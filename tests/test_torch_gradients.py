"""Parity of the port's gradients through `solve` with the JAX package's, in
float64 on the CPU: the flagship reaction–diffusion gradient (n = 1024, 16
fixed Tsit5 steps) under BacksolveAdjoint (fixed-grid forward, adaptive
reverse at adj_rtol) and DirectAdjoint, and the Backsolve reconstruction
guard with its two deliberate divergences (its own retcode, and a check
before every checkpoint snap). JAX runs each reference as one program
compiled at XLA optimization level 0 (`torch_parity.jax_o0`), whose
rounding is op by op, as the port's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import jax_o0, rd1d_u0, to_numpy, to_port

import scimlsensitivity_jl_tpu as J
import scimlsensitivity_jl_tpu_torch as P
from scimlsensitivity_jl_tpu.ops.pallas_pde import make_rd1d_field as jax_field
from scimlsensitivity_jl_tpu_torch.adjoints.continuous import RETCODE_RECON_DRIFT
from scimlsensitivity_jl_tpu_torch.ops.rd1d import make_rd1d_field as port_field

N, DT, STEPS = 1024, 1e-9, 16
ADJ = dict(adj_rtol=1e-3, adj_atol=1e-8, adj_max_steps=128)


def _rd1d_inputs():
    # a bump plus a seeded ripple, so the gradient has structure on the grid
    g = np.random.default_rng(7)
    return rd1d_u0(N) + 0.01 * g.standard_normal(N), np.array([1e-7, 1.5])


@pytest.mark.parametrize("sensealg", ["BacksolveAdjoint", "DirectAdjoint"])
def test_rd1d_gradients_match_jax(sensealg):
    """d/du0 and d/dp of Σ ys[-1]² agree with JAX at rtol 1e-8. The
    Backsolve reverse is adaptive in both packages; with the same float64
    arithmetic it takes the same steps, which this tolerance (far below
    adj_rtol) checks."""
    u0, p = _rd1d_inputs()
    t1 = STEPS * DT
    kw = dict(saveat=[0.0, t1], dt=DT, adaptive=False, **ADJ)

    def loss_jax(uu, pp):
        sol = J.solve(J.ODEProblem(jax_field(N, 1.0 / N), uu, (0.0, t1), pp),
                      J.Tsit5(), sensealg=getattr(J, sensealg)(), **kw)
        return jnp.sum(sol.ys[-1] ** 2)

    gu_j, gp_j = jax_o0(jax.grad(loss_jax, argnums=(0, 1)), jnp.asarray(u0),
                        jnp.asarray(p))
    uu = to_port(u0).requires_grad_()
    pp = to_port(p).requires_grad_()
    sol = P.solve(P.ODEProblem(port_field(N, 1.0 / N), uu, (0.0, t1), pp),
                  P.Tsit5(), sensealg=getattr(P, sensealg)(), **kw)
    torch.sum(sol.ys[-1] ** 2).backward()
    np.testing.assert_allclose(to_numpy(uu.grad), np.asarray(gu_j), rtol=1e-8,
                               atol=1e-8 * float(np.abs(gu_j).max()))
    np.testing.assert_allclose(to_numpy(pp.grad), np.asarray(gp_j), rtol=1e-8)
    if sensealg == "BacksolveAdjoint":
        assert sol.adjoint.stats.retcode == 0
        assert sol.adjoint.stats.n_accepted > 0


def _heat(n):
    h = 1.0 / n

    def jax_f(u, pp, t):
        return pp[0] * (jnp.roll(u, 1) - 2.0 * u + jnp.roll(u, -1)) / h**2

    def port_f(u, pp, t):
        return pp[0] * (torch.roll(u, 1) - 2.0 * u + torch.roll(u, -1)) / h**2

    return jax_f, port_f


def test_backsolve_recon_guard_poisons_in_both_packages(capfd):
    """Backward re-integration of the heat equation over ~45 e-folds of its
    fastest mode amplifies roundoff far past recon_guard: both packages
    return NaN gradients (tests/test_adjoints.py:
    test_backsolve_recon_guard); a benign horizon stays finite and equal.
    Deliberate divergence in the retcode: JAX reports 3, the code it names
    DDELagViolation; the port gives the drift its own, 6,
    BacksolveReconstructionDrift."""
    n = 32
    h = 1.0 / n
    u0 = np.exp(-40.0 * (np.arange(n) * h - 0.5) ** 2)
    p = np.array([1.0])
    jax_f, port_f = _heat(n)
    kw = dict(rtol=1e-8, atol=1e-10, max_steps=16384, adj_max_steps=16384)

    def grads(T):
        def loss_jax(pp):
            sol = J.solve(J.ODEProblem(jax_f, jnp.asarray(u0), (0.0, T), pp),
                          J.Tsit5(), saveat=jnp.array([0.0, T]),
                          sensealg=J.BacksolveAdjoint(checkpointing=False),
                          verbose=True, **kw)
            return jnp.sum(sol.ys[-1] ** 2)

        g_j = np.asarray(jax_o0(jax.grad(loss_jax), jnp.asarray(p)))
        pp = to_port(p).requires_grad_()
        sol = P.solve(P.ODEProblem(port_f, to_port(u0), (0.0, T), pp),
                      P.Tsit5(), saveat=[0.0, T],
                      sensealg=P.BacksolveAdjoint(checkpointing=False), **kw)
        torch.sum(sol.ys[-1] ** 2).backward()
        return g_j, to_numpy(pp.grad), sol.adjoint.stats.retcode

    g_j, g_p, rc = grads(0.001)
    assert rc == 0
    np.testing.assert_allclose(g_p, g_j, rtol=1e-8)

    capfd.readouterr()
    g_j, g_p, rc = grads(45.0 / (4.0 / h**2))
    assert np.isnan(g_j).all() and np.isnan(g_p).all()
    assert "non-success retcode 3" in capfd.readouterr().out  # JAX's code
    assert J.solution.RETCODE_NAMES[3] == "DDELagViolation"
    assert rc == RETCODE_RECON_DRIFT == 6
    assert P.RETCODE_NAMES[rc] == "BacksolveReconstructionDrift"


def test_backsolve_drift_checked_before_every_snap():
    """Deliberate divergence: with checkpointing, JAX checks the drift only
    at t0, after the t0 snap has put the stored u0 back, so the check
    never trips; the port compares the reconstruction with the stored
    forward value before every snap. Over 2 x 45 e-folds of the heat
    equation's fastest mode, with a save time between, each segment's
    reconstruction drifts far past recon_guard: JAX returns a finite
    gradient taken on a drifted trajectory and retcode 0, the port NaN and
    retcode 6 (a benign horizon passes the port's check)."""
    n = 32
    h = 1.0 / n
    u0 = np.exp(-40.0 * (np.arange(n) * h - 0.5) ** 2)
    jax_f, port_f = _heat(n)
    kw = dict(rtol=1e-8, atol=1e-10, max_steps=4096, adj_max_steps=4096)

    def port_grads(T):
        pp = to_port(np.ones(1)).requires_grad_()
        sol = P.solve(P.ODEProblem(port_f, to_port(u0), (0.0, T), pp),
                      P.Tsit5(), saveat=[0.0, T / 2, T],
                      sensealg=P.BacksolveAdjoint(), **kw)
        torch.sum(sol.ys[-1] ** 2).backward()
        return to_numpy(pp.grad), sol.adjoint.stats.retcode

    g_p, rc = port_grads(0.001)
    assert rc == 0 and np.isfinite(g_p).all()
    T = 90.0 / (4.0 / h**2)

    def loss_jax(pp):
        sol = J.solve(J.ODEProblem(jax_f, jnp.asarray(u0), (0.0, T), pp),
                      J.Tsit5(), saveat=jnp.array([0.0, T / 2, T]),
                      sensealg=J.BacksolveAdjoint(), **kw)
        return jnp.sum(sol.ys[-1] ** 2)

    assert np.isfinite(np.asarray(jax_o0(jax.grad(loss_jax),
                                         jnp.ones(1)))).all()
    g_p, rc = port_grads(T)
    assert np.isnan(g_p).all() and rc == RETCODE_RECON_DRIFT


def test_dict_parameters_carry_across_and_differentiate():
    """Parameters as a dict of numpy arrays (as the JAX package's mlp_init
    returns them) go through from_numpy_tree; the Backsolve gradient comes
    back as the same dict and matches JAX's."""
    p_np = {"alpha": np.array(1.5), "beta": np.array([1.0]),
            "delta": np.array(1.0), "gamma": np.array(3.0)}

    def lv(u, p, t, stack):
        x, y = u[0], u[1]
        a, b, d, g = p["alpha"], p["beta"][0], p["delta"], p["gamma"]
        return stack([a * x - b * x * y, -g * y + d * x * y])

    kw = dict(dt=0.01, adaptive=False, adj_rtol=1e-10, adj_atol=1e-12)

    def loss_jax(pp):
        sol = J.solve(J.ODEProblem(lambda u, q, t: lv(u, q, t, jnp.stack),
                                   jnp.array([1.0, 1.0]), (0.0, 1.0), pp),
                      J.Tsit5(), saveat=jnp.array([0.0, 1.0]),
                      sensealg=J.BacksolveAdjoint(), **kw)
        return jnp.sum(sol.ys[-1] ** 2)

    g_j = jax_o0(jax.grad(loss_jax),
                 {k: jnp.asarray(v) for k, v in p_np.items()})
    p = {k: v.requires_grad_() for k, v in to_port(p_np).items()}
    sol = P.solve(P.ODEProblem(lambda u, q, t: lv(u, q, t, torch.stack),
                               to_port(np.array([1.0, 1.0])), (0.0, 1.0), p),
                  P.Tsit5(), saveat=[0.0, 1.0], sensealg=P.BacksolveAdjoint(),
                  **kw)
    torch.sum(sol.ys[-1] ** 2).backward()
    for key in p_np:
        assert p[key].grad.shape == p[key].shape
        np.testing.assert_allclose(to_numpy(p[key].grad),
                                   np.asarray(g_j[key]), rtol=1e-8,
                                   err_msg=key)
