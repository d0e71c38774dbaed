"""Parity of the port's forward-mode rules with the JAX package's, in float64
on the CPU: ForwardDiffSensitivity (what sensealg=None picks for
Lotka–Volterra) at chunk sizes 0, 1 and 3, ForwardSensitivity, the direct
API ODEForwardSensitivityProblem with extract_local_sensitivities, the
classic models, and the refusal of forward mode through a kernel field in
both packages.

JAX runs each reference as one program compiled at XLA optimization level
0 (`torch_parity.jax_o0`): its rounding is op by op, as the port's, so
both take the same adaptive steps and agree far below the solve
tolerance; the stated tolerances leave room for summation order only."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (assert_close, jax_o0, lotka_volterra_jax,
                          lotka_volterra_port, rd1d_u0, to_port)

import scimlsensitivity_jl_tpu as J
import scimlsensitivity_jl_tpu_torch as P
from scimlsensitivity_jl_tpu.models import classic as jax_classic
from scimlsensitivity_jl_tpu.ops.pallas_mlp import fused_mlp2 as jax_mlp2
from scimlsensitivity_jl_tpu.ops.pallas_pde import make_rd1d_field as jax_rd1d
from scimlsensitivity_jl_tpu_torch.ops.mlp import fused_mlp2 as port_mlp2
from scimlsensitivity_jl_tpu_torch.ops.rd1d import make_rd1d_field as port_rd1d
from scimlsensitivity_jl_tpu_torch.ops.vjp import ForwardModeUnsupported

LV_U0 = np.array([1.0, 1.0])
LV_P = np.array([1.5, 1.0, 3.0, 1.0])
T1 = 2.0
TS = np.linspace(0.0, T1, 5)
TOL = dict(rtol=1e-6, atol=1e-8)  # 25 accepted Tsit5 steps
# gradients of the same discrete program, summed in other orders
GRAD_RTOL = 1e-10


def _jax_loss(sensealg, final=False):
    def loss(u0, p):
        sol = J.solve(J.ODEProblem(lotka_volterra_jax, u0, (0.0, T1), p),
                      J.Tsit5(), saveat=jnp.asarray(TS), sensealg=sensealg,
                      **TOL)
        out = sol.u_final if final else sol.ys
        return jnp.sum((out - 1.0) ** 2), sol.stats.n_accepted

    return loss


def _port_grads(sensealg, final=False):
    u0 = to_port(LV_U0).requires_grad_()
    p = to_port(LV_P).requires_grad_()
    sol = P.solve(P.ODEProblem(lotka_volterra_port, u0, (0.0, T1), p),
                  P.Tsit5(), saveat=TS, sensealg=sensealg, **TOL)
    out = sol.u_final if final else sol.ys
    torch.sum((out - 1.0) ** 2).backward()
    return sol, u0.grad, p.grad


@functools.lru_cache(maxsize=None)
def _jax_default_grads():
    """JAX's gradient under sensealg=None, which is ForwardDiffSensitivity
    for n + p = 6, computed once for the three chunk sizes."""
    return jax_o0(jax.grad(_jax_loss(None), argnums=(0, 1), has_aux=True),
                  jnp.asarray(LV_U0), jnp.asarray(LV_P))


@pytest.mark.parametrize("chunk", [0, 1, 3])
def test_default_is_forwarddiff_and_matches_jax(chunk):
    """sensealg=None dispatches to ForwardDiffSensitivity in both packages;
    the port's du0 and dp at chunk sizes 0 (all 6 directions in one
    sweep), 1 and 3 (two sweeps) are JAX's."""
    (gu_j, gp_j), n_j = _jax_default_grads()
    sensealg = None if chunk == 0 else P.ForwardDiffSensitivity(chunk_size=chunk)
    sol, gu, gp = _port_grads(sensealg)
    assert type(sol.sensealg) is P.ForwardDiffSensitivity
    assert sol.stats.n_accepted == int(n_j) and sol.adjoint is None
    assert_close(gu, gu_j, rtol=GRAD_RTOL)
    assert_close(gp, gp_j, rtol=GRAD_RTOL)


def test_forward_sensitivity_matches_jax():
    """ForwardSensitivity solves [u; S] with S over the 2 u0- and 4
    p-directions, the error norm over all of it (both packages take the
    same steps, more than the 25 of u alone), and contracts the saved S
    with the cotangents."""
    (gu_j, gp_j), n_j = jax_o0(
        jax.grad(_jax_loss(J.ForwardSensitivity()), argnums=(0, 1),
                 has_aux=True), jnp.asarray(LV_U0), jnp.asarray(LV_P))
    sol, gu, gp = _port_grads(P.ForwardSensitivity())
    assert sol.stats.n_accepted == int(n_j) > 25
    assert_close(gu, gu_j, rtol=GRAD_RTOL)
    assert_close(gp, gp_j, rtol=GRAD_RTOL)
    # and with ForwardDiffSensitivity, to ten times the solve's rtol
    _, gu_d, gp_d = _port_grads(P.ForwardDiffSensitivity())
    assert_close(gp, gp_d, rtol=1e-5)
    assert_close(gu, gu_d, rtol=1e-5)


def test_forward_sensitivity_u_final_cotangent_divergence():
    """Deliberate divergence: a loss on sol.u_final. The JAX rule drops
    that cotangent (adjoints/forward.py:_bwd), so its gradient is zero; the
    port contracts it with the final sensitivities and agrees with
    ForwardDiffSensitivity."""
    (gu_j, gp_j), _ = jax_o0(
        jax.grad(_jax_loss(J.ForwardSensitivity(), True), argnums=(0, 1),
                 has_aux=True), jnp.asarray(LV_U0), jnp.asarray(LV_P))
    assert not np.any(np.asarray(gu_j)) and not np.any(np.asarray(gp_j))
    _, gu, gp = _port_grads(P.ForwardSensitivity(), final=True)
    _, gu_d, gp_d = _port_grads(P.ForwardDiffSensitivity(), final=True)
    assert float(gp.abs().min()) > 1e-3
    assert_close(gp, gp_d, rtol=1e-5)
    assert_close(gu, gu_d, rtol=1e-5)


def test_forward_sensitivity_problem_matches_jax():
    """ODEForwardSensitivityProblem with p-directions only, solved and
    split by extract_local_sensitivities: u (nt, n), S (nt, np, n) and the
    accepted steps as in JAX, and S = ∂u/∂p."""
    def jax_solve(u0, p):
        prob = J.ODEForwardSensitivityProblem(lotka_volterra_jax, u0,
                                              (0.0, T1), p)
        sol = J.solve(prob, J.Tsit5(), saveat=jnp.asarray(TS), **TOL)
        return sol.ys, sol.stats.n_accepted

    ys_j, n_j = jax_o0(jax_solve, jnp.asarray(LV_U0), jnp.asarray(LV_P))
    prob = P.ODEForwardSensitivityProblem(lotka_volterra_port, to_port(LV_U0),
                                          (0.0, T1), to_port(LV_P))
    sol = P.solve(prob, P.Tsit5(), saveat=TS, **TOL)
    u, S = P.extract_local_sensitivities(sol)
    assert u.shape == (5, 2) and S.shape == (5, 4, 2)
    assert sol.stats.n_accepted == int(n_j)
    assert_close(u, np.asarray(ys_j)[:, :2], rtol=1e-12, atol=1e-14)
    assert_close(S, np.asarray(ys_j)[:, 2:].reshape(5, 4, 2), rtol=1e-10,
                 atol=1e-12)
    u2, S2 = P.extract_local_sensitivities(sol, 2)
    assert torch.equal(u2, u[2]) and torch.equal(S2, S[2])
    # S is the derivative of the solution: the direct API against the
    # ForwardSensitivity rule's saved columns, through the ys of one p_j
    p = to_port(LV_P).requires_grad_()
    ys = P.solve(P.ODEProblem(lotka_volterra_port, to_port(LV_U0), (0.0, T1),
                              p), P.Tsit5(), saveat=TS,
                 sensealg=P.ForwardSensitivity(), **TOL).ys
    (g,) = torch.autograd.grad(ys[-1, 0], p)
    assert_close(g, S[-1, :, 0], rtol=1e-5)


def test_classic_models_match_jax():
    """The classic fields at seeded states, and the problems' u0, p and span
    (made on the CPU here; the builders default to the card)."""
    g = np.random.default_rng(3)
    for name in ("lotka_volterra", "robertson", "lorenz"):
        jprob = getattr(jax_classic, f"{name}_problem")()
        pprob = getattr(P, f"{name}_problem")(device="cpu")
        assert pprob.tspan == tuple(jprob.tspan)
        assert_close(pprob.u0, jprob.u0, rtol=0)
        assert_close(pprob.p, jprob.p, rtol=0)
        u = g.uniform(0.5, 1.5, np.asarray(jprob.u0).shape)
        assert_close(getattr(P, name)(to_port(u), pprob.p, 0.0),
                     getattr(jax_classic, name)(jnp.asarray(u), jprob.p, 0.0),
                     rtol=1e-15)
    assert pprob.u0.device.type == "cpu"


def _kernel_fields():
    n = 16
    g = np.random.default_rng(5)
    mlp = {"W0": 0.3 * g.standard_normal((2, 8)), "b0": np.zeros(8),
           "W1": 0.3 * g.standard_normal((8, 2)), "b1": np.zeros(2)}
    return {
        "FusedRD1D": (lambda: (jax_rd1d(n, 1.0 / n), port_rd1d(n, 1.0 / n)),
                      rd1d_u0(n), np.array([1e-4, 1.5])),
        "FusedMLP2": (lambda: (lambda u, p, t: jax_mlp2(p, u),
                               lambda u, p, t: port_mlp2(p, u)),
                      np.array([2.0, 0.0]), mlp),
    }


@pytest.mark.parametrize("function", ["FusedRD1D", "FusedMLP2"])
def test_forward_mode_through_kernel_field_raises_in_both(function):
    """A kernel field has a pullback only. JAX's custom_vjp refuses jax.jvp
    (shown under both rules for the MLP field, and on the rd1d field's own
    jvp); the port's Function raises
    ForwardModeUnsupported (a NotImplementedError) naming itself, under
    ForwardDiffSensitivity (at the gradient), ForwardSensitivity (at the
    solve) and ODEForwardSensitivityProblem."""
    make, u0, p = _kernel_fields()[function]
    f_jax, f_port = make()
    kw = dict(saveat=[0.0, 0.1], rtol=1e-6, atol=1e-8)

    def jax_loss(pp, sensealg):
        sol = J.solve(J.ODEProblem(f_jax, jnp.asarray(u0), (0.0, 0.1), pp),
                      J.Tsit5(), sensealg=sensealg, **kw)
        return jnp.sum(sol.ys[-1] ** 2)

    p_jax = jax.tree_util.tree_map(jnp.asarray, p)
    if function == "FusedMLP2":
        for sensealg in (J.ForwardDiffSensitivity(), J.ForwardSensitivity()):
            # tracing raises; nothing is compiled
            with pytest.raises(TypeError, match="forward-mode autodiff"):
                jax.jit(jax.grad(lambda pp: jax_loss(pp, sensealg))).lower(
                    p_jax)
    else:
        # the interpreted Pallas field traces slowly inside a solve: its
        # own jvp, which both rules take, shows the refusal
        with pytest.raises(TypeError, match="forward-mode autodiff"):
            jax.jvp(lambda uu: f_jax(uu, p_jax, 0.0), (jnp.asarray(u0),),
                    (jnp.ones_like(jnp.asarray(u0)),))

    def port_problem():
        pp = to_port(p)
        leaves = pp.values() if isinstance(pp, dict) else [pp]
        for leaf in leaves:
            leaf.requires_grad_()
        return P.ODEProblem(f_port, to_port(u0), (0.0, 0.1), pp)

    sol = P.solve(port_problem(), P.Tsit5(),
                  sensealg=P.ForwardDiffSensitivity(), **kw)
    with pytest.raises(ForwardModeUnsupported, match=function):
        torch.sum(sol.ys[-1] ** 2).backward()
    with pytest.raises(NotImplementedError, match="custom_vjp"):
        P.solve(port_problem(), P.Tsit5(), sensealg=P.ForwardSensitivity(),
                **kw)
    prob = port_problem()
    with pytest.raises(ForwardModeUnsupported, match=function):
        P.solve(P.ODEForwardSensitivityProblem(prob.f, prob.u0, prob.tspan,
                                               prob.p), P.Tsit5(), **kw)


def test_rk4_block_refuses_forward_mode():
    """The RK4 block megakernel's Function (K5/K6) refuses forward mode by
    name too, like the JAX block's custom_vjp."""
    n = 64
    block = P.make_rd1d_rk4_block(n, 4, chunk=64, bwd_chunk=64)
    u = to_port(rd1d_u0(n))
    p = to_port(np.array([1e-7, 1.5]))
    with pytest.raises(ForwardModeUnsupported, match="RD1DRK4Block"):
        torch.func.jvp(lambda uu: block(uu, p, float(n) ** 2, 1e-9), (u,),
                       (torch.ones_like(u),))
