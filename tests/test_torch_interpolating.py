"""Parity of the port's InterpolatingAdjoint (dense, pinned, checkpointed,
with `checkpoints=`), GaussKronrodAdjoint (adaptive and pinned) and
GaussAdjoint with checkpointing or a pinned reverse with the JAX package's,
in float64 on the CPU: the gradient and the reverse step count on
Lotka–Volterra, the reaction–diffusion kernel field under the pinned
InterpolatingAdjoint and GaussKronrodAdjoint (K1 and K2 run their plain
versions on the CPU), the auto-pinned reverse's fallback on a stiff decay,
the `checkpoints=` refusals, and the float32 short-span divergence (time
matching relative to the span in every matcher).

Each package gets a Tsit5 reverse stepper that counts its `step` calls
(JAX's through `jax.debug.callback`), so the reverse's steps, rejected
attempts, pinned intervals and the checkpointed local reverses are counted
alike. JAX runs each reference as one program compiled at XLA optimization
level 0 (`torch_parity.jax_o0`), so both take the same steps; the
tolerances leave room for summation order only."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (assert_close, jax_o0, lotka_volterra_jax,
                          lotka_volterra_port, rd1d_u0, to_numpy, to_port)

import scimlsensitivity_jl_tpu as J
import scimlsensitivity_jl_tpu_torch as P
from scimlsensitivity_jl_tpu.ops.pallas_pde import make_rd1d_field as jax_field
from scimlsensitivity_jl_tpu.solvers.explicit import ExplicitRK as JaxRK
from scimlsensitivity_jl_tpu.solvers.tableaus import TSIT5 as JAX_TSIT5
from scimlsensitivity_jl_tpu_torch.ops.rd1d import make_rd1d_field as port_field
from scimlsensitivity_jl_tpu_torch.solvers.explicit import ExplicitRK as PortRK
from scimlsensitivity_jl_tpu_torch.solvers.tableaus import TSIT5 as PORT_TSIT5

GRAD_RTOL = 1e-10


class _JaxCountingTsit5(JaxRK):
    """JAX's Tsit5 with a host counter of the steps the compiled program
    takes (one callback per executed `step`)."""

    def __init__(self):
        super().__init__(JAX_TSIT5, "Tsit5")
        self.calls = []

    def step(self, fvec, t, dt, u, f0):
        jax.debug.callback(lambda _: self.calls.append(1), dt)
        return super().step(fvec, t, dt, u, f0)


class _PortCountingTsit5(PortRK):
    def __init__(self):
        super().__init__(PORT_TSIT5, "Tsit5")
        self.calls = 0

    def step(self, fvec, t, dt, u, f0, need_err=True):
        self.calls += 1
        return super().step(fvec, t, dt, u, f0, need_err)


def _grads(problem, sensealg_j, sensealg_p, loss, jax_kw=None,
           jax_loss_of=None, **kw):
    """(JAX's du0, dp, reverse steps) and (the port's du0, dp, reverse
    steps, sol) of loss(sol.ys) under the two sensealgs. problem: (field_j,
    field_p, u0, p, tspan); jax_kw / jax_loss_of: JAX's own solve arguments
    and loss, where they differ."""
    field_j, field_p, u0, p, tspan = problem
    stepper_j, stepper_p = _JaxCountingTsit5(), _PortCountingTsit5()

    def jax_loss(uu, pp):
        sol = J.solve(J.ODEProblem(field_j, uu, tspan, pp), J.Tsit5(),
                      sensealg=sensealg_j, bwd_solver=stepper_j,
                      **{**kw, **(jax_kw or {})})
        return (jax_loss_of or loss)(sol.ys)

    gu_j, gp_j = jax_o0(jax.grad(jax_loss, argnums=(0, 1)), jnp.asarray(u0),
                        jnp.asarray(p))
    uu = to_port(u0).requires_grad_()
    pp = to_port(p).requires_grad_()
    sol = P.solve(P.ODEProblem(field_p, uu, tspan, pp), P.Tsit5(),
                  sensealg=sensealg_p, bwd_solver=stepper_p, **kw)
    loss(sol.ys).backward()
    return ((np.asarray(gu_j), np.asarray(gp_j), len(stepper_j.calls)),
            (to_numpy(uu.grad), to_numpy(pp.grad), stepper_p.calls, sol))


LV = (lotka_volterra_jax, lotka_volterra_port, np.array([1.0, 1.0]),
      np.array([1.5, 1.0, 3.0, 1.0]), (0.0, 1.0))
LV_TS = np.linspace(0.0, 1.0, 4)
LV_CKPTS = (0.1, 0.5, 0.9)

# (id, constructor arguments, the reverse the port reports running)
LV_CASES = [
    ("interp_pinned", ("InterpolatingAdjoint", {}), "pinned"),
    ("interp_adaptive",
     ("InterpolatingAdjoint", dict(pinned_reverse=False)), "adaptive"),
    ("interp_ckpt",
     ("InterpolatingAdjoint", dict(checkpointing=True)), "checkpointed"),
    ("interp_ckpt_grid",
     ("InterpolatingAdjoint", dict(checkpointing=True, checkpoints=LV_CKPTS)),
     "checkpointed"),
    ("gauss_ckpt", ("GaussAdjoint", dict(checkpointing=True)),
     "checkpointed"),
    ("gauss_pinned", ("GaussAdjoint", dict(pinned_reverse=True)), "pinned"),
    ("gk_adaptive", ("GaussKronrodAdjoint", {}), "adaptive"),
    ("gk_pinned", ("GaussKronrodAdjoint", dict(pinned_reverse=True)),
     "pinned"),
]


@pytest.mark.parametrize("rule,reverse", [c[1:] for c in LV_CASES],
                         ids=[c[0] for c in LV_CASES])
def test_lotka_volterra_rules_match_jax(rule, reverse):
    """d/du0 and d/dp of Σ (ys − 1)² agree with JAX at rtol 1e-10, in the
    same number of reverse steps. GaussKronrodAdjoint runs at tolerances
    (abstol 1e-12, reltol 1e-10) that make its steps split; the pinned
    reverses take one step per forward interval, and the checkpointed ones
    re-solve each inter-save interval (with checkpoints=, the three
    checkpoint times split them further; the caller's rows come back
    alone). JAX's solve merges checkpoints= into the save grid only for
    concrete save times, which a compiled program does not have: its
    reference there is the merged grid that its solve builds
    (solve.py:548-578), with the loss on the caller's rows."""
    name, kwargs = rule
    if name == "GaussKronrodAdjoint":
        kwargs = dict(kwargs, abstol=1e-12, reltol=1e-10)
    sensealg_j = getattr(J, name)(**kwargs)
    jax_kw = jax_loss_of = None
    if "checkpoints" in kwargs:
        merged = np.union1d(LV_TS, LV_CKPTS)
        rows = np.searchsorted(merged, LV_TS)
        sensealg_j = J.InterpolatingAdjoint(checkpointing=True)
        jax_kw = dict(saveat=merged)
        jax_loss_of = lambda ys: jnp.sum((ys[rows] - 1.0) ** 2)
    (gu_j, gp_j, steps_j), (gu_p, gp_p, steps_p, sol) = _grads(
        LV, sensealg_j, getattr(P, name)(**kwargs),
        lambda ys: (ys - 1.0).pow(2).sum() if isinstance(ys, torch.Tensor)
        else jnp.sum((ys - 1.0) ** 2), jax_kw=jax_kw,
        jax_loss_of=jax_loss_of, saveat=LV_TS, rtol=1e-6, atol=1e-8)
    assert sol.ys.shape == (LV_TS.size, 2)
    record = sol.adjoint
    assert record.reverse == reverse and record.stats.retcode == 0
    assert steps_p == steps_j > 0
    if reverse == "pinned":
        assert record.stats.n_accepted == sol.stats.n_accepted == steps_p
    if reverse == "checkpointed":
        n_intervals = LV_TS.size - 1 + (len(LV_CKPTS) if "checkpoints"
                                        in kwargs else 0)
        assert record.resolves == n_intervals
    assert_close(gu_p, gu_j, rtol=GRAD_RTOL)
    assert_close(gp_p, gp_j, rtol=GRAD_RTOL)


RD1D_CASES = [
    ("interp_pinned", "InterpolatingAdjoint", {}),
    ("interp_ckpt_grid", "InterpolatingAdjoint",
     dict(checkpointing=True, checkpoints=tuple(k * 1e-9 for k in range(1, 8)))),
    ("gk_adaptive", "GaussKronrodAdjoint", dict(max_depth=0)),
]


@pytest.mark.parametrize("rule,kwargs", [c[1:] for c in RD1D_CASES],
                         ids=[c[0] for c in RD1D_CASES])
def test_rd1d_kernel_field_matches_jax(rule, kwargs):
    """The kernel field at n = 64 on the PDE's fixed grid (8 steps of
    1e-9), the reverse adaptive at adj_rtol 1e-3: InterpolatingAdjoint
    pins its reverse to the 8 forward steps (each stage one f_and_vjp, K1 +
    K2); with checkpointing and a checkpoint at every step (chip_smoke's
    arm (e) at an eighth of its depth: 7 interior checkpoints, 8 intervals)
    the fixed-grid budget counts the caller's two save times, as JAX's
    solve does before it merges the checkpoints, and each interval is solved
    again on the grid; GaussKronrodAdjoint takes one K2 pullback per node
    (max_depth 0 keeps JAX's compile short). JAX's field is the Pallas
    kernel in interpret mode; its checkpointed reference is the merged
    save grid (see test_lotka_volterra_rules_match_jax)."""
    n, dt, steps = 64, 1e-9, 8
    t1 = steps * dt
    u0 = rd1d_u0(n) + 0.01 * np.random.default_rng(7).standard_normal(n)
    sensealg_j = getattr(J, rule)(**kwargs)
    jax_kw = jax_loss_of = None
    ckpts = kwargs.get("checkpoints", ())
    if ckpts:
        sensealg_j = J.InterpolatingAdjoint(checkpointing=True)
        jax_kw = dict(saveat=np.union1d([0.0, t1], ckpts))
        jax_loss_of = lambda ys: jnp.sum(ys[-1] ** 2)
    (gu_j, gp_j, steps_j), (gu_p, gp_p, steps_p, sol) = _grads(
        (jax_field(n, 1.0 / n), port_field(n, 1.0 / n), u0,
         np.array([1e-7, 1.5]), (0.0, t1)),
        sensealg_j, getattr(P, rule)(**kwargs),
        lambda ys: (ys[-1] ** 2).sum(), jax_kw=jax_kw,
        jax_loss_of=jax_loss_of, saveat=[0.0, t1], dt=dt, adaptive=False,
        adj_rtol=1e-3, adj_atol=1e-8, adj_max_steps=128)
    assert sol.adjoint.stats.retcode == 0 and sol.stats.n_accepted == steps
    assert steps_p == steps_j > 0
    if not kwargs:
        assert sol.adjoint.reverse == "pinned" and steps_p == steps
    if ckpts:
        assert sol.adjoint.resolves == len(ckpts) + 1
        assert sol.ys.shape == (2, n)
    assert_close(gu_p, gu_j, rtol=GRAD_RTOL,
                 atol=GRAD_RTOL * float(np.abs(gu_j).max()))
    assert_close(gp_p, gp_j, rtol=1e-8)


def _decay(u, p, t):
    """u' = −p₀·u, for both packages. At p₀ = 50 over [0, 1] a stiff
    decay: once u is far below atol the forward strides at Tsit5's
    stability limit, while the adjoint, which starts at λ(1) = 1, needs
    small steps there."""
    return -p[0] * u


STIFF = (_decay, _decay, np.array([1.0, 0.5]), np.array([50.0]),
         (0.0, 1.0))
STIFF_KW = dict(saveat=[0.0, 1.0], rtol=1e-6, atol=1e-6)


def test_auto_pinned_falls_back_when_the_guard_trips():
    """Auto pinning on the stiff decay: the pinned pass's weighted error
    exceeds its guard (100 × tolerance), so both packages run the adaptive
    joined reverse after it and return its gradient; the step counts
    include both passes."""
    (gu_j, gp_j, steps_j), (gu_p, gp_p, steps_p, sol) = _grads(
        STIFF, J.InterpolatingAdjoint(), P.InterpolatingAdjoint(),
        lambda ys: ys[-1].sum(), **STIFF_KW)
    assert sol.adjoint.reverse == "pinned, then adaptive"
    assert sol.adjoint.stats.retcode == 0
    assert steps_p == steps_j > sol.stats.n_accepted
    assert np.isfinite(gp_p).all()
    assert_close(gu_p, gu_j, rtol=GRAD_RTOL)
    assert_close(gp_p, gp_j, rtol=GRAD_RTOL)


def test_pinned_true_poisons_when_the_guard_trips(capfd):
    """pinned_reverse=True on the same decay keeps the guard's verdict:
    NaN gradients and retcode 2 in both packages (JAX prints its code
    under verbose=True)."""
    sa = dict(pinned_reverse=True)
    capfd.readouterr()
    (gu_j, gp_j, steps_j), (gu_p, gp_p, steps_p, sol) = _grads(
        STIFF, J.InterpolatingAdjoint(**sa), P.InterpolatingAdjoint(**sa),
        lambda ys: ys[-1].sum(), verbose=True, **STIFF_KW)
    out = capfd.readouterr().out
    # JAX's notice names Backsolve's drift 3, the port's 6
    assert out.count("adjoint: non-success retcode 2") == 2
    assert "3=Backsolve" in out and "6=Backsolve" in out
    assert np.isnan(gu_j).all() and np.isnan(gp_j).all()
    assert np.isnan(gu_p).all() and np.isnan(gp_p).all()
    assert sol.adjoint.reverse == "pinned"
    assert sol.adjoint.stats.retcode == 2
    assert steps_p == steps_j == sol.stats.n_accepted


@pytest.mark.parametrize("checkpointing", [False, True],
                         ids=["pinned", "checkpointed"])
def test_float32_short_span_divergence(checkpointing):
    """Deliberate divergence (ROADMAP §3): u' = −p·u with p = 1e7 over a
    span of 1e-7 in float32, loss u(T) summed (a jump at t1 only). JAX
    matches times to 64 eps · max(|t|, 1), 7.6e-6 in float32, more than the
    whole span: its pinned walk finds every forward interval zero-width,
    and its checkpointed reverse freezes every interval, so λ never moves
    and dL/dp is exactly 0; its save hook takes the save time T as reached
    at t0, so ys[-1] holds u0. The port's tolerance is relative to the span
    below 1, and its gradient is the analytic one, e^(−pT) in u0 and
    −T·Σu0·e^(−pT) in p, to the solve's tolerance (rtol 1e-4; 1e-3 on the
    gradient), with ys[-1] = u0·e^(−pT)."""
    u0, p, T = np.array([1.0, 0.5], np.float32), np.array([1e7], np.float32), 1e-7
    sa = dict(checkpointing=True) if checkpointing else {}
    kw = dict(saveat=[0.0, T], rtol=1e-4, atol=1e-6)

    def jax_loss(uu, pp):
        sol = J.solve(J.ODEProblem(_decay, uu, (0.0, T), pp),
                      J.Tsit5(), sensealg=J.InterpolatingAdjoint(**sa), **kw)
        return jnp.sum(sol.u_final), sol.ys

    (gu_j, gp_j), ys_j = jax_o0(
        jax.grad(jax_loss, argnums=(0, 1), has_aux=True), jnp.asarray(u0),
        jnp.asarray(p))
    assert np.asarray(gp_j).dtype == np.float32
    # the reference's fault
    assert float(np.asarray(gp_j)[0]) == 0.0
    assert (np.asarray(ys_j) == u0[None]).all()
    uu = torch.from_numpy(u0).requires_grad_()
    pp = torch.from_numpy(p).requires_grad_()
    sol = P.solve(P.ODEProblem(_decay, uu, (0.0, T), pp),
                  P.Tsit5(), sensealg=P.InterpolatingAdjoint(**sa), **kw)
    sol.u_final.sum().backward()
    assert sol.adjoint.reverse == ("checkpointed" if checkpointing
                                   else "pinned")
    assert sol.adjoint.stats.retcode == 0
    decay = np.exp(-1.0)
    assert_close(sol.ys[-1].detach(), decay * u0, rtol=1e-4)
    assert_close(uu.grad, [decay, decay], rtol=1e-3)
    assert_close(pp.grad, [-T * u0.sum() * decay], rtol=1e-3)


SHORT_SPAN_CASES = [
    ("interp_pinned", "InterpolatingAdjoint", {}),
    ("interp_adaptive", "InterpolatingAdjoint", dict(pinned_reverse=False)),
    ("interp_ckpt", "InterpolatingAdjoint", dict(checkpointing=True)),
    ("gauss", "GaussAdjoint", {}),
    ("quadrature", "QuadratureAdjoint", {}),
    ("backsolve", "BacksolveAdjoint", {}),
]


@pytest.mark.parametrize("rule,kwargs", [c[1:] for c in SHORT_SPAN_CASES],
                         ids=[c[0] for c in SHORT_SPAN_CASES])
def test_float32_short_span_save_rows_and_jumps(rule, kwargs):
    """The same divergence in the forward's save hook and the adaptive
    reverse's jump matcher (ROADMAP §3): the decay of
    test_float32_short_span_divergence saved at 0, T/2 and T, loss Σ ys.
    Under JAX's floor every save row holds u0 and every jump fires at t1
    (test_float32_short_span_divergence); the port's rows are
    u0·e^(−pt) to the solve's tolerance (rtol 1e-4), and every rule's
    gradient is the analytic Σₖ e^(−ptₖ) in u0 and −Σₖ tₖ·Σu0·e^(−ptₖ) in
    p (rtol 1e-3)."""
    u0, p, T = np.array([1.0, 0.5], np.float32), np.array([1e7], np.float32), 1e-7
    ts = np.array([0.0, T / 2, T])
    decays = np.exp(-p[0] * ts)
    uu = torch.from_numpy(u0).requires_grad_()
    pp = torch.from_numpy(p).requires_grad_()
    sol = P.solve(P.ODEProblem(_decay, uu, (0.0, T), pp), P.Tsit5(),
                  sensealg=getattr(P, rule)(**kwargs), saveat=ts.tolist(),
                  rtol=1e-4, atol=1e-6)
    sol.ys.sum().backward()
    assert sol.retcode == 0 and sol.adjoint.stats.retcode == 0
    assert_close(sol.ys.detach(), decays[:, None] * u0[None], rtol=1e-4)
    assert_close(uu.grad, [decays.sum()] * 2, rtol=1e-3)
    assert_close(pp.grad, [-(ts * decays).sum() * u0.sum()], rtol=1e-3)


def test_checkpoints_refusals_match_jax():
    """checkpoints= needs checkpointing=True, and the times must lie inside
    tspan: the same ValueErrors in both packages."""
    field_j, field_p, u0, p, tspan = LV
    cases = [(dict(checkpoints=(0.5,)), "requires checkpointing=True"),
             (dict(checkpointing=True, checkpoints=(0.5, 1.5)),
              "inside tspan")]
    for kwargs, msg in cases:
        with pytest.raises(ValueError, match=msg):
            J.solve(J.ODEProblem(field_j, jnp.asarray(u0), tspan,
                                 jnp.asarray(p)), J.Tsit5(),
                    sensealg=J.InterpolatingAdjoint(**kwargs))
        with pytest.raises(ValueError, match=msg):
            P.solve(P.ODEProblem(field_p, to_port(u0), tspan, to_port(p)),
                    P.Tsit5(), sensealg=P.InterpolatingAdjoint(**kwargs))
