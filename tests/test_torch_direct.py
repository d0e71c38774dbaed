"""Parity of the port's adaptive DirectAdjoint (adjoints/direct.py:
`make_direct_solve_fn`, autograd through the eager adaptive loop) with the
JAX package's (autograd through the masked fixed-trip `integrate_scan`),
in float64 on the CPU.

JAX runs as one program compiled at XLA optimization level 0
(`torch_parity.jax_o0`), as the adaptive parity tests of
test_torch_solve.py do: an optimized program contracts multiply-adds into
FMAs, and the controller's error on a step clipped to a save time is
dominated by roundoff, so only a program whose rounding is op by op takes
the port's exact steps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (assert_close, jax_o0, lotka_volterra_jax,
                          lotka_volterra_port, to_numpy, to_port)

import scimlsensitivity_jl_tpu as J
import scimlsensitivity_jl_tpu_torch as P

U0 = np.array([1.0, 1.0])
PRM = np.array([1.5, 1.0, 3.0, 1.0])
T1 = 1.0
TS = np.array([0.0, 0.3, 0.6, 1.0])
# 13 attempts reach t1 from dt0 = 0.5 (11 accepted, 2 rejected); the
# scan runs all of its max_steps iterations
MAX_STEPS = 16
KW = dict(saveat=TS, rtol=1e-6, atol=1e-9)


def _jax_run(max_steps=MAX_STEPS, dt0=0.5, **sense):
    """((ū0, p̄), ys, counts) of Σ ys² through JAX's DirectAdjoint."""

    def loss(u0, p):
        sol = J.solve(J.ODEProblem(lotka_volterra_jax, u0, (0.0, T1), p),
                      J.Tsit5(), sensealg=J.DirectAdjoint(**sense),
                      max_steps=max_steps, dt0=dt0, **KW)
        st = sol.stats
        return jnp.sum(sol.ys ** 2), (sol.ys, st.n_accepted, st.n_rejected,
                                      st.n_fevals, sol.retcode)

    (_, aux), grads = jax_o0(
        jax.value_and_grad(loss, argnums=(0, 1), has_aux=True),
        jnp.asarray(U0), jnp.asarray(PRM))
    ys, n_acc, n_rej, n_fev, rc = aux
    counts = (int(n_acc), int(n_rej), int(n_fev), int(rc))
    return [np.asarray(g) for g in grads], np.asarray(ys), counts


def _port_run(max_steps=MAX_STEPS, dt0=0.5, **sense):
    u0 = to_port(U0).requires_grad_()
    p = to_port(PRM).requires_grad_()
    sol = P.solve(P.ODEProblem(lotka_volterra_port, u0, (0.0, T1), p),
                  P.Tsit5(),
                  sensealg=P.DirectAdjoint(**sense), max_steps=max_steps,
                  dt0=dt0, **KW)
    st = sol.stats
    grads = torch.autograd.grad(torch.sum(sol.ys ** 2), (u0, p))
    counts = (st.n_accepted, st.n_rejected, st.n_fevals, sol.retcode)
    return grads, sol.ys.detach(), counts


def test_lotka_volterra_matches_jax():
    """Rejections included (dt0 = 0.5): the same accepted and rejected
    counts, n_fevals (max_steps·stages, the scan's fixed trip) and retcode;
    ys within 1e-12, gradients within 1e-9 relative."""
    g_j, ys_j, counts_j = _jax_run()
    g_p, ys_p, counts_p = _port_run()
    assert counts_p == counts_j
    assert counts_p[3] == 0 and counts_p[2] == MAX_STEPS * 7
    assert counts_p[1] > 0
    assert_close(ys_p, ys_j, atol=1e-12)
    for got, want in zip(g_p, g_j):
        assert_close(got, want, rtol=1e-9, atol=1e-9 * np.abs(want).max())


def test_remat_gives_the_same_gradient():
    """remat=True, with the automatic first step: the same gradient (1e-13),
    and the backward pass evaluates the field again, 6 fresh Tsit5 stages
    per accepted step."""
    calls = {"n": 0}

    def counted(u, p, t):
        calls["n"] += 1
        return lotka_volterra_port(u, p, t)

    runs = {}
    for remat in (False, True):
        calls["n"] = 0
        u0 = to_port(U0).requires_grad_()
        p = to_port(PRM).requires_grad_()
        sol = P.solve(P.ODEProblem(counted, u0, (0.0, T1), p), P.Tsit5(),
                      sensealg=P.DirectAdjoint(remat=remat), max_steps=64,
                      **KW)
        forward = calls["n"]
        grads = torch.autograd.grad(torch.sum(sol.ys ** 2), (u0, p))
        runs[remat] = (grads, forward, calls["n"] - forward,
                       sol.stats.n_accepted)
    (g0, fwd0, bwd0, _), (g1, fwd1, bwd1, n_acc) = runs[False], runs[True]
    for a, b in zip(g1, g0):
        assert float((a - b).abs().max() / b.abs().max()) <= 1e-13
    assert fwd1 == fwd0 and bwd0 == 0
    assert bwd1 == 6 * n_acc


def test_small_budget_poisons_both_with_nan():
    """4 attempts cannot reach t1: retcode 1 (MaxIters), NaN values and NaN
    gradients in both packages, and a NaN dense output in the port."""
    g_j, ys_j, counts_j = _jax_run(max_steps=4)
    g_p, ys_p, counts_p = _port_run(max_steps=4)
    assert counts_p == counts_j and counts_p[3] == 1
    assert np.isnan(to_numpy(ys_p)).all() and np.isnan(ys_j).all()
    for got, want in zip(g_p, g_j):
        assert np.isnan(to_numpy(got)).all() and np.isnan(want).all()
    sol = P.solve(P.ODEProblem(lotka_volterra_port, to_port(U0), (0.0, T1),
                               to_port(PRM)), P.Tsit5(),
                  sensealg=P.DirectAdjoint(), max_steps=4, dense=True, **KW)
    assert np.isnan(to_numpy(sol([0.1, 0.2]))).all()


def test_unroll_guard_raises_in_both():
    """adaptive + unroll=True dispatches to DirectAdjoint in both packages,
    and more than 256 steps raise."""
    prob_j = J.ODEProblem(lotka_volterra_jax, jnp.asarray(U0), (0.0, T1),
                          jnp.asarray(PRM))
    prob_p = P.ODEProblem(lotka_volterra_port, to_port(U0), (0.0, T1),
                          to_port(PRM))
    with pytest.raises(ValueError, match="256"):
        J.solve(prob_j, J.Tsit5(), unroll=True, max_steps=300, **KW)
    with pytest.raises(ValueError, match="256"):
        P.solve(prob_p, P.Tsit5(), unroll=True, max_steps=300, **KW)
    sol = P.solve(prob_p, P.Tsit5(), unroll=True, max_steps=64, **KW)
    assert isinstance(sol.sensealg, P.DirectAdjoint) and sol.retcode == 0


def test_bf16_adaptive_direct_save_time_matching_divergence():
    """F2, a deliberate divergence (ROADMAP §3): with a bfloat16 state the
    port matches save times within 64 eps of its float32 time dtype
    (`match_tol`), JAX within 64 eps of bfloat16 (0.5 at |t| ≤ 1). On
    u' = −u from u0 = 1 with saves at [0.25, 0.5, 1.0], JAX takes the two
    first save times as reached at t0 and its rows there hold u0; the
    port's rows hold u(tᵢ) = e^{−tᵢ} to bfloat16 precision (2⁻⁷ relative).
    JAX's row at t1 is the state of its first step end past t1 − 0.5, while
    both packages' u_final is e^{−1} (2⁻⁶)."""
    sv = [0.25, 0.5, 1.0]
    kw = dict(saveat=sv, rtol=1e-2, atol=1e-3, max_steps=64)
    port = P.solve(P.ODEProblem(lambda u, p, t: -p * u,
                                torch.tensor([1.0], dtype=torch.bfloat16),
                                (0.0, 1.0),
                                torch.tensor(1.0, dtype=torch.bfloat16)),
                   sensealg=P.DirectAdjoint(), **kw)
    ref = J.solve(J.ODEProblem(lambda u, p, t: -p * u,
                               jnp.array([1.0], jnp.bfloat16), (0.0, 1.0),
                               jnp.asarray(1.0, jnp.bfloat16)),
                  sensealg=J.DirectAdjoint(), **kw)
    ys_port = port.ys.float().numpy()[:, 0]
    ys_jax = np.asarray(ref.ys, np.float32)[:, 0]
    np.testing.assert_array_equal(ys_jax[:2], [1.0, 1.0])
    np.testing.assert_allclose(ys_port, np.exp(-np.asarray(sv)), rtol=2**-7)
    assert np.all(np.abs(ys_port[:2] - 1.0) > 0.2)
    assert abs(ys_jax[2] - np.exp(-1.0)) > 0.1
    for uf in (port.u_final.float().numpy(), np.asarray(ref.u_final,
                                                         np.float32)):
        np.testing.assert_allclose(uf, [np.exp(-1.0)], rtol=2**-6)
