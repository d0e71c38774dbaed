"""Parity of the port's shadowing (adjoints/shadowing: LSS, NILSS, NILSAS,
and solve's shadowing rule) with the JAX package's, in float64 on the
CPU, on the cases of tests/test_shadowing.py: Lorenz at ρ = 28 and the
literature's d⟨z⟩/dρ ≈ 1.01.

  * LSS takes JAX's attractor trajectory (1001 rows on (30, 40)) through
    numpy: each regularizer's result matches JAX's to 1e-10;
  * the block-Thomas solve against the dense Schur matrix (1e-9), and the
    Nt = 10⁴ trajectory (JAX's, through numpy) within 0.1 of 1.01;
  * NILSS and NILSAS, sequential and segment_parallel, draw JAX's random
    tangents through `torch_parity.JaxKey` and match JAX to 1e-8 relative
    on a short horizon, (30, 31.5) in 3 segments (roundoff grows ~e^0.9
    per time unit on the attractor, and JAX's (30, 60) cases take ~10^5
    tangent or adjoint evaluations of host-paced `torch.func` calls, so
    they run in chip_smoke.py's phase 5n on the card instead);
  * the gradient of a weighted sum loss Σᵢ wᵢ·zᵢ (rows that differ)
    over `solve` under each of the four rules matches jax.grad over
    J.solve: LSS on (30, 31) to 1e-10, NILSS and NILSAS on (30, 31.5)
    with JAX's draws handed through solve's key, NILSS to 1e-8 and
    NILSAS to 1e-4 (its lifted forcing jumps, and a one-ulp move of u0
    moves JAX's own result by 1.1e-5); under LSS the
    plain sum equals the direct problem with ∂g/∂u = e_z (1e-12), within
    JAX's tolerance of 1.01; NILSS without g raises JAX's ValueError;
  * ForwardLSS, AdjointLSS and NILSS on a kernel field (the fused MLP
    field, whose plain version runs on the CPU) raise
    ForwardModeUnsupported before the field's operator runs; NILSAS on it
    calls the pullback per row and equals the plain field's vmapped
    pullback.

JAX references are compiled at XLA level 0 (`torch_parity.jax_o0`) where
they are functions of arrays, and cached per module."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import JaxKey, jax_o0

import scimlsensitivity_jl_tpu as J
import scimlsensitivity_jl_tpu_torch as P
from scimlsensitivity_jl_tpu.adjoints.shadowing.nilsas import \
    nilsas_shadow_adjoint as j_nilsas
from scimlsensitivity_jl_tpu.adjoints.shadowing.nilss import \
    nilss_shadow_forward as j_nilss
from scimlsensitivity_jl_tpu_torch.adjoints.continuous import AdjointRecord
from scimlsensitivity_jl_tpu_torch.adjoints.shadowing.lss import (
    _build_lss, _schur_solve)
from scimlsensitivity_jl_tpu_torch.ops import mlp as mlp_ops
from scimlsensitivity_jl_tpu_torch.ops.vjp import ForwardModeUnsupported
from scimlsensitivity_jl_tpu_torch.solvers.integrate import Stats

DT = torch.float64
RHO_SENS = 1.01  # literature value of d<z>/drho at rho = 28
U0 = np.array([-2.259143724332269, -2.47457604992522, 18.939914218990612])
TS = np.arange(0.0, 10.0 + 1e-9, 0.01) + 30.0
SHORT = (30.0, 31.5)  # the NILSS / NILSAS parity horizon
NSEG, NSTEP = 3, 26
SEED = 1234  # NILSS / NILSAS rng_seed
# the loss Σᵢ wᵢ·zᵢ under solve's rule against JAX's: rows that differ, so
# a wrong row (or a wrong nearest-save-time lift) shows. LSS on (30, 31)
# at 11 rows, where the port and JAX take the same 171 steps: on a denser
# grid or a longer span the adaptive steps part (on (30, 40) at 1001 rows,
# 3360 against 3486: the step after one clipped onto a save time reads a
# roundoff-sized error estimate), and the chaotic trajectories then differ
# by ~1e-7 at rtol 1e-8, so the rules could not be held tightly there
TS_LSS = np.linspace(30.0, 31.0, 11)
W_LSS = np.random.default_rng(7).uniform(0.5, 1.5, TS_LSS.shape[0])
TS_SHORT = np.linspace(SHORT[0], SHORT[1], 16)
W_SHORT = np.random.default_rng(8).uniform(0.5, 1.5, TS_SHORT.shape[0])
LSS_SOLVE = dict(rtol=1e-8, atol=1e-10, max_steps=16384)
# NILSAS's primal under the rule takes the solve's tolerances, JAX's its
# fwd_rtol / fwd_atol defaults: the solve runs at those
NIL_SOLVE = dict(rtol=1e-11, atol=1e-13, max_steps=16384)


def lorenz_jax(u, p, t):
    return jnp.stack([10.0 * (u[1] - u[0]), u[0] * (p[0] - u[2]) - u[1],
                      u[0] * u[1] - (8.0 / 3.0) * u[2]])


def lorenz_port(u, p, t):
    return torch.stack([10.0 * (u[1] - u[0]), u[0] * (p[0] - u[2]) - u[1],
                        u[0] * u[1] - (8.0 / 3.0) * u[2]])


def g(u, p, t):
    return u[2]


def ten(x):
    return torch.tensor(np.asarray(x, float), dtype=DT)


def port_prob(tspan, u0=U0):
    return P.ODEProblem(lorenz_port, ten(u0), tspan, ten([28.0]))


def port_solution(ts, ys, tspan):
    return P.ODESolution(ts=ten(ts), ys=ten(ys), stats=Stats(0, 0, 0, 0),
                         retcode=0, prob=port_prob(tspan))


def e_z(u, p, t):
    return torch.tensor([0.0, 0.0, 1.0], dtype=DT)


REGS = ["CosWindowing", "Cos2Windowing", "TimeDilation"]


def _reg(M, name):
    return M.TimeDilation(10.0) if name == "TimeDilation" else getattr(M, name)()


@pytest.fixture(scope="module")
def lss_ref():
    """JAX's attractor trajectory (tests/test_shadowing.py:attractor_sol)
    and its LSS results."""
    sol = J.solve(J.ODEProblem(lorenz_jax, jnp.asarray(U0), (30.0, 40.0),
                               jnp.array([28.0])), J.Tsit5(),
                  saveat=jnp.asarray(TS), rtol=1e-11, atol=1e-13,
                  max_steps=16384)
    out = {"ts": np.asarray(sol.ts), "ys": np.asarray(sol.ys)}
    for name in REGS:
        out[name] = float(J.shadow_forward(J.ForwardLSSProblem(
            sol, J.ForwardLSS(LSSregularizer=_reg(J, name), g=g)))[0])
    out["dgdu"] = float(J.shadow_forward(J.ForwardLSSProblem(
        sol, J.ForwardLSS(LSSregularizer=J.TimeDilation(10.0), g=g),
        dgdu_continuous=lambda u, p, t: jnp.array([0.0, 0.0, 1.0])))[0])
    out["adjoint"] = float(J.shadow_adjoint(J.AdjointLSSProblem(
        sol, J.AdjointLSS(LSSregularizer=J.TimeDilation(10.0), g=g)))[0])
    return out


def _rel(a, b):
    return abs(a - b) / abs(b)


def _lss_sensealg(M, rule):
    return (M.ForwardLSS(LSSregularizer=M.CosWindowing()) if rule == "ForwardLSS"
            else M.AdjointLSS(LSSregularizer=M.TimeDilation(10.0), g=g))


@pytest.fixture(scope="module")
def lss_solve_ref():
    """jax.grad of Σᵢ W_LSS[i]·zᵢ over J.solve on (30, 31) under
    ForwardLSS and AdjointLSS (eager: JAX's LSS reads the save times on
    the host)."""
    def loss(q, rule):
        sol = J.solve(J.ODEProblem(lorenz_jax, jnp.asarray(U0), (30.0, 31.0),
                                   q), J.Tsit5(), saveat=jnp.asarray(TS_LSS),
                      sensealg=_lss_sensealg(J, rule), **LSS_SOLVE)
        return jnp.sum(jnp.asarray(W_LSS) * sol.ys[:, 2])

    return {rule: float(jax.grad(loss)(jnp.array([28.0]), rule)[0])
            for rule in ("ForwardLSS", "AdjointLSS")}


@pytest.mark.parametrize("reg", REGS)
def test_forward_lss_matches_jax(lss_ref, reg):
    """ForwardLSS on JAX's trajectory: JAX's value to 1e-10, and within
    the JAX test's 0.12 of 1.01."""
    sol = port_solution(lss_ref["ts"], lss_ref["ys"], (30.0, 40.0))
    res = P.shadow_forward(P.ForwardLSSProblem(
        sol, P.ForwardLSS(LSSregularizer=_reg(P, reg), g=g)))
    assert res.shape == (1,)
    assert _rel(float(res[0]), lss_ref[reg]) <= 1e-10, (float(res[0]),
                                                        lss_ref[reg])
    assert abs(float(res[0]) - RHO_SENS) <= 0.12


def test_forward_lss_with_dgdu_matches_jax(lss_ref):
    sol = port_solution(lss_ref["ts"], lss_ref["ys"], (30.0, 40.0))
    res = P.shadow_forward(P.ForwardLSSProblem(
        sol, P.ForwardLSS(LSSregularizer=P.TimeDilation(10.0), g=g),
        dgdu_continuous=e_z))
    assert _rel(float(res[0]), lss_ref["dgdu"]) <= 1e-10
    assert abs(float(res[0]) - RHO_SENS) <= 0.12


def test_adjoint_lss_matches_jax(lss_ref):
    """AdjointLSS: JAX's value to 1e-10, 1.01 within 0.12, the forward
    LSS within 0.05; a regularizer other than TimeDilation is refused as
    in JAX, and the dispatch raises TypeError on other problems."""
    sol = port_solution(lss_ref["ts"], lss_ref["ys"], (30.0, 40.0))
    adj = P.shadow_adjoint(P.AdjointLSSProblem(
        sol, P.AdjointLSS(LSSregularizer=P.TimeDilation(10.0), g=g)))
    assert _rel(float(adj[0]), lss_ref["adjoint"]) <= 1e-10
    assert abs(float(adj[0]) - RHO_SENS) <= 0.12
    assert abs(float(adj[0]) - lss_ref["TimeDilation"]) <= 0.05
    with pytest.raises(NotImplementedError, match="TimeDilation"):
        P.AdjointLSSProblem(sol, P.AdjointLSS(LSSregularizer=P.CosWindowing(),
                                              g=g))
    with pytest.raises(TypeError, match="shadow_forward"):
        P.shadow_forward(object())
    with pytest.raises(TypeError, match="shadow_adjoint"):
        P.shadow_adjoint(P.ForwardLSSProblem(sol, P.ForwardLSS(g=g)))


def test_lss_block_thomas_matches_dense():
    """The block-tridiagonal Schur solve equals the dense assembly
    (tests/test_shadowing.py:210-235) to 1e-9."""
    sol = P.solve(port_prob((0.0, 6.0), u0=[1.0, 0.0, 0.0]), P.Tsit5(),
                  saveat=np.linspace(0.0, 6.0, 101), rtol=1e-8, atol=1e-10)
    data = _build_lss(sol, P.ForwardLSS(LSSregularizer=P.TimeDilation(10.0),
                                        g=g), None, None, g)
    Ndt, n = data.Sd.shape[0], data.n
    S = np.zeros((Ndt * n, Ndt * n))
    for i in range(Ndt):
        S[i*n:(i+1)*n, i*n:(i+1)*n] = data.Sd[i].numpy()
        if i < Ndt - 1:
            S[i*n:(i+1)*n, (i+1)*n:(i+2)*n] = data.Su[i].numpy()
            S[(i+1)*n:(i+2)*n, i*n:(i+1)*n] = data.Su[i].numpy().T
    rhs = np.random.default_rng(0).normal(size=(Ndt, n, 2))
    x_block = _schur_solve(data, ten(rhs)).numpy().reshape(Ndt * n, 2)
    x_dense = np.linalg.solve(S, rhs.reshape(Ndt * n, 2))
    np.testing.assert_allclose(x_block, x_dense, rtol=1e-7, atol=1e-9)


def test_forward_lss_long_trajectory_nt1e4():
    """ForwardLSS at Nt = 10⁴ (JAX's trajectory through numpy) in
    O(Nt·n²) memory, within 0.1 of 1.01 (tests/test_shadowing.py:238)."""
    Nt, T = 10_000, 100.0

    def trajectory():
        warm = J.solve(J.ODEProblem(lorenz_jax, jnp.array([1.0, 0.0, 0.0]),
                                    (0.0, 30.0), jnp.array([28.0])),
                       J.Tsit5(), saveat=jnp.array([0.0, 30.0]), rtol=1e-8,
                       atol=1e-10)
        sol = J.solve(J.ODEProblem(lorenz_jax, warm.ys[-1], (0.0, T),
                                   jnp.array([28.0])), J.Tsit5(),
                      saveat=jnp.linspace(0.0, T, Nt), rtol=1e-8, atol=1e-10,
                      max_steps=65536)
        return np.asarray(sol.ts), np.asarray(sol.ys)

    ts, ys = trajectory()
    sol = P.ODESolution(ts=ten(ts), ys=ten(ys), stats=Stats(0, 0, 0, 0),
                        retcode=0, prob=port_prob((0.0, T), u0=ys[0]))
    res = P.shadow_forward(P.ForwardLSSProblem(sol, P.ForwardLSS(
        LSSregularizer=P.TimeDilation(10.0, 5.0, 5.0), g=g)))
    assert abs(float(res[0]) - 1.01) < 0.1, float(res[0])


# -- NILSS and NILSAS against JAX on a short horizon ----------------------------


@pytest.fixture(scope="module")
def nil_ref():
    """JAX's NILSS and NILSAS, sequential and segment_parallel, on SHORT."""
    def run(p):
        prob = J.ODEProblem(lorenz_jax, jnp.asarray(U0), SHORT, p)
        out = {}
        for par in (False, True):
            out[f"NILSS {par}"] = j_nilss(
                J.NILSSProblem(prob, J.NILSS(nseg=NSEG, nstep=NSTEP), g=g),
                segment_parallel=par)
            out[f"NILSAS {par}"] = j_nilsas(
                J.NILSASProblem(prob, J.NILSAS(nseg=NSEG, nstep=NSTEP, M=2),
                                g=g),
                fwd_rtol=1e-10, max_steps=32768, segment_parallel=par)
        # jax.grad of Σᵢ W_SHORT[i]·zᵢ over J.solve under each rule
        for name, sa in (
                ("solve NILSS", J.NILSS(nseg=NSEG, nstep=NSTEP, g=g)),
                ("solve NILSAS", J.NILSAS(nseg=NSEG, nstep=NSTEP, M=2))):
            out[name] = jax.grad(lambda q, sa=sa: jnp.sum(
                jnp.asarray(W_SHORT) * J.solve(
                    J.ODEProblem(lorenz_jax, jnp.asarray(U0), SHORT, q),
                    J.Tsit5(), saveat=jnp.asarray(TS_SHORT), sensealg=sa,
                    **NIL_SOLVE).ys[:, 2]))(p)
        return out

    return {k: float(v[0]) for k, v in jax_o0(run, jnp.array([28.0])).items()}


@pytest.mark.parametrize("segment_parallel", [False, True])
def test_nilss_matches_jax(nil_ref, segment_parallel):
    """NILSS with JAX's tangents (JaxKey): JAX's value to 1e-8 relative."""
    nprob = P.NILSSProblem(port_prob(SHORT), P.NILSS(nseg=NSEG, nstep=NSTEP),
                           g=g)
    res = P.shadow_forward(nprob, segment_parallel=segment_parallel,
                           key=JaxKey(jax.random.PRNGKey(SEED)))
    assert res.shape == (1,)
    ref = nil_ref[f"NILSS {segment_parallel}"]
    assert _rel(float(res[0]), ref) <= 1e-8, (float(res[0]), ref)


@pytest.mark.parametrize("segment_parallel", [False, True])
def test_nilsas_matches_jax(nil_ref, segment_parallel):
    """NILSAS with JAX's terminal draw (JaxKey): JAX's value to 1e-8
    relative."""
    nprob = P.NILSASProblem(port_prob(SHORT),
                            P.NILSAS(nseg=NSEG, nstep=NSTEP, M=2), g=g)
    res = P.nilsas_shadow_adjoint(nprob, fwd_rtol=1e-10, max_steps=32768,
                                  segment_parallel=segment_parallel,
                                  key=JaxKey(jax.random.PRNGKey(SEED)))
    ref = nil_ref[f"NILSAS {segment_parallel}"]
    assert _rel(float(res[0]), ref) <= 1e-8, (float(res[0]), ref)


def test_nilss_fewer_tangents_than_states_matches_jax():
    """NILSS(nus=1) on Lorenz (two tangent rows, fewer than the three
    states): JAX's value to 1e-8 relative on (30, 30.5) in 2 segments."""
    sa = dict(nseg=2, nstep=11, nus=1)
    ref = float(jax_o0(lambda p: j_nilss(J.NILSSProblem(
        J.ODEProblem(lorenz_jax, jnp.asarray(U0), (30.0, 30.5), p),
        J.NILSS(**sa), g=g)), jnp.array([28.0]))[0])
    res = P.shadow_forward(
        P.NILSSProblem(port_prob((30.0, 30.5)), P.NILSS(**sa), g=g),
        key=JaxKey(jax.random.PRNGKey(SEED)))
    assert _rel(float(res[0]), ref) <= 1e-8, (float(res[0]), ref)


# -- the gradient over solve ------------------------------------------------------


def _loss_grad(sensealg, tspan, saveat, **kw):
    p = ten([28.0]).requires_grad_()
    sol = P.solve(P.ODEProblem(lorenz_port, ten(U0), tspan, p), P.Tsit5(),
                  saveat=saveat, sensealg=sensealg, **kw)
    (grad,) = torch.autograd.grad(torch.sum(sol.ys[:, 2]), p)
    return float(grad[0]), sol


@pytest.mark.parametrize("rule", ["ForwardLSS", "AdjointLSS"])
def test_grad_over_solve_lss(lss_solve_ref, rule):
    """The sum of z over the save rows, differentiated through solve
    under ForwardLSS (Cos) or AdjointLSS (TimeDilation 10): the direct
    LSS problem on the solve's rows with ∂g/∂u = e_z to 1e-12, within
    JAX's 0.15 of 1.01 (tests/test_shadowing.py:138-159, on (30, 40) at
    rtol 1e-8, JAX's 1e-11). The weighted sum Σᵢ wᵢ·zᵢ (rows that
    differ) on (30, 31) matches jax.grad over J.solve to 1e-10, and u0
    gets a zero gradient."""
    sa = _lss_sensealg(P, rule)
    grad, sol = _loss_grad(sa, (30.0, 40.0), TS, **LSS_SOLVE)
    lss = getattr(P, f"{rule}Problem")(
        P.ODESolution(ts=sol.ts, ys=sol.ys.detach(), stats=sol.stats,
                      retcode=0, prob=port_prob((30.0, 40.0))),
        sa, dgdu_continuous=e_z)
    direct = (P.shadow_forward(lss) if rule == "ForwardLSS"
              else P.shadow_adjoint(lss))
    assert _rel(grad, float(direct[0])) <= 1e-12
    assert abs(grad - RHO_SENS) <= 0.15, grad
    u0, p = ten(U0).requires_grad_(), ten([28.0]).requires_grad_()
    sol = P.solve(P.ODEProblem(lorenz_port, u0, (30.0, 31.0), p), P.Tsit5(),
                  saveat=TS_LSS, sensealg=sa, **LSS_SOLVE)
    du0, dp = torch.autograd.grad(torch.sum(ten(W_LSS) * sol.ys[:, 2]),
                                  (u0, p))
    assert torch.equal(du0, torch.zeros_like(du0))
    assert _rel(float(dp[0]), lss_solve_ref[rule]) <= 1e-10, (
        float(dp[0]), lss_solve_ref[rule])


@pytest.mark.parametrize("rule", ["NILSS", "NILSAS"])
def test_grad_over_solve_nilss_nilsas(nil_ref, rule):
    """NILSS and NILSAS under a gradient of solve lift the cotangent rows
    to the nearest save time's (JAX solve.py:737-765): the weighted sum
    Σᵢ wᵢ·zᵢ over 16 save rows on SHORT (rows that differ, so a wrong
    row shows), with JAX's draws handed through solve's key, matches
    jax.grad over J.solve, with JAX's segment tolerances and NILSAS's
    primal at the solve's rtol: NILSS, which reads the rows at its
    segment grid's points, to 1e-8 relative; NILSAS, whose adjoint field
    reads them at every stage time and so integrates a forcing that jumps
    midway between save times, to 1e-4: there a one-ulp move of u0 moves
    JAX's own gradient by up to 1.1e-5 relative, and the port's by 2.1e-6
    (tests/shadowing_roundoff_witness.py), where giving every row its
    neighbour's weight moves it by 1.9."""
    sa = (P.NILSS(nseg=NSEG, nstep=NSTEP, g=g) if rule == "NILSS"
          else P.NILSAS(nseg=NSEG, nstep=NSTEP, M=2))
    p = ten([28.0]).requires_grad_()
    sol = P.solve(P.ODEProblem(lorenz_port, ten(U0), SHORT, p), P.Tsit5(),
                  saveat=TS_SHORT, sensealg=sa,
                  key=JaxKey(jax.random.PRNGKey(SEED)), **NIL_SOLVE)
    (grad,) = torch.autograd.grad(torch.sum(ten(W_SHORT) * sol.ys[:, 2]), p)
    ref = nil_ref[f"solve {rule}"]
    assert np.isfinite(float(grad[0]))
    tol = 1e-8 if rule == "NILSS" else 1e-4
    assert _rel(float(grad[0]), ref) <= tol, (float(grad[0]), ref)
    assert sol.adjoint.reverse == rule and sol.adjoint.stats.retcode == 0


def test_grad_over_solve_nilss_needs_g():
    """NILSS without g under a gradient of solve raises JAX's ValueError."""
    with pytest.raises(ValueError, match="NILSS.*g"):
        _loss_grad(P.NILSS(nseg=4, nstep=6), (30.0, 32.0),
                   np.arange(0.0, 2.0 + 1e-9, 0.1) + 30.0)


# -- kernel fields -------------------------------------------------------------------


@pytest.fixture
def mlp_field():
    """The fused MLP field (its plain versions on the CPU) on a 3-state
    problem, and a counter of its forward operator's runs."""
    g_ = np.random.default_rng(1)
    mlp = {"W0": 0.5 * g_.standard_normal((3, 8)), "b0": np.zeros(8),
           "W1": 0.3 * g_.standard_normal((8, 3)), "b1": np.zeros(3)}
    params = {k: ten(v) for k, v in mlp.items()}
    runs = []
    plain = mlp_ops.mlp2_fwd_reference

    def counted(*args):
        runs.append(1)
        return plain(*args)

    mlp_ops.mlp2_fwd_reference = counted
    try:
        yield params, runs
    finally:
        mlp_ops.mlp2_fwd_reference = plain


def test_kernel_field_refusals_before_launch(mlp_field):
    """ForwardLSS, AdjointLSS (direct and under solve) and NILSS on the
    fused MLP field raise ForwardModeUnsupported naming the kernel
    Function before its forward operator runs, as JAX's custom_vjp field
    refuses jacfwd / jvp."""
    params, runs = mlp_field
    prob = P.ODEProblem(lambda u, q, t: P.fused_mlp2(q, u),
                        ten([0.5, -0.2, 0.1]), (0.0, 0.5), params)
    sol = P.solve(prob, P.Tsit5(), saveat=np.linspace(0.0, 0.5, 11))
    sg = lambda u, q, t: u[0]  # noqa: E731
    runs.clear()
    with pytest.raises(ForwardModeUnsupported, match="FusedMLP2"):
        P.ForwardLSSProblem(sol, P.ForwardLSS(g=sg))
    with pytest.raises(ForwardModeUnsupported, match="FusedMLP2"):
        P.AdjointLSSProblem(sol, P.AdjointLSS(g=sg))
    with pytest.raises(ForwardModeUnsupported, match="FusedMLP2"):
        P.shadow_forward(P.NILSSProblem(prob, P.NILSS(nseg=2, nstep=5), g=sg))
    assert not runs
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    sol = P.solve(P.ODEProblem(prob.f, prob.u0, prob.tspan, leaves),
                  P.Tsit5(), saveat=np.linspace(0.0, 0.5, 11),
                  sensealg=P.ForwardLSS())
    runs.clear()
    with pytest.raises(ForwardModeUnsupported, match="FusedMLP2"):
        torch.autograd.grad(torch.sum(sol.ys), list(leaves.values()))
    assert not runs


def test_nilsas_on_kernel_field_matches_plain_field(mlp_field):
    """NILSAS on the fused MLP field calls the pullback once per adjoint
    row (the kernel Function has no vmap rule): one forward operator run
    per right-hand side evaluation, and the plain field's vmapped pullback
    gives the same gradient to 1e-12."""
    params, runs = mlp_field
    u0 = ten([0.5, -0.2, 0.1])
    sa = P.NILSAS(nseg=2, nstep=5, M=2)
    sg = lambda u, q, t: torch.sum(u ** 2) / 3.0  # noqa: E731
    tols = dict(rtol=1e-8, atol=1e-10, fwd_rtol=1e-9, fwd_atol=1e-11)
    got = {}
    for name, field in (("kernel", lambda u, q, t: P.fused_mlp2(q, u)),
                        ("plain", lambda u, q, t: P.mlp_apply(q, u))):
        rec = AdjointRecord()
        runs.clear()
        got[name] = P.nilsas_shadow_adjoint(P.NILSASProblem(
            P.ODEProblem(field, u0, (0.0, 1.0), params), sa, g=sg),
            record=rec, **tols)
        got[name + " runs"] = len(runs)
        got[name + " rec"] = rec
    rec = got["kernel rec"]
    # primal: f0, the initial step's probe and 6 per attempt; segments:
    # the same per segment, one forward run each; and f(u_T)
    want = (2 + 6 * (rec.primal.n_accepted + rec.primal.n_rejected) + 1
            + 2 * sa.nseg + 6 * (rec.stats.n_accepted + rec.stats.n_rejected))
    assert got["kernel runs"] == want
    np.testing.assert_allclose(got["kernel"].numpy(), got["plain"].numpy(),
                               rtol=1e-12)
