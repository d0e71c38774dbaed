"""Parity of the port's DAEs on constant mass matrices (the mass-matrix
branch of solve, the DAE branches of the continuous rules, of
adjoint_sensitivities and of ODEAdjointProblem) with the JAX package's, in
float64 on the CPU: one case for each test of tests/test_dae.py, and the
mass-matrix cases of tests/test_interface.py and tests/test_dispatch.py.

JAX's `solve` tests the mass matrix's determinant on the host, so its DAE
branch cannot be compiled; the references hand the mass matrix to the
stepper (`SDIRK4().with_mass_matrix(M)`) on a problem without one, which
is what that branch does, and run compiled at XLA optimization level 0
(`torch_parity.jax_o0`), so the steps are the port's. dae_init="newton"
composes JAX's `solve_nonlinear` with that solve, as its branch does.

Sizes (not tolerances): Robertson runs on (0, 1e-3) with saves at 1e-4,
5e-4 and 1e-3, at rtol 1e-5 (the JAX tests: (0, 10) or (0, 100) at rtol
1e-8, hundreds of stiff reverse steps, each ~0.2 s of torch.func on a
CPU); the events sit inside that span. Tolerances: rows 1e-10 relative,
step counts and retcodes equal, gradients 1e-8 of max|g|; the rules that
have no JAX reference here are held to the port's ForwardDiffSensitivity
at the JAX tests' tolerances.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.integrate import solve_ivp

from torch_parity import jax_o0

import scimlsensitivity_jl_tpu as J
import scimlsensitivity_jl_tpu_torch as P
from scimlsensitivity_jl_tpu.adjoints.continuous import (
    _semi_explicit_split as j_split)
from scimlsensitivity_jl_tpu_torch.adjoints.continuous import (
    _semi_explicit_split as p_split)
from scimlsensitivity_jl_tpu_torch.ops.vjp import ForwardModeUnsupported

DT = torch.float64
P_ROB = np.array([0.04, 3e7, 1e4])
M_ROB = np.diag([1.0, 1.0, 0.0])
T1 = 1e-3
TS = np.array([1e-4, 5e-4, 1e-3])
U0D = np.array([1.0, 0.0])
KW = dict(rtol=1e-5, atol=1e-9, dt0=1e-5, max_steps=200, adj_rtol=1e-5,
          adj_atol=1e-9)
# the rotated Robertson of tests/test_dae.py: T·f_d on the differential rows
T_ROT = np.array([[1.0, 0.3], [0.2, 1.0]])
M_ROT = np.zeros((3, 3))
M_ROT[:2, :2] = T_ROT
P_ROT = np.array([0.04, 1e4, 3e7])


def ten(x):
    return torch.tensor(np.asarray(x, dtype=float), dtype=DT)


def max_rel(port, ref):
    port = np.asarray(port.detach() if isinstance(port, torch.Tensor)
                      else port, dtype=float)
    ref = np.asarray(ref, dtype=float)
    return float(np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-300))


def l2_rel(port, ref):
    port = np.asarray(port.detach(), dtype=float)
    ref = np.asarray(ref, dtype=float)
    return float(np.linalg.norm(port - ref) / np.linalg.norm(ref))


def rober(lib):
    def f(u, p, t):
        return lib.stack([-p[0] * u[0] + p[2] * u[1] * u[2],
                          p[0] * u[0] - p[1] * u[1] ** 2 - p[2] * u[1] * u[2],
                          u[0] + u[1] + u[2] - 1.0])
    return f


def rober_rot(lib):
    T = jnp.asarray(T_ROT) if lib is jnp else ten(T_ROT)

    def f(u, p, t):
        f_d = lib.stack([-p[0] * u[0] + p[1] * u[1] * u[2],
                         p[0] * u[0] - p[1] * u[1] * u[2] - p[2] * u[1] ** 2])
        f_a = u[0] + u[1] + u[2] - 1.0
        return lib.concatenate([T @ f_d, f_a[None]])
    return f


def _sensealg(mod, name):
    return None if name is None else getattr(mod, name)()


def dae_loss(mod, args, sensealg, *, field=rober, mass=M_ROB,
             solver="SDIRK4", callback=None, tstops=None, loss="rob",
             **kw):
    """The DAE loss over (log p, u0's differential part): JAX hands the mass
    to the stepper, the port takes it on the problem. Returns (L, (ys,
    accepted, rejected, retcode))."""
    lib = jnp if mod is J else torch
    logp, u0d = args
    u0 = lib.stack([u0d[0], u0d[1], 1.0 - u0d[0] - u0d[1]])
    stepper = getattr(mod, solver)()
    opts = dict(KW, **kw)
    if mod is J:
        prob = J.ODEProblem(field(jnp), u0, (0.0, T1), jnp.exp(logp))
        stepper = stepper.with_mass_matrix(mass)
        if tstops is not None:
            opts["tstops"] = jnp.asarray(tstops)
        sv = jnp.asarray(TS)
    else:
        prob = P.ODEProblem(field(torch), u0, (0.0, T1), torch.exp(logp),
                            mass_matrix=mass)
        if tstops is not None:
            opts["tstops"] = tstops
        sv = TS
    s = mod.solve(prob, stepper, saveat=sv, sensealg=_sensealg(mod, sensealg),
                  callback=None if callback is None else callback(mod, lib),
                  **opts)
    ys = s.ys
    if loss == "rob":
        L = 1e4 * lib.sum(ys[:, 1]) + lib.sum(ys[:, 2])
    else:
        L = (lib.sum(ys[:, 0] ** 2) + 1e4 * lib.sum(ys[:, 1] ** 2)
             + lib.sum(ys[:, 2] ** 2))
    return L, (ys, s.stats.n_accepted, s.stats.n_rejected, s.retcode)


def j_args(logp=None):
    return (jnp.log(jnp.asarray(P_ROB if logp is None else logp)),
            jnp.asarray(U0D))


def p_args(logp=None):
    return (ten(np.log(P_ROB if logp is None else logp)).requires_grad_(),
            ten(U0D).requires_grad_())


def _jax_dose(u, p, t):
    return jnp.abs(t - 5e-4) < 1e-12


def _port_dose(u, p, t):
    return abs(float(t) - 5e-4) < 1e-12


def _dose(mod, lib):
    """A constraint-consistent dose at t = 5e-4 (a tstop)."""
    return mod.DiscreteCallback(
        condition=_jax_dose if mod is J else _port_dose,
        affect=lambda u, p, t: lib.stack([u[0] - 0.01, u[1], u[2] + 0.01]))


def _crossing(mod, lib):
    """u0 falls through 0.99998 near t = 5e-4; the affect keeps the sum."""
    return mod.ContinuousCallback(
        condition=lambda u, p, t: u[0] - 0.99998,
        affect=lambda u, p, t: lib.stack([u[0] - 0.001, u[1], u[2] + 0.001]),
        direction=-1)


ROT = dict(field=rober_rot, mass=M_ROT, loss="sq")
# case -> (the point of log p, dae_loss keywords)
CASES = {
    "rob": (P_ROB, {}),
    "seulex": (P_ROB, dict(solver="Rodas4Like")),
    "fbdf": (P_ROB, dict(solver="FBDF")),
    "rot": (P_ROT, ROT),
    "dose": (P_ROT, dict(ROT, callback=_dose, tstops=np.array([5e-4]))),
    "cross": (P_ROT, dict(ROT, callback=_crossing)),
}


@functools.lru_cache(maxsize=None)
def jax_ref(sensealg, case="rob"):
    """JAX's (dL/dlog p, dL/du0_d) and (ys, accepted, rejected, retcode)."""
    point, kw = CASES[case]
    return jax_o0(jax.grad(lambda a: dae_loss(J, a, sensealg, **kw),
                           has_aux=True), j_args(point))


@functools.lru_cache(maxsize=None)
def port_run(sensealg, case="rob"):
    """The port's gradients and (ys, accepted, rejected, retcode)."""
    point, kw = CASES[case]
    args = p_args(point)
    L, aux = dae_loss(P, args, sensealg, **kw)
    return torch.autograd.grad(L, args), aux


def assert_rows_and_steps(aux_p, aux_j):
    ys, acc, rej, rc = aux_p
    assert (acc, rej, rc) == (int(aux_j[1]), int(aux_j[2]), int(aux_j[3]))
    assert l2_rel(ys, aux_j[0]) <= 1e-10


def assert_grads(gp, gj, tol=1e-8):
    for a, b in zip(gp, gj):
        assert torch.isfinite(a).all()
        assert max_rel(a, b) <= tol, (a, b)


def test_robertson_dae_forward():
    """Robertson in semi-explicit form on SDIRK4: the port's rows, steps and
    retcode equal JAX's (1e-10), and its rows Radau's on the ODE form
    (rtol 1e-10) to 1e-5 relative, as the JAX test holds them."""
    _, aux_j = jax_ref("ForwardDiffSensitivity")
    _, aux_p = port_run("ForwardDiffSensitivity")
    assert aux_p[3] == 0
    assert_rows_and_steps(aux_p, aux_j)
    r = solve_ivp(lambda t, y: [-0.04 * y[0] + 1e4 * y[1] * y[2],
                                0.04 * y[0] - 1e4 * y[1] * y[2]
                                - 3e7 * y[1] ** 2, 3e7 * y[1] ** 2],
                  (0, T1), [1.0, 0.0, 0.0], method="Radau", rtol=1e-10,
                  atol=1e-14, t_eval=TS)
    np.testing.assert_allclose(aux_p[0].detach().numpy(), r.y.T, rtol=1e-5,
                               atol=1e-8)


def test_robertson_dae_gradient():
    """sensealg=None on a singular mass is ForwardDiffSensitivity (JAX
    solve.py:262): the tangents replayed through the mass-matrix stepper
    equal JAX's jvp through its loop to 1e-8 in log p and u0_d."""
    gj, _ = jax_ref("ForwardDiffSensitivity")
    gp, _ = port_run(None)
    assert_grads(gp, gj)


def test_singular_mass_requires_sdirk():
    """A singular mass on an explicit stepper raises NotImplementedError,
    and without dt0 ValueError, in both packages (JAX solve.py:249-263)."""
    for mod, lib in ((J, jnp), (P, torch)):
        u0 = jnp.asarray([1.0, 0.0, 0.0]) if mod is J else ten([1, 0, 0])
        p = jnp.asarray(P_ROB) if mod is J else ten(P_ROB)
        prob = mod.ODEProblem(rober(lib), u0, (0.0, T1), p,
                              mass_matrix=M_ROB)
        with pytest.raises(NotImplementedError, match="SDIRK4"):
            mod.solve(prob, mod.Tsit5(), dt0=1e-6)
        with pytest.raises(ValueError, match="explicit dt0"):
            mod.solve(prob, mod.SDIRK4())


@pytest.mark.parametrize("rule", ["InterpolatingAdjoint", "GaussAdjoint",
                                  "QuadratureAdjoint"])
def test_robertson_dae_continuous_adjoint(rule):
    """The continuous DAE adjoints (projected jumps; Interpolating's joined
    [λ; q] with blockdiag(Mᵀ, I), Gauss's and Quadrature's λ with mass Mᵀ
    and the algebraic λ re-solved at each node) on a loss of a differential
    and the algebraic state: JAX's gradient to 1e-8, and ForwardDiff's to
    the JAX test's rtol 2e-3."""
    gj, aux_j = jax_ref(rule)
    gp, aux_p = port_run(rule)
    assert_rows_and_steps(aux_p, aux_j)
    assert_grads(gp, gj)
    g_fd, _ = port_run(None)
    for a, b in zip(gp, g_fd):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-3,
                                   atol=1e-7)


def test_dae_continuous_adjoint_u0_gradient():
    """dL/du0 through μ = Mᵀλ(t0) on the differential states (the u0_d
    entries of the Interpolating gradient): JAX's to 1e-8, ForwardDiff's
    to 2e-3."""
    gj, _ = jax_ref("InterpolatingAdjoint")
    gp, _ = port_run("InterpolatingAdjoint")
    assert max_rel(gp[1], gj[1]) <= 1e-8
    np.testing.assert_allclose(gp[1].numpy(), port_run(None)[0][1].numpy(),
                               rtol=2e-3, atol=1e-7)


def test_direct_adjoint_dae_divergence():
    """DirectAdjoint through the mass-matrix SDIRK4 (autograd through its
    Newton stages) gives ForwardDiffSensitivity's gradient to 1e-8, where
    JAX's DirectAdjoint returns NaN (its masked scan; a deliberate
    divergence, ROADMAP §3)."""
    gj_direct, _ = jax_ref("DirectAdjoint")
    gj_fds, _ = jax_ref("ForwardDiffSensitivity")
    gp, aux_p = port_run("DirectAdjoint")
    assert aux_p[3] == 0
    assert all(np.isnan(np.asarray(g)).all() for g in gj_direct)
    assert_grads(gp, gj_fds)


def test_robertson_dae_seulex():
    """Rodas4Like (linearly implicit extrapolation, W = M − hJ) on the DAE:
    steps and rows equal JAX's, and the InterpolatingAdjoint gradient (its
    reverse on SDIRK4 with mass blockdiag(Mᵀ, I)) JAX's to 1e-8."""
    gj, aux_j = jax_ref("InterpolatingAdjoint", "seulex")
    gp, aux_p = port_run("InterpolatingAdjoint", "seulex")
    assert aux_p[3] == 0
    assert_rows_and_steps(aux_p, aux_j)
    assert_grads(gp, gj)


def test_robertson_dae_fbdf_gauss():
    """FBDF on the DAE under GaussAdjoint (the reverse on SDIRK4 with mass
    Mᵀ): steps, rows and gradient equal JAX's; ForwardDiffSensitivity on
    FBDF (the tangents replayed through each logged BDF solve with the
    history's tangents) equals JAX's jvp through its loop to 1e-8."""
    gj, aux_j = jax_ref("GaussAdjoint", "fbdf")
    gp, aux_p = port_run("GaussAdjoint", "fbdf")
    assert_rows_and_steps(aux_p, aux_j)
    assert_grads(gp, gj)
    gj_fd, aux_jfd = jax_ref("ForwardDiffSensitivity", "fbdf")
    g_fd, aux_fd = port_run("ForwardDiffSensitivity", "fbdf")
    assert_rows_and_steps(aux_fd, aux_jfd)
    assert_grads(g_fd, gj_fd)


MZ = np.diag([1.0, 0.0])


def _init_problem(mod, args):
    """y' = -y, 0 = z - p·y², with the inconsistent guess z0 = 0."""
    lib = jnp if mod is J else torch

    def f(u, p, t):
        return lib.stack([-u[0], u[1] - p[0] * u[0] ** 2])

    y0, p = args[0], args[1:]
    return f, lib.stack([y0, 0.0 * y0]), p


def test_dae_consistent_initialization_adjoint():
    """dae_init="newton" solves 0 = f_a(u0) by solve_nonlinear before the
    solve, and the IFT adjoint differentiates it: the ForwardDiff gradient
    of y(T) + z(T) equals JAX's (its solve_nonlinear, then the solve its
    branch runs) to 1e-8; ForwardDiff and Interpolating are exact to 1e-5;
    the saved u0 is projected, z(T) = p·y(T)². T = 0.2 at rtol 1e-8 (the
    JAX test: T = 1 at 1e-10)."""
    T, y0, p0 = 0.2, 1.3, 0.8
    kw = dict(rtol=1e-8, atol=1e-10, dt0=1e-3, adj_rtol=1e-8,
              adj_atol=1e-10, max_steps=8192)

    def jax_g(a):
        f, u0, p = _init_problem(J, a)
        ns = J.solve_nonlinear(J.NonlinearProblem(
            lambda ua, pp: f(pp[0].at[1].set(ua[0]), pp[1], 0.0)[1:],
            u0[1:], (u0, p)))
        u0c = u0.at[1].set(ns.u[0])
        s = J.solve(J.ODEProblem(f, u0c, (0.0, T), p),
                    J.SDIRK4().with_mass_matrix(MZ), saveat=jnp.asarray([T]),
                    sensealg=J.ForwardDiffSensitivity(), **kw)
        return s.ys[0, 0] + s.ys[0, 1]

    gj = jax_o0(jax.grad(jax_g), jnp.asarray([y0, p0]))
    exact = np.array([np.exp(-T) + 2 * p0 * y0 * np.exp(-2 * T),
                      y0 ** 2 * np.exp(-2 * T)])
    for rule in ("ForwardDiffSensitivity", "InterpolatingAdjoint"):
        a = ten([y0, p0]).requires_grad_()
        f, u0, p = _init_problem(P, a)
        s = P.solve(P.ODEProblem(f, u0, (0.0, T), p, mass_matrix=MZ),
                    P.SDIRK4(), saveat=[T], dae_init="newton",
                    sensealg=getattr(P, rule)(), **kw)
        (g,) = torch.autograd.grad(s.ys[0, 0] + s.ys[0, 1], a)
        np.testing.assert_allclose(g.numpy(), exact, rtol=1e-5)
        if rule == "ForwardDiffSensitivity":
            assert max_rel(g, gj) <= 1e-8
    f, u0, p = _init_problem(P, ten([y0, p0]))
    s = P.solve(P.ODEProblem(f, u0, (0.0, T), p, mass_matrix=MZ), P.SDIRK4(),
                saveat=[0.0, T], dae_init="newton", rtol=1e-8, atol=1e-10,
                dt0=1e-3)
    assert np.isclose(float(s.ys[0, 1]), p0 * y0 ** 2, rtol=1e-8)
    assert np.isclose(float(s.ys[1, 1]), p0 * (y0 * np.exp(-T)) ** 2,
                      rtol=1e-6)


def test_rotated_robertson_nondiagonal_mass_adjoints():
    """A non-diagonal differential mass block (T·f_d on the differential
    rows, M[:2, :2] = T), under GaussAdjoint, whose λ-only reverse rests
    on the algebraic re-solve at every node most: steps, rows and gradient
    equal JAX's. (The other rules run this projection on Robertson above;
    each JAX rule compiles in 5-10 s here, so each case has one.)"""
    gj, aux_j = jax_ref("GaussAdjoint", "rot")
    gp, aux_p = port_run("GaussAdjoint", "rot")
    assert_rows_and_steps(aux_p, aux_j)
    assert_grads(gp, gj)


def test_mass_matrix_dense_coupling_rejected():
    """M[d, a] != 0 is not semi-explicit: NotImplementedError in both; a
    singular differential block raises ValueError in both."""
    M = np.array([[1.0, 0.0, 0.5], [0.0, 1.0, 0.0], [0.0, 0.0, 0.0]])
    for split in (j_split, p_split):
        with pytest.raises(NotImplementedError, match="semi-explicit"):
            split(M)
        with pytest.raises(ValueError, match="nonsingular"):
            split(np.array([[1.0, 1.0, 0.0], [1.0, 1.0, 0.0],
                            [0.0, 0.0, 0.0]]))


def test_dae_adjoints_with_dosing_event():
    """The rotated DAE with a dose at a tstop (the DAE event jump: ν⁺ =
    M_ddᵀλ⁺_d pulled back through the affect and routed through the
    constraint): InterpolatingAdjoint's steps, rows and gradient equal
    JAX's, and ForwardDiff's (the dose replayed on the tangents) equals
    JAX's ForwardDiff."""
    gj, aux_j = jax_ref("InterpolatingAdjoint", "dose")
    gp, aux_p = port_run("InterpolatingAdjoint", "dose")
    assert_rows_and_steps(aux_p, aux_j)
    assert_grads(gp, gj)
    g_fd, _ = port_run("ForwardDiffSensitivity", "dose")
    assert_grads(g_fd, jax_ref("ForwardDiffSensitivity", "dose")[0])


def test_dae_adjoint_with_continuous_event():
    """A continuous condition on the rotated DAE (the implicit-τ correction
    with the DAE-consistent u̇): GaussAdjoint's steps, rows and gradient
    equal JAX's to 1e-8. ForwardDiffSensitivity through the event (the
    event time's tangent carried into the SDIRK4 steps after it) equals
    JAX's to 1e-8, and GaussAdjoint is within the JAX test's rtol 2e-3 of
    it, JAX's test's oracle."""
    gj, aux_j = jax_ref("GaussAdjoint", "cross")
    gp, aux_p = port_run("GaussAdjoint", "cross")
    assert_rows_and_steps(aux_p, aux_j)
    assert_grads(gp, gj)
    gj_fd, _ = jax_ref("ForwardDiffSensitivity", "cross")
    g_fd, _ = port_run("ForwardDiffSensitivity", "cross")
    assert_grads(g_fd, gj_fd)
    for a, b in zip(gp, g_fd):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-3)


@functools.lru_cache(maxsize=None)
def _dense_dae_sol():
    prob = P.ODEProblem(rober(torch), ten([1.0, 0.0, 0.0]), (0.0, T1),
                        ten(P_ROB), mass_matrix=M_ROB)
    return P.solve(prob, P.SDIRK4(), saveat=TS, dense=True,
                   sensealg=P.InterpolatingAdjoint(), **KW)


def _rob_dg(u, p, t, i):
    return torch.stack([torch.zeros_like(u[0]), 1e4 + 0 * u[1],
                        1.0 + 0 * u[2]])


def test_ode_adjoint_problem_dae_robertson():
    """adjoint_sensitivities on the DAE solution (Interpolating, the
    direct-API DAE branch) gives the solve-gradient of JAX's
    InterpolatingAdjoint to the reverse rtol; ODEAdjointProblem returns the
    block mass [Mᵀ 0; 0 I] with projected jumps, and solving it by hand
    with SDIRK4 matches adjoint_sensitivities to 2e-4, as the JAX test
    holds them. Both reverses at rtol 1e-5 (the JAX test: 1e-7)."""
    sol = _dense_dae_sol()
    du0, dp = P.adjoint_sensitivities(sol, t=TS, dgdu_discrete=_rob_dg,
                                      sensealg=P.InterpolatingAdjoint(),
                                      rtol=1e-5, atol=1e-9)
    assert du0[2] == 0.0
    gj, _ = jax_ref("InterpolatingAdjoint")
    np.testing.assert_allclose((dp * ten(P_ROB)).numpy(), np.asarray(gj[0]),
                               rtol=1e-4)
    np.testing.assert_allclose((du0[:2] - du0[2]).numpy(), np.asarray(gj[1]),
                               rtol=1e-4, atol=1e-9)
    spec = P.ODEAdjointProblem(sol, P.InterpolatingAdjoint(), t=TS,
                               dgdu_discrete=_rob_dg)
    assert tuple(spec.prob.mass_matrix.shape) == (6, 6)
    adj = P.solve(spec.prob, P.SDIRK4(), callback=spec.callback,
                  tstops=spec.tstops, dt0=1e-5, saveat=[T1, 0.0], rtol=1e-5,
                  atol=1e-9, max_steps=8192)
    assert adj.success
    du0_h, dp_h = spec.extract(adj.u_final)
    np.testing.assert_allclose(du0_h.numpy(), du0.numpy(), rtol=2e-4,
                               atol=1e-9)
    np.testing.assert_allclose(dp_h.numpy(), dp.numpy(), rtol=2e-4,
                               atol=1e-12)


def test_mass_matrix_invertible():
    """M u' = -u with M = diag(2, 4) is folded to u' = M⁻¹f: rates 1/2 and
    1/4 to 1e-8 under GaussAdjoint, and the gradient of Σu(1)² in u0 is the
    closed form's, as JAX's test holds its own."""
    M = np.diag([2.0, 4.0])
    u0 = ten([1.0, 1.0]).requires_grad_()
    sol = P.solve(P.ODEProblem(lambda u, p, t: -u, u0, (0.0, 1.0),
                               mass_matrix=M), P.Tsit5(), rtol=1e-10,
                  atol=1e-12, sensealg=P.GaussAdjoint())
    rates = np.array([np.exp(-0.5), np.exp(-0.25)])
    np.testing.assert_allclose(sol.ys[-1].detach().numpy(), rates, rtol=1e-8)
    (g,) = torch.autograd.grad(sol.ys[-1].pow(2).sum(), u0)
    np.testing.assert_allclose(g.numpy(), 2 * rates ** 2, rtol=1e-7)
    jsol = J.solve(J.ODEProblem(lambda u, p, t: -u, jnp.ones(2), (0.0, 1.0),
                                None, mass_matrix=jnp.asarray(M)), J.Tsit5(),
                   rtol=1e-10, atol=1e-12, sensealg=J.GaussAdjoint())
    np.testing.assert_allclose(sol.ys[-1].detach().numpy(),
                               np.asarray(jsol.ys[-1]), rtol=1e-10)


def test_mass_matrix_singular_raises():
    """A singular M on Tsit5 raises NotImplementedError in both; dae_init
    on a problem without a mass or with an invertible one, or an unknown
    dae_init, raises ValueError in both (tests/test_dispatch.py:89-164)."""
    for mod, lib in ((J, jnp), (P, torch)):
        prob = mod.ODEProblem(lambda u, p, t: -u,
                              lib.ones(2, dtype=lib.float64), (0.0, 1.0),
                              None, mass_matrix=MZ)
        with pytest.raises(NotImplementedError):
            mod.solve(prob, mod.Tsit5())
        for mass in (None, np.diag([2.0, 4.0])):
            plain = dataclasses.replace(prob, mass_matrix=mass)
            with pytest.raises(ValueError, match="dae_init"):
                mod.solve(plain, mod.Tsit5(), dae_init="newton")
        with pytest.raises(ValueError, match="dae_init"):
            mod.solve(prob, mod.SDIRK4(), dt0=1e-3, dae_init="guess")


def test_dae_refusals_match_jax():
    """Every refusal of JAX's DAE paths raises in the port with the same
    type: Backsolve and a checkpointed rule in solve; gradients through
    sol(t); Backsolve, t_grads in adjoint_sensitivities; a non-
    Interpolating layout and events in ODEAdjointProblem; parameter-
    modifying events on a DAE."""
    prob = P.ODEProblem(rober(torch), ten([1.0, 0.0, 0.0]), (0.0, T1),
                        ten(P_ROB), mass_matrix=M_ROB)
    kw = dict(saveat=TS, rtol=1e-5, atol=1e-9, dt0=1e-5, max_steps=200)
    with pytest.raises(NotImplementedError, match="DAE gradients"):
        P.solve(prob, P.SDIRK4(), sensealg=P.BacksolveAdjoint(), **kw)
    with pytest.raises(NotImplementedError, match="non-checkpointed"):
        P.solve(prob, P.SDIRK4(),
                sensealg=P.InterpolatingAdjoint(checkpointing=True), **kw)
    jprob = J.ODEProblem(rober(jnp), jnp.asarray([1.0, 0.0, 0.0]), (0.0, T1),
                         jnp.asarray(P_ROB), mass_matrix=M_ROB)
    for sa in (J.BacksolveAdjoint(), J.InterpolatingAdjoint(
            checkpointing=True)):
        with pytest.raises(NotImplementedError):
            J.solve(jprob, J.SDIRK4(), sensealg=sa, saveat=jnp.asarray(TS),
                    rtol=1e-5, atol=1e-9, dt0=1e-5, max_steps=200)
    # sol(t) gradients
    p = ten(P_ROB).requires_grad_()
    s = P.solve(dataclasses.replace(prob, p=p), P.SDIRK4(), dense=True,
                sensealg=P.GaussAdjoint(), **kw)
    with pytest.raises(NotImplementedError, match="DAE"):
        torch.autograd.grad(s(5e-4).sum(), p)
    # the direct API and the reverse problem
    sol = _dense_dae_sol()
    with pytest.raises(NotImplementedError, match="BacksolveAdjoint"):
        P.adjoint_sensitivities(sol, dgdu_discrete=_rob_dg,
                                sensealg=P.BacksolveAdjoint())
    with pytest.raises(NotImplementedError, match="t_grads"):
        P.adjoint_sensitivities(sol, dgdu_discrete=_rob_dg, t_grads=True)
    with pytest.raises(NotImplementedError, match="InterpolatingAdjoint"):
        P.ODEAdjointProblem(sol, P.QuadratureAdjoint(),
                            dgdu_discrete=_rob_dg)
    ev_sol = dataclasses.replace(sol, events=object())
    with pytest.raises(NotImplementedError, match="events"):
        P.ODEAdjointProblem(ev_sol, P.InterpolatingAdjoint(),
                            dgdu_discrete=_rob_dg)
    lift = P.DiscreteCallback(lambda u, q, t: True,
                              lambda u, q, t: (u, q), modifies_p=True)
    with pytest.raises(NotImplementedError, match="p-lift"):
        P.solve(prob, P.SDIRK4(), callback=lift,
                sensealg=P.ForwardDiffSensitivity(), **kw)


def test_dae_on_kernel_field_raises_before_launch():
    """A DAE on the fused MLP field: the stepper's Jacobians need forward
    mode, which the kernel Function refuses; solve probes it before any
    field evaluation and raises ForwardModeUnsupported by name, as JAX's
    custom_vjp field refuses jax.jvp."""
    g = np.random.default_rng(1)
    mlp = {"W0": 0.5 * g.standard_normal((2, 8)), "b0": np.zeros(8),
           "W1": 0.3 * g.standard_normal((8, 2)), "b1": np.zeros(2)}
    pt = {k: ten(v) for k, v in mlp.items()}
    prob = P.ODEProblem(lambda u, q, t: P.fused_mlp2(q, u), ten([2.0, 0.0]),
                        (0.0, 0.1), pt, mass_matrix=MZ)
    with pytest.raises(ForwardModeUnsupported, match="FusedMLP2"):
        P.solve(prob, P.SDIRK4(), dt0=1e-3, sensealg=P.GaussAdjoint())
