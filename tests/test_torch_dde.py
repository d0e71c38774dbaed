"""Parity of the port's delay differential equations (adjoints/dde.py, the
DDE dispatch of solve) with the JAX package's, in float64 on the CPU: one
case for each test of tests/test_dde.py.

The same numpy constants go through both packages; each package writes its
own field, history and lag callables in its idiom. JAX runs compiled at
XLA optimization level 0 (`torch_parity.jax_o0`), whose op-by-op
rounding lets the adaptive cases take the port's exact steps. Tolerances:
fixed-grid trajectories and gradients 1e-12 relative, adaptive step counts
equal and values and gradients 1e-10, state-dependent lags and
distributed lags 1e-10. Where a JAX test runs long on a fine grid (its
oracles at dt = 1e-4 or 2e-4, TRBDF2 over thousands of Newton sweeps),
the port's case runs a shorter span or a coarser grid, or takes JAX's own
fine-grid value as the oracle; each case's docstring states the size it
uses, which is a size, not a tolerance.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import jax_o0

import scimlsensitivity_jl_tpu as J
import scimlsensitivity_jl_tpu_torch as P
from scimlsensitivity_jl_tpu.models.neural_ode import mlp_apply as j_mlp
from scimlsensitivity_jl_tpu.models.neural_ode import mlp_init as j_mlp_init
from scimlsensitivity_jl_tpu_torch.models.neural_ode import (
    mlp_apply as p_mlp)
from scimlsensitivity_jl_tpu_torch.ops.vjp import ForwardModeUnsupported
from scimlsensitivity_jl_tpu_torch.utils.pytree import from_numpy_tree

DT = torch.float64


def ten(x):
    return torch.tensor(np.asarray(x, dtype=float), dtype=DT)


def rel(port, ref):
    port = np.asarray(port.detach() if isinstance(port, torch.Tensor)
                      else port, dtype=float)
    ref = np.asarray(ref, dtype=float)
    return float(np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-300))


def neg_delay(u, h, p, t):
    return -h[0]


def jprob(f, u0, tspan, p=None, **kw):
    return J.DDEProblem(f, jnp.asarray(u0, float), tspan, p, **kw)


def pprob(f, u0, tspan, p=None, **kw):
    return P.DDEProblem(f, ten(u0), tspan, p, **kw)


def j_out(sol):
    return (sol.ys, sol.stats.n_accepted, sol.stats.n_rejected, sol.retcode)


def assert_same_solve(sp, ref, tol):
    """ys within tol relative and the same step counts and retcode."""
    ys, acc, rej, rc = ref
    assert (sp.stats.n_accepted, sp.stats.n_rejected, sp.retcode) == (
        int(acc), int(rej), int(rc))
    assert rel(sp.ys, ys) <= tol


# -- fixed grid ---------------------------------------------------------------

TS5 = np.array([0.0, 0.5, 1.0, 1.5, 2.0])


def _exact_unit_lag(t, tau=1.0):
    """u' = -u(t - τ), u = 1 for t <= 0, by the method of steps."""
    out = 1.0 - t
    if t > tau:
        out += (t - tau) ** 2 / 2.0
    if t > 2 * tau:
        out -= (t - 2 * tau) ** 3 / 6.0
    return out


def test_dde_exact_piecewise():
    """RK4 at dt = 1e-2 on (0, 2): the port's rows equal JAX's to 1e-12 and
    the method-of-steps solution to 1e-6."""
    ref = jax_o0(lambda u: J.solve(jprob(neg_delay, u, (0.0, 2.0),
                                         lags=(1.0,)),
                                   dt=1e-2, saveat=jnp.asarray(TS5)).ys,
                 jnp.ones(1))
    sp = P.solve(pprob(neg_delay, [1.0], (0.0, 2.0), lags=(1.0,)),
                 dt=1e-2, saveat=TS5)
    assert sp.retcode == 0 and sp.stats.n_accepted == 200
    assert rel(sp.ys, ref) <= 1e-12
    expect = np.array([_exact_unit_lag(t) for t in TS5])
    np.testing.assert_allclose(sp.ys[:, 0].numpy(), expect, atol=1e-6)


def test_dde_order4_convergence():
    """History e^{-t} with u' = -(1/e)u(t-1): exact e^{-t}; RK4 with the
    Hermite reads keeps order ~4 (slope > 3.5 between dt 0.1 and 0.05),
    and each endpoint equals JAX's to 1e-12."""
    c = float(np.exp(-1.0))

    def run(mod, lib, dt):
        prob = mod.DDEProblem(
            lambda u, h, p, t: -c * h[0], lib.ones(1, dtype=lib.float64),
            (0.0, 2.0), None, lags=(1.0,),
            history=lambda t: lib.exp(-t).reshape(1))
        return mod.solve(prob, dt=dt, saveat=np.array([0.0, 2.0])).ys[-1, 0]

    errs = []
    for dt in (0.1, 0.05):
        yj = jax_o0(lambda: run(J, jnp, dt))
        yp = run(P, torch, dt)
        assert rel(yp, yj) <= 1e-12
        errs.append(abs(float(yp) - float(np.exp(-2.0))))
    assert np.log2(errs[0] / errs[1]) > 3.5, errs


def test_dde_lag_not_multiple_of_dt():
    """τ = 1/3 off the dt = 0.01 grid: JAX's rows to 1e-12 and the
    method-of-steps solution to 5e-5."""
    tau, ts = 1.0 / 3.0, np.array([0.0, 0.3, 0.6, 0.9])
    ref = jax_o0(lambda u: J.solve(jprob(neg_delay, u, (0.0, 0.9),
                                         lags=(tau,)),
                                   dt=0.01, saveat=jnp.asarray(ts)).ys,
                 jnp.ones(1))
    sp = P.solve(pprob(neg_delay, [1.0], (0.0, 0.9), lags=(tau,)),
                 dt=0.01, saveat=ts)
    assert rel(sp.ys, ref) <= 1e-12
    expect = np.array([_exact_unit_lag(t, tau) for t in ts])
    np.testing.assert_allclose(sp.ys[:, 0].numpy(), expect, atol=5e-5)


def _feedback_loss(mod, p):
    lib = jnp if mod is J else torch
    prob = mod.DDEProblem(lambda u, h, pp, t: -pp * h[0],
                          lib.ones(1, dtype=lib.float64), (0.0, 2.0), p,
                          lags=(0.5,))
    return lib.sum(mod.solve(prob, dt=1e-2).ys[-1] ** 2)


def test_dde_gradient_vs_fd():
    """u' = -p·u(t - 0.5): dL/dp equals JAX's to 1e-12 and central
    differences of the port's loss to 1e-6."""
    gj = jax_o0(jax.grad(lambda p: _feedback_loss(J, p)), jnp.asarray(1.3))
    p = torch.tensor(1.3, dtype=DT, requires_grad=True)
    (g,) = torch.autograd.grad(_feedback_loss(P, p), p)
    assert rel(g, gj) <= 1e-12
    eps = 1e-6
    fd = (float(_feedback_loss(P, ten(1.3 + eps)))
          - float(_feedback_loss(P, ten(1.3 - eps)))) / (2 * eps)
    assert np.isclose(float(g), fd, rtol=1e-6)


def test_neural_dde_trains():
    """The JAX test's 2→8→1 MLP on [u, u(t - 0.25)] (JAX's mlp_init
    weights carried across): the gradient equals JAX's to 1e-10, and one
    step of -0.1·g lowers the port's loss."""
    params = j_mlp_init(jax.random.PRNGKey(0), (2, 8, 1), jnp.float64)
    target = 0.3

    def loss(mod, pp):
        lib, mlp = (jnp, j_mlp) if mod is J else (torch, p_mlp)
        prob = mod.DDEProblem(
            lambda u, h, q, t: mlp(q, lib.concatenate([u, h[0]])),
            lib.ones(1, dtype=lib.float64), (0.0, 1.0), pp, lags=(0.25,))
        return (mod.solve(prob, dt=1.0 / 40).ys[-1, 0] - target) ** 2

    gj = jax_o0(jax.grad(lambda q: loss(J, q)), params)
    pp = from_numpy_tree({k: np.asarray(v) for k, v in params.items()},
                         "cpu", DT)
    for v in pp.values():
        v.requires_grad_()
    L = loss(P, pp)
    grads = torch.autograd.grad(L, list(pp.values()))
    for (name, v), g in zip(pp.items(), grads):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(gj[name]),
                                   rtol=0, atol=1e-10 * np.abs(
                                       np.asarray(gj[name])).max())
    stepped = {k: (v - 0.1 * g).detach() for (k, v), g in
               zip(pp.items(), grads)}
    assert float(loss(P, stepped)) < float(L)


def test_dde_state_dependent_lag_matches_constant():
    """A callable lag that returns a constant reproduces the constant-lag
    solve bit for bit, as in JAX, whose rows it equals to 1e-12."""
    ts = np.array([0.0, 0.7, 1.4, 2.0])
    const = P.solve(pprob(neg_delay, [1.0], (0.0, 2.0), lags=(1.0,)),
                    dt=1e-2, saveat=ts).ys
    dep = P.solve(pprob(neg_delay, [1.0], (0.0, 2.0),
                        lags=(lambda u, p, t: 1.0,), max_lag=1.0),
                  dt=1e-2, saveat=ts).ys
    assert torch.equal(const, dep)
    ref = jax_o0(lambda u: J.solve(jprob(neg_delay, u, (0.0, 2.0),
                                         lags=(lambda u, p, t: 1.0,),
                                         max_lag=1.0),
                                   dt=1e-2, saveat=jnp.asarray(ts)).ys,
                 jnp.ones(1))
    assert rel(dep, ref) <= 1e-12


def _dep_endpoint(mod, p, dt):
    lib = jnp if mod is J else torch
    prob = mod.DDEProblem(
        lambda u, h, pp, t: -pp * h[0], lib.ones(1, dtype=lib.float64),
        (0.0, 2.0), p,
        lags=(lambda u, pp, t: 0.5 + 0.25 * lib.tanh(u[0]),), max_lag=0.75)
    return mod.solve(prob, dt=dt).ys[-1, 0]


def test_dde_state_dependent_lag_self_convergence_and_grad():
    """τ(u) = 0.5 + 0.25·tanh(u): the port's endpoints self-converge
    (dt 1/40, 1/80, 1/160) and equal JAX's to 1e-10; the gradient at dt
    1/80 equals JAX's to 1e-10 and central differences to 1e-5."""
    ys = []
    for dt in (1 / 40, 1 / 80, 1 / 160):
        yp = _dep_endpoint(P, ten(1.1), dt)
        yj = jax_o0(lambda p: _dep_endpoint(J, p, dt), jnp.asarray(1.1))
        assert rel(yp, yj) <= 1e-10
        ys.append(float(yp))
    assert abs(ys[1] - ys[2]) < abs(ys[0] - ys[1]) / 3, ys
    gj = jax_o0(jax.grad(lambda p: _dep_endpoint(J, p, 1 / 80) ** 2),
                jnp.asarray(1.1))
    p = torch.tensor(1.1, dtype=DT, requires_grad=True)
    (g,) = torch.autograd.grad(_dep_endpoint(P, p, 1 / 80) ** 2, p)
    assert rel(g, gj) <= 1e-10
    eps = 1e-6
    fd = (float(_dep_endpoint(P, ten(1.1 + eps), 1 / 80)) ** 2
          - float(_dep_endpoint(P, ten(1.1 - eps), 1 / 80)) ** 2) / (2 * eps)
    assert np.isclose(float(g), fd, rtol=1e-5)


def test_dde_state_dependent_lag_violation_poisons():
    """A lag that dips below dt at run time: retcode 3 (DDELagViolation)
    and a NaN state in both packages."""
    sj = jax_o0(lambda u: j_out(J.solve(jprob(
        neg_delay, u, (0.0, 1.0),
        lags=(lambda u, p, t: jnp.where(t > 0.5, 1e-4, 0.5),), max_lag=0.5),
        dt=1.0 / 50)), jnp.ones(1))
    sp = P.solve(pprob(neg_delay, [1.0], (0.0, 1.0),
                       lags=(lambda u, p, t: 1e-4 if t > 0.5 else 0.5,),
                       max_lag=0.5), dt=1.0 / 50)
    assert int(sj[3]) == 3 and sp.retcode == 3
    assert P.RETCODE_NAMES[sp.retcode] == "DDELagViolation"
    assert np.isnan(np.asarray(sj[0][-1])).all()
    assert torch.isnan(sp.ys[-1]).all() and torch.isnan(sp.u_final).all()


def test_dde_callable_lag_requires_max_lag():
    """A callable lag without max_lag raises ValueError in both."""
    for mod, lib in ((J, jnp), (P, torch)):
        prob = mod.DDEProblem(neg_delay, lib.ones(1, dtype=lib.float64),
                              (0.0, 1.0), None, lags=(lambda u, p, t: 0.5,))
        with pytest.raises(ValueError, match="max_lag"):
            mod.solve(prob, dt=0.01)


A_STIFF, B_STIFF = 500.0, 5.0


def _stiff_rhs(lib, A=A_STIFF):
    if lib is jnp:
        return lambda u, h, p, t: (-A * (u - jnp.sin(2.0 * jnp.pi * t))
                                   + B_STIFF * h[0])
    return lambda u, h, p, t: (-A * (u - float(np.sin(2.0 * np.pi * t)))
                               + B_STIFF * h[0])


def test_dde_stiff_trbdf2():
    """u' = -500(u - sin 2πt) + 5u(t - 1) on (0, 1.2) (the JAX test: (0, 2),
    with a refinement to dt 0.005): TRBDF2 at dt 0.02 equals JAX's to 1e-12
    and JAX's RK4 in its stable regime (dt 1e-3; the JAX test: 2e-4) to
    5e-2; explicit RK4 at dt 0.02 blows up in the port."""
    span = (0.0, 1.2)
    y_ref = jax_o0(lambda u: J.solve(jprob(_stiff_rhs(jnp), u, span,
                                           lags=(1.0,)), dt=1e-3).ys[-1, 0],
                   jnp.ones(1))
    y_j = jax_o0(lambda u: J.solve(jprob(_stiff_rhs(jnp), u, span,
                                         lags=(1.0,)), J.TRBDF2(),
                                   dt=0.02).ys[-1, 0], jnp.ones(1))
    sp = P.solve(pprob(_stiff_rhs(torch), [1.0], span, lags=(1.0,)),
                 P.TRBDF2(), dt=0.02)
    assert sp.solver == "MethodOfStepsTRBDF2Hermite"
    assert rel(sp.ys[-1, 0], y_j) <= 1e-12
    assert np.isclose(float(sp.ys[-1, 0]), float(y_ref), rtol=5e-2,
                      atol=1e-4)
    y_exp = float(P.solve(pprob(_stiff_rhs(torch), [1.0], span,
                                lags=(1.0,)), dt=0.02).ys[-1, 0])
    assert (not np.isfinite(y_exp)) or abs(y_exp) > 1e3


def _stiff_grad_loss(mod, p):
    lib = jnp if mod is J else torch
    prob = mod.DDEProblem(lambda u, h, pp, t: -200.0 * u + pp * h[0],
                          lib.ones(1, dtype=lib.float64), (0.0, 0.75), p,
                          lags=(0.5,))
    return mod.solve(prob, mod.TRBDF2(), dt=0.01).ys[-1, 0] ** 2


def test_dde_stiff_trbdf2_gradient_vs_fd():
    """TRBDF2 through its Newton sweeps on (0, 0.75) (the JAX test: 1.5):
    dL/dp equals JAX's to 1e-12, and JAX's central differences of its own
    loss to 1e-5."""
    eps = 1e-6
    gj, lo, hi = jax_o0(lambda p: (
        jax.grad(lambda q: _stiff_grad_loss(J, q))(p),
        _stiff_grad_loss(J, p - eps), _stiff_grad_loss(J, p + eps)),
        jnp.asarray(3.0))
    p = torch.tensor(3.0, dtype=DT, requires_grad=True)
    (g,) = torch.autograd.grad(_stiff_grad_loss(P, p), p)
    assert rel(g, gj) <= 1e-12
    assert np.isclose(float(g), (float(hi) - float(lo)) / (2 * eps),
                      rtol=1e-5)


def test_dde_max_lag_must_cover_constant_lags():
    for mod, lib in ((J, jnp), (P, torch)):
        prob = mod.DDEProblem(neg_delay, lib.ones(1, dtype=lib.float64),
                              (0.0, 1.0), None, lags=(1.0,), max_lag=0.5)
        with pytest.raises(ValueError, match="max_lag"):
            mod.solve(prob, dt=0.05)


def test_dde_rejects_explicit_solver():
    """The fixed grid takes RK4 (solver=None) or TRBDF2 only; a lag below
    dt raises ValueError; callback= on a DDE raises (the three refusals of
    JAX dde.py:305-345 and solve.py:156), in both packages."""
    for mod, lib in ((J, jnp), (P, torch)):
        prob = mod.DDEProblem(neg_delay, lib.ones(1, dtype=lib.float64),
                              (0.0, 1.0), None, lags=(0.5,))
        with pytest.raises(NotImplementedError, match="RK4"):
            mod.solve(prob, mod.Tsit5(), dt=0.01)
        with pytest.raises(NotImplementedError, match="TRBDF2"):
            mod.solve(prob, mod.SDIRK4(), dt=0.01)
        with pytest.raises(ValueError, match="shrink dt"):
            mod.solve(prob, dt=0.6)
        cb = mod.DiscreteCallback(lambda u, p, t: True, lambda u, p, t: u)
        with pytest.raises(NotImplementedError, match="callbacks"):
            mod.solve(prob, dt=0.01, callback=cb)


def _dist_setup(lib):
    def kern(s, pp):
        return pp[0] * lib.exp(-pp[1] * s)

    def f_dde(u, hist, pp, t):
        (I,) = hist
        return -I

    return kern, f_dde


def test_distributed_lag_integrodifferential():
    """u' = -∫₀^2 α e^{-βs} u(t - s) ds on (0, 3) at dt 0.05 (the JAX test:
    dt 0.005 and 0.01, 600 steps of 400 reads each): rows and dL/dp equal
    JAX's to 1e-10, and the rows the linear-chain ODE's (Tsit5, rtol 1e-10)
    to the trapezoid's O(dt²) at this dt, 5e-3."""
    alpha, beta, tau = 2.0, 6.0, 2.0
    ts = np.array([0.0, 1.0, 2.0, 3.0])

    def run(mod, p):
        lib = jnp if mod is J else torch
        kern, f_dde = _dist_setup(lib)
        prob = mod.DDEProblem(f_dde, lib.ones(1, dtype=lib.float64),
                              (0.0, 3.0), p, lags=(), max_lag=tau,
                              dist_kernels=(kern,))
        return mod.solve(prob, dt=0.05, saveat=ts)

    p0 = np.array([alpha, beta])
    yj, gj = jax_o0(lambda p: (run(J, p).ys, jax.grad(
        lambda q: jnp.sum(run(J, q).ys[-1]))(p)), jnp.asarray(p0))
    p = ten(p0).requires_grad_()
    sp = run(P, p)
    (g,) = torch.autograd.grad(torch.sum(sp.ys[-1]), p)
    assert sp.retcode == 0
    assert rel(sp.ys, yj) <= 1e-10 and rel(g, gj) <= 1e-10
    I0 = alpha * (1 - np.exp(-beta * tau)) / beta
    chain = P.solve(P.ODEProblem(
        lambda z, q, t: torch.stack([-z[1], q[0] * z[0] - q[1] * z[1]]),
        ten([1.0, I0]), (0.0, 3.0), ten(p0)), P.Tsit5(), saveat=ts,
        rtol=1e-10, atol=1e-12)
    assert float((sp.ys[:, 0] - chain.ys[:, 0]).abs().max()) < 5e-3


def test_distributed_plus_discrete_lags():
    """Discrete then distributed delays in f's hist tuple, at dt 0.05 (the
    JAX test: 0.01, 100 reads a stage): rows and the gradient through both
    channels equal JAX's to 1e-10, and the gradient central differences to
    1e-8."""
    ts = np.array([0.0, 1.0])

    def run(mod, p):
        lib = jnp if mod is J else torch

        def f_dde(u, hist, pp, t):
            ud, I = hist
            return -0.1 * ud - 0.05 * I

        prob = mod.DDEProblem(f_dde, 2.0 * lib.ones(1, dtype=lib.float64),
                              (0.0, 1.0), p, lags=(0.5,), max_lag=1.0,
                              dist_kernels=(lambda s, pp: pp[0],))
        return mod.solve(prob, dt=0.05, saveat=ts).ys

    yj, gj = jax_o0(lambda p: (run(J, p), jax.grad(
        lambda q: jnp.sum(run(J, q)[-1]))(p)), jnp.asarray([0.5]))
    p = ten([0.5]).requires_grad_()
    yp = run(P, p)
    (g,) = torch.autograd.grad(torch.sum(yp[-1]), p)
    assert torch.isfinite(yp).all()
    assert rel(yp, yj) <= 1e-10 and rel(g, gj) <= 1e-10
    fd = (float(run(P, ten([0.5 + 1e-6]))[-1].sum())
          - float(run(P, ten([0.5 - 1e-6]))[-1].sum())) / 2e-6
    assert abs(float(g[0]) - fd) < 1e-8


# -- adaptive -----------------------------------------------------------------


def test_dde_adaptive_exact_piecewise():
    """No dt: the adaptive method of steps at rtol 1e-8 takes JAX's steps
    (under 20), its rows equal JAX's to 1e-10 and the exact solution to
    1e-9, and sol(0.75) reads the dense output to 1e-9."""
    ref = jax_o0(lambda u: j_out(J.solve(
        jprob(neg_delay, u, (0.0, 2.0), lags=(1.0,)),
        saveat=jnp.asarray(TS5), rtol=1e-8, atol=1e-10)), jnp.ones(1))
    sp = P.solve(pprob(neg_delay, [1.0], (0.0, 2.0), lags=(1.0,)),
                 saveat=TS5, rtol=1e-8, atol=1e-10)
    assert_same_solve(sp, ref, 1e-10)
    assert sp.stats.n_accepted < 20
    assert sp.solver == "MethodOfStepsAdaptiveTsit5"
    expect = np.array([_exact_unit_lag(t) for t in TS5])
    np.testing.assert_allclose(sp.ys[:, 0].numpy(), expect, atol=1e-9)
    assert abs(float(sp(0.75)[0]) - _exact_unit_lag(0.75)) < 1e-9


def _logistic(lib):
    return lambda u, h, p, t: p[0] * u * (1.0 - h[0])


TS3 = np.array([0.0, 2.0, 4.0])


def _logistic_prob(mod, p, **kw):
    lib = jnp if mod is J else torch
    return mod.DDEProblem(_logistic(lib), 0.5 * lib.ones(1, dtype=lib.float64),
                          (0.0, 4.0), p, lags=(0.8,), **kw)


@functools.lru_cache(maxsize=None)
def _logistic_fixed_ref():
    """JAX's fixed-grid delayed logistic at dt 1e-3 (the JAX tests: 1e-4;
    RK4's error at 1e-3 is ~1e-12 here): rows and dL/dp."""
    def loss(p):
        ys = J.solve(_logistic_prob(J, p), dt=1e-3, saveat=jnp.asarray(TS3)).ys
        return jnp.sum(ys ** 2), ys
    g, ys = jax_o0(jax.grad(loss, has_aux=True), jnp.asarray([1.7]))
    return np.asarray(ys), np.asarray(g)


def test_dde_adaptive_tolerance_controls_error():
    """Delayed logistic at rtol 1e-3, 1e-6, 1e-9: each takes JAX's steps and
    rows (1e-10); the error against JAX's fixed grid falls and the steps
    rise with the tolerance, below 1e-7 at 1e-9."""
    ref_ys, _ = _logistic_fixed_ref()
    errs, accs = [], []
    for rt in (1e-3, 1e-6, 1e-9):
        ref = jax_o0(lambda p: j_out(J.solve(
            _logistic_prob(J, p), saveat=jnp.asarray(TS3), rtol=rt,
            atol=rt * 1e-2)), jnp.asarray([1.7]))
        sp = P.solve(_logistic_prob(P, ten([1.7])), saveat=TS3, rtol=rt,
                     atol=rt * 1e-2)
        assert_same_solve(sp, ref, 1e-10)
        errs.append(float(np.abs(sp.ys.numpy() - ref_ys).max()))
        accs.append(sp.stats.n_accepted)
    assert errs[0] > errs[1] > errs[2] and accs[0] < accs[1] < accs[2]
    assert errs[2] < 1e-7


def test_dde_adaptive_gradient_converges_to_fixed_grid():
    """dL/dp at rtol 1e-10 equals JAX's to 1e-10 (same steps) and JAX's
    fixed grid to 1e-6."""
    def loss(p):
        s = J.solve(_logistic_prob(J, p), saveat=jnp.asarray(TS3),
                    rtol=1e-10, atol=1e-12)
        return jnp.sum(s.ys ** 2), (s.stats.n_accepted, s.stats.n_rejected)

    gj, (acc, rej) = jax_o0(jax.grad(loss, has_aux=True), jnp.asarray([1.7]))
    p = ten([1.7]).requires_grad_()
    sp = P.solve(_logistic_prob(P, p), saveat=TS3, rtol=1e-10, atol=1e-12)
    (g,) = torch.autograd.grad(torch.sum(sp.ys ** 2), p)
    assert (sp.stats.n_accepted, sp.stats.n_rejected) == (int(acc), int(rej))
    assert rel(g, gj) <= 1e-10
    assert np.isclose(float(g[0]), float(_logistic_fixed_ref()[1][0]),
                      rtol=1e-6)


def _dep_lag(lib):
    return lambda u, p, t: 0.6 + 0.2 * lib.sin(u[0]) ** 2


def test_dde_adaptive_state_dependent_lag():
    """τ(u) in [0.6, 0.8] adaptively: dtmax is required (ValueError in
    both); at rtol 1e-9 with dtmax 0.5 the steps and rows equal JAX's
    (1e-10), and the gradient at rtol 1e-10 JAX's (1e-10). The JAX test
    also holds its adaptive solve to its fixed grid at dt 2e-4 (20,000
    steps); the port's equality with JAX's adaptive solve carries that
    over."""
    def prob(mod, p):
        lib = jnp if mod is J else torch
        return mod.DDEProblem(_logistic(lib),
                              0.5 * lib.ones(1, dtype=lib.float64),
                              (0.0, 4.0), p, lags=(_dep_lag(lib),),
                              max_lag=0.8)

    for mod in (J, P):
        with pytest.raises(ValueError, match="dtmax"):
            mod.solve(prob(mod, ten([1.3]) if mod is P else jnp.asarray(
                [1.3])), saveat=TS3)
    ref = jax_o0(lambda p: j_out(J.solve(prob(J, p), saveat=jnp.asarray(TS3),
                                         dtmax=0.5, rtol=1e-9, atol=1e-11)),
                 jnp.asarray([1.3]))
    sp = P.solve(prob(P, ten([1.3])), saveat=TS3, dtmax=0.5, rtol=1e-9,
                 atol=1e-11)
    assert_same_solve(sp, ref, 1e-10)

    g_ad = jax_o0(jax.grad(lambda q: jnp.sum(J.solve(
        prob(J, q), saveat=jnp.asarray(TS3), dtmax=0.5, rtol=1e-10,
        atol=1e-12).ys ** 2)), jnp.asarray([1.3]))
    p = ten([1.3]).requires_grad_()
    s = P.solve(prob(P, p), saveat=TS3, dtmax=0.5, rtol=1e-10, atol=1e-12)
    (g,) = torch.autograd.grad(torch.sum(s.ys ** 2), p)
    assert rel(g, g_ad) <= 1e-10


def test_dde_adaptive_dep_lag_violation_poisons():
    """A realizable lag of 0.01 under a dtmax cap of 0.3: retcode 3 and NaN
    rows in both packages."""
    sj = jax_o0(lambda u: j_out(J.solve(
        jprob(neg_delay, u, (0.0, 4.0), lags=(lambda u, p, t: 0.01,)),
        saveat=jnp.asarray([0.0, 4.0]), dtmax=0.3)), 0.5 * jnp.ones(1))
    sp = P.solve(pprob(neg_delay, [0.5], (0.0, 4.0),
                       lags=(lambda u, p, t: 0.01,)),
                 saveat=[0.0, 4.0], dtmax=0.3)
    assert int(sj[3]) == 3 and sp.retcode == 3
    assert np.isnan(np.asarray(sj[0])).all() and torch.isnan(sp.ys).all()


def test_dde_adaptive_rejects_unsupported():
    """dist_kernels on the adaptive path, an explicit solver that is not
    RK, a mass-matrix ESDIRK and t1 <= t0 raise as in JAX (dde.py:60-100)."""
    for mod, lib in ((J, jnp), (P, torch)):
        one = lib.ones(1, dtype=lib.float64)
        prob_dist = mod.DDEProblem(neg_delay, one, (0.0, 1.0), None,
                                   lags=(0.5,), max_lag=1.0,
                                   dist_kernels=(lambda s, p: 1.0,))
        with pytest.raises(NotImplementedError, match="fixed-grid"):
            mod.solve(prob_dist, saveat=np.array([0.0, 1.0]))
        prob = mod.DDEProblem(neg_delay, one, (0.0, 1.0), None,
                              lags=(0.5,))
        with pytest.raises(NotImplementedError, match="explicit RK"):
            mod.solve(prob, mod.Rosenbrock23())
        with pytest.raises(NotImplementedError, match="mass matrices"):
            mod.solve(prob, mod.SDIRK4().with_mass_matrix(np.eye(1)))
        back = mod.DDEProblem(neg_delay, one, (1.0, 0.0), None,
                              lags=(0.5,))
        with pytest.raises(ValueError, match="forward"):
            mod.solve(back)


def test_dde_adaptive_stiff_trbdf2():
    """A = 5000 adaptively (rtol 1e-4): TRBDF2 takes JAX's steps and rows
    (1e-10), under 500 steps; adaptive Tsit5 with max_steps 1024 fails
    with the same retcode in both. (The JAX test also holds its adaptive
    TRBDF2 to its fixed one at dt 5e-4, 4000 steps.)"""
    ts = np.array([0.0, 0.7, 1.4, 2.0])
    ref = jax_o0(lambda u: j_out(J.solve(
        jprob(_stiff_rhs(jnp, 5000.0), u, (0.0, 2.0), lags=(1.0,)),
        J.TRBDF2(), saveat=jnp.asarray(ts), rtol=1e-4, atol=1e-7)),
        jnp.ones(1))
    sp = P.solve(pprob(_stiff_rhs(torch, 5000.0), [1.0], (0.0, 2.0),
                       lags=(1.0,)), P.TRBDF2(), saveat=ts, rtol=1e-4,
                 atol=1e-7)
    assert_same_solve(sp, ref, 1e-10)
    assert sp.stats.n_accepted < 500
    rc_j = jax_o0(lambda u: J.solve(
        jprob(_stiff_rhs(jnp, 5000.0), u, (0.0, 2.0), lags=(1.0,)),
        saveat=jnp.asarray(ts), rtol=1e-4, atol=1e-7,
        max_steps=1024).retcode, jnp.ones(1))
    exp = P.solve(pprob(_stiff_rhs(torch, 5000.0), [1.0], (0.0, 2.0),
                        lags=(1.0,)), saveat=ts, rtol=1e-4, atol=1e-7,
                  max_steps=1024)
    assert int(rc_j) != 0 and exp.retcode == int(rc_j)


def _stiff_ad_loss(mod, p, **kw):
    lib = jnp if mod is J else torch
    sin = (jnp.sin if mod is J else
           (lambda x: float(np.sin(x))))
    prob = mod.DDEProblem(
        lambda u, h, q, t: -q[0] * (u - sin(2.0 * np.pi * t)) + q[1] * h[0],
        lib.ones(1, dtype=lib.float64), (0.0, 2.0), p, lags=(1.0,))
    sol = mod.solve(prob, mod.TRBDF2(), saveat=np.array([0.0, 1.0, 2.0]),
                    **kw)
    return lib.sum(sol.ys ** 2), sol


def test_dde_adaptive_stiff_gradient_vs_fixed_grid():
    """Adaptive TRBDF2 at rtol 1e-4 (the JAX test: 1e-6, 861 steps): the
    gradient equals JAX's to 1e-10; a truncated solve (max_steps 64 at
    rtol 1e-10; the JAX test: 512) poisons the gradient with NaN in both.
    (The JAX test also holds its adaptive gradient to its fixed TRBDF2 at
    dt 2e-4, 10,000 steps.)"""
    p0 = jnp.asarray([60.0, 4.0])
    g_j, g_bad = jax_o0(lambda p: (
        jax.grad(lambda q: _stiff_ad_loss(J, q, rtol=1e-4, atol=1e-6,
                                          max_steps=2048)[0])(p),
        jax.grad(lambda q: _stiff_ad_loss(J, q, rtol=1e-10, atol=1e-12,
                                          max_steps=64)[0])(p)), p0)
    p = ten([60.0, 4.0]).requires_grad_()
    L, _ = _stiff_ad_loss(P, p, rtol=1e-4, atol=1e-6, max_steps=2048)
    (g,) = torch.autograd.grad(L, p)
    assert rel(g, g_j) <= 1e-10
    p = ten([60.0, 4.0]).requires_grad_()
    L, sol = _stiff_ad_loss(P, p, rtol=1e-10, atol=1e-12, max_steps=64)
    (g_p_bad,) = torch.autograd.grad(L, p)
    assert sol.retcode == 1
    assert torch.isnan(g_p_bad).all() and np.isnan(np.asarray(g_bad)).all()


def test_dde_adaptive_stiff_rejects_dep_lags():
    for mod, lib in ((J, jnp), (P, torch)):
        prob = mod.DDEProblem(neg_delay, lib.ones(1, dtype=lib.float64),
                              (0.0, 1.0), None, lags=(lambda u, p, t: 0.5,),
                              max_lag=0.6)
        with pytest.raises(NotImplementedError, match="[Ss]tate-dependent"):
            mod.solve(prob, mod.TRBDF2(), saveat=np.array([0.0, 1.0]),
                      dtmax=0.3)


# -- a kernel field -----------------------------------------------------------


def test_stiff_dde_on_kernel_field_raises_before_launch():
    """A stiff DDE (TRBDF2, fixed grid or adaptive) on the fused MLP field
    raises ForwardModeUnsupported by name, from the forward-mode probe that
    runs before any field evaluation; the explicit method of steps runs on
    it and its gradient reaches every weight through the kernel's
    pullback."""
    g = np.random.default_rng(0)
    mlp = {"W0": 0.5 * g.standard_normal((2, 8)), "b0": np.zeros(8),
           "W1": 0.3 * g.standard_normal((8, 2)), "b1": np.zeros(2)}
    pt = {k: ten(v) for k, v in mlp.items()}
    prob = P.DDEProblem(lambda u, h, q, t: P.fused_mlp2(q, h[0]),
                        ten([2.0, 0.0]), (0.0, 0.5), pt, lags=(0.25,))
    with pytest.raises(ForwardModeUnsupported, match="FusedMLP2"):
        P.solve(prob, P.TRBDF2(), dt=0.05)
    with pytest.raises(ForwardModeUnsupported, match="FusedMLP2"):
        P.solve(prob, P.TRBDF2())
    for v in pt.values():
        v.requires_grad_()
    ys = P.solve(prob, dt=0.05).ys
    grads = torch.autograd.grad(ys.pow(2).sum(), list(pt.values()))
    assert all(torch.isfinite(gr).all() for gr in grads)
    assert float(grads[0].abs().sum()) > 0
