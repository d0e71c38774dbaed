"""The port's reverse-problem constructors, `ODEAdjointProblem` and
`AdjointSensitivityIntegrand`, in float64 on the CPU, on the cases of the
JAX package's tests/test_interface.py:458-960: the reverse problem solved
by hand with the port's `solve` against the port's `adjoint_sensitivities`
and against JAX's, for the Interpolating, Backsolve and Quadrature
layouts and for solutions with events.

A solve by hand controls the error of every component of the reverse
state (q too, which the direct API weights 0), so it takes other steps
than the direct API: the two agree to the solver tolerance, and the
tolerances here are those of the JAX tests (1e-5 against the direct API
or exact AD, 2e-4 for a Simpson sum of the integrand). The JAX references
are JAX's direct API or exact AD over its solve, compiled at XLA
optimization level 0 (`torch_parity.jax_o0`); JAX's own constructor
reads its save times on the host and does not compile."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import jax_o0, lotka_volterra_jax, lotka_volterra_port

import scimlsensitivity_jl_tpu as J
import scimlsensitivity_jl_tpu_torch as P

DT = torch.float64
LV_P = np.array([1.5, 1.0, 3.0, 1.0])
LV_U0 = np.array([1.0, 1.0])
MANUAL_RTOL = 1e-5


def _t(x):
    return torch.tensor(np.asarray(x, float), dtype=DT)


def _close(port, ref, rtol, msg=""):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(port), ref, rtol=rtol,
                               atol=rtol * float(np.max(np.abs(ref))),
                               err_msg=msg)


def _cost(u, p, t, i):
    return 2.0 * u


def _solve_by_hand(spec, t0, t1, tol, dense=False):
    """spec.prob solved with the port's solve from t1 back to t0."""
    adj = P.solve(spec.prob, P.Tsit5(), callback=spec.callback,
                  tstops=spec.tstops, saveat=[t1, t0], max_steps=4096,
                  dense=dense, **tol)
    assert adj.success
    return adj


# -- Lotka–Volterra: the layouts (test_interface.py:458-541) -----------------

CASES = {"interp": (2.0, 7, dict(rtol=1e-9, atol=1e-11)),
         "quadrature": (1.5, 5, dict(rtol=1e-10, atol=1e-12))}


@pytest.fixture(scope="module")
def lv_ref():
    """JAX's direct API on each case: InterpolatingAdjoint on (0, 2) and
    QuadratureAdjoint on (0, 1.5)."""
    def run(u0, p):
        out = {}
        for key, alg in (("interp", J.InterpolatingAdjoint()),
                         ("quadrature", J.QuadratureAdjoint())):
            t1, nt, tol = CASES[key]
            ts = jnp.linspace(0.0, t1, nt)
            sol = J.solve(J.ODEProblem(lotka_volterra_jax, u0, (0.0, t1), p),
                          J.Tsit5(), saveat=ts, dense=True, **tol)
            out[key] = J.adjoint_sensitivities(sol, t=ts, dgdu_discrete=_cost,
                                               sensealg=alg, **tol)
        return out

    return jax_o0(run, jnp.asarray(LV_U0), jnp.asarray(LV_P))


def _lv_sol(key):
    t1, nt, tol = CASES[key]
    ts = np.linspace(0.0, t1, nt)
    sol = P.solve(P.ODEProblem(lotka_volterra_port, _t(LV_U0), (0.0, t1),
                               _t(LV_P)), P.Tsit5(), saveat=ts, dense=True,
                  **tol)
    return sol, ts, t1, tol


@pytest.mark.parametrize("layout", ["InterpolatingAdjoint",
                                    "BacksolveAdjoint"])
def test_manual_solve_matches_direct_api_and_jax(lv_ref, layout):
    """[λ; q] and [λ; q; u] solved by hand: (du0, dp) against the port's
    adjoint_sensitivities (InterpolatingAdjoint) and JAX's, to 1e-5."""
    sol, ts, t1, tol = _lv_sol("interp")
    spec = P.ODEAdjointProblem(sol, getattr(P, layout)(), t=ts,
                               dgdu_discrete=_cost)
    assert isinstance(spec, P.AdjointProblemSpec) and spec.prob.tspan == (
        t1, 0.0)
    du0, dp = spec.extract(_solve_by_hand(spec, 0.0, t1, tol).u_final)
    ref = P.adjoint_sensitivities(sol, t=ts, dgdu_discrete=_cost, **tol)
    for got, want, jax_ref in zip((du0, dp), ref, lv_ref["interp"]):
        _close(got, want, MANUAL_RTOL, layout)
        _close(got, jax_ref, MANUAL_RTOL, layout)


def test_quadrature_layout_and_integrand(lv_ref):
    """λ alone solved by hand gives dG/du0; AdjointSensitivityIntegrand
    over the forward and that reverse, summed by composite Simpson on 2001
    nodes, gives JAX's dG/dp to 2e-4 (the integrand is only C⁰ at the data
    times), and equals λᵀ∂f/∂p at a node."""
    sol, ts, t1, tol = _lv_sol("quadrature")
    spec = P.ODEAdjointProblem(sol, P.QuadratureAdjoint(), t=ts,
                               dgdu_discrete=_cost)
    adj = _solve_by_hand(spec, 0.0, t1, tol, dense=True)
    du0, _ = spec.extract(adj.u_final)
    ref = P.adjoint_sensitivities(sol, t=ts, dgdu_discrete=_cost,
                                  sensealg=P.QuadratureAdjoint(), **tol)
    _close(du0, ref[0], 1e-6)
    _close(du0, lv_ref["quadrature"][0], 1e-6)
    rho = P.AdjointSensitivityIntegrand(sol, adj)
    tq = np.linspace(0.0, t1, 2001)
    vals = torch.stack([rho(t) for t in tq]).numpy()
    w = np.ones(len(tq))
    w[1:-1:2], w[2:-1:2] = 4.0, 2.0
    dp_quad = (tq[1] - tq[0]) / 3.0 * w @ vals
    _close(dp_quad, lv_ref["quadrature"][1], 2e-4)
    u, lam = sol(0.7), adj(0.7)
    x, y = u
    a_bar = torch.stack([x * lam[0], -x * y * lam[0], -y * lam[1],
                         x * y * lam[1]])
    _close(rho(0.7), a_bar, 1e-12)


# -- event solutions (test_interface.py:776-960) ----------------------------

def _decay(mod):
    return lambda u, p, t: -p[0] * u


def _dose_cbs(mod, case):
    if case == "dose":
        return [mod.PresetTimeCallback(np.array([0.9]),
                                       lambda u, pr, t: u + pr[1])]
    # dose at 0.5 and 1.3, and a scaling also at 1.3, which does not
    # commute with the dose: the records at one time apply newest first
    return [mod.PresetTimeCallback(np.array([0.5, 1.3]),
                                   lambda u, pr, t: u + pr[1]),
            mod.PresetTimeCallback(np.array([1.3]),
                                   lambda u, pr, t: u * pr[2])]


EVENT_P = {"dose": [0.8, 0.35], "coincident": [0.8, 0.35, 1.15]}
EVENT_TS = np.linspace(0.0, 2.0, 5)
EVENT_TOL = dict(rtol=1e-9, atol=1e-11)


@pytest.fixture(scope="module")
def event_ref():
    """Exact AD over JAX's solve (DirectAdjoint) of Σ ys² for each case."""
    def run(u0, p_dose, p_coinc):
        out = {}
        for case, p in (("dose", p_dose), ("coincident", p_coinc)):
            def loss(p_, u0_):
                sol = J.solve(J.ODEProblem(_decay(J), u0_, (0.0, 2.0), p_),
                              J.Tsit5(), saveat=jnp.asarray(EVENT_TS),
                              callback=_dose_cbs(J, case),
                              sensealg=J.DirectAdjoint(), max_steps=512,
                              **EVENT_TOL)
                return jnp.sum(sol.ys ** 2)

            out[case] = jax.grad(loss, argnums=(1, 0))(p, u0)
        return out

    return jax_o0(run, jnp.array([1.0]), jnp.asarray(EVENT_P["dose"]),
                  jnp.asarray(EVENT_P["coincident"]))


@pytest.mark.parametrize("case", ["dose", "coincident"])
@pytest.mark.parametrize("layout", ["InterpolatingAdjoint",
                                    "BacksolveAdjoint"])
def test_event_bundle_matches_jax(event_ref, case, layout):
    """A dosed decay (one record) and two preset callbacks at one time
    (three records, two at 1.3): with the forward's callback the recorded
    events' reverse jumps come as a second PresetTimeCallback, each record
    applied once; solved by hand, against exact AD over JAX's solve and
    over the port's (DirectAdjoint), to 1e-5."""
    p = _t(EVENT_P[case])
    sol = P.solve(P.ODEProblem(_decay(P), _t([1.0]), (0.0, 2.0), p),
                  P.Tsit5(), saveat=EVENT_TS, callback=_dose_cbs(P, case),
                  dense=True, **EVENT_TOL)
    assert sol.events.count == (1 if case == "dose" else 3)
    spec = P.ODEAdjointProblem(sol, getattr(P, layout)(), t=EVENT_TS,
                               dgdu_discrete=_cost,
                               callback=_dose_cbs(P, case))
    assert len(spec.callback) == 2
    du0, dp = spec.extract(_solve_by_hand(spec, 0.0, 2.0, EVENT_TOL).u_final)
    u0d, pd = _t([1.0]).requires_grad_(), p.clone().requires_grad_()
    s = P.solve(P.ODEProblem(_decay(P), u0d, (0.0, 2.0), pd), P.Tsit5(),
                saveat=EVENT_TS, callback=_dose_cbs(P, case),
                sensealg=P.DirectAdjoint(), max_steps=512, **EVENT_TOL)
    torch.sum(s.ys ** 2).backward()
    du0_j, dp_j = event_ref[case]
    for got, port_ref, jax_ref in ((du0, u0d.grad, du0_j), (dp, pd.grad, dp_j)):
        _close(got, port_ref, MANUAL_RTOL, layout)
        _close(got, jax_ref, MANUAL_RTOL, layout)


def _ball(mod, stack):
    cb = mod.ContinuousCallback(
        condition=lambda u, p, t: u[0],
        affect=lambda u, p, t: stack([u[0], -p[0] * u[1]]), direction=-1)
    f = lambda u, p, t: stack([u[1], -9.81 + 0.0 * u[0]])
    return f, cb


def _run_cost(u, p, t):
    return u[0] ** 2 + 0.1 * u[1] ** 2


@pytest.mark.parametrize("layout", ["InterpolatingAdjoint",
                                    "BacksolveAdjoint"])
def test_continuous_event_running_cost(layout):
    """The bouncing ball with a running cost whose integrand jumps at the
    bounce: the bundled event callback carries the moving-boundary term
    (g⁻ − g⁺)·dτ, so the solve by hand gives the direct API's gradient
    (held to JAX's in test_torch_interface.py) to 1e-5; a derivative-only
    continuous cost is refused there, as in JAX."""
    f, cb = _ball(P, torch.stack)
    tol = dict(rtol=1e-10, atol=1e-12)
    sol = P.solve(P.ODEProblem(f, _t([1.0, 0.0]), (0.0, 1.2), _t([0.9])),
                  P.Tsit5(), callback=cb, dense=True, **tol)
    assert sol.events.count >= 1
    ref = P.adjoint_sensitivities(sol, g=_run_cost, callback=cb, **tol)
    with pytest.raises(NotImplementedError, match="moving-boundary"):
        P.ODEAdjointProblem(sol, getattr(P, layout)(), callback=cb,
                            dgdu_continuous=torch.func.grad(_run_cost))
    spec = P.ODEAdjointProblem(sol, getattr(P, layout)(), g=_run_cost,
                               callback=cb)
    du0, dp = spec.extract(_solve_by_hand(spec, 0.0, 1.2, tol).u_final)
    _close(du0, ref[0], MANUAL_RTOL, layout)
    _close(dp, ref[1], MANUAL_RTOL, layout)


@pytest.mark.parametrize("case", ["missing callback", "stray callback",
                                  "quadrature with events", "terminal",
                                  "sde", "rode"])
def test_refusals_match_jax(case):
    """What JAX's constructor refuses, the port's refuses with the same
    exception type: a missing or a stray forward callback (ValueError),
    QuadratureAdjoint's λ-only layout with events and terminal events
    (NotImplementedError); SDEAdjointProblem refuses an adaptive SDE
    solution (NotImplementedError) and either constructor a solution of
    another problem type (TypeError), as JAX's do
    (adjoint_problem.py:446-453, :557-560, :795-798)."""
    if case in ("sde", "rode"):
        sde = P.SDEProblem(_decay(P), lambda u, p, t: 0.1 * u, _t([1.0]),
                           (0.0, 1.0), _t([0.8]))
        fixed = P.solve(sde, P.EulerMaruyama(), dt=0.1, key=0)
        if case == "sde":
            adaptive = P.solve(sde, rtol=1e-2, atol=1e-4, key=0)
            with pytest.raises(NotImplementedError, match="FIXED-GRID"):
                P.SDEAdjointProblem(adaptive, dgdu_discrete=_cost)
        else:
            with pytest.raises(TypeError, match="RODEProblem"):
                P.RODEAdjointProblem(fixed, dgdu_discrete=_cost)
        fn = P.SDEAdjointProblem if case == "sde" else P.RODEAdjointProblem
        ode = P.solve(P.ODEProblem(_decay(P), _t([1.0]), (0.0, 1.0),
                                   _t([0.8])), P.Tsit5(), dense=True)
        with pytest.raises(TypeError, match="solution"):
            fn(ode, dgdu_discrete=_cost)
        return
    terminal = case == "terminal"
    cb = P.ContinuousCallback(lambda u, p, t: u[0] - 0.5,
                              lambda u, p, t: u, terminal=terminal)
    sol = P.solve(P.ODEProblem(_decay(P), _t([1.0]), (0.0, 2.0), _t([0.8])),
                  P.Tsit5(), saveat=EVENT_TS, dense=True,
                  callback=None if case == "stray callback" else cb)
    kw = dict(t=EVENT_TS, dgdu_discrete=_cost)
    if case == "missing callback":
        with pytest.raises(ValueError, match="event records"):
            P.ODEAdjointProblem(sol, **kw)
    elif case == "stray callback":
        with pytest.raises(ValueError, match="no event records"):
            P.ODEAdjointProblem(sol, callback=cb, **kw)
    elif case == "quadrature with events":
        with pytest.raises(NotImplementedError, match="QuadratureAdjoint"):
            P.ODEAdjointProblem(sol, P.QuadratureAdjoint(), callback=cb, **kw)
    else:
        with pytest.raises(NotImplementedError, match="terminal"):
            P.ODEAdjointProblem(sol, callback=cb, **kw)
