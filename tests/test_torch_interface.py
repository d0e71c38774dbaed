"""Parity of the port's direct API, `adjoint_sensitivities`, with the JAX
package's, in float64 on the CPU, on the inputs of tests/test_interface.py
(LV_P, LV_U0; its mixed-cost case on (0, 5) with data at 1-4 where the
JAX test takes (0, 10) and 1-9, to keep the tier-1 clock) and of
tests/test_callbacks.py's direct-API cases; the port's public names
against the JAX package's, and `solve(save_idxs=)`.

Each JAX reference is compiled at XLA optimization level 0
(`torch_parity.jax_o0`): its rounding is op by op, so the adaptive forward
and reverse take the port's steps, and each family of the port matches the
same family of JAX to 1e-9 relative (on Lotka–Volterra the rules of one
package differ from one another by the solver tolerance, ~1e-6 here, so
there the families are compared family by family). The terminated and the
event case are piecewise quadratic, which Tsit5 and the Hermite
interpolant hold exactly: every family of either package gives the same
gradient to roundoff (~1e-15), so JAX's GaussAdjoint is the one reference
for every family of the port there. One JAX program per case, cached for
the module."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (jax_o0, lotka_volterra_jax, lotka_volterra_port,
                          to_numpy)

import scimlsensitivity_jl_tpu as J
import scimlsensitivity_jl_tpu_torch as P

LV_P = np.array([1.5, 1.0, 3.0, 1.0])
LV_U0 = np.array([1.0, 1.0])
T1 = 5.0
TOLS = dict(rtol=1e-6, atol=1e-8)
RTOL = 1e-9  # port family against the same JAX family
FAMILIES = ["InterpolatingAdjoint", "BacksolveAdjoint", "GaussAdjoint",
            "GaussKronrodAdjoint", "QuadratureAdjoint"]
DT = torch.float64


def _t(x):
    return torch.tensor(np.asarray(x, float), dtype=DT)


def _close(port, ref, rtol=RTOL, msg=""):
    ref = np.asarray(ref)
    np.testing.assert_allclose(to_numpy(port), ref, rtol=rtol,
                               atol=rtol * float(np.max(np.abs(ref))),
                               err_msg=msg)


# -- mixed discrete and continuous costs (test_interface.py:262-305) ---------

TS_DATA = np.linspace(1.0, 4.0, 4)


def _mixed_costs(stack, vec):
    """G = ∫ (u₁² + p₁) dt + Σᵢ (u₁(tᵢ)² + p₂): the four callbacks."""
    return dict(
        dgdu_discrete=lambda u, p, t, i: stack([2 * u[0], 0.0 * u[0]]),
        dgdp_discrete=lambda u, p, t, i: vec([0.0, 1.0, 0.0, 0.0]),
        dgdu_continuous=lambda u, p, t: stack([2 * u[0], 0.0 * u[0]]),
        dgdp_continuous=lambda u, p, t: vec([1.0, 0.0, 0.0, 0.0]))


def _g_cost(u, p, t):
    return (u ** 2).sum() + (p ** 2).sum()


@pytest.fixture(scope="module")
def lv_ref():
    """JAX's (du0, dp) of the mixed cost under every family, and of the
    g= cost with t_grads under InterpolatingAdjoint (t = [0, T1])."""
    def run(u0, p):
        sol = J.solve(J.ODEProblem(lotka_volterra_jax, u0, (0.0, T1), p),
                      J.Tsit5(), dense=True, **TOLS)
        out = {fam: J.adjoint_sensitivities(
            sol, J.Tsit5(), t=jnp.asarray(TS_DATA), sensealg=getattr(J, fam)(),
            **_mixed_costs(jnp.stack, jnp.array), **TOLS)
            for fam in FAMILIES}
        out["g"] = J.adjoint_sensitivities(
            sol, J.Tsit5(), g=_g_cost, t=jnp.array([0.0, T1]),
            sensealg=J.InterpolatingAdjoint(), t_grads=True, **TOLS)
        return out

    return jax_o0(run, jnp.asarray(LV_U0), jnp.asarray(LV_P))


@pytest.fixture(scope="module")
def lv_sol():
    return P.solve(P.ODEProblem(lotka_volterra_port, _t(LV_U0), (0.0, T1),
                                _t(LV_P)), P.Tsit5(), dense=True, **TOLS)


@pytest.mark.parametrize("family", FAMILIES)
def test_mixed_costs_match_jax(lv_ref, lv_sol, family):
    """A discrete cost with its ∂g/∂p and a continuous cost with its ∂g/∂p
    in one call, every family against JAX's, to 1e-9."""
    du0, dp = P.adjoint_sensitivities(
        lv_sol, P.Tsit5(), t=TS_DATA, sensealg=getattr(P, family)(),
        **_mixed_costs(torch.stack, _t), **TOLS)
    ref = lv_ref[family]
    _close(du0, ref[0], msg=family)
    _close(dp, ref[1], msg=family)


def test_g_cost_and_t_grads_match_jax(lv_ref, lv_sol):
    """g(u, p, t) = Σu² + Σp², its derivatives from torch.func.grad (JAX:
    jax.grad), with t_grads: (du0, dp) and (dG/dt0, dG/dt1) to 1e-9."""
    du0, dp, (dt0, dt1) = P.adjoint_sensitivities(
        lv_sol, P.Tsit5(), g=_g_cost, t=[0.0, T1],
        sensealg=P.InterpolatingAdjoint(), t_grads=True, **TOLS)
    ref = lv_ref["g"]
    _close(du0, ref[0])
    _close(dp, ref[1])
    _close(torch.stack([dt0, dt1]), np.array([ref[2][0], ref[2][1]]))


# -- a terminated solution (test_interface.py:355-441) -----------------------

TERM_TS = np.linspace(0.0, 5.0, 6)
TERM_W = np.arange(1.0, 13.0).reshape(6, 2)
TERM_FAMILIES = ["InterpolatingAdjoint", "GaussAdjoint", "QuadratureAdjoint",
                 "BacksolveAdjoint"]
TIGHT = dict(rtol=1e-10, atol=1e-12)


def _alg(mod, fam):
    if fam == "QuadratureAdjoint":
        return mod.QuadratureAdjoint(abstol=1e-13, reltol=1e-11)
    return getattr(mod, fam)()


def _falling(mod, stack):
    """u = [height, velocity] under gravity q[0], stopped by a terminal
    callback where the height crosses 0 downwards."""
    cb = mod.ContinuousCallback(lambda u, q, t: u[0], lambda u, q, t: u,
                                direction=-1, terminal=True)
    f = lambda u, q, t: stack([u[1], -q[0] + 0.0 * u[0]])
    return f, cb


@pytest.fixture(scope="module")
def term_ref():
    f, cb = _falling(J, jnp.stack)

    def run(u0, q):
        sol = J.solve(J.ODEProblem(f, u0, (0.0, 5.0), q), J.Tsit5(),
                      saveat=jnp.asarray(TERM_TS), callback=cb, dense=True,
                      **TIGHT)
        out = {"discrete": J.adjoint_sensitivities(
            sol, t=jnp.asarray(TERM_TS), callback=cb,
            sensealg=J.GaussAdjoint(),
            dgdu_discrete=lambda u, qq, t, i: jnp.asarray(TERM_W)[i],
            **TIGHT)}
        out["g"] = J.adjoint_sensitivities(
            sol, t=jnp.array([5.0]), g=lambda u, qq, t: u[1] ** 2,
            callback=cb, sensealg=J.GaussAdjoint(), t_grads=True, **TIGHT)
        return out, sol.retcode

    return jax_o0(run, jnp.array([2.0, 0.0]), jnp.array([3.0]))


def test_terminated_solution_matches_jax(term_ref):
    """Retcode 5: the reverse runs over [t0, t_final] and the held rows'
    cotangents fold in at its start; every family against JAX's
    GaussAdjoint to 1e-9, and a running cost with t_grads (dG/dt1 = 0: the
    solve stopped before t1)."""
    ref, rc = term_ref
    f, cb = _falling(P, torch.stack)
    sol = P.solve(P.ODEProblem(f, _t([2.0, 0.0]), (0.0, 5.0), _t([3.0])),
                  P.Tsit5(), saveat=TERM_TS, callback=cb, dense=True, **TIGHT)
    assert sol.retcode == int(rc) == 5
    w = _t(TERM_W)
    for fam in TERM_FAMILIES:
        du0, dp = P.adjoint_sensitivities(
            sol, t=TERM_TS, callback=cb, sensealg=_alg(P, fam),
            dgdu_discrete=lambda u, q, t, i: w[i], **TIGHT)
        _close(du0, ref["discrete"][0], msg=fam)
        _close(dp, ref["discrete"][1], msg=fam)
    du0, dp, (dt0, dt1) = P.adjoint_sensitivities(
        sol, t=[5.0], g=lambda u, q, t: u[1] ** 2, callback=cb,
        sensealg=P.GaussAdjoint(), t_grads=True, **TIGHT)
    _close(du0, ref["g"][0])
    _close(dp, ref["g"][1])
    assert float(dt1) == 0.0 == float(ref["g"][2][1])
    np.testing.assert_allclose(float(dt0), float(ref["g"][2][0]), rtol=RTOL,
                               atol=1e-12)


# -- an event solution with callback= (test_callbacks.py:301-355) ------------

G = 9.81
BALL_TS = np.linspace(0.0, 1.2, 7)
EVENT_FAMILIES = ["InterpolatingAdjoint", "BacksolveAdjoint", "GaussAdjoint",
                  "QuadratureAdjoint"]


def _ball(mod, stack):
    cb = mod.ContinuousCallback(
        condition=lambda u, p, t: u[0],
        affect=lambda u, p, t: stack([u[0], -p[0] * u[1]]), direction=-1)
    f = lambda u, p, t: stack([u[1], -G + 0.0 * u[0]])
    return f, cb


def _ball_run_cost(u, p, t):
    return u[0] ** 2 + 0.1 * u[1] ** 2


@pytest.fixture(scope="module")
def ball_ref():
    f, cb = _ball(J, jnp.stack)

    def run(u0, p):
        sol = J.solve(J.ODEProblem(f, u0, (0.0, 1.2), p), J.Tsit5(),
                      saveat=jnp.asarray(BALL_TS), callback=cb, dense=True,
                      **TIGHT)
        out = {"discrete": J.adjoint_sensitivities(
            sol, J.Tsit5(), t=jnp.asarray(BALL_TS), callback=cb,
            dgdu_discrete=lambda u, pp, t, i: 2.0 * u,
            sensealg=J.GaussAdjoint(), **TIGHT)}
        # a running cost whose integrand jumps at the bounce
        out["g"] = J.adjoint_sensitivities(
            sol, J.Tsit5(), g=_ball_run_cost, callback=cb,
            sensealg=J.InterpolatingAdjoint(), **TIGHT)
        return out, sol.events[3]

    return jax_o0(run, jnp.array([1.0, 0.0]), jnp.array([0.9]))


@pytest.fixture(scope="module")
def ball_sol():
    f, cb = _ball(P, torch.stack)
    sol = P.solve(P.ODEProblem(f, _t([1.0, 0.0]), (0.0, 1.2), _t([0.9])),
                  P.Tsit5(), saveat=BALL_TS, callback=cb, dense=True, **TIGHT)
    return sol, cb


def test_event_solution_matches_jax(ball_ref, ball_sol):
    """The bouncing ball solved with callback=: every family applies the
    recorded bounce's reverse jump, against JAX's GaussAdjoint to 1e-9;
    and a running cost through the bounce, whose moving-boundary term
    needs g=."""
    ref, count = ball_ref
    sol, cb = ball_sol
    assert sol.events.count == int(count) >= 1
    for fam in EVENT_FAMILIES:
        du0, dp = P.adjoint_sensitivities(
            sol, P.Tsit5(), t=BALL_TS, callback=cb,
            dgdu_discrete=lambda u, p, t, i: 2.0 * u,
            sensealg=getattr(P, fam)(), **TIGHT)
        _close(du0, ref["discrete"][0], msg=fam)
        _close(dp, ref["discrete"][1], msg=fam)
    du0, dp = P.adjoint_sensitivities(sol, P.Tsit5(), g=_ball_run_cost,
                                      callback=cb, **TIGHT)
    _close(du0, ref["g"][0])
    _close(dp, ref["g"][1])


# -- the refusals, as JAX's ---------------------------------------------------

@pytest.mark.parametrize("case", ["no callback", "stray callback",
                                  "continuous cost without g", "sde", "dae",
                                  "no dense"])
def test_refusals_match_jax(ball_sol, lv_sol, case):
    """A missing callback on an event solution, a callback on a solution
    without events and a derivative-only continuous cost over a continuous
    event raise as JAX's do (ValueError, ValueError, NotImplementedError);
    on an SDE solution a continuous cost and t_grads raise, and
    SDEAdjointProblem refuses an adaptive one, as JAX's do
    (interface.py:191-204, adjoint_problem.py:446-453); on a DAE
    solution (its stepper carries the singular mass) BacksolveAdjoint and
    t_grads raise NotImplementedError, as JAX's do (interface.py:342-360);
    a solution without dense output raises ValueError."""
    import dataclasses

    sol, cb = ball_sol
    dg = lambda u, p, t, i: 2.0 * u
    if case == "no callback":
        with pytest.raises(ValueError, match="callback"):
            P.adjoint_sensitivities(sol, dgdu_discrete=dg)
    elif case == "stray callback":
        with pytest.raises(ValueError, match="no event records"):
            P.adjoint_sensitivities(lv_sol, dgdu_discrete=dg, callback=cb)
    elif case == "continuous cost without g":
        with pytest.raises(NotImplementedError, match="moving-boundary"):
            P.adjoint_sensitivities(
                sol, callback=cb,
                dgdu_continuous=lambda u, p, t: torch.stack(
                    [2 * u[0], 0.2 * u[1]]))
    elif case == "sde":
        prob = P.SDEProblem(lambda u, p, t: -p[0] * u,
                            lambda u, p, t: 0.1 * u,
                            torch.tensor([1.0], dtype=DT), (0.0, 1.0),
                            torch.tensor([1.0], dtype=DT))
        fixed = P.solve(prob, P.EulerMaruyama(), dt=0.1, key=0)
        with pytest.raises(NotImplementedError, match="discrete costs"):
            P.adjoint_sensitivities(fixed, dgdu_discrete=dg,
                                    g=lambda u, p, t: torch.sum(u ** 2))
        with pytest.raises(NotImplementedError, match="t_grads"):
            P.adjoint_sensitivities(fixed, dgdu_discrete=dg, t_grads=True)
        adaptive = P.solve(prob, rtol=1e-2, atol=1e-4, key=0)
        with pytest.raises(NotImplementedError, match="FIXED-GRID"):
            P.SDEAdjointProblem(adaptive, dgdu_discrete=dg)
    elif case == "dae":
        # y' = -y, 0 = z - y: the mass-matrix branch moves M onto SDIRK4
        dae = P.solve(P.ODEProblem(
            lambda u, p, t: torch.stack([-p[0] * u[0], u[1] - u[0]]),
            torch.tensor([1.0, 1.0], dtype=DT), (0.0, 0.1),
            torch.tensor([1.0], dtype=DT), mass_matrix=np.diag([1.0, 0.0])),
            P.SDIRK4(), dt0=1e-2, dense=True)
        assert dae.solver.mass_matrix is not None
        with pytest.raises(NotImplementedError, match="BacksolveAdjoint"):
            P.adjoint_sensitivities(dae, dgdu_discrete=dg,
                                    sensealg=P.BacksolveAdjoint())
        with pytest.raises(NotImplementedError, match="t_grads"):
            P.adjoint_sensitivities(dae, dgdu_discrete=dg, t_grads=True)
    else:
        with pytest.raises(ValueError, match="dense=True"):
            P.adjoint_sensitivities(dataclasses.replace(lv_sol, dense=None),
                                    dgdu_discrete=dg)


def test_failed_forward_poisons_the_gradients(lv_sol):
    """A forward that ran out of steps (retcode 1) gives NaN sensitivities
    and a NaN dG/dt0, as JAX's `_finish` poisons them; a terminated one
    (retcode 5) does not (test_terminated_solution_matches_jax)."""
    import dataclasses

    failed = dataclasses.replace(lv_sol, retcode=1)
    du0, dp, (dt0, dt1) = P.adjoint_sensitivities(
        failed, g=_g_cost, t=[0.0, T1], t_grads=True, **TOLS)
    assert torch.isnan(du0).all() and torch.isnan(dp).all()
    assert torch.isnan(dt0) and not torch.isnan(dt1)


# -- the public names and save_idxs -----------------------------------------

# public names of the JAX package that wait for later ROADMAP items (none:
# the port exports every one)
NOT_YET = {}


def test_public_names_match_jax():
    """The port exports every public name of the JAX package but the ones
    NOT_YET lists under their ROADMAP items, and each of those is absent
    (a name that lands must leave the list); the aliases build what JAX's
    do."""
    waiting = {name for names in NOT_YET.values() for name in names}
    assert set(J.__all__) - set(P.__all__) == waiting
    assert all(hasattr(P, name) for name in set(J.__all__) - waiting)
    for name in ("ZygoteAdjoint", "ReverseDiffAdjoint", "TrackerAdjoint",
                 "EnzymeAdjoint", "MooncakeAdjoint"):
        assert isinstance(getattr(P, name)(compile=True), P.DirectAdjoint)
        assert isinstance(getattr(J, name)(), J.DirectAdjoint)
    for name in ("ZygoteVJP", "EnzymeVJP", "TrackerVJP", "ReverseDiffVJP",
                 "MooncakeVJP", "ReactantVJP"):
        assert isinstance(getattr(P, name)(), P.AutoVJP)
        assert isinstance(getattr(J, name)(), J.AutoVJP)
    assert P.supports_functor_params(P.GaussAdjoint()) is True
    assert J.supports_functor_params(J.GaussAdjoint()) is True


SAVE_TS = np.linspace(0.0, 2.0, 5)
SAVE_RULES = ["DirectAdjoint", "GaussAdjoint"]


@pytest.fixture(scope="module")
def save_idxs_ref():
    """JAX's ys and (u0, p) gradient of Σ ys² with save_idxs=[1], per rule."""
    def run(u0, p):
        out = {}
        for rule in SAVE_RULES:
            def loss(u0_, p_):
                sol = J.solve(J.ODEProblem(lotka_volterra_jax, u0_, (0.0, 2.0),
                                           p_), J.Tsit5(),
                              saveat=jnp.asarray(SAVE_TS), save_idxs=[1],
                              sensealg=getattr(J, rule)(), **TOLS)
                return jnp.sum(sol.ys ** 2), sol.ys

            (_, ys), g = jax.value_and_grad(loss, argnums=(0, 1),
                                            has_aux=True)(u0, p)
            out[rule] = (ys, g)
        return out

    return jax_o0(run, jnp.asarray(LV_U0), jnp.asarray(LV_P))


@pytest.mark.parametrize("sensealg", SAVE_RULES)
def test_save_idxs_matches_jax(save_idxs_ref, sensealg):
    """solve(save_idxs=[1]) keeps ys[:, [1]], and the gradient of a loss on
    those rows flows through the gather, against JAX's to 1e-9
    (Lotka–Volterra on (0, 2), 5 save times)."""
    ys_j, g_j = save_idxs_ref[sensealg]
    ts = SAVE_TS
    u0, p = _t(LV_U0).requires_grad_(), _t(LV_P).requires_grad_()
    sol = P.solve(P.ODEProblem(lotka_volterra_port, u0, (0.0, 2.0), p),
                  P.Tsit5(), saveat=ts, save_idxs=[1],
                  sensealg=getattr(P, sensealg)(), **TOLS)
    assert tuple(sol.ys.shape) == (5, 1) == ys_j.shape
    _close(sol.ys, ys_j)
    g = torch.autograd.grad(torch.sum(sol.ys ** 2), (u0, p))
    _close(g[0], g_j[0])
    _close(g[1], g_j[1])
