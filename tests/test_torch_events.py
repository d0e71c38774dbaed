"""Parity of the port's events and callbacks with the JAX package's, in
float64 on the CPU: the cases of tests/test_callbacks.py (but its two
direct-API tests, which wait for ROADMAP M11) and
tests/test_callback_library.py, as parametrised cases over the rules.

Every problem whose gradient has no closed form has a JAX reference,
compiled at XLA optimization level 0 (`torch_parity.jax_o0`, rounding op
by op, so both packages take the same steps) and cached for the module:
the bouncing ball, the parameter swap, the simultaneous events, the
vector callback, the terminal discrete stop, the steady state, the
terminal stop after a prior event, the kernel field and the float32 dose.
Event times are held to 1e-10 relative and gradients to 1e-8: the rules
of both packages differ from each other by at most ~3e-9 on these
problems, so one reference serves them all, and where a case needs more
its docstring says why. The dosing, time-to-event and t1 cases hold the
port to the closed form of the JAX test itself, at that test's tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import jax_o0, to_numpy

import scimlsensitivity_jl_tpu as J
import scimlsensitivity_jl_tpu_torch as P
from scimlsensitivity_jl_tpu.ops.pallas_mlp import fused_mlp2 as jax_fused
from scimlsensitivity_jl_tpu_torch.ops.mlp import fused_mlp2 as port_fused
from scimlsensitivity_jl_tpu_torch.ops.vjp import ForwardModeUnsupported

TOLS = dict(rtol=1e-10, atol=1e-12)
G = 9.81
GRAD_RTOL = 1e-8
DT = torch.float64

ALL_RULES = ["GaussAdjoint", "InterpolatingAdjoint", "BacksolveAdjoint",
             "QuadratureAdjoint", "GaussKronrodAdjoint",
             "InterpolatingAdjoint(checkpointing=True)",
             "ForwardDiffSensitivity", "DirectAdjoint", "None"]
FEW_RULES = ["GaussAdjoint", "BacksolveAdjoint", "QuadratureAdjoint",
             "DirectAdjoint"]


def _alg(mod, name):
    """A sensealg of package `mod` by name; QuadratureAdjoint gets the JAX
    tests' tight quadrature tolerances."""
    if name == "None":
        return None
    if name == "QuadratureAdjoint":
        return mod.QuadratureAdjoint(abstol=1e-12, reltol=1e-10)
    if "(" in name:
        cls, arg = name.split("(")
        return getattr(mod, cls)(checkpointing=True)
    return getattr(mod, name)()


def _port_grad(loss, *args):
    """Gradients of loss(*tensors) with respect to each numpy argument."""
    xs = [torch.tensor(np.asarray(a, float), dtype=DT).requires_grad_()
          for a in args]
    loss(*xs).backward()
    return [x.grad.numpy() for x in xs]


def _close(port, ref, rtol, msg=""):
    np.testing.assert_allclose(port, np.asarray(ref), rtol=rtol,
                               atol=rtol * float(np.max(np.abs(ref))),
                               err_msg=msg)


# -- the bouncing ball (test_callbacks.py, BASELINE config 4) ---------------

def _bounce(mod, stack):
    return mod.ContinuousCallback(
        condition=lambda u, p, t: u[0],
        affect=lambda u, p, t: stack([u[0], -p[0] * u[1]]), direction=-1)


def _ball_jax(u, p, t):
    return jnp.stack([u[1], -G + 0.0 * u[0]])


def _ball_port(u, p, t):
    return torch.stack([u[1], -G + 0.0 * u[0]])


BALL_TS = np.linspace(0.0, 2.0, 7)


@pytest.fixture(scope="module")
def ball_ref():
    """JAX's GaussAdjoint gradient of the ball's loss over three bounces,
    and its forward event record."""
    def loss(u0, p):
        sol = J.solve(J.ODEProblem(_ball_jax, u0, (0.0, 2.0), p), J.Tsit5(),
                      saveat=jnp.asarray(BALL_TS), callback=_bounce(J, jnp.stack),
                      sensealg=J.GaussAdjoint(), **TOLS)
        return (jnp.sum(sol.ys[:, 0] ** 2) + jnp.sum(sol.ys[-1] ** 2),
                (sol.events, sol.ys))

    (g, (events, ys)) = jax_o0(jax.grad(loss, argnums=(0, 1), has_aux=True),
                               jnp.array([1.0, 0.0]), jnp.array([0.9]))
    return g, events, ys


def _ball_loss(alg, **kw):
    def loss(u0, p):
        sol = P.solve(P.ODEProblem(_ball_port, u0, (0.0, 2.0), p), P.Tsit5(),
                      saveat=BALL_TS, callback=_bounce(P, torch.stack),
                      sensealg=alg, **TOLS, **kw)
        return torch.sum(sol.ys[:, 0] ** 2) + torch.sum(sol.ys[-1] ** 2)

    return loss


def test_bounce_event_record_matches_jax(ball_ref):
    """Three bounces: times (to 1e-10 relative, and the analytic ones),
    callback indices, pre-event states and save rows."""
    _, (ts_j, upre_j, idx_j, count_j), ys_j = ball_ref
    sol = P.solve(P.ODEProblem(_ball_port, torch.tensor([1.0, 0.0], dtype=DT),
                               (0.0, 2.0), torch.tensor([0.9], dtype=DT)),
                  P.Tsit5(), saveat=BALL_TS, callback=_bounce(P, torch.stack),
                  sensealg=P.GaussAdjoint(), **TOLS)
    ev = sol.events
    assert ev.count == int(count_j) == 3
    np.testing.assert_allclose(ev.ts.numpy(), np.asarray(ts_j), rtol=1e-10)
    t1 = np.sqrt(2 / G)
    np.testing.assert_allclose(
        ev.ts.numpy()[:3], [t1, t1 + 1.8 * t1, t1 + 1.8 * t1 + 1.62 * t1],
        rtol=1e-9)
    assert ev.idx.tolist() == np.asarray(idx_j).tolist()
    np.testing.assert_allclose(ev.u_pre.numpy()[:3], np.asarray(upre_j)[:3],
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(to_numpy(sol.ys), np.asarray(ys_j), rtol=1e-9,
                               atol=1e-12)
    assert sol.retcode == 0 and np.all(to_numpy(sol.ys)[:, 0] > -1e-8)


@pytest.mark.parametrize("rule", ALL_RULES)
def test_bounce_gradients_match_jax(ball_ref, rule):
    """Every rule, and sensealg=None (GaussAdjoint: n + p = 3 would pick
    ForwardDiffSensitivity, but not with callbacks), against JAX's
    GaussAdjoint: the ball is piecewise quadratic, so Tsit5 and the
    Hermite interpolant are exact and all rules agree to roundoff."""
    (gu_j, gp_j), _, _ = ball_ref
    gu, gp = _port_grad(_ball_loss(_alg(P, rule)), [1.0, 0.0], [0.9])
    _close(gu, gu_j, GRAD_RTOL, rule)
    _close(gp, gp_j, GRAD_RTOL, rule)


def test_event_record_overflow_poisons_gradient():
    """max_events=2 on three bounces: retcode 4 (EventRecordOverflow), and
    the continuous rules' gradient is NaN, as JAX poisons it."""
    u0 = torch.tensor([1.0, 0.0], dtype=DT, requires_grad=True)
    sol = P.solve(P.ODEProblem(_ball_port, u0, (0.0, 2.0),
                               torch.tensor([0.9], dtype=DT)), P.Tsit5(),
                  saveat=BALL_TS, callback=_bounce(P, torch.stack),
                  sensealg=P.GaussAdjoint(), max_events=2, **TOLS)
    assert sol.retcode == 4 and sol.events.count == 3
    sol.ys.sum().backward()
    assert torch.isnan(u0.grad).all()


# -- parameter-modifying events (lifted into the state) ---------------------

def _swap_cb(mod):
    return mod.ContinuousCallback(
        condition=lambda u, p, t: u[0] - 0.5,
        affect=lambda u, p, t: (u, p * 0.5), direction=-1, modifies_p=True)


SWAP_TS = np.linspace(0.0, 2.0, 5)


def _swap_loss(alg):
    def loss(p0):
        sol = P.solve(P.ODEProblem(lambda u, p, t: -p * u,
                                   torch.tensor([1.0], dtype=DT), (0.0, 2.0),
                                   p0), P.Tsit5(), saveat=SWAP_TS,
                      callback=_swap_cb(P), sensealg=alg, **TOLS)
        tstar = float(np.log(2.0) / 1.1)
        np.testing.assert_allclose(
            float(sol.ys[-1, 0]), 0.5 * np.exp(-0.55 * (2.0 - tstar)),
            rtol=1e-8)
        return torch.sum(sol.ys ** 2)

    return loss


@pytest.fixture(scope="module")
def swap_ref():
    """JAX's GaussAdjoint gradient, with p lifted into the state."""
    def loss(p0):
        sol = J.solve(J.ODEProblem(lambda u, p, t: -p * u, jnp.array([1.0]),
                                   (0.0, 2.0), p0), J.Tsit5(),
                      saveat=jnp.asarray(SWAP_TS), callback=_swap_cb(J),
                      sensealg=J.GaussAdjoint(), **TOLS)
        return jnp.sum(sol.ys ** 2)

    return np.asarray(jax_o0(jax.grad(loss), jnp.array([1.1])))


@pytest.mark.parametrize("rule", [
    "GaussAdjoint", "BacksolveAdjoint",
    "InterpolatingAdjoint(checkpointing=True)", "DirectAdjoint",
    "ForwardDiffSensitivity"])
def test_parameter_modifying_event(swap_ref, rule):
    """The decay rate halves when u crosses 0.5 (p lifted into the state):
    the analytic value after the swap, and the gradient against JAX's
    GaussAdjoint at 1e-8; the discrete rules, which differ from the
    continuous ones by the solver tolerance's order, are 3e-9 from it."""
    (g,) = _port_grad(_swap_loss(_alg(P, rule)), [1.1])
    _close(g, swap_ref, GRAD_RTOL, rule)


# -- simultaneous events ----------------------------------------------------

SIM_TS = np.array([0.0, 0.8, 1.2, 1.9])


def _sim_cbs(mod, mul, add):
    return mod.CallbackSet(continuous=(
        mod.ContinuousCallback(lambda u, p, t: u[0] - 1.0,
                               lambda u, p, t: u * mul, direction=1),
        mod.ContinuousCallback(lambda u, p, t: u[1] - 1.0,
                               lambda u, p, t: u + add, direction=1)))


@pytest.fixture(scope="module")
def sim_ref():
    """JAX's GaussAdjoint gradient through the two simultaneous events."""
    def loss(p):
        sol = J.solve(J.ODEProblem(lambda u, q, t: jnp.stack([q[0], q[0]]),
                                   jnp.zeros(2), (0.0, 1.9), p), J.Tsit5(),
                      saveat=jnp.asarray(SIM_TS),
                      callback=_sim_cbs(J, jnp.array([0.5, 1.0]),
                                        jnp.array([0.0, 0.3])),
                      sensealg=J.GaussAdjoint(), **TOLS)
        return jnp.sum(sol.ys ** 2)

    return np.asarray(jax_o0(jax.grad(loss), jnp.array([1.0])))


@pytest.mark.parametrize("rule", ["InterpolatingAdjoint", "GaussAdjoint",
                                  "QuadratureAdjoint", "DirectAdjoint",
                                  "ForwardDiffSensitivity"])
def test_two_simultaneous_events(sim_ref, rule):
    """Two conditions crossing at t = 1 in one step: both affects applied
    in callback order, both recorded, both reverse jumps composed; against
    JAX's GaussAdjoint (1e-8: the field is constant, so every rule is exact
    to roundoff)."""
    def run(p, alg):
        sol = P.solve(P.ODEProblem(lambda u, q, t: torch.stack([q[0], q[0]]),
                                   torch.zeros(2, dtype=DT), (0.0, 1.9), p),
                      P.Tsit5(), saveat=SIM_TS,
                      callback=_sim_cbs(P, torch.tensor([0.5, 1.0], dtype=DT),
                                        torch.tensor([0.0, 0.3], dtype=DT)),
                      sensealg=alg, **TOLS)
        ev = sol.events
        assert ev.count == 3 and ev.idx.tolist()[:3] == [0, 1, 0]
        np.testing.assert_allclose(ev.ts.numpy()[:2], [1.0, 1.0], rtol=1e-10)
        np.testing.assert_allclose(to_numpy(sol.ys[-1]), [0.9, 2.2],
                                   rtol=1e-8)
        return torch.sum(sol.ys ** 2)

    (g,) = _port_grad(lambda p: run(p, _alg(P, rule)), [1.0])
    _close(g, sim_ref, GRAD_RTOL, rule)


# -- VectorContinuousCallback -----------------------------------------------

VEC_TS = np.linspace(0.0, 2.0, 7)
VEC_W = np.arange(1.0, 15.0).reshape(7, 2)


def _vec_field(u, p, t):
    return torch.stack([u[1], -p[0] * u[0]])


def _vec_loss(cb, alg):
    def loss(q):
        sol = P.solve(P.ODEProblem(_vec_field, torch.tensor([1.0, 0.0],
                                                            dtype=DT),
                                   (0.0, 2.0), q), callback=cb, sensealg=alg,
                      saveat=VEC_TS, max_events=64, **TOLS)
        assert sol.events.count >= 2
        return torch.sum(sol.ys * torch.tensor(VEC_W, dtype=DT))

    return loss


def _vec_callbacks(mod, stack, where):
    """A 2-component vector callback and the equivalent scalar pair. The
    second component's affect pushes past its threshold (u ← 1.05u), where
    the JAX test's u ← 0.97u chatters 27 times at rtol 1e-10, seconds of
    bisection that this file cannot spend."""
    vcb = mod.VectorContinuousCallback(
        lambda u, p, t: stack([u[0] - 0.4, u[0] + 0.4]),
        lambda u, p, t, idx: where(idx == 0, u * p[1], u * 1.05), len=2)
    scb = [mod.ContinuousCallback(lambda u, p, t: u[0] - 0.4,
                                  lambda u, p, t: u * p[1]),
           mod.ContinuousCallback(lambda u, p, t: u[0] + 0.4,
                                  lambda u, p, t: u * 1.05)]
    return vcb, scb


@pytest.fixture(scope="module")
def vec_ref():
    """JAX's GaussAdjoint gradient through the vector callback, its save
    rows and its event count."""
    def loss(q):
        sol = J.solve(J.ODEProblem(
            lambda u, p, t: jnp.stack([u[1], -p[0] * u[0]]),
            jnp.array([1.0, 0.0]), (0.0, 2.0), q),
            callback=_vec_callbacks(J, jnp.stack, jnp.where)[0],
            sensealg=J.GaussAdjoint(), saveat=jnp.asarray(VEC_TS),
            max_events=64, **TOLS)
        return jnp.sum(sol.ys * jnp.asarray(VEC_W)), (sol.ys, sol.events[3])

    g, (ys, count) = jax_o0(jax.grad(loss, has_aux=True),
                            jnp.array([4.0, 0.9]))
    return np.asarray(g), np.asarray(ys), int(count)


def test_vector_callback_matches_scalar_composition(vec_ref):
    """The vector callback's event count, save rows and GaussAdjoint
    gradient against JAX's (1e-8), and its save rows against the scalar
    pair's: each component is its own tracked event."""
    g_j, ys_j, count_j = vec_ref
    vcb, scb = _vec_callbacks(P, torch.stack,
                              lambda c, a, b: a if c else b)
    g_v = _port_grad(_vec_loss(vcb, P.GaussAdjoint()), [4.0, 0.9])[0]
    _close(g_v, g_j, GRAD_RTOL)
    q0 = torch.tensor([4.0, 0.9], dtype=DT)
    u0 = torch.tensor([1.0, 0.0], dtype=DT)
    kw = dict(saveat=VEC_TS, max_events=64, **TOLS)
    sv = P.solve(P.ODEProblem(_vec_field, u0, (0.0, 2.0), q0), callback=vcb,
                 **kw)
    ss = P.solve(P.ODEProblem(_vec_field, u0, (0.0, 2.0), q0), callback=scb,
                 **kw)
    assert sv.events.count == count_j
    np.testing.assert_allclose(to_numpy(sv.ys), ys_j, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(to_numpy(sv.ys), to_numpy(ss.ys), rtol=1e-9)


# -- PresetTimeCallback / PeriodicCallback (dosing) --------------------------

DOSE_P = np.array([1.3, 0.5])


def _dose_exact():
    a, d = DOSE_P
    u05 = (np.exp(-0.3 * a) + d) * np.exp(-0.2 * a)
    u1 = ((np.exp(-0.3 * a) + d) * np.exp(-0.45 * a) + d) * np.exp(-0.25 * a)
    du05_da = (-0.3 * np.exp(-0.3 * a)) * np.exp(-0.2 * a) \
        + (np.exp(-0.3 * a) + d) * (-0.2) * np.exp(-0.2 * a)
    t1 = (-0.3 * np.exp(-0.3 * a)) * np.exp(-0.45 * a) \
        + (np.exp(-0.3 * a) + d) * (-0.45) * np.exp(-0.45 * a)
    du1_da = t1 * np.exp(-0.25 * a) + ((np.exp(-0.3 * a) + d)
                                       * np.exp(-0.45 * a) + d) \
        * (-0.25) * np.exp(-0.25 * a)
    du05_dd = np.exp(-0.2 * a)
    du1_dd = np.exp(-0.45 * a) * np.exp(-0.25 * a) + np.exp(-0.25 * a)
    return np.array([2 * u05 * du05_da + 2 * u1 * du1_da,
                     2 * u05 * du05_dd + 2 * u1 * du1_dd])


@pytest.mark.parametrize("rule", ["ForwardDiffSensitivity"] + FEW_RULES)
def test_preset_time_dosing_gradients(rule):
    """Doses at 0.3 and 0.75: every rule's gradient against the analytic
    one of the dosed decay (1e-6, the JAX test's bound), the record against
    the preset times."""
    cb = P.PresetTimeCallback([0.3, 0.75], lambda u, p, t: u + p[1])

    def loss(q):
        sol = P.solve(P.ODEProblem(lambda u, p, t: -p[0] * u,
                                   torch.tensor([1.0], dtype=DT), (0.0, 1.0),
                                   q), P.Tsit5(), saveat=np.array([0.5, 1.0]),
                      callback=cb, sensealg=_alg(P, rule), **TOLS)
        assert sol.events.count == 2
        np.testing.assert_allclose(sol.events.ts.numpy()[:2], [0.3, 0.75],
                                   rtol=1e-12)
        return torch.sum(sol.ys ** 2)

    (g,) = _port_grad(loss, DOSE_P)
    np.testing.assert_allclose(g, _dose_exact(), rtol=1e-6)


def test_periodic_callback_equals_preset_times():
    dose = lambda u, p, t: u + p[1]
    prob = P.ODEProblem(lambda u, p, t: -p[0] * u,
                        torch.tensor([1.0], dtype=DT), (0.0, 1.0),
                        torch.tensor(DOSE_P, dtype=DT))
    kw = dict(saveat=np.array([0.6, 1.0]), **TOLS)
    s1 = P.solve(prob, P.Tsit5(), callback=P.PeriodicCallback(dose, 0.25),
                 **kw)
    s2 = P.solve(prob, P.Tsit5(), callback=P.PresetTimeCallback(
        [0.25, 0.5, 0.75, 1.0], dose), **kw)
    assert s1.events.count == 4
    np.testing.assert_allclose(to_numpy(s1.ys), to_numpy(s2.ys), rtol=1e-10)


def test_preset_time_float32_short_span_divergence():
    """A dose at 24 ns on a 64 ns float32 solve (the flagship PDE's span):
    JAX's lowered condition takes a step end within 64 eps·max(1, |t|) =
    7.6e-6 of the dose time, about 100 spans, so it doses at every step
    end; the port matches within `match_tol`, relative to the span, and
    doses once (ROADMAP §3)."""
    span, t_dose = 64e-9, 24e-9

    def run(mod, arr, dtype):
        prob = mod.ODEProblem(lambda u, p, t: -p * u, arr([1.0], dtype),
                              (0.0, span), arr(2e7, dtype))
        return mod.solve(prob, mod.Tsit5(), rtol=1e-4, atol=1e-7,
                         dt0=1e-9, callback=mod.PresetTimeCallback(
                             [t_dose], lambda u, p, t: 0.5 * u))

    count_j = jax_o0(lambda: run(J, lambda x, d: jnp.asarray(x, d),
                                 jnp.float32).events[3])
    sol_p = run(P, lambda x, d: torch.tensor(x, dtype=d), torch.float32)
    assert int(count_j) > 1          # JAX doses at every step end
    assert sol_p.events.count == 1
    assert abs(float(sol_p.events.ts[0]) - t_dose) <= 1e-15
    np.testing.assert_allclose(float(sol_p.ys[-1, 0]),
                               0.5 * np.exp(-2e7 * span), rtol=1e-4)


# -- terminal events --------------------------------------------------------

def _fall(u, p, t):
    return torch.stack([u[1], -p[0] + 0.0 * u[0]])


FALL_CB = P.ContinuousCallback(lambda u, p, t: u[0], lambda u, p, t: u,
                               direction=-1, terminal=True)


@pytest.mark.parametrize("rule", ["DirectAdjoint", "ForwardDiffSensitivity",
                                  "GaussAdjoint", "InterpolatingAdjoint",
                                  "BacksolveAdjoint", "QuadratureAdjoint"])
def test_terminal_event_time_to_event_gradient(rule):
    """Falling body stopped at height 0: retcode 5, the save row past τ
    holds the terminal state, and dτ/dg = -τ/(2g) through the held
    velocity row (1e-9, the JAX test's bound); dτ/du0 too for two rules."""
    tau = float(np.sqrt(2.0 / 3.0))

    def loss(g):
        sol = P.solve(P.ODEProblem(_fall, torch.tensor([1.0, 0.0], dtype=DT),
                                   (0.0, 2.0), g), P.Tsit5(),
                      saveat=np.array([0.0, 2.0]), callback=FALL_CB,
                      sensealg=_alg(P, rule), **TOLS)
        assert sol.retcode == 5 and sol.success
        np.testing.assert_allclose(float(sol.ys[1, 0]), 0.0, atol=1e-8)
        np.testing.assert_allclose(float(sol.t_final), tau, rtol=1e-10)
        return -sol.ys[-1, 1] / g[0]

    (g,) = _port_grad(loss, [3.0])
    np.testing.assert_allclose(g[0], -tau / 6.0, rtol=1e-9)
    if rule in ("GaussAdjoint", "InterpolatingAdjoint"):
        def loss_u(u0):
            sol = P.solve(P.ODEProblem(_fall, u0, (0.0, 2.0),
                                       torch.tensor([3.0], dtype=DT)),
                          P.Tsit5(), saveat=np.array([0.0, 2.0]),
                          callback=FALL_CB, sensealg=_alg(P, rule), **TOLS)
            return -sol.ys[-1, 1] / 3.0

        (gu,) = _port_grad(loss_u, [1.0, 0.0])
        np.testing.assert_allclose(gu[0], 1.0 / (3.0 * tau), rtol=1e-9)


TERM_TS = np.linspace(0.0, 5.0, 6)


def _term_cb(mod):
    return mod.DiscreteCallback(lambda u, p, t: u[0] < 0.5,
                                lambda u, p, t: u, terminal=True)


@pytest.fixture(scope="module")
def term_ref():
    """JAX's GaussAdjoint(checkpointing=True) gradient through a terminal
    discrete stop."""
    def loss(q):
        sol = J.solve(J.ODEProblem(lambda u, p, t: -p * u, jnp.array([1.0]),
                                   (0.0, 5.0), q), J.Tsit5(),
                      saveat=jnp.asarray(TERM_TS), callback=_term_cb(J),
                      sensealg=J.GaussAdjoint(checkpointing=True), **TOLS)
        return jnp.sum(jnp.arange(1.0, 7.0) * sol.ys[:, 0])

    return np.asarray(jax_o0(jax.grad(loss), jnp.array([1.0])))


@pytest.mark.parametrize("rule", ["InterpolatingAdjoint(checkpointing=True)",
                                  "GaussAdjoint(checkpointing=True)",
                                  "ForwardDiffSensitivity"])
def test_terminal_discrete_checkpointed_adjoints(term_ref, rule):
    """A terminal discrete stop: the checkpointed reverse freezes the
    intervals past t_final and clamps the boundary one; against JAX's
    GaussAdjoint(checkpointing=True) at 1e-8, ForwardDiffSensitivity (the
    JAX test's oracle) too: it is 9e-10 from it. sensealg=None with a
    terminal callback picks DirectAdjoint."""
    def loss(q):
        sol = P.solve(P.ODEProblem(lambda u, p, t: -p * u,
                                   torch.tensor([1.0], dtype=DT), (0.0, 5.0),
                                   q), P.Tsit5(), saveat=TERM_TS,
                      callback=_term_cb(P), sensealg=_alg(P, rule), **TOLS)
        return torch.sum(torch.arange(1.0, 7.0, dtype=DT) * sol.ys[:, 0])

    (g,) = _port_grad(loss, [1.0])
    assert abs(term_ref[0]) > 1e-8
    _close(g, term_ref, GRAD_RTOL, rule)
    sol = P.solve(P.ODEProblem(lambda u, p, t: -p * u,
                               torch.tensor([1.0], dtype=DT), (0.0, 5.0),
                               torch.tensor([1.0], dtype=DT)), P.Tsit5(),
                  callback=_term_cb(P), **TOLS)
    assert sol.retcode == 5 and isinstance(sol.sensealg, P.DirectAdjoint)


HELD_TS = np.linspace(0.0, 3.0, 9)
HELD_W = np.arange(1.0, 19.0).reshape(9, 2)


def _held_cbs(mod, stack):
    return [
        mod.ContinuousCallback(lambda u, p, t: u[1] + 0.3,
                               lambda u, p, t: stack([u[0] * p[1],
                                                      u[1] - 0.1]),
                               direction=-1),
        mod.ContinuousCallback(lambda u, p, t: u[0] + 0.55,
                               lambda u, p, t: u * 0.9, direction=-1,
                               terminal=True)]


@pytest.fixture(scope="module")
def held_ref():
    def loss(q):
        sol = J.solve(J.ODEProblem(
            lambda u, p, t: jnp.array([p[0] * u[1], -p[0] * u[0]]),
            jnp.array([1.0, 0.0]), (0.0, 3.0), q), J.Tsit5(),
            saveat=jnp.asarray(HELD_TS), callback=_held_cbs(J, jnp.stack),
            sensealg=J.GaussAdjoint(), max_events=64, **TOLS)
        return jnp.sum(jnp.asarray(HELD_W) * sol.ys)

    return np.asarray(jax_o0(jax.grad(loss), jnp.array([2.0, 0.95])))


@pytest.mark.parametrize("rule", ["GaussAdjoint", "DirectAdjoint",
                                  "ForwardDiffSensitivity"])
def test_terminal_event_held_rows_and_prior_events_match_jax(held_ref, rule):
    """A non-terminal event, then a terminal one: held save rows and prior
    event composition. The continuous rules against JAX's GaussAdjoint at
    1e-8; the discrete ones (DirectAdjoint and ForwardDiffSensitivity,
    which match JAX's own to 5e-14) differ from the continuous value by
    4e-7 here, as JAX's do: rtol 1e-6 for them."""
    def loss(q):
        sol = P.solve(P.ODEProblem(
            lambda u, p, t: torch.stack([p[0] * u[1], -p[0] * u[0]]),
            torch.tensor([1.0, 0.0], dtype=DT), (0.0, 3.0), q), P.Tsit5(),
            saveat=HELD_TS, callback=_held_cbs(P, torch.stack),
            sensealg=_alg(P, rule), max_events=64, **TOLS)
        assert sol.retcode == 5 and sol.events.count >= 2
        return torch.sum(torch.tensor(HELD_W, dtype=DT) * sol.ys)

    (g,) = _port_grad(loss, [2.0, 0.95])
    discrete = rule in ("ForwardDiffSensitivity", "DirectAdjoint")
    _close(g, held_ref, 1e-6 if discrete else GRAD_RTOL, rule)


@pytest.fixture(scope="module")
def steady_ref():
    """JAX's DirectAdjoint gradient through TerminateSteadyState."""
    def loss(q):
        sol = J.solve(J.ODEProblem(lambda u, p, t: -(u - p), jnp.zeros(2),
                                   (0.0, 100.0), q), J.Tsit5(),
                      saveat=jnp.array([0.0, 100.0]),
                      callback=J.TerminateSteadyState(abstol=1e-10,
                                                      reltol=0.0),
                      sensealg=J.DirectAdjoint(), **TOLS)
        return jnp.sum(jnp.array([1.0, 2.0]) * sol.ys[-1])

    return np.asarray(jax_o0(jax.grad(loss), jnp.array([2.0, -1.0])))


def test_terminate_steady_state(steady_ref):
    """TerminateSteadyState stops at the settled state; DirectAdjoint and
    ForwardDiffSensitivity against JAX's DirectAdjoint (1e-8), and
    du*/dp = I."""
    cb = P.TerminateSteadyState(abstol=1e-10, reltol=0.0)

    def loss(q, alg):
        sol = P.solve(P.ODEProblem(lambda u, p, t: -(u - p),
                                   torch.zeros(2, dtype=DT), (0.0, 100.0), q),
                      P.Tsit5(), saveat=np.array([0.0, 100.0]), callback=cb,
                      sensealg=alg, **TOLS)
        assert sol.retcode == 5 and sol.success
        np.testing.assert_allclose(to_numpy(sol.ys[-1]), [2.0, -1.0],
                                   rtol=1e-8)
        return torch.sum(torch.tensor([1.0, 2.0], dtype=DT) * sol.ys[-1])

    for alg in (P.DirectAdjoint(), P.ForwardDiffSensitivity()):
        (g,) = _port_grad(lambda q: loss(q, alg), [2.0, -1.0])
        _close(g, steady_ref, GRAD_RTOL, repr(alg))
    np.testing.assert_allclose(g, [1.0, 2.0], rtol=1e-6)


@pytest.mark.parametrize("rule", ["InterpolatingAdjoint",
                                  "ForwardDiffSensitivity"] + FEW_RULES)
def test_event_exactly_at_t1_reverse_jump_applied(rule):
    """A dose at the final time: every rule applies its reverse jump (the
    start-of-reverse consumption), so d u(1)/dp = -0.5·e^-1.3."""
    cb = P.PresetTimeCallback([1.0], lambda u, p, t: u * 0.5)

    def loss(q):
        sol = P.solve(P.ODEProblem(lambda u, p, t: -p * u,
                                   torch.tensor([1.0], dtype=DT), (0.0, 1.0),
                                   q), P.Tsit5(), saveat=np.array([1.0]),
                      callback=cb, sensealg=_alg(P, rule), **TOLS)
        return sol.ys[-1, 0]

    (g,) = _port_grad(loss, [1.3])
    np.testing.assert_allclose(g[0], -0.5 * np.exp(-1.3), rtol=1e-7)


def test_terminal_preset_time_and_discrete_callback():
    """A terminal dose stops at the first preset time; a discrete impulse
    on t > 0.5 fires at every step end past it."""
    sol = P.solve(P.ODEProblem(lambda u, p, t: -p * u,
                               torch.tensor([1.0], dtype=DT), (0.0, 1.0),
                               torch.tensor([1.0], dtype=DT)), P.Tsit5(),
                  saveat=np.array([0.0, 1.0]), callback=P.PresetTimeCallback(
                      [0.4], lambda u, p, t: u * 0.5, terminal=True), **TOLS)
    assert sol.retcode == 5
    np.testing.assert_allclose(float(sol.ys[-1, 0]), 0.5 * np.exp(-0.4),
                               rtol=1e-8)
    cb = P.DiscreteCallback(
        condition=lambda u, p, t: t > 0.5,
        affect=lambda u, p, t: u + torch.tensor([0.0, 1.0], dtype=DT))
    sol = P.solve(P.ODEProblem(lambda u, p, t: torch.stack([u[1], 0 * u[0]]),
                               torch.tensor([0.0, 1.0], dtype=DT), (0.0, 1.0),
                               None), P.Tsit5(), callback=cb,
                  sensealg=P.GaussAdjoint(), **TOLS)
    assert float(sol.ys[-1, 1]) >= 2.0 - 1e-8


def test_events_with_vjp_backends(ball_ref):
    """JacVJP and FiniteDiffVJP reverse passes through the ball's bounces
    against JAX's GaussAdjoint at 1e-8: the ball's field is linear, so
    central differences are exact but for roundoff (2e-10 here; the JAX
    test allows 1e-3 on a general field)."""
    (gu_j, gp_j), _, _ = ball_ref
    for alg in [P.setvjp(P.InterpolatingAdjoint(), P.JacVJP()),
                P.setvjp(P.GaussAdjoint(), P.FiniteDiffVJP())]:
        gu, gp = _port_grad(_ball_loss(alg), [1.0, 0.0], [0.9])
        _close(gu, gu_j, GRAD_RTOL, repr(alg))
        _close(gp, gp_j, GRAD_RTOL, repr(alg))


# -- a kernel field: the fused MLP (K3/K4's plain versions on the CPU) -------

MLP_TS = np.linspace(0.0, 0.5, 6)


def _mlp_params(seed=3):
    g = np.random.default_rng(seed)
    out = {}
    for i, (m, n) in enumerate([(2, 16), (16, 2)]):
        out[f"W{i}"] = g.standard_normal((m, n)) * np.sqrt(2.0 / (m + n))
        out[f"b{i}"] = 0.1 * g.standard_normal(n)
    return out


def _mlp_cb(mod, c=5.0):
    return mod.ContinuousCallback(lambda u, p, t: u[0] ** 2 + u[1] ** 2 - c,
                                  lambda u, p, t: 0.8 * u)


def test_kernel_field_continuous_event_matches_jax():
    """The spiral's MLP field u ↦ fused_mlp2(p, u³) with the event
    ‖u‖² = 5 (affect u ← 0.8u; ‖u‖² grows from 4 to 8.7 on the span) under GaussAdjoint: JAX's fused_mlp2 runs
    in interpret mode, the port's plain K3/K4. The event's jump calls the
    field for f⁻ and f⁺ only, so no forward mode reaches the kernel;
    ForwardDiffSensitivity, which needs it, refuses. rtol 1e-6: at 1e-8
    the first steps' embedded error is at roundoff level, and the MLP's
    summation order (the port's matmul against XLA's dot) moves the grid."""
    params = _mlp_params()
    u0 = np.array([2.0, 0.0])

    def jloss(p):
        sol = J.solve(J.ODEProblem(lambda u, q, t: jax_fused(q, u ** 3),
                                   jnp.asarray(u0), (0.0, 0.5), p), J.Tsit5(),
                      saveat=jnp.asarray(MLP_TS), callback=_mlp_cb(J),
                      sensealg=J.GaussAdjoint(), rtol=1e-6, atol=1e-8)
        return jnp.sum(sol.ys ** 2), sol.events[3]

    g_j, count_j = jax_o0(jax.grad(jloss, has_aux=True),
                          {k: jnp.asarray(v) for k, v in params.items()})
    pp = {k: torch.tensor(v, dtype=DT).requires_grad_()
          for k, v in params.items()}
    prob = P.ODEProblem(lambda u, q, t: port_fused(q, u ** 3),
                        torch.tensor(u0, dtype=DT), (0.0, 0.5), pp)
    sol = P.solve(prob, P.Tsit5(), saveat=MLP_TS, callback=_mlp_cb(P),
                  sensealg=P.GaussAdjoint(), rtol=1e-6, atol=1e-8)
    assert sol.events.count == int(count_j) >= 1
    torch.sum(sol.ys ** 2).backward()
    for k in params:
        _close(pp[k].grad.numpy(), g_j[k], GRAD_RTOL, k)
    with pytest.raises(ForwardModeUnsupported):
        sol = P.solve(prob, P.Tsit5(), saveat=MLP_TS, callback=_mlp_cb(P),
                      sensealg=P.ForwardDiffSensitivity(), rtol=1e-6,
                      atol=1e-8)
        torch.sum(sol.ys ** 2).backward()


# -- refusals ---------------------------------------------------------------

def test_callback_closing_over_a_grad_tensor_raises():
    """A continuous rule's Function differentiates u0 and p only: an
    affect closing over a tensor with requires_grad is refused, as JAX
    refuses closure-captured tracers; DirectAdjoint takes it."""
    coef = torch.tensor(0.9, dtype=DT, requires_grad=True)
    cb = P.ContinuousCallback(
        lambda u, p, t: u[0],
        lambda u, p, t: torch.stack([u[0], -coef * u[1]]), direction=-1)
    prob = P.ODEProblem(_ball_port, torch.tensor([1.0, 0.0], dtype=DT),
                        (0.0, 1.2), torch.tensor([0.9], dtype=DT))
    with pytest.raises(ValueError, match="requires_grad"):
        P.solve(prob, P.Tsit5(), callback=cb, sensealg=P.GaussAdjoint(),
                **TOLS)
    sol = P.solve(prob, P.Tsit5(), callback=cb, sensealg=P.DirectAdjoint(),
                  **TOLS)
    sol.ys[-1, 1].backward()
    assert coef.grad is not None and coef.grad != 0


@pytest.mark.parametrize("case", ["forward_sensitivity", "pinned",
                                  "fixed_grid", "fixed_grid_continuous"])
def test_callback_refusals(case):
    """What the JAX package refuses with callbacks, the port refuses."""
    prob = P.ODEProblem(_ball_port, torch.tensor([1.0, 0.0], dtype=DT),
                        (0.0, 1.2), torch.tensor([0.9], dtype=DT))
    cb = _bounce(P, torch.stack)
    kw = {"forward_sensitivity": dict(sensealg=P.ForwardSensitivity()),
          "pinned": dict(sensealg=P.GaussAdjoint(pinned_reverse=True)),
          "fixed_grid": dict(adaptive=False, dt=0.1),
          "fixed_grid_continuous": dict(adaptive=False, dt=0.1,
                                        sensealg=P.GaussAdjoint())}[case]
    p = prob.p.clone().requires_grad_()
    with pytest.raises(NotImplementedError):
        sol = P.solve(P.remake(prob, p=p), P.Tsit5(), callback=cb, **kw)
        sol.ys.sum().backward()


# -- F1: a field that reads t, through an event (ROADMAP §3) -----------------

def _forced_event(mod, sin, as_t, forced):
    """u' = −a·u + 2 sin(3t) with ContinuousCallback(u − 1.5, u ← 0.5u)
    (F1's event case), or the autonomous control u' = −a·u + 1 with the
    event at u = 1.35."""
    if forced:
        f = lambda u, p, t: -p[0] * u + 2 * sin(3 * as_t(t, u))
        level = 1.5
    else:
        f = lambda u, p, t: -p[0] * u + 1.0
        level = 1.35
    cb = mod.ContinuousCallback(lambda u, p, t: u[0] - level,
                                lambda u, p, t: 0.5 * u)
    return f, cb


F1_SV = [0.3, 0.6, 1.0]
F1_TQ = 0.8


@pytest.fixture(scope="module")
def forced_event_ref():
    """JAX DirectAdjoint's dL/da and dL/du0 of Σ ys² + sol(0.8)² (the dense
    query after the event), per field."""
    out = {}
    for forced in (True, False):
        def loss(a, u0, forced=forced):
            f, cb = _forced_event(J, jnp.sin, lambda t, u: t, forced)
            sol = J.solve(J.ODEProblem(f, u0, (0.0, 1.0), a),
                          saveat=jnp.asarray(F1_SV), callback=cb, dense=True,
                          sensealg=J.DirectAdjoint(), max_steps=256, **TOLS)
            return jnp.sum(sol.ys ** 2) + jnp.sum(sol(F1_TQ)) ** 2

        out[forced] = [np.asarray(g) for g in jax_o0(
            jax.grad(loss, argnums=(0, 1)), jnp.array([0.7]),
            jnp.array([1.3]))]
    return out


@pytest.mark.parametrize("forced", [True, False],
                         ids=["forced", "autonomous"])
@pytest.mark.parametrize("rule", ["DirectAdjoint", "ForwardDiffSensitivity"])
def test_time_dependent_field_event_gradient_matches_jax(forced_event_ref,
                                                         rule, forced):
    """F1: the event time's derivative reaches a field that reads t (the
    stage times after the event, the slopes at the event time), and the
    dense query after the event sees it too; against JAX's DirectAdjoint
    at 1e-8. Without the dense term JAX gives dL/da = −4.683654 and
    dL/du0 = 5.443729 on the forced field, where the port gave −4.590260
    and 5.335407 before the repair. The autonomous field is the control."""
    def loss(a, u0):
        f, cb = _forced_event(
            P, torch.sin, lambda t, u: torch.as_tensor(t, dtype=u.dtype),
            forced)
        sol = P.solve(P.ODEProblem(f, u0, (0.0, 1.0), a), saveat=F1_SV,
                      callback=cb, dense=True, sensealg=_alg(P, rule),
                      max_steps=256, **TOLS)
        assert sol.events.count == 1
        return torch.sum(sol.ys ** 2) + torch.sum(sol(F1_TQ)) ** 2

    got = _port_grad(loss, [0.7], [1.3])
    for g, r, name in zip(got, forced_event_ref[forced], ("a", "u0")):
        _close(g, r, GRAD_RTOL, name)
    if forced:
        # the JAX figures of ROADMAP §3, without the dense query
        f, cb = _forced_event(
            P, torch.sin, lambda t, u: torch.as_tensor(t, dtype=u.dtype),
            True)
        a = torch.tensor([0.7], dtype=DT, requires_grad=True)
        u0 = torch.tensor([1.3], dtype=DT, requires_grad=True)
        sol = P.solve(P.ODEProblem(f, u0, (0.0, 1.0), a), saveat=F1_SV,
                      callback=cb, sensealg=_alg(P, rule), max_steps=256,
                      **TOLS)
        g = torch.autograd.grad(torch.sum(sol.ys ** 2), (a, u0))
        np.testing.assert_allclose([float(g[0]), float(g[1])],
                                   [-4.683654, 5.443729], rtol=1e-6)
