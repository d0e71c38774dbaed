"""Parity of the port's gradients through dense output sol(t), sol.u_final
and the save times with the JAX package's, in float64 on the CPU: the
cases of tests/test_dense_grad.py as parametrised cases over the rules.

The JAX reference, compiled at XLA optimization level 0
(`torch_parity.jax_o0`, so both packages take the same steps), is the
decay u' = -a·u under GaussAdjoint with a dense query and a traced
saveat; gradients are held to it to 1e-8 relative (the rules differ from
each other by ~1e-9 there, so one reference serves them all). The other
cases hold the port to the oracles of the JAX tests (closed forms, finite
differences), at their tolerances, but sol(t) through events under the
discrete rules, which has a JAX reference of its own (DirectAdjoint on the
bouncing ball and on a dosed decay). A test of the saveat gradient fails on a port that drops it
(the saveat tensor then gets no gradient at all).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import jax_o0, lotka_volterra_port

import scimlsensitivity_jl_tpu as J
import scimlsensitivity_jl_tpu_torch as P

DT = torch.float64
TOLS = dict(rtol=1e-10, atol=1e-12)
TQ = 0.37
SV = np.array([0.2, 0.5, 0.9])
GRAD_RTOL = 1e-8


def _alg(mod, name):
    if "(" in name:
        return getattr(mod, name.split("(")[0])(checkpointing=True)
    return getattr(mod, name)()


def _decay_jax(u, p, t):
    return -p["a"] * u


def _decay_port(u, p, t):
    return -p["a"] * u


def _decay_prob(a, u0=None):
    u0 = torch.tensor([1.3], dtype=DT) if u0 is None else u0
    return P.ODEProblem(_decay_port, u0, (0.0, 1.0), {"a": a})


@pytest.fixture(scope="module")
def decay_ref():
    """JAX's GaussAdjoint gradient of sol(TQ)² summed plus Σ sol.ys, with
    respect to a and the (traced) save times."""
    def loss(a, sv):
        sol = J.solve(J.ODEProblem(_decay_jax, jnp.array([1.3]), (0.0, 1.0),
                                   {"a": a}), saveat=sv, dense=True,
                      sensealg=J.GaussAdjoint(), **TOLS)
        return jnp.sum(sol(TQ)) ** 2 + jnp.sum(sol.ys)

    ga, gs = jax_o0(jax.grad(loss, argnums=(0, 1)), jnp.asarray(0.7),
                    jnp.asarray(SV))
    return float(ga), np.asarray(gs)


@pytest.mark.parametrize("rule", [
    "GaussAdjoint", "InterpolatingAdjoint", "QuadratureAdjoint",
    "BacksolveAdjoint(checkpointing=True)", "ForwardDiffSensitivity",
    "DirectAdjoint"])
def test_dense_and_saveat_gradients_match_jax(decay_ref, rule):
    """sol(t) and the save times at once: each node a query touched is a λ
    jump (its state's and slope's cotangents), dL/dtᵢ = Δᵢ·f(u(tᵢ)) (the
    discrete derivative under DirectAdjoint); against JAX (1e-8) and the
    closed form (1e-6, the JAX tests' bound). DirectAdjoint's first save
    time also moves the nodes of the interval that sol(TQ) reads, a
    discrete term of the interpolation error's order (7e-8) that the
    continuous reference lacks: rtol 1e-7 for its save times."""
    ga_j, gs_j = decay_ref
    a = torch.tensor(0.7, dtype=DT, requires_grad=True)
    sv = torch.tensor(SV, dtype=DT, requires_grad=True)
    sol = P.solve(_decay_prob(a), saveat=sv, dense=True,
                  sensealg=_alg(P, rule), **TOLS)
    (torch.sum(sol(TQ)) ** 2 + torch.sum(sol.ys)).backward()
    np.testing.assert_allclose(float(a.grad), ga_j, rtol=GRAD_RTOL)
    np.testing.assert_allclose(sv.grad.numpy(), gs_j, rtol=(
        1e-7 if rule == "DirectAdjoint" else GRAD_RTOL))
    exact_a = (-2 * TQ * (1.3 * math.exp(-0.7 * TQ)) ** 2
               + sum(-t * 1.3 * math.exp(-0.7 * t) for t in SV))
    assert abs(float(a.grad) - exact_a) < 1e-6
    np.testing.assert_allclose(sv.grad.numpy(),
                               -0.7 * 1.3 * np.exp(-0.7 * SV), rtol=1e-7)


@pytest.mark.parametrize("rule", ["GaussAdjoint", "ForwardDiffSensitivity",
                                  "QuadratureAdjoint", "DirectAdjoint",
                                  "InterpolatingAdjoint(checkpointing=True)"])
def test_grad_wrt_saveat(rule):
    """dL/dtᵢ = -a·u0·e^{-a tᵢ} for L = Σ sol.ys (the JAX test's case, 1e-7),
    and sol.ts keeps the caller's times."""
    sv = torch.tensor(SV, dtype=DT, requires_grad=True)
    sol = P.solve(_decay_prob(torch.tensor(0.7, dtype=DT)), saveat=sv,
                  sensealg=_alg(P, rule), **TOLS)
    np.testing.assert_array_equal(sol.ts.numpy(), SV)
    sol.ys.sum().backward()
    assert sv.grad is not None
    np.testing.assert_allclose(sv.grad.numpy(),
                               -0.7 * 1.3 * np.exp(-0.7 * SV), atol=1e-7)


def test_saveat_gradient_past_a_terminal_stop_is_zero():
    """A falling body stopped at height 0 (τ ≈ 0.816): the save row at 2.0
    holds the terminal state whatever its time, so its time gets 0; the
    row at 0.5 gets Δ·f."""
    cb = P.ContinuousCallback(lambda u, p, t: u[0], lambda u, p, t: u,
                              direction=-1, terminal=True)
    sv = torch.tensor([0.0, 0.5, 2.0], dtype=DT, requires_grad=True)
    sol = P.solve(P.ODEProblem(lambda u, p, t: torch.stack([u[1],
                                                            -p[0] + 0 * u[0]]),
                               torch.tensor([1.0, 0.0], dtype=DT), (0.0, 2.0),
                               torch.tensor([3.0], dtype=DT)), saveat=sv,
                  callback=cb, sensealg=P.GaussAdjoint(), **TOLS)
    assert sol.retcode == 5
    sol.ys[:, 0].sum().backward()
    np.testing.assert_allclose(sv.grad.numpy(), [0.0, -1.5, 0.0], atol=1e-9)


@pytest.mark.parametrize("rule", ["GaussAdjoint", "ForwardDiffSensitivity",
                                  "BacksolveAdjoint", "InterpolatingAdjoint"])
def test_grad_through_u_final(rule):
    a = torch.tensor(0.7, dtype=DT, requires_grad=True)
    sol = P.solve(_decay_prob(a), sensealg=_alg(P, rule), rtol=1e-9,
                  atol=1e-11)
    (torch.sum(sol.u_final) ** 2).backward()
    assert abs(float(a.grad) + 2 * (1.3 * math.exp(-0.7)) ** 2) < 1e-6


def test_dense_many_query_times_mixed_consumers_and_u0():
    """sol(ts) at three times with a sol.ys term, sol(t) with sol.ys and
    sol.u_final, and d sol(TQ)/du0 (the JAX tests' closed forms)."""
    a = torch.tensor(0.7, dtype=DT, requires_grad=True)
    u0 = torch.tensor([1.3], dtype=DT, requires_grad=True)
    sol = P.solve(_decay_prob(a, u0), saveat=np.array([0.0, 0.6, 1.0]),
                  sensealg=P.GaussAdjoint(), dense=True, **TOLS)
    tq = [0.11, 0.43, 0.77]
    loss = (torch.sum(sol(tq) ** 2) + torch.sum(sol.ys[1])
            + torch.sum(sol(0.3)) + torch.sum(sol.u_final))
    loss.backward()
    exact = (sum(-2 * t * (1.3 * math.exp(-0.7 * t)) ** 2 for t in tq)
             + sum(-t * 1.3 * math.exp(-0.7 * t) for t in (0.6, 0.3, 1.0)))
    assert abs(float(a.grad) - exact) < 1e-6
    exact_u = (sum(2 * 1.3 * math.exp(-1.4 * t) for t in tq)
               + sum(math.exp(-0.7 * t) for t in (0.6, 0.3, 1.0)))
    assert abs(float(u0.grad[0]) - exact_u) < 1e-7


def test_dense_nonlinear_lotka_volterra_vs_finite_differences():
    """Lotka–Volterra, three dense queries under InterpolatingAdjoint:
    against central differences (the JAX test's oracle and bound) in a and
    c."""
    def loss(p):
        sol = P.solve(P.ODEProblem(lotka_volterra_port,
                                   torch.tensor([1.0, 1.0], dtype=DT),
                                   (0.0, 3.0), p),
                      sensealg=P.InterpolatingAdjoint(), dense=True, **TOLS)
        return torch.sum(sol([0.9, 1.7, 2.6]) ** 2)

    p0 = np.array([1.5, 1.0, 3.0, 1.0])
    p = torch.tensor(p0, dtype=DT, requires_grad=True)
    loss(p).backward()
    eps = 1e-6
    with torch.no_grad():
        for i in (0, 2):
            e = np.zeros(4)
            e[i] = eps
            fd = (float(loss(torch.tensor(p0 + e, dtype=DT)))
                  - float(loss(torch.tensor(p0 - e, dtype=DT)))) / (2 * eps)
            assert abs(float(p.grad[i]) - fd) <= 2e-5 * (1 + abs(fd))


def test_direct_adjoint_dense():
    """DirectAdjoint's dense rows are autograd tensors: sol(t) is
    differentiable; without dense=True, sol(t) raises."""
    a = torch.tensor(0.7, dtype=DT, requires_grad=True)
    sol = P.solve(_decay_prob(a), sensealg=P.DirectAdjoint(), dense=True,
                  max_steps=512, **TOLS)
    (torch.sum(sol(TQ)) ** 2).backward()
    assert abs(float(a.grad) + 2 * TQ * (1.3 * math.exp(-0.7 * TQ)) ** 2) < 1e-6
    sol = P.solve(_decay_prob(torch.tensor(0.7, dtype=DT)),
                  sensealg=P.DirectAdjoint())
    with pytest.raises(ValueError):
        sol(TQ)


# -- sol(t) through events, under the discrete rules -----------------------

G = 9.81
BALL_TS = np.linspace(0.0, 2.0, 7)
BALL_TQ = [0.3, 0.7, 1.2, 1.8]
DOSE_P = np.array([1.3, 0.5])
DOSE_TQ = [0.2, 0.3, 0.5, 0.74, 0.9]


def _ball(mod, stack, u0, p, alg):
    """The bouncing ball with dense output: a continuous event per bounce,
    so every later node's time moves with u0 and p."""
    cb = mod.ContinuousCallback(
        condition=lambda u, p, t: u[0],
        affect=lambda u, p, t: stack([u[0], -p[0] * u[1]]), direction=-1)
    sol = mod.solve(mod.ODEProblem(lambda u, p, t: stack([u[1],
                                                          -G + 0.0 * u[0]]),
                                   u0, (0.0, 2.0), p), mod.Tsit5(),
                    saveat=BALL_TS, callback=cb, sensealg=alg, dense=True,
                    **TOLS)
    return (sol(BALL_TQ) ** 2).sum() + sol.ys[:, 0].sum()


def _dose(mod, one, q, alg):
    """Doses at 0.3 and 0.75 (discrete events: pre- and post-dose rows at
    each), queried on both sides of them."""
    cb = mod.PresetTimeCallback([0.3, 0.75], lambda u, p, t: u + p[1])
    sol = mod.solve(mod.ODEProblem(lambda u, p, t: -p[0] * u, one, (0.0, 1.0),
                                   q), mod.Tsit5(), saveat=np.array([0.5, 1.0]),
                    callback=cb, sensealg=alg, dense=True, **TOLS)
    return (sol(DOSE_TQ) ** 2).sum()


@pytest.fixture(scope="module")
def events_dense_ref():
    """JAX's DirectAdjoint gradients of both losses: it differentiates the
    discrete program, the dense node times included, as its
    ForwardDiffSensitivity does (the two agree to roundoff here; this one
    compiles in less time)."""
    direct = J.DirectAdjoint()
    ball = jax_o0(jax.grad(lambda u0, p: _ball(J, jnp.stack, u0, p, direct),
                           argnums=(0, 1)),
                  jnp.array([1.0, 0.0]), jnp.array([0.9]))
    dose = jax_o0(jax.grad(lambda q: _dose(J, jnp.array([1.0]), q, direct)),
                  jnp.asarray(DOSE_P))
    return {"ball": [np.asarray(g) for g in ball], "dose": [np.asarray(dose)]}


@pytest.mark.parametrize("rule", ["ForwardDiffSensitivity", "DirectAdjoint"])
@pytest.mark.parametrize("case", ["ball", "dose"])
def test_dense_gradient_through_events_matches_jax(events_dense_ref, case,
                                                   rule):
    """sol(t) through events against JAX's DirectAdjoint (1e-8):
    the bounces move the nodes after them, whose times the replay carries
    (without them the ball's gradient is off by 10x); the doses add a pre-
    and a post-dose row each, which the replay's nodes mirror."""
    alg = _alg(P, rule)
    if case == "ball":
        got = _port_grad_np(lambda u0, p: _ball(P, torch.stack, u0, p, alg),
                            [1.0, 0.0], [0.9])
    else:
        got = _port_grad_np(
            lambda q: _dose(P, torch.tensor([1.0], dtype=DT), q, alg), DOSE_P)
    for g, ref in zip(got, events_dense_ref[case]):
        np.testing.assert_allclose(g, ref, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * np.max(np.abs(ref)))


def _port_grad_np(loss, *args):
    xs = [torch.tensor(np.asarray(a, float), dtype=DT).requires_grad_()
          for a in args]
    loss(*xs).backward()
    return [x.grad.numpy() for x in xs]


@pytest.mark.parametrize("case", ["checkpointing", "callbacks",
                                  "reverse_span", "gauss_checkpointing"])
def test_dense_gradient_refusals(case):
    """What JAX refuses raises, with JAX's meaning: the checkpointed rules,
    callbacks under a continuous rule (naming the rules that take them)
    and t1 < t0."""
    a = torch.tensor(0.7, dtype=DT, requires_grad=True)
    tspan = (1.0, 0.0) if case == "reverse_span" else (0.0, 1.0)
    prob = P.ODEProblem(_decay_port, torch.tensor([1.3], dtype=DT), tspan,
                        {"a": a})
    cb = P.ContinuousCallback(lambda u, p, t: u[0] - 1.0,
                              lambda u, p, t: 0.5 * u)
    kw, match = {
        "checkpointing": (dict(
            sensealg=P.InterpolatingAdjoint(checkpointing=True),
            saveat=np.array([0.0, 0.5, 1.0])), "checkpointing=True"),
        "callbacks": (dict(sensealg=P.GaussAdjoint(), callback=cb),
                      "use ForwardDiffSensitivity or DirectAdjoint"),
        "reverse_span": (dict(sensealg=P.GaussAdjoint()), "t1 >= t0"),
        "gauss_checkpointing": (dict(
            sensealg=P.GaussAdjoint(checkpointing=True),
            saveat=np.array([0.0, 0.5, 1.0])), "checkpointing=True")}[case]
    with pytest.raises(NotImplementedError, match=match):
        sol = P.solve(prob, dense=True, **TOLS, **kw)
        (torch.sum(sol(0.5)) ** 2).backward()


# -- F1: a field that reads t, through save times (ROADMAP §3) ---------------

def _forced(mod, sin, as_t):
    """u' = −a·u + sin(3t) (F1's save-time case); the autonomous control
    with sin=None, u' = −a·u + 1."""
    if sin is None:
        return lambda u, p, t: -p[0] * u + 1.0
    return lambda u, p, t: -p[0] * u + sin(3 * as_t(t, u))


_FIELDS = {
    "jax": {"forced": _forced(J, jnp.sin, lambda t, u: t),
            "autonomous": _forced(J, None, None)},
    "port": {"forced": _forced(P, torch.sin,
                               lambda t, u: torch.as_tensor(t, dtype=u.dtype)),
             "autonomous": _forced(P, None, None)},
}


@pytest.fixture(scope="module")
def forced_saveat_ref():
    """JAX DirectAdjoint's gradient of Σ sol.ys with respect to a, u0 and
    the traced save times, per field."""
    out = {}
    for name, f in _FIELDS["jax"].items():
        def loss(a, u0, sv, f=f):
            sol = J.solve(J.ODEProblem(f, u0, (0.0, 1.0), a), saveat=sv,
                          sensealg=J.DirectAdjoint(), max_steps=256, **TOLS)
            return jnp.sum(sol.ys)

        out[name] = [np.asarray(g) for g in jax_o0(
            jax.grad(loss, argnums=(0, 1, 2)), jnp.array([0.7]),
            jnp.array([1.3]), jnp.asarray(SV))]
    return out


@pytest.mark.parametrize("field", ["forced", "autonomous"])
@pytest.mark.parametrize("rule", ["DirectAdjoint", "ForwardDiffSensitivity"])
def test_time_dependent_field_saveat_gradient_matches_jax(forced_saveat_ref,
                                                          rule, field):
    """F1: the stage times of every step clipped to a save time carry the
    save time's derivative, so a field that reads t gets dL/dtᵢ =
    f(u(tᵢ), tᵢ) = [−0.2654, 0.1644, −0.3973] on u' = −a·u + sin(3t),
    with JAX's DirectAdjoint (1e-8; before the repair the port's
    DirectAdjoint gave [−0.9333, 0.6711, −0.3855]). The autonomous field
    is the control."""
    a = torch.tensor([0.7], dtype=DT, requires_grad=True)
    u0 = torch.tensor([1.3], dtype=DT, requires_grad=True)
    sv = torch.tensor(SV, dtype=DT, requires_grad=True)
    sol = P.solve(P.ODEProblem(_FIELDS["port"][field], u0, (0.0, 1.0), a),
                  saveat=sv, sensealg=_alg(P, rule), max_steps=256, **TOLS)
    got = torch.autograd.grad(sol.ys.sum(), (a, u0, sv))
    for g, r, name in zip(got, forced_saveat_ref[field], ("a", "u0", "t")):
        np.testing.assert_allclose(g.numpy(), r, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * np.abs(r).max(),
                                   err_msg=name)
    if field == "forced":
        np.testing.assert_allclose(got[2].numpy(),
                                   [-0.2654, 0.1644, -0.3973], atol=1e-4)


def test_fixed_grid_saveat_tensor_has_no_gradient():
    """The fixed-grid discrete path gathers its rows at grid indices, as
    JAX's does (its saveat gradient is 0): the port's saveat tensor takes
    no part in the graph, and the rows match JAX's (1e-12)."""
    f = _FIELDS["port"]["forced"]
    sv = torch.tensor([0.25, 0.5, 1.0], dtype=DT, requires_grad=True)
    a = torch.tensor([0.7], dtype=DT, requires_grad=True)
    sol = P.solve(P.ODEProblem(f, torch.tensor([1.3], dtype=DT), (0.0, 1.0),
                               a), saveat=sv, adaptive=False, dt=0.125)
    g_a, g_sv = torch.autograd.grad(sol.ys.sum(), (a, sv), allow_unused=True)
    assert g_sv is None
    ref = J.solve(J.ODEProblem(_FIELDS["jax"]["forced"], jnp.array([1.3]),
                               (0.0, 1.0), jnp.array([0.7])),
                  saveat=jnp.array([0.25, 0.5, 1.0]), adaptive=False,
                  dt=0.125)
    np.testing.assert_allclose(sol.ys.detach().numpy(), np.asarray(ref.ys),
                               rtol=1e-12)
