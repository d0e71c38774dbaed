"""Parity of the port's unroll=True under the continuous rules with the JAX
package's, in float64 on the CPU: the cases of
tests/test_unrolled_adjoints.py.

JAX runs its forward and reverse on the masked-scan driver, fully
unrolled, with the while driver's steps; its test holds the unrolled
gradients to the while driver's at 1e-7. Eager torch has no loop to
unroll: the port runs the same eager loop with the scan's budget
(`integrate(fixed_trip=True)`), so where the budget is not hit every
accepted step, value and gradient is the while driver's, and the tests
assert exact equality. Each case is also held to JAX's while-driver
gradient of the same rule, compiled at XLA optimization level 0
(`torch_parity.jax_o0`, so both packages take the same steps) and cached
for the module, at 1e-9 relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (jax_o0, lotka_volterra_jax, lotka_volterra_port)

import scimlsensitivity_jl_tpu as J
import scimlsensitivity_jl_tpu_torch as P

DT = torch.float64
PRM = np.array([1.5, 1.0, 3.0, 1.0])
U0 = np.array([1.0, 1.0])
T = 3.0
TS = np.linspace(0.0, T, 7)
RULES = ["InterpolatingAdjoint", "BacksolveAdjoint", "GaussAdjoint",
         "QuadratureAdjoint"]
REF_RTOL = 1e-9


def _while_alg(mod, name):
    # Interpolating auto-pins its while-driver reverse; the unrolled one is
    # the adaptive reverse, so the while side is the unpinned rule
    if name == "InterpolatingAdjoint":
        return mod.InterpolatingAdjoint(pinned_reverse=False)
    return getattr(mod, name)()


def _lv_loss(mod, alg, unroll, stack_sum):
    def loss(p, u0):
        sol = mod.solve(mod.ODEProblem(
            lotka_volterra_jax if mod is J else lotka_volterra_port, u0,
            (0.0, T), p), mod.Tsit5(), saveat=TS, rtol=1e-4, atol=1e-7,
            sensealg=alg, unroll=unroll, max_steps=40)
        return stack_sum(sol.ys ** 2)
    return loss


@pytest.fixture(scope="module")
def lv_refs():
    """JAX's while-driver (ū0, p̄) of Σ ys² per rule, one program."""
    def all_grads(p, u0):
        return [jax.grad(_lv_loss(J, _while_alg(J, r), False, jnp.sum),
                         argnums=(0, 1))(p, u0) for r in RULES]

    out = jax_o0(all_grads, jnp.asarray(PRM), jnp.asarray(U0))
    return {r: [np.asarray(g) for g in gs] for r, gs in zip(RULES, out)}


def _port_grads(loss, *args):
    xs = [torch.tensor(a, dtype=DT, requires_grad=True) for a in args]
    val = loss(*xs)
    return val, torch.autograd.grad(val, xs)


@pytest.mark.parametrize("rule", RULES)
def test_unrolled_matches_while_driver(lv_refs, rule):
    """Lotka–Volterra at rtol 1e-4 (~30 accepted steps under max_steps
    40): the unrolled value and gradients equal the while driver's bit for
    bit (the same eager loop, and the budget is not hit), and JAX's to
    1e-9."""
    y_w, g_w = _port_grads(_lv_loss(P, _while_alg(P, rule), False,
                                    torch.sum), PRM, U0)
    y_u, g_u = _port_grads(_lv_loss(P, getattr(P, rule)(), True, torch.sum),
                           PRM, U0)
    assert float(y_u.detach()) == float(y_w.detach())
    for gu, gw, ref in zip(g_u, g_w, lv_refs[rule]):
        np.testing.assert_array_equal(gu.numpy(), gw.numpy())
        np.testing.assert_allclose(gu.numpy(), ref, rtol=REF_RTOL,
                                   atol=REF_RTOL * np.abs(ref).max())


def _decay(mod):
    return lambda u, p, t: -p[0] * u


def _cb(mod, kind, closure=None):
    if kind == "discrete":
        return mod.PresetTimeCallback(np.array([0.9]),
                                      lambda u, pr, t: u + pr[1])
    pr1 = (lambda pr: pr[1]) if closure is None else (lambda pr: closure[1])
    return mod.ContinuousCallback(lambda u, pr, t: u[0] - 0.5,
                                  lambda u, pr, t: u * pr1(pr))


CB_P = {"discrete": np.array([0.8, 0.35]), "continuous": np.array([0.8, 0.9])}
CB_TS = np.linspace(0.0, 2.0, 5)


def _cb_loss(mod, kind, alg, unroll, stack_sum, closure=None):
    def loss(pp):
        sol = mod.solve(mod.ODEProblem(
            _decay(mod), (jnp.array([1.0]) if mod is J
                          else torch.tensor([1.0], dtype=DT)), (0.0, 2.0), pp),
            mod.Tsit5(), saveat=CB_TS, rtol=1e-6, atol=1e-9, sensealg=alg,
            unroll=unroll, max_steps=32, callback=_cb(mod, kind, closure))
        return stack_sum(sol.ys ** 2)
    return loss


CB_RULES = ["GaussAdjoint", "InterpolatingAdjoint"]


@pytest.fixture(scope="module")
def cb_refs():
    """JAX's while-driver gradient per callback kind and rule, one
    program."""
    cases = [(k, r) for k in ("discrete", "continuous") for r in CB_RULES]

    def grads(pd, pc):
        q = {"discrete": pd, "continuous": pc}
        return [jax.grad(_cb_loss(J, k, _while_alg(J, r), False,
                                  jnp.sum))(q[k]) for k, r in cases]

    out = jax_o0(grads, jnp.asarray(CB_P["discrete"]),
                 jnp.asarray(CB_P["continuous"]))
    return {case: np.asarray(g) for case, g in zip(cases, out)}


@pytest.mark.parametrize("rule", CB_RULES)
@pytest.mark.parametrize("kind", ["discrete", "continuous"])
def test_unrolled_callbacks_match_while_driver(cb_refs, kind, rule):
    """A preset dose and a continuous crossing unroll: the same pre- and
    post-affect rows as the while driver, so the gradient is the while
    driver's bit for bit, and JAX's while driver's to 1e-9."""
    _, (g_w,) = _port_grads(_cb_loss(P, kind, _while_alg(P, rule), False,
                                     torch.sum), CB_P[kind])
    _, (g_u,) = _port_grads(_cb_loss(P, kind, getattr(P, rule)(), True,
                                     torch.sum), CB_P[kind])
    np.testing.assert_array_equal(g_u.numpy(), g_w.numpy())
    ref = cb_refs[(kind, rule)]
    np.testing.assert_allclose(g_u.numpy(), ref, rtol=REF_RTOL,
                               atol=REF_RTOL * np.abs(ref).max())


@pytest.mark.parametrize("unroll", [False, True])
def test_callback_closure_over_grad_tensor_raises(unroll):
    """A callback that closes over a tensor with requires_grad cannot cross
    the continuous rule's Function, with either driver
    (`callbacks.check_callback_closures`, JAX's closure-captured tracer
    guard); DirectAdjoint differentiates the closure."""
    pp = torch.tensor(CB_P["continuous"], dtype=DT, requires_grad=True)
    with pytest.raises(ValueError, match="closes over a tensor"):
        _cb_loss(P, "continuous", P.GaussAdjoint(), unroll, torch.sum,
                 closure=pp)(pp)
    val = _cb_loss(P, "continuous", P.DirectAdjoint(), unroll, torch.sum,
                   closure=pp)(pp)
    (g,) = torch.autograd.grad(val, pp)
    assert torch.isfinite(g).all() and float(g[1]) != 0.0


@pytest.mark.parametrize("case", ["stiff", "multistep", "bwd_solver",
                                  "checkpointing", "max_steps",
                                  "adj_max_steps", "sensealg"])
def test_unrolled_guards(case):
    """JAX's refusals, with its messages: a stepper that is not explicit RK
    (Rosenbrock23, the multistep FBDF, or as bwd_solver), checkpointing on
    a rule but Backsolve, and budgets above 512."""
    prob = P.ODEProblem(lotka_volterra_port, torch.tensor(U0, dtype=DT),
                        (0.0, T), torch.tensor(PRM, dtype=DT))
    kw = dict(saveat=TS, sensealg=P.GaussAdjoint(), unroll=True,
              max_steps=64)
    err, match = NotImplementedError, "explicit-RK"
    solver = P.Tsit5()
    if case == "stiff":
        solver = P.Rosenbrock23()
    elif case == "multistep":
        solver = P.FBDF()
    elif case == "bwd_solver":
        kw["bwd_solver"] = P.Rosenbrock23()
    elif case == "checkpointing":
        kw["sensealg"] = P.InterpolatingAdjoint(checkpointing=True)
        match = "checkpointing"
    elif case == "max_steps":
        kw["max_steps"], err, match = 4096, ValueError, "max_steps"
    elif case == "adj_max_steps":
        kw["adj_max_steps"], err, match = 1024, ValueError, "max_steps"
    else:
        kw["sensealg"], match = P.ForwardSensitivity(), "DirectAdjoint"
    with pytest.raises(err, match=match):
        P.solve(prob, solver, **kw)
    if case == "checkpointing":
        # Backsolve's checkpointing is a snap, not a nested solve
        sol = P.solve(prob, P.Tsit5(), saveat=TS, rtol=1e-4, atol=1e-7,
                      unroll=True, max_steps=40,
                      sensealg=P.BacksolveAdjoint(checkpointing=True))
        assert sol.retcode == 0
