"""Parity of the port's VJP engine with the JAX package's
(`ops/vjp.py:make_vjp_kernels`), in float64 on the CPU: every product
(f_and_vjp, vjp_u, vjp_p, jvp, jac_u) on every route (AutoVJP, JacVJP,
FiniteDiffVJP) and under each user hook (jac, vjp, paramjac) with JAX's
precedence, on a field with dict parameters; then the hooks and the route
choice threaded through `solve` into the continuous rules."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_close, lotka_volterra_port, to_port

import scimlsensitivity_jl_tpu as J
import scimlsensitivity_jl_tpu_torch as P
from scimlsensitivity_jl_tpu.ops.vjp import make_vjp_kernels as jax_kernels
from scimlsensitivity_jl_tpu_torch.ops.vjp import make_vjp_kernels as port_kernels

N = 3
T = 0.3


def _field(lib):
    def f(u, p, t):
        return p["A"] @ lib.tanh(u) + p["b"] * lib.sin(u) * np.cos(t)
    return f


def _inputs():
    g = np.random.default_rng(21)
    p = {"A": g.standard_normal((N, N)), "b": g.standard_normal(N)}
    u, lam, du = (g.standard_normal(N) for _ in range(3))
    dp = {"A": g.standard_normal((N, N)), "b": g.standard_normal(N)}
    return p, u, lam, du, dp


def _true_products(lib):
    """Exact ∂f/∂u, λᵀ∂f/∂u and λᵀ∂f/∂p of the field, doubled: hooks whose
    values no route computes, so that the product shows which one ran."""
    def jac(u, p, t):
        return 2.0 * (p["A"] * (1.0 - lib.tanh(u) ** 2)[None, :]
                      + lib.diag(p["b"] * lib.cos(u) * np.cos(t)))

    def vjp(lam, u, p, t):
        return jac(u, p, t).T @ lam

    def paramjac(lam, u, p, t):
        return {"A": 2.0 * lam[:, None] * lib.tanh(u)[None, :],
                "b": 2.0 * lam * lib.sin(u) * np.cos(t)}

    return jac, vjp, paramjac


def _both(route, hook=None):
    """(JAX kernels, port kernels) for one route and at most one hook."""
    p = _inputs()[0]
    kernels = []
    for lib, make, mod, conv in ((jnp, jax_kernels, J, jnp.asarray),
                                 (torch, port_kernels, P, to_port)):
        hooks = dict(zip(("user_jac", "user_vjp", "user_paramjac"),
                         _true_products(lib)))
        kw = {} if hook is None else {hook: hooks[hook]}
        choice = getattr(mod, route)()
        kernels.append(make(_field(lib), conv(np.zeros(N)),
                            {k: conv(v) for k, v in p.items()},
                            vjp_choice=choice, **kw))
    return kernels


def _products(kern, conv):
    p, u, lam, du, dp = _inputs()
    p, u, lam, du = ({k: conv(v) for k, v in p.items()}, conv(u), conv(lam),
                     conv(du))
    dp = {k: conv(v) for k, v in dp.items()}
    fval, ubar, pbar = kern.f_and_vjp(u, p, T, lam)
    return {"f": fval, "f_and_vjp.u": ubar, "f_and_vjp.A": pbar["A"],
            "f_and_vjp.b": pbar["b"], "vjp_u": kern.vjp_u(u, p, T, lam),
            "vjp_p.A": kern.vjp_p(u, p, T, lam)["A"],
            "vjp_p.b": kern.vjp_p(u, p, T, lam)["b"],
            "jvp": kern.jvp(u, p, T, du, dp)[1],
            "jvp.dp0": kern.jvp(u, p, T, du, None)[1],
            "jac_u": kern.jac_u(u, p, T)}


# (rtol, atol): the exact routes agree to summation order; two finite
# differences at eps = 1e-6 to the roundoff of a difference of O(1) values
# over 2·eps, ~1e-10
ROUTE_TOL = {"AutoVJP": (1e-13, 1e-12), "JacVJP": (1e-13, 1e-12),
             "FiniteDiffVJP": (1e-8, 1e-9)}


@pytest.mark.parametrize("route", ["AutoVJP", "JacVJP", "FiniteDiffVJP"])
@pytest.mark.parametrize("hook", [None, "user_jac", "user_vjp",
                                  "user_paramjac"])
def test_products_match_jax(route, hook):
    """Each product of each route, alone and under each hook: a hook's
    doubled value shows where it takes precedence (user_vjp over every
    route's λᵀ∂f/∂u, user_paramjac over every λᵀ∂f/∂p, user_jac in jac_u and
    so in JacVJP's λᵀ∂f/∂u), and both packages agree on all of it."""
    jk, pk = _both(route, hook)
    got, ref = _products(pk, to_port), _products(jk, jnp.asarray)
    rtol, atol = ROUTE_TOL[route]
    for name in ref:
        assert_close(got[name], ref[name], rtol=rtol, atol=atol,
                     msg=f"{route} {hook} {name}")
    auto = _products(_both("AutoVJP")[1], to_port)
    doubled = {"user_jac": ["jac_u"] + (["vjp_u"] if route == "JacVJP" else []),
               "user_vjp": ["f_and_vjp.u", "vjp_u"],
               "user_paramjac": ["f_and_vjp.A", "f_and_vjp.b", "vjp_p.A",
                                 "vjp_p.b"]}.get(hook, [])
    for name in doubled:
        assert_close(got[name], 2.0 * auto[name], rtol=1e-12, msg=name)


def test_hooks_and_route_thread_through_solve():
    """prob.vjp and prob.paramjac reach the continuous rules (they were
    refused before the VJP engine had them): exact hooks give the AutoVJP
    gradient, and the hooks are what ran. setvjp's JacVJP gives it too."""
    calls = []

    def vjp(lam, u, p, t):
        calls.append("vjp")
        x, y = u[0], u[1]
        return torch.stack([lam[0] * (p[0] - p[1] * y) + lam[1] * p[3] * y,
                            -lam[0] * p[1] * x + lam[1] * (p[3] * x - p[2])])

    def paramjac(lam, u, p, t):
        calls.append("paramjac")
        x, y = u[0], u[1]
        return torch.stack([lam[0] * x, -lam[0] * x * y, -lam[1] * y,
                            lam[1] * x * y])

    def grads(sensealg, **hooks):
        u0 = to_port(np.array([1.0, 1.0])).requires_grad_()
        p = to_port(np.array([1.5, 1.0, 3.0, 1.0])).requires_grad_()
        sol = P.solve(P.ODEProblem(lotka_volterra_port, u0, (0.0, 1.0), p,
                                   **hooks), P.Tsit5(), saveat=[0.0, 0.5, 1.0],
                      rtol=1e-6, atol=1e-8, sensealg=sensealg)
        torch.sum(sol.ys ** 2).backward()
        return torch.cat([u0.grad, p.grad])

    ref = grads(P.GaussAdjoint())
    assert_close(grads(P.GaussAdjoint(), vjp=vjp, paramjac=paramjac), ref,
                 rtol=1e-12)
    assert {"vjp", "paramjac"} <= set(calls)
    assert_close(grads(P.setvjp(P.GaussAdjoint(), P.JacVJP())), ref,
                 rtol=1e-12)
