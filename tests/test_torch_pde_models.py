"""Parity of the port's PDE models (models/pde.py) with the JAX package's,
in float64 on the CPU: the heat-equation and Brusselator fields at seeded
states, the problems' initial states, and the heat-equation gradient
through `solve`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_close, rng, to_port

import scimlsensitivity_jl_tpu as J
import scimlsensitivity_jl_tpu_torch as P
from scimlsensitivity_jl_tpu.models import pde as jpde


def test_heat1d_field_matches_jax():
    g = rng(11)
    u, p, dx = g.standard_normal(32), g.uniform(0.5, 1.5, 2), 0.3
    f_j = jpde.heat1d_field(dx)(jnp.asarray(u), jnp.asarray(p), 0.0)
    f_p = P.heat1d_field(dx)(to_port(u), to_port(p), 0.0)
    assert_close(f_p, f_j, atol=1e-12)


@pytest.mark.parametrize("t", [0.5, 1.5], ids=["forcing_off", "forcing_on"])
def test_brusselator_field_matches_jax(t):
    """n = 16 (the forcing disc covers cells), a seeded (n, n, 2) state."""
    n = 16
    g = rng(12)
    state, p = g.uniform(0.0, 3.0, (n, n, 2)), np.array([3.4, 1.0])
    f_j = jpde.brusselator_2d_field(n)(jnp.asarray(state), jnp.asarray(p), t)
    f_p = P.brusselator_2d_field(n)(to_port(state), to_port(p), t)
    assert f_p.shape == (n, n, 2)
    assert_close(f_p, f_j, atol=1e-12 * float(np.abs(f_j).max()))


def test_problems_match_jax():
    pj, xj = jpde.heat1d_problem(nx=32)
    pp, xp = P.heat1d_problem(nx=32, device="cpu")
    assert_close(xp, xj, atol=1e-12)
    assert_close(pp.u0, pj.u0, atol=1e-12)
    assert pp.tspan == pj.tspan
    bj = jpde.brusselator_2d_problem(n=8)
    bp = P.brusselator_2d_problem(n=8, device="cpu")
    assert_close(bp.u0, bj.u0, atol=1e-12)
    assert_close(bp.p, bj.p, atol=0.0)


def test_heat1d_gradient_matches_jax():
    """nx = 32 on a fixed grid of 10 steps with the default sensealg: n + p
    = 34 picks ForwardDiffSensitivity in both packages, which on a fixed
    grid takes the discrete path (autograd through the steps). The gradient
    of Σ u(T)² with respect to u0 and p, relative 1e-9."""
    kw = dict(saveat=[0.0, 0.5], dt=0.05, adaptive=False)
    pj, _ = jpde.heat1d_problem(nx=32)

    def loss_j(u0, p):
        sol = J.solve(J.remake(pj, u0=u0, p=p), J.Tsit5(), **kw)
        return jnp.sum(sol.ys[-1] ** 2)

    g_j = jax.grad(loss_j, argnums=(0, 1))(pj.u0, pj.p)
    pp, _ = P.heat1d_problem(nx=32, device="cpu")
    u0 = pp.u0.clone().requires_grad_()
    p = pp.p.clone().requires_grad_()
    sol = P.solve(P.remake(pp, u0=u0, p=p), P.Tsit5(), **kw)
    assert isinstance(sol.sensealg, P.ForwardDiffSensitivity)
    assert sol.retcode == 0 and sol.adjoint is None
    g_p = torch.autograd.grad(torch.sum(sol.ys[-1] ** 2), (u0, p))
    for got, want in zip(g_p, g_j):
        want = np.asarray(want)
        assert_close(got, want, rtol=1e-9, atol=1e-9 * np.abs(want).max())
