"""Parity of the port's QuadratureAdjoint and its quadrature rules with the
JAX package's, in float64 on the CPU: the Gauss–Kronrod and Gauss–Legendre
nodes and weights, the gradient on Lotka–Volterra (with tolerances that
make the bisection worklist run), on
a problem without parameters with n > 100 (where sensealg=None picks
QuadratureAdjoint), and on the reaction–diffusion kernel field at a small n
(K1 in the forward, K2 in every λ step and at every Gauss–Kronrod node; on
the CPU both run their plain versions).

JAX runs each reference as one program compiled at XLA optimization level
0 (`torch_parity.jax_o0`), so both packages take the same steps; the
tolerances leave room for summation order only."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (assert_close, jax_o0, lotka_volterra_jax,
                          lotka_volterra_port, rd1d_u0, to_port)

import scimlsensitivity_jl_tpu as J
import scimlsensitivity_jl_tpu_torch as P
from scimlsensitivity_jl_tpu.ops import quadrature as jax_quad
from scimlsensitivity_jl_tpu.ops.pallas_pde import rd1d_reference
from scimlsensitivity_jl_tpu_torch.ops import quadrature as port_quad
from scimlsensitivity_jl_tpu_torch.ops.rd1d import make_rd1d_field as port_rd1d

GRAD_RTOL = 1e-10


@pytest.mark.parametrize("n", [3, 7, 15])
def test_gauss_kronrod_and_legendre_rules_match_jax(n):
    """The same host construction in float64, so the same values; the
    GK(n, 2n+1) rule integrates x^(3n+1) exactly on [0, 1], its embedded
    Gauss rule x^(2n-1)."""
    for got, ref in zip(port_quad.gauss_kronrod_01(n),
                        jax_quad.gauss_kronrod_01(n, jnp.float64)):
        assert got.dtype == np.float64
        np.testing.assert_array_equal(got, np.asarray(ref))
    for got, ref in zip(port_quad.gl_01(n), jax_quad.gl_01(n, jnp.float64)):
        np.testing.assert_array_equal(got, np.asarray(ref))
    x, wk, wg = port_quad.gauss_kronrod_01(n)
    np.testing.assert_allclose(wk @ x ** (3 * n + 1), 1.0 / (3 * n + 2),
                               rtol=1e-13)
    np.testing.assert_allclose(wg @ x ** (2 * n - 1), 1.0 / (2 * n),
                               rtol=1e-13)
    x32, _, _ = port_quad.gauss_kronrod_01(n, np.float32)
    assert x32.dtype == np.float32


LV_U0 = np.array([1.0, 1.0])
LV_P = np.array([1.5, 1.0, 3.0, 1.0])
LV_TS = np.linspace(0.0, 2.0, 5)
LV_TOL = dict(rtol=1e-6, atol=1e-8)


def test_quadrature_adjoint_lv_matches_jax():
    """dL/du0 = λ(t0) from the λ-only reverse, dL/dp from the adaptive
    Gauss–Kronrod pass over λ's recorded dense output: one panel per
    reverse step, then, under tolerances no panel meets, bisection until
    the worklist's budget of 4·2^max_depth = 8 splits, or every panel's
    depth max_depth = 1, runs out (a small depth keeps JAX's compile
    short)."""
    quad = dict(abstol=1e-15, reltol=1e-15, max_depth=1)

    def jax_loss(u0, p):
        sol = J.solve(J.ODEProblem(lotka_volterra_jax, u0, (0.0, 2.0), p),
                      J.Tsit5(), saveat=jnp.asarray(LV_TS),
                      sensealg=J.QuadratureAdjoint(**quad), **LV_TOL)
        return jnp.sum((sol.ys - 1.0) ** 2)

    gu_j, gp_j = jax_o0(jax.grad(jax_loss, argnums=(0, 1)),
                        jnp.asarray(LV_U0), jnp.asarray(LV_P))
    u0 = to_port(LV_U0).requires_grad_()
    p = to_port(LV_P).requires_grad_()
    sol = P.solve(P.ODEProblem(lotka_volterra_port, u0, (0.0, 2.0), p),
                  P.Tsit5(), saveat=LV_TS,
                  sensealg=P.QuadratureAdjoint(**quad), **LV_TOL)
    torch.sum((sol.ys - 1.0) ** 2).backward()
    assert sol.adjoint.stats.retcode == 0
    assert_close(u0.grad, gu_j, rtol=GRAD_RTOL)
    assert_close(p.grad, gp_j, rtol=GRAD_RTOL)


def _decay_diffusion(n, lib):
    """u' = -u + 0.05 (u_{i-1} - 2u_i + u_{i+1}) + 0.1 sin(t), periodic,
    no parameters."""
    def f(u, p, t):
        lap = lib.roll(u, 1) - 2.0 * u + lib.roll(u, -1)
        return -u + 0.05 * lap + 0.1 * lib.sin(lib.asarray(t) if lib is jnp
                                               else torch.as_tensor(t))

    return f


def test_default_without_parameters_is_quadrature_and_matches_jax():
    """n = 128 and no p: sensealg=None picks QuadratureAdjoint in both
    packages, whose gradient is then λ(t0) alone."""
    n = 128
    u0 = np.random.default_rng(11).standard_normal(n)
    ts = np.linspace(0.0, 1.0, 3)
    kw = dict(rtol=1e-6, atol=1e-8)

    def jax_loss(uu):
        sol = J.solve(J.ODEProblem(_decay_diffusion(n, jnp), uu, (0.0, 1.0)),
                      J.Tsit5(), saveat=jnp.asarray(ts), **kw)
        return jnp.sum(sol.ys ** 2)

    g_j = jax_o0(jax.grad(jax_loss), jnp.asarray(u0))
    uu = to_port(u0).requires_grad_()
    sol = P.solve(P.ODEProblem(_decay_diffusion(n, torch), uu, (0.0, 1.0)),
                  P.Tsit5(), saveat=ts, **kw)
    torch.sum(sol.ys ** 2).backward()
    assert type(sol.sensealg) is P.QuadratureAdjoint
    assert sol.adjoint.stats.retcode == 0
    assert_close(uu.grad, g_j, rtol=GRAD_RTOL, atol=1e-13)


def test_quadrature_adjoint_rd1d_field_matches_jax():
    """The kernel field at n = 64 on the PDE's fixed grid (8 steps of
    1e-9, the reverse adaptive at adj_rtol 1e-3), one Gauss–Kronrod panel
    per reverse step and no bisection (max_depth 0, which keeps JAX's
    compile short): in the port the forward
    through K1's operator, the λ steps and the Gauss–Kronrod nodes through
    K2's; JAX's side is the field's plain reference (`rd1d_reference`),
    which its kernels are tested against and which compiles in a fraction
    of the interpreted Pallas kernels' time."""
    n, dt, steps = 64, 1e-9, 8
    t1 = steps * dt
    u0 = rd1d_u0(n) + 0.01 * np.random.default_rng(7).standard_normal(n)
    p = np.array([1e-7, 1.5])
    kw = dict(saveat=[0.0, t1], dt=dt, adaptive=False, adj_rtol=1e-3,
              adj_atol=1e-8, adj_max_steps=128)

    def jax_loss(uu, pp):
        field = lambda u, q, t: rd1d_reference(u, q[0], q[1], float(n) ** 2)
        sol = J.solve(J.ODEProblem(field, uu, (0.0, t1), pp),
                      J.Tsit5(), sensealg=J.QuadratureAdjoint(max_depth=0),
                      saveat=jnp.asarray(kw["saveat"]),
                      **{k: v for k, v in kw.items() if k != "saveat"})
        return jnp.sum(sol.ys[-1] ** 2)

    gu_j, gp_j = jax_o0(jax.grad(jax_loss, argnums=(0, 1)), jnp.asarray(u0),
                        jnp.asarray(p))
    uu = to_port(u0).requires_grad_()
    pp = to_port(p).requires_grad_()
    sol = P.solve(P.ODEProblem(port_rd1d(n, 1.0 / n), uu, (0.0, t1), pp),
                  P.Tsit5(), sensealg=P.QuadratureAdjoint(max_depth=0), **kw)
    torch.sum(sol.ys[-1] ** 2).backward()
    assert sol.adjoint.stats.retcode == 0
    assert_close(uu.grad, gu_j, rtol=GRAD_RTOL,
                 atol=GRAD_RTOL * float(np.abs(gu_j).max()))
    assert_close(pp.grad, gp_j, rtol=1e-8)
