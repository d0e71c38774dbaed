"""Parity of the port's nonlinear solves and SteadyStateAdjoint with the
JAX package's, in float64 on the CPU: the cases of tests/test_steadystate.py
and bench.py's 8-unknown tanh residual.

Newton converges to 1e-10 of the residual in both packages, so roots are
held to each other at 1e-10 and IFT gradients at 1e-9 relative; the JAX
references are jitted (no adaptive step sequence to match). The GMRES
iterates differ from JAX's at roundoff (ROADMAP §3), which the solve's
tolerance of 1e-10 covers. Where the JAX test's oracle is a closed form
or finite differences, the port is held to it too, at that test's
tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scimlsensitivity_jl_tpu as J
import scimlsensitivity_jl_tpu_torch as P

DT = torch.float64
RTOL = 1e-9


def _grad(fn, *args):
    xs = [torch.tensor(np.asarray(a, float), dtype=DT, requires_grad=True)
          for a in args]
    return [g.numpy() for g in torch.autograd.grad(fn(*xs), xs)]


def _close(port, ref, rtol=RTOL):
    ref = np.asarray(ref)
    np.testing.assert_allclose(port, ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(), 1e-300))


def test_nonlinear_root():
    """u² − p = 0: u* = √p, dL/dp = 1/(2√p), as JAX's."""
    sol = P.solve_nonlinear(P.NonlinearProblem(
        lambda u, p: u ** 2 - p, torch.tensor([1.0], dtype=DT),
        torch.tensor(2.0, dtype=DT)))
    ref = J.solve_nonlinear(J.NonlinearProblem(
        lambda u, p: u ** 2 - p, jnp.array([1.0]), jnp.asarray(2.0)))
    assert sol.retcode == 0 and int(ref.retcode) == 0
    assert sol.iters == int(ref.iters)
    np.testing.assert_allclose(sol.u.numpy(), np.sqrt(2.0), rtol=1e-10)

    def loss(mod, one):
        return lambda p: mod.solve_nonlinear(mod.NonlinearProblem(
            lambda u, pp: u ** 2 - pp, one, p)).u[0]

    (g,) = _grad(loss(P, torch.tensor([1.0], dtype=DT)), 2.0)
    g_ref = jax.jit(jax.grad(loss(J, jnp.array([1.0]))))(jnp.asarray(2.0))
    _close(g, g_ref)
    np.testing.assert_allclose(g, 0.5 / np.sqrt(2.0), rtol=1e-8)


def test_steady_state_problem_via_solve():
    """du/dt = p − u through `solve`: u* = p, d(Σu*²)/dp = 2p."""
    def loss(mod, u0):
        return lambda p: (mod.solve(mod.SteadyStateProblem(
            lambda u, pp, t: pp - u, u0, p)).u ** 2).sum()

    (g,) = _grad(loss(P, torch.tensor([0.3], dtype=DT)), 1.7)
    g_ref = jax.jit(jax.grad(loss(J, jnp.array([0.3]))))(jnp.asarray(1.7))
    _close(g, g_ref)
    np.testing.assert_allclose(g, 2 * 1.7, rtol=1e-8)
    with pytest.raises(NotImplementedError, match="SteadyStateAdjoint"):
        P.solve(P.SteadyStateProblem(lambda u, pp, t: pp - u,
                                     torch.tensor([0.3], dtype=DT),
                                     torch.tensor(1.7, dtype=DT)),
                sensealg=P.GaussAdjoint())


A5 = np.array(jax.random.normal(jax.random.PRNGKey(1), (5, 5),
                                  jnp.float64) + 5.0 * jnp.eye(5))


def _twisted(mod, tanh):
    return lambda u, p: mod_matmul(A5, u) + 0.1 * tanh(u) - p


def mod_matmul(a, u):
    if isinstance(u, torch.Tensor):
        return torch.as_tensor(a, dtype=u.dtype) @ u
    return jnp.asarray(a) @ u


@pytest.mark.parametrize("case", ["dense", "gmres"])
def test_ift_gradient_multidim(case):
    """A u + 0.1 tanh(u) − p = 0 (the JAX test's A): the IFT gradient
    through the dense branch, and through the matrix-free GMRES branch
    (dense_cutoff = 0, Newton-Krylov forward too), against JAX's same
    branch (1e-9) and central differences (1e-6)."""
    sa = {"dense": {}, "gmres": dict(linsolve="gmres", dense_cutoff=0)}[case]

    def loss(mod, tanh, zeros):
        def fn(p):
            s = mod.solve_nonlinear(mod.NonlinearProblem(_twisted(mod, tanh),
                                                         zeros, p),
                                    sensealg=mod.SteadyStateAdjoint(**sa))
            return (s.u ** 2).sum()
        return fn

    p0 = np.arange(1.0, 6.0)
    fn_p = loss(P, torch.tanh, torch.zeros(5, dtype=DT))
    (g,) = _grad(fn_p, p0)
    g_ref = jax.jit(jax.grad(loss(J, jnp.tanh, jnp.zeros(5))))(
        jnp.asarray(p0))
    _close(g, g_ref)
    eps = 1e-6
    fd = [(float(fn_p(torch.tensor(p0 + eps * e, dtype=DT)))
           - float(fn_p(torch.tensor(p0 - eps * e, dtype=DT)))) / (2 * eps)
          for e in np.eye(5)]
    np.testing.assert_allclose(g, fd, rtol=1e-6, atol=1e-9)


def test_matrix_free_gmres_path():
    """u³ + u − p = 0 with 8 unknowns: the GMRES branch agrees with the
    dense one (1e-7, the JAX test's bound) and with JAX's GMRES branch."""
    def loss(mod, ones, **sa):
        def fn(p):
            s = mod.solve_nonlinear(
                mod.NonlinearProblem(lambda u, q: u ** 3 + u - q, ones, p),
                sensealg=mod.SteadyStateAdjoint(**sa))
            return (s.u ** 2).sum()
        return fn

    p0 = np.linspace(1.0, 2.0, 8)
    sa = dict(linsolve="gmres", dense_cutoff=0)
    (g,) = _grad(loss(P, torch.ones(8, dtype=DT), **sa), p0)
    (g_dense,) = _grad(loss(P, torch.ones(8, dtype=DT)), p0)
    g_ref = jax.jit(jax.grad(loss(J, jnp.ones(8), **sa)))(jnp.asarray(p0))
    np.testing.assert_allclose(g, g_dense, rtol=1e-7, atol=1e-10)
    _close(g, g_ref)


def test_unconstrained_optimization_adjoint():
    """argmin_u (u − p)² + 0.1u⁴: d(Σu*)/dp by IFT on ∇φ = 0."""
    def loss(mod, summ, zeros):
        def phi(u, p):
            return summ((u - p) ** 2 + 0.1 * u ** 4)

        return lambda p: mod.solve_unconstrained_optimization(
            phi, zeros, p).u.sum()

    p0 = np.array([0.7, -0.3])
    (g,) = _grad(loss(P, torch.sum, torch.zeros(2, dtype=DT)), p0)
    g_ref = jax.jit(jax.grad(loss(J, jnp.sum, jnp.zeros(2))))(
        jnp.asarray(p0))
    _close(g, g_ref)


def test_pytree_params_steady_state():
    """A dict parameter {A, b}: the gradient comes back per leaf, dL/db =
    A⁻ᵀ1."""
    A = 3.0 * np.eye(3) + 0.1
    b = np.array([1.0, 2.0, 3.0])

    def loss(mod, zeros):
        return lambda a, bb: mod.solve_nonlinear(mod.NonlinearProblem(
            lambda u, p: p["A"] @ u - p["b"], zeros,
            {"A": a, "b": bb})).u.sum()

    g_a, g_b = _grad(loss(P, torch.zeros(3, dtype=DT)), A, b)
    ref = jax.jit(jax.grad(loss(J, jnp.zeros(3)), argnums=(0, 1)))(
        jnp.asarray(A), jnp.asarray(b))
    _close(g_a, ref[0])
    _close(g_b, ref[1])
    np.testing.assert_allclose(g_b, np.linalg.solve(A.T, np.ones(3)),
                               rtol=1e-8)


def test_gmres_nonconvergence_never_silent(capsys):
    """roll(u, −1) − p = 0 with n = 100: restarted GMRES stagnates on the
    cyclic permutation, so the default falls back to the dense solve
    (dL/dp = roll(w, −1), 1e-8, as JAX's), dense_fallback_cutoff = 0
    poisons the gradient with NaN (verbose says so), and a well-conditioned
    matrix-free solve is untouched."""
    n = 100
    rng = np.random.default_rng(0)
    p0, w = rng.normal(size=n), torch.tensor(rng.normal(size=n))

    def loss(sa, verbose=False):
        def fn(p):
            prob = P.NonlinearProblem(lambda u, q: torch.roll(u, -1) - q,
                                      torch.roll(p.detach(), 1), p)
            return w @ P.solve_nonlinear(prob, sensealg=sa,
                                         verbose=verbose).u
        return fn

    (g1,) = _grad(loss(P.SteadyStateAdjoint()), p0)
    np.testing.assert_allclose(g1, np.roll(w.numpy(), -1), rtol=1e-8)
    (g2,) = _grad(loss(P.SteadyStateAdjoint(dense_fallback_cutoff=0),
                       verbose=True), p0)
    assert np.all(np.isnan(g2))
    assert "NaN-poisoning" in capsys.readouterr().out
    (g3,) = _grad(lambda p: w @ P.solve_nonlinear(P.NonlinearProblem(
        lambda u, q: 2.0 * u + 0.1 * torch.tanh(u) - q,
        torch.zeros(n, dtype=DT), p),
        sensealg=P.SteadyStateAdjoint(dense_fallback_cutoff=0)).u, p0)
    assert np.all(np.isfinite(g3))


def test_bench_tanh_residual_matches_jax():
    """bench.py's 8-unknown residual Σⱼ tanh(pⱼ u) + u − 1 = 0 with p of
    4 entries: root (1e-10), iterations, and the IFT gradient of Σu*²
    (1e-9) against JAX's; du0 is 0 in both."""
    def res(tanh, summ):
        return lambda u, q: summ(tanh(q[:, None] * u[None, :]), 0) + u - 1.0

    p0 = np.linspace(0.1, 0.5, 4)
    u0 = np.zeros(8)
    sol_p = P.solve_nonlinear(P.NonlinearProblem(
        res(torch.tanh, torch.sum), torch.tensor(u0, dtype=DT),
        torch.tensor(p0, dtype=DT)))
    sol_j = J.solve_nonlinear(J.NonlinearProblem(
        res(jnp.tanh, jnp.sum), jnp.asarray(u0), jnp.asarray(p0)))
    np.testing.assert_allclose(sol_p.u.numpy(), np.asarray(sol_j.u),
                               rtol=1e-10)
    assert sol_p.iters == int(sol_j.iters)

    def loss_p(uu0, p):
        return (P.solve_nonlinear(P.NonlinearProblem(
            res(torch.tanh, torch.sum), uu0, p)).u ** 2).sum()

    def loss_j(uu0, p):
        return jnp.sum(J.solve_nonlinear(J.NonlinearProblem(
            res(jnp.tanh, jnp.sum), uu0, p)).u ** 2)

    g_u0, g_p = _grad(loss_p, u0, p0)
    ref = jax.jit(jax.grad(loss_j, argnums=(0, 1)))(jnp.asarray(u0),
                                                     jnp.asarray(p0))
    np.testing.assert_array_equal(g_u0, np.zeros(8))
    np.testing.assert_array_equal(np.asarray(ref[0]), np.zeros(8))
    _close(g_p, ref[1])
