"""Parity of the port's high-order SDE schemes, the adaptive adjoint menu,
the RODE rules and the Lévy-area Milstein with the JAX package's, in
float64 on the CPU: one case for each test of tests/test_sde_highorder.py.

As in test_torch_sde.py: parity cases hand the port `torch_parity.JaxKey`
and agree with JAX to 1e-10 relative; statistical and exact-solution
oracles run the port alone, on its own key, under JAX's assertion, with
many paths as one batched draw and one vmapped scheme step (JAX vmaps
its scheme over per-path keys; here each fine step draws all paths at
once from one key). The adaptive cases hold the port to forward mode on
its own grid and to the rules against each other (ROADMAP §3: the
realised grid amplifies a last-bit difference step by step). Each
docstring states where the port's size differs from JAX's.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import JaxKey, jax_o0

import scimlsensitivity_jl_tpu as J
import scimlsensitivity_jl_tpu_torch as P
from scimlsensitivity_jl_tpu_torch.ops.brownian import (grid_increment,
                                                        grid_iterated,
                                                        grid_levy_area)

DT = torch.float64
TOL = 1e-10
MU, SIG = 1.2, 0.8


def ten(x):
    return torch.tensor(np.asarray(x, dtype=float), dtype=DT)


def rel(port, ref):
    port = np.asarray(port.detach() if isinstance(port, torch.Tensor)
                      else port, dtype=float)
    ref = np.asarray(ref, dtype=float)
    return float(np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-300))


def grad_of(loss, *args):
    xs = [ten(a).requires_grad_() for a in args]
    return [g.numpy() for g in torch.autograd.grad(loss(*xs), xs)]


def _strong_error(scheme, needs_dz, levels, n_paths=300, K=9):
    """Path-averaged strong error of `scheme` on GBM at 2^level steps, all
    levels on one fine path per sample (coarse ΔW, ΔZ aggregated from the
    fine ones as in JAX's test)."""
    T = 1.0
    nf = 2 ** K
    dtf = T / nf
    key = P.PRNGKey(0)
    dWf = torch.stack([grid_increment(key, i, (n_paths,), dtf, "cpu")
                       for i in range(nf)], dim=1)
    dZf = torch.stack([grid_iterated(key, i, (n_paths,), dtf, dWf[:, i])
                       for i in range(nf)], dim=1)
    Wn = torch.cat([dWf.new_zeros(n_paths, 1), torch.cumsum(dWf, 1)], dim=1)
    exact = torch.exp((MU - 0.5 * SIG ** 2) * T + SIG * Wn[:, -1])

    def fvec(u, t):
        return MU * u

    def gvec(u, t):
        return SIG * u

    errs = []
    for level in levels:
        m = 2 ** level
        step = nf // m
        dt = T / m
        dW_c = dWf.reshape(n_paths, m, step).sum(2)
        Wlo = Wn[:, :-1].reshape(n_paths, m, step)
        dZ_c = (dZf.reshape(n_paths, m, step)
                + (Wlo - Wlo[:, :, :1]) * dtf).sum(2)
        u = torch.ones(n_paths, 1, dtype=DT)
        for j in range(m):
            t = np.float64(j * dt)
            if needs_dz:
                u = torch.func.vmap(lambda uu, dw, dz: scheme.step(
                    fvec, gvec, t, dt, uu, dw, dz))(
                    u, dW_c[:, j:j + 1], dZ_c[:, j:j + 1])
            else:
                u = torch.func.vmap(lambda uu, dw: scheme.step(
                    fvec, gvec, t, dt, uu, dw))(u, dW_c[:, j:j + 1])
        errs.append(float((u[:, 0] - exact).abs().mean()))
    return errs


def test_strong_orders_on_gbm():
    """Measured strong slopes on GBM over 300 paths: EulerMaruyama ~0.5,
    Milstein ~1.0, StrongTaylor15 ~1.5 (JAX's bounds), and Taylor 1.5
    below 0.12x Milstein at the finest level."""
    levels = [3, 4, 5, 6]

    def slope(errs):
        return np.mean([math.log2(errs[i] / errs[i + 1])
                        for i in range(len(errs) - 1)])

    e_em = _strong_error(P.EulerMaruyama(), False, levels)
    e_mi = _strong_error(P.Milstein(), False, levels)
    e_t15 = _strong_error(P.StrongTaylor15(), True, levels)
    assert 0.35 < slope(e_em) < 0.75, e_em
    assert 0.8 < slope(e_mi) < 1.25, e_mi
    assert 1.3 < slope(e_t15) < 1.8, e_t15
    assert e_t15[-1] < 0.12 * e_mi[-1] < 0.12 * e_em[-1]


def _gbm(f_lib, p, u0):
    return f_lib.SDEProblem(lambda u, pp, t: pp[0] * u,
                            lambda u, pp, t: pp[1] * u, u0, (0.0, 1.0), p,
                            noise="diagonal")


GBM_P, GBM_U0 = [1.1, 0.4], [1.0, 0.5]
TS5 = np.linspace(0.0, 1.0, 5)


def test_taylor15_fixed_grid_adjoints():
    """StrongTaylor15 on a fixed grid of dt 1/16 (JAX: 1/64) under the
    three rules: Backsolve, whose reverse takes the scheme's step map and
    its pullback, equals JAX's Backsolve on the same path (1e-10; JAX holds
    it within 1e-4 of Direct at dt 1/64, where the port's forward-mode
    terms cost ~0.1 s per reverse step), Interpolating equals Direct
    (1e-10), and SRIW1 / SOSRI are the same scheme (1e-12)."""
    key = jax.random.PRNGKey(0)

    def j_loss(rule):
        def f(pp):
            sol = J.solve(_gbm(J, pp, jnp.asarray(GBM_U0)),
                          J.StrongTaylor15(), dt=1 / 16,
                          saveat=jnp.asarray(TS5), key=key,
                          sensealg=getattr(J, rule)())
            return jnp.sum(sol.ys ** 2)
        return jax_o0(jax.grad(f), jnp.asarray(GBM_P))

    def loss(alg, sch):
        def f(pp):
            sol = P.solve(_gbm(P, pp, ten(GBM_U0)), sch, dt=1 / 16,
                          saveat=TS5, key=JaxKey(key), sensealg=alg)
            return torch.sum(sol.ys ** 2)
        return f

    (g_d,) = grad_of(loss(P.DirectAdjoint(), P.StrongTaylor15()), GBM_P)
    (g_i,) = grad_of(loss(P.InterpolatingAdjoint(), P.StrongTaylor15()),
                     GBM_P)
    np.testing.assert_allclose(g_i, g_d, rtol=1e-10)
    (g_b,) = grad_of(loss(P.BacksolveAdjoint(), P.StrongTaylor15()), GBM_P)
    assert rel(g_b, j_loss("BacksolveAdjoint")) <= TOL
    for alias in (P.SRIW1(), P.SOSRI()):
        (g_a,) = grad_of(loss(P.DirectAdjoint(), alias), GBM_P)
        np.testing.assert_allclose(g_a, g_d, rtol=1e-12)


def _adaptive_loss(alg, sch, rtol=1e-3, atol=1e-6):
    def loss(pp):
        sol = P.solve(_gbm(P, pp, ten(GBM_U0)), sch, saveat=TS5,
                      sensealg=alg, rtol=rtol, atol=atol, max_steps=4096,
                      key=5)
        return torch.sum(sol.ys ** 2)
    return loss


@pytest.mark.parametrize("scheme", ["EulerMaruyama", "Milstein"])
def test_adaptive_sde_adjoint_menu(scheme):
    """The adaptive path's rules on the port's own tree at rtol 1e-3 (JAX:
    1e-4): Interpolating equals Direct (1e-9), Backsolve within 1e-3."""
    sch = None if scheme == "EulerMaruyama" else P.Milstein()
    (g_d,) = grad_of(_adaptive_loss(P.DirectAdjoint(), sch), GBM_P)
    (g_i,) = grad_of(_adaptive_loss(P.InterpolatingAdjoint(), sch), GBM_P)
    (g_b,) = grad_of(_adaptive_loss(P.BacksolveAdjoint(), sch), GBM_P)
    np.testing.assert_allclose(g_i, g_d, rtol=1e-9)
    np.testing.assert_allclose(g_b, g_d, rtol=1e-3)


def test_adaptive_adjoint_vs_forward_mode_same_noise():
    """The adaptive Direct gradient against forward mode (dual tensors)
    through the same solve, which reads the same tree and takes the same
    grid (rtol 1e-9), at rtol 1e-3 (JAX: 1e-4)."""
    import torch.autograd.forward_ad as fwAD

    loss = _adaptive_loss(P.DirectAdjoint(), None)
    (g_rev,) = grad_of(loss, GBM_P)
    g_fwd = np.zeros(2)
    for i in range(2):
        with fwAD.dual_level():
            e = torch.zeros(2, dtype=DT)
            e[i] = 1.0
            g_fwd[i] = float(fwAD.unpack_dual(
                loss(fwAD.make_dual(ten(GBM_P), e))).tangent)
    np.testing.assert_allclose(g_rev, g_fwd, rtol=1e-9)


def test_adaptive_milstein_beats_em_accuracy():
    """Against GBM's exact endpoint on the same tree, adaptive Milstein is
    more than 5x closer than adaptive EulerMaruyama (JAX's bound). JAX
    compares one path at rtol 1e-5, where the outcome rests on that path
    (on JAX's path the port gives 0.040x, at 250 s of JAX-drawn tree
    nodes; on its own key 0, 2.67x); here the mean error over 64 paths,
    one adaptive solve of a 128-entry diagonal state at rtol 1e-4
    (0.17x)."""
    mu, sig, B = 1.1, 0.4, 64
    u0 = ten(GBM_U0).repeat(B)
    vbt = P.VirtualBrownianTree.create(P.PRNGKey(0), 0.0, 1.0, shape=(2 * B,),
                                       depth=28, dtype=DT, device="cpu")
    exact = u0.numpy() * np.exp((mu - 0.5 * sig ** 2) + sig * vbt(1.0).numpy())
    errs = []
    for sch in (None, P.Milstein()):
        with torch.no_grad():
            sol = P.solve(_gbm(P, ten([mu, sig]), u0), sch, saveat=[0.0, 1.0],
                          sensealg=P.DirectAdjoint(), rtol=1e-4, atol=1e-7,
                          max_steps=32768, key=0)
        assert sol.retcode == 0
        err = np.abs(sol.ys[-1].numpy() - exact).reshape(B, 2).max(axis=1)
        errs.append(float(err.mean()))
    assert errs[1] < 0.2 * errs[0], errs


def test_rode_continuous_adjoint_menu():
    """RODE u' = −p₀u + p₁ sin W at dt 1/128: Direct JAX's on the same path
    (1e-10); Interpolating equal to Direct (1e-12), Backsolve within
    1e-10."""
    key = jax.random.PRNGKey(0)

    def j_loss(pp):
        sol = J.solve(J.RODEProblem(lambda u, p, t, W: -p[0] * u
                                    + p[1] * jnp.sin(W),
                                    jnp.array([1.0, 0.5]), (0.0, 1.0), pp),
                      dt=1 / 128, saveat=jnp.asarray(TS5), key=key)
        return jnp.sum(sol.ys ** 2)

    def loss(alg):
        def f(pp):
            sol = P.solve(P.RODEProblem(lambda u, p, t, W: -p[0] * u
                                        + p[1] * torch.sin(W),
                                        ten([1.0, 0.5]), (0.0, 1.0), pp),
                          dt=1 / 128, saveat=TS5, key=JaxKey(key),
                          sensealg=alg)
            return torch.sum(sol.ys ** 2)
        return f

    (g_d,) = grad_of(loss(P.DirectAdjoint()), [1.2, 0.7])
    assert rel(g_d, jax_o0(jax.grad(j_loss), jnp.array([1.2, 0.7]))) <= TOL
    (g_i,) = grad_of(loss(P.InterpolatingAdjoint()), [1.2, 0.7])
    (g_b,) = grad_of(loss(P.BacksolveAdjoint()), [1.2, 0.7])
    np.testing.assert_allclose(g_i, g_d, rtol=1e-12)
    np.testing.assert_allclose(g_b, g_d, rtol=1e-10)


def _noncommutative_g(lib):
    stack = torch.stack if lib is P else jnp.stack

    def g(u, q, t):
        col1 = stack([q[1] * u[1], 0.1 * u[0]])
        col2 = stack([q[3] * u[0], q[2] * u[0]])
        return (torch.stack([col1, col2], dim=1) if lib is P
                else jnp.stack([col1, col2], axis=1))
    return g


def test_rkmilgeneral_reduces_to_commutative_milstein():
    """On commutative noise the Lévy-area contraction vanishes:
    RKMilGeneral(levy_terms=8) equals Milstein(commutative=True) to
    1e-12, and both equal JAX's on the same path (key 3)."""
    key = jax.random.PRNGKey(3)

    def run(solver, lib, k):
        stack = torch.stack if lib is P else jnp.stack
        prob = lib.SDEProblem(
            lambda u, q, t: q[0] * u,
            lambda u, q, t: (torch.stack([q[1] * u, q[2] * u], dim=1)
                             if lib is P else stack([q[1] * u, q[2] * u],
                                                    axis=1)),
            (ten if lib is P else jnp.asarray)([1.0, 2.0]), (0.0, 1.0),
            (ten if lib is P else jnp.asarray)([0.1, 0.4, 0.25]),
            noise="general", noise_dim=2)
        return lib.solve(prob, solver, dt=1e-2, key=k).ys[-1]

    a = run(P.Milstein(commutative=True), P, JaxKey(key))
    b = run(P.RKMilGeneral(levy_terms=8), P, JaxKey(key))
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12, atol=1e-12)
    assert rel(b, run(J.RKMilGeneral(levy_terms=8), J, key)) <= TOL


def test_plain_milstein_rejects_matrix_noise():
    prob = P.SDEProblem(lambda u, q, t: q[0] * u, _noncommutative_g(P),
                        ten([1.0, 0.5]), (0.0, 1.0), ten([0.1, 0.4, 0.25, 0.3]),
                        noise="general", noise_dim=2)
    with pytest.raises(NotImplementedError, match="commutative"):
        P.solve(prob, P.Milstein(), dt=1e-2, key=0)


def test_levy_area_statistics():
    """The truncated series at 400 terms over 4000 steps (the port's own
    key): antisymmetric, mean 0, variance within JAX's band around the
    exact h²/4; and one area equal to JAX's on JAX's draws."""
    key = P.PRNGKey(42)
    h = np.float64(0.25)
    A = torch.stack([grid_levy_area(key, i, 2, h, grid_increment(
        key, i, (2,), h, "cpu"), terms=400) for i in range(4000)])
    np.testing.assert_allclose(A[:, 0, 1].numpy(), -A[:, 1, 0].numpy(),
                               rtol=0, atol=1e-12)
    assert abs(float(A[:, 0, 1].mean())) < 0.05 * h
    var = float(A[:, 0, 1].var(unbiased=False))
    assert 0.85 * h ** 2 / 4 < var < 1.1 * h ** 2 / 4, var
    from scimlsensitivity_jl_tpu.ops.brownian import grid_levy_area as j_levy

    jk = jax.random.PRNGKey(42)
    dw = np.array([0.3, -0.2])
    ref = j_levy(jk, 5, 2, jnp.asarray(h), jnp.asarray(dw), terms=400)
    got = grid_levy_area(JaxKey(jk), 5, 2, h, ten(dw), terms=400)
    assert rel(got, ref) <= TOL


def test_rkmilgeneral_strong_order_one_noncommutative():
    """Strong order 1 on non-commutative noise against a fine-grid
    self-reference on one consistent path (coarse iterated integrals
    chained from the fine ones, as in JAX's test), 200 paths, 2^10 fine
    steps: the slope between dt 1/16 and 1/128 exceeds 0.8."""
    T, K, n_paths = 1.0, 10, 200
    nf = 2 ** K
    dtf = T / nf
    q = ten([0.05, 0.35, 0.3, 0.25])
    u0 = ten([1.0, 0.5])
    solver = P.RKMilGeneral(levy_terms=12)
    g = _noncommutative_g(P)

    def fvec(u, t):
        return q[0] * u

    def gvec(u, t):
        return g(u, q, t)

    key = P.PRNGKey(1)
    dWf = torch.stack([grid_increment(key, i, (n_paths, 2), dtf, "cpu")
                       for i in range(nf)], dim=1)
    Af = torch.stack([grid_levy_area(key, i, 2, np.float64(dtf), dWf[:, i],
                                     terms=12) for i in range(nf)], dim=1)
    eye = torch.eye(2, dtype=DT)
    If = 0.5 * (dWf[..., :, None] * dWf[..., None, :] - dtf * eye) + Af

    def run(dt, dW, A):
        u = u0.repeat(n_paths, 1)
        for m in range(dW.shape[1]):
            t = np.float64(m * dt)
            u = torch.func.vmap(lambda uu, dw, a: solver.step(
                fvec, gvec, t, dt, uu, dw, a))(u, dW[:, m], A[:, m])
        return u

    uref = run(dtf, dWf, Af)

    def err_at(level):
        mth = 2 ** level
        sub = nf // mth
        blocks = dWf.reshape(n_paths, mth, sub, 2)
        dWc = blocks.sum(2)
        W_before = torch.cumsum(blocks, 2) - blocks
        cross = torch.einsum("bcsj,bcsk->bcjk", W_before, blocks)
        Ic = If.reshape(n_paths, mth, sub, 2, 2).sum(2) + cross
        Ac = 0.5 * (Ic - Ic.transpose(-1, -2))
        uc = run(T / mth, dWc, Ac)
        return float((uc - uref).abs().max(dim=1).values.mean())

    e4, e7 = err_at(4), err_at(7)
    slope = math.log(e4 / e7) / math.log(2 ** 3)
    assert slope > 0.8, (e4, e7, slope)


def test_rkmilgeneral_gradient_adjoint_vs_forward():
    """Non-commutative noise under RKMilGeneral(levy_terms=10), dt 1e-2:
    Direct, Interpolating and Backsolve against JAX's Direct (which JAX
    holds to jacfwd) on the same path and Lévy areas (key 17), 1e-10
    (Backsolve: JAX's 1e-4)."""
    key = jax.random.PRNGKey(17)
    q0 = [0.2, 0.3, 0.15, 0.25]

    def j_loss(qq):
        prob = J.SDEProblem(lambda u, p, t: p[0] * u, _noncommutative_g(J),
                            jnp.array([1.0, 0.5]), (0.0, 0.5), qq,
                            noise="general", noise_dim=2)
        return jnp.sum(J.solve(prob, J.RKMilGeneral(levy_terms=10), dt=1e-2,
                               key=key, sensealg=J.DirectAdjoint()).ys[-1]
                       ** 2)

    g_j = jax_o0(jax.grad(j_loss), jnp.asarray(q0))
    for rule, tol in (("DirectAdjoint", TOL), ("InterpolatingAdjoint", TOL),
                      ("BacksolveAdjoint", 1e-4)):
        def loss(qq, rule=rule):
            prob = P.SDEProblem(lambda u, p, t: p[0] * u, _noncommutative_g(P),
                                ten([1.0, 0.5]), (0.0, 0.5), qq,
                                noise="general", noise_dim=2)
            return torch.sum(P.solve(prob, P.RKMilGeneral(levy_terms=10),
                                     dt=1e-2, key=JaxKey(key),
                                     sensealg=getattr(P, rule)()).ys[-1]
                             ** 2)

        (g,) = grad_of(loss, q0)
        assert rel(g, g_j) <= tol, rule
