"""Parity of the port's SDE and RODE solves (adjoints/sde.py, solvers/sde.py,
ops/brownian.py, the SDE branches of solve and of the direct APIs) with
the JAX package's, in float64 on the CPU: one case for each test of
tests/test_sde.py, and for the SDE cases of tests/test_interface.py,
tests/test_smoke.py and tests/test_matrix.py.

Both packages integrate one path: the port's solve gets
`torch_parity.JaxKey`, which implements the port's key protocol with
`jax.random`, so every increment, iterated integral, Lévy area, bridge
draw and tree node is the number JAX draws. Fixed-grid values and
gradients then agree to 1e-10 relative (they agree to ~1e-15; 1e-10
leaves room for the summation order of a reduction). Where JAX's oracle
is statistical or an exact solution, the case runs the port alone, on
its own key, under JAX's assertion; many paths are one batched state
(diagonal noise draws independent entries), or one vmapped solve over a
batch of observed paths for matrix noise, never a loop of solves.

The adaptive path's realised grid amplifies a last-bit difference about
a thousandfold per step at these noise levels, and compiled JAX
(at any optimization level) rounds differently from op-by-op JAX, which
the port matches step for step: its adaptive cases hold the port to
JAX's own oracles (exact solutions, forward mode on the same grid, the
rules against each other), as ROADMAP §3 records. Where a JAX test runs
long on a fine grid, the port's case runs a coarser grid or fewer
steps; each docstring states the size it uses (a size, not a
tolerance).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import JaxKey, jax_o0

import scimlsensitivity_jl_tpu as J
import scimlsensitivity_jl_tpu_torch as P
from scimlsensitivity_jl_tpu_torch.ops.brownian import grid_increment

DT = torch.float64
KEY = jax.random.PRNGKey(42)
TOL = 1e-10


def ten(x):
    return torch.tensor(np.asarray(x, dtype=float), dtype=DT)


def rel(port, ref):
    port = np.asarray(port.detach() if isinstance(port, torch.Tensor)
                      else port, dtype=float)
    ref = np.asarray(ref, dtype=float)
    return float(np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-300))


def grad_of(loss, *args):
    """torch gradient of loss(*args) with respect to every argument."""
    xs = [ten(a).requires_grad_() for a in args]
    out = loss(*xs)
    return [g.numpy() for g in torch.autograd.grad(out, xs)]


# -- Lotka–Volterra SDE under every rule (tests/test_sde.py:84-135) ----------

LV_P = np.array([1.5, 1.0, 3.0, 1.0])
LV_TS = np.linspace(0.0, 1.0, 6)


def lv_j(u, pp, t):
    return jnp.stack([pp[0] * u[0] - pp[1] * u[0] * u[1],
                      -pp[2] * u[1] + pp[3] * u[0] * u[1]])


def lv_p(u, pp, t):
    return torch.stack([pp[0] * u[0] - pp[1] * u[0] * u[1],
                        -pp[2] * u[1] + pp[3] * u[0] * u[1]])


def lv_loss_j(rule, dt):
    def loss(p):
        prob = J.SDEProblem(lv_j, lambda u, pp, t: 0.1 * u,
                            jnp.array([1.0, 1.0]), (0.0, 1.0), p)
        sol = J.solve(prob, J.EulerMaruyama(), dt=dt,
                      saveat=jnp.asarray(LV_TS), key=KEY,
                      sensealg=getattr(J, rule)())
        return jnp.sum((sol.ys - 1.0) ** 2)
    return loss


def lv_loss_p(rule, dt):
    def loss(p):
        prob = P.SDEProblem(lv_p, lambda u, pp, t: 0.1 * u, ten([1.0, 1.0]),
                            (0.0, 1.0), p)
        sol = P.solve(prob, P.EulerMaruyama(), dt=dt, saveat=LV_TS,
                      key=JaxKey(KEY), sensealg=getattr(P, rule)())
        return torch.sum((sol.ys - 1.0) ** 2)
    return loss


@pytest.mark.parametrize("rule,dt", [("DirectAdjoint", 1e-2),
                                     ("InterpolatingAdjoint", 1e-2),
                                     ("BacksolveAdjoint", 1e-3)])
def test_lv_sde_rules_match_jax(rule, dt):
    """tests/test_sde.py's direct_adjoint_vs_fd, interpolating_adjoint_exact
    and backsolve_adjoint_close: each rule's gradient against JAX's same
    rule on the same path (1e-10); Interpolating equals the port's Direct
    to 1e-10, Backsolve (dt 1e-3, reconstructed and snapped at 6 save
    nodes) is within JAX's 2e-2 of it."""
    g_j = np.asarray(jax.jit(jax.grad(lv_loss_j(rule, dt)))(
        jnp.asarray(LV_P)))
    (g,) = grad_of(lv_loss_p(rule, dt), LV_P)
    assert rel(g, g_j) <= TOL
    if rule != "DirectAdjoint":
        (g_d,) = grad_of(lv_loss_p("DirectAdjoint", dt), LV_P)
        tol = 1e-10 if rule == "InterpolatingAdjoint" else 2e-2
        np.testing.assert_allclose(g, g_d, rtol=tol)


# -- statistics and exact solutions, the port alone ---------------------------


def test_gbm_weak_mean():
    """E[X(T)] = X0·exp(μT) over 4000 paths at dt 1e-3 (JAX: 4000 keys
    under vmap; here one solve of a 4000-entry diagonal state)."""
    mu, sigma, T = 0.3, 0.4, 1.0
    prob = P.SDEProblem(lambda u, p, t: p[0] * u, lambda u, p, t: p[1] * u,
                        torch.ones(4000, dtype=DT), (0.0, T), ten([mu, sigma]))
    vals = P.solve(prob, P.EulerMaruyama(), dt=1e-3, key=42).ys[-1]
    assert np.isclose(float(vals.mean()), np.exp(mu * T), rtol=2e-2)


def test_milstein_strong_order_vs_exact_gbm():
    """Strong order 1 against GBM's exact solution on the same increments
    (200 paths as one diagonal state): the error ratio over a tenfold dt
    refinement exceeds 5."""
    mu, sigma, T = 0.2, 0.5, 1.0
    key = P.PRNGKey(42)

    def path_err(dt):
        prob = P.SDEProblem(lambda u, p, t: p[0] * u, lambda u, p, t: p[1] * u,
                            torch.ones(200, dtype=DT), (0.0, T),
                            ten([mu, sigma]))
        sol = P.solve(prob, P.Milstein(), dt=dt, key=key)
        n = int(round(T / dt))
        WT = sum(grid_increment(key, i, (200,), dt, "cpu") for i in range(n))
        exact = torch.exp((mu - 0.5 * sigma ** 2) * T + sigma * WT)
        return float((sol.ys[-1] - exact).abs().mean())

    e1, e2 = path_err(1e-2), path_err(1e-3)
    assert e1 / e2 > 5.0, (e1, e2)


def test_ito_stratonovich_consistency():
    """The Itô problem by EulerMaruyama and by EulerHeun (through the
    drift transform) agree pathwise at dt 1e-3 (JAX: 2e-4; rtol 2e-2);
    both schemes match JAX's on the same path at dt 1e-2 (1e-10)."""
    p = ten([0.2, 0.5])
    prob = P.SDEProblem(lambda u, pp, t: pp[0] * u, lambda u, pp, t: pp[1] * u,
                        ten([1.0]), (0.0, 1.0), p, interpretation="ito")
    a = P.solve(prob, P.EulerMaruyama(), dt=1e-3, key=42).ys[-1, 0]
    b = P.solve(prob, P.EulerHeun(), dt=1e-3, key=42).ys[-1, 0]
    assert np.isclose(float(a), float(b), rtol=2e-2)
    jprob = J.SDEProblem(lambda u, pp, t: pp[0] * u,
                         lambda u, pp, t: pp[1] * u, jnp.array([1.0]),
                         (0.0, 1.0), jnp.array([0.2, 0.5]))
    for js, ps in ((J.EulerMaruyama(), P.EulerMaruyama()),
                   (J.EulerHeun(), P.EulerHeun())):
        ref = J.solve(jprob, js, dt=1e-2, key=KEY).ys
        got = P.solve(prob, ps, dt=1e-2, key=JaxKey(KEY)).ys
        assert rel(got, ref) <= TOL


def test_sde_u0_gradient():
    """dL/du0 under Direct and Interpolating against JAX's (key 7)."""
    key = jax.random.PRNGKey(7)

    def j_loss(u0):
        prob = J.SDEProblem(lambda u, p, t: -u,
                            lambda u, p, t: 0.2 * jnp.ones_like(u), u0,
                            (0.0, 1.0), None)
        sol = J.solve(prob, J.EulerMaruyama(), dt=1e-2, key=key,
                      sensealg=J.DirectAdjoint())
        return jnp.sum(sol.ys[-1] ** 2)

    g_j = np.asarray(jax_o0(jax.grad(j_loss), jnp.array([1.0, -0.5])))
    for rule in ("DirectAdjoint", "InterpolatingAdjoint"):
        def loss(u0, rule=rule):
            prob = P.SDEProblem(lambda u, p, t: -u,
                                lambda u, p, t: 0.2 * torch.ones_like(u), u0,
                                (0.0, 1.0), None)
            sol = P.solve(prob, P.EulerMaruyama(), dt=1e-2, key=JaxKey(key),
                          sensealg=getattr(P, rule)())
            return torch.sum(sol.ys[-1] ** 2)

        (g,) = grad_of(loss, [1.0, -0.5])
        assert rel(g, g_j) <= TOL


G_MIX = np.array([[0.1, 0.0], [0.05, 0.2]])


def test_scalar_and_general_noise():
    """Scalar noise (one shared process) and general (n, m) noise: shapes,
    values and the general-noise gradient against JAX's (key 3)."""
    key = jax.random.PRNGKey(3)
    ps = P.SDEProblem(lambda u, p, t: -u,
                      lambda u, p, t: 0.3 * torch.ones_like(u),
                      ten([1.0, 2.0]), (0.0, 0.5), None, noise="scalar")
    js = J.SDEProblem(lambda u, p, t: -u,
                      lambda u, p, t: 0.3 * jnp.ones_like(u),
                      jnp.array([1.0, 2.0]), (0.0, 0.5), None, noise="scalar")
    sol_s = P.solve(ps, P.EulerMaruyama(), dt=1e-2, key=JaxKey(key))
    assert tuple(sol_s.ys.shape) == (2, 2)
    assert rel(sol_s.ys, J.solve(js, J.EulerMaruyama(), dt=1e-2,
                                 key=key).ys) <= TOL

    def j_loss(u0):
        pr = J.SDEProblem(lambda u, p, t: -u,
                          lambda u, p, t: jnp.asarray(G_MIX), u0, (0.0, 0.5),
                          None, noise="general", noise_dim=2)
        return jnp.sum(J.solve(pr, J.EulerMaruyama(), dt=1e-2,
                               key=key).ys ** 2)

    def loss(u0):
        pr = P.SDEProblem(lambda u, p, t: -u, lambda u, p, t: ten(G_MIX), u0,
                          (0.0, 0.5), None, noise="general", noise_dim=2)
        sol = P.solve(pr, P.EulerMaruyama(), dt=1e-2, key=JaxKey(key))
        assert tuple(sol.ys.shape) == (2, 2)
        return torch.sum(sol.ys ** 2)

    (g,) = grad_of(loss, [1.0, 2.0])
    assert np.all(np.isfinite(g))
    assert rel(g, jax_o0(jax.grad(j_loss), jnp.array([1.0, 2.0]))) <= TOL


def test_implicit_em_stiff_sde():
    """dX = −50X dt + 0.1 dW at dt 0.05: EulerMaruyama blows up, ImplicitEM
    stays stable; ImplicitEM's gradient (dt 0.01 on (0, 0.2)) against
    JAX's on the same path."""
    prob = P.SDEProblem(lambda u, p, t: -50.0 * u,
                        lambda u, p, t: 0.1 * torch.ones_like(u), ten([1.0]),
                        (0.0, 2.0), None)
    sol_exp = P.solve(prob, P.EulerMaruyama(), dt=0.05, key=42)
    sol_imp = P.solve(prob, P.ImplicitEM(), dt=0.05, key=42)
    assert not np.all(np.abs(sol_exp.ys[-1].numpy()) < 1.0)
    assert np.all(np.abs(sol_imp.ys[-1].numpy()) < 0.5)

    def j_loss(u0):
        pr = J.SDEProblem(lambda u, p, t: -50.0 * u,
                          lambda u, p, t: 0.1 * jnp.ones_like(u), u0,
                          (0.0, 0.2), None)
        return jnp.sum(J.solve(pr, J.solvers.sde.ImplicitEM(), dt=0.01,
                               key=KEY).ys ** 2)

    def loss(u0):
        pr = P.SDEProblem(lambda u, p, t: -50.0 * u,
                          lambda u, p, t: 0.1 * torch.ones_like(u), u0,
                          (0.0, 0.2), None)
        return torch.sum(P.solve(pr, P.ImplicitEM(), dt=0.01,
                                 key=JaxKey(KEY)).ys ** 2)

    (g,) = grad_of(loss, [1.0])
    assert np.all(np.isfinite(g))
    assert rel(g, jax_o0(jax.grad(j_loss), jnp.array([1.0]))) <= TOL


def test_bfloat16_forward():
    """The bfloat16 neural-ODE forward on the fixed grid (JAX's weights,
    carried across as numpy): bfloat16 rows, finite, and within bfloat16's
    rounding (2e-2 relative) of JAX's."""
    from scimlsensitivity_jl_tpu.models.neural_ode import mlp_apply as j_mlp
    from scimlsensitivity_jl_tpu.models.neural_ode import mlp_init as j_init
    from scimlsensitivity_jl_tpu_torch.models.neural_ode import mlp_apply
    from scimlsensitivity_jl_tpu_torch.utils.pytree import from_numpy_tree

    params = j_init(jax.random.PRNGKey(0), (2, 16, 2), jnp.bfloat16)
    u0 = jnp.array([1.0, 0.5], jnp.bfloat16)
    ref = J.solve(J.ODEProblem(lambda u, p, t: j_mlp(p, jnp.tanh(u)), u0,
                               (0.0, 1.0), params), J.Tsit5(), dt=1.0 / 32,
                  adaptive=False).ys
    pp = from_numpy_tree({k: np.asarray(v) for k, v in params.items()},
                         "cpu", torch.bfloat16)
    sol = P.solve(P.ODEProblem(lambda u, p, t: mlp_apply(p, torch.tanh(u)),
                               torch.tensor([1.0, 0.5], dtype=torch.bfloat16),
                               (0.0, 1.0), pp), P.Tsit5(), dt=1.0 / 32,
                  adaptive=False)
    assert sol.ys.dtype == torch.bfloat16
    ys = sol.ys.float().numpy()
    assert np.all(np.isfinite(ys))
    assert rel(ys, np.asarray(ref, np.float32)) <= 2e-2


def test_adaptive_sde_vbt():
    """Adaptive EulerMaruyama on the port's own tree: GBM against its exact
    solution on the same W(T) read from a tree of the same key (rtol 1e-5,
    JAX: 3e-3), and the gradient against GBM's exact pathwise gradient
    (rtol 1e-4, JAX: 2e-2)."""
    mu, sigma = 0.2, 0.3
    key = P.PRNGKey(9)

    def solve(p, **kw):
        prob = P.SDEProblem(lambda u, pp, t: pp[0] * u,
                            lambda u, pp, t: pp[1] * u, ten([1.0]),
                            (0.0, 1.0), p)
        return P.solve(prob, saveat=[0.0, 1.0], key=key, **kw)

    sol = solve(ten([mu, sigma]), rtol=1e-5, atol=1e-8, max_steps=8192)
    assert sol.retcode == 0
    vbt = P.VirtualBrownianTree.create(key, 0.0, 1.0, shape=(1,), depth=28,
                                       dtype=DT, device="cpu")
    WT = float(vbt(1.0)[0])
    exact = float(np.exp((mu - 0.5 * sigma ** 2) + sigma * WT))
    assert np.isclose(float(sol.ys[-1, 0]), exact, rtol=3e-3)

    p = ten([mu, sigma]).requires_grad_()
    s = solve(p, rtol=1e-4, atol=1e-7, max_steps=4096)
    (g,) = torch.autograd.grad(s.ys[-1, 0], p)
    uT = float(s.ys[-1, 0])
    assert np.isclose(float(g[0]), uT, rtol=2e-2)
    assert np.isclose(float(g[1]), uT * (WT - sigma), rtol=2e-2)


def test_adaptive_sde_float32_state():
    """Adaptive EulerMaruyama with a float32 state (float32 times): GBM at
    test_adaptive_sde_vbt's tolerances ends with retcode 0 and within its
    3e-3 of the exact solution on the same tree. At depth 28 a leaf is
    narrower than float32's spacing of times near 1, so tb − ta rounds to
    0; the JAX package's tree divides by max(tb − ta, 1e-300), which is 0
    in float32, and reads NaN there (its solve ends at MaxIters), where
    the port's divides by float32's smallest normal and reads W(ta)."""
    mu, sigma = 0.2, 0.3
    key = P.PRNGKey(9)
    prob = P.SDEProblem(lambda u, pp, t: pp[0] * u,
                        lambda u, pp, t: pp[1] * u,
                        torch.ones(1, dtype=torch.float32), (0.0, 1.0),
                        torch.tensor([mu, sigma], dtype=torch.float32))
    sol = P.solve(prob, saveat=[0.0, 1.0], key=key, rtol=1e-5, atol=1e-8,
                  max_steps=8192)
    assert sol.retcode == 0
    vbt = P.VirtualBrownianTree.create(key, 0.0, 1.0, shape=(1,), depth=28,
                                       dtype=torch.float32, device="cpu")
    WT = float(vbt(1.0)[0])
    exact = float(np.exp((mu - 0.5 * sigma ** 2) + sigma * WT))
    assert np.isclose(float(sol.ys[-1, 0]), exact, rtol=3e-3)


def test_sra1_weak_order2_ou():
    """OU at dt 1/16 over 16384 paths (one diagonal state): SRA1's mean
    and variance within JAX's bounds, and closer than EulerMaruyama's."""
    theta, sigma, T, dt = 3.0, 1.0, 1.0, 1.0 / 16

    def run(solver):
        prob = P.SDEProblem(lambda u, p, t: -p[0] * u,
                            lambda u, p, t: p[1] * torch.ones_like(u),
                            torch.ones(16384, dtype=DT), (0.0, T),
                            ten([theta, sigma]))
        return P.solve(prob, solver, dt=dt, key=7).ys[-1].numpy()

    xs_sra, xs_em = run(P.SRA1()), run(P.EulerMaruyama())
    mean_exact = float(np.exp(-theta * T))
    var_exact = sigma ** 2 * (1 - np.exp(-2 * theta * T)) / (2 * theta)
    m_sra, v_sra = xs_sra.mean(), xs_sra.var()
    m_em, v_em = xs_em.mean(), xs_em.var()
    assert abs(m_sra - mean_exact) < 8e-3, (m_sra, mean_exact)
    assert abs(v_sra - var_exact) < 1e-2, (v_sra, var_exact)
    assert abs(m_em - mean_exact) > abs(m_sra - mean_exact)
    assert abs(v_em - var_exact) > abs(v_sra - var_exact)


def test_sra1_time_dependent_g():
    """dX = −θX dt + σ(1 + t) dW over 16384 paths: SRA1's moments against
    the exact variance (JAX's bounds)."""
    theta, sigma, T = 2.0, 0.5, 1.0
    prob = P.SDEProblem(lambda u, p, t: -p[0] * u,
                        lambda u, p, t: p[1] * (1.0 + t) * torch.ones_like(u),
                        torch.zeros(16384, dtype=DT), (0.0, T),
                        ten([theta, sigma]))
    xs = P.solve(prob, P.SRA1(), dt=1.0 / 16, key=11).ys[-1].numpy()
    s = np.linspace(0.0, T, 100001)
    var_exact = sigma ** 2 * np.trapezoid(
        np.exp(-2 * theta * (T - s)) * (1 + s) ** 2, s)
    assert abs(xs.mean()) < 8e-3
    assert abs(xs.var() - var_exact) < 1.5e-2, (xs.var(), var_exact)


def test_sra1_deterministic_drift_order2():
    """g ≡ 0: SRA1 is Ralston's RK2, order 2 on the logistic ODE."""
    def run(dt):
        prob = P.SDEProblem(lambda u, p, t: u * (1.0 - u),
                            lambda u, p, t: torch.zeros_like(u), ten([0.1]),
                            (0.0, 2.0), None)
        return float(P.solve(prob, P.SRA1(), dt=dt, key=42).ys[-1, 0])

    exact = 0.1 * np.exp(2.0) / (1 - 0.1 + 0.1 * np.exp(2.0))
    e1, e2 = abs(run(1.0 / 8) - exact), abs(run(1.0 / 16) - exact)
    assert e1 / e2 > 3.4, (e1, e2)


def test_sra1_gradient_vs_fd():
    """SRA1 under DirectAdjoint with a time-dependent g: the gradient
    against JAX's on the same path (dt 1/32)."""
    def j_loss(p):
        prob = J.SDEProblem(lambda u, q, t: -q[0] * u,
                            lambda u, q, t: q[1] * (1.0 + 0.5 * t)
                            * jnp.ones_like(u), jnp.array([1.0]), (0.0, 1.0),
                            p)
        return jnp.sum(J.solve(prob, J.SRA1(), dt=1.0 / 32, key=KEY,
                               sensealg=J.DirectAdjoint()).ys[-1] ** 2)

    def loss(p):
        prob = P.SDEProblem(lambda u, q, t: -q[0] * u,
                            lambda u, q, t: q[1] * (1.0 + 0.5 * t)
                            * torch.ones_like(u), ten([1.0]), (0.0, 1.0), p)
        return torch.sum(P.solve(prob, P.SRA1(), dt=1.0 / 32, key=JaxKey(KEY),
                                 sensealg=P.DirectAdjoint()).ys[-1] ** 2)

    (g,) = grad_of(loss, [1.5, 0.3])
    assert rel(g, jax_o0(jax.grad(j_loss), jnp.array([1.5, 0.3]))) <= TOL


# -- observed paths -----------------------------------------------------------


def _observed(seed, n_steps, dt):
    from scimlsensitivity_jl_tpu.ops.brownian import grid_path

    ts = np.arange(n_steps + 1) * dt
    return ts, np.asarray(grid_path(jax.random.PRNGKey(seed), n_steps, (1,),
                                    dt))


def test_noise_grid_user_supplied_path():
    """A NoiseGrid path: the trajectory equals the EulerMaruyama recursion
    over its increments (1e-12), the Interpolating gradient JAX's (which
    JAX holds to forward mode), and a grid that is not the solve's is
    refused."""
    ts_nodes, W = _observed(7, 100, 0.01)
    saveat = np.linspace(0.0, 1.0, 11)

    def prob(p, ng):
        return P.SDEProblem(lambda u, pp, t: pp[0] * u,
                            lambda u, pp, t: pp[1] * u, ten([1.0]),
                            (0.0, 1.0), p, noise_process=ng)

    ng = P.NoiseGrid(ts=ts_nodes, W=W)
    sol = P.solve(prob(ten([0.5, 0.3]), ng), dt=0.01, saveat=saveat)
    u = 1.0
    for i in range(100):
        u = u + 0.5 * u * 0.01 + 0.3 * u * float(W[i + 1, 0] - W[i, 0])
    assert abs(u - float(sol.ys[-1, 0])) < 1e-12

    def j_loss(pp):
        pr = J.SDEProblem(lambda u, q, t: q[0] * u, lambda u, q, t: q[1] * u,
                          jnp.array([1.0]), (0.0, 1.0), pp,
                          noise_process=J.NoiseGrid(ts=jnp.asarray(ts_nodes),
                                                    W=jnp.asarray(W)))
        return jnp.sum(J.solve(pr, dt=0.01, saveat=jnp.asarray(saveat),
                               sensealg=J.InterpolatingAdjoint()).ys ** 2)

    (g,) = grad_of(lambda p: torch.sum(P.solve(
        prob(p, ng), dt=0.01, saveat=saveat,
        sensealg=P.InterpolatingAdjoint()).ys ** 2), [0.5, 0.3])
    assert rel(g, jax_o0(jax.grad(j_loss), jnp.array([0.5, 0.3]))) <= TOL
    with pytest.raises(ValueError, match="solve grid"):
        P.solve(prob(ten([0.5, 0.3]), P.NoiseGrid(ts=ts_nodes + 0.005, W=W)),
                dt=0.01, saveat=saveat)


def test_noise_callable_path():
    """A callable W(t) (a VirtualBrownianTree, on JAX's tree draws) drives
    the solve: finite, and JAX's trajectory (1e-10)."""
    vj = J.VirtualBrownianTree.create(jax.random.PRNGKey(3), 0.0, 1.0,
                                      shape=(1,))
    vp = P.VirtualBrownianTree.create(JaxKey(jax.random.PRNGKey(3)), 0.0, 1.0,
                                      shape=(1,), device="cpu")
    saveat = np.linspace(0.0, 1.0, 5)
    ref = J.solve(J.SDEProblem(lambda u, pp, t: pp[0] * u,
                               lambda u, pp, t: pp[1] * u, jnp.array([1.0]),
                               (0.0, 1.0), jnp.array([0.5, 0.3]),
                               noise_process=lambda t: vj(t)),
                  dt=0.01, saveat=jnp.asarray(saveat)).ys
    ys = P.solve(P.SDEProblem(lambda u, pp, t: pp[0] * u,
                              lambda u, pp, t: pp[1] * u, ten([1.0]),
                              (0.0, 1.0), ten([0.5, 0.3]), noise_process=vp),
                 dt=0.01, saveat=saveat).ys
    assert np.all(np.isfinite(ys.numpy()))
    assert rel(ys, ref) <= TOL


def test_vbt_keeps_one_walk_of_nodes():
    """A tree keeps its queries' results and the nodes of the last query's
    walk, no more: after 40 queries in shuffled order it holds `depth`
    nodes and 40 results, and each W equals, bit for bit, that of a fresh
    tree of the same key, which draws every node of its walk."""
    ts = np.random.default_rng(0).permutation(np.linspace(0.0, 1.0, 40))

    def tree():
        return P.VirtualBrownianTree.create(P.PRNGKey(5), 0.0, 1.0,
                                            shape=(3,), depth=28, dtype=DT,
                                            device="cpu")

    vbt = tree()
    ws = [vbt(t) for t in ts]
    assert len(vbt._path) == 28 and len(vbt._memo) == 40
    for t, w in zip(ts, ws):
        assert torch.equal(w, tree()(t))


def test_rode_noise_process():
    """RODE on a NoiseGrid path: the Euler recursion (1e-12), and the
    Interpolating gradient JAX's."""
    ts_nodes, W = _observed(5, 100, 0.01)
    ng = P.NoiseGrid(ts=ts_nodes, W=W)
    saveat = [0.0, 0.5, 1.0]

    def prob(p):
        return P.RODEProblem(lambda u, q, t, w: -q[0] * u + q[1] * w,
                             ten([1.0]), (0.0, 1.0), p, noise_process=ng)

    sol = P.solve(prob(ten([1.0, 0.5])), dt=0.01, saveat=saveat)
    u = 1.0
    for i in range(100):
        u = u + 0.01 * (-1.0 * u + 0.5 * float(W[i, 0]))
    assert abs(u - float(sol.ys[-1, 0])) < 1e-12

    def j_loss(pp):
        pr = J.RODEProblem(lambda u, q, t, w: -q[0] * u + q[1] * w,
                           jnp.array([1.0]), (0.0, 1.0), pp,
                           noise_process=J.NoiseGrid(ts=jnp.asarray(ts_nodes),
                                                     W=jnp.asarray(W)))
        return jnp.sum(J.solve(pr, dt=0.01, saveat=jnp.asarray(saveat),
                               sensealg=J.InterpolatingAdjoint()).ys ** 2)

    (g,) = grad_of(lambda p: torch.sum(P.solve(
        prob(p), dt=0.01, saveat=saveat,
        sensealg=P.InterpolatingAdjoint()).ys ** 2), [1.0, 0.5])
    assert rel(g, jax_o0(jax.grad(j_loss), jnp.array([1.0, 0.5]))) <= TOL


def test_traced_saveat_misalignment_poisons_values_and_gradient():
    """JAX poisons off-grid save rows with NaN under jit, where its save
    times are traced; the port's save times are host values, so an
    off-grid time raises as JAX's eager solve does (a deliberate
    divergence, ROADMAP §3), and on-grid rows match JAX's."""
    def jrun(saveat):
        prob = J.SDEProblem(lambda u, pp, t: pp[0] * u,
                            lambda u, pp, t: 0.2 * u, jnp.array([1.0]),
                            (0.0, 1.0), jnp.array([0.3]))
        return J.solve(prob, dt=0.1, saveat=saveat, key=KEY,
                       sensealg=J.BacksolveAdjoint()).ys

    def prun(saveat):
        prob = P.SDEProblem(lambda u, pp, t: pp[0] * u,
                            lambda u, pp, t: 0.2 * u, ten([1.0]), (0.0, 1.0),
                            ten([0.3]))
        return P.solve(prob, dt=0.1, saveat=saveat, key=JaxKey(KEY),
                       sensealg=P.BacksolveAdjoint()).ys

    good = [0.0, 0.5, 1.0]
    assert rel(prun(good), jax.jit(jrun)(jnp.asarray(good))) <= TOL
    off = [0.0, 0.437, 1.0]
    with pytest.raises(ValueError, match="dt grid"):
        jrun(jnp.asarray(off))
    with pytest.raises(ValueError, match="dt grid"):
        prun(off)


# -- callbacks ------------------------------------------------------------------


def test_sde_preset_dose_gradient_vs_fd():
    """Preset doses at grid nodes (u ← u·p₂ at 0.25 and 0.5): the Direct
    gradient against JAX's on the same path, and the dose factor flows."""
    def j_loss(p):
        prob = J.SDEProblem(lambda u, pp, t: -pp[0] * u,
                            lambda u, pp, t: pp[1] * u, jnp.array([1.0]),
                            (0.0, 1.0), p)
        cb = J.PresetTimeCallback([0.25, 0.5], lambda u, pp, t: u * pp[2])
        s = J.solve(prob, J.EulerMaruyama(), dt=0.01, key=KEY, callback=cb,
                    saveat=jnp.array([0.0, 0.5, 1.0]),
                    sensealg=J.DirectAdjoint())
        return jnp.sum(s.ys ** 2)

    def loss(p):
        prob = P.SDEProblem(lambda u, pp, t: -pp[0] * u,
                            lambda u, pp, t: pp[1] * u, ten([1.0]),
                            (0.0, 1.0), p)
        cb = P.PresetTimeCallback([0.25, 0.5], lambda u, pp, t: u * pp[2])
        s = P.solve(prob, P.EulerMaruyama(), dt=0.01, key=JaxKey(KEY),
                    callback=cb, saveat=[0.0, 0.5, 1.0],
                    sensealg=P.DirectAdjoint())
        return torch.sum(s.ys ** 2)

    (g,) = grad_of(loss, [0.8, 0.3, 0.6])
    # JAX's preset doses need concrete times: its reference runs eagerly
    assert rel(g, jax.grad(j_loss)(jnp.array([0.8, 0.3, 0.6]))) <= TOL
    assert abs(g[2]) > 1e-6


def test_sde_discrete_callback_interpolating_matches_direct():
    """A state-dependent discrete callback: Direct and Interpolating
    against JAX's Direct on the same path, and the affect parameter
    flows."""
    def j_loss(p):
        prob = J.SDEProblem(lambda u, pp, t: pp[0] * u,
                            lambda u, pp, t: 0.2 * u, jnp.array([1.0]),
                            (0.0, 1.0), p)
        cb = J.DiscreteCallback(
            condition=lambda u, pp, t: (t > 0.5) & (u[0] > 1.1),
            affect=lambda u, pp, t: u * pp[1])
        return J.solve(prob, J.EulerMaruyama(), dt=0.01, key=KEY,
                       callback=cb, sensealg=J.DirectAdjoint()).ys[-1, 0]

    g_j = jax_o0(jax.grad(j_loss), jnp.array([0.4, 0.97]))
    for rule in ("DirectAdjoint", "InterpolatingAdjoint"):
        def loss(p, rule=rule):
            prob = P.SDEProblem(lambda u, pp, t: pp[0] * u,
                                lambda u, pp, t: 0.2 * u, ten([1.0]),
                                (0.0, 1.0), p)
            cb = P.DiscreteCallback(
                condition=lambda u, pp, t: (u[0] > 1.1) & bool(t > 0.5),
                affect=lambda u, pp, t: u * pp[1])
            return P.solve(prob, P.EulerMaruyama(), dt=0.01, key=JaxKey(KEY),
                           callback=cb,
                           sensealg=getattr(P, rule)()).ys[-1, 0]

        (g,) = grad_of(loss, [0.4, 0.97])
        assert rel(g, g_j) <= TOL
        assert abs(g[1]) > 1e-8


def test_sde_callback_guards():
    """JAX's SDE callback scope: adaptive discrete callbacks run (Direct
    only), continuous callbacks on the grid run, Backsolve cannot invert a
    jump, terminal callbacks run under Direct (retcode 5) and raise under
    Interpolating, modifies_p runs through the p-lift and raises with an
    observed path."""
    prob = P.SDEProblem(lambda u, p, t: -p[0] * u, lambda u, p, t: 0.1 * u,
                        ten([1.0]), (0.0, 1.0), ten([1.0]))
    key = JaxKey(KEY)
    dcb = P.DiscreteCallback(condition=lambda u, p, t: t > 0.5,
                             affect=lambda u, p, t: u * 0.9)
    assert P.solve(prob, key=key, callback=dcb, rtol=1e-3,
                   atol=1e-6).success
    with pytest.raises(NotImplementedError, match="DirectAdjoint"):
        P.solve(prob, key=key, callback=dcb, rtol=1e-3, atol=1e-6,
                sensealg=P.InterpolatingAdjoint())
    ccb = P.ContinuousCallback(condition=lambda u, p, t: u[0] - 0.5,
                               affect=lambda u, p, t: u + 0.1)
    assert P.solve(prob, P.EulerMaruyama(), dt=0.1, key=key,
                   callback=ccb).success
    with pytest.raises(NotImplementedError):
        P.solve(prob, P.EulerMaruyama(), dt=0.1, key=key, callback=dcb,
                sensealg=P.BacksolveAdjoint())
    tcb = P.DiscreteCallback(condition=lambda u, p, t: t > 0.5,
                             affect=lambda u, p, t: u, terminal=True)
    assert P.solve(prob, P.EulerMaruyama(), dt=0.1, key=key,
                   callback=tcb).retcode == 5
    with pytest.raises(NotImplementedError):
        P.solve(prob, P.EulerMaruyama(), dt=0.1, key=key, callback=tcb,
                sensealg=P.InterpolatingAdjoint())
    mcb = P.DiscreteCallback(condition=lambda u, p, t: t > 0.5,
                             affect=lambda u, p, t: (u * 0.9, p),
                             modifies_p=True)
    assert P.solve(prob, P.EulerMaruyama(), dt=0.1, key=key,
                   callback=mcb).success
    W = np.zeros((11, 1))
    with pytest.raises(NotImplementedError, match="noise_process"):
        P.solve(P.SDEProblem(prob.f, prob.g, prob.u0, prob.tspan, prob.p,
                             noise_process=P.NoiseGrid(
                                 np.linspace(0.0, 1.0, 11), W)),
                P.EulerMaruyama(), dt=0.1, callback=mcb)


def _dose_p(u, pp, t):
    return u, torch.cat([(pp[0] * pp[2]).reshape(1), pp[1:]])


@pytest.mark.parametrize("noise", ["diagonal", "general"])
def test_sde_modifies_p_dose_gradient_vs_fd(noise):
    """A dose on the decay rate (p₀ ← p₀·p₂ at 0.5), p lifted into the
    state with zero drift and noise rows, dt 1/256: the Direct gradient
    against JAX's on the same path for diagonal and general noise, and
    Interpolating equal to Direct (1e-9)."""
    cb_j = J.PresetTimeCallback(
        ts=[0.5], affect=lambda u, pp, t: (u, pp.at[0].set(pp[0] * pp[2])),
        modifies_p=True)

    def j_loss(p):
        if noise == "general":
            prob = J.SDEProblem(lambda u, pp, t: -pp[0] * u,
                                lambda u, pp, t: jnp.array(
                                    [[pp[1] * u[0], 0.05 * u[0]]]),
                                jnp.array([1.0]), (0.0, 1.0), p,
                                noise="general", noise_dim=2)
        else:
            prob = J.SDEProblem(lambda u, pp, t: -pp[0] * u,
                                lambda u, pp, t: pp[1] * u, jnp.array([1.0]),
                                (0.0, 1.0), p)
        s = J.solve(prob, dt=1 / 256, key=KEY, callback=cb_j,
                    sensealg=J.DirectAdjoint())
        return jnp.sum(s.ys[-1] ** 2)

    def loss(p, rule="DirectAdjoint"):
        if noise == "general":
            prob = P.SDEProblem(lambda u, pp, t: -pp[0] * u,
                                lambda u, pp, t: torch.stack(
                                    [pp[1] * u[0], 0.05 * u[0]])[None, :],
                                ten([1.0]), (0.0, 1.0), p, noise="general",
                                noise_dim=2)
        else:
            prob = P.SDEProblem(lambda u, pp, t: -pp[0] * u,
                                lambda u, pp, t: pp[1] * u, ten([1.0]),
                                (0.0, 1.0), p)
        cb = P.PresetTimeCallback(ts=[0.5], affect=_dose_p, modifies_p=True)
        s = P.solve(prob, dt=1 / 256, key=JaxKey(KEY), callback=cb,
                    sensealg=getattr(P, rule)())
        return torch.sum(s.ys[-1] ** 2)

    p0 = [1.3, 0.2, 2.0]
    (g,) = grad_of(loss, p0)
    # JAX's preset doses need concrete times: its reference runs eagerly
    assert rel(g, jax.grad(j_loss)(jnp.asarray(p0))) <= TOL
    assert abs(g[2]) > 1e-6
    if noise == "diagonal":
        (g_i,) = grad_of(lambda p: loss(p, "InterpolatingAdjoint"), p0)
        np.testing.assert_allclose(g_i, g, rtol=1e-9)


def test_sde_modifies_p_adaptive_near_deterministic():
    """The adaptive path with a p-modifying dose at σ = 1e-4 (the port's
    own key): the gradient against central differences (5e-3) and the
    deterministic limit (JAX's bounds)."""
    def loss(p):
        prob = P.SDEProblem(lambda u, pp, t: -pp[0] * u,
                            lambda u, pp, t: pp[1] * u, ten([1.0]),
                            (0.0, 1.0), p)
        cb = P.PresetTimeCallback(ts=[0.5], affect=_dose_p, modifies_p=True)
        s = P.solve(prob, key=42, callback=cb, rtol=1e-5, atol=1e-8)
        return torch.sum(s.ys[-1] ** 2)

    p0 = np.array([1.3, 1e-4, 2.0])
    (g,) = grad_of(loss, p0)
    eps = 1e-5
    with torch.no_grad():
        for i in (0, 2):
            pp, pm = p0.copy(), p0.copy()
            pp[i] += eps
            pm[i] -= eps
            fd = (float(loss(ten(pp))) - float(loss(ten(pm)))) / (2 * eps)
            assert abs(g[i] - fd) / max(abs(fd), 1e-12) < 5e-3, (i, g[i], fd)
    a, c = p0[0], p0[2]
    u1 = np.exp(-a * 0.5) * np.exp(-a * c * 0.5)
    assert abs(g[0] - 2 * u1 ** 2 * (-(0.5 + 0.5 * c))) < 1e-2 * abs(g[0]) \
        + 1e-3
    assert abs(g[2] - 2 * u1 ** 2 * (-a * 0.5)) < 1e-2 * abs(g[2]) + 1e-3


# -- commutative matrix noise -------------------------------------------------


def test_milstein_commutative_matrix_noise_strong_vs_exact():
    """Commutative (2, 2) noise, g[:, j] = σ_j·u: Milstein(commutative=True)
    at strong order 1 against the exact solution, over 200 observed paths
    (one vmapped solve over a batch of NoiseGrids, the paths drawn from the
    port's key): a tenfold dt refinement cuts the error more than 5-fold,
    and Milstein beats EulerMaruyama (0.7x)."""
    mu, s1, s2, T = 0.15, 0.4, 0.25, 1.0
    u0 = ten([1.0, 2.0])
    p = ten([mu, s1, s2])
    key = P.PRNGKey(7)

    def g(u, pp, t):
        return torch.stack([pp[1] * u, pp[2] * u], dim=1)

    def path_err(dt, solver):
        n = int(round(T / dt))
        ts = np.arange(n + 1) * dt
        incs = torch.stack([grid_increment(key, i, (200, 2), dt, "cpu")
                            for i in range(n)], dim=1)
        W = torch.cat([incs.new_zeros(200, 1, 2), incs.cumsum(1)], dim=1)

        def one(w):
            prob = P.SDEProblem(lambda u, pp, t: pp[0] * u, g, u0, (0.0, T),
                                p, noise="general", noise_dim=2,
                                noise_process=P.NoiseGrid(ts, w))
            return P.solve(prob, solver, dt=dt).ys[-1]

        yT = torch.func.vmap(one)(W)
        WT = W[:, -1]
        exact = u0[None, :] * torch.exp(
            (mu - 0.5 * (s1 ** 2 + s2 ** 2)) * T + s1 * WT[:, :1]
            + s2 * WT[:, 1:])
        return float((yT - exact).abs().max(dim=1).values.mean())

    e1 = path_err(1e-2, P.Milstein(commutative=True))
    e2 = path_err(1e-3, P.Milstein(commutative=True))
    assert e1 / e2 > 5.0, (e1, e2)
    e_em = path_err(1e-2, P.EulerMaruyama())
    assert e1 < 0.7 * e_em, (e1, e_em)


def test_milstein_commutative_gradient_vs_forward_mode():
    """The commutative-noise Milstein step under DirectAdjoint: the
    gradient against JAX's (which JAX holds to jacfwd) on the same path."""
    key = jax.random.PRNGKey(11)

    def j_loss(pp):
        prob = J.SDEProblem(lambda u, q, t: q[0] * u,
                            lambda u, q, t: jnp.stack([q[1] * u, q[2] * u],
                                                      axis=1),
                            jnp.array([1.0, 0.5]), (0.0, 0.5), pp,
                            noise="general", noise_dim=2)
        return jnp.sum(J.solve(prob, J.Milstein(commutative=True), dt=1e-2,
                               key=key, sensealg=J.DirectAdjoint()).ys[-1]
                       ** 2)

    def loss(pp):
        prob = P.SDEProblem(lambda u, q, t: q[0] * u,
                            lambda u, q, t: torch.stack([q[1] * u, q[2] * u],
                                                        dim=1),
                            ten([1.0, 0.5]), (0.0, 0.5), pp, noise="general",
                            noise_dim=2)
        return torch.sum(P.solve(prob, P.Milstein(commutative=True), dt=1e-2,
                                 key=JaxKey(key),
                                 sensealg=P.DirectAdjoint()).ys[-1] ** 2)

    (g,) = grad_of(loss, [0.2, 0.3, 0.15])
    assert rel(g, jax_o0(jax.grad(j_loss), jnp.array([0.2, 0.3, 0.15]))) <= TOL


# -- continuous and terminal events on the grid --------------------------------


def test_sde_continuous_event_deterministic_limit():
    """g ≡ 0: decay across u = 0.5 with a kick of +1, twice on (0, 2) at dt
    1e-3; the bridged localisation gives the analytic u(2) (rtol 2e-3)."""
    cb = P.ContinuousCallback(condition=lambda u, p, t: u[0] - 0.5,
                              affect=lambda u, p, t: u + 1.0)
    prob = P.SDEProblem(lambda u, p, t: -p[0] * u, lambda u, p, t: 0.0 * u,
                        ten([1.0]), (0.0, 2.0), ten([1.0]))
    sol = P.solve(prob, P.EulerMaruyama(), dt=1e-3, key=42, callback=cb,
                  saveat=[0.0, 2.0])
    tau2 = np.log(2.0) + np.log(3.0)
    np.testing.assert_allclose(float(sol.ys[-1, 0]),
                               1.5 * np.exp(-(2.0 - tau2)), rtol=2e-3)


def test_sde_continuous_event_gradient_vs_forward():
    """A stochastic barrier event (u₀ crossing 1.3 upward, u ← u/2): Direct
    and Interpolating against JAX's Direct (which JAX holds to jacfwd) on
    the same path; dτ/dp flows through the bridge's θ."""
    key = jax.random.PRNGKey(5)
    cb_j = J.ContinuousCallback(condition=lambda u, p, t: u[0] - 1.3,
                                affect=lambda u, p, t: 0.5 * u, direction=1)

    def j_loss(p):
        prob = J.SDEProblem(lambda u, q, t: q[0] * u,
                            lambda u, q, t: q[1] * u, jnp.array([1.0]),
                            (0.0, 1.0), p)
        return jnp.sum(J.solve(prob, J.EulerMaruyama(), dt=1e-2, key=key,
                               callback=cb_j, sensealg=J.DirectAdjoint(),
                               saveat=jnp.array([0.0, 1.0])).ys[-1] ** 2)

    g_j = np.asarray(jax_o0(jax.grad(j_loss), jnp.array([0.4, 0.25])))
    assert abs(g_j[0]) > 0
    cb = P.ContinuousCallback(condition=lambda u, p, t: u[0] - 1.3,
                              affect=lambda u, p, t: 0.5 * u, direction=1)
    for rule in ("DirectAdjoint", "InterpolatingAdjoint"):
        def loss(p, rule=rule):
            prob = P.SDEProblem(lambda u, q, t: q[0] * u,
                                lambda u, q, t: q[1] * u, ten([1.0]),
                                (0.0, 1.0), p)
            return torch.sum(P.solve(
                prob, P.EulerMaruyama(), dt=1e-2, key=JaxKey(key),
                callback=cb, sensealg=getattr(P, rule)(),
                saveat=[0.0, 1.0]).ys[-1] ** 2)

        (g,) = grad_of(loss, [0.4, 0.25])
        assert rel(g, g_j) <= TOL


def test_sde_terminal_event():
    """A terminal barrier: retcode 5, τ and the held rows equal JAX's, the
    stop state on the barrier, and dτ/dp equal JAX's (key 9)."""
    key = jax.random.PRNGKey(9)
    cb_j = J.ContinuousCallback(condition=lambda u, p, t: u[0] - 1.5,
                                affect=lambda u, p, t: u, terminal=True,
                                direction=1)

    def jrun(p):
        prob = J.SDEProblem(lambda u, q, t: q[0] * u,
                            lambda u, q, t: q[1] * u, jnp.array([1.0]),
                            (0.0, 3.0), p)
        return J.solve(prob, J.EulerMaruyama(), dt=1e-2, key=key,
                       callback=cb_j, saveat=jnp.array([0.0, 1.5, 3.0]))

    cb = P.ContinuousCallback(condition=lambda u, p, t: u[0] - 1.5,
                              affect=lambda u, p, t: u, terminal=True,
                              direction=1)
    p = ten([1.2, 0.3]).requires_grad_()
    sol = P.solve(P.SDEProblem(lambda u, q, t: q[0] * u,
                               lambda u, q, t: q[1] * u, ten([1.0]),
                               (0.0, 3.0), p), P.EulerMaruyama(), dt=1e-2,
                  key=JaxKey(key), callback=cb, saveat=[0.0, 1.5, 3.0])
    ref = jrun(jnp.array([1.2, 0.3]))
    assert sol.retcode == 5 == int(ref.retcode) and sol.success
    tf = float(sol.t_final)
    assert 0.0 < tf < 3.0 and rel(tf, ref.t_final) <= TOL
    ys = sol.ys.detach().numpy()
    assert rel(ys, ref.ys) <= TOL
    for k, tk in enumerate(sol.ts.numpy()):
        if tk > tf:
            np.testing.assert_allclose(ys[k], ys[-1])
    np.testing.assert_allclose(ys[-1, 0], 1.5, rtol=2e-2)
    (g,) = torch.autograd.grad(sol.t_final, p)
    g_j = jax_o0(jax.grad(lambda q: jrun(q).t_final), jnp.array([1.2, 0.3]))
    assert rel(g, g_j) <= TOL and abs(float(g[0])) > 1e-3


def test_sde_terminal_event_wrong_sensealg_raises():
    cb = P.ContinuousCallback(condition=lambda u, p, t: u[0] - 1.5,
                              affect=lambda u, p, t: u, terminal=True)
    prob = P.SDEProblem(lambda u, q, t: q[0] * u, lambda u, q, t: q[1] * u,
                        ten([1.0]), (0.0, 3.0), ten([1.2, 0.3]))
    with pytest.raises(NotImplementedError, match="DirectAdjoint"):
        P.solve(prob, P.EulerMaruyama(), dt=1e-2, key=42, callback=cb,
                sensealg=P.InterpolatingAdjoint())


def _forward_mode_grad(loss, p0):
    """∂loss/∂p by forward-mode AD (dual tensors), one direction per
    parameter: the realised grid's host decisions read primal values, so
    each pass follows the reverse pass's grid."""
    import torch.autograd.forward_ad as fwAD

    out = []
    for i in range(len(p0)):
        with fwAD.dual_level():
            tangent = torch.zeros(len(p0), dtype=DT)
            tangent[i] = 1.0
            val = loss(fwAD.make_dual(ten(p0), tangent))
            out.append(float(fwAD.unpack_dual(val).tangent))
    return np.array(out)


def test_adaptive_sde_callbacks_dose_and_discrete():
    """A preset dose (u ← u + p₂ at 0.5) and a discrete clamp on the
    adaptive path (the port's own tree): the dose shows at its save row,
    and the reverse gradient equals forward mode on the same grid
    (rtol 1e-6)."""
    dose = P.PresetTimeCallback(ts=[0.5], affect=lambda u, p, t: u + p[2])
    clamp = P.DiscreteCallback(condition=lambda u, p, t: u[0] > 2.0,
                               affect=lambda u, p, t: 0.9 * u)

    def solve(p):
        prob = P.SDEProblem(lambda u, q, t: q[0] * u,
                            lambda u, q, t: q[1] * u, ten([1.0]), (0.0, 1.0),
                            p)
        return P.solve(prob, key=3, callback=[dose, clamp], rtol=1e-3,
                       atol=1e-6, saveat=[0.0, 0.5, 1.0],
                       sensealg=P.DirectAdjoint())

    p0 = [0.6, 0.3, 0.7]
    sol = solve(ten(p0))
    assert sol.retcode == 0 and float(sol.ys[1, 0]) > 1.5
    (g,) = grad_of(lambda p: torch.sum(solve(p).ys[-1] ** 2), p0)
    g_fwd = _forward_mode_grad(lambda p: torch.sum(solve(p).ys[-1] ** 2), p0)
    np.testing.assert_allclose(g, g_fwd, rtol=1e-6)
    assert abs(g[2]) > 0.1


def test_adaptive_sde_callbacks_wrong_sensealg_raises():
    dose = P.PresetTimeCallback(ts=[0.5], affect=lambda u, p, t: u + 1.0)
    prob = P.SDEProblem(lambda u, q, t: q[0] * u, lambda u, q, t: q[1] * u,
                        ten([1.0]), (0.0, 1.0), ten([0.6, 0.3]))
    with pytest.raises(NotImplementedError, match="DirectAdjoint"):
        P.solve(prob, key=42, callback=dose, rtol=1e-3, atol=1e-6,
                sensealg=P.InterpolatingAdjoint())


# -- the direct APIs (tests/test_interface.py) --------------------------------

LV2_P = np.array([1.5, 1.0, 0.2])


def lv2_j(u, p, t):
    return jnp.array([p[0] * u[0] - p[1] * u[0] * u[1],
                      -u[1] + p[1] * u[0] * u[1]])


def lv2_p(u, p, t):
    return torch.stack([p[0] * u[0] - p[1] * u[0] * u[1],
                        -u[1] + p[1] * u[0] * u[1]])


def _dg_j(u, p, t, i):
    return 2.0 * u


def _dg_p(u, p, t, i):
    return 2.0 * u


def test_adjoint_sensitivities_sde_and_rode():
    """adjoint_sensitivities on SDE and RODE solutions replays the solve on
    the same noise: the fixed-grid SDE's (du0, dp) and the RODE's dp against
    JAX's (1e-9, as its test asserts against grad-over-solve); the
    adaptive SDE solution replays (the port's own tree: finite, nonzero)."""
    key = jax.random.PRNGKey(11)
    wts = np.arange(1.0, 7.0).reshape(3, 2)
    ts = [0.0, 0.5, 1.0]
    jprob = J.SDEProblem(lambda u, q, t: -q[0] * u, lambda u, q, t: q[1] * u,
                         jnp.array([1.0, 1.2]), (0.0, 1.0),
                         jnp.array([0.8, 0.25]))
    sol_j = J.solve(jprob, J.EulerMaruyama(), dt=0.01, key=key,
                    saveat=jnp.asarray(ts))
    ref = J.adjoint_sensitivities(
        sol_j, dgdu_discrete=lambda u, q, t, i: jnp.asarray(wts)[i],
        sensealg=J.InterpolatingAdjoint())
    pprob = P.SDEProblem(lambda u, q, t: -q[0] * u, lambda u, q, t: q[1] * u,
                         ten([1.0, 1.2]), (0.0, 1.0), ten([0.8, 0.25]))
    sol = P.solve(pprob, P.EulerMaruyama(), dt=0.01, key=JaxKey(key),
                  saveat=ts)
    du0, dp = P.adjoint_sensitivities(
        sol, dgdu_discrete=lambda u, q, t, i: ten(wts[i]),
        sensealg=P.InterpolatingAdjoint())
    assert rel(du0, ref[0]) <= 1e-9 and rel(dp, ref[1]) <= 1e-9

    sol_a = P.solve(pprob, key=11, saveat=[0.0, 1.0], rtol=1e-3, atol=1e-6)
    _, dpa = P.adjoint_sensitivities(
        sol_a, dgdu_discrete=lambda u, q, t, i: ten(wts[i]))
    assert np.isfinite(dpa.numpy()).all() and float(dpa.abs().sum()) > 1e-8

    rj = J.solve(J.RODEProblem(lambda u, q, t, W: -q[0] * u + q[1] * W,
                               jnp.array([1.0]), (0.0, 1.0),
                               jnp.array([0.8, 0.25])),
                 dt=0.01, key=key, saveat=jnp.array([0.0, 1.0]))
    _, rdp_j = J.adjoint_sensitivities(
        rj, dgdu_discrete=lambda u, q, t, i: jnp.where(i == 1, 2.0 * u,
                                                       jnp.zeros_like(u)))
    rsol = P.solve(P.RODEProblem(lambda u, q, t, W: -q[0] * u + q[1] * W,
                                 ten([1.0]), (0.0, 1.0), ten([0.8, 0.25])),
                   dt=0.01, key=JaxKey(key), saveat=[0.0, 1.0])
    _, rdp = P.adjoint_sensitivities(
        rsol, dgdu_discrete=lambda u, q, t, i: 2.0 * u if i == 1
        else torch.zeros_like(u))
    assert rel(rdp, rdp_j) <= 1e-9


def _sde_adjoint_spec_pair(interp, layout, noise, n_steps, key):
    """(JAX's, the port's) gradient from SDEAdjointProblem solved by hand
    with EulerHeun on the same path, and the port's spec."""
    if noise == "general":
        mix = np.array([[1.0, 0.3], [0.1, 0.8]])
        g_j = lambda u, p, t: p[2] * jnp.asarray(mix) * u[:, None]
        g_p = lambda u, p, t: p[2] * ten(mix) * u[:, None]
        kw = dict(noise="general", noise_dim=2)
        ts = [0.0, 1.0]
    else:
        g_j = lambda u, p, t: p[2] * u
        g_p = lambda u, p, t: p[2] * u
        kw = {}
        ts = [0.0, 0.5, 1.0]
    dt = 1.0 / n_steps
    solver_j = J.EulerHeun() if interp == "stratonovich" else \
        J.EulerMaruyama()
    solver_p = P.EulerHeun() if interp == "stratonovich" else \
        P.EulerMaruyama()
    sol_j = J.solve(J.SDEProblem(lv2_j, g_j, jnp.array([1.0, 0.8]),
                                 (0.0, 1.0), jnp.asarray(LV2_P),
                                 interpretation=interp, **kw),
                    solver_j, dt=dt, saveat=jnp.asarray(ts), key=key,
                    sensealg=J.InterpolatingAdjoint())
    spec_j = J.SDEAdjointProblem(sol_j, getattr(J, layout)(),
                                 dgdu_discrete=_dg_j)
    adj_j = J.solve(spec_j.prob, J.EulerHeun(), dt=spec_j.dt,
                    callback=spec_j.callback)
    ref = spec_j.extract(adj_j.ys[-1])
    sol = P.solve(P.SDEProblem(lv2_p, g_p, ten([1.0, 0.8]), (0.0, 1.0),
                               ten(LV2_P), interpretation=interp, **kw),
                  solver_p, dt=dt, saveat=ts, key=JaxKey(key),
                  sensealg=P.InterpolatingAdjoint())
    spec = P.SDEAdjointProblem(sol, getattr(P, layout)(), dgdu_discrete=_dg_p)
    adj = P.solve(spec.prob, P.EulerHeun(), dt=spec.dt,
                  callback=spec.callback)
    got = spec.extract(adj.ys[-1])
    return ref, got, spec


@pytest.mark.parametrize("interp", ["stratonovich", "ito"])
def test_sde_adjoint_problem_manual_solve_matches_replay(interp):
    """SDEAdjointProblem solved by hand (EulerHeun on the reversed path):
    the Backsolve layout (and Interpolating's, on the Stratonovich case)
    equals JAX's on the same path at dt 1/128 (1e-10), and at JAX's dt
    1/1024 Backsolve's gradient lies within JAX's 3e-2 / 5e-2 of the
    replayed discrete adjoint."""
    key = jax.random.PRNGKey(7)
    layouts = (("BacksolveAdjoint", "InterpolatingAdjoint")
               if interp == "stratonovich" else ("BacksolveAdjoint",))
    for layout in layouts:
        ref, got, _ = _sde_adjoint_spec_pair(interp, layout, "diagonal",
                                             128, key)
        assert rel(got[0], ref[0]) <= TOL and rel(got[1], ref[1]) <= TOL
    solver = P.EulerHeun() if interp == "stratonovich" else P.EulerMaruyama()
    sol = P.solve(P.SDEProblem(lv2_p, lambda u, p, t: p[2] * u,
                               ten([1.0, 0.8]), (0.0, 1.0), ten(LV2_P),
                               interpretation=interp),
                  solver, dt=1 / 1024, saveat=[0.0, 0.5, 1.0], key=7,
                  sensealg=P.InterpolatingAdjoint())
    replay = P.adjoint_sensitivities(sol, dgdu_discrete=_dg_p,
                                     sensealg=P.DirectAdjoint())
    spec = P.SDEAdjointProblem(sol, P.BacksolveAdjoint(), dgdu_discrete=_dg_p)
    adj = P.solve(spec.prob, P.EulerHeun(), dt=spec.dt,
                  callback=spec.callback)
    du0, dp = spec.extract(adj.ys[-1])
    np.testing.assert_allclose(du0.numpy(), replay[0].numpy(), rtol=3e-2)
    np.testing.assert_allclose(dp.numpy(), replay[1].numpy(), rtol=5e-2)


def test_sde_adjoint_problem_general_noise():
    """General (2, 2) Stratonovich noise through SDEAdjointProblem's
    Backsolve layout (endpoint costs fold into z0 and extract: no
    callback): JAX's gradient at dt 1/128 (1e-10), and the replay within
    JAX's 3e-2 / 5e-2 at dt 1/512 (JAX: 1/1024)."""
    ref, got, spec = _sde_adjoint_spec_pair(
        "stratonovich", "BacksolveAdjoint", "general", 128,
        jax.random.PRNGKey(7))
    assert spec.callback is None
    assert rel(got[0], ref[0]) <= TOL and rel(got[1], ref[1]) <= TOL
    mix = ten([[1.0, 0.3], [0.1, 0.8]])
    sol = P.solve(P.SDEProblem(lv2_p, lambda u, p, t: p[2] * mix * u[:, None],
                               ten([1.0, 0.8]), (0.0, 1.0), ten(LV2_P),
                               noise="general", noise_dim=2,
                               interpretation="stratonovich"),
                  P.EulerHeun(), dt=1 / 512, saveat=[0.0, 1.0], key=7,
                  sensealg=P.InterpolatingAdjoint())
    replay = P.adjoint_sensitivities(sol, dgdu_discrete=_dg_p,
                                     sensealg=P.DirectAdjoint())
    spec = P.SDEAdjointProblem(sol, P.BacksolveAdjoint(), dgdu_discrete=_dg_p)
    adj = P.solve(spec.prob, P.EulerHeun(), dt=spec.dt)
    du0, dp = spec.extract(adj.ys[-1])
    np.testing.assert_allclose(du0.numpy(), replay[0].numpy(), rtol=3e-2)
    np.testing.assert_allclose(dp.numpy(), replay[1].numpy(), rtol=5e-2)


def test_rode_adjoint_problem_manual_solve():
    """RODEAdjointProblem: the pathwise reverse ODE on the replayed path.
    Endpoint costs by fixed-grid Euler: JAX's gradient on the same path at
    dt 1/64 (1e-10), and the replay within JAX's 1e-2 at dt 1/512; an
    interior data time through adaptive Heun with the λ-jump callback and
    tstops, the replay within JAX's 1e-2 at dt 1/512 (JAX runs both at dt
    1/2048; its adaptive reverse with a callback cannot be compiled, and
    runs ~11 s eagerly)."""
    def f_p(u, p, t, W):
        return torch.stack([p[0] * u[0] - u[0] * u[1] + 0.3 * W[0],
                            -u[1] + p[1] * u[0] * u[1] + 0.2 * W[1] * u[1]])

    def f_j(u, p, t, W):
        return jnp.array([p[0] * u[0] - u[0] * u[1] + 0.3 * W[0],
                          -u[1] + p[1] * u[0] * u[1] + 0.2 * W[1] * u[1]])

    key = jax.random.PRNGKey(3)
    rj = J.solve(J.RODEProblem(f_j, jnp.array([1.0, 0.5]), (0.0, 1.0),
                               jnp.array([1.2, 0.6])), dt=1 / 64,
                 saveat=jnp.array([0.0, 1.0]), key=key,
                 sensealg=J.InterpolatingAdjoint())
    spec_j = J.RODEAdjointProblem(rj, J.BacksolveAdjoint(),
                                  dgdu_discrete=_dg_j)
    ref = spec_j.extract(J.solve(spec_j.prob, J.Euler(), dt=spec_j.dt,
                                 adaptive=False).ys[-1])
    rp = P.solve(P.RODEProblem(f_p, ten([1.0, 0.5]), (0.0, 1.0),
                               ten([1.2, 0.6])), dt=1 / 64, saveat=[0.0, 1.0],
                 key=JaxKey(key), sensealg=P.InterpolatingAdjoint())
    spec = P.RODEAdjointProblem(rp, P.BacksolveAdjoint(), dgdu_discrete=_dg_p)
    assert spec.callback is None
    got = spec.extract(P.solve(spec.prob, P.Euler(), dt=spec.dt,
                               adaptive=False).ys[-1])
    assert rel(got[0], ref[0]) <= TOL and rel(got[1], ref[1]) <= TOL

    prob = P.RODEProblem(f_p, ten([1.0, 0.5]), (0.0, 1.0), ten([1.2, 0.6]))
    for ts in ([0.0, 1.0], [0.0, 0.5, 1.0]):
        sol = P.solve(prob, dt=1 / 512, saveat=ts, key=3,
                      sensealg=P.InterpolatingAdjoint())
        du0_ref, dp_ref = P.adjoint_sensitivities(
            sol, dgdu_discrete=_dg_p, sensealg=P.DirectAdjoint())
        spec = P.RODEAdjointProblem(sol, P.BacksolveAdjoint(),
                                    dgdu_discrete=_dg_p)
        if len(ts) == 2:
            adj = P.solve(spec.prob, P.Euler(), dt=spec.dt, adaptive=False)
        else:
            adj = P.solve(spec.prob, P.Heun(), callback=spec.callback,
                          tstops=spec.tstops, rtol=1e-4, atol=1e-7,
                          max_steps=8192)
        assert adj.success
        du0, dp = spec.extract(adj.ys[-1])
        np.testing.assert_allclose(du0.numpy(), du0_ref.numpy(), rtol=1e-2)
        np.testing.assert_allclose(dp.numpy(), dp_ref.numpy(), rtol=1e-2)


def test_sde_adjoint_problem_rejects_adaptive_solutions():
    prob = P.SDEProblem(lambda u, p, t: -u, lambda u, p, t: 0.1 * u,
                        ten([1.0]), (0.0, 1.0), None)
    sol = P.solve(prob, rtol=1e-2, atol=1e-4, key=0)
    with pytest.raises(NotImplementedError, match="FIXED-GRID"):
        P.SDEAdjointProblem(sol, dgdu_discrete=lambda u, p, t, i: 2 * u)


def test_sde_adjoint_problem_dt_refinement_order():
    """SDEAdjointProblem's re-discretised reverse SDE converges to the
    replayed discrete adjoint at strong order ~1: the log-log slope of the
    relative error over dt = 1/64 ... 1/512 (JAX: 1/128 ... 1/1024), two
    seeds (JAX: three), exceeds 0.7, and the finest error is below JAX's
    2e-2."""
    dts = [1.0 / 64, 1.0 / 128, 1.0 / 256, 1.0 / 512]
    errs = []
    for dt in dts:
        e = 0.0
        for seed in (7, 8):
            prob = P.SDEProblem(lv2_p, lambda u, p, t: p[2] * u,
                                ten([1.0, 0.8]), (0.0, 1.0), ten(LV2_P),
                                interpretation="stratonovich")
            sol = P.solve(prob, P.EulerHeun(), dt=dt, saveat=[0.0, 0.5, 1.0],
                          key=seed, sensealg=P.InterpolatingAdjoint())
            ref = P.adjoint_sensitivities(sol, dgdu_discrete=_dg_p,
                                          sensealg=P.DirectAdjoint())
            spec = P.SDEAdjointProblem(sol, P.BacksolveAdjoint(),
                                       dgdu_discrete=_dg_p)
            adj = P.solve(spec.prob, P.EulerHeun(), dt=spec.dt,
                          callback=spec.callback)
            got = spec.extract(adj.ys[-1])
            gref = np.concatenate([ref[0].numpy(), ref[1].numpy()])
            gman = np.concatenate([got[0].numpy(), got[1].numpy()])
            e += float(np.linalg.norm(gman - gref) / np.linalg.norm(gref))
        errs.append(e / 2.0)
    slope = float(np.polyfit(np.log(dts), np.log(errs), 1)[0])
    assert slope > 0.7, (slope, errs)
    assert errs[-1] < 2e-2, errs


# -- tests/test_smoke.py and tests/test_matrix.py -----------------------------


def test_smoke_sde_fixed_grid_grad():
    """tests/test_smoke.py:79: the DirectAdjoint gradient on a short GBM
    against JAX's (which JAX holds to jacfwd), key 0."""
    key = jax.random.PRNGKey(0)

    def j_loss(p):
        prob = J.SDEProblem(lambda u, q, t: q[0] * u, lambda u, q, t: q[1] * u,
                            jnp.array([1.0]), (0.0, 0.3), p)
        return jnp.sum(J.solve(prob, J.EulerMaruyama(), dt=0.05, key=key,
                               sensealg=J.DirectAdjoint()).ys[-1])

    def loss(p):
        prob = P.SDEProblem(lambda u, q, t: q[0] * u, lambda u, q, t: q[1] * u,
                            ten([1.0]), (0.0, 0.3), p)
        return torch.sum(P.solve(prob, P.EulerMaruyama(), dt=0.05,
                                 key=JaxKey(key),
                                 sensealg=P.DirectAdjoint()).ys[-1])

    (g,) = grad_of(loss, [0.3, 0.2])
    assert rel(g, jax_o0(jax.grad(j_loss), jnp.array([0.3, 0.2]))) <= TOL


MIX3 = np.array([[1.0, 0.5, 0.0], [0.2, 1.0, 0.3]])


def test_nondiagonal_sde_noise_adjoint_vs_forward():
    """tests/test_matrix.py:144: 2 states driven by 3 Wiener processes, the
    default key and scheme; Direct and Interpolating against JAX's Direct
    (which JAX holds to forward mode)."""
    def j_loss(pp):
        prob = J.SDEProblem(lambda u, p, t: -p[0] * u,
                            lambda u, p, t: p[1] * jnp.asarray(MIX3)
                            * (1.0 + 0.1 * u[:, None]),
                            jnp.array([1.0, 0.5]), (0.0, 1.0), pp,
                            noise="general", noise_dim=3)
        return jnp.sum(J.solve(prob, None, dt=1 / 64,
                               saveat=jnp.linspace(0.0, 1.0, 5),
                               sensealg=J.DirectAdjoint()).ys ** 2)

    g_j = jax_o0(jax.grad(j_loss), jnp.array([1.0, 0.4]))
    for rule in ("DirectAdjoint", "InterpolatingAdjoint"):
        def loss(pp, rule=rule):
            prob = P.SDEProblem(lambda u, p, t: -p[0] * u,
                                lambda u, p, t: p[1] * ten(MIX3)
                                * (1.0 + 0.1 * u[:, None]),
                                ten([1.0, 0.5]), (0.0, 1.0), pp,
                                noise="general", noise_dim=3)
            return torch.sum(P.solve(prob, None, dt=1 / 64,
                                     saveat=np.linspace(0.0, 1.0, 5),
                                     key=JaxKey(jax.random.PRNGKey(0)),
                                     sensealg=getattr(P, rule)()).ys ** 2)

        (g,) = grad_of(loss, [1.0, 0.4])
        assert rel(g, g_j) <= TOL
