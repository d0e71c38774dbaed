"""Parity of the port's stiff and extrapolation solvers with the JAX
package's, in float64 on the CPU: the cases of tests/test_stiff.py
(Robertson and Van der Pol forward, Robertson's gradient under
Quadrature, Gauss and Interpolating, the SDIRK4 order conditions,
Seulex's order, Robertson and its adjoint) and GBS / Vern9Like.

JAX runs compiled at XLA optimization level 0 (`torch_parity.jax_o0`, so
both packages round op by op) and its references are cached per module.
Both packages factor W = I − h·γ·J by LAPACK's partial-pivoting getrf on
the CPU, and the step sequences here match exactly: accepted and
rejected counts and retcodes are asserted equal, states at 1e-12
relative and gradients at 1e-8. The JAX tests run at rtol 1e-8 to 1e-10
with up to 16,384 steps; to keep the port's suite inside its clock these
cases use shorter spans and rtol 1e-5 to 1e-7 (stated per test), and
hold each rule to ForwardDiffSensitivity at the bound that those
tolerances leave (stated per test). The port's stiff steps pay ~0.2 ms
per forward-mode operation on this CPU build (`torch.func.jvp`), which
sets these sizes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.integrate import solve_ivp

from torch_parity import jax_o0, lotka_volterra_jax, lotka_volterra_port

import scimlsensitivity_jl_tpu as J
import scimlsensitivity_jl_tpu_torch as P
from scimlsensitivity_jl_tpu.solvers.integrate import integrate as j_integrate
from scimlsensitivity_jl_tpu_torch.ops.vjp import ForwardModeUnsupported
from scimlsensitivity_jl_tpu_torch.solvers.integrate import (
    integrate as p_integrate)

DT = torch.float64
ROBER_P = np.array([0.04, 3e7, 1e4])
ROBER_U0 = np.array([1.0, 0.0, 0.0])


def _rober(stack):
    def f(u, p, t):
        return stack([-p[0] * u[0] + p[2] * u[1] * u[2],
                      p[0] * u[0] - p[1] * u[1] ** 2 - p[2] * u[1] * u[2],
                      p[1] * u[1] ** 2])
    return f


def _vdp(stack):
    def f(u, p, t):
        return stack([u[1], p * ((1 - u[0] ** 2) * u[1] - u[0])])
    return f


def _scipy(f, u0, p, span, ts=None):
    r = solve_ivp(lambda t, y: np.asarray(f(torch.tensor(y), p, t)), span,
                  u0, method="Radau", rtol=1e-10, atol=1e-12, t_eval=ts)
    return r.y.T


# (name, problem, span, rtol, atol)
FORWARD = [
    ("Rosenbrock23", "rober", 1.0, 1e-6, 1e-10),
    ("TRBDF2", "rober", 1.0, 1e-6, 1e-10),
    ("Kvaerno3", "rober", 1.0, 1e-6, 1e-10),
    ("SDIRK4", "rober", 1.0, 1e-6, 1e-10),
    ("Rodas4Like", "rober", 1.0, 1e-6, 1e-10),
    ("Rosenbrock23", "vdp", 0.3, 1e-6, 1e-9),
    ("TRBDF2", "vdp", 0.3, 1e-6, 1e-9),
    ("Kvaerno3", "vdp", 0.3, 1e-6, 1e-9),
    ("SDIRK4", "vdp", 0.3, 1e-6, 1e-9),
    ("GBS", "lv", 3.0, 1e-8, 1e-10),
    ("Vern9Like", "lv", 3.0, 1e-8, 1e-10),
]


def _case(mod, name, problem, stack):
    if problem == "rober":
        f, u0, p = _rober(stack), ROBER_U0, ROBER_P
    elif problem == "vdp":
        f, u0, p = _vdp(stack), np.array([2.0, 0.0]), 1e3
    else:
        f = lotka_volterra_jax if mod is J else lotka_volterra_port
        u0, p = np.array([1.0, 1.0]), np.array([1.5, 1.0, 3.0, 1.0])
    return getattr(mod, name)(), f, u0, p


@pytest.fixture(scope="module")
def forward_refs():
    """JAX's integrate per case: u_final, accepted, rejected, retcode."""
    out = {}
    for name, problem, t1, rtol, atol in FORWARD:
        solver, f, u0, p = _case(J, name, problem, jnp.stack)
        pj = jnp.asarray(p)

        def run(u, solver=solver, f=f, t1=t1, rtol=rtol, atol=atol):
            r = j_integrate(solver, lambda uv, t: f(uv, pj, t), 0.0, t1, u,
                            rtol=rtol, atol=atol, max_steps=4096,
                            store_dense=False)
            return r.u_final, r.stats.n_accepted, r.stats.n_rejected, \
                r.stats.retcode

        out[(name, problem)] = [np.asarray(x) for x in
                                jax_o0(run, jnp.asarray(u0))]
    return out


@pytest.mark.parametrize("name,problem,t1,rtol,atol", FORWARD,
                         ids=[f"{c[0]}-{c[1]}" for c in FORWARD])
def test_forward_matches_jax(forward_refs, name, problem, t1, rtol, atol):
    """Robertson on (0, 1) and Van der Pol (μ = 1e3) on (0, 0.3) at rtol
    1e-6 (the JAX tests: 1e-8 and 1e-7 on (0, 100) and (0, 0.3)), and the
    explicit GBS / Vern9Like on Lotka–Volterra: the same accepted and
    rejected steps and retcode as JAX, u_final to 1e-12, and the stiff
    cases against scipy's Radau at 1e-4 relative (the global error that
    rtol 1e-6 leaves the second-order solvers; the JAX tests' 1e-5 is at
    rtol 1e-8)."""
    solver, f, u0, p = _case(P, name, problem, torch.stack)
    pt = torch.as_tensor(p, dtype=DT)
    r = p_integrate(solver, lambda uv, t: f(uv, pt, t), 0.0, t1,
                    torch.tensor(u0, dtype=DT), rtol=rtol, atol=atol,
                    max_steps=4096, store_dense=False)
    uf, acc, rej, rc = forward_refs[(name, problem)]
    assert (r.stats.n_accepted, r.stats.n_rejected, r.stats.retcode) == (
        int(acc), int(rej), int(rc))
    np.testing.assert_allclose(r.u_final.numpy(), uf, rtol=1e-12,
                               atol=1e-12 * np.abs(uf).max())
    if problem != "lv":
        ref = _scipy(f, u0, pt, (0.0, t1))[-1]
        np.testing.assert_allclose(r.u_final.numpy(), ref, rtol=1e-4,
                                   atol=1e-8)


# -- Robertson's gradient (test_robertson_adjoint_gradient) ------------------

ADJ_TS = np.array([1e-4, 1e-3])
ADJ_KW = dict(rtol=1e-6, atol=1e-10, adj_rtol=1e-5, adj_atol=1e-8,
              max_steps=4096)
ADJ_RULES = ["QuadratureAdjoint", "GaussAdjoint", "InterpolatingAdjoint",
             "ForwardDiffSensitivity"]


def _adj_loss(mod, rule, exp, summ):
    def loss(logp):
        prob = mod.ODEProblem(_rober(jnp.stack if mod is J else torch.stack),
                              (jnp.asarray(ROBER_U0) if mod is J else
                               torch.tensor(ROBER_U0, dtype=DT)),
                              (0.0, 1e-3), exp(logp))
        sol = mod.solve(prob, mod.Rosenbrock23(), saveat=ADJ_TS,
                        sensealg=getattr(mod, rule)(), **ADJ_KW)
        return summ(sol.ys[:, 1]) * 1e4
    return loss


@pytest.fixture(scope="module")
def adjoint_refs():
    """JAX's gradient of 1e4·Σ y₂ in log p per rule, one program."""
    def grads(logp):
        return [jax.grad(_adj_loss(J, r, jnp.exp, jnp.sum))(logp)
                for r in ADJ_RULES]

    out = jax_o0(grads, jnp.log(jnp.asarray(ROBER_P)))
    return {r: np.asarray(g) for r, g in zip(ADJ_RULES, out)}


@pytest.mark.parametrize("rule", ADJ_RULES)
def test_robertson_adjoint_gradient(adjoint_refs, rule):
    """Rosenbrock23 forward and reverse (the reverse takes −(∂f/∂u)ᵀ from
    the reverse field's `.jac`) on Robertson over (0, 1e-3), its stiff
    transient, at rtol 1e-6,
    adj_rtol 1e-5 (the JAX test: (0, 10), 1e-9 and 1e-6): each rule
    against JAX's (1e-8), and each reverse rule against the port's
    ForwardDiffSensitivity, the JAX test's oracle, at 1e-3 of max|g|
    (the reverse tolerance of 1e-5 leaves that much)."""
    logp = torch.log(torch.tensor(ROBER_P, dtype=DT)).requires_grad_()
    (g,) = torch.autograd.grad(_adj_loss(P, rule, torch.exp, torch.sum)(logp),
                               logp)
    ref = adjoint_refs[rule]
    np.testing.assert_allclose(g.numpy(), ref, rtol=1e-8,
                               atol=1e-8 * np.abs(ref).max())
    oracle = adjoint_refs["ForwardDiffSensitivity"]
    np.testing.assert_allclose(g.numpy(), oracle, rtol=0,
                               atol=1e-3 * np.abs(oracle).max())


def test_sdirk4_order_conditions():
    from scimlsensitivity_jl_tpu_torch.solvers.sdirk import SDIRK4_TAB

    b = np.asarray(SDIRK4_TAB.a[-1], np.float64)
    c = np.asarray(SDIRK4_TAB.c, np.float64)
    for k in range(4):
        assert np.isclose((b * c ** k).sum(), 1.0 / (k + 1), atol=1e-14), k
    bh = b - np.asarray(SDIRK4_TAB.b_err, np.float64)
    assert np.isclose(bh.sum(), 1.0, atol=1e-14)
    assert np.isclose((bh * c).sum(), 0.5, atol=1e-14)


def test_seulex_order():
    """K levels give order K: one step on u' = u² from u(0) = 1 (u =
    1/(1 − t)), the local error ratio between h = 0.1 and 0.05 above 20
    (local order 5), and the step equal to JAX's to 1e-14."""
    from scimlsensitivity_jl_tpu.solvers.seulex import Seulex as JSeulex
    from scimlsensitivity_jl_tpu_torch.solvers.seulex import Seulex

    st = Seulex(levels=4)
    f = lambda u, t: u ** 2

    def one_step(dt):
        u0 = torch.tensor([1.0], dtype=DT)
        u1, _, _ = st.step(f, np.float64(0.0), np.float64(dt), u0, f(u0, 0.0))
        return float(u1[0])

    e1, e2 = (abs(one_step(h) - 1.0 / (1.0 - h)) for h in (0.1, 0.05))
    assert e1 / e2 > 20.0, (e1, e2)
    uj, _, _ = JSeulex(levels=4).step(f, jnp.asarray(0.0), jnp.asarray(0.1),
                                      jnp.array([1.0]), jnp.array([1.0]))
    np.testing.assert_allclose(one_step(0.1), float(uj[0]), rtol=1e-14)


def _lin_loss(mod, rule, summ, rtol):
    A = np.array([[-1.0, 1.0], [0.0, -1000.0]])

    def loss(p):
        Am = jnp.asarray(A) if mod is J else torch.tensor(A, dtype=DT)
        one = jnp.ones(2) if mod is J else torch.ones(2, dtype=DT)
        prob = mod.ODEProblem(lambda u, q, t: Am @ u + q, one, (0.0, 1.0), p)
        s = mod.solve(prob, mod.Rodas4Like(), saveat=np.array([0.5, 1.0]),
                      rtol=rtol, atol=rtol * 1e-3,
                      sensealg=getattr(mod, rule)(), max_steps=8192,
                      adj_rtol=rtol, adj_atol=rtol * 1e-3)
        return summ(s.ys ** 2)
    return loss


def test_seulex_adjoint_gradient():
    """Rodas4Like as forward and reverse stepper of InterpolatingAdjoint on
    a stiff linear system at rtol and adj_rtol 1e-5 (the JAX test: 1e-8
    and 1e-7), against JAX's (1e-8) and against ForwardDiffSensitivity at
    the same rtol (1e-4, the JAX test's bound)."""
    p0 = np.array([0.3, 0.7])
    grads = {}
    for rule in ("InterpolatingAdjoint", "ForwardDiffSensitivity"):
        pt = torch.tensor(p0, dtype=DT, requires_grad=True)
        (grads[rule],) = torch.autograd.grad(
            _lin_loss(P, rule, torch.sum, 1e-5)(pt), pt)
    ref = jax_o0(jax.grad(_lin_loss(J, "InterpolatingAdjoint", jnp.sum,
                                    1e-5)), jnp.asarray(p0))
    g = grads["InterpolatingAdjoint"].numpy()
    np.testing.assert_allclose(g, np.asarray(ref), rtol=1e-8)
    np.testing.assert_allclose(g, grads["ForwardDiffSensitivity"].numpy(),
                               rtol=1e-4)


def _mlp_fields():
    from scimlsensitivity_jl_tpu.ops.pallas_mlp import fused_mlp2 as j_mlp2
    from scimlsensitivity_jl_tpu_torch.ops.mlp import fused_mlp2 as p_mlp2

    g = np.random.default_rng(5)
    mlp = {"W0": 0.3 * g.standard_normal((2, 8)), "b0": np.zeros(8),
           "W1": 0.3 * g.standard_normal((8, 2)), "b1": np.zeros(2)}
    return (lambda u, q, t: j_mlp2(q, u), lambda u, q, t: p_mlp2(q, u),
            np.array([2.0, 0.0]), mlp)


@pytest.mark.parametrize("name", ["Rosenbrock23", "TRBDF2", "Rodas4Like",
                                  "FBDF", "newton"])
def test_stiff_solver_on_kernel_field_raises_in_both(name):
    """A stiff step takes ∂f/∂u by forward mode, which a kernel field
    refuses: the port's FusedMLP2 raises ForwardModeUnsupported by name,
    as JAX's custom_vjp field refuses jax.jvp (its tracing raises; nothing
    is compiled); so does Newton on a kernel residual."""
    f_jax, f_port, u0, mlp = _mlp_fields()
    pj = jax.tree_util.tree_map(jnp.asarray, mlp)
    pt = {k: torch.tensor(v, dtype=DT) for k, v in mlp.items()}
    if name == "newton":
        with pytest.raises(ForwardModeUnsupported, match="forward-mode"):
            P.solve_nonlinear(P.NonlinearProblem(
                lambda u, q: f_port(u, q, 0.0), torch.tensor(u0, dtype=DT),
                pt))
        run = lambda u: J.solve_nonlinear(J.NonlinearProblem(
            lambda uu, q: f_jax(uu, q, 0.0), u, pj)).u
    else:
        with pytest.raises(ForwardModeUnsupported, match="forward-mode"):
            P.solve(P.ODEProblem(f_port, torch.tensor(u0, dtype=DT),
                                 (0.0, 0.1), pt), getattr(P, name)(),
                    sensealg=P.GaussAdjoint(), max_steps=8)
        run = lambda u: J.solve(J.ODEProblem(f_jax, u, (0.0, 0.1), pj),
                                getattr(J, name)(), sensealg=J.GaussAdjoint(),
                                max_steps=8).ys
    with pytest.raises(TypeError, match="forward-mode autodiff"):
        jax.jit(run).lower(jnp.asarray(u0))
