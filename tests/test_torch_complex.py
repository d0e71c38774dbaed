"""Complex states in the port, in float64 on the CPU, against the JAX
package on the cases of tests/test_matrix.py:266-302, :330-400, :429-436
and tests/test_dispatch.py:100-124.

Conventions: for a real loss L of a complex z, torch's gradient is
∂L/∂Re z + i·∂L/∂Im z, the conjugate of JAX's (jax.grad(|z|²)(1+2j) is
2-4j, torch's 2+4j). So a complex parameter's gradient in the port is
the conjugate of JAX's, which these tests assert; a real parameter's is
real in both and equal. Each JAX reference is compiled at XLA
optimization level 0 (`torch_parity.jax_o0`), so both packages take the
same steps: the port's DirectAdjoint and GaussAdjoint against JAX's same
rule to 1e-9 relative, every other rule against JAX's rule of its kind
(discrete: DirectAdjoint, continuous: GaussAdjoint, the continuous rules
differing from one another by their reverse tolerance), and, as the JAX
tests do, against the closed form or finite differences at those tests'
tolerances."""

# the JAX rule each port rule is held to, and the tolerance when it is not
# the same rule
JAX_REF = {"DirectAdjoint": "DirectAdjoint",
           "ForwardDiffSensitivity": "DirectAdjoint"}
KIND_RTOL = 1e-7


def _ref(refs, rule):
    """(JAX's reference for `rule`, the tolerance to hold it to)."""
    name = JAX_REF.get(rule, "GaussAdjoint")
    return refs[name], (RTOL if name == rule else KIND_RTOL)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import jax_o0

import scimlsensitivity_jl_tpu as J
import scimlsensitivity_jl_tpu_torch as P

RULES = ["ForwardDiffSensitivity", "GaussAdjoint", "InterpolatingAdjoint",
         "BacksolveAdjoint", "QuadratureAdjoint", "DirectAdjoint"]
TOLS = dict(rtol=1e-10, atol=1e-12)
RTOL = 1e-9
C = torch.complex128


def _close(port, ref, rtol=RTOL, msg=""):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(port), ref, rtol=rtol,
                               atol=rtol * float(np.max(np.abs(ref))),
                               err_msg=msg)


# -- complex state, real parameter (test_matrix.py:266-302) ------------------

DECAY_TS = np.linspace(0.0, 1.0, 5)


def _decay_loss(mod, xp, alg, p):
    sol = mod.solve(mod.ODEProblem(lambda u, q, t: (1j - 0.3) * q * u,
                                   xp([1.0 + 0j]), (0.0, 1.0), p),
                    mod.Tsit5(), saveat=DECAY_TS, sensealg=alg, **TOLS)
    return (abs(sol.ys) ** 2).sum()


@pytest.fixture(scope="module")
def decay_ref():
    """JAX's real gradient under DirectAdjoint and GaussAdjoint."""
    def run(p):
        return {r: jax.grad(lambda q: _decay_loss(
            J, jnp.array, getattr(J, r)(), q))(p)
            for r in ("DirectAdjoint", "GaussAdjoint")}

    return jax_o0(run, jnp.asarray(1.1))


@pytest.mark.parametrize("rule", RULES)
def test_complex_state_real_parameter(decay_ref, rule):
    """u' = (i - 0.3)·p·u: the gradient of Σ|u(tᵢ)|² in the real p is real,
    equals JAX's (module docstring) and the closed form
    Σ -0.6·tᵢ·e^{-0.6·p·tᵢ} to 1e-6 (the JAX test's tolerance); the save
    times stay real."""
    p = torch.tensor(1.1, dtype=torch.float64, requires_grad=True)
    loss = _decay_loss(P, lambda x: torch.tensor(x, dtype=C),
                       getattr(P, rule)(), p)
    (g,) = torch.autograd.grad(loss, p)
    assert g.dtype == torch.float64
    _close(g, *_ref(decay_ref, rule), msg=rule)
    exact = float(np.sum(-0.6 * DECAY_TS * np.exp(-0.6 * 1.1 * DECAY_TS)))
    np.testing.assert_allclose(float(g), exact, rtol=1e-6)


# -- complex parameters (test_matrix.py:330-400) -----------------------------

A = np.array([[1.0j, 2.0], [3.0, 4.0]])
U0 = np.array([[1.0, 0.0j], [0.0, 1.0]])
UT = np.array([[0.0j, 1.0], [1.0, 0.0]])
P0 = np.array([1.5 + 1.0j, 1.0 - 0.5j])


def _matrix_loss(mod, xp, alg, p):
    a, u0, ut = xp(A), xp(U0), xp(UT)
    f = lambda u, q, t: (a @ u) * (q[0] * t + q[1] * t ** 2) * 0.2
    sol = mod.solve(mod.ODEProblem(f, u0, (0.0, 1.0), p), mod.Tsit5(),
                    saveat=[0.0, 1.0], sensealg=alg, **TOLS)
    uf = sol.ys[-1]
    return 1.0 - abs((uf @ ut.conj().T).trace() / 2.0) ** 2


@pytest.fixture(scope="module")
def matrix_ref():
    """JAX's complex gradient (dL/dRe − i·dL/dIm) under DirectAdjoint and
    GaussAdjoint."""
    def run(p):
        return {r: jax.grad(lambda q: _matrix_loss(
            J, jnp.asarray, getattr(J, r)(), q))(p)
            for r in ("DirectAdjoint", "GaussAdjoint")}

    return jax_o0(run, jnp.asarray(P0, jnp.complex128))


@pytest.mark.parametrize("rule", RULES)
def test_complex_parameter_is_conj_of_jax(matrix_ref, rule):
    """The reference's complex matrix ODE (complex_adjoints.jl:10-31): the
    port's gradient in the complex p is the conjugate of JAX's (module
    docstring); and DirectAdjoint's equals dL/dRe + i·dL/dIm from central
    differences to 1e-6 (the JAX test holds conj of its gradient to the
    same)."""
    p = torch.tensor(P0, dtype=C, requires_grad=True)
    as_c = lambda x: torch.tensor(x, dtype=C)
    (g,) = torch.autograd.grad(
        _matrix_loss(P, as_c, getattr(P, rule)(), p), p)
    assert g.dtype == C
    g = g.resolve_conj().numpy()
    ref, rtol = _ref(matrix_ref, rule)
    _close(g, np.conj(np.asarray(ref)), rtol, msg=rule)
    if rule == "DirectAdjoint":
        eps = 1e-7
        with torch.no_grad():
            loss = lambda q: float(_matrix_loss(P, as_c, P.DirectAdjoint(),
                                                torch.tensor(q, dtype=C)))
            fd = np.array([
                (loss(P0 + eps * e) - loss(P0 - eps * e)) / (2 * eps)
                + 1j * (loss(P0 + 1j * eps * e) - loss(P0 - 1j * eps * e))
                / (2 * eps) for e in np.eye(2)])
        _close(g, fd, 1e-6)


# -- complex u0, real p, a save series (test_matrix.py:403-430) ---------------

SERIES_TS = np.linspace(0.0, 1.0, 11)
SERIES_U0 = np.array([1.0 + 2.0j, 2.0 + 1.0j])
SERIES_RULES = ["InterpolatingAdjoint", "QuadratureAdjoint",
                "BacksolveAdjoint", "GaussAdjoint"]


@pytest.mark.parametrize("rule", SERIES_RULES)
def test_complex_u0_real_parameter_series(rule):
    """u' = p·u from a complex u0: d/dp Σ|u(1)| = Σ|u0|·e^p, real, to 1e-7
    (the JAX test's closed form and tolerance), and the gradient in the
    complex u0 is conj of JAX's: (u0/|u0|)·e^p for torch, its conjugate
    for JAX (one JAX rule computes it: u0 enters linearly)."""
    p = torch.tensor([1.0], dtype=torch.float64, requires_grad=True)
    u0 = torch.tensor(SERIES_U0, dtype=C, requires_grad=True)
    sol = P.solve(P.ODEProblem(lambda u, q, t: q * u, u0, (0.0, 1.0), p),
                  P.Tsit5(), saveat=SERIES_TS, sensealg=getattr(P, rule)(),
                  **TOLS)
    gu, gp = torch.autograd.grad(sol.ys[-1].abs().sum(), (u0, p))
    assert gp.dtype == torch.float64 and gu.dtype == C
    np.testing.assert_allclose(
        float(gp[0]), float(np.abs(SERIES_U0).sum() * np.e), rtol=1e-7)
    np.testing.assert_allclose(gu.resolve_conj().numpy(),
                               SERIES_U0 / np.abs(SERIES_U0) * np.e,
                               rtol=1e-7)


def test_save_times_stay_real():
    """A complex state keeps real save times (test_matrix.py:429-436) and
    a real time dtype (JAX integrate.py:175-180)."""
    sol = P.solve(P.ODEProblem(lambda u, p, t: 1j * u,
                               torch.tensor([1.0 + 0j], dtype=C), (0.0, 1.0),
                               None), P.Tsit5(), saveat=[0.0, 0.5, 1.0])
    assert not sol.ts.is_complex() and sol.ts.dtype == torch.float64
    assert sol.ys.dtype == C
    np.testing.assert_allclose(sol.ys[:, 0].numpy(),
                               np.exp(1j * np.array([0.0, 0.5, 1.0])),
                               rtol=1e-6)


# -- the rotation of test_dispatch.py:100-124 ----------------------------------

def test_complex_rotation_matches_jax():
    """u' = i·p·u: the forward under GaussAdjoint reaches e^{3i·p}, and the
    InterpolatingAdjoint gradient of |u(3) − e^{5.7i}|² in the real p is
    real, equal to JAX's to 1e-9 and to central differences to 1e-6."""
    def loss(mod, xp, p, alg):
        sol = mod.solve(mod.ODEProblem(lambda u, q, t: 1j * q * u,
                                       xp([1.0 + 0j]), (0.0, 3.0), p),
                        mod.Tsit5(), sensealg=alg, **TOLS)
        return abs(sol.ys[-1, 0] - np.exp(1j * 1.9 * 3.0)) ** 2, sol.ys

    g_j = jax_o0(jax.grad(lambda q: loss(J, jnp.array, q,
                                         J.InterpolatingAdjoint())[0]),
                 jnp.asarray(2.0))
    as_c = lambda x: torch.tensor(x, dtype=C)
    p = torch.tensor(2.0, dtype=torch.float64, requires_grad=True)
    value, _ = loss(P, as_c, p, P.InterpolatingAdjoint())
    (g,) = torch.autograd.grad(value, p)
    assert g.dtype == torch.float64
    _close(g, g_j)
    with torch.no_grad():
        _, ys = loss(P, as_c, torch.tensor(2.0, dtype=torch.float64),
                     P.GaussAdjoint())
        np.testing.assert_allclose(complex(ys[-1, 0]), np.exp(6j), atol=1e-8)
        eps = 1e-6
        at = lambda q: float(loss(P, as_c, torch.tensor(
            q, dtype=torch.float64), None)[0])
        fd = (at(2.0 + eps) - at(2.0 - eps)) / (2 * eps)
    np.testing.assert_allclose(float(g), fd, rtol=1e-6)


def test_kernel_field_refuses_complex_state():
    """The kernels take real dtypes only: a complex state on the fused
    fields raises ComplexStateUnsupported before any launch, naming the
    Function."""
    from scimlsensitivity_jl_tpu_torch.ops.mlp import fused_mlp2
    from scimlsensitivity_jl_tpu_torch.ops.rd1d import make_rd1d_field
    from scimlsensitivity_jl_tpu_torch.ops.vjp import ComplexStateUnsupported

    field = make_rd1d_field(8, 1.0 / 8)
    with pytest.raises(ComplexStateUnsupported, match="FusedRD1D"):
        field(torch.ones(8, dtype=C), torch.tensor([1e-3, 1.5]), 0.0)
    params = P.mlp_init(torch.Generator().manual_seed(0), (2, 4, 2),
                        torch.float64, device="cpu")
    with pytest.raises(ComplexStateUnsupported, match="FusedMLP2"):
        fused_mlp2(params, torch.ones(2, dtype=C))
