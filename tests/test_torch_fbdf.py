"""Parity of the port's FBDF (variable-order BDF with the integrator's
stateful-stepper path) with the JAX package's, in float64 on the CPU: the
cases of tests/test_fbdf.py.

JAX runs compiled at XLA optimization level 0 (`torch_parity.jax_o0`)
with references cached per module. The port keeps FBDF's history times
and order on the host and JAX on the device; the Lagrange weights then
round alike here, and the accepted and rejected counts and retcodes are
asserted equal to JAX's, final states at 1e-12 relative and gradients at
1e-8. The forward cases run at the JAX tests' own settings; the adjoint
case at rtol 1e-6 over (0, 1) (the JAX test: 1e-10 over (0, 100), with
finite differences as its oracle), stated there."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import jax_o0

import scimlsensitivity_jl_tpu as J
from scimlsensitivity_jl_tpu.solvers.integrate import integrate as j_integrate
import scimlsensitivity_jl_tpu_torch as P
from scimlsensitivity_jl_tpu_torch.solvers.integrate import (
    integrate as p_integrate)

DT = torch.float64
# scipy LSODA at rtol 1e-12, Robertson's u(100) (the JAX test's value)
ROB_U100 = np.array([6.17234882e-01, 6.15359127e-06, 3.82758964e-01])
M_DAE = np.diag([1.0, 1.0, 0.0])


def _rob(stack):
    return lambda u, t: stack([
        -0.04 * u[0] + 1e4 * u[1] * u[2],
        0.04 * u[0] - 1e4 * u[1] * u[2] - 3e7 * u[1] ** 2,
        3e7 * u[1] ** 2])


def _rob_dae(stack):
    return lambda u, t: stack([
        -0.04 * u[0] + 1e4 * u[1] * u[2],
        0.04 * u[0] - 1e4 * u[1] * u[2] - 3e7 * u[1] ** 2,
        u[0] + u[1] + u[2] - 1.0])


def _ho(stack):
    return lambda u, t: stack([u[1], -u[0]])


# name -> (field, solver, u0, t1, rtol, atol, max_steps)
CASES = {
    "robertson": (_rob, "FBDF", [1.0, 0.0, 0.0], 100.0, 1e-8, 1e-10, 4096),
    "robertson_seulex": (_rob, "Seulex", [1.0, 0.0, 0.0], 100.0, 1e-8,
                         1e-10, 4096),
    "robertson_r23": (_rob, "Rosenbrock23", [1.0, 0.0, 0.0], 100.0, 1e-8,
                      1e-10, 16384),
    "oscillator": (_ho, "FBDF", [1.0, 0.0], 10.0, 1e-8, 1e-10, 8192),
    "long_horizon": (_rob, "FBDF", [1.0, 0.0, 0.0], 1e5, 1e-8, 1e-12, 8192),
    "dae_fbdf": (_rob_dae, "FBDF", [1.0, 0.0, 0.0], 100.0, 1e-8, 1e-10,
                 8192),
    "dae_sdirk4": (_rob_dae, "SDIRK4", [1.0, 0.0, 0.0], 100.0, 1e-8, 1e-10,
                   8192),
}


def _solver(mod, name, case):
    s = getattr(mod, name)()
    return s.with_mass_matrix(M_DAE) if case.startswith("dae") else s


def _run(mod, case, u0):
    field, name, _, t1, rtol, atol, max_steps = CASES[case]
    integ = j_integrate if mod is J else p_integrate
    r = integ(_solver(mod, name, case),
              field(jnp.stack if mod is J else torch.stack), 0.0, t1, u0,
              rtol=rtol, atol=atol, max_steps=max_steps, store_dense=False)
    return r.u_final, r.stats.n_accepted, r.stats.n_rejected, r.stats.retcode


@pytest.fixture(scope="module")
def refs():
    """JAX's (u_final, accepted, rejected, retcode) per case."""
    out = {}
    for case, spec in CASES.items():
        out[case] = [np.asarray(x) for x in jax_o0(
            lambda u, case=case: _run(J, case, u), jnp.asarray(spec[2]))]
    return out


@functools.lru_cache(maxsize=None)
def _port(case):
    """The port's (u_final, accepted, rejected, retcode), once per case."""
    uf, acc, rej, rc = _run(P, case, torch.tensor(CASES[case][2], dtype=DT))
    return uf.numpy(), acc, rej, rc


@pytest.mark.parametrize("case", list(CASES))
def test_integrate_matches_jax(refs, case):
    """Each case's steps, retcode and final state equal JAX's (counts
    exactly, u_final at 1e-12)."""
    uf, acc, rej, rc = _port(case)
    j_uf, j_acc, j_rej, j_rc = refs[case]
    assert (acc, rej, rc) == (int(j_acc), int(j_rej), int(j_rc))
    np.testing.assert_allclose(uf, j_uf, rtol=1e-12,
                               atol=1e-12 * np.abs(j_uf).max())


def test_fbdf_robertson_accuracy_and_efficiency(refs):
    """u(100) to 1e-6 of LSODA's, and the multistep efficiency of the JAX
    test: FBDF's accepted steps at or below Seulex's + 10 and below
    Rosenbrock23's (rtol 1e-8)."""
    uf, acc, _, rc = _port("robertson")
    assert rc == 0
    np.testing.assert_allclose(uf, ROB_U100, rtol=1e-6)
    assert acc <= int(refs["robertson_seulex"][1]) + 10
    assert acc < int(refs["robertson_r23"][1])


def test_fbdf_order_ramps_beyond_bdf1(refs):
    """The oscillator at rtol 1e-8 needs the higher orders: under 500
    accepted steps (BDF1 would need ~70,000), cos(10) to 1e-5."""
    uf, acc, _, rc = _port("oscillator")
    assert rc == 0 and acc < 500
    assert abs(uf[0] - np.cos(10.0)) < 1e-5


def test_fbdf_long_horizon_and_dae(refs):
    """Robertson to 1e5 conserves mass to 1e-9; the index-1 DAE form
    (M = diag(1, 1, 0)) under FBDF agrees with SDIRK4's to 1e-6 and keeps
    the constraint to 1e-10."""
    uf, _, _, rc = _port("long_horizon")
    assert rc == 0 and abs(uf.sum() - 1.0) < 1e-9
    uf_b, _, _, rc_b = _port("dae_fbdf")
    uf_s, _, _, _ = _port("dae_sdirk4")
    assert rc_b == 0
    np.testing.assert_allclose(uf_b, uf_s, rtol=1e-6)
    assert abs(uf_b.sum() - 1.0) < 1e-10


def _adj_loss(mod, rule, summ):
    def rob(u, p, t):
        stack = jnp.stack if mod is J else torch.stack
        return stack([-p[0] * u[0] + p[1] * u[1] * u[2],
                      p[0] * u[0] - p[1] * u[1] * u[2] - p[2] * u[1] ** 2,
                      p[2] * u[1] ** 2])

    def loss(pp):
        u0 = (jnp.array([1.0, 0.0, 0.0]) if mod is J
              else torch.tensor([1.0, 0.0, 0.0], dtype=DT))
        sol = mod.solve(mod.ODEProblem(rob, u0, (0.0, 1.0), pp), mod.FBDF(),
                        saveat=np.array([0.0, 0.1, 1.0]), rtol=1e-6,
                        atol=1e-12, sensealg=getattr(mod, rule)(),
                        adj_rtol=1e-5, adj_atol=1e-10, max_steps=16384)
        return summ(sol.ys[:, 0] ** 2) + 1e4 * summ(sol.ys[:, 1] ** 2)
    return loss


ADJ_RULES = ["QuadratureAdjoint", "GaussAdjoint"]
P_ROB = np.array([0.04, 1e4, 3e7])


@pytest.fixture(scope="module")
def adj_refs():
    def grads(pp):
        return [jax.grad(_adj_loss(J, r, jnp.sum))(pp) for r in ADJ_RULES]

    return [np.asarray(g) for g in jax_o0(grads, jnp.asarray(P_ROB))]


def test_fbdf_adjoint_gradients_cross_validated(adj_refs):
    """FBDF forward and reverse (the reverse restarts its history at every
    λ jump) under Quadrature and Gauss on Robertson over (0, 1) at rtol
    1e-6 and adj_rtol 1e-5: each against JAX's (1e-8), and the two against
    each other at 2e-4 (the JAX test's bound; it runs (0, 100) at rtol
    1e-10 against finite differences). Its third arm, a Seulex forward
    with an SDIRK4 reverse, is left out: it costs ~200 ms per reverse step
    on this CPU (160 pullbacks per SDIRK4 step); SDIRK4's steps are held
    to JAX's in test_torch_stiff.py and here (the DAE case), and Rodas4Like
    as a reverse stepper in test_torch_stiff.py."""
    got = []
    for rule, ref in zip(ADJ_RULES, adj_refs):
        pt = torch.tensor(P_ROB, dtype=DT, requires_grad=True)
        (g,) = torch.autograd.grad(_adj_loss(P, rule, torch.sum)(pt), pt)
        np.testing.assert_allclose(g.numpy(), ref, rtol=1e-8,
                                   atol=1e-8 * np.abs(ref).max(),
                                   err_msg=rule)
        got.append(g.numpy())
    np.testing.assert_allclose(got[1], got[0], rtol=2e-4)


def test_fbdf_rejects_scan_driver():
    """The fixed-trip driver refuses a multistep stepper, as JAX's scan
    driver does, and so does unroll=True (an explicit-RK path)."""
    u0 = torch.tensor([1.0, 0.0, 0.0], dtype=DT)
    with pytest.raises(NotImplementedError, match="multistep"):
        p_integrate(P.FBDF(), _rob(torch.stack), 0.0, 1.0, u0,
                    fixed_trip=True)
    with pytest.raises(NotImplementedError):
        J.solvers.integrate.integrate_scan(
            J.FBDF(), _rob(jnp.stack), 0.0, 1.0, jnp.array([1.0, 0.0, 0.0]))
