"""Parity of the port's ensembles (parallel/ensemble.py) with the JAX
package's, in float64 on the CPU, on the cases of tests/test_parallel.py:
u' = −p·u with trajectory i's u0 scaled by 1 + i/10.

The port's "vmap" backend is a loop of solves and a mesh is a list of
devices: on this CPU, `make_mesh(8)` is the CPU eight times, so
"shard_map" runs its eight shards here one after another and must give
the loop's values bit for bit. JAX's references (a vmapped solve and its
gradient) are compiled at XLA level 0 (`torch_parity.jax_o0`), so the
port's per-trajectory solves match them to roundoff. NILSS and NILSAS in
segment_parallel over a mesh equal the same without one, and refuse a
segment count the mesh does not divide. `entry.dryrun_multichip(2)` runs
one data-parallel training step over two gloo processes in a subprocess.

tests/test_parallel.py's two sharded-state cases (one state split over 8
devices by XLA's sharding propagation, :72-101 and :188-228) have no
counterpart: the port's solve runs each state on one device
(ROADMAP §3)."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import jax_o0

import scimlsensitivity_jl_tpu as J
import scimlsensitivity_jl_tpu_torch as P
from scimlsensitivity_jl_tpu.parallel.ensemble import (
    EnsembleProblem as JEnsembleProblem, solve_ensemble as j_solve_ensemble)

DT = torch.float64
LORENZ_U0 = np.array([-2.259143724332269, -2.47457604992522,
                      18.939914218990612])


def decay_jax(u, p, t):
    return -p * u


def decay_port(u, p, t):
    return -p * u


def base_port(p=1.0):
    p = p if isinstance(p, torch.Tensor) else torch.tensor(p, dtype=DT)
    return P.ODEProblem(decay_port, torch.tensor([1.0], dtype=DT), (0.0, 1.0),
                        p)


def prob_func_port(prob, i):
    return P.remake(prob, u0=prob.u0 * (1.0 + i / 10.0))


def prob_func_jax(prob, i):
    return J.remake(prob, u0=prob.u0 * (1.0 + i / 10.0))


TS = np.linspace(0.0, 1.0, 5)


@pytest.fixture(scope="module")
def jax_ref():
    """JAX's vmapped ensemble (8 trajectories, GaussAdjoint) and the
    gradient of test_parallel.py's fitting loss."""
    def run(p):
        base = J.ODEProblem(decay_jax, jnp.array([1.0]), (0.0, 1.0), p)
        sols = j_solve_ensemble(JEnsembleProblem(base, prob_func_jax),
                                J.Tsit5(), trajectories=8,
                                sensealg=J.GaussAdjoint())

        def loss(q):
            s = j_solve_ensemble(
                JEnsembleProblem(J.remake(base, p=q), prob_func_jax),
                J.Tsit5(), trajectories=8, saveat=jnp.asarray(TS),
                sensealg=J.GaussAdjoint())
            scale = 1.0 + jnp.arange(8) / 10.0
            target = scale[:, None] * jnp.exp(-1.3 * jnp.asarray(TS))[None]
            return jnp.mean((s.ys[:, :, 0] - target) ** 2)

        return sols.ys, jax.grad(loss)(p)

    ys, grad = jax_o0(run, jnp.asarray(1.0))
    return np.asarray(ys), float(grad)


def _fit_loss(p, backend, mesh=None):
    sols = P.solve_ensemble(
        P.EnsembleProblem(base_port(p), prob_func_port), P.Tsit5(),
        trajectories=8, backend=backend, mesh=mesh, saveat=TS,
        sensealg=P.GaussAdjoint())
    scale = 1.0 + torch.arange(8, dtype=DT) / 10.0
    target = scale[:, None] * torch.exp(-1.3 * torch.tensor(TS))[None]
    return torch.mean((sols.ys[:, :, 0] - target) ** 2)


def test_vmap_ensemble_matches_jax(jax_ref):
    """8 trajectories: the stacked solution's ys (8, 2, 1) equal JAX's to
    1e-12 and the closed form to 1e-6; retcodes and stats are stacked."""
    sols = P.solve_ensemble(P.EnsembleProblem(base_port(), prob_func_port),
                            P.Tsit5(), trajectories=8,
                            sensealg=P.GaussAdjoint())
    assert sols.ys.shape == (8, 2, 1)
    np.testing.assert_allclose(sols.ys.numpy(), jax_ref[0], rtol=1e-12)
    expect = (1.0 + np.arange(8) / 10.0) * np.exp(-1.0)
    np.testing.assert_allclose(sols.ys[:, -1, 0].numpy(), expect, rtol=1e-6)
    assert sols.retcode.tolist() == [0] * 8
    assert sols.stats.n_accepted.shape == (8,)


def test_shard_map_ensemble_matches_vmap():
    """16 trajectories over the 8-entry CPU mesh in contiguous shards: the
    loop's values bit for bit; a count the mesh does not divide raises
    JAX's ValueError, and an unknown backend raises."""
    mesh = P.make_mesh(8)
    assert mesh == [torch.device("cpu")] * 8
    ens = P.EnsembleProblem(base_port(), prob_func_port)
    s1 = P.solve_ensemble(ens, P.Tsit5(), trajectories=16,
                          sensealg=P.GaussAdjoint())
    s2 = P.solve_ensemble(ens, P.Tsit5(), trajectories=16,
                          backend="shard_map", mesh=mesh,
                          sensealg=P.GaussAdjoint())
    assert torch.equal(s1.ys, s2.ys)
    with pytest.raises(ValueError, match="divide evenly"):
        P.solve_ensemble(ens, P.Tsit5(), trajectories=12,
                         backend="shard_map", mesh=mesh)
    with pytest.raises(ValueError, match="backend"):
        P.solve_ensemble(ens, P.Tsit5(), trajectories=2, backend="pmap")


def test_gradient_through_sharded_ensemble(jax_ref):
    """The fitting loss of tests/test_parallel.py:49-69: the gradient
    through the loop equals the one through the shards bit for bit, and
    JAX's to 1e-10; it is negative (the optimum is p = 1.3)."""
    grads = []
    for backend, mesh in (("vmap", None), ("shard_map", P.make_mesh(8))):
        p = torch.tensor(1.0, dtype=DT, requires_grad=True)
        (g,) = torch.autograd.grad(_fit_loss(p, backend, mesh), p)
        grads.append(float(g))
    assert grads[0] == grads[1]
    assert abs(grads[0] - jax_ref[1]) <= 1e-10 * abs(jax_ref[1])
    assert grads[0] < 0


def test_ensemble_output_func_and_reduction():
    """output_func per trajectory, stacked, and a reduction over it."""
    ens = P.EnsembleProblem(base_port(), prob_func_port,
                            output_func=lambda sol, i: sol.ys[-1, 0] * (i + 1))
    outs = P.solve_ensemble(ens, P.Tsit5(), trajectories=8)
    expect = (1.0 + np.arange(8) / 10.0) * np.exp(-1.0) * (np.arange(8) + 1)
    np.testing.assert_allclose(outs.numpy(), expect, rtol=1e-6)
    total = P.solve_ensemble(ens, P.Tsit5(), trajectories=8,
                             reduction=lambda o: torch.sum(o))
    assert np.isclose(float(total), expect.sum(), rtol=1e-6)


def test_ensemble_summary_matches_numpy():
    """mean, var (ddof 1), median and the 5% / 95% quantiles over the
    trajectory axis, as numpy's (linear interpolation)."""
    ys = 1.0 + 0.1 * np.random.default_rng(0).standard_normal((64, 5, 2))
    s = P.ensemble_summary(torch.tensor(ys))
    np.testing.assert_allclose(s["mean"].numpy(), ys.mean(0), rtol=1e-14)
    np.testing.assert_allclose(s["var"].numpy(), ys.var(0, ddof=1),
                               rtol=1e-12)
    np.testing.assert_allclose(s["median"].numpy(), np.median(ys, axis=0),
                               rtol=1e-14)
    ql, qh = np.quantile(ys, [0.05, 0.95], axis=0)
    np.testing.assert_allclose(s["qlow"].numpy(), ql, rtol=1e-14)
    np.testing.assert_allclose(s["qhigh"].numpy(), qh, rtol=1e-14)
    js = J.ensemble_summary(jnp.asarray(ys))
    for k in s:
        np.testing.assert_allclose(s[k].numpy(), np.asarray(js[k]),
                                   rtol=1e-12)


def _lorenz(u, p, t):
    return torch.stack([10.0 * (u[1] - u[0]), u[0] * (p[0] - u[2]) - u[1],
                        u[0] * u[1] - (8.0 / 3.0) * u[2]])


@pytest.mark.parametrize("rule", ["NILSS", "NILSAS"])
def test_shadowing_segments_over_a_mesh(rule):
    """segment_parallel over the 4-entry CPU mesh (4 segments of Lorenz
    on (30, 30.8)): the same values as without a mesh, bit for bit, as
    tests/test_parallel.py:104-186 holds them to rtol 1e-6; 3 segments on
    2 devices raise."""
    prob = P.ODEProblem(_lorenz, torch.tensor(LORENZ_U0), (30.0, 30.8),
                        torch.tensor([28.0], dtype=DT))
    g = lambda u, q, t: u[2]  # noqa: E731

    def run(nseg, mesh):
        if rule == "NILSS":
            return P.shadow_forward(
                P.NILSSProblem(prob, P.NILSS(nseg=nseg, nstep=9), g=g),
                rtol=1e-6, atol=1e-8, segment_parallel=True, mesh=mesh)
        return P.nilsas_shadow_adjoint(
            P.NILSASProblem(prob, P.NILSAS(nseg=nseg, nstep=9, M=2), g=g),
            rtol=1e-6, atol=1e-8, fwd_rtol=1e-8, fwd_atol=1e-10,
            segment_parallel=True, mesh=mesh)

    plain, meshed = run(4, None), run(4, P.make_mesh(4))
    assert torch.isfinite(plain).all()
    assert torch.equal(plain, meshed)
    with pytest.raises(ValueError, match="divide evenly"):
        run(3, P.make_mesh(2))


def test_dryrun_multichip_two_processes():
    """entry.dryrun_multichip(2): one ensemble training step over two
    gloo ranks, the loss and gradient all-reduced, run in a subprocess."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run(
        [sys.executable, "-c",
         "import torch; torch.set_num_threads(1)\n"
         "from scimlsensitivity_jl_tpu_torch.entry import dryrun_multichip\n"
         "dryrun_multichip(2, timeout=240)"],
        cwd=root, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "dryrun_multichip(2): loss=" in out.stdout and "OK" in out.stdout
