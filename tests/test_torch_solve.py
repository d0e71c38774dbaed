"""Parity of the port's forward solve and dispatch with the JAX package, in
float64 on the CPU: the adaptive Tsit5 integrator on Lotka–Volterra, the
fixed-grid march on the flagship reaction–diffusion field, the
default-sensealg table, and the package's import hygiene."""

import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_parity import (assert_close, lotka_volterra_jax,
                          lotka_volterra_port, rd1d_u0, to_port)

import scimlsensitivity_jl_tpu as J
import scimlsensitivity_jl_tpu_torch as P
from scimlsensitivity_jl_tpu.ops.pallas_pde import make_rd1d_field as jax_field
from scimlsensitivity_jl_tpu_torch.ops.rd1d import make_rd1d_field as port_field

LV_U0 = np.array([1.0, 1.0])
LV_P = np.array([1.5, 1.0, 3.0, 1.0])


@pytest.mark.parametrize("dt0", [None, 0.5], ids=["auto_dt0", "rejecting_dt0"])
def test_lotka_volterra_adaptive_matches_jax(dt0):
    """Same accepted grid, counts, retcode, saved states and dense output.

    The JAX side runs op by op (jax.disable_jit): a jitted XLA program
    contracts multiply-adds into FMAs, and on a short step clipped to a save
    time the embedded error estimate is a cancellation dominated by
    roundoff, so the compiled controller picks steps that differ in the
    sixth digit. Op by op, both packages do the same float64 arithmetic and
    agree to the last bit."""
    ts = np.linspace(0.0, 1.5, 4)
    kw = dict(saveat=ts, rtol=1e-6, atol=1e-9, dt0=dt0, dense=True)
    with jax.disable_jit():
        sj = J.solve(J.ODEProblem(lotka_volterra_jax, jnp.asarray(LV_U0),
                                  (0.0, 1.5), jnp.asarray(LV_P)), J.Tsit5(),
                     **kw)
        t_probe = np.array([0.3, 1.1])
        dense_j = np.asarray(sj(jnp.asarray(t_probe)))
    sp = P.solve(P.ODEProblem(lotka_volterra_port, to_port(LV_U0), (0.0, 1.5),
                              to_port(LV_P)), P.Tsit5(), **kw)
    n_acc = int(sj.stats.n_accepted)
    assert sp.stats.n_accepted == n_acc
    assert sp.stats.n_rejected == int(sj.stats.n_rejected)
    assert sp.retcode == int(sj.retcode) == 0
    if dt0 is not None:
        assert sp.stats.n_rejected > 0
    np.testing.assert_array_equal(sp.dense.ts, np.asarray(sj.dense.ts)[:n_acc + 1])
    assert_close(sp.ys, sj.ys, atol=1e-12)
    assert_close(sp(list(t_probe)), dense_j, atol=1e-12)


@pytest.mark.parametrize("sensealg", ["discrete", "backsolve"])
def test_rd1d_fixed_grid_forward_matches_jax(sensealg):
    """n = 1024, 16 fixed Tsit5 steps through the Pallas / CUDA-kernel field:
    the discrete path (direct.py's fixed-grid solve) and the continuous
    rule's forward (integrate's fixed_dt march)."""
    n, dt = 1024, 1e-9
    t1 = 16 * dt
    u0, p = rd1d_u0(n), np.array([1e-7, 1.5])
    kw = dict(saveat=[0.0, 8 * dt, t1], dt=dt, adaptive=False)
    sa_j = J.BacksolveAdjoint() if sensealg == "backsolve" else None
    sa_p = P.BacksolveAdjoint() if sensealg == "backsolve" else None
    sj = J.solve(J.ODEProblem(jax_field(n, 1.0 / n), jnp.asarray(u0),
                              (0.0, t1), jnp.asarray(p)), J.Tsit5(),
                 sensealg=sa_j, **kw)
    sp = P.solve(P.ODEProblem(port_field(n, 1.0 / n), to_port(u0), (0.0, t1),
                              to_port(p)), P.Tsit5(), sensealg=sa_p, **kw)
    assert_close(sp.ys, sj.ys, atol=1e-12)
    assert_close(sp.u_final, sj.u_final, atol=1e-12)
    assert sp.stats.n_accepted == int(sj.stats.n_accepted)
    assert sp.stats.n_rejected == int(sj.stats.n_rejected) == 0
    assert sp.retcode == int(sj.retcode) == 0


DISPATCH_ROWS = [
    # (n, p, fixed_grid, unroll)
    (16384, 2, True, False),     # fixed-grid PDE: BacksolveAdjoint
    (16383, 2, True, False),     # just below the n threshold
    (16384, 129, True, False),   # too many parameters for Backsolve
    (262144, 2, False, False),   # adaptive: GaussAdjoint
    (2, 4, False, False),        # small: ForwardDiffSensitivity
    (50, 0, False, False),       # no parameters: QuadratureAdjoint
    (1024, 2, True, True),       # unrolled: DirectAdjoint
]


@pytest.mark.parametrize("n,np_,fixed_grid,unroll", DISPATCH_ROWS)
def test_default_sensealg_matches_jax(n, np_, fixed_grid, unroll):
    kw = dict(fixed_grid=fixed_grid, unroll=unroll)
    j = J.default_sensealg(n, np_, np_ > 0, **kw)
    p = P.default_sensealg(n, np_, np_ > 0, **kw)
    assert type(p).__name__ == type(j).__name__


def test_solve_default_dispatch_picks_backsolve_at_16384():
    """sensealg=None on a fixed grid at n = 16384 with p = [D, k] picks
    BacksolveAdjoint in both packages (4 steps)."""
    n, dt = 16384, 1e-9
    u0, p = rd1d_u0(n), np.array([1e-7, 1.5])
    kw = dict(saveat=[0.0, 4 * dt], dt=dt, adaptive=False)
    sj = J.solve(J.ODEProblem(jax_field(n, 1.0 / n), jnp.asarray(u0),
                              (0.0, 4 * dt), jnp.asarray(p)), J.Tsit5(), **kw)
    sp = P.solve(P.ODEProblem(port_field(n, 1.0 / n), to_port(u0),
                              (0.0, 4 * dt), to_port(p)), P.Tsit5(), **kw)
    assert type(sj.sensealg).__name__ == "BacksolveAdjoint"
    assert isinstance(sp.sensealg, P.BacksolveAdjoint)
    assert_close(sp.ys, sj.ys, atol=1e-12)


def test_reversed_span_fixed_grid_dt_sign():
    """u' = -u from u(1) = 1 back to t = 0 on a fixed grid. With dt = 0.1
    pointing away from t1, JAX's discrete march takes one Tsit5 step of -1
    (2.71809888); the port raises instead, on the discrete and on the
    continuous (BacksolveAdjoint) fixed-grid path alike (a deliberate
    divergence). With dt = -0.1 both packages reach e on both paths, in the
    same steps: 10 on the discrete march; the continuous one's controller
    adds a last sliver of roundoff (11)."""
    kw = dict(adaptive=False)
    with jax.disable_jit():
        jprob = J.ODEProblem(lambda u, p, t: -u, jnp.ones(1), (1.0, 0.0))
        sj = J.solve(jprob, J.Tsit5(), dt=0.1, **kw)
        sj_neg = {sa: J.solve(jprob, J.Tsit5(), dt=-0.1, sensealg=sa, **kw)
                  for sa in (None, J.BacksolveAdjoint())}
    assert int(sj.stats.n_accepted) == 1
    assert int(sj_neg[None].stats.n_accepted) == 10
    np.testing.assert_allclose(np.asarray(sj.u_final), [2.71809888], atol=1e-8)
    pprob = P.ODEProblem(lambda u, p, t: -u, to_port(np.ones(1)), (1.0, 0.0))
    for sa_j, sa_p in zip(sj_neg, (None, P.BacksolveAdjoint())):
        with pytest.raises(ValueError, match="points away from t1"):
            P.solve(pprob, P.Tsit5(), dt=0.1, sensealg=sa_p, **kw)
        sp_neg = P.solve(pprob, P.Tsit5(), dt=-0.1, sensealg=sa_p, **kw)
        assert sp_neg.stats.n_accepted == int(sj_neg[sa_j].stats.n_accepted)
        np.testing.assert_allclose(np.asarray(sj_neg[sa_j].u_final), [np.e],
                                   rtol=1e-8)
        assert_close(sp_neg.u_final, sj_neg[sa_j].u_final, atol=1e-12)


def test_unported_paths_raise():
    """What the port does not have yet fails loudly, naming the ROADMAP
    item, instead of returning a silent zero gradient."""
    u0 = to_port(LV_U0).requires_grad_()
    prob = P.ODEProblem(lotka_volterra_port, u0, (0.0, 1.0), to_port(LV_P))
    with pytest.raises(NotImplementedError, match="ROADMAP M4"):
        P.solve(prob, sensealg=P.InterpolatingAdjoint())
    with pytest.raises(NotImplementedError, match="ROADMAP M4"):
        P.solve(prob, sensealg=P.GaussAdjoint(checkpointing=True))
    with pytest.raises(NotImplementedError, match="ROADMAP M8"):
        P.solve(prob, callback=object())
    with pytest.raises(NotImplementedError, match="ROADMAP M4"):
        P.solve(prob, sensealg=P.GaussKronrodAdjoint())
    # without a gradient the shared forward solve runs under any rule
    sol = P.solve(P.ODEProblem(lotka_volterra_port, to_port(LV_U0),
                               (0.0, 1.0), to_port(LV_P)))
    assert isinstance(sol.sensealg, P.ForwardDiffSensitivity)
    assert sol.retcode == 0


def test_port_never_imports_jax_and_import_builds_nothing():
    pkg = Path(P.__file__).parent
    pattern = re.compile(r"^\s*(import jax|from jax)", re.M)
    offenders = [str(f.relative_to(pkg)) for f in pkg.rglob("*.py")
                 if pattern.search(f.read_text())]
    assert offenders == []
    # a fresh interpreter: importing every module loads no kernel library
    probe = ("import scimlsensitivity_jl_tpu_torch, "
             "scimlsensitivity_jl_tpu_torch.ops.rd1d; "
             "from scimlsensitivity_jl_tpu_torch.ops import cuda_build; "
             "print(len(cuda_build._loaded))")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, check=True, cwd=pkg.parent)
    assert out.stdout.strip() == "0"
