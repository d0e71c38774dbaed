"""Parity of a sharded state (parallel/sharded.py) with the JAX package.

The JAX package's tests/test_parallel.py:72 and :204 solve the heat
equation with u0 placed on an 8-device mesh and assert that the sharded
gradient equals the unsharded one at rtol 1e-10; the package has no code
of its own for it (XLA's partitioner carries the sharding). Here the
port's state is split over gloo ranks on the CPU (tests/sharded_ranks.py,
four processes started once for the module; world sizes 3 and 2 are its
subgroups; the adaptive heat case runs in a second group of four beside
it), and its gradients are held against the JAX package's
unsharded gradients, computed in this process, and the port's unsharded
ones, at rtol 1e-10, with the accepted steps side by side.

The fixed-grid heat case (:204) runs both packages on the first 256 of
the JAX test's 2048 steps: a step of the heat field on a sharded state
costs ~10 ms of DTensor dispatch and gathers (its torch.roll gathers the
whole state, ROADMAP §3), so the 2048 steps and their pinned reverse took
over two minutes of this file's budget; the adaptive case (:72) runs in
full. The flagship field (make_rd1d_field) runs on ragged grids under
every rule the slice takes at world size 4, and under InterpolatingAdjoint
at world size 3 (the halo cases cover ragged shards at world sizes 2-4),
held against the JAX package's make_rd1d_field (its Pallas kernel in
interpret mode); the halo exchange alone against the edge-copy Laplacian
of the gathered state; the error norms over the ranks against those of
the gathered vector; and each refusal by name, before the field runs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sharded_ranks as R
from torch_parity import jax_o0

import scimlsensitivity_jl_tpu as J
from scimlsensitivity_jl_tpu.ops import pallas_pde as jpde
import scimlsensitivity_jl_tpu_torch as P
from scimlsensitivity_jl_tpu_torch.ops import rd1d
from scimlsensitivity_jl_tpu_torch.parallel import sharded

RTOL = 1e-10  # the JAX tests' rtol between sharded and unsharded


# two groups of four ranks, run at once: the adaptive heat case alone
# (the longest, ~50 s of DTensor dispatch and gathers) and every other case;
# its test comes last in this file, so that the JAX references of the
# others compile while it runs
GROUPS = (("heat adaptive",),
          ("halo", "norms", "empty shard", "comm", "refusals", "heat fixed",
           "rd "))


@pytest.fixture(scope="module")
def ranks():
    groups = R.RankGroups(GROUPS)
    yield groups
    groups.close()


def _close(got, ref, rtol=RTOL, what=""):
    """Relative to the largest entry of the reference (an entry near 0 of a
    gradient is held to the scale of the rest)."""
    got, ref = np.asarray(got, float), np.asarray(ref, float)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.max(np.abs(got - ref)) / np.max(np.abs(ref))
    assert err <= rtol, f"{what}: max error {err:.3e} > {rtol:g}"


# -- the flagship field on a sharded state ------------------------------------


_JAX_RD = {}


def _jax_rd(n, rule):
    """JAX's unsharded gradient of Σ ys[-1]² through its make_rd1d_field
    (the Pallas kernel in interpret mode), one compile per (n, rule)."""
    if (n, rule) not in _JAX_RD:
        field = jpde.make_rd1d_field(n, 1.0 / n)
        t1 = R.RD_STEPS * R.RD_DT
        sensealg = None if rule == "None" else getattr(J, rule)()

        def loss(u0, p):
            sol = J.solve(J.ODEProblem(field, u0, (0.0, t1), p), J.Tsit5(),
                          saveat=jnp.asarray([0.0, t1]), dt=R.RD_DT,
                          adaptive=False, sensealg=sensealg, **R.RD_ADJ)
            return jnp.sum(sol.ys[-1] ** 2)

        gu, gp = jax_o0(jax.grad(loss, argnums=(0, 1)),
                        jnp.asarray(R.rd_u0(n)), jnp.asarray(R.rd_p(n)))
        _JAX_RD[n, rule] = np.asarray(gu), np.asarray(gp)
    return _JAX_RD[n, rule]


@pytest.mark.parametrize("world,n,rule", R.RD_CASES,
                         ids=[f"w{w}-n{n}-{r}" for w, n, r in R.RD_CASES])
def test_rd1d_field_matches_jax(ranks, world, n, rule):
    """make_rd1d_field on a ragged grid split over 4 ranks, 64 fixed Tsit5
    steps: sensealg=None (GaussAdjoint at n = 1027, BacksolveAdjoint at
    n = 16411, as the global size dispatches), DirectAdjoint,
    InterpolatingAdjoint, GaussAdjoint; and over 3 ranks under
    InterpolatingAdjoint."""
    gu_j, gp_j = _jax_rd(n, rule)
    u0 = torch.from_numpy(R.rd_u0(n)).requires_grad_()
    gu_p, gp_p, sol_p = R.rd_gradient(P, u0, n, rule)
    got = ranks[f"rd w{world} n{n} {rule}"]
    assert got["sensealg"] == type(sol_p.sensealg).__name__
    if rule == "None":
        assert got["sensealg"] == ("BacksolveAdjoint" if n >= 16384
                                   else "GaussAdjoint")
    assert got["stats"] == R._stats(sol_p.stats)
    if sol_p.adjoint is not None:
        print(f"w{world} n{n} {rule}: reverse steps sharded {got['adj']}, "
              f"unsharded {R._stats(sol_p.adjoint.stats)}")
        assert got["adj"] == R._stats(sol_p.adjoint.stats)
    _close(got["gu"], gu_j, what="u0-grad vs JAX")
    _close(got["gp"], gp_j, what="p-grad vs JAX")
    _close(got["gu"], R._np(gu_p), what="u0-grad vs the port unsharded")
    _close(got["gp"], R._np(gp_p), what="p-grad vs the port unsharded")


# -- the halo exchange alone --------------------------------------------------


@pytest.mark.parametrize("world,n", R.HALO_CASES,
                         ids=[f"w{w}-n{n}" for w, n in R.HALO_CASES])
def test_halo_exchange_matches_edge_copy(ranks, world, n):
    """The field's value and pullback on the sharded state against the
    plain edge-copy versions on the gathered state: uneven shards (torch
    .chunk's split) and shards of one cell; the pullback through
    torch.func.vjp the same bits as through autograd."""
    got = ranks[f"halo w{world} n{n}"]
    chunk = -(-n // world)
    assert got["sizes"] == [min(chunk, n - r * chunk) for r in range(world)]
    assert got["f_placements"] == "(Shard(dim=0),)"
    _close(got["f"], got["f_ref"], rtol=1e-13, what="f")
    _close(got["du"], got["du_ref"], rtol=1e-13, what="ū")
    _close(got["dp"], got["dp_ref"], rtol=1e-13, what="[D̄, k̄]")
    assert np.array_equal(got["du_func"], got["du"])
    assert np.array_equal(got["dp_func"], got["dp"])


def test_halo_cases_hold_uneven_and_one_cell_shards():
    sizes = {(w, n): [min(-(-n // w), n - r * -(-n // w)) for r in range(w)]
             for w, n in R.HALO_CASES}
    assert any(len(set(s)) > 1 for s in sizes.values())
    assert any(min(s) == 1 for s in sizes.values())


@pytest.mark.parametrize("world", [2, 3, 4])
def test_shard_norms_match_the_gathered_vector(ranks, world):
    """The step controller's reductions over a vector split over the ranks
    (ShardNorms) against the whole-vector ones (Norms) of the gathered
    vector, with and without rows of per-rank partial sums; the same bits
    on every rank."""
    got = ranks[f"norms w{world}"]
    assert got["local_is_whole"]
    first = got["ranks"][0]
    assert all(r == first for r in got["ranks"]), got["ranks"]
    for what, (sharded_value, whole) in first.items():
        _close(sharded_value, whole, rtol=1e-14, what=what)


def test_empty_shard_raises_by_name(ranks):
    """n = 5 over 4 ranks splits 2, 2, 1, 0 (torch.chunk): the field and
    solve raise ShardedStateError naming the empty rank."""
    got = ranks["empty shard"]
    for what in ("field", "solve"):
        name, msg = got[what]
        assert name == "ShardedStateError", (what, name, msg)
        assert "[2, 2, 1, 0]" in msg and "rank(s) [3]" in msg


def test_flagship_field_never_gathers_the_state(ranks):
    """One evaluation and one pullback of make_rd1d_field on a state of
    1027 cells over 4 ranks move two exchanges of edge cells, O(P) values
    (each rank's 2, then 4 with λ's), and no gather of the state; the heat
    field written with torch.roll gathers the whole state through DTensor's
    rule (ROADMAP §3)."""
    got = ranks["comm"]
    rd, heat = got["rd1d"], got["heat"]
    assert rd["exchanges"] == 2
    assert rd["debug"] == {"c10d.allgather_": 2}, rd
    assert rd["ops"] == {"c10d.allgather_.default": 2}, rd
    # every rank's edge cells and the gathered copies: (P + 1)·2 + (P + 1)·4
    assert rd["elements"] == 5 * 2 + 5 * 4, rd
    assert heat["debug"].get("c10d_functional.all_gather_into_tensor",
                             0) >= 2, heat


# -- refusals -----------------------------------------------------------------


REFUSALS = [
    "ForwardDiffSensitivity", "ForwardSensitivity", "NILSS", "JacVJP",
    "FiniteDiffVJP", "a DTensor weight", "a state split along dim 1",
    "default ForwardDiffSensitivity (n + p <= 100)", "Rosenbrock23", "FBDF",
    "Rosenbrock23 bwd_solver", "extrapolation (Seulex)", "callback",
    "dense=True", "save_idxs", "mass matrix", "SDEProblem",
    "DDEProblem", "adjoint_sensitivities", "ODEAdjointProblem",
    "second_order_sensitivities", "ODEForwardSensitivityProblem",
    "ForwardLSSProblem", "AdjointLSSProblem", "NILSSProblem",
    "NILSASProblem", "solve_ensemble"]


@pytest.mark.parametrize("name", REFUSALS)
def test_refusal_raises_by_name_before_the_field_runs(ranks, name):
    got = ranks["refusals"]
    assert set(got) == set(REFUSALS)
    cls, msg, calls = got[name]
    assert cls == "ShardedStateUnsupported", (name, cls, msg)
    assert "does not run on a sharded state" in msg
    assert calls == 0, f"{name}: the field ran {calls} times first"


# -- one process: the kernels' plain versions with a shard's ghosts -----------


def _slices(n, world, seed):
    g = np.random.default_rng(seed)
    u, lam = g.uniform(0.0, 1.0, n), g.standard_normal(n)
    chunk = -(-n // world)
    return u, lam, [(r * chunk, min(n, (r + 1) * chunk)) for r in range(world)]


def _ghosts(x, a, b):
    n = x.shape[0]
    return torch.tensor([x[a - 1] if a > 0 else x[0],
                         x[b] if b < n else x[n - 1]], dtype=torch.float64)


@pytest.mark.parametrize("n,world", [(1027, 4), (7, 3), (3, 2), (1, 1)])
def test_plain_versions_with_ghosts_piece_together(n, world):
    """rd1d_fwd / rd1d_vjp on each shard with its neighbours' cells as
    ghosts: the pieces of the field and ū are the whole grid's (the same
    bits), and the partial D̄, k̄ sum to its."""
    u, lam, spans = _slices(n, world, n)
    p = torch.tensor([0.7, 2.3], dtype=torch.float64)
    inv_dx2 = float(n * n)
    ut, lt = torch.from_numpy(u), torch.from_numpy(lam)
    f_all = rd1d.rd1d_fwd(ut, p, inv_dx2)
    du_all, dp_all = rd1d.rd1d_vjp(ut, p, inv_dx2, lt)
    f_parts, du_parts, dp_sum = [], [], torch.zeros(2, dtype=torch.float64)
    for a, b in spans:
        gu, gl = _ghosts(u, a, b), _ghosts(lam, a, b)
        f_parts.append(rd1d.rd1d_fwd(ut[a:b], p, inv_dx2, gu))
        du, dp = rd1d.rd1d_vjp(ut[a:b], p, inv_dx2, lt[a:b],
                               torch.cat([gu, gl]))
        du_parts.append(du)
        dp_sum = dp_sum + dp
    assert torch.equal(torch.cat(f_parts), f_all)
    assert torch.equal(torch.cat(du_parts), du_all)
    _close(dp_sum, dp_all, rtol=1e-13, what="[D̄, k̄]")


def test_ghosts_none_is_the_edge_copy():
    u, lam, _ = _slices(33, 1, 5)
    ut, lt = torch.from_numpy(u), torch.from_numpy(lam)
    p = torch.tensor([0.7, 2.3], dtype=torch.float64)
    edge = _ghosts(u, 0, 33)
    assert torch.equal(rd1d.rd1d_fwd(ut, p, 9.0),
                       rd1d.rd1d_fwd(ut, p, 9.0, edge))
    both = torch.cat([edge, _ghosts(lam, 0, 33)])
    for a, b in zip(rd1d.rd1d_vjp(ut, p, 9.0, lt),
                    rd1d.rd1d_vjp(ut, p, 9.0, lt, both)):
        assert torch.equal(a, b)


def test_plain_state_is_not_sharded():
    """A plain tensor takes the unsharded path, whose solves reduce their
    error norms over the whole vector."""
    from scimlsensitivity_jl_tpu_torch.adjoints.continuous import (
        SolveOptions)
    from scimlsensitivity_jl_tpu_torch.solvers.integrate import LOCAL_NORMS

    assert not sharded.is_sharded(torch.zeros(3))
    assert SolveOptions().norms is LOCAL_NORMS
    with pytest.raises(sharded.ShardedStateError, match="DTensor"):
        sharded.ShardContext.of(torch.zeros(3))


# -- the JAX tests' heat field ------------------------------------------------


def _jax_heat(fixed):
    u0 = jnp.asarray(R.heat_u0())
    scale = R.heat_scale()

    def heat(u, p, t):
        return p * scale * (jnp.roll(u, 1) + jnp.roll(u, -1) - 2.0 * u)

    if fixed:
        kw = dict(dt=R.HEAT_DT, adaptive=False,
                  sensealg=J.InterpolatingAdjoint(), adj_rtol=1e-8,
                  adj_atol=1e-10, adj_max_steps=4096)
        tspan = (0.0, R.HEAT_DT * R.HEAT_STEPS)
    else:
        kw = dict(rtol=1e-8, atol=1e-10, sensealg=J.GaussAdjoint(),
                  max_steps=1024)
        tspan = (0.0, 0.1)

    def sol(p, u0_):
        return J.solve(J.ODEProblem(heat, u0_, tspan, p), J.Tsit5(), **kw)

    def loss(p, u0_):
        return jnp.sum(sol(p, u0_).ys[-1] ** 2)

    gp, gu = jax_o0(jax.grad(loss, argnums=(0, 1)), jnp.asarray(1.3), u0)
    steps = int(jax_o0(lambda p, u: sol(p, u).stats.n_accepted,
                       jnp.asarray(1.3), u0))
    return np.asarray(gu), float(gp), steps


@pytest.mark.parametrize("fixed", [False, True], ids=["adaptive", "fixed"])
def test_heat_matches_jax(ranks, fixed):
    """test_parallel.py:72 (adaptive Tsit5, GaussAdjoint) and :204 (the
    fixed grid, InterpolatingAdjoint) on 4 ranks: u0's and p's gradients
    against JAX's unsharded ones and the port's, the steps side by side."""
    gu_j, gp_j, steps_j = _jax_heat(fixed)
    u0 = torch.from_numpy(R.heat_u0()).requires_grad_()
    gu_p, gp_p, sol_p = R.heat_gradient(P, u0, fixed)
    got = ranks["heat fixed" if fixed else "heat adaptive"]
    steps = {"JAX": steps_j, "port": sol_p.stats.n_accepted,
             "port sharded": got["stats"][0],
             "port reverse": sol_p.adjoint.stats.n_accepted,
             "port sharded reverse": got["adj"][0]}
    print(f"heat {'fixed' if fixed else 'adaptive'}: accepted steps {steps}")
    assert got["stats"] == R._stats(sol_p.stats), steps
    assert got["adj"] == R._stats(sol_p.adjoint.stats), steps
    assert steps["JAX"] == steps["port"], steps
    assert got["ys_type"] == "DTensor" and got["gp_type"] == "Tensor"
    assert got["gu_placements"] == "(Shard(dim=0),)"
    _close(got["gu"], gu_j, what="u0-grad vs JAX")
    _close(got["gp"], gp_j, what="p-grad vs JAX")
    _close(got["gu"], R._np(gu_p), what="u0-grad vs the port unsharded")
    _close(got["gp"], R._np(gp_p), what="p-grad vs the port unsharded")
