"""Parity of the kernels' paths on a sharded state (parallel/sharded.py) with
the JAX package: the RK4 block (K5/K6, `make_rd1d_rk4_block`) on a state
split over 2, 3 and 4 gloo ranks, and the batched neural field
(`fused_mlp2`, K3/K4) on a state split by rows over 3, under every
reverse-mode rule.

The ranks run in tests/sharded_ranks.py (one group of four processes,
started once for the module; world sizes 3 and 2 are its subgroups), and
their results are held here against the JAX package's unsharded results,
computed in this process meanwhile, and against the port's unsharded ones.
The block runs at the JAX megakernel test's problem (N = 1024, D = 1e-4,
k = 1.5, h = 1e-5; tests/test_pallas_pde.py:67-73) against JAX's
interpret-mode block at tests/test_torch_rd1d_rk4.py's tolerances (ū 1e-11,
D̄ and k̄ 1e-10 relative). The neural field's JAX side is the package's
plain `mlp2_reference` (the function its fused kernel computes), whose
solves compile in seconds, against which the sharded gradients hold at
1e-10. On the CPU every kernel runs its plain version: the ghosted plain
K5/K6 are also pieced together here in one process.
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
from scimlsensitivity_jl_tpu.ops.pallas_mlp import mlp2_reference
import scimlsensitivity_jl_tpu_torch as P
from scimlsensitivity_jl_tpu_torch.ops import rd1d
from scimlsensitivity_jl_tpu_torch.utils.pytree import from_numpy_tree

RTOL = 1e-10
GROUPS = (("mlp",), ("blk",))
INV_DX2 = float(R.BLK_N * R.BLK_N)


@pytest.fixture(scope="module")
def ranks():
    groups = R.RankGroups(GROUPS)
    yield groups
    groups.close()


@pytest.fixture(scope="module")
def jax_refs(ranks):
    """Every case's JAX result, computed once the ranks have started and
    before any test waits for them."""
    refs = {R.blk_name(*c): _jax_block(*c[1:]) for c in R.BLK_CASES}
    refs.update({f"mlp B{B} {rule} {grid}": _jax_mlp(B, rule, grid)
                 for B, rule, grid in R.MLP_CASES})
    return refs


def _close(got, ref, rtol=RTOL, what=""):
    """Relative to the largest entry of the reference."""
    got, ref = np.asarray(got, float), np.asarray(ref, float)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.max(np.abs(got - ref)) / np.max(np.abs(ref))
    assert err <= rtol, f"{what}: max error {err:.3e} > {rtol:g}"


# -- the RK4 block -------------------------------------------------------------


def _jax_block(S, chunk, bwd_chunk, blocks):
    """(y, ū, [D̄, k̄]) of Σ y² through JAX's interpret-mode block."""
    blk = jpde.make_rd1d_rk4_block(R.BLK_N, S, chunk=chunk,
                                   bwd_chunk=bwd_chunk,
                                   force_kernel_interpret=True)

    def chain(u, D, k):
        for _ in range(blocks):
            u = blk(u, D, k, INV_DX2, R.BLK_H)
        return u

    u0 = jnp.asarray(R.blk_u0())
    D, k = R.BLK_P
    y = chain(u0, D, k)
    gu, gD, gk = jax.grad(lambda u, DD, kk: jnp.sum(chain(u, DD, kk) ** 2),
                          argnums=(0, 1, 2))(u0, D, k)
    return np.asarray(y), np.asarray(gu), np.array([float(gD), float(gk)])


def _assert_block(y, gu, gp, y_ref, gu_ref, gp_ref, what):
    """y within 1e-12, ū within 1e-11, D̄ and k̄ within 1e-10 relative
    (tests/test_torch_rd1d_rk4.py's tolerances)."""
    assert float(np.max(np.abs(y - y_ref))) < 1e-12, what
    assert float(np.max(np.abs(gu - gu_ref))) < 1e-11, what
    for got, want in zip(gp, gp_ref):
        assert abs(got - want) < 1e-10 * max(1.0, abs(want)), (what, got,
                                                                want)


@pytest.mark.parametrize("world,S,chunk,bwd_chunk,blocks", R.BLK_CASES,
                         ids=[R.blk_name(*c).replace(" ", "-")
                              for c in R.BLK_CASES])
def test_sharded_block_matches_jax(ranks, jax_refs, world, S, chunk,
                                   bwd_chunk, blocks):
    """The block on a Shard(0) DTensor against JAX's interpret-mode block
    at the same chunks, and against the port's unsharded block where every
    shard end falls on a tile end of both chunks: its value the same bits,
    ū and [D̄, k̄] at the same tolerances. One halo exchange per block call
    and one per pullback, 4(S+1) cells per side that has a neighbour of u,
    then of u and λ."""
    name = R.blk_name(world, S, chunk, bwd_chunk, blocks)
    got = ranks[name]
    assert got["placements"] == got["gu_placements"] == "(Shard(dim=0),)"
    assert got["gp_type"] == "Tensor"
    H = 4 * (S + 1)
    assert got["exchanges"] == 2 * blocks
    assert got["ghost_cells"] == [(1 + 2) * H * blocks * ((r > 0)
                                                         + (r < world - 1))
                                  for r in range(world)]
    assert got["launches"] == (0, 0)  # CPU tensors: the plain versions
    _assert_block(got["y"], got["gu"], got["gp"], *jax_refs[name], "vs JAX")
    ends = np.cumsum(got["sizes"])[:-1]
    if all(e % chunk == 0 and e % bwd_chunk == 0 for e in ends):
        u = torch.from_numpy(R.blk_u0()).requires_grad_()
        y, gu, gp = R.blk_gradient(u, S, chunk, bwd_chunk, blocks)
        assert np.array_equal(got["y"], R._np(y))
        _assert_block(got["y"], got["gu"], got["gp"], R._np(y), R._np(gu),
                      R._np(gp), "vs the port unsharded")


def test_block_cases_hold_tile_ends_and_ragged_shards():
    sizes = {c: [len(x) for x in np.array_split(np.zeros(R.BLK_N), c[0])]
             for c in R.BLK_CASES}
    on_ends = [c for c, s in sizes.items()
               if all(e % c[2] == 0 and e % c[3] == 0
                      for e in np.cumsum(s)[:-1])]
    assert on_ends and len(on_ends) < len(R.BLK_CASES)
    assert any(len(set(s)) > 1 for s in sizes.values())


def test_shards_the_block_cannot_take_raise_by_name(ranks):
    """A shard narrower than the ghost width 4(S+1), and a shard length
    that the chunk does not divide, raise ShardedStateError on every rank
    before any exchange."""
    got = ranks["blkerr"]
    cls, msg, exchanges = got["narrow"]
    assert cls == "ShardedStateError" and "4*(S+1) = 12" in msg, msg
    assert "holds 10" in msg and exchanges == 0
    cls, msg, exchanges = got["ragged chunk"]
    assert cls == "ShardedStateError" and "divisible" in msg, msg
    assert exchanges == 0


def _shard_ghosts(x, a, b, H):
    """[left H | right H] of x's cells beyond [a, b), zeros at a global end
    (never read there)."""
    n = x.shape[0]
    left = x[a - H:a] if a > 0 else np.zeros(H)
    right = x[b:b + H] if b < n else np.zeros(H)
    return np.concatenate([left, right])


@pytest.mark.parametrize("n,world,S", [(1024, 2, 4), (1000, 3, 2),
                                       (1024, 4, 4), (342, 3, 4)])
def test_ghosted_plain_block_pieces_together(n, world, S):
    """K5's and K6's plain versions on each shard with its neighbours'
    4(S+1) cells as ghosts: the pieces of the value are the whole grid's
    bits, those of ū the whole grid's within 1e-12 (the widened shard's
    edge copy reaches its own cells' adjoint only through terms of order
    (h·D·inv_dx2)^(S+1)), and the partial D̄, k̄ sum to its."""
    g = np.random.default_rng(n + world)
    u, lam = g.uniform(0.0, 1.0, n), g.standard_normal(n)
    p = torch.tensor([0.7, 2.3], dtype=torch.float64)
    inv_dx2, h, H = float(n * n), 1e-9, 4 * (S + 1)
    ut, lt = torch.from_numpy(u), torch.from_numpy(lam)
    y_all = rd1d.rd1d_rk4_fwd(ut, p, inv_dx2, h, S, n)
    du_all, dp_all = rd1d.rd1d_rk4_vjp(ut, p, inv_dx2, h, S, n, lt)
    chunk = -(-n // world)
    y_parts, du_parts, dp_sum = [], [], torch.zeros(2, dtype=torch.float64)
    for r in range(world):
        a, b = r * chunk, min(n, (r + 1) * chunk)
        sides = (a > 0, b < n)
        gu = torch.from_numpy(_shard_ghosts(u, a, b, H))
        gl = torch.from_numpy(_shard_ghosts(lam, a, b, H))
        y_parts.append(rd1d.rd1d_rk4_fwd(ut[a:b], p, inv_dx2, h, S, b - a,
                                         gu, *sides))
        du, dp = rd1d.rd1d_rk4_vjp(ut[a:b], p, inv_dx2, h, S, b - a,
                                   lt[a:b], torch.cat([gu, gl]), *sides)
        du_parts.append(du)
        dp_sum = dp_sum + dp
    assert torch.equal(torch.cat(y_parts), y_all)
    _close(torch.cat(du_parts), du_all, rtol=1e-12, what="ū")
    _close(dp_sum, dp_all, rtol=1e-12, what="[D̄, k̄]")


# -- the neural field on a batch split by rows ---------------------------------


def _jax_mlp(B, rule, grid):
    """JAX's unsharded (u0-grad, weights' grads) of the row-split case,
    through the plain MLP field."""
    x, params = R.mlp_inputs(B)

    def field(u, p, t):
        return mlp2_reference(u, p["W0"], p["b0"], p["W1"], p["b1"])

    sensealg = None if rule == "None" else getattr(J, rule)()
    kw = R.mlp_kwargs(grid)

    def loss(u0, p):
        sol = J.solve(J.ODEProblem(field, u0, (0.0, R.MLP_T1), p),
                      J.Tsit5(), saveat=jnp.asarray([0.0, 0.5 * R.MLP_T1,
                                                     R.MLP_T1]),
                      sensealg=sensealg, **kw)
        return jnp.sum(sol.ys ** 2)

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    gu, gp = jax_o0(jax.grad(loss, argnums=(0, 1)), jnp.asarray(x), jp)
    return np.asarray(gu), [np.asarray(gp[k]) for k in params]


@pytest.mark.parametrize("B,rule,grid", R.MLP_CASES,
                         ids=[f"B{B}-{r}-{g}" for B, r, g in R.MLP_CASES])
def test_row_split_neural_field_matches_jax(ranks, jax_refs, B, rule, grid):
    """Σ ys² of the batched field fused_mlp2(p, u) with u0 (B, 4) split by
    rows over 3 ranks (B = 7: 3, 3, 1): u0's and the weights' gradients
    against JAX's unsharded ones and the port's at 1e-10, with the rule
    and the forward and reverse steps of the port's unsharded run; every
    K3 call on rank 0 over its own rows only."""
    gu_j, gp_j = jax_refs[f"mlp B{B} {rule} {grid}"]
    x, params = R.mlp_inputs(B)
    u0 = torch.from_numpy(x).requires_grad_()
    pp = {k: v.requires_grad_() for k, v in
          from_numpy_tree(params, "cpu", torch.float64).items()}
    gu_p, gp_p, sol_p = R.mlp_gradient(P, u0, pp, rule, grid)
    got = ranks[f"mlp B{B} {rule} {grid}"]
    assert got["rows"] == [-(-B // 3)], got["rows"]
    assert got["ys_type"] == "DTensor" and got["gp_type"] == "Tensor"
    assert got["gu_placements"] == "(Shard(dim=0),)"
    assert got["sensealg"] == type(sol_p.sensealg).__name__
    assert got["stats"] == R._stats(sol_p.stats)
    if sol_p.adjoint is not None:
        assert got["adj"] == R._stats(sol_p.adjoint.stats)
    _close(got["gu"], gu_j, what="u0-grad vs JAX")
    _close(got["gu"], R._np(gu_p), what="u0-grad vs the port unsharded")
    for k, g, gj, gpp in zip(params, got["gp"], gp_j, gp_p):
        _close(g, gj, what=f"{k}-grad vs JAX")
        _close(g, R._np(gpp), what=f"{k}-grad vs the port unsharded")
