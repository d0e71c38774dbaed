"""A state split over the ranks of a process group (PyTorch port).

The JAX package has no code of its own for this. Its tests put u0 on an
8-device mesh (`jax.device_put(u0, NamedSharding(mesh, P("x")))`,
tests/test_parallel.py:72 and :204), and XLA's partitioner carries the
sharding through the solver loops and turns the field's `jnp.roll` into
halo exchanges. Here the caller builds a 1-D `DeviceMesh`
(`torch.distributed.device_mesh.init_device_mesh`) over the process group
it made, and passes `solve` the state as
`distribute_tensor(u0, mesh, [Shard(0)])`; p stays a plain tensor, which
every rank holds whole. Nothing else changes at the call.

How such a solve runs:

  * every rank runs the solver on its own shard, a plain tensor (`Shard(0)`
    splits n cells, or the n rows of a 2-D (n, d) state, as `torch.chunk`
    does; an empty shard raises `ShardedStateError`). Step sizes, accept
    or reject and every other host decision come from global reductions
    whose bits are the same on every rank, so every rank takes the same
    steps and calls the same collectives in the same order;
  * the caller's field sees the whole state as a DTensor and p as
    replicated DTensors. A field written with `torch.roll` runs through
    DTensor's own rules, which gather the whole state for it (ROADMAP §3);
    the flagship reaction-diffusion field (`ops.rd1d.make_rd1d_field`)
    exchanges one ghost cell per side (`ShardContext.halo`) and launches
    K1/K2 on the rank's shard, the RK4 block (`make_rd1d_rk4_block`) 4(S+1)
    cells per side for K5/K6, and `ops.mlp.fused_mlp2` on a batch split by
    rows launches K3/K4 on the rank's rows, which need no exchange;
  * the error norms and BacksolveAdjoint's drift reduce over every rank's
    shard: the solve passes `ShardNorms` down as `SolveOptions.norms`
    (`solvers.integrate.Norms` is the whole-vector version);
  * inside the solve a cotangent of p is this rank's partial sum; one sum
    over the ranks at the solve's boundary (`sum_over_ranks`) makes p's
    gradient whole, the same on every rank. The joined reverse states of
    BacksolveAdjoint and InterpolatingAdjoint carry such partial sums in
    their q rows: the rules declare them
    (`Norms.with_partial_rows`), and the norms sum them before squaring;
    the Gauss–Kronrod error estimates of p's integral, vectors of such
    partial sums, are normed the same way (`Norms.partial_norm`), so every
    rank refines the same panels.

Every collective is an `all_gather`: gloo takes it on CPU and CUDA tensors
(its send and recv take host memory only: on a CUDA tensor they fail), and
NCCL on CUDA tensors. Sums over ranks add the gathered values in rank order,
so every rank gets the same bits.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..solvers.integrate import Norms

__all__ = ["ShardContext", "ShardNorms", "ShardedStateError",
           "ShardedStateUnsupported", "refuse", "refuse_sharded",
           "is_sharded", "unwrapped", "to_local", "from_local", "replicate",
           "replicated_local", "sum_over_ranks"]


class ShardedStateError(ValueError):
    """A sharded state that the port cannot split: not a 1-D or 2-D
    DTensor with placement Shard(0) over a 1-D mesh, a rank with an empty
    shard, or a shard narrower than a kernel's ghost width."""


class ShardedStateUnsupported(NotImplementedError):
    """A problem type, rule, option or kernel that does not run on a
    sharded state yet (ROADMAP §1 queues each)."""


def refuse(feature: str) -> ShardedStateUnsupported:
    """The error raised, before any launch, for a feature that a sharded
    state does not reach yet."""
    return ShardedStateUnsupported(
        f"{feature} does not run on a sharded state (a DTensor u0) yet. A "
        "sharded solve takes an ODEProblem with an explicit Runge-Kutta "
        "stepper (Tsit5), adaptive or on a fixed grid, under a reverse-mode "
        "rule (sensealg=None where it resolves to one, BacksolveAdjoint, "
        "InterpolatingAdjoint, GaussAdjoint, GaussKronrodAdjoint, "
        "QuadratureAdjoint or DirectAdjoint, with any of their options but "
        "an autojacvec other than AutoVJP), with no callbacks; solve this "
        "one on a whole state")


def unwrapped(x):
    """x without the wrappers of torch.func's transforms, which hide a
    DTensor's type inside `torch.func.vjp` and `vmap`."""
    while (isinstance(x, torch.Tensor)
           and torch._C._functorch.is_functorch_wrapped_tensor(x)):
        x = torch._C._functorch.get_unwrapped(x)
    return x


def is_sharded(x) -> bool:
    """Whether x is a DTensor, inside torch.func's transforms too."""
    return isinstance(unwrapped(x), DTensor)


def refuse_sharded(prob, feature: str) -> None:
    """Raise `refuse(feature)` when the problem's state is sharded: the
    entry points that a sharded state does not reach yet call it before
    anything runs."""
    if is_sharded(getattr(prob, "u0", None)):
        raise refuse(feature)


def _placed(x: DTensor, placements) -> DTensor:
    return (x if tuple(x.placements) == tuple(placements)
            else x.redistribute(x.device_mesh, placements))


class ShardContext:
    """One sharded state's layout: its mesh and process group, its global
    length n (cells, or rows of a 2-D state whose rows hold `row` values
    each), each rank's shard (`sizes`, torch.chunk's split), and the
    collectives over them. Counters: `exchanges` (halo exchanges),
    `ghost_cells` (the ghost values they brought this rank from its
    neighbours; a global end's edge copy exchanges nothing and counts
    none) and
    `comm_seconds` (host time inside every collective, gloo's staging
    copies included)."""

    _cache = {}

    def __init__(self, mesh, n: int, row: int = 1):
        self.mesh = mesh
        self.row = row
        self.group = mesh.get_group()
        self.world = mesh.size()
        self.rank = mesh.get_local_rank()
        chunk = -(-n // self.world)
        self.sizes = [max(0, min(chunk, n - r * chunk))
                      for r in range(self.world)]
        empty = [r for r, s in enumerate(self.sizes) if s == 0]
        if empty:
            raise ShardedStateError(
                f"Shard(0) splits n={n} cells over {self.world} ranks as "
                f"torch.chunk does, {self.sizes}, which leaves rank(s) "
                f"{empty} an empty shard; every rank needs at least one "
                "cell: use fewer ranks or more cells")
        self.n = n
        self.local_n = self.sizes[self.rank]
        self.exchanges = self.ghost_cells = 0
        self.comm_seconds = 0.0

    @property
    def numel(self) -> int:
        """The values of the whole state (cells, or rows × row)."""
        return self.n * self.row

    @property
    def sides(self) -> Tuple[bool, bool]:
        """Whether this rank's shard has a neighbour on its (left, right)."""
        return self.rank > 0, self.rank + 1 < self.world

    @classmethod
    def of(cls, x) -> "ShardContext":
        """The context of a sharded state x (checked), one per mesh and
        length."""
        x = unwrapped(x)
        if not isinstance(x, DTensor):
            raise ShardedStateError(
                f"expected a DTensor state, got {type(x).__name__}")
        mesh = x.device_mesh
        if x.dim() not in (1, 2) or mesh.ndim != 1 or tuple(
                x.placements) != (Shard(0),):
            raise ShardedStateError(
                "a sharded state is a 1-D DTensor, or a 2-D one split by "
                "rows, with placements [Shard(0)] over a 1-D DeviceMesh; "
                f"got shape {tuple(x.shape)}, placements "
                f"{tuple(x.placements)} on a {mesh.ndim}-D mesh")
        key = (mesh, tuple(x.shape))
        shard = cls._cache.get(key)
        if shard is None:
            row = x.shape[1] if x.dim() == 2 else 1
            shard = cls._cache[key] = cls(mesh, x.shape[0], row)
        return shard

    # -- collectives ---------------------------------------------------------

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """(world, *x.shape): every rank's x, in rank order."""
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.world)]
        t = time.perf_counter()
        dist.all_gather(parts, x, group=self.group)
        self.comm_seconds += time.perf_counter() - t
        return torch.stack(parts)

    def rank_sum(self, x: torch.Tensor) -> torch.Tensor:
        """Σ over the ranks of x, added in rank order: the same bits on
        every rank."""
        parts = self.gather(x)
        total = parts[0]
        for r in range(1, self.world):
            total = total + parts[r]
        return total

    def halo(self, *xs: torch.Tensor, width: int = 1) -> torch.Tensor:
        """The ghosts of this rank's shards xs (vectors of one state's
        layout): [left, right] of each in turn, `width` cells each, the
        cells beyond the shard, which are the neighbours' edge cells in
        order; at the global ends the shard's own edge cell repeated, the
        edge-copy ghost of `ops.rd1d`. One all_gather of each rank's edge
        cells; every shard must hold `width` cells."""
        if min(self.sizes) < width:
            raise ShardedStateError(
                f"a halo of {width} cells per side needs every shard to "
                f"hold at least {width} cells; the shards hold {self.sizes}")
        w = width
        own = torch.stack([v for x in xs for v in (x[:w], x[-w:])])
        edges = self.gather(own)
        self.exchanges += 1
        # a left ghost is the last cells of the rank before, a right one
        # the first cells of the rank after
        left, right = self.sides
        left = (edges[self.rank - 1, 1::2] if left
                else own[0::2, :1].expand(-1, w))
        right = (edges[self.rank + 1, 0::2] if right
                 else own[1::2, -1:].expand(-1, w))
        self.ghost_cells += w * sum(self.sides) * len(xs)
        return torch.stack([left, right], dim=1).reshape(-1)

    # -- global reductions of local vectors --------------------------------

    def mean_sq(self, x: torch.Tensor,
                partial: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        """mean(|x|²) over the whole vector whose local part is x: its
        rows [a, b) = `partial`, per-rank partial sums, summed over the
        ranks first; every other row sharded."""
        sq = x.abs() ** 2
        if partial is None:
            local, m = sq.sum().reshape(1), 0
        else:
            a, b = partial
            m = b - a
            local = torch.cat([(sq[:a].sum() + sq[b:].sum()).reshape(1),
                               x[a:b].to(sq.dtype)])
        total = self.rank_sum(local)
        segments, rest = divmod(x.numel() - m, self.local_n)
        if rest:
            raise ShardedStateError(
                f"a vector of {x.numel()} local rows ({m} partial) is not "
                f"made of shards of {self.local_n} cells")
        s = total[0] + (total[1:] ** 2).sum() if m else total[0]
        return s / (segments * self.n + m)

    def global_sum(self, x: torch.Tensor) -> torch.Tensor:
        """Σ x over the whole sharded vector (a 0-dim result)."""
        return self.rank_sum(x.sum().reshape(1))[0]

    def partial_norm(self, x: torch.Tensor) -> torch.Tensor:
        """‖Σ over the ranks of x‖₂: x holds this rank's partial sums."""
        return torch.linalg.vector_norm(self.rank_sum(x))

    # -- layout ------------------------------------------------------------

    def local(self, x, dim: int = 0) -> torch.Tensor:
        """This rank's rows of x, a DTensor split along dim (redistributed
        there first if it is placed otherwise)."""
        if not isinstance(x, DTensor):
            raise ShardedStateError(
                "a field on a sharded state returns a DTensor; got "
                f"{type(x).__name__}")
        return _placed(x, [Shard(dim)]).to_local()

    def wrap(self, x: torch.Tensor, dim: int = 0) -> DTensor:
        """The DTensor whose rows along dim are split over the ranks, x
        this rank's rows."""
        shape = list(x.shape)
        shape[dim] = self.n
        stride, acc = [0] * len(shape), 1
        for i in range(len(shape) - 1, -1, -1):
            stride[i] = acc
            acc *= shape[i]
        return DTensor.from_local(x.contiguous(), self.mesh, [Shard(dim)],
                                  run_check=False, shape=torch.Size(shape),
                                  stride=tuple(stride))

    def partial_of(self, g) -> torch.Tensor:
        """A cotangent of a replicated value as this rank's partial sum:
        a Partial DTensor's local value; a replicated one whole on rank 0
        and zero elsewhere (exact, where a split by the world size would
        round); any other placement gathered first."""
        if not isinstance(g, DTensor):
            return g
        if all(pl.is_partial() for pl in g.placements):
            return g.to_local()
        whole = _placed(g, [Replicate()]).to_local()
        return whole if self.rank == 0 else torch.zeros_like(whole)

    def local_field(self, f):
        """f(u, p, t) over the whole state -> the same field over this
        rank's shard: u enters as the DTensor, each leaf of p as a
        replicated DTensor, and the value leaves as the shard's rows."""
        def field(u, p, t):
            out = f(from_local(u, self), replicate(p, self), t)
            return to_local(out, self)

        field.__name__ = getattr(f, "__name__", "field")
        return field


def _tree_map(fn, tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {key: _tree_map(fn, v) for key, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


class ShardNorms(Norms):
    """The step controller's reductions over a vector made of every rank's
    shard (each rank holds its rows of it): sums over the ranks, the same
    bits on every rank, so every rank takes the same steps. `partial`:
    rows [a, b) of each vector that hold per-rank partial sums instead
    (`with_partial_rows`)."""

    def __init__(self, shard: ShardContext,
                 partial: Optional[Tuple[int, int]] = None):
        self.shard, self.partial = shard, partial

    def mean_sq(self, x: torch.Tensor) -> torch.Tensor:
        return self.shard.mean_sq(x, self.partial)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return self.shard.global_sum(x)

    def vector_norm(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sqrt(self.sum(x.abs() ** 2))

    def partial_norm(self, x: torch.Tensor) -> torch.Tensor:
        return self.shard.partial_norm(x)

    def with_partial_rows(self, start: int, stop: int) -> "ShardNorms":
        return ShardNorms(self.shard, (start, stop))

    def summed(self, x: torch.Tensor) -> torch.Tensor:
        if self.partial is None:
            return x
        a, b = self.partial
        return torch.cat([x[:a], self.shard.rank_sum(x[a:b]), x[b:]])


# -- autograd across the layouts (setup_context form, so torch.func.vjp
# takes them) -------------------------------------------------------------


class _FromLocal(torch.autograd.Function):
    @staticmethod
    def forward(x, shard, dim):
        return shard.wrap(x, dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.shard, ctx.dim = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        return ctx.shard.local(g, ctx.dim), None, None


class _ToLocal(torch.autograd.Function):
    @staticmethod
    def forward(x, shard, dim):
        return shard.local(x, dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.shard, ctx.dim = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, g):
        return ctx.shard.wrap(g, ctx.dim), None, None


class _Replicated(torch.autograd.Function):
    @staticmethod
    def forward(x, shard):
        return DTensor.from_local(x, shard.mesh, [Replicate()],
                                  run_check=False)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.shard = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return ctx.shard.partial_of(g), None


class _ReplicatedLocal(torch.autograd.Function):
    @staticmethod
    def forward(x, shard):
        return _placed(x, [Replicate()]).to_local()

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.shard = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return DTensor.from_local(g, ctx.shard.mesh, [Partial()],
                                  run_check=False), None


class _SumOverRanks(torch.autograd.Function):
    @staticmethod
    def forward(x, shard):
        return x.clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.shard = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return ctx.shard.rank_sum(g), None


def to_local(x: DTensor, shard: ShardContext, dim: int = 0) -> torch.Tensor:
    """This rank's rows of x, differentiably: the cotangent goes back as a
    DTensor placed like x."""
    return _ToLocal.apply(x, shard, dim)


def from_local(x: torch.Tensor, shard: ShardContext,
               dim: int = 0) -> DTensor:
    """The DTensor split along dim whose rows here are x, differentiably."""
    return _FromLocal.apply(x, shard, dim)


def replicate(tree, shard: ShardContext):
    """Each tensor of a tree as a replicated DTensor; its cotangent comes
    back as this rank's partial sum."""
    return _tree_map(lambda x: _Replicated.apply(x, shard), tree)


def replicated_local(x, shard: ShardContext) -> torch.Tensor:
    """A replicated value as a plain tensor whose cotangent is this rank's
    partial sum: a replicated DTensor's local value (the cotangent goes back
    as a Partial DTensor), or a plain tensor behind `sum_over_ranks`."""
    if is_sharded(x):
        return _ReplicatedLocal.apply(x, shard)
    return _SumOverRanks.apply(x, shard)


def sum_over_ranks(tree, shard: ShardContext):
    """Identity on each tensor of a tree, whose cotangent arrives as
    per-rank partial sums: the backward sums them over the ranks, the same
    bits on every rank."""
    return _tree_map(lambda x: _SumOverRanks.apply(x, shard), tree)
