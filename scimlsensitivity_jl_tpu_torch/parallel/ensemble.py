"""Ensemble solves, the data-parallel surface (PyTorch port).

Counterpart of `scimlsensitivity_jl_tpu/parallel/ensemble.py`:
`EnsembleProblem`, `make_mesh`, `solve_ensemble` (backends "vmap" and
"shard_map", `reduction`) and `ensemble_summary`.

The JAX package vmaps a whole solve: every lane keeps its own step
controller. The port's adaptive loop reads its error norm on the host,
which `torch.func.vmap` cannot batch, and the kernel Functions have no
vmap rule. So here:

  * backend="vmap" is a loop over the trajectories that stacks their
    outputs. Each trajectory is exactly its own `solve`, with every field
    (kernel fields included), problem type and sensealg, and autograd
    flows through the stack;
  * a mesh is a list of devices (`make_mesh`): the cards that exist, else
    the CPU repeated;
  * backend="shard_map" splits the trajectories into len(mesh) contiguous
    shards; each shard's problems move to its device (u0 and p; the field
    must accept tensors there), run there, and their outputs come back to
    the first device of the mesh. Autograd crosses the copies.

`map_segments` is the helper both backends and the shadowing rules'
`segment_parallel` modes map their independent solves through, so `mesh=`
means the same there. A batched state with a step controller per
trajectory would be the fast design for the card (ROADMAP §2).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, List, Optional

import torch

from ..problems import remake
from ..solution import ODESolution
from ..solve import solve
from ..solvers.integrate import Stats
from ..utils.pytree import tree_to
from . import sharded

__all__ = ["EnsembleProblem", "solve_ensemble", "make_mesh",
           "ensemble_summary", "map_segments"]


@dataclass(frozen=True)
class EnsembleProblem:
    """prob + prob_func(prob, i) -> the problem of trajectory i;
    output_func(sol, i) -> what trajectory i returns (default: its
    solution)."""

    prob: Any
    prob_func: Optional[Callable] = None
    output_func: Optional[Callable] = None

    def instantiate(self, i):
        if self.prob_func is None:
            return self.prob
        return self.prob_func(self.prob, i)


def make_mesh(n_devices: Optional[int] = None, axis: str = "traj"
              ) -> List[torch.device]:
    """n devices (default: all cards): the first n cards, or, with no
    card, the CPU n times (default once). `axis` is accepted for the JAX
    signature; a device list has one axis."""
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n_cards == 0:
        return [torch.device("cpu")] * (n_devices or 1)
    n = n_devices or n_cards
    if n > n_cards:
        raise ValueError(f"make_mesh({n}): this host has {n_cards} cards")
    return [torch.device("cuda", i) for i in range(n)]


def map_segments(fn: Callable, count: int, mesh, out_device=None) -> list:
    """[fn(i, device) for i in range(count)], the outputs' tensors on
    `out_device`. mesh None: every call on out_device. A mesh (a list of
    devices): len(mesh) contiguous shards of count // len(mesh) calls,
    shard s on mesh[s]; count must divide by the mesh size."""
    if mesh is None:
        return [fn(i, out_device) for i in range(count)]
    nd = len(mesh)
    if count % nd != 0:
        raise ValueError(
            f"{count} independent solves must divide evenly over the "
            f"{nd}-device mesh; got {count} % {nd} != 0")
    per = count // nd
    out_device = mesh[0] if out_device is None else out_device
    return [tree_to(fn(i, mesh[i // per]), out_device)
            for i in range(count)]


def _stack(outs):
    """Stack a list of like outputs on a new leading axis: tensors, trees
    of them, Python numbers, or solutions (ts, ys, u_final, stats and
    retcode stacked; the dense output and events dropped)."""
    first = outs[0]
    if isinstance(first, ODESolution):
        return ODESolution(
            ts=torch.stack([o.ts for o in outs]),
            ys=_stack([o.ys for o in outs]),
            stats=Stats(*(torch.tensor([getattr(o.stats, f) for o in outs])
                          for f in Stats._fields)),
            retcode=torch.tensor([o.retcode for o in outs]),
            prob=first.prob, solver=first.solver, sensealg=first.sensealg,
            unravel_u=first.unravel_u,
            u_final=(None if first.u_final is None
                     else torch.stack([o.u_final for o in outs])))
    if isinstance(first, torch.Tensor):
        return torch.stack(outs)
    if isinstance(first, dict):
        return {k: _stack([o[k] for o in outs]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_stack(list(z)) for z in zip(*outs))
    return torch.as_tensor(outs)


def solve_ensemble(
    ens: EnsembleProblem,
    solver=None,
    *,
    trajectories: int,
    backend: str = "vmap",
    mesh=None,
    axis: str = "traj",
    reduction: Optional[Callable] = None,
    **solve_kwargs,
):
    """Solve `trajectories` variations of ens.prob: the outputs stacked on
    a leading trajectory axis (an ODESolution with stacked ts, ys, u_final,
    stats and retcode, or the stacked output_func values), or
    reduction(stacked). backend "vmap": one trajectory after another on
    each problem's own device; "shard_map": contiguous shards over `mesh`
    (default `make_mesh(axis=axis)`), the outputs on mesh[0]."""
    if backend not in ("vmap", "shard_map"):
        raise ValueError(f"unknown ensemble backend {backend!r}")
    sharded.refuse_sharded(ens.prob, "solve_ensemble")

    def run_one(i, device):
        prob_i = ens.instantiate(i)
        if device is not None:  # u0 and p on the shard's device
            prob_i = remake(prob_i, u0=tree_to(prob_i.u0, device),
                            p=tree_to(prob_i.p, device))
        sol = solve(prob_i, solver, **solve_kwargs)
        if ens.output_func is not None:
            return ens.output_func(sol, i)
        return sol

    if backend == "shard_map":
        mesh = mesh if mesh is not None else make_mesh(axis=axis)
        outs = map_segments(run_one, trajectories, mesh)
    else:
        outs = map_segments(run_one, trajectories, None)
    stacked = _stack(outs)
    return reduction(stacked) if reduction is not None else stacked


def ensemble_summary(ys, quantiles=(0.05, 0.95)):
    """Per-time statistics over the leading trajectory axis (SciMLBase
    EnsembleSummary): {mean, var (ddof 1), median, qlow, qhigh}, the
    quantiles and the median interpolated linearly, as numpy's and JAX's."""
    ys = torch.as_tensor(ys)
    qs = torch.tensor(quantiles, dtype=ys.dtype, device=ys.device)
    ql, qh = torch.quantile(ys, qs, dim=0)
    return {
        "mean": torch.mean(ys, dim=0),
        "var": torch.var(ys, dim=0, correction=1),
        "median": torch.quantile(ys, 0.5, dim=0),
        "qlow": ql,
        "qhigh": qh,
    }
