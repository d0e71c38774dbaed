"""The rank side of tests/test_torch_sharded.py, test_torch_sharded_kernels.py
and test_torch_sharded_rules.py: a sharded state solved by gloo processes on
the CPU. It imports no JAX.

    python tests/sharded_ranks.py OUT.pt [NAME ...]

starts four ranks (the `spawn` context, as `entry.dryrun_multichip` does)
and saves, from rank 0, {case: result} to OUT.pt. World sizes 4, 3 and 2
are the whole group and its subgroups of ranks {0, 1, 2} and {0, 1}, so
one start of four processes serves every case. Each case gathers its
gradients whole (u0's from its DTensor), as float64 numpy arrays, beside
its step counts and seconds; the test module holds them against the JAX
package and the port's unsharded solve. NAME arguments keep only the cases
whose names contain one of them.
"""

from __future__ import annotations

import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

WORLD = 4

# the JAX tests' heat field (tests/test_parallel.py:72, :204)
HEAT_N = 1024
HEAT_STEPS = 256  # of the fixed-grid case's 2048 (its docstring says why)
HEAT_DT = 0.1 / 2048

# the flagship field on ragged grids: 64 fixed Tsit5 steps of RD_DT, with
# D·inv_dx2·dt = RD_CFL at every n (the flagship's regime of little
# diffusion per step, so that BacksolveAdjoint's backward reconstruction,
# which amplifies the stiffest mode by exp(4·RD_CFL·RD_STEPS), stays
# accurate) and k = 1.5
RD_N, RD_N_LARGE = 1027, 16411
RD_STEPS, RD_DT, RD_CFL = 64, 1e-3, 0.02
RD_ADJ = dict(adj_rtol=1e-8, adj_atol=1e-10)
RD_RULES = ("None", "DirectAdjoint", "InterpolatingAdjoint", "GaussAdjoint")
# (world, n, rule): every rule at world size 4; world size 3 (shards of 343,
# 342, 342) under InterpolatingAdjoint, whose pinned reverse norms the
# joined [λ; q] with p's partial sums in its q rows; BacksolveAdjoint by
# the global size at n = 16411
RD_CASES = ([(4, RD_N, rule) for rule in RD_RULES]
            + [(3, RD_N, "InterpolatingAdjoint"), (4, RD_N_LARGE, "None")])

# the reverse-mode rules and their options on the flagship field, beyond
# RD_CASES: label -> (rule, its options, grid). "fixed": RD_STEPS steps of
# RD_DT forward, the reverse adaptive; "adaptive": Tsit5 at RULE_TOL;
# "unroll": adaptive with unroll=True (the masked scan's budget)
RULE_TOL = dict(rtol=1e-6, atol=1e-8, max_steps=128)
# unroll=True: JAX emits max_steps forward and adj_max_steps + |saveat| + 4
# reverse iterations straight-line; the solve takes 5 attempts forward and
# at most 10 reverse steps at this reverse tolerance
UNROLL_TOL = dict(rtol=1e-6, atol=1e-8, max_steps=8, adj_rtol=1e-6,
                  adj_atol=1e-8, adj_max_steps=12)
RULE_CASES = {
    "Quadrature": ("QuadratureAdjoint", {}, "fixed"),
    "Quadrature tol": ("QuadratureAdjoint",
                       dict(abstol=1e-9, reltol=1e-7, max_depth=3), "fixed"),
    "GaussKronrod": ("GaussKronrodAdjoint", {}, "fixed"),
    "GaussKronrod tol": ("GaussKronrodAdjoint",
                         dict(abstol=1e-12, reltol=1e-10, max_depth=3),
                         "fixed"),
    "GaussKronrod pinned": ("GaussKronrodAdjoint", dict(pinned_reverse=True),
                            "fixed"),
    "Interpolating ckpt": ("InterpolatingAdjoint", dict(checkpointing=True),
                           "fixed"),
    "Interpolating ckpts": ("InterpolatingAdjoint",
                            dict(checkpointing=True,
                                 checkpoints=(0.016, 0.032, 0.048)), "fixed"),
    "Gauss ckpt": ("GaussAdjoint", dict(checkpointing=True), "fixed"),
    "GaussKronrod ckpt": ("GaussKronrodAdjoint", dict(checkpointing=True),
                          "fixed"),
    "Interpolating unpinned": ("InterpolatingAdjoint",
                               dict(pinned_reverse=False), "fixed"),
    "Interpolating pinned": ("InterpolatingAdjoint",
                             dict(pinned_reverse=True, pinned_fallback=False),
                             "fixed"),
    "Gauss pinned": ("GaussAdjoint", dict(pinned_reverse=True), "fixed"),
    "Gauss n_nodes": ("GaussAdjoint", dict(n_nodes=3), "fixed"),
    "Backsolve": ("BacksolveAdjoint", {}, "fixed"),
    "Backsolve unguarded": ("BacksolveAdjoint",
                            dict(checkpointing=False, recon_guard=None),
                            "fixed"),
    "Direct": ("DirectAdjoint", {}, "adaptive"),
    "Direct remat": ("DirectAdjoint", dict(max_steps=96, remat=True),
                     "adaptive"),
    "Direct unroll": ("DirectAdjoint", {}, "unroll"),
    "None unroll": (None, {}, "unroll"),
    "Interpolating unroll": ("InterpolatingAdjoint", {}, "unroll"),
    "Gauss adaptive": ("GaussAdjoint", {}, "adaptive"),
}
# the JAX tests' heat field under the rules whose reverse passes it would
# not take otherwise, on the fixed grid's HEAT_STEPS steps
HEAT_RULES = {"Quadrature": ("QuadratureAdjoint", {}),
              "Gauss ckpt": ("GaussAdjoint", dict(checkpointing=True))}

# the RK4 block (K5/K6) at the JAX megakernel test's problem
# (tests/test_pallas_pde.py:67-73): (world, S, chunk, bwd_chunk, blocks).
# Shards of 512 (two tiles of 256), 256 (one tile) and 342, 342, 340
# (ragged, one tile each); the last case chains 4 blocks
BLK_N, BLK_P, BLK_H = 1024, (1e-4, 1.5), 1e-5
BLK_CASES = ((2, 2, 256, 256, 1), (2, 4, 256, 512, 1), (3, 2, 512, 512, 1),
             (3, 4, 512, 512, 1), (4, 2, 512, 512, 1), (4, 4, 256, 256, 1),
             (4, 4, 256, 512, 4))

# the batched neural field y = tanh(x·W0 + b0)·W1 + b1 (fused_mlp2, K3/K4)
# on a (B, 4) state split by rows over 3 ranks, 4 -> 16 -> 4: every
# reverse-mode rule (sensealg=None resolves to GaussAdjoint, or to the
# fixed grid's discrete path), on the fixed grid and adaptive
MLP_D, MLP_HIDDEN, MLP_T1, MLP_DT = 4, 16, 1.0, 0.1
MLP_RULES = ("None", "BacksolveAdjoint", "InterpolatingAdjoint",
             "GaussAdjoint", "GaussKronrodAdjoint", "QuadratureAdjoint",
             "DirectAdjoint")
MLP_CASES = [(B, rule, grid) for B in (8, 7) for rule in MLP_RULES
             for grid in ("fixed", "adaptive")]

# halo exchanges: (world, n) with uneven shards (torch.chunk: 1027 over 4
# is 257, 257, 257, 256) and one-cell shards (13 over 4: 4, 4, 4, 1)
HALO_CASES = ((4, 1027), (4, 13), (3, 1027), (3, 7), (2, 5), (2, 3))


def heat_u0(n=HEAT_N) -> np.ndarray:
    xs = np.linspace(0.0, 1.0, n, endpoint=False)
    return np.sin(2 * np.pi * xs) + 0.5 * np.sin(6 * np.pi * xs)


def heat_scale(n=HEAT_N) -> float:
    return float(n * n) / 400.0


def rd_u0(n: int) -> np.ndarray:
    """A smooth state from a numpy seed: three random sine modes."""
    g = np.random.default_rng(n)
    x = np.arange(n) / n
    amp, k, ph = g.uniform(0.05, 0.2, 3), g.integers(1, 6, 3), g.uniform(
        0.0, 2 * np.pi, 3)
    return 0.5 + sum(a * np.sin(2 * np.pi * kk * x + f)
                     for a, kk, f in zip(amp, k, ph))


def rd_p(n: int):
    return (RD_CFL / (n * n * RD_DT), 1.5)


def rd_sensealg(P, rule: str):
    return None if rule == "None" else getattr(P, rule)()


def _np(x):
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        x = x.full_tensor()
    return x.detach().double().cpu().numpy()


def _stats(s):
    return None if s is None else tuple(int(v) for v in s)


def heat_field(n=HEAT_N):
    scale = heat_scale(n)

    def heat(u, p, t):
        return p * scale * (torch.roll(u, 1) + torch.roll(u, -1) - 2.0 * u)

    return heat


def heat_gradient(P, u0, fixed: bool):
    """(u0-grad, p-grad, solution) of Σ ys[-1]² for the JAX tests' heat
    problem: adaptive Tsit5 under GaussAdjoint (:72), or the fixed grid
    under InterpolatingAdjoint (:204) on its first HEAT_STEPS steps."""
    p = torch.tensor(1.3, dtype=torch.float64, requires_grad=True)
    if fixed:
        kw = dict(dt=HEAT_DT, adaptive=False, adj_rtol=1e-8, adj_atol=1e-10,
                  adj_max_steps=4096, sensealg=P.InterpolatingAdjoint())
        tspan = (0.0, HEAT_DT * HEAT_STEPS)
    else:
        kw = dict(rtol=1e-8, atol=1e-10, max_steps=1024,
                  sensealg=P.GaussAdjoint())
        tspan = (0.0, 0.1)
    sol = P.solve(P.ODEProblem(heat_field(), u0, tspan, p), P.Tsit5(), **kw)
    gu, gp = torch.autograd.grad(torch.sum(sol.ys[-1] ** 2), (u0, p))
    return gu, gp, sol


def rd_gradient(P, u0, n: int, rule: str):
    """(u0-grad, p-grad, solution) of Σ ys[-1]² for make_rd1d_field over
    RD_STEPS fixed Tsit5 steps."""
    from scimlsensitivity_jl_tpu_torch.ops import rd1d

    p = torch.tensor(rd_p(n), dtype=torch.float64, requires_grad=True)
    t1 = RD_STEPS * RD_DT
    sol = P.solve(P.ODEProblem(rd1d.make_rd1d_field(n, 1.0 / n), u0,
                               (0.0, t1), p), P.Tsit5(), saveat=[0.0, t1],
                  dt=RD_DT, adaptive=False, sensealg=rd_sensealg(P, rule),
                  **RD_ADJ)
    gu, gp = torch.autograd.grad(torch.sum(sol.ys[-1] ** 2), (u0, p))
    return gu, gp, sol


def rule_kwargs(grid: str):
    """solve's keywords of a RULE_CASES grid."""
    if grid == "fixed":
        return dict(dt=RD_DT, adaptive=False, **RD_ADJ)
    if grid == "unroll":
        return dict(UNROLL_TOL, unroll=True)
    return dict(RULE_TOL, **RD_ADJ)


def rule_gradient(P, u0, label: str):
    """(u0-grad, p-grad, solution) of Σ ys[-1]² for make_rd1d_field at
    n = RD_N under RULE_CASES[label]."""
    from scimlsensitivity_jl_tpu_torch.ops import rd1d

    rule, opts, grid = RULE_CASES[label]
    n = RD_N
    p = torch.tensor(rd_p(n), dtype=torch.float64, requires_grad=True)
    t1 = RD_STEPS * RD_DT
    sensealg = None if rule is None else getattr(P, rule)(**opts)
    field, calls = counted(rd1d.make_rd1d_field(n, 1.0 / n))
    sol = P.solve(P.ODEProblem(field, u0, (0.0, t1), p), P.Tsit5(),
                  saveat=[0.0, t1], sensealg=sensealg, **rule_kwargs(grid))
    gu, gp = torch.autograd.grad(torch.sum(sol.ys[-1] ** 2), (u0, p))
    sol.field_calls = calls[0]
    return gu, gp, sol


def counted(field):
    """(field that counts its evaluations, pullbacks' included, [count]):
    equal counts mean the same steps, panels and quadrature nodes."""
    calls = [0]

    def f(u, p, t):
        calls[0] += 1
        return field(u, p, t)

    return f, calls


def heat_rule_gradient(P, u0, label: str):
    """heat_gradient's fixed-grid problem under HEAT_RULES[label]."""
    rule, opts = HEAT_RULES[label]
    p = torch.tensor(1.3, dtype=torch.float64, requires_grad=True)
    field, calls = counted(heat_field())
    sol = P.solve(P.ODEProblem(field, u0, (0.0, HEAT_DT * HEAT_STEPS), p),
                  P.Tsit5(), dt=HEAT_DT, adaptive=False, adj_rtol=1e-8,
                  adj_atol=1e-10, adj_max_steps=4096,
                  sensealg=getattr(P, rule)(**opts))
    gu, gp = torch.autograd.grad(torch.sum(sol.ys[-1] ** 2), (u0, p))
    sol.field_calls = calls[0]
    return gu, gp, sol


def blk_u0(n=BLK_N) -> np.ndarray:
    """The megakernel test's state (tests/test_torch_rd1d_rk4.py)."""
    i = np.arange(n)
    return np.exp(-(((i / n) - 0.5) ** 2) * 100.0) + 0.01 * np.sin(i * 0.1)


def blk_gradient(u, S: int, chunk: int, bwd_chunk: int, blocks: int = 1):
    """(y, ū, [D̄, k̄]) of Σ y² after `blocks` chained calls of the port's
    RK4 block on u (a plain tensor or a DTensor that requires grad)."""
    from scimlsensitivity_jl_tpu_torch.ops import rd1d

    blk = rd1d.make_rd1d_rk4_block(BLK_N, S, chunk=chunk,
                                   bwd_chunk=bwd_chunk)
    p = torch.tensor(BLK_P, dtype=torch.float64, requires_grad=True)
    y = u
    for _ in range(blocks):
        y = blk(y, p, float(BLK_N * BLK_N), BLK_H)
    gu, gp = torch.autograd.grad(torch.sum(y ** 2), (u, p))
    return y, gu, gp


def mlp_inputs(B: int):
    """A (B, MLP_D) state and the field's weights from a numpy seed."""
    g = np.random.default_rng(40 + B)
    d, hid = MLP_D, MLP_HIDDEN
    params = {"W0": g.standard_normal((d, hid)) / np.sqrt(d),
              "b0": 0.1 * g.standard_normal(hid),
              "W1": g.standard_normal((hid, d)) / np.sqrt(hid),
              "b1": 0.1 * g.standard_normal(d)}
    return g.uniform(-1.0, 1.0, (B, d)), params


def mlp_kwargs(grid: str):
    if grid == "fixed":
        return dict(dt=MLP_DT, adaptive=False, adj_rtol=1e-6, adj_atol=1e-8)
    return dict(rtol=1e-6, atol=1e-8)


def mlp_gradient(P, u0, params, rule: str, grid: str):
    """(u0-grad, [weights' grads], solution) of Σ ys² over saveat
    [0, T/2, T] for the batched field fused_mlp2(p, u); params: leaves that
    require grad."""
    from scimlsensitivity_jl_tpu_torch.ops import mlp

    def field(u, p, t):
        return mlp.fused_mlp2(p, u)

    sol = P.solve(P.ODEProblem(field, u0, (0.0, MLP_T1), params), P.Tsit5(),
                  saveat=[0.0, 0.5 * MLP_T1, MLP_T1],
                  sensealg=rd_sensealg(P, rule), **mlp_kwargs(grid))
    grads = torch.autograd.grad(torch.sum(sol.ys ** 2),
                                (u0, *params.values()))
    return grads[0], list(grads[1:]), sol


def _result(gu, gp, sol, seconds):
    adj = getattr(sol, "adjoint", None)
    return {"gu": _np(gu), "gp": _np(gp), "stats": _stats(sol.stats),
            "adj": _stats(adj.stats) if adj is not None else None,
            "sensealg": type(sol.sensealg).__name__, "seconds": seconds,
            "ys_type": type(sol.ys).__name__,
            "gu_placements": str(getattr(gu, "placements", None)),
            "gp_type": type(gp).__name__}


# -- cases --------------------------------------------------------------------


def case_halo(P, mesh, world, n):
    """make_rd1d_field on a DTensor: value and pullback against the plain
    edge-copy versions of the gathered state."""
    from torch.distributed.tensor import distribute_tensor, Shard

    from scimlsensitivity_jl_tpu_torch.ops import rd1d
    from scimlsensitivity_jl_tpu_torch.parallel import sharded

    g = np.random.default_rng(100 + n)
    u = torch.from_numpy(g.uniform(0.0, 1.0, n))
    lam = torch.from_numpy(g.standard_normal(n))
    p = torch.tensor([0.7, 2.3], dtype=torch.float64)
    inv_dx2 = float(n * n)
    field = rd1d.make_rd1d_field(n, 1.0 / n)
    ud = distribute_tensor(u, mesh, [Shard(0)]).requires_grad_()
    pp = p.clone().requires_grad_()
    lam_d = distribute_tensor(lam, mesh, [Shard(0)])
    f = field(ud, pp, 0.0)
    gu, gp = torch.autograd.grad(f, (ud, pp), lam_d)
    # the same pullback through torch.func, whose wrappers hide the
    # DTensor's type from the field
    _, pull = torch.func.vjp(lambda a, b: field(a, b, 0.0), ud.detach(), p)
    gu_f, gp_f = pull(lam_d)
    du_ref, dp_ref = rd1d.rd1d_vjp_reference(u, p, inv_dx2, lam)
    shard = sharded.ShardContext.of(ud)
    return {"sizes": shard.sizes, "f": _np(f),
            "f_ref": _np(rd1d.rd1d_reference(u, p, inv_dx2)),
            "du": _np(gu), "du_ref": _np(du_ref), "dp": _np(gp),
            "dp_ref": _np(dp_ref), "f_placements": str(f.placements),
            "du_func": _np(gu_f), "dp_func": _np(gp_f)}


def case_norms(P, mesh, world):
    """ShardNorms against the whole-vector Norms of the gathered vectors:
    a vector of two segments of the state's layout ([λ; u]), and a joined
    [λ; q; u] whose q rows hold per-rank partial sums (their whole value
    is the sum over the ranks)."""
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor, Shard

    from scimlsensitivity_jl_tpu_torch.parallel import sharded
    from scimlsensitivity_jl_tpu_torch.solvers.integrate import LOCAL_NORMS

    n, nq = 11, 3
    shard = sharded.ShardContext.of(distribute_tensor(
        torch.zeros(n, dtype=torch.float64), mesh, [Shard(0)]))
    rank = mesh.get_local_rank()
    g = np.random.default_rng(7)
    lam, u = g.standard_normal(n), g.standard_normal(n)
    q_parts = g.standard_normal((world, nq))  # every rank's partial sums
    a = sum(shard.sizes[:rank])
    b = a + shard.local_n
    two_local = torch.from_numpy(np.concatenate([lam[a:b], u[a:b]]))
    two_whole = torch.from_numpy(np.concatenate([lam, u]))
    joined_local = torch.from_numpy(np.concatenate(
        [lam[a:b], q_parts[rank], u[a:b]]))
    joined_whole = torch.from_numpy(np.concatenate(
        [lam, q_parts.sum(0), u]))
    norms = sharded.ShardNorms(shard)
    joined = norms.with_partial_rows(shard.local_n, shard.local_n + nq)
    got = {"mean_sq": [float(norms.mean_sq(two_local)),
                       float(LOCAL_NORMS.mean_sq(two_whole))],
           "sum": [float(norms.sum(two_local)),
                   float(LOCAL_NORMS.sum(two_whole))],
           "vector_norm": [float(norms.vector_norm(two_local)),
                           float(LOCAL_NORMS.vector_norm(two_whole))],
           "mean_sq partial": [float(joined.mean_sq(joined_local)),
                               float(LOCAL_NORMS.mean_sq(joined_whole))]}
    # every rank's values, to show that they are the same bits
    every = [None] * world
    dist.all_gather_object(every, got, group=mesh.get_group())
    return {"ranks": every, "local_is_whole": LOCAL_NORMS.with_partial_rows(
        0, 1) is LOCAL_NORMS}


def case_empty(P, mesh, world):
    """n = 5 over 4 ranks splits 2, 2, 1, 0: the field and solve name the
    empty shard."""
    from torch.distributed.tensor import distribute_tensor, Shard

    from scimlsensitivity_jl_tpu_torch.ops import rd1d

    u = distribute_tensor(torch.ones(5, dtype=torch.float64), mesh,
                          [Shard(0)])
    p = torch.tensor(rd_p(5), dtype=torch.float64)
    out = {}
    for what, fn in (
            ("field", lambda: rd1d.make_rd1d_field(5, 0.2)(u, p, 0.0)),
            ("solve", lambda: P.solve(P.ODEProblem(
                rd1d.make_rd1d_field(5, 0.2), u, (0.0, 1e-3), p),
                P.Tsit5(), dt=1e-4, adaptive=False))):
        try:
            fn()
            out[what] = ("no error", "")
        except Exception as err:  # the test asserts the class and message
            out[what] = (type(err).__name__, str(err))
    return out


class _CommCount(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the collectives that pass the dispatcher and the elements of
    their input tensors."""

    def __init__(self):
        super().__init__()
        self.ops, self.elements = {}, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        if name.startswith(("c10d", "_c10d_functional")):
            self.ops[name] = self.ops.get(name, 0) + 1
            for a in torch.utils._pytree.tree_leaves((args, kwargs)):
                if isinstance(a, torch.Tensor):
                    self.elements += a.numel()
        return func(*args, **(kwargs or {}))


def case_comm(P, mesh, world):
    """What one evaluation and one pullback move: the flagship field on a
    sharded state against the heat field written with torch.roll, under
    CommDebugMode and a dispatch mode that counts the collectives' input
    elements."""
    from torch.distributed.tensor import distribute_tensor, Shard
    from torch.distributed.tensor.debug import CommDebugMode

    from scimlsensitivity_jl_tpu_torch.ops import rd1d
    from scimlsensitivity_jl_tpu_torch.parallel import sharded

    n = RD_N
    u = distribute_tensor(torch.from_numpy(rd_u0(n)), mesh, [Shard(0)])
    out = {}
    for label, field, p in (
            ("rd1d", rd1d.make_rd1d_field(n, 1.0 / n),
             torch.tensor(rd_p(n), dtype=torch.float64)),
            ("heat", heat_field(n), torch.tensor(1.3, dtype=torch.float64))):
        shard = sharded.ShardContext.of(u)
        before = shard.exchanges
        debug, count = CommDebugMode(), _CommCount()
        with debug, count:
            ud = u.detach().requires_grad_()
            f = field(ud, p, 0.0)
            torch.autograd.grad(f, ud, torch.ones_like(f))
        out[label] = {
            "debug": {str(k): v for k, v in debug.get_comm_counts().items()},
            "ops": count.ops, "elements": count.elements,
            "exchanges": shard.exchanges - before}
    return out


def case_heat(P, mesh, world, fixed):
    from torch.distributed.tensor import distribute_tensor, Shard

    u0 = distribute_tensor(torch.from_numpy(heat_u0()), mesh,
                           [Shard(0)]).requires_grad_()
    t = time.perf_counter()
    gu, gp, sol = heat_gradient(P, u0, fixed)
    return _result(gu, gp, sol, time.perf_counter() - t)


def case_rd(P, mesh, world, n, rule):
    from torch.distributed.tensor import distribute_tensor, Shard

    u0 = distribute_tensor(torch.from_numpy(rd_u0(n)), mesh,
                           [Shard(0)]).requires_grad_()
    t = time.perf_counter()
    gu, gp, sol = rd_gradient(P, u0, n, rule)
    return _result(gu, gp, sol, time.perf_counter() - t)


def case_rule(P, mesh, world, label):
    from torch.distributed.tensor import distribute_tensor, Shard

    u0 = distribute_tensor(torch.from_numpy(rd_u0(RD_N)), mesh,
                           [Shard(0)]).requires_grad_()
    t = time.perf_counter()
    gu, gp, sol = rule_gradient(P, u0, label)
    out = _result(gu, gp, sol, time.perf_counter() - t)
    adj = sol.adjoint
    out["reverse"] = None if adj is None else (adj.reverse, adj.resolves)
    out["field_calls"] = sol.field_calls
    return out


def case_heat_rule(P, mesh, world, label):
    from torch.distributed.tensor import distribute_tensor, Shard

    u0 = distribute_tensor(torch.from_numpy(heat_u0()), mesh,
                           [Shard(0)]).requires_grad_()
    t = time.perf_counter()
    gu, gp, sol = heat_rule_gradient(P, u0, label)
    out = _result(gu, gp, sol, time.perf_counter() - t)
    out["reverse"] = (sol.adjoint.reverse, sol.adjoint.resolves)
    out["field_calls"] = sol.field_calls
    return out


def case_block(P, mesh, world, S, chunk, bwd_chunk, blocks):
    """The RK4 block on a DTensor: its value and gradients gathered whole,
    the placements, the halo exchanges of this rank and the ghost cells of
    every rank, in rank order."""
    from torch.distributed.tensor import distribute_tensor, Shard

    from scimlsensitivity_jl_tpu_torch.ops import rd1d
    from scimlsensitivity_jl_tpu_torch.parallel import sharded

    u = distribute_tensor(torch.from_numpy(blk_u0()), mesh,
                          [Shard(0)]).requires_grad_()
    shard = sharded.ShardContext.of(u)
    ex, cells = shard.exchanges, shard.ghost_cells
    launches = (rd1d.rd1d_rk4_fwd_cuda.launches,
                rd1d.rd1d_rk4_vjp_cuda.launches)
    y, gu, gp = blk_gradient(u, S, chunk, bwd_chunk, blocks)
    cells = shard.gather(torch.tensor([shard.ghost_cells - cells]))
    return {"y": _np(y), "gu": _np(gu), "gp": _np(gp),
            "placements": str(y.placements),
            "gu_placements": str(gu.placements), "gp_type": type(gp).__name__,
            "exchanges": shard.exchanges - ex,
            "ghost_cells": cells.reshape(-1).tolist(), "sizes": shard.sizes,
            "launches": (rd1d.rd1d_rk4_fwd_cuda.launches - launches[0],
                         rd1d.rd1d_rk4_vjp_cuda.launches - launches[1])}


def case_block_errors(P, mesh, world):
    """Shards the block cannot take, each raising on every rank before any
    exchange: 40 cells over 4 ranks (10 each) at S = 2, whose ghost width
    is 12; 1024 over 3 ranks (342, 342, 340) at chunk 256."""
    from torch.distributed.tensor import distribute_tensor, Shard

    from scimlsensitivity_jl_tpu_torch.ops import rd1d
    from scimlsensitivity_jl_tpu_torch.parallel import sharded

    out = {}
    p = torch.tensor(BLK_P, dtype=torch.float64)
    for what, n, S, chunk, m in (("narrow", 40, 2, 40, mesh[4]),
                                 ("ragged chunk", BLK_N, 2, 256, mesh.get(3))):
        if m is None:
            continue
        u = distribute_tensor(torch.ones(n, dtype=torch.float64), m,
                              [Shard(0)])
        shard = sharded.ShardContext.of(u)
        before = shard.exchanges
        try:
            rd1d.make_rd1d_rk4_block(n, S, chunk=chunk, bwd_chunk=chunk)(
                u, p, 1.0, 1e-9)
            out[what] = ("no error", "", 0)
        except Exception as err:  # the test asserts the class and message
            out[what] = (type(err).__name__, str(err),
                         shard.exchanges - before)
    return out


def case_mlp(P, mesh, world, B, rule, grid):
    """The row-split neural field: u0 (B, 4) split by rows, the weights
    plain; the gradients gathered whole, with K3/K4 counted on this rank's
    rows (plain versions on the CPU: the rows each call covered)."""
    from torch.distributed.tensor import distribute_tensor, Shard

    from scimlsensitivity_jl_tpu_torch.ops import mlp
    from scimlsensitivity_jl_tpu_torch.utils.pytree import from_numpy_tree

    x, params = mlp_inputs(B)
    u0 = distribute_tensor(torch.from_numpy(x), mesh,
                           [Shard(0)]).requires_grad_()
    pp = {k: v.requires_grad_() for k, v in
          from_numpy_tree(params, "cpu", torch.float64).items()}
    rows = []
    fwd = mlp.mlp2_fwd_reference

    def counting(x_, *w):
        rows.append(x_.shape[0])
        return fwd(x_, *w)

    mlp.mlp2_fwd_reference = counting
    try:
        t = time.perf_counter()
        gu, gp, sol = mlp_gradient(P, u0, pp, rule, grid)
        seconds = time.perf_counter() - t
    finally:
        mlp.mlp2_fwd_reference = fwd
    out = _result(gu, gp[0], sol, seconds)
    out["gp"] = [_np(g) for g in gp]
    out["rows"] = sorted(set(rows))
    return out


def refusal_thunks(P, mesh):
    """name -> a call that must raise ShardedStateUnsupported before the
    field runs; the field counts its evaluations."""
    from torch.distributed.tensor import distribute_tensor, Shard

    from scimlsensitivity_jl_tpu_torch.ops import mlp, rd1d

    n = RD_N
    u0 = distribute_tensor(torch.from_numpy(rd_u0(n)), mesh, [Shard(0)])
    p = torch.tensor(rd_p(n), dtype=torch.float64)
    calls = [0]
    inner = rd1d.make_rd1d_field(n, 1.0 / n)

    def field(u, p, t):
        calls[0] += 1
        return inner(u, p, t)

    prob = P.ODEProblem(field, u0, (0.0, 0.01), p)
    # a solution of the sharded problem, as the direct APIs take one
    sol = P.ODESolution(ts=torch.zeros(2), ys=None, stats=None, retcode=0,
                        prob=prob)
    fixed = dict(dt=1e-3, adaptive=False)

    def solve(sensealg=None, solver=None, prob=prob, **kw):
        return lambda: P.solve(prob, solver or P.Tsit5(), sensealg=sensealg,
                               **kw)

    small = P.ODEProblem(field, distribute_tensor(
        torch.ones(8, dtype=torch.float64), mesh, [Shard(0)]), (0.0, 0.01), p)
    # a batch of 8 rows of 4 split along dim 1, and the weights of its field
    batch = distribute_tensor(torch.ones(8, 4, dtype=torch.float64), mesh,
                              [Shard(1)])
    weights = {"W0": torch.ones(4, 4, dtype=torch.float64),
               "b0": torch.ones(4, dtype=torch.float64),
               "W1": torch.ones(4, 4, dtype=torch.float64),
               "b1": torch.ones(4, dtype=torch.float64)}

    def mlp_field(u, p, t):
        calls[0] += 1
        return mlp.fused_mlp2(p, u)

    rows = distribute_tensor(torch.ones(8, 4, dtype=torch.float64), mesh,
                             [Shard(0)])
    split_weights = dict(weights, W0=distribute_tensor(weights["W0"], mesh,
                                                       [Shard(0)]))
    return calls, {
        "ForwardDiffSensitivity": solve(P.ForwardDiffSensitivity()),
        "ForwardSensitivity": solve(P.ForwardSensitivity()),
        "NILSS": solve(P.NILSS()),
        "JacVJP": solve(P.InterpolatingAdjoint(autojacvec=P.JacVJP())),
        "FiniteDiffVJP": solve(P.GaussAdjoint(
            autojacvec=P.FiniteDiffVJP())),
        "a DTensor weight": solve(prob=P.ODEProblem(
            mlp_field, rows, (0.0, 0.01), split_weights)),
        "a state split along dim 1": solve(prob=P.ODEProblem(
            mlp_field, batch, (0.0, 0.01), weights)),
        "default ForwardDiffSensitivity (n + p <= 100)": solve(prob=small),
        "Rosenbrock23": solve(solver=P.Rosenbrock23()),
        "FBDF": solve(solver=P.FBDF()),
        "Rosenbrock23 bwd_solver": solve(P.GaussAdjoint(),
                                         bwd_solver=P.Rosenbrock23()),
        "extrapolation (Seulex)": solve(solver=P.Seulex()),
        "callback": solve(callback=P.PresetTimeCallback(
            [0.005], lambda u, p, t: u)),
        "dense=True": solve(dense=True),
        "save_idxs": solve(save_idxs=[0]),
        "mass matrix": solve(prob=P.ODEProblem(
            field, u0, (0.0, 0.01), p, mass_matrix=torch.eye(n))),
        "SDEProblem": solve(prob=P.SDEProblem(
            field, lambda u, p, t: 0.1 * u, u0, (0.0, 0.01), p), **fixed),
        "DDEProblem": solve(prob=P.DDEProblem(
            lambda u, h, p, t: field(u, p, t), u0, (0.0, 0.01), p,
            lags=(0.005,)), **fixed),
        "adjoint_sensitivities": lambda: P.adjoint_sensitivities(
            sol, dgdu_discrete=lambda *a: None),
        "ODEAdjointProblem": lambda: P.ODEAdjointProblem(sol),
        "second_order_sensitivities": lambda: P.second_order_sensitivities(
            lambda s: s.ys.sum(), prob),
        "ODEForwardSensitivityProblem":
            lambda: P.ODEForwardSensitivityProblem(field, u0, (0.0, 0.01), p),
        "ForwardLSSProblem": lambda: P.ForwardLSSProblem(sol, P.ForwardLSS()),
        "AdjointLSSProblem": lambda: P.AdjointLSSProblem(sol, P.AdjointLSS()),
        "NILSSProblem": lambda: P.NILSSProblem(prob, P.NILSS(),
                                               g=lambda u, p, t: u[0]),
        "NILSASProblem": lambda: P.NILSASProblem(prob, P.NILSAS(),
                                                 g=lambda u, p, t: u[0]),
        "solve_ensemble": lambda: P.solve_ensemble(
            P.EnsembleProblem(prob), P.Tsit5(), trajectories=2),
    }


def case_refusals(P, mesh, world):
    calls, thunks = refusal_thunks(P, mesh)
    out = {}
    for name, thunk in thunks.items():
        before = calls[0]
        try:
            thunk()
            got = ("no error", "")
        except Exception as err:  # the test asserts the class and message
            got = (type(err).__name__, str(err))
        out[name] = got + (calls[0] - before,)
    return out


def _meshes(rank: int):
    """The whole group's 1-D mesh and those of its subgroups of ranks
    {0, 1, 2} and {0, 1} (on the ranks that belong to them)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    meshes = {WORLD: DeviceMesh("cpu", list(range(WORLD)))}
    for world in (3, 2):
        group = dist.new_group(list(range(world)))
        if rank < world:
            meshes[world] = DeviceMesh.from_group(group, "cpu")
    return meshes


def _cases():
    """(name, world, function, arguments) of every case."""
    cases = [(f"halo w{w} n{n}", w, case_halo, (n,)) for w, n in HALO_CASES]
    cases += [(f"norms w{w}", w, case_norms, ()) for w in (2, 3, 4)]
    cases += [("empty shard", 4, case_empty, ()),
              ("comm", 4, case_comm, ()),
              ("refusals", 4, case_refusals, ()),
              ("heat adaptive", 4, case_heat, (False,)),
              ("heat fixed", 4, case_heat, (True,))]
    cases += [(f"rd w{w} n{n} {rule}", w, case_rd, (n, rule))
              for w, n, rule in RD_CASES]
    cases += [(blk_name(*c), c[0], case_block, c[1:]) for c in BLK_CASES]
    cases += [("blkerr", 4, case_block_errors, ())]
    cases += [(f"mlp B{B} {rule} {grid}", 3, case_mlp, (B, rule, grid))
              for B, rule, grid in MLP_CASES]
    cases += [(f"rule {label}", 4, case_rule, (label,))
              for label in RULE_CASES]
    cases += [(f"rheat {label}", 4, case_heat_rule, (label,))
              for label in HEAT_RULES]
    return cases


def blk_name(world, S, chunk, bwd_chunk, blocks):
    return f"blk w{world} S{S} c{chunk}/{bwd_chunk} x{blocks}"


def _rank(rank: int, port: int, out: str, only=()) -> None:
    import torch.distributed as dist

    import scimlsensitivity_jl_tpu_torch as P

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=WORLD, rank=rank)
    try:
        meshes = _meshes(rank)
        results = {}
        for name, world, fn, args in _cases():
            if rank >= world or (only and not any(o in name for o in only)):
                continue
            t = time.perf_counter()
            try:
                mesh = meshes if fn is case_block_errors else meshes[world]
                results[name] = fn(P, mesh, world, *args)
            except Exception:
                # the other ranks would wait on this one's collectives:
                # stop the group, with the traceback on stderr
                print(f"[sharded_ranks] rank {rank}, case {name}:\n"
                      + traceback.format_exc(), file=sys.stderr, flush=True)
                os._exit(1)
            if rank == 0:
                print(f"[sharded_ranks] {name}: "
                      f"{time.perf_counter() - t:.1f} s", flush=True)
        if rank == 0:
            torch.save(results, out)
    finally:
        dist.destroy_process_group()


class _Group:
    """One group of ranks running this script for the cases whose names
    contain one of `names`, its results read when first needed."""

    def __init__(self, names):
        self.dir = tempfile.mkdtemp(prefix="sharded_ranks_")
        self.out = os.path.join(self.dir, "results.pt")
        self.log = open(os.path.join(self.dir, "log.txt"), "w+")
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), self.out, *names],
            stdout=self.log, stderr=subprocess.STDOUT,
            stdin=subprocess.DEVNULL)
        self.results = None

    def get(self):
        if self.results is None:
            try:
                rc = self.proc.wait(timeout=900)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                rc = "killed after 900 s"
            self.log.seek(0)
            text = self.log.read()
            assert rc == 0, f"a rank group failed ({rc}):\n{text[-6000:]}"
            self.results = torch.load(self.out, weights_only=False)
        return self.results

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.log.close()
        shutil.rmtree(self.dir, ignore_errors=True)


class RankGroups:
    """Groups of ranks started at once, one per tuple of case names in
    `groups` (a test module starts them in its first test that asks, so
    that its own process computes the JAX references meanwhile); indexing
    by a case's name waits for its group and returns its result."""

    def __init__(self, groups):
        self.names = groups
        self.groups = [_Group(names) for names in groups]

    def __getitem__(self, case):
        for names, group in zip(self.names, self.groups):
            if any(name in case for name in names):
                return group.get()[case]
        raise KeyError(case)

    def close(self):
        for group in self.groups:
            group.close()


def run(out: str, only=(), timeout: float = 600.0) -> None:
    """Start the four ranks and wait for them; raise if one fails."""
    import multiprocessing

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(r, port, out, tuple(only)))
             for r in range(WORLD)]
    for proc in procs:
        proc.start()
    try:
        for proc in procs:
            proc.join(timeout)
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.terminate()
                proc.join()
    bad = [(r, proc.exitcode) for r, proc in enumerate(procs)
           if proc.exitcode != 0]
    if bad:
        raise RuntimeError(f"sharded ranks (rank, exit code) {bad} failed")


if __name__ == "__main__":
    run(sys.argv[1], sys.argv[2:])
