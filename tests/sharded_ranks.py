"""The rank side of tests/test_torch_sharded.py: a sharded state solved by
gloo processes on the CPU. It imports no JAX.

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
import socket
import sys
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
    block = rd1d.make_rd1d_rk4_block(n, 4, chunk=n, bwd_chunk=n)
    params = {"W0": torch.ones(n, 4, dtype=torch.float64),
              "b0": torch.ones(4, dtype=torch.float64),
              "W1": torch.ones(4, n, dtype=torch.float64),
              "b1": torch.ones(n, dtype=torch.float64)}
    return calls, {
        "QuadratureAdjoint": solve(P.QuadratureAdjoint()),
        "GaussKronrodAdjoint": solve(P.GaussKronrodAdjoint()),
        "ForwardDiffSensitivity": solve(P.ForwardDiffSensitivity()),
        "ForwardSensitivity": solve(P.ForwardSensitivity()),
        "NILSS": solve(P.NILSS()),
        "InterpolatingAdjoint(checkpointing=True)": solve(
            P.InterpolatingAdjoint(checkpointing=True), **fixed),
        "DirectAdjoint(remat=True)": solve(P.DirectAdjoint(remat=True)),
        "default ForwardDiffSensitivity (n + p <= 100)": solve(prob=small),
        "Rosenbrock23": solve(solver=P.Rosenbrock23()),
        "FBDF": solve(solver=P.FBDF()),
        "Rosenbrock23 bwd_solver": solve(P.GaussAdjoint(),
                                         bwd_solver=P.Rosenbrock23()),
        "extrapolation (Seulex)": solve(solver=P.Seulex()),
        "callback": solve(callback=P.PresetTimeCallback(
            [0.005], lambda u, p, t: u)),
        "dense=True": solve(dense=True),
        "unroll=True": solve(P.DirectAdjoint(), unroll=True, max_steps=64),
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
        "make_rd1d_rk4_block (K5/K6)": lambda: block(u0, p, float(n * n),
                                                     1e-9),
        "fused_mlp2 (K3/K4)": lambda: mlp.fused_mlp2(params, u0[None]),
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


def _rank(rank: int, port: int, out: str, only=()) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    import scimlsensitivity_jl_tpu_torch as P

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=WORLD, rank=rank)
    try:
        meshes = {WORLD: DeviceMesh("cpu", list(range(WORLD)))}
        for world in (3, 2):
            group = dist.new_group(list(range(world)))
            if rank < world:
                meshes[world] = DeviceMesh.from_group(group, "cpu")
        cases = [(f"halo w{w} n{n}", w, case_halo, (n,))
                 for w, n in HALO_CASES]
        cases += [(f"norms w{w}", w, case_norms, ()) for w in (2, 3, 4)]
        cases += [("empty shard", 4, case_empty, ()),
                  ("comm", 4, case_comm, ()),
                  ("refusals", 4, case_refusals, ()),
                  ("heat adaptive", 4, case_heat, (False,)),
                  ("heat fixed", 4, case_heat, (True,))]
        cases += [(f"rd w{w} n{n} {rule}", w, case_rd, (n, rule))
                  for w, n, rule in RD_CASES]
        results = {}
        for name, world, fn, args in cases:
            if rank >= world or (only and not any(o in name for o in only)):
                continue
            t = time.perf_counter()
            try:
                results[name] = fn(P, meshes[world], world, *args)
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
