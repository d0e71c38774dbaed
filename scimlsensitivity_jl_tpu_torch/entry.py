"""Entry points of the PyTorch port.

Counterpart of the JAX package's `__graft_entry__.py`:

entry()             -- the spiral neural ODE's gradient step (2→50→2 tanh
                       MLP on u³, Tsit5, rtol 1e-3, BacksolveAdjoint,
                       float32), on the card unless device="cpu";
dryrun_multichip(n) -- one data-parallel ensemble training step over n
                       processes of torch.distributed on gloo (CPU): each
                       rank solves its shard of the trajectories, and the
                       loss and the gradient are all-reduced, on tiny
                       shapes.

    python -m scimlsensitivity_jl_tpu_torch.entry   # both (a card), n = 2

JAX shards one program over a device mesh (`jax.shard_map`); the port runs
one process per rank and gives `init_process_group` its address
(tcp://localhost:<a free port>), world size and rank itself.
"""

from __future__ import annotations

import socket

import torch

__all__ = ["entry", "dryrun_multichip"]


def entry(device="cuda"):
    """(grad_step, (params, data)): grad_step(params, data) -> (loss,
    gradients like params) of Σ (solve(...).ys − data)² over 30 save times
    on [0, 1.5]."""
    from . import BacksolveAdjoint, ODEProblem, Tsit5, solve
    from .models.neural_ode import mlp_apply, mlp_init

    dtype = torch.float32
    ts = torch.linspace(0.0, 1.5, 30, dtype=dtype)
    u0 = torch.tensor([2.0, 0.0], dtype=dtype, device=device)
    params = mlp_init(torch.Generator().manual_seed(0), (2, 50, 2), dtype,
                      device=device)

    def field(u, p, t):
        return mlp_apply(p, u ** 3)

    def grad_step(p, data):
        leaves = {k: v.detach().requires_grad_() for k, v in p.items()}
        prob = ODEProblem(field, u0, (0.0, 1.5), leaves)
        sol = solve(prob, Tsit5(), saveat=ts, rtol=1e-3, atol=1e-6,
                    sensealg=BacksolveAdjoint(), max_steps=256)
        loss = torch.sum((sol.ys - data) ** 2)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss.detach(), dict(zip(leaves, grads))

    data = torch.zeros((30, 2), dtype=dtype, device=device)
    return grad_step, (params, data)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _dryrun_rank(rank: int, world: int, port: int) -> None:
    """One rank of dryrun_multichip: its 2 trajectories of the 2·world."""
    import torch.distributed as dist

    from . import BacksolveAdjoint, ODEProblem, Tsit5, remake
    from .models.neural_ode import mlp_apply, mlp_init
    from .parallel.ensemble import EnsembleProblem, solve_ensemble

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        dtype = torch.float32
        batch, nt = 2 * world, 4
        ts = torch.linspace(0.0, 0.5, nt, dtype=dtype)
        params = mlp_init(torch.Generator().manual_seed(0), (2, 8, 2), dtype,
                          device="cpu")
        params = {k: v.requires_grad_() for k, v in params.items()}
        u0s = torch.stack([torch.tensor([1.0 + 0.1 * i, 0.0], dtype=dtype)
                           for i in range(batch)])
        mine = u0s[2 * rank:2 * rank + 2]
        targets = torch.zeros((2, nt, 2), dtype=dtype)

        def field(u, p, t):
            return mlp_apply(p, torch.tanh(u))

        ens = EnsembleProblem(
            ODEProblem(field, mine[0], (0.0, 0.5), params),
            prob_func=lambda prob, i: remake(prob, u0=mine[i]),
            output_func=lambda sol, i: sol.ys)
        ys = solve_ensemble(ens, Tsit5(), trajectories=2, saveat=ts,
                            rtol=1e-2, atol=1e-4,
                            sensealg=BacksolveAdjoint(), max_steps=64)
        local = torch.sum((ys - targets) ** 2) / (batch * nt * 2)
        grads = torch.autograd.grad(local, list(params.values()))
        loss = local.detach().clone()
        dist.all_reduce(loss)
        for g in grads:
            dist.all_reduce(g)
        new = {k: v.detach() - 1e-2 * g
               for (k, v), g in zip(params.items(), grads)}
        if not (torch.isfinite(loss)
                and all(bool(torch.isfinite(v).all()) for v in new.values())):
            raise RuntimeError("dryrun training step produced non-finite "
                               "values")
        if rank == 0:
            print(f"dryrun_multichip({world}): loss={float(loss):.6f} OK",
                  flush=True)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_processes: int, timeout: float = 300.0) -> None:
    """One ensemble training step over n processes (gloo, CPU); raises
    if a rank fails or does not finish within `timeout` seconds."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_dryrun_rank, args=(r, n_processes, port))
             for r in range(n_processes)]
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
        raise RuntimeError(f"dryrun_multichip({n_processes}): ranks "
                           f"(rank, exit code) {bad} failed")


if __name__ == "__main__":
    fn, args = entry()
    loss, grads = fn(*args)
    print("entry OK: loss", float(loss),
          {k: tuple(v.shape) for k, v in grads.items()})
    dryrun_multichip(2)
