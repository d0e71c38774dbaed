#!/usr/bin/env python3
"""Times the PyTorch port's reaction-diffusion field kernels K1/K2
(scimlsensitivity_jl_tpu_torch/ops/rd1d.py, csrc/rd1d.cu) on one NVIDIA GPU,
for one or more checkouts of this repository, each in a fresh process and in
the order given, so that two commits compare in one run:

    git archive <commit> | tar -x -C .tree_check/parent   # a dir .gitignore lists
    python3 compare_rd1d.py .tree_check/parent . . .tree_check/parent

With no argument it times this checkout. For each checkout it prints:

  * ptxas's registers and spills of each kernel of csrc/rd1d.cu;
  * device µs per K1 and per K2 call at float32 n = 262,144 and 1,048,576,
    from a torch.profiler trace (each kernel's mean, summed over the kernels
    of a call): warm, 100 calls on the same inputs, which then sit in the
    50 MB L2; and cold, one call on each of a rotation of input sets that
    add up to at least 128 MiB, so that no call finds its operands in L2;
  * kernels and memsets per call in that trace;
  * K2's float32 D̄ and k̄ at n = 1,048,576 (seeds 0 and 1234) against the
    plain version in float64, beside the float32 plain version's own error;
  * the wrappers' host µs per call: back-to-back calls at n = 4096, where
    the device waits on the host;
  * the PDE's walls (bench.py:591-654): the forward and the (a)
    sensealg=None (BacksolveAdjoint) and (b) DirectAdjoint gradients of
    Σ ys[-1]², Tsit5, 64 fixed steps of 1e-9, float32, at both n; CUDA
    events, median of 5 interleaved rounds.

It needs a CUDA device and exits 1 without one.
"""

from __future__ import annotations

import os
import re
import statistics
import subprocess
import sys
import time

SIZES = (262144, 1048576)
COLD_BYTES = 128 << 20


def kernel_inputs(torch, n, dev, sets=1, seed=1234):
    """`sets` seeded float32 (u, λ) pairs of length n and p = [1e-7, 1.5]."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    u = torch.rand(sets, n, generator=gen, device=dev)
    lam = torch.randn(sets, n, generator=gen, device=dev)
    return u, lam, torch.tensor([1e-7, 1.5], device=dev)


def traced(torch, calls):
    """(device µs per call summed over its kernels' means, kernels per call,
    memsets per call) of the closures in `calls`, each run once, from a
    torch.profiler trace of device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    calls[-1]()  # warm-up; a rotation evicts it before its turn comes
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for fn in calls:
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA and e.count]
    mem = [e for e in ev if "memset" in e.key.lower()]
    ker = [e for e in ev if "mem" not in e.key.lower()]
    us = sum(e.self_device_time_total / e.count for e in ker)
    return (us, sum(e.count for e in ker) / len(calls),
            sum(e.count for e in mem) / len(calls))


def kernel_times(torch, rd1d, dev, tag):
    """Warm and cold device µs and kernels per call of K1 and K2 at SIZES."""
    for n in SIZES:
        inv_dx2 = float(n) * float(n)
        u, lam, p = kernel_inputs(torch, n, dev)
        cold = {"K1": -(-COLD_BYTES // (4 * n)), "K2": -(-COLD_BYTES // (8 * n))}
        U, L, _ = kernel_inputs(torch, n, dev, sets=max(cold.values()), seed=7)
        fns = {"K1": lambda u, lam: rd1d.rd1d_fwd_cuda(u, p, inv_dx2),
               "K2": lambda u, lam: rd1d.rd1d_vjp_cuda(u, p, inv_dx2, lam)}
        for name, fn in fns.items():
            warm, k, m = traced(torch, [lambda: fn(u[0], lam[0])] * 100)
            cold_us, _, _ = traced(torch, [
                (lambda i=i: fn(U[i], L[i])) for i in range(cold[name])])
            print(f"[{tag}] f32 n={n} {name}: device {warm:.2f} us warm "
                  f"(100 calls), {cold_us:.2f} us cold ({cold[name]} input "
                  f"sets, {cold[name] * (4 if name == 'K1' else 8) * n >> 20} "
                  f"MiB); {k:g} kernels and {m:g} memsets per call",
                  flush=True)
        del U, L


def time_checkout(root: str, tag: str) -> None:
    sys.path.insert(0, os.path.abspath(root))
    import torch

    import scimlsensitivity_jl_tpu_torch as P
    from scimlsensitivity_jl_tpu_torch.ops import cuda_build, rd1d

    dev = torch.device("cuda", 0)
    rd1d.load_rd1d_library()
    entry = None
    for line in cuda_build.build_log("rd1d").splitlines():
        m = re.search(r"entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
        elif entry and ("spill" in line or "registers" in line):
            print(f"[{tag}] ptxas {entry}: {line.strip()}", flush=True)

    kernel_times(torch, rd1d, dev, tag)

    n = SIZES[1]
    for seed in (0, 1234):
        gen = torch.Generator(device=dev).manual_seed(seed)
        u = torch.rand(n, generator=gen, device=dev)
        lam = torch.randn(n, generator=gen, device=dev)
        p = torch.tensor([1e-7, 1.5], device=dev)
        _, dp = rd1d.rd1d_vjp_cuda(u, p, float(n) ** 2, lam)
        _, dp32 = rd1d.rd1d_vjp_reference(u, p, float(n) ** 2, lam)
        _, dp64 = rd1d.rd1d_vjp_reference(u.double(), p.double(),
                                          float(n) ** 2, lam.double())
        err = [((d.double() - dp64).abs() / dp64.abs()).tolist()
               for d in (dp, dp32)]
        print(f"[{tag}] f32 n={n} seed {seed}: K2 (D̄, k̄) relative to the "
              f"float64 plain version {err[0][0]:.2e}, {err[0][1]:.2e}; the "
              f"float32 plain version's {err[1][0]:.2e}, {err[1][1]:.2e}",
              flush=True)

    ns = 4096
    u, lam, p = kernel_inputs(torch, ns, dev)
    for name, fn in (
            ("K1 wrapper", lambda: rd1d.rd1d_fwd_cuda(u[0], p, float(ns) ** 2)),
            ("K2 wrapper", lambda: rd1d.rd1d_vjp_cuda(u[0], p, float(ns) ** 2,
                                                      lam[0]))):
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(1000):
            fn()
        torch.cuda.synchronize()
        print(f"[{tag}] {name}: host {(time.perf_counter() - t) / 1000 * 1e6:.2f}"
              f" us per back-to-back call at n={ns}", flush=True)

    steps, dt = 64, 1e-9
    for n in SIZES:
        field = rd1d.make_rd1d_field(n, 1.0 / n)
        x = torch.arange(n, dtype=torch.float32, device=dev) / n
        u0 = torch.exp(-((x - 0.5) ** 2) * 100.0)
        p0 = torch.tensor([1e-7, 1.5], device=dev)

        def run(sensealg, grad):
            uu = u0.clone().requires_grad_(grad)
            pp = p0.clone().requires_grad_(grad)
            with torch.set_grad_enabled(grad):
                sol = P.solve(P.ODEProblem(field, uu, (0.0, steps * dt), pp),
                              P.Tsit5(), saveat=[0.0, steps * dt], dt=dt,
                              adaptive=False, sensealg=sensealg, adj_rtol=1e-3,
                              adj_atol=1e-8, adj_max_steps=128)
                if grad:
                    torch.autograd.grad(torch.sum(sol.ys[-1] ** 2), (uu, pp))

        arms = {"forward": lambda: run(None, False),
                "(a) default->Backsolve": lambda: run(None, True),
                "(b) DirectAdjoint": lambda: run(P.DirectAdjoint(), True)}
        walls = {name: [] for name in arms}
        for fn in arms.values():
            fn()
        for r in range(5):
            names = list(arms)
            for name in names[r % 3:] + names[:r % 3]:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                arms[name]()
                end.record()
                torch.cuda.synchronize()
                walls[name].append(start.elapsed_time(end))
        print(f"[{tag}] PDE f32 n={n}: " + ", ".join(
            f"{name} {statistics.median(w):.3f} ms" for name, w in walls.items())
            + " (CUDA events, median of 5 interleaved)", flush=True)


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        time_checkout(sys.argv[2], sys.argv[3])
        return 0
    import torch
    if not torch.cuda.is_available():
        print("compare_rd1d.py needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    for i, root in enumerate(sys.argv[1:] or ["."]):
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root,
                        f"{i} {root}"], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
