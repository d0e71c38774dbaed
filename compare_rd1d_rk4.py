#!/usr/bin/env python3
"""Times the PyTorch port's RK4 block kernels K5/K6
(scimlsensitivity_jl_tpu_torch/ops/rd1d.py, csrc/rd1d_rk4.cu) on one NVIDIA
GPU, for one or more checkouts of this repository, each in a fresh process
and in the order given, so that two commits compare in one run:

    git archive <commit> | tar -x -C .tree_check/parent   # a dir .gitignore lists
    python3 compare_rd1d_rk4.py .tree_check/parent . . .tree_check/parent

With no argument it times this checkout. For each checkout it prints:

  * ptxas's registers and spills of each K5/K6 kernel;
  * device µs per K5 and per K6 call at the float32 flagship (n = 1,048,576,
    S = 16, tiles 4096 and 1024): each kernel's mean over 20 calls in a
    torch.profiler trace, summed over the kernels of a call;
  * the wrappers' host µs per call, and of one block call with its pullback
    (make_rd1d_rk4_block, forward and torch.autograd.grad): back-to-back
    calls at n = 4096, S = 4, where the device waits on the host;
  * the megakernel path's walls (bench.py:838-954): the 64-step forward and
    the 64- and 512-step gradients of Σ u² (p = [1e-7, 1.5], h = 1e-9, the
    flagship u0), CUDA events, median of 5 (3 at 512 steps).

It needs a CUDA device and exits 1 without one.
"""

from __future__ import annotations

import os
import re
import statistics
import subprocess
import sys
import time


def time_checkout(root: str, tag: str) -> None:
    sys.path.insert(0, os.path.abspath(root))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from scimlsensitivity_jl_tpu_torch.ops import cuda_build, rd1d

    dev = torch.device("cuda", 0)
    rd1d.load_rd1d_rk4_library()
    entry = None
    for line in cuda_build.build_log("rd1d_rk4").splitlines():
        m = re.search(r"entry function '([^']+)'", line)
        if m:
            entry = re.search(r"rd1d_rk4_(fwd|bwd|bwd_reduce)_kernelI\w+?EEv",
                              m.group(1))
            entry = entry.group(0)[:-3] if entry else m.group(1)
        elif entry and ("spill" in line or "registers" in line):
            print(f"[{tag}] ptxas {entry}: {line.strip()}", flush=True)

    n, S, h = 1 << 20, 16, 1e-9
    inv_dx2 = float(n) * float(n)
    x = torch.arange(n, dtype=torch.float32, device=dev) / n
    u0 = torch.exp(-((x - 0.5) ** 2) * 100.0)
    p = torch.tensor([1e-7, 1.5], device=dev)
    lam = torch.randn(n, generator=torch.Generator(device=dev).manual_seed(
        1234), device=dev)
    for name, fn in (
            ("K5", lambda: rd1d.rd1d_rk4_fwd_cuda(u0, p, inv_dx2, h, S, 4096)),
            ("K6", lambda: rd1d.rd1d_rk4_vjp_cuda(u0, p, inv_dx2, h, S, 1024,
                                                  lam))):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.count]
        us = sum(e.self_device_time_total / e.count for e in ev)
        parts = ", ".join(f"{e.self_device_time_total / e.count:.2f}"
                          for e in ev)
        print(f"[{tag}] flagship f32 {name}: device {us:.2f} us per call "
              f"({parts} per kernel; 20 calls)", flush=True)

    ns, Ss = 4096, 4
    us_ = torch.rand(ns, device=dev)
    lams = torch.randn(ns, device=dev)
    ps = torch.tensor([1.0 / ns ** 2, 1.5], device=dev)
    blk = rd1d.make_rd1d_rk4_block(ns, Ss, chunk=1024, bwd_chunk=1024)

    def block_call():
        uu = us_.clone().requires_grad_()
        pp = ps.clone().requires_grad_()
        torch.autograd.grad(torch.sum(blk(uu, pp, float(ns) ** 2, 1e-3)),
                            (uu, pp))

    for name, fn in (
            ("K5 wrapper", lambda: rd1d.rd1d_rk4_fwd_cuda(
                us_, ps, float(ns) ** 2, 1e-3, Ss, 1024)),
            ("K6 wrapper", lambda: rd1d.rd1d_rk4_vjp_cuda(
                us_, ps, float(ns) ** 2, 1e-3, Ss, 1024, lams)),
            ("block call + pullback", block_call)):
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(300):
            fn()
        torch.cuda.synchronize()
        print(f"[{tag}] {name}: host {(time.perf_counter() - t) / 300 * 1e6:.1f}"
              f" us per back-to-back call at n={ns}, S={Ss}", flush=True)

    mega = rd1d.make_rd1d_rk4_block(n, S)

    def run(steps, grad):
        uu = u0.clone().requires_grad_(grad)
        pp = p.clone().requires_grad_(grad)
        with torch.set_grad_enabled(grad):
            u = uu
            for _ in range(steps // S):
                u = mega(u, pp, inv_dx2, h)
            if grad:
                torch.autograd.grad(torch.sum(u ** 2), (uu, pp))

    for label, steps, grad, reps in (("64-step forward", 64, False, 5),
                                     ("64-step gradient", 64, True, 5),
                                     ("512-step gradient", 512, True, 3)):
        run(steps, grad)
        walls = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run(steps, grad)
            end.record()
            torch.cuda.synchronize()
            walls.append(start.elapsed_time(end))
        print(f"[{tag}] megakernel f32 {label}: median {statistics.median(walls):.3f}"
              f" ms of {[round(w, 3) for w in walls]}", flush=True)


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        time_checkout(sys.argv[2], sys.argv[3])
        return 0
    import torch
    if not torch.cuda.is_available():
        print("compare_rd1d_rk4.py needs a CUDA device", file=sys.stderr)
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
