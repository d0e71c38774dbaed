#!/usr/bin/env python3
"""Times the PyTorch port's fused MLP kernels K3/K4
(scimlsensitivity_jl_tpu_torch/ops/mlp.py) on one NVIDIA GPU, for one or
more checkouts of this repository, each in a fresh process and in the order
given, so that two commits compare in one run:

    git archive <commit> | tar -x -C .tree_check/parent   # a dir .gitignore lists
    python3 compare_mlp2.py .tree_check/parent . . .tree_check/parent

With no argument it times this checkout. For each checkout it prints:

  * device µs per K3 and per K4 call at S4 (B = 1024, 512->2048->512) in
    bfloat16 and float32 and at the spiral (1, 2->50->2) in float32: the sum
    of the kernels of 20 (5, 100) calls in a torch.profiler trace, with the
    kernels per call counted in the same trace (a fresh process's first
    traces lose no events);
  * the wrappers' host µs per call: back-to-back calls at a tiny bfloat16
    shape (8, 64->64->64), where the device waits on the host;
  * the S4 bfloat16 forward and gradient wall time (64 Tsit5 steps, median
    of 3), and the host CPU time of one forward in a torch.profiler trace of
    host operators, with the K3 operator's mean.

It needs a CUDA device and exits 1 without one.
"""

from __future__ import annotations

import os
import statistics
import subprocess
import sys
import time


def time_checkout(root: str, tag: str) -> None:
    sys.path.insert(0, os.path.abspath(root))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import scimlsensitivity_jl_tpu_torch as P
    from scimlsensitivity_jl_tpu_torch.ops import mlp

    dev = torch.device("cuda", 0)

    def inputs(shape, dtype):
        B, din, hid, dout = shape
        gen = torch.Generator(device=dev).manual_seed(1234)
        mk = lambda *sh, s=1.0: (s * torch.randn(*sh, generator=gen,
                                                 device=dev)).to(dtype)
        return (mk(B, din), mk(din, hid, s=din ** -0.5), mk(hid, s=0.1),
                mk(hid, dout, s=hid ** -0.5), mk(dout, s=0.1), mk(B, dout))

    for label, shape, dtype, calls in (
            ("S4", (1024, 512, 2048, 512), torch.bfloat16, 20),
            ("S4", (1024, 512, 2048, 512), torch.float32, 5),
            ("spiral", (1, 2, 50, 2), torch.float32, 100)):
        x, w0, b0, w1, b1, g = inputs(shape, dtype)
        _, h = mlp.mlp2_fwd_cuda(x, w0, b0, w1, b1)
        for name, fn in (("K3", lambda: mlp.mlp2_fwd_cuda(x, w0, b0, w1, b1)),
                         ("K4", lambda: mlp.mlp2_vjp_cuda(x, w0, w1, h, g))):
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
            ev = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and e.count]
            us = sum(e.self_device_time_total for e in ev) / calls
            kernels = sum(e.count for e in ev) / calls
            print(f"[{tag}] {label} {str(dtype)[6:]} {name}: device {us:.2f} us "
                  f"per call, {kernels:.2f} kernels per call ({calls} calls)",
                  flush=True)

    x, w0, b0, w1, b1, g = inputs((8, 64, 64, 64), torch.bfloat16)
    _, h = mlp.mlp2_fwd_cuda(x, w0, b0, w1, b1)
    for name, fn in (("K3", lambda: mlp.mlp2_fwd_cuda(x, w0, b0, w1, b1)),
                     ("K4", lambda: mlp.mlp2_vjp_cuda(x, w0, w1, h, g))):
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(300):
            fn()
        torch.cuda.synchronize()
        print(f"[{tag}] wrapper {name}: host {(time.perf_counter() - t) / 300 * 1e6:.1f}"
              " us per back-to-back call at (8, 64->64->64) bf16", flush=True)

    gen = torch.Generator().manual_seed(1234)
    params = P.mlp_init(gen, (512, 2048, 512), torch.bfloat16, device=dev)
    u0 = (0.1 * torch.randn((1024, 512), generator=gen)).to(device=dev,
                                                            dtype=torch.bfloat16)

    def s4(grad):
        ps = {k: v.detach().clone().requires_grad_(grad)
              for k, v in params.items()}
        prob = P.ODEProblem(lambda u, p, t: mlp.fused_mlp2(p, u), u0,
                            (0.0, 1.0), ps)
        with torch.set_grad_enabled(grad):
            sol = P.solve(prob, P.Tsit5(), saveat=[0.0, 1.0], dt=1.0 / 64,
                          adaptive=False)
            if grad:
                torch.autograd.grad(torch.sum(sol.ys[-1].float() ** 2),
                                    list(ps.values()))

    for grad in (False, True):
        s4(grad)
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            s4(grad)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)
        print(f"[{tag}] S4 bf16 {'gradient' if grad else 'forward'}: wall "
              f"median {statistics.median(walls):.1f} ms of "
              f"{[round(w, 1) for w in walls]}", flush=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        s4(False)
        torch.cuda.synchronize()
    ev = prof.key_averages()
    k3 = [e for e in ev if e.key == "scimlsens_torch::mlp2_fwd"]
    print(f"[{tag}] S4 bf16 forward host trace: self CPU "
          f"{sum(e.self_cpu_time_total for e in ev) / 1e3:.2f} ms; K3 operator "
          f"{k3[0].cpu_time_total / k3[0].count:.2f} us per call over "
          f"{k3[0].count} calls (profiler on)", flush=True)


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        time_checkout(sys.argv[2], sys.argv[3])
        return 0
    import torch
    if not torch.cuda.is_available():
        print("compare_mlp2.py needs a CUDA device", file=sys.stderr)
        return 1
    for i, root in enumerate(sys.argv[1:] or ["."]):
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root,
                        f"{i} {root}"], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
