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
    of the device operations of 20 (5, 100) calls in a torch.profiler
    trace, with the operations per call counted in the same trace (a fresh
    process's first traces lose no events) and each one's mean;
  * the wrappers' host µs per call: back-to-back calls at a tiny bfloat16
    shape (8, 64->64->64), where the device waits on the host;
  * the S4 bfloat16 forward and gradient wall time (64 Tsit5 steps, median
    of 3), and the host CPU time of one forward in a torch.profiler trace of
    host operators, with the K3 operator's mean.

Variants of this checkout's float32 engine (csrc/mlp2.cu with the text
substitutions VARIANTS lists) are timed in turns likewise:

    python3 compare_mlp2.py --variant final 128x128-1 final

Each is built into scimlsensitivity_jl_tpu_torch/_build/variant/<name>/,
one nvcc each, all started together; for each it prints the ptxas
registers and spills of the float32 kernels, whether K3 and K4 match their
plain versions (relative to max|.| of each output, 1e-5) and give the same
bits twice at five shapes (S4's, a ragged one, B = 1, the spiral's and
operands off 16-byte alignment), and the float32 device times above. The
`diag-` variants are wrong by construction: they time what a part of the
kernel costs.

It needs a CUDA device and exits 1 without one.
"""

from __future__ import annotations

import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TILE = "using FfmaBig = Ffma<128, 64, 8, 4, 2>;"
VARIANTS = {
    "final": [],
    # 8 x 8 outputs per thread on 128 x 128 tiles, one or two blocks per SM
    "128x128-1": [(TILE, "using FfmaBig = Ffma<128, 128, 8, 8, 1>;")],
    "128x128-2": [(TILE, "using FfmaBig = Ffma<128, 128, 8, 8, 2>;")],
    # one tile plan: 128 x 64 (8 x 4 per thread) or 64 x 64 (4 x 4) always
    "big-only": [("p.big = blocks >= sm_count();", "p.big = true;")],
    "64x64": [(TILE, "using FfmaBig = Ffma<64, 64, 4, 4, 2>;")],
    # a ring of 3 or 6 slices
    "stages3": [("kBK = 16, kStages = 4", "kBK = 16, kStages = 3")],
    "stages6": [("kBK = 16, kStages = 4", "kBK = 16, kStages = 6")],
    # every tile on the main loop that checks its copies
    "checked": [("if (fa.whole(m0, j.M) && fb.whole(n0, j.N) && (ke - kb) % kBK == 0)",
                 "if (false)")],
    # wrong by construction, to time what the copies cost: the ring is
    # filled once and never refilled; or a turned operand copies one float
    # of each thread's eight
    "diag-nocopy": [("if (kt + kStages - 1 < nk) load(kt + kStages - 1);", "")],
    "diag-turn1": [("for (int r = 0; r < kCopies; ++r) cp_async4(stage + dst + 64 * r,",
                    "for (int r = 0; r < 1; ++r) cp_async4(stage + dst + 64 * r,")],
}
LAUNCHES = ("EpiBiasTanh", "EpiBias<", "EpiDz", "ColFinals", "Memset")


def variant_dir(name: str) -> Path:
    return ROOT / "scimlsensitivity_jl_tpu_torch" / "_build" / "variant" / name


def use_variant(name: str):
    """cuda_build pointed at the variant's source and build directory."""
    from scimlsensitivity_jl_tpu_torch.ops import cuda_build
    cuda_build.CSRC = variant_dir(name) / "csrc"
    cuda_build.BUILD_DIR = variant_dir(name)
    return cuda_build


def build_variants(names) -> None:
    """Writes each variant's mlp2.cu (failing where a substitution no longer
    matches csrc/mlp2.cu) and builds them all at once."""
    for name in names:
        src = (ROOT / "scimlsensitivity_jl_tpu_torch" / "csrc" / "mlp2.cu").read_text()
        for old, new in VARIANTS[name]:
            if old not in src:
                raise SystemExit(f"variant {name}: {old!r} is no longer in "
                                 "csrc/mlp2.cu; update VARIANTS")
            src = src.replace(old, new)
        (variant_dir(name) / "csrc").mkdir(parents=True, exist_ok=True)
        (variant_dir(name) / "csrc" / "mlp2.cu").write_text(src)
    procs = [subprocess.Popen([sys.executable, __file__, "--build", name])
             for name in names]
    if any(p.wait() for p in procs):
        raise SystemExit("a variant failed to build")


def check_variant(name, torch, mlp, dev) -> None:
    """ptxas lines of the float32 kernels; K3/K4 against the plain versions
    and twice, at five shapes."""
    entry = None
    for line in use_variant(name).build_log("mlp2").splitlines():
        if "Compiling entry" in line:
            entry = line
        elif entry and "Ffma" in entry and ("registers" in line or "spill stores" in line):
            tile = entry[entry.find("FfmaILi") + 7:].split("EE")[0].replace("ELi", "x")
            epi = next(e for e in ("EpiBiasTanh", "EpiBiasI", "EpiDz", "ColFinals")
                       if e in entry)
            print(f"[{name}] ptxas Ffma<{tile}> {epi}: {line.split(':', 1)[-1].strip()}")
    gen = torch.Generator(device=dev).manual_seed(1234)
    bad = []
    for shape, off in (((1024, 512, 2048, 512), 0), ((1100, 520, 2050, 510), 0),
                       ((1, 512, 2048, 512), 0), ((1, 2, 50, 2), 0),
                       ((64, 512, 2048, 512), 1)):
        B, din, hid, dout = shape
        x, w0, b0, w1, b1, g = (
            (s * torch.randn(r * c + off, generator=gen, device=dev))[off:].view(r, c)
            for r, c, s in ((B, din, 1.0), (din, hid, din ** -0.5), (1, hid, 1.0),
                            (hid, dout, hid ** -0.5), (1, dout, 1.0), (B, dout, 1.0)))
        b0, b1 = b0[0], b1[0]
        got = mlp.mlp2_fwd_cuda(x, w0, b0, w1, b1)
        again = mlp.mlp2_fwd_cuda(x, w0, b0, w1, b1)
        h = got[1]
        got += mlp.mlp2_vjp_cuda(x, w0, w1, h, g)
        again += mlp.mlp2_vjp_cuda(x, w0, w1, h, g)
        refs = (mlp.mlp2_fwd_reference(x, w0, b0, w1, b1)
                + mlp.mlp2_vjp_reference(x, w0, w1, h, g))
        worst = max(float((a.double() - r.double()).abs().max() / r.double().abs().max())
                    for a, r in zip(got, refs))
        if worst > 1e-5 or not all(torch.equal(a, b) for a, b in zip(got, again)):
            bad.append((shape, off, worst))
    print(f"[{name}] K3/K4 vs plain within 1e-5, the same bits twice: "
          f"{'yes' if not bad else bad}", flush=True)


def time_checkout(root: str, tag: str, variant: str = None) -> None:
    sys.path.insert(0, os.path.abspath(root))
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import scimlsensitivity_jl_tpu_torch as P
    from scimlsensitivity_jl_tpu_torch.ops import mlp

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    if variant:
        check_variant(variant, torch, mlp, dev)

    def inputs(shape, dtype):
        B, din, hid, dout = shape
        gen = torch.Generator(device=dev).manual_seed(1234)
        mk = lambda *sh, s=1.0: (s * torch.randn(*sh, generator=gen,
                                                 device=dev)).to(dtype)
        return (mk(B, din), mk(din, hid, s=din ** -0.5), mk(hid, s=0.1),
                mk(hid, dout, s=hid ** -0.5), mk(dout, s=0.1), mk(B, dout))

    cases = (("S4", (1024, 512, 2048, 512), torch.bfloat16, 20),
             ("S4", (1024, 512, 2048, 512), torch.float32, 5),
             ("spiral", (1, 2, 50, 2), torch.float32, 100))
    for label, shape, dtype, calls in cases[1:] if variant else cases:
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
            each = ", ".join(
                f"{next((k for k in LAUNCHES if k in e.key), e.key[:24])} "
                f"{e.self_device_time_total / e.count:.2f}" for e in ev)
            print(f"[{tag}] {label} {str(dtype)[6:]} {name}: device {us:.2f} us "
                  f"per call, {kernels:.2f} device operations per call "
                  f"({calls} calls; each {each} us)", flush=True)
    if variant:
        return

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
    if len(sys.argv) > 2 and sys.argv[1] in ("--build", "--run"):
        sys.path.insert(0, str(ROOT))
        if sys.argv[1] == "--build":
            use_variant(sys.argv[2]).build_libraries(["mlp2"])
        else:
            use_variant(sys.argv[2])
            time_checkout(str(ROOT), sys.argv[3], variant=sys.argv[2])
        return 0
    import torch
    if not torch.cuda.is_available():
        print("compare_mlp2.py needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    if sys.argv[1:2] == ["--variant"]:
        names = sys.argv[2:]
        unknown = [n for n in names if n not in VARIANTS]
        if unknown or not names:
            print(f"unknown variants {unknown}; the variants are "
                  f"{list(VARIANTS)}", file=sys.stderr)
            return 2
        build_variants(sorted(set(names)))
        for i, name in enumerate(names):
            subprocess.run([sys.executable, os.path.abspath(__file__), "--run",
                            name, f"{i} {name}"], check=True)
        return 0
    for i, root in enumerate(sys.argv[1:] or ["."]):
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root,
                        f"{i} {root}"], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
