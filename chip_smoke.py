#!/usr/bin/env python3
"""Smoke run of the PyTorch port (scimlsensitivity_jl_tpu_torch) on one
NVIDIA GPU: the quickest proof that the port still builds, runs and agrees.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

It drives the port's main path, the gradient of Σ solve(...).ys[-1]² with
respect to u0 and p for the flagship 1-D reaction-diffusion PDE (Tsit5, 64
fixed steps of 1e-9, p = [1e-7, 1.5], n = 262,144 and 1,048,576 states),
under sensealg=None (which dispatches to BacksolveAdjoint) and under
DirectAdjoint. Phases, each printed before the last line:

  1. device: CUDA is required (no CPU fallback); the card's name and power
     limit as nvidia-smi reports them;
  2. build of the CUDA kernels from the repository's sources (set-up time);
  3. each kernel against its plain PyTorch version on the card;
  4. the float64 gradient on the card against the port's own CPU run
     (plain path), with retcode, dispatch and kernel-launch checks;
  5. the float32 gradients against the card's float64 ones;
  6. timings: CUDA events (median of 10, arms interleaved) and a
     torch.profiler trace for kernel time and the device's idle share.

Any failed check raises, so the exit code is nonzero. The line before the
last is a JSON summary of the kernels; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
import warnings

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

SEED = 1234
STEPS, DT = 64, 1e-9
P_FLAGSHIP = (1e-7, 1.5)
ADJ = dict(adj_rtol=1e-3, adj_atol=1e-8, adj_max_steps=128)
SIZES = (262144, 1048576)
TIMING_REPS = 10

# relative tolerances, each with its reason in the check's printed line
K_TOL = {torch.float64: 1e-12, torch.float32: 1e-5}   # f, ū vs max|.|
KP_TOL = {torch.float64: 1e-10, torch.float32: 1e-5}  # D̄, k̄
F64_GRAD_TOL = 1e-9   # card f64 vs CPU f64, relative L2
F32_U0_TOL = 1e-4     # card f32 vs card f64, relative L2 of the u0-grad
F32_DK_TOL = 1e-3     # ... and of k̄


def check(ok: bool, what: str):
    if not ok:
        raise AssertionError(what)


def rel_l2(a, b) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def flagship_inputs(n, dtype, device):
    x = torch.arange(n, dtype=dtype, device=device) / n
    u0 = torch.exp(-((x - 0.5) ** 2) * 100.0)
    return u0, torch.tensor(P_FLAGSHIP, dtype=dtype, device=device)


def flagship_gradient(P, field, n, u0, p, sensealg):
    """(u0-grad, p-grad, solution) of Σ ys[-1]² through the port's solve."""
    uu = u0.clone().requires_grad_()
    pp = p.clone().requires_grad_()
    t1 = STEPS * DT
    sol = P.solve(P.ODEProblem(field, uu, (0.0, t1), pp), P.Tsit5(),
                  saveat=[0.0, t1], dt=DT, adaptive=False, sensealg=sensealg,
                  **ADJ)
    gu, gp = torch.autograd.grad(torch.sum(sol.ys[-1] ** 2), (uu, pp))
    return gu, gp, sol


def flagship_forward(P, field, u0, p):
    t1 = STEPS * DT
    with torch.no_grad():
        sol = P.solve(P.ODEProblem(field, u0, (0.0, t1), p), P.Tsit5(),
                      saveat=[0.0, t1], dt=DT, adaptive=False)
    return sol.ys[-1]


def profiled_ms(fn, calls=1):
    """(device kernel time, host wall time) per call of fn, in ms, from a
    torch.profiler (CUPTI) trace: the sum of the kernels' own device time,
    so the rest of the wall time is the device idling on the host."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3 / calls
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3 / calls
    check(busy > 0, "the profiler recorded no device time")
    return busy, wall


def interleaved_ms(fns, rounds=TIMING_REPS):
    """Median CUDA-event time of each fn, measured in turns (one call of
    each per round, the order rotating) after one warm-up round."""
    names = list(fns)
    for name in names:
        fns[name]()
    times = {name: [] for name in names}
    for r in range(rounds):
        for name in names[r % len(names):] + names[:r % len(names)]:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fns[name]()
            end.record()
            torch.cuda.synchronize()
            times[name].append(start.elapsed_time(end))
    return {name: statistics.median(ts) for name, ts in times.items()}


def main() -> int:
    # -- 1. device ---------------------------------------------------------
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; "
                           "torch.cuda.is_available() is false")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import scimlsensitivity_jl_tpu_torch as P
    from scimlsensitivity_jl_tpu_torch.ops import cuda_build, rd1d

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}; {torch.cuda.get_device_name(0)} "
          f"x{torch.cuda.device_count()}")
    print(card)

    # -- 2. build ----------------------------------------------------------
    t = time.perf_counter()
    rd1d.load_rd1d_library()
    print(f"[setup] nvcc build + load of csrc/rd1d.cu: "
          f"{time.perf_counter() - t:.2f} s ({' '.join(cuda_build.NVCC_FLAGS)})")
    for line in cuda_build.build_log("rd1d").splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"[setup] ptxas: {line.strip()}")

    # -- 3. kernels vs plain versions on the card --------------------------
    max_abs = {}
    for dtype in (torch.float64, torch.float32):
        for n in (262144, 262147):
            gen = torch.Generator(device=dev).manual_seed(SEED)
            u = torch.rand(n, generator=gen, device=dev, dtype=dtype)
            lam = torch.randn(n, generator=gen, device=dev, dtype=dtype)
            p = torch.tensor(P_FLAGSHIP, device=dev, dtype=dtype)
            inv_dx2 = float(n) * float(n)
            f = rd1d.rd1d_fwd_cuda(u, p, inv_dx2)
            du, dp = rd1d.rd1d_vjp_cuda(u, p, inv_dx2, lam)
            torch.cuda.synchronize()
            f_ref = rd1d.rd1d_reference(u, p, inv_dx2)
            du_ref, dp_ref = rd1d.rd1d_vjp_reference(u, p, inv_dx2, lam)
            e_f = float((f - f_ref).abs().max() / f_ref.abs().max())
            e_du = float((du - du_ref).abs().max() / du_ref.abs().max())
            e_dp = ((dp - dp_ref).abs() / dp_ref.abs()).tolist()
            print(f"[kernels] {str(dtype)[6:]} n={n}: K1 max|f-f_ref|/max|f|="
                  f"{e_f:.3e} (tol {K_TOL[dtype]:g}); K2 max|ū-ū_ref|/max|ū|="
                  f"{e_du:.3e} (tol {K_TOL[dtype]:g}), D̄ rel {e_dp[0]:.3e}, "
                  f"k̄ rel {e_dp[1]:.3e} (tol {KP_TOL[dtype]:g})")
            check(e_f <= K_TOL[dtype], f"K1 disagrees: {e_f}")
            check(e_du <= K_TOL[dtype], f"K2 ū disagrees: {e_du}")
            check(max(e_dp) <= KP_TOL[dtype], f"K2 dp disagrees: {e_dp}")
            if dtype == torch.float32 and n == 262144:
                max_abs["K1"] = float((f - f_ref).abs().max())
                # K2's D̄, k̄ are O(1e13) and O(1) and reported relative above
                max_abs["K2"] = float((du - du_ref).abs().max())

    # -- 4. main path, float64: card vs the port's CPU run -----------------
    n = SIZES[0]
    field = rd1d.make_rd1d_field(n, 1.0 / n)
    results64 = {}
    rd1d.rd1d_fwd_cuda.launches = 0
    rd1d.rd1d_vjp_cuda.launches = 0
    for arm, sensealg in (("a", None), ("b", P.DirectAdjoint())):
        u0, p = flagship_inputs(n, torch.float64, dev)
        gu, gp, sol = flagship_gradient(P, field, n, u0, p, sensealg)
        torch.cuda.synchronize()
        results64[arm] = (gu, gp)
        check(sol.retcode == 0, f"({arm}) forward retcode {sol.retcode}")
        if arm == "a":
            check(isinstance(sol.sensealg, P.BacksolveAdjoint),
                  f"(a) dispatched to {sol.sensealg!r}")
            check(sol.adjoint.stats.retcode == 0,
                  f"(a) adjoint retcode {sol.adjoint.stats.retcode}")
            print(f"[main f64] (a) sensealg=None -> {type(sol.sensealg).__name__}"
                  f"; forward {sol.stats}; reverse {sol.adjoint.stats}")
    launches = {"K1": rd1d.rd1d_fwd_cuda.launches,
                "K2": rd1d.rd1d_vjp_cuda.launches}
    print(f"[main f64] kernel launches during (a)+(b): K1 {launches['K1']}, "
          f"K2 {launches['K2']}")
    check(launches["K1"] > 0 and launches["K2"] > 0,
          f"the main path did not launch every kernel: {launches}")

    t = time.perf_counter()
    for arm, sensealg in (("a", None), ("b", P.DirectAdjoint())):
        u0, p = flagship_inputs(n, torch.float64, "cpu")
        gu_c, gp_c, _ = flagship_gradient(P, field, n, u0, p, sensealg)
        gu, gp = results64[arm]
        e_u = rel_l2(gu, gu_c)
        e_p = [abs(float(gp[i].cpu() - gp_c[i]) / float(gp_c[i]))
               for i in range(2)]
        print(f"[main f64] ({arm}) card vs CPU: u0-grad rel L2 {e_u:.3e}, "
              f"dD rel {e_p[0]:.3e}, dk rel {e_p[1]:.3e} (tol {F64_GRAD_TOL:g})"
              f"; p-grad {gp.tolist()}")
        check(e_u <= F64_GRAD_TOL and max(e_p) <= F64_GRAD_TOL,
              f"({arm}) f64 card gradient disagrees with the CPU run")
    print(f"[main f64] CPU reference runs: {time.perf_counter() - t:.1f} s")

    # -- 5. main path, float32 vs the card's float64 -------------------------
    for n in SIZES:
        field = rd1d.make_rd1d_field(n, 1.0 / n)
        for arm, sensealg in (("a", None), ("b", P.DirectAdjoint())):
            u0, p = flagship_inputs(n, torch.float64, dev)
            gu64, gp64, _ = flagship_gradient(P, field, n, u0, p, sensealg)
            before = (rd1d.rd1d_fwd_cuda.launches, rd1d.rd1d_vjp_cuda.launches)
            u0, p = flagship_inputs(n, torch.float32, dev)
            gu, gp, sol = flagship_gradient(P, field, n, u0, p, sensealg)
            after = (rd1d.rd1d_fwd_cuda.launches, rd1d.rd1d_vjp_cuda.launches)
            check(all(a > b for a, b in zip(after, before)),
                  f"f32 ({arm}) n={n} did not launch both kernels")
            e_u = rel_l2(gu, gu64)
            e_dD = abs(float(gp[0]) - float(gp64[0])) / abs(float(gp64[0]))
            e_dk = abs(float(gp[1]) - float(gp64[1])) / abs(float(gp64[1]))
            rc = sol.adjoint.stats.retcode if sol.adjoint is not None else 0
            print(f"[main f32] n={n} ({arm}) vs card f64: u0-grad rel L2 "
                  f"{e_u:.3e} (tol {F32_U0_TOL:g}), dk rel {e_dk:.3e} (tol "
                  f"{F32_DK_TOL:g}), dD rel {e_dD:.3e} (not gated: D̄ = "
                  "inv_dx2·Σλ·L(u) cancels O(1) values into L(u) ~ 1e-9, "
                  "roundoff-bound in float32 by the problem, not the kernel); "
                  f"forward {sol.stats}, adjoint retcode {rc}")
            check(sol.retcode == 0 and rc == 0, f"f32 ({arm}) n={n} retcode")
            check(e_u <= F32_U0_TOL and e_dk <= F32_DK_TOL,
                  f"f32 ({arm}) n={n} gradient off the f64 one")

    # -- host syncs: the fixed-grid march and DirectAdjoint make none; the
    # Backsolve reverse reads its error norm once per step attempt ------------
    n = SIZES[0]
    field = rd1d.make_rd1d_field(n, 1.0 / n)
    u0, p = flagship_inputs(n, torch.float32, dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        flagship_forward(P, field, u0, p)
        flagship_gradient(P, field, n, u0, p, P.DirectAdjoint())
    finally:
        torch.cuda.set_sync_debug_mode("default")
    print("[syncs] forward and (b) DirectAdjoint ran under "
          "torch.cuda.set_sync_debug_mode('error'): no host sync")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            _, _, sol = flagship_gradient(P, field, n, u0, p, None)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    n_sync = sum("synchroniz" in str(w.message) for w in caught)
    attempts = sol.adjoint.stats.n_fevals // 7
    print(f"[syncs] (a) default->Backsolve: {n_sync} host syncs for "
          f"{attempts} reverse step attempts (one error-norm read each, plus "
          "the initial-step norms, the weight count and the drift guard)")

    # -- 6. timings ------------------------------------------------------------
    timing = {}
    for n in SIZES:
        field = rd1d.make_rd1d_field(n, 1.0 / n)
        u0, p = flagship_inputs(n, torch.float32, dev)
        arms = {
            "forward": lambda: flagship_forward(P, field, u0, p),
            "(a) default->Backsolve": lambda: flagship_gradient(
                P, field, n, u0, p, None),
            "(b) DirectAdjoint": lambda: flagship_gradient(
                P, field, n, u0, p, P.DirectAdjoint()),
        }
        med = interleaved_ms(arms)
        t_fwd = med["forward"]
        for name, fn in arms.items():
            busy, wall = profiled_ms(fn)
            print(f"[time] {card}: n={n} f32 {name}: {med[name]:.3f} ms "
                  f"({med[name] / t_fwd:.2f}x forward; CUDA events, median of "
                  f"{TIMING_REPS} interleaved); profiled run: kernels "
                  f"{busy:.3f} ms of {wall:.3f} ms wall, device idle "
                  f"{100 * (1 - busy / wall):.1f}%")

        gen = torch.Generator(device=dev).manual_seed(SEED)
        u = torch.rand(n, generator=gen, device=dev, dtype=torch.float32)
        lam = torch.randn(n, generator=gen, device=dev, dtype=torch.float32)
        inv_dx2 = float(n) * float(n)
        versions = {
            "K1": lambda: rd1d.rd1d_fwd_cuda(u, p, inv_dx2),
            "K1_plain": lambda: rd1d.rd1d_reference(u, p, inv_dx2),
            "K2": lambda: rd1d.rd1d_vjp_cuda(u, p, inv_dx2, lam),
            "K2_plain": lambda: rd1d.rd1d_vjp_reference(u, p, inv_dx2, lam),
        }
        timing[n] = {}
        for name, fn in versions.items():
            busy, wall = profiled_ms(fn, calls=100)
            timing[n][name] = busy
            cells = 8 if name.startswith("K1") else 12
            print(f"[time] {card}: n={n} f32 {name}: device {busy * 1e3:.2f} "
                  f"us per call ({cells * n / (busy * 1e-3) / 1e9:.0f} GB/s of "
                  f"{cells} B/cell), host-paced {wall * 1e3:.2f} us per call; "
                  "profiler over 100 calls")

    n = SIZES[0]
    kernels = [
        {"name": "rd1d_fwd (K1)", "route": "cuda",
         "source": "scimlsensitivity_jl_tpu_torch/csrc/rd1d.cu",
         "replaces": "scimlsensitivity_jl_tpu/ops/pallas_pde.py:58",
         "launches": launches["K1"], "max_abs_err": max_abs["K1"],
         "ms": timing[n]["K1"], "plain_ms": timing[n]["K1_plain"]},
        {"name": "rd1d_vjp (K2)", "route": "cuda",
         "source": "scimlsensitivity_jl_tpu_torch/csrc/rd1d.cu",
         "replaces": "scimlsensitivity_jl_tpu/ops/pallas_pde.py:66",
         "launches": launches["K2"], "max_abs_err": max_abs["K2"],
         "ms": timing[n]["K2"], "plain_ms": timing[n]["K2_plain"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
