#!/usr/bin/env python3
"""Smoke run of the PyTorch port (scimlsensitivity_jl_tpu_torch) on one
NVIDIA GPU: the quickest proof that the port still builds, runs and agrees.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

It drives the port's paths through its entry points, each with the kernel
launch counters set to 0 just before it and read just after:

  * the flagship 1-D reaction-diffusion PDE: the gradient of
    Σ solve(...).ys[-1]² with respect to u0 and p (Tsit5, 64 fixed steps of
    1e-9, p = [1e-7, 1.5], n = 262,144 and 1,048,576 states), under
    sensealg=None (which dispatches to BacksolveAdjoint) and DirectAdjoint;
    kernels K1, K2 (csrc/rd1d.cu);
  * the neural-ODE family with the fused MLP field fused_mlp2, kernels K3,
    K4 (csrc/mlp2.cu): S1 the spiral (2->50->2 tanh MLP on u³, u0 = [2, 0],
    Tsit5, dt = 1.5/29, 30 save times on [0, 1.5], unroll=True, so
    DirectAdjoint; loss Σ(ys - data)² against a tight float64 solve of the
    true spiral); S2 the same adaptive (rtol 1e-3, atol 1e-6,
    BacksolveAdjoint, max_steps 256); S3 as S2 with sensealg=None, which
    dispatches to GaussAdjoint; S4 the batched field (B = 1024,
    512->2048->512, Tsit5, 64 fixed steps on [0, 1], sensealg=None, which
    takes the discrete fixed-grid path; loss Σ ys[-1].float()²); S5 the
    spiral adaptive under DirectAdjoint (autograd through the adaptive
    loop), also with remat=True;
  * the RK4 block megakernel (bench.py:838-954, bench_pde_megakernel):
    make_rd1d_rk4_block(n = 1,048,576, S = 16) chained 4 and 32 times (64
    and 512 RK4 steps of h = 1e-9, p = [1e-7, 1.5], the flagship u0); the
    gradient of Σ u²; kernels K5, K6 (csrc/rd1d_rk4.cu);
  * the forward-mode rules and QuadratureAdjoint: Lotka–Volterra at the
    setting of the JAX package's tests/test_forward.py (tspan (0, 10), 11
    save times, rtol 1e-10, atol 1e-12, loss Σ(ys - 1)² in u0 and p) under
    sensealg=None (ForwardDiffSensitivity), ForwardDiffSensitivity with
    chunk_size 2, ForwardSensitivity, QuadratureAdjoint and GaussAdjoint,
    and ODEForwardSensitivityProblem with extract_local_sensitivities (no
    kernel: forward mode through a kernel field is refused, which the
    phase checks); S2q, the spiral at S2's setting under QuadratureAdjoint
    (K3, K4); PDE (c), the flagship PDE under QuadratureAdjoint (K1, K2).

Phases, each printed before the last line:

  1. device: CUDA is required (no CPU fallback); the card's name and power
     limit as nvidia-smi reports them;
  2. build of the CUDA kernels from the repository's sources, one nvcc per
     source, started together (set-up time), with the ptxas lines;
  3. each kernel against its plain PyTorch version on the card (K1, K2 in
     float64 and float32 at the PDE's n, a ragged n, n = 1, 2, 3, 5, 33,
     u and λ off 16-byte alignment and λ off u's alignment, with 1 kernel
     and no memset per call in a profiler trace; K3, K4 in
     float64, float32 and bfloat16 at the spiral's, a ragged and S4's
     shape, bfloat16 also at an aligned ragged shape, each on the route
     mlp2_route picks and S4 also forced onto WMMA, with the per-route
     counters checked, and 2 kernels per K3 and per K4 call on each route
     in a profiler trace; K5, K6 in float64 and float32 at the flagship
     and a ragged geometry; K2, K4 and K6 return the same bits twice);
  4. the PDE's float64 gradient on the card against the port's own CPU run
     (plain path), with retcode, dispatch and kernel-launch checks, then
     float32 against the card's float64;
  5. S1-S3 and S5 in float64, the card against the port's CPU run (S5's
     remat arm launching K3 again for every accepted step's 6 stages); S4
     in float64 at full width with B = 8 and 4 steps, card against CPU; S4
     at full size in float32 against the card's float64 and in bfloat16
     against the card's float32 (every S4 call on the route of its dtype:
     wgmma for bfloat16); the megakernel's 64-step float64 gradient,
     card against CPU, and its float32 gradient at 64 and 512 steps against
     the card's float64;
  5d. [fwd f64]: the Lotka–Volterra gradients of every rule and the direct
     forward API, the card against the port's CPU run, the rules against
     one another; S2q and PDE (c) in float64, card against CPU, with their
     K3/K4 and K1/K2 launches, and PDE (c) in float32 against the card's
     float64 at both n; ForwardDiffSensitivity through the kernel field
     raising ForwardModeUnsupported on the card;
  6. timings: CUDA events (median of interleaved rounds) and a
     torch.profiler trace for kernel time and the device's idle share; per
     kernel device time against its bound and its plain version (K1, K2
     also cold: each call on other inputs, 128 MiB of them in turn); K3/K4
     at S4 bf16 on the wgmma and the WMMA route in turns, per kernel, and
     the cuBLAS products as a yardstick; the megakernel against the plain
     RK4 loop (64 steps) and against the plain loop with per-step
     torch.utils.checkpoint (512 steps), with the peak device memory of
     each; the Lotka–Volterra gradient of each rule against its forward,
     S2q against S1's forward and PDE (c) against the PDE forward.

Any failed check raises, so the exit code is nonzero. The line before the
last is a JSON summary of the kernels; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import itertools
import json
import os
import re
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
TIMING_REPS = 5

# the neural-ODE family (bench.py:124-163, 956-1038; __graft_entry__.py:61)
SPIRAL_T1, SPIRAL_NT = 1.5, 30
SPIRAL_ADAPTIVE = dict(rtol=1e-3, atol=1e-6, max_steps=256)
S4_WIDTHS = (512, 2048, 512)
S4_B, S4_STEPS = 1024, 64
S4_EVALS = 6 * S4_STEPS + 1  # Tsit5: 6 fresh evaluations per step + the first
# the last step's FSAL evaluation f(u1) reaches no output, so autograd never
# pulls it back: one K4 call fewer than K3 calls per gradient
S4_PULLBACKS = S4_EVALS - 1
MLP_SHAPES = {"spiral": (None, 2, 50, 2), "ragged": (37, 5, 67, 3),
              "S4": (S4_B,) + S4_WIDTHS,
              # widths that are multiples of 8 but of no tile: the wgmma
              # route with partial tiles in every dimension
              "aligned": (1000, 264, 1032, 136)}
# K3/K4 checks on the card: (dtype, shape label, forced route or None for
# the one mlp2_route picks); bfloat16 S4 also on the WMMA route it left
MLP_CHECKS = ([(dt, label, None) for dt in (torch.float64, torch.float32)
               for label in ("spiral", "ragged", "S4")]
              + [(torch.bfloat16, label, None)
                 for label in ("spiral", "ragged", "S4", "aligned")]
              + [(torch.bfloat16, "S4", "wmma")])
# H100 SXM peaks (NVIDIA data sheet, dense): the bound of each kernel is the
# larger of its bytes over HBM and its operations over the rate of its type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# relative tolerances, each with its reason in the check's printed line
K_TOL = {torch.float64: 1e-12, torch.float32: 1e-5}   # f, ū vs max|.|
KP_TOL = {torch.float64: 1e-10, torch.float32: 1e-5}  # D̄, k̄
F64_GRAD_TOL = 1e-9   # card f64 vs CPU f64, relative L2
F32_U0_TOL = 1e-4     # card f32 vs card f64, relative L2 of the u0-grad
F32_DK_TOL = 1e-3     # ... and of k̄
# K3, K4 vs plain, relative to max|.| of each output: float64 and float32
# sum up to 2048 products in another order (float32 never as TF32);
# bfloat16 outputs keep 8 bits and a sum in another order can flip one
# rounding of h, dz or an output (2^-8 each)
MLP_TOL = {torch.float64: 1e-12, torch.float32: 1e-4, torch.bfloat16: 2e-2}
NODE_F64_TOL = 1e-9   # S1-S4 card f64 vs CPU f64, relative L2 per leaf
# S4 card f32 vs card f64: 385 evaluations of 512-2048-term float32 sums
S4_F32_TOL = 1e-4
# S4 bf16 vs card f32: the bf16 state rounds at every stage (unit roundoff
# 2^-9 of |u| against increments of ~|u|/64), which compounds over 385
# stages to a few percent; an O(1) error is a wrong result
S4_BF16_TOL = 0.25

# the forward-mode and quadrature phase: Lotka–Volterra at the setting of
# the JAX package's tests/test_forward.py
LV_T1, LV_NT = 10.0, 11
LV_TOL = dict(rtol=1e-10, atol=1e-12)
LV_RULE_TOL = 1e-6    # the rules against one another, as in that test
# the device trace for the idle share covers [0, 0.5] (~40 of the 779 steps):
# a trace of the whole horizon holds ~10^6 launches, takes minutes to read
# back, and leaves later traces of the process losing events
LV_TRACE_T1 = 0.5
LV_RULES = ("ForwardDiffSensitivity (sensealg=None)", "ForwardSensitivity",
            "QuadratureAdjoint", "GaussAdjoint")

# the RK4 block megakernel (bench.py:838-954)
MEGA_N, MEGA_S, MEGA_H = 1048576, 16, 1e-9
# K5 / K6 checks: (n, S, chunk, bwd_chunk); the flagship tiles and a ragged
# geometry (windows of 1064 and 564 cells, not a multiple of a block's 512
# threads, 5 and 10 tiles)
RK4_GEOMS = {"flagship": (MEGA_N, MEGA_S, 4096, 1024),
             "ragged": (5000, 7, 1000, 500)}
# operations per cell and step of the function each kernel computes,
# counted from csrc/rd1d_rk4.cu (a multiply-add is 2): K5's RK4 step is 4
# field evaluations of 8 (stencil 3, D·inv_dx2·L 1, k·u(1-u) 3, sum 1),
# 3 stage inputs of 2 and a final combination of 6; K6 needs the stage
# states (44) and the reverse sweep: 4 transposes of 9, the w's 10, λ's
# update 4, D̄ 8 and k̄ 16
RK4_FLOPS = {"K5": 44, "K6": 44 + 74}
RK4_BYTES = {"K5": 2, "K6": 3}  # values per cell read or written once


# K1/K2 checks: (n, u's offset, λ's offset) in values into a larger buffer:
# the PDE's n, a ragged n, tiny n (no whole 16-byte vector, or one and a
# tail), u and λ both off 16-byte alignment (a scalar head before the
# vectors) and λ off u's alignment (K2 on single cells)
RD1D_CASES = [(262144, 0, 0), (262147, 0, 0), (1, 0, 0), (2, 0, 0), (3, 0, 0),
              (5, 0, 0), (33, 0, 0), (1048576, 0, 0), (262144, 1, 1),
              (262144, 0, 1)]
# K1/K2 cold timing: one call on each input set of a rotation this large,
# so that no call finds its operands in the 50 MB L2
COLD_BYTES = 128 << 20


def check(ok: bool, what: str):
    if not ok:
        raise AssertionError(what)


def rel_l2(a, b) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def rd1d_case(n, u_off, lam_off, dtype, device):
    """Seeded u ∈ [0, 1) and λ ~ N(0, 1), each a contiguous view at the given
    offset (in values) into a buffer of n + 1."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    u = torch.rand(n + 1, generator=gen, device=device, dtype=dtype)
    lam = torch.randn(n + 1, generator=gen, device=device, dtype=dtype)
    return u[u_off:u_off + n], lam[lam_off:lam_off + n]


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


def profiled_ms(fn, calls=1, kernels=None):
    """(device kernel time, host wall time) per call of fn, in ms, from a
    torch.profiler (CUPTI) trace: the sum of the kernels' own device time,
    so the rest of the wall time is the device idling on the host. Only
    device activity is traced: with host operators traced as well, the
    traces of one process lost device events after some forty of them.
    With `kernels`, fn launches that many distinct kernels once each per
    call, and the time per call is the sum of the mean times of the
    trace's `kernels` most launched kernels, which a trace that lost some
    launches, or that holds a stray event of earlier work, still gives.
    A trace without device activity (or with fewer kernels) is taken again,
    four times at most, each retry printing what the trace held."""
    fn()
    torch.cuda.synchronize()
    for attempt in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3 / calls
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and e.count]
        if kernels is None:
            busy = sum(e.self_device_time_total for e in events) / 1e3 / calls
        else:
            ours = sorted(events, key=lambda e: e.count)[-kernels:]
            busy = (sum(e.self_device_time_total / e.count for e in ours) / 1e3
                    if len(ours) == kernels else 0.0)
        if busy > 0:
            return busy, wall
        print(f"[time] trace {attempt + 1} recorded no (or not every) kernel "
              f"({[(e.key[:40], e.count) for e in events]}); again")
    raise AssertionError("the profiler recorded no device time")


def kernels_per_call(fn):
    """(device kernels, memsets) in a torch.profiler trace of one call of
    fn; a trace without a kernel is taken again, twice at most (see
    profiled_ms)."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        memsets = sum(e.count for e in events if "memset" in e.key.lower())
        count = sum(e.count for e in events
                    if "memcpy" not in e.key.lower()
                    and "memset" not in e.key.lower())
        if count:
            return count, memsets
    return 0, 0


def event_ms(fn):
    """(fn's result, CUDA-event ms) of one call: for calls of seconds, where
    the run whose result is checked is also the timed one."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


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


def mlp_inputs(shape, dtype, device):
    """Seeded K3/K4 inputs at (B, din, hid, dout); B None is the 1-D row."""
    B, din, hid, dout = shape
    gen = torch.Generator(device=device).manual_seed(SEED)
    make = lambda *sh, s=1.0: (s * torch.randn(*sh, generator=gen,
                                               device=device)).to(dtype)
    rows = 1 if B is None else B
    return (make(rows, din), make(din, hid, s=din ** -0.5), make(hid, s=0.1),
            make(hid, dout, s=hid ** -0.5), make(dout, s=0.1),
            make(rows, dout))


def mlp_bound_ms(shape, dtype):
    """(bound in ms, what bounds it) of K3 and of K4 at `shape`: each input
    read once, each output written once; 2 flops per multiply-add."""
    B, din, hid, dout = shape
    B = B or 1
    size = torch.tensor([], dtype=dtype).element_size()
    flops = 2 * B * hid * (din + dout)
    io = {"K3": (B * din + din * hid + hid + hid * dout + dout
                 + B * dout + B * hid) * size,
          "K4": (B * din + din * hid + hid * dout + B * hid + B * dout
                 + B * din + din * hid + hid + hid * dout + dout) * size}
    out = {}
    for name, fl in (("K3", flops), ("K4", 2 * flops)):
        t_ops = fl / PEAK_FLOPS[dtype] * 1e3
        t_bytes = io[name] / HBM_BYTES_PER_S * 1e3
        out[name] = (max(t_ops, t_bytes),
                     "operations" if t_ops >= t_bytes else "bytes")
    return out


def spiral_setup(P, dtype, device, data64):
    """Seeded spiral weights, u0, data and save times."""
    gen = torch.Generator().manual_seed(SEED)
    params = P.mlp_init(gen, (2, 50, 2), dtype, device=device)
    u0 = torch.tensor([2.0, 0.0], dtype=dtype, device=device)
    ts = torch.linspace(0.0, SPIRAL_T1, SPIRAL_NT, dtype=torch.float64).tolist()
    return params, u0, data64.to(device=device, dtype=dtype), ts


def spiral_data64(P):
    """The spiral's true ODE solved tightly in float64 (bench.py:124-140)."""
    prob, ts = P.spiral_data(torch.float64, SPIRAL_NT, SPIRAL_T1, device="cpu")
    sol = P.solve(prob, P.Tsit5(), saveat=ts, rtol=1e-10, atol=1e-12)
    check(sol.retcode == 0, f"spiral data solve retcode {sol.retcode}")
    return sol.ys


def spiral_solve(P, setup, kw, params):
    from scimlsensitivity_jl_tpu_torch.ops.mlp import fused_mlp2

    _, u0, _, ts = setup
    prob = P.ODEProblem(lambda u, p, t: fused_mlp2(p, u ** 3), u0,
                        (0.0, SPIRAL_T1), params)
    return P.solve(prob, P.Tsit5(), saveat=ts, **kw)


def spiral_gradient(P, setup, kw):
    """(d/dp of Σ(ys - data)² per leaf, solution)."""
    params = {k: v.detach().clone().requires_grad_()
              for k, v in setup[0].items()}
    sol = spiral_solve(P, setup, kw, params)
    grads = torch.autograd.grad(torch.sum((sol.ys - setup[2]) ** 2),
                                list(params.values()))
    return dict(zip(params, grads)), sol


def spiral_forward(P, setup, kw):
    with torch.no_grad():
        return spiral_solve(P, setup, kw, setup[0]).ys


def s4_setup(P, dtype, device, B=S4_B, steps=S4_STEPS):
    """Seeded S4 weights and u0 = 0.1·randn (drawn in float32, then cast)."""
    gen = torch.Generator().manual_seed(SEED)
    params = P.mlp_init(gen, S4_WIDTHS, dtype, device=device)
    u0 = 0.1 * torch.randn((B, S4_WIDTHS[0]), generator=gen)
    return params, u0.to(device=device, dtype=dtype), steps


def s4_solve(P, setup, params):
    from scimlsensitivity_jl_tpu_torch.ops.mlp import fused_mlp2

    _, u0, steps = setup
    prob = P.ODEProblem(lambda u, p, t: fused_mlp2(p, u), u0, (0.0, 1.0),
                        params)
    return P.solve(prob, P.Tsit5(), saveat=[0.0, 1.0], dt=1.0 / steps,
                   adaptive=False)


def s4_gradient(P, setup):
    """(d/dp of Σ ys[-1].float()² per leaf, solution)."""
    params = {k: v.detach().clone().requires_grad_()
              for k, v in setup[0].items()}
    sol = s4_solve(P, setup, params)
    grads = torch.autograd.grad(torch.sum(sol.ys[-1].float() ** 2),
                                list(params.values()))
    return dict(zip(params, grads)), sol


def s4_forward(P, setup):
    with torch.no_grad():
        return s4_solve(P, setup, setup[0]).ys[-1]


def lv_solve(P, device, sensealg, grad, t1=LV_T1):
    """Lotka–Volterra (u0 = [1, 1], p = [1.5, 1, 3, 1]) on [0, t1] with 11
    save times; with grad, (d/d[u0, p] of Σ(ys - 1)², solution), else the
    solution."""
    prob = P.lotka_volterra_problem((0.0, t1), device=device)
    u0 = prob.u0.clone().requires_grad_(grad)
    p = prob.p.clone().requires_grad_(grad)
    ts = torch.linspace(0.0, t1, LV_NT, dtype=torch.float64).tolist()
    with torch.set_grad_enabled(grad):
        sol = P.solve(P.ODEProblem(prob.f, u0, prob.tspan, p), P.Tsit5(),
                      saveat=ts, sensealg=sensealg, **LV_TOL)
        if not grad:
            return sol
        gu, gp = torch.autograd.grad(torch.sum((sol.ys - 1.0) ** 2), (u0, p))
    return torch.cat([gu, gp]), sol


def lv_sensitivities(P, device):
    """(u, S) of the direct forward API on the same problem."""
    prob = P.lotka_volterra_problem((0.0, LV_T1), device=device)
    ts = torch.linspace(0.0, LV_T1, LV_NT, dtype=torch.float64).tolist()
    sprob = P.ODEForwardSensitivityProblem(prob.f, prob.u0, prob.tspan, prob.p)
    sol = P.solve(sprob, P.Tsit5(), saveat=ts, **LV_TOL)
    return P.extract_local_sensitivities(sol), sol


def max_rel(a, b) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float(((a - b).abs() / b.abs()).max())


def leaf_errors(got, ref):
    return {k: rel_l2(got[k], ref[k]) for k in ref}


def fmt_errors(errs):
    return ", ".join(f"{k} {v:.3e}" for k, v in errs.items())


def rk4_check_inputs(n, dtype, device):
    """Seeded K5/K6 check inputs: u in [0, 1], λ ~ N(0, 1), h·D·inv_dx2 =
    1e-3, so every step moves u while the window-edge values that the halo
    absorbs stay (1e-3)^(2S+2) below the interior's."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    u = torch.rand(n, generator=gen, device=device, dtype=dtype)
    lam = torch.randn(n, generator=gen, device=device, dtype=dtype)
    inv_dx2 = float(n) * float(n)
    p = torch.tensor([1.0 / inv_dx2, 1.5], device=device, dtype=dtype)
    return u, lam, p, inv_dx2, 1e-3


def mega_run(P, u0, p, steps, grad, remat=False, block=None):
    """`steps` RK4 steps of the flagship field from u0: through the
    megakernel block (block=make_rd1d_rk4_block(...)) or, with block None,
    through the plain RK4 loop (per-step torch.utils.checkpoint when
    remat). Returns u, or (u0-grad, p-grad) of Σ u² when grad."""
    from torch.utils.checkpoint import checkpoint

    from scimlsensitivity_jl_tpu_torch.ops.rd1d import rd1d_rk4_scan_reference

    inv_dx2 = float(MEGA_N) * float(MEGA_N)
    uu = u0.clone().requires_grad_(grad)
    pp = p.clone().requires_grad_(grad)
    with torch.set_grad_enabled(grad):
        u = uu
        if block is not None:
            for _ in range(steps // MEGA_S):
                u = block(u, pp, inv_dx2, MEGA_H)
        else:
            for _ in range(steps):
                if remat:
                    u = checkpoint(rd1d_rk4_scan_reference, u, pp, inv_dx2,
                                   MEGA_H, 1, use_reentrant=False,
                                   preserve_rng_state=False)
                else:
                    u = rd1d_rk4_scan_reference(u, pp, inv_dx2, MEGA_H, 1)
        if not grad:
            return u
        return torch.autograd.grad(torch.sum(u ** 2), (uu, pp))


def ptxas_rows(log):
    """(kernel, registers, spill store bytes, spill load bytes) of each
    kernel in an `nvcc -Xptxas -v` log of csrc/rd1d_rk4.cu, the kernel
    named with its template arguments (float or double, then any
    integers)."""
    rows, entry, spills = [], None, (None, None)
    for line in log.splitlines():
        m = re.search(r"entry function '([^']+)'", line)
        if m:
            name = re.search(r"(rd1d_rk4_(?:fwd|bwd|bwd_reduce)_kernel)I([fd])"
                             r"((?:Li\d+E)*)EEv", m.group(1))
            entry = m.group(1)
            if name:
                args = ["float" if name.group(2) == "f" else "double"]
                args += re.findall(r"Li(\d+)E", name.group(3))
                entry = f"{name.group(1)}<{', '.join(args)}>"
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            rows.append((entry, int(m.group(1))) + spills)
            entry = None
    return rows


def rk4_bound_ms(name, n, S, dtype):
    """(bound in ms, what bounds it) of one K5 / K6 call at (n, S): the
    operations of S steps over the non-tensor-core peak, against each input
    read once and each output written once."""
    size = torch.tensor([], dtype=dtype).element_size()
    t_ops = S * RK4_FLOPS[name] * n / PEAK_FLOPS[torch.float32] * 1e3
    t_bytes = RK4_BYTES[name] * n * size / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def main() -> int:
    t_start = time.perf_counter()

    def elapsed(phase):
        print(f"[elapsed] {phase} done at {time.perf_counter() - t_start:.0f} s")

    # -- 1. device ---------------------------------------------------------
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; "
                           "torch.cuda.is_available() is false")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import scimlsensitivity_jl_tpu_torch as P
    from scimlsensitivity_jl_tpu_torch.ops import cuda_build, mlp, rd1d
    sources = ("rd1d", "mlp2", "rd1d_rk4")

    # every float32 comparison and timing is full float32, never TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

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
    cuda_build.build_libraries(sources)
    rd1d.load_rd1d_library()
    mlp.load_mlp2_library()
    rd1d.load_rd1d_rk4_library()
    print(f"[setup] nvcc build (in parallel) + load of "
          f"{', '.join(f'csrc/{name}.cu' for name in sources)}: "
          f"{time.perf_counter() - t:.2f} s "
          f"({' '.join(cuda_build.NVCC_FLAGS)}); allow_tf32 False")
    for name in sources:
        if name == "rd1d_rk4":
            # one line per K5 / K6 instantiation; K5's integer template
            # arguments are R, its most threads and its blocks per SM
            for kernel, regs, st, ld in ptxas_rows(cuda_build.build_log(name)):
                print(f"[setup] ptxas rd1d_rk4: {kernel}: {regs} registers, "
                      f"spill stores {st} B, spill loads {ld} B")
            continue
        for line in cuda_build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"[setup] ptxas {name}: {line.strip()}")

    # -- 3. kernels vs plain versions on the card --------------------------
    max_abs = {}
    for dtype in (torch.float64, torch.float32):
        for n, u_off, lam_off in RD1D_CASES:
            u, lam = rd1d_case(n, u_off, lam_off, dtype, dev)
            p = torch.tensor(P_FLAGSHIP, device=dev, dtype=dtype)
            inv_dx2 = float(n) * float(n)
            f = rd1d.rd1d_fwd_cuda(u, p, inv_dx2)
            du, dp = rd1d.rd1d_vjp_cuda(u, p, inv_dx2, lam)
            du2, dp2 = rd1d.rd1d_vjp_cuda(u, p, inv_dx2, lam)
            torch.cuda.synchronize()
            f_ref = rd1d.rd1d_reference(u, p, inv_dx2)
            du_ref, _ = rd1d.rd1d_vjp_reference(u, p, inv_dx2, lam)
            # D̄, k̄ against the plain version in float64 on the same inputs:
            # the sums cancel, and at n = 2^20 the float32 plain version's
            # own sum is off by up to ~1e-5 of k̄
            _, dp_ref = rd1d.rd1d_vjp_reference(u.double(), p.double(),
                                                inv_dx2, lam.double())
            e_f = float((f - f_ref).abs().max() / f_ref.abs().max())
            e_du = float((du - du_ref).abs().max() / du_ref.abs().max())
            # D̄ is exactly 0 at n = 1 (L(u) = 0): compared absolutely there
            diff = (dp.double() - dp_ref).abs()
            e_dp = torch.where(dp_ref != 0, diff / dp_ref.abs(), diff).tolist()
            same = torch.equal(du, du2) and torch.equal(dp, dp2)
            print(f"[kernels] {str(dtype)[6:]} n={n} (u at +{u_off}, λ at "
                  f"+{lam_off} values): K1 max|f-f_ref|/max|f|={e_f:.3e} (tol "
                  f"{K_TOL[dtype]:g}); K2 max|ū-ū_ref|/max|ū|={e_du:.3e} (tol "
                  f"{K_TOL[dtype]:g}), D̄ rel {e_dp[0]:.3e}, k̄ rel "
                  f"{e_dp[1]:.3e} to the float64 plain version (tol "
                  f"{KP_TOL[dtype]:g}); K2 same bits "
                  f"twice: {same}")
            check(f.shape == du.shape == (n,), f"K1/K2 shapes at n={n}")
            check(e_f <= K_TOL[dtype], f"K1 disagrees: {e_f}")
            check(e_du <= K_TOL[dtype], f"K2 ū disagrees: {e_du}")
            check(max(e_dp) <= KP_TOL[dtype], f"K2 dp disagrees: {e_dp}")
            check(same, "K2 gave other bits on a second call")
            if dtype == torch.float32 and (n, u_off, lam_off) == (262144, 0, 0):
                max_abs["K1"] = float((f - f_ref).abs().max())
                # K2's D̄, k̄ are O(1e13) and O(1) and reported relative above
                max_abs["K2"] = float((du - du_ref).abs().max())
    # one kernel per K1 and per K2 call and no memset (K2's workspace is
    # made by the first call on a stream, outside the trace)
    k12_counts = {}  # n -> {"K1": (kernels, memsets), "K2": ...}, aligned
    for n, u_off, lam_off in ((SIZES[0], 0, 0), (SIZES[1], 0, 0),
                              (SIZES[0], 1, 1), (SIZES[0], 0, 1)):
        u, lam = rd1d_case(n, u_off, lam_off, torch.float32, dev)
        p = torch.tensor(P_FLAGSHIP, device=dev)
        counts = {"K1": kernels_per_call(
                      lambda: rd1d.rd1d_fwd_cuda(u, p, float(n) ** 2)),
                  "K2": kernels_per_call(
                      lambda: rd1d.rd1d_vjp_cuda(u, p, float(n) ** 2, lam))}
        print(f"[kernels] float32 n={n} (u at +{u_off}, λ at +{lam_off}): "
              f"(kernels, memsets) per call in the profiler trace: {counts}")
        check(counts == {"K1": (1, 0), "K2": (1, 0)},
              f"K1/K2 launched {counts} (kernels, memsets) per call, not 1, 0")
        if u_off == lam_off == 0:
            k12_counts[n] = counts
    del u, lam, f, du, du2, f_ref, du_ref

    for dtype, label, forced in MLP_CHECKS:
        shape = MLP_SHAPES[label]
        x, w0, b0, w1, b1, g = mlp_inputs(shape, dtype, dev)
        route = forced or mlp.mlp2_route(*x.shape, *w1.shape, dtype, True)
        before = (dict(mlp.mlp2_fwd_cuda.routes), dict(mlp.mlp2_vjp_cuda.routes))
        y, h = mlp.mlp2_fwd_cuda(x, w0, b0, w1, b1, route=forced)
        grads = mlp.mlp2_vjp_cuda(x, w0, w1, h, g, route=forced)
        again = mlp.mlp2_vjp_cuda(x, w0, w1, h, g, route=forced)
        torch.cuda.synchronize()
        moved = [{k: v - b[k] for k, v in now.items() if v != b[k]} for now, b
                 in zip((mlp.mlp2_fwd_cuda.routes, mlp.mlp2_vjp_cuda.routes),
                        before)]
        check(moved == [{route: 1}, {route: 2}],
              f"K3/K4 {label} took {moved}, expected route {route}")
        refs = (mlp.mlp2_fwd_reference(x, w0, b0, w1, b1)
                + mlp.mlp2_vjp_reference(x, w0, w1, h, g))
        errs = {}
        for name, got, ref in zip(("y", "h", "dx", "dW0", "db0", "dW1",
                                   "db1"), (y, h) + grads, refs):
            check(got.dtype == dtype and got.shape == ref.shape,
                  f"K3/K4 {name} {got.dtype} {tuple(got.shape)}")
            d = (got.double() - ref.double()).abs().max()
            errs[name] = (float(d / ref.double().abs().max()), float(d))
        same = all(torch.equal(a, b) for a, b in zip(again, grads))
        worst = max(e for e, _ in errs.values())
        print(f"[kernels] {str(dtype)[6:]} {label} {shape} route {route}"
              f"{' (forced)' if forced else ''}: K3/K4 vs plain, "
              f"max|err|/max|ref| "
              + ", ".join(f"{k} {e:.2e}" for k, (e, _) in errs.items())
              + f" (tol {MLP_TOL[dtype]:g}); K4 same bits twice: {same}")
        check(worst <= MLP_TOL[dtype], f"K3/K4 disagree: {errs}")
        check(same, "K4 gave other bits on a second call")
        if dtype == torch.bfloat16 and label == "S4" and not forced:
            max_abs["K3"] = max(errs["y"][1], errs["h"][1])
            max_abs["K4"] = max(errs[k][1] for k in
                                ("dx", "dW0", "db0", "dW1", "db1"))

    # kernels per K3/K4 call on each route, from a profiler trace of one
    # call, among the process's first traces (later ones can lose events)
    for label, dtype in (("spiral", torch.float32), ("ragged", torch.bfloat16),
                         ("S4", torch.bfloat16)):
        x, w0, b0, w1, b1, g = mlp_inputs(MLP_SHAPES[label], dtype, dev)
        _, h = mlp.mlp2_fwd_cuda(x, w0, b0, w1, b1)
        route = mlp.mlp2_route(*x.shape, *w1.shape, dtype, True)
        counts = {"K3": kernels_per_call(lambda: mlp.mlp2_fwd_cuda(
                      x, w0, b0, w1, b1))[0],
                  "K4": kernels_per_call(lambda: mlp.mlp2_vjp_cuda(
                      x, w0, w1, h, g))[0]}
        print(f"[kernels] {label} {str(dtype)[6:]} route {route}: kernels per "
              f"call in the profiler trace: K3 {counts['K3']}, K4 "
              f"{counts['K4']}")
        check(counts == {"K3": 2, "K4": 2},
              f"{label}: K3/K4 launched {counts} kernels per call, not 2")

    for dtype in (torch.float64, torch.float32):
        n, S, chunk, bwd_chunk = RK4_GEOMS["flagship"]
        tiles = []
        for which, tile in (("fwd", chunk), ("bwd", bwd_chunk)):
            C, H, W, G = rd1d._chunk_geometry(n, S, tile)
            R, threads, smem, most = rd1d.rd1d_rk4_tile(which, W, S, dtype)
            tiles.append(f"{'K5' if which == 'fwd' else 'K6'} tile {C} "
                         f"(window {W} cells, {G} blocks): R = {R} cells per "
                         f"thread, {threads} threads (at most {most}), "
                         f"{smem} B of dynamic shared memory")
        print(f"[kernels] {str(dtype)[6:]} flagship launch: " + "; ".join(tiles))
        for label, (n, S, chunk, bwd_chunk) in RK4_GEOMS.items():
            u, lam, p, inv_dx2, h = rk4_check_inputs(n, dtype, dev)
            y = rd1d.rd1d_rk4_fwd_cuda(u, p, inv_dx2, h, S, chunk)
            du, dp = rd1d.rd1d_rk4_vjp_cuda(u, p, inv_dx2, h, S, bwd_chunk,
                                            lam)
            du2, dp2 = rd1d.rd1d_rk4_vjp_cuda(u, p, inv_dx2, h, S, bwd_chunk,
                                              lam)
            torch.cuda.synchronize()
            y_ref = rd1d.rd1d_rk4_scan_reference(u, p, inv_dx2, h, S)
            du_ref, dp_ref = rd1d.rd1d_rk4_block_vjp_reference(
                u, p, inv_dx2, h, S, lam)
            e_y = float((y - y_ref).abs().max() / y_ref.abs().max())
            e_du = float((du - du_ref).abs().max() / du_ref.abs().max())
            e_dp = ((dp - dp_ref).abs() / dp_ref.abs()).tolist()
            same = torch.equal(du, du2) and torch.equal(dp, dp2)
            print(f"[kernels] {str(dtype)[6:]} {label} (n, S, chunk, "
                  f"bwd_chunk) = {(n, S, chunk, bwd_chunk)}: K5 "
                  f"max|u-u_ref|/max|u|={e_y:.3e}, K6 max|ū-ū_ref|/max|ū|="
                  f"{e_du:.3e} (tol {K_TOL[dtype]:g}), D̄ rel {e_dp[0]:.3e}, "
                  f"k̄ rel {e_dp[1]:.3e} (tol {KP_TOL[dtype]:g}); K6 same "
                  f"bits twice: {same}")
            check(e_y <= K_TOL[dtype], f"K5 disagrees: {e_y}")
            check(e_du <= K_TOL[dtype], f"K6 ū disagrees: {e_du}")
            check(max(e_dp) <= KP_TOL[dtype], f"K6 dp disagrees: {e_dp}")
            check(same, "K6 gave other bits on a second call")
            if dtype == torch.float32 and label == "flagship":
                max_abs["K5"] = float((y - y_ref).abs().max())
                max_abs["K6"] = float((du - du_ref).abs().max())
            del y, du, du2, y_ref, du_ref

    elapsed("phase 3 (kernels against plain versions)")

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

    elapsed("phases 4-5 (PDE)")

    # -- 5b. neural-ODE paths, float64: card vs the port's CPU run ---------
    data64 = spiral_data64(P)
    spiral_arms = {
        "S1 fixed grid, unroll -> DirectAdjoint": dict(
            dt=SPIRAL_T1 / (SPIRAL_NT - 1), adaptive=False, unroll=True),
        "S2 adaptive BacksolveAdjoint": dict(SPIRAL_ADAPTIVE,
                                             sensealg=P.BacksolveAdjoint()),
        "S3 adaptive sensealg=None": dict(SPIRAL_ADAPTIVE),
        "S5 adaptive DirectAdjoint": dict(SPIRAL_ADAPTIVE,
                                          sensealg=P.DirectAdjoint()),
        "S5r adaptive DirectAdjoint(remat=True)": dict(
            SPIRAL_ADAPTIVE, sensealg=P.DirectAdjoint(remat=True)),
    }
    want_rule = [P.DirectAdjoint, P.BacksolveAdjoint, P.GaussAdjoint,
                 P.DirectAdjoint, P.DirectAdjoint]
    spiral_runs = {}
    node_launches = {"K3": 0, "K4": 0}

    wrappers = (mlp.mlp2_fwd_cuda, mlp.mlp2_vjp_cuda)
    path_routes = {}

    def count_path(fn):
        """Run one path with K3/K4's counters zeroed before and read after;
        the routes they took are left in path_routes."""
        for w in wrappers:
            w.launches = 0
            w.routes = dict.fromkeys(w.routes, 0)
        out = fn()
        torch.cuda.synchronize()
        got = tuple(w.launches for w in wrappers)
        check(got[0] > 0 and got[1] > 0, f"the path did not launch K3 and K4: "
              f"{got}")
        for name, w in zip(("K3", "K4"), wrappers):
            path_routes[name] = {k: v for k, v in w.routes.items() if v}
        node_launches["K3"] += got[0]
        node_launches["K4"] += got[1]
        return out, got

    setup_card = spiral_setup(P, torch.float64, dev, data64)
    setup_cpu = spiral_setup(P, torch.float64, "cpu", data64)
    for (arm, kw), rule in zip(spiral_arms.items(), want_rule):
        (g_card, sol), got = count_path(
            lambda: spiral_gradient(P, setup_card, kw))
        g_cpu, sol_cpu = spiral_gradient(P, setup_cpu, kw)
        errs = leaf_errors(g_card, g_cpu)
        rc = sol.adjoint.stats.retcode if sol.adjoint is not None else 0
        rev = sol.adjoint.stats if sol.adjoint is not None else "autograd"
        print(f"[node f64] {arm}: dispatched to {type(sol.sensealg).__name__}; "
              f"forward {sol.stats}; reverse {rev}; K3 {got[0]} and K4 {got[1]}"
              f" launches; card vs CPU rel L2 {fmt_errors(errs)} "
              f"(tol {NODE_F64_TOL:g})")
        check(type(sol.sensealg) is rule,
              f"{arm} dispatched to {sol.sensealg!r}")
        check(sol.retcode == 0 and rc == 0, f"{arm}: retcode {sol.retcode}/{rc}")
        check(max(errs.values()) <= NODE_F64_TOL,
              f"{arm}: f64 card gradient disagrees with the CPU run")
        spiral_runs[arm.split(" ")[0]] = (got, sol.stats)
    # remat: the backward pass evaluates every accepted step's 6 fresh Tsit5
    # stages again, one K3 launch each; the pullbacks are the same
    (k3, k4), st = spiral_runs["S5"]
    (k3r, k4r), st_r = spiral_runs["S5r"]
    print(f"[node f64] S5 remat: K3 {k3r} = {k3} + 6 x {st.n_accepted} "
          f"accepted steps; K4 {k4r} = {k4}")
    check(st_r == st and k3r == k3 + 6 * st.n_accepted and k4r == k4,
          "S5 remat did not recompute each accepted step once")

    s4_small = {dev: s4_setup(P, torch.float64, dev, B=8, steps=4),
                "cpu": s4_setup(P, torch.float64, "cpu", B=8, steps=4)}
    (g_card, sol), got = count_path(lambda: s4_gradient(P, s4_small[dev]))
    g_cpu, _ = s4_gradient(P, s4_small["cpu"])
    errs = leaf_errors(g_card, g_cpu)
    print(f"[node f64] S4 at full width, B=8, 4 steps: dispatched to "
          f"{type(sol.sensealg).__name__} on the fixed-grid discrete path; "
          f"K3 {got[0]} and K4 {got[1]} launches; card vs CPU rel L2 "
          f"{fmt_errors(errs)} (tol {NODE_F64_TOL:g})")
    check(sol.retcode == 0 and sol.adjoint is None,
          "S4 did not take the discrete fixed-grid path")
    check(max(errs.values()) <= NODE_F64_TOL, "S4 f64 card vs CPU disagrees")

    s4_grads = {}
    for dtype in (torch.float64, torch.float32, torch.bfloat16):
        setup = s4_setup(P, dtype, dev)
        (g, sol), got = count_path(lambda: s4_gradient(P, setup))
        check(sol.ys.dtype == dtype, f"S4 state dtype {sol.ys.dtype}")
        check(got == (S4_EVALS, S4_PULLBACKS),
              f"S4 {dtype}: {got} launches, expected {S4_EVALS} and "
              f"{S4_PULLBACKS}")
        finite = all(bool(torch.isfinite(v).all()) for v in g.values())
        check(finite, f"S4 {dtype}: non-finite gradient")
        s4_grads[dtype] = g
        want = "simt" if dtype != torch.bfloat16 else "wgmma"
        check(path_routes == {"K3": {want: S4_EVALS},
                              "K4": {want: S4_PULLBACKS}},
              f"S4 {dtype} took the routes {path_routes}, expected {want}")
        line = (f"[node {str(dtype)[6:]}] S4 full size (B={S4_B}, "
                f"{'->'.join(map(str, S4_WIDTHS))}, {S4_STEPS} steps): K3 "
                f"{got[0]} and K4 {got[1]} launches, routes {path_routes}")
        if dtype == torch.float32:
            errs = leaf_errors(g, s4_grads[torch.float64])
            line += (f"; vs card f64 rel L2 {fmt_errors(errs)} "
                     f"(tol {S4_F32_TOL:g})")
            check(max(errs.values()) <= S4_F32_TOL, "S4 f32 off the f64 run")
        elif dtype == torch.bfloat16:
            errs = leaf_errors(g, s4_grads[torch.float32])
            line += (f"; vs card f32 rel L2 {fmt_errors(errs)} "
                     f"(tol {S4_BF16_TOL:g})")
            check(max(errs.values()) <= S4_BF16_TOL, "S4 bf16 off the f32 run")
        print(line)
        del setup, g, sol
    del s4_grads
    print(f"[node] K3/K4 launches over S1-S5's card runs: {node_launches}")
    s1_s5_launches = dict(node_launches)

    elapsed("phase 5b (neural ODE)")

    # -- 5c. the RK4 block megakernel: f64 card vs CPU, f32 vs card f64 ------
    mega = P.make_rd1d_rk4_block(MEGA_N, MEGA_S)
    u0, p = flagship_inputs(MEGA_N, torch.float64, dev)
    rd1d.rd1d_rk4_fwd_cuda.launches = 0
    rd1d.rd1d_rk4_vjp_cuda.launches = 0
    gu64, gp64 = mega_run(P, u0, p, 64, grad=True, block=mega)
    torch.cuda.synchronize()
    mega_launches = {"K5": rd1d.rd1d_rk4_fwd_cuda.launches,
                     "K6": rd1d.rd1d_rk4_vjp_cuda.launches}
    t = time.perf_counter()
    u0c, pc = flagship_inputs(MEGA_N, torch.float64, "cpu")
    gu_c, gp_c = mega_run(P, u0c, pc, 64, grad=True, block=mega)
    e_u = rel_l2(gu64, gu_c)
    e_p = ((gp64.cpu() - gp_c).abs() / gp_c.abs()).tolist()
    print(f"[mega f64] n={MEGA_N}, S={MEGA_S}, 64 steps: K5 "
          f"{mega_launches['K5']} and K6 {mega_launches['K6']} launches; card "
          f"vs CPU u0-grad rel L2 {e_u:.3e}, dD rel {e_p[0]:.3e}, dk rel "
          f"{e_p[1]:.3e} (tol {F64_GRAD_TOL:g}); p-grad {gp64.tolist()}; CPU "
          f"run {time.perf_counter() - t:.1f} s")
    check(mega_launches == {"K5": 4, "K6": 4},
          f"the megakernel path launched {mega_launches}, not 4 and 4")
    check(e_u <= F64_GRAD_TOL and max(e_p) <= F64_GRAD_TOL,
          "megakernel f64 card gradient disagrees with the CPU run")
    del u0c, pc, gu_c, gp_c
    for steps in (64, 512):
        if steps != 64:
            gu64, gp64 = mega_run(P, u0, p, steps, grad=True, block=mega)
        u32, p32 = flagship_inputs(MEGA_N, torch.float32, dev)
        gu, gp = mega_run(P, u32, p32, steps, grad=True, block=mega)
        e_u = rel_l2(gu, gu64)
        e_dD = abs(float(gp[0]) - float(gp64[0])) / abs(float(gp64[0]))
        e_dk = abs(float(gp[1]) - float(gp64[1])) / abs(float(gp64[1]))
        print(f"[mega f32] {steps} steps vs card f64: u0-grad rel L2 "
              f"{e_u:.3e} (tol {F32_U0_TOL:g}), dk rel {e_dk:.3e} (tol "
              f"{F32_DK_TOL:g}), dD rel {e_dD:.3e} (not gated: D̄ = "
              "inv_dx2·Σ(L w)·u cancels O(1) values into L ~ 1e-9, "
              "roundoff-bound in float32 by the problem, not the kernel)")
        check(bool(torch.isfinite(gu).all()) and e_u <= F32_U0_TOL
              and e_dk <= F32_DK_TOL, f"megakernel f32 {steps} steps off f64")
    del u0, p, gu64, gp64, gu, gp

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

    elapsed("phase 5c and the sync checks")

    # -- 5d. forward mode and QuadratureAdjoint, float64: card vs CPU ---------
    from scimlsensitivity_jl_tpu_torch.ops.vjp import ForwardModeUnsupported

    lv_rules = dict(zip(LV_RULES, (None, P.ForwardSensitivity(),
                                   P.QuadratureAdjoint(), P.GaussAdjoint())))
    lv_runs = dict(lv_rules, **{
        "ForwardDiffSensitivity(chunk_size=2)":
            P.ForwardDiffSensitivity(chunk_size=2)})
    lv_grads, lv_times = {}, {}
    t = time.perf_counter()
    for name, sensealg in lv_runs.items():
        # the CPU run first, so that the timed card run finds the host side
        # warm (each takes seconds: one timed run, read in phase 6d)
        g_cpu, _ = lv_solve(P, "cpu", sensealg, grad=True)
        (g_card, sol), lv_times[name] = event_ms(
            lambda: lv_solve(P, dev, sensealg, grad=True))
        lv_grads[name] = g_card
        err = rel_l2(g_card, g_cpu)
        rev = sol.adjoint.stats if sol.adjoint is not None else "none"
        print(f"[fwd f64] Lotka-Volterra {name}: dispatched to "
              f"{type(sol.sensealg).__name__}; forward {sol.stats}; reverse "
              f"{rev}; card vs CPU rel L2 {err:.3e} (tol {F64_GRAD_TOL:g}); "
              f"grad [u0, p] {g_card.tolist()}")
        check(sol.retcode == 0, f"LV {name}: retcode {sol.retcode}")
        check(err <= F64_GRAD_TOL, f"LV {name}: card gradient off the CPU's")
        if sensealg is None:
            check(type(sol.sensealg) is P.ForwardDiffSensitivity,
                  f"LV sensealg=None dispatched to {sol.sensealg!r}")
    ref = lv_grads[LV_RULES[0]]
    errs = {k: max_rel(v, ref) for k, v in lv_grads.items()}
    print(f"[fwd f64] Lotka-Volterra rules against ForwardDiffSensitivity, "
          f"max relative difference per entry: "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + f" (tol {LV_RULE_TOL:g})")
    check(max(errs.values()) <= LV_RULE_TOL, "LV: the rules disagree")
    (u_card, S_card), sol = lv_sensitivities(P, dev)
    (u_cpu, S_cpu), _ = lv_sensitivities(P, "cpu")
    e_u, e_S = rel_l2(u_card, u_cpu), rel_l2(S_card, S_cpu)
    print(f"[fwd f64] ODEForwardSensitivityProblem + "
          f"extract_local_sensitivities: u {tuple(u_card.shape)}, S "
          f"{tuple(S_card.shape)}, forward {sol.stats}; card vs CPU rel L2 "
          f"u {e_u:.3e}, S {e_S:.3e} (tol {F64_GRAD_TOL:g}); card and CPU "
          f"runs {time.perf_counter() - t:.1f} s")
    check(tuple(S_card.shape) == (LV_NT, 4, 2) and tuple(u_card.shape)
          == (LV_NT, 2), "forward sensitivity shapes")
    check(max(e_u, e_S) <= F64_GRAD_TOL, "forward sensitivities: card off CPU")

    # the spiral (S2's setting) under QuadratureAdjoint: K3 in the forward
    # and in every pullback's recomputation, K4 at every λ stage and node
    s2q = dict(SPIRAL_ADAPTIVE, sensealg=P.QuadratureAdjoint())
    (g_card, sol), s2q_launches = count_path(
        lambda: spiral_gradient(P, setup_card, s2q))
    g_cpu, _ = spiral_gradient(P, setup_cpu, s2q)
    errs = leaf_errors(g_card, g_cpu)
    print(f"[fwd f64] S2q spiral adaptive QuadratureAdjoint: forward "
          f"{sol.stats}; reverse {sol.adjoint.stats}; K3 {s2q_launches[0]} "
          f"and K4 {s2q_launches[1]} launches; card vs CPU rel L2 "
          f"{fmt_errors(errs)} (tol {NODE_F64_TOL:g})")
    check(sol.retcode == 0 and sol.adjoint.stats.retcode == 0, "S2q retcode")
    check(max(errs.values()) <= NODE_F64_TOL, "S2q card gradient off the CPU's")

    # PDE (c): QuadratureAdjoint on the flagship field, K1 in the forward,
    # K2 at every λ stage and Gauss–Kronrod node
    n = SIZES[0]
    field = rd1d.make_rd1d_field(n, 1.0 / n)
    rd1d.rd1d_fwd_cuda.launches = 0
    rd1d.rd1d_vjp_cuda.launches = 0
    u0, p = flagship_inputs(n, torch.float64, dev)
    gu, gp, sol = flagship_gradient(P, field, n, u0, p, P.QuadratureAdjoint())
    torch.cuda.synchronize()
    pde_c_launches = {"K1": rd1d.rd1d_fwd_cuda.launches,
                      "K2": rd1d.rd1d_vjp_cuda.launches}
    u0c, pc = flagship_inputs(n, torch.float64, "cpu")
    gu_c, gp_c, _ = flagship_gradient(P, field, n, u0c, pc,
                                      P.QuadratureAdjoint())
    e_u = rel_l2(gu, gu_c)
    e_p = ((gp.cpu() - gp_c).abs() / gp_c.abs()).tolist()
    print(f"[fwd f64] PDE (c) n={n} QuadratureAdjoint: forward {sol.stats}; "
          f"reverse {sol.adjoint.stats}; K1 {pde_c_launches['K1']} and K2 "
          f"{pde_c_launches['K2']} launches; card vs CPU u0-grad rel L2 "
          f"{e_u:.3e}, dD rel {e_p[0]:.3e}, dk rel {e_p[1]:.3e} (tol "
          f"{F64_GRAD_TOL:g}); p-grad {gp.tolist()}")
    check(pde_c_launches["K1"] > 0 and pde_c_launches["K2"] > 0,
          f"PDE (c) did not launch K1 and K2: {pde_c_launches}")
    check(sol.retcode == 0 and sol.adjoint.stats.retcode == 0,
          "PDE (c) retcode")
    check(e_u <= F64_GRAD_TOL and max(e_p) <= F64_GRAD_TOL,
          "PDE (c) f64 card gradient off the CPU run")
    del u0c, pc, gu_c, gp_c
    for n in SIZES:
        field = rd1d.make_rd1d_field(n, 1.0 / n)
        u0, p = flagship_inputs(n, torch.float64, dev)
        gu64, gp64, _ = flagship_gradient(P, field, n, u0, p,
                                          P.QuadratureAdjoint())
        u0, p = flagship_inputs(n, torch.float32, dev)
        gu, gp, sol = flagship_gradient(P, field, n, u0, p,
                                        P.QuadratureAdjoint())
        e_u = rel_l2(gu, gu64)
        e_dD = abs(float(gp[0]) - float(gp64[0])) / abs(float(gp64[0]))
        e_dk = abs(float(gp[1]) - float(gp64[1])) / abs(float(gp64[1]))
        print(f"[fwd f32] PDE (c) n={n} vs card f64: u0-grad rel L2 {e_u:.3e} "
              f"(tol {F32_U0_TOL:g}), dk rel {e_dk:.3e} (tol {F32_DK_TOL:g}), "
              f"dD rel {e_dD:.3e} (not gated, as in (a)); forward "
              f"{sol.stats}, reverse {sol.adjoint.stats}")
        check(sol.retcode == 0 and sol.adjoint.stats.retcode == 0,
              f"PDE (c) f32 n={n} retcode")
        check(e_u <= F32_U0_TOL and e_dk <= F32_DK_TOL,
              f"PDE (c) f32 n={n} gradient off the f64 one")
    del u0, p, gu, gp, gu64, gp64

    # forward mode through a kernel field is refused on the card as well
    n = 4096
    small = rd1d.make_rd1d_field(n, 1.0 / n)
    u0, p = flagship_inputs(n, torch.float64, dev)
    pp = p.clone().requires_grad_()
    sol = P.solve(P.ODEProblem(small, u0, (0.0, 4 * DT), pp), P.Tsit5(),
                  saveat=[0.0, 4 * DT], dt=DT, adaptive=False,
                  sensealg=P.ForwardDiffSensitivity())
    try:
        torch.autograd.grad(torch.sum(sol.ys[-1] ** 2), pp)
    except ForwardModeUnsupported as e:
        refusal = str(e)
    else:
        raise AssertionError("ForwardDiffSensitivity through FusedRD1D ran")
    print(f"[fwd f64] ForwardDiffSensitivity through the kernel field "
          f"(n={n}, on the card) raised ForwardModeUnsupported: "
          f"{refusal[:90]}...")
    check("FusedRD1D" in refusal and "custom_vjp" in refusal,
          f"the refusal does not name the Function: {refusal}")
    del u0, p, pp, sol

    elapsed("phase 5d (forward mode and QuadratureAdjoint)")

    # -- 6. timings: the megakernel path first ---------------------------------
    u0, p = flagship_inputs(MEGA_N, torch.float32, dev)
    arms = {
        "megakernel forward": lambda: mega_run(P, u0, p, 64, False, block=mega),
        "plain forward": lambda: mega_run(P, u0, p, 64, False),
        "megakernel gradient": lambda: mega_run(P, u0, p, 64, True, block=mega),
        "plain gradient": lambda: mega_run(P, u0, p, 64, True),
    }
    med = interleaved_ms(arms)
    for name, fn in arms.items():
        busy, wall = profiled_ms(fn)
        print(f"[time] {card}: megakernel path f32 n={MEGA_N}, 64 steps, "
              f"{name}: {med[name]:.3f} ms "
              f"({med[name] / med['plain forward']:.3f}x the plain forward; "
              f"CUDA events, median of {TIMING_REPS} interleaved); profiled run: kernels {busy:.3f} ms of "
              f"{wall:.3f} ms wall, device idle {100 * (1 - busy / wall):.1f}%")
    arms = {
        "megakernel gradient": lambda: mega_run(P, u0, p, 512, True,
                                                block=mega),
        "plain per-step-checkpoint gradient": lambda: mega_run(
            P, u0, p, 512, True, remat=True),
    }
    med = interleaved_ms(arms, rounds=3)
    for name, fn in arms.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fn()
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
        print(f"[time] {card}: megakernel path f32 n={MEGA_N}, 512 steps, "
              f"{name}: {med[name]:.3f} ms (CUDA events, median of 3 "
              f"interleaved); peak device memory above the inputs "
              f"{peak:.1f} MiB (torch.cuda.max_memory_allocated)")

    lam = torch.randn(MEGA_N, generator=torch.Generator(device=dev).manual_seed(
        SEED), device=dev)
    inv_dx2 = float(MEGA_N) * float(MEGA_N)
    versions = {
        "K5": lambda: rd1d.rd1d_rk4_fwd_cuda(u0, p, inv_dx2, MEGA_H, MEGA_S,
                                             4096),
        "K5_plain": lambda: rd1d.rd1d_rk4_scan_reference(u0, p, inv_dx2,
                                                         MEGA_H, MEGA_S),
        "K6": lambda: rd1d.rd1d_rk4_vjp_cuda(u0, p, inv_dx2, MEGA_H, MEGA_S,
                                             1024, lam),
        "K6_plain": lambda: rd1d.rd1d_rk4_block_vjp_reference(
            u0, p, inv_dx2, MEGA_H, MEGA_S, lam),
    }
    rk4_timing = {}
    for name, fn in versions.items():
        calls = 20 if name in ("K5", "K6") else 3
        # K5 is one launch per call, K6 two (the window pass and the
        # one-block reduction): their mean times hold where a trace lost
        # launches, which a trace's sum over the calls does not
        busy, wall = profiled_ms(fn, calls=calls, kernels={
            "K5": 1, "K6": 2}.get(name))
        rk4_timing[name] = busy
        kname = name[:2]
        bound, by = rk4_bound_ms(kname, MEGA_N, MEGA_S, torch.float32)
        flops = MEGA_S * RK4_FLOPS[kname] * MEGA_N
        print(f"[time] {card}: n={MEGA_N} S={MEGA_S} f32 {name}: device "
              f"{busy * 1e3:.2f} us per call ({flops / (busy * 1e-3) / 1e12:.2f}"
              f" TFLOP/s of the function's {flops / 1e9:.3f} GFLOP), bound "
              f"{bound * 1e3:.2f} us by {by} ({100 * bound / busy:.1f}% of it),"
              f" host-paced {wall * 1e3:.2f} us per call; profiler over "
              f"{calls} calls")
    del u0, p, lam

    elapsed("phase 6 (megakernel timings)")

    # -- 6b. PDE timings --------------------------------------------------------
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

        u, lam = rd1d_case(n, 0, 0, torch.float32, dev)
        inv_dx2 = float(n) * float(n)
        versions = {
            "K1": lambda u, lam: rd1d.rd1d_fwd_cuda(u, p, inv_dx2),
            "K1_plain": lambda u, lam: rd1d.rd1d_reference(u, p, inv_dx2),
            "K2": lambda u, lam: rd1d.rd1d_vjp_cuda(u, p, inv_dx2, lam),
            "K2_plain": lambda u, lam: rd1d.rd1d_vjp_reference(u, p, inv_dx2,
                                                               lam),
        }
        sets = -(-COLD_BYTES // (4 * n))  # K1 reads u: 4n bytes per call
        gen = torch.Generator(device=dev).manual_seed(SEED + 1)
        U = torch.rand(sets, n, generator=gen, device=dev)
        L = torch.randn(sets, n, generator=gen, device=dev)
        timing[n] = {}
        for name, fn in versions.items():
            # K1 and K2 launch one kernel per call (phase 3): their mean
            # holds where a trace lost some launches
            kern = None if "_" in name else 1
            busy, wall = profiled_ms(lambda: fn(u, lam), calls=100,
                                     kernels=kern)
            timing[n][name] = busy
            cells = 8 if name.startswith("K1") else 12
            bound = cells * n / HBM_BYTES_PER_S * 1e3
            line = (f"[time] {card}: n={n} f32 {name}: device {busy * 1e3:.2f} "
                    f"us per call warm ({cells * n / (busy * 1e-3) / 1e9:.0f} "
                    f"GB/s of {cells} B/cell, {100 * bound / busy:.1f}% of "
                    "the HBM bound), "
                    f"host-paced {wall * 1e3:.2f} us per call; profiler over "
                    "100 calls")
            if "_" not in name:
                # cold: each call on another (u, λ) of a rotation of at
                # least COLD_BYTES of inputs; the profiler's mean per call
                k_sets = sets if name == "K1" else -(-sets // 2)
                pairs = itertools.cycle(list(zip(U[:k_sets], L[:k_sets])))
                cold_ms, _ = profiled_ms(lambda: fn(*next(pairs)),
                                         calls=k_sets, kernels=kern)
                timing[n][f"{name}_cold"] = cold_ms
                kernels, memsets = k12_counts[n][name]
                line += (f"; cold {cold_ms * 1e3:.2f} us per call "
                         f"({100 * bound / cold_ms:.1f}% of the bound; "
                         f"profiler over {k_sets} calls on {k_sets} input "
                         f"sets, {k_sets * (cells - 4) * n >> 20} MiB of "
                         f"inputs); {kernels} kernel and {memsets} memsets "
                         "per call (phase 3's trace)")
            print(line)
        del U, L

    elapsed("phase 6b (PDE timings)")

    # -- 6c. neural-ODE timings ------------------------------------------------
    setup32 = spiral_setup(P, torch.float32, dev, data64)
    arms = {"S1 forward": lambda: spiral_forward(
        P, setup32, spiral_arms["S1 fixed grid, unroll -> DirectAdjoint"])}
    for arm, kw in spiral_arms.items():
        arms[arm.split(" ")[0] + " gradient"] = (
            lambda kw=kw: spiral_gradient(P, setup32, kw))
    med = interleaved_ms(arms, rounds=10)
    for name, fn in arms.items():
        busy, wall = profiled_ms(fn)
        print(f"[time] {card}: spiral f32 {name}: {med[name]:.3f} ms "
              f"({med[name] / med['S1 forward']:.2f}x S1 forward; CUDA events, "
              f"median of 10 interleaved); profiled run: kernels {busy:.3f} ms "
              f"of {wall:.3f} ms wall, device idle "
              f"{100 * (1 - busy / wall):.1f}%")

    setup_bf = s4_setup(P, torch.bfloat16, dev)
    arms = {"S4 forward": lambda: s4_forward(P, setup_bf),
            "S4 gradient": lambda: s4_gradient(P, setup_bf)}
    med = interleaved_ms(arms, rounds=5)
    eval_flops = 2 * S4_B * S4_WIDTHS[1] * (S4_WIDTHS[0] + S4_WIDTHS[2])
    for name, fn in arms.items():
        flops = eval_flops * S4_EVALS
        if name == "S4 gradient":  # K4 does twice K3's products
            flops += 2 * eval_flops * S4_PULLBACKS
        busy, wall = profiled_ms(fn)
        print(f"[time] {card}: S4 bf16 {name}: {med[name]:.3f} ms "
              f"({med[name] / med['S4 forward']:.2f}x forward; CUDA events, "
              f"median of 5 interleaved), {flops / 1e9:.1f} GFLOP of field "
              f"products -> {flops / (med[name] * 1e-3) / 1e12:.1f} TFLOP/s "
              f"({100 * flops / (med[name] * 1e-3) / PEAK_FLOPS[torch.bfloat16]:.1f}"
              f"% of the bf16 peak); profiled run: kernels {busy:.3f} ms of "
              f"{wall:.3f} ms wall, device idle {100 * (1 - busy / wall):.1f}%")
    del setup_bf

    mlp_timing = {}
    for label, dtype, calls in (("S4", torch.bfloat16, 20),
                                ("S4", torch.float32, 5),
                                ("spiral", torch.float32, 100)):
        shape = MLP_SHAPES[label]
        x, w0, b0, w1, b1, g = mlp_inputs(shape, dtype, dev)
        _, h = mlp.mlp2_fwd_cuda(x, w0, b0, w1, b1)
        versions = {
            "K3": lambda: mlp.mlp2_fwd_cuda(x, w0, b0, w1, b1),
            "K3_plain": lambda: mlp.mlp2_fwd_reference(x, w0, b0, w1, b1),
            "K4": lambda: mlp.mlp2_vjp_cuda(x, w0, w1, h, g),
            "K4_plain": lambda: mlp.mlp2_vjp_reference(x, w0, w1, h, g),
        }
        route = mlp.mlp2_route(*x.shape, *w1.shape, dtype, True)
        bounds = mlp_bound_ms(shape, dtype)
        key = (label, dtype)
        mlp_timing[key] = {"bound": bounds}
        for name, fn in versions.items():
            busy, wall = profiled_ms(fn, calls=calls,
                                     kernels=None if "_" in name else 2)
            mlp_timing[key][name] = busy
            kname = name[:2]
            flops = (2 if kname == "K3" else 4) * (shape[0] or 1) * shape[2] * (
                shape[1] + shape[3])
            print(f"[time] {card}: {label} {shape} {str(dtype)[6:]} {name}"
                  f"{'' if '_' in name else ' (route ' + route + ')'}: "
                  f"device {busy * 1e3:.2f} us per call "
                  f"({flops / (busy * 1e-3) / 1e12:.2f} TFLOP/s), bound "
                  f"{bounds[kname][0] * 1e3:.4g} us by {bounds[kname][1]} "
                  f"({100 * bounds[kname][0] / busy:.1f}% of it), host-paced "
                  f"{wall * 1e3:.2f} us per call; profiler over {calls} calls")

    # S4 bf16: the wgmma route against the WMMA route it replaced, in turns
    # (new, old, old, new), and the cuBLAS products as a yardstick
    x, w0, b0, w1, b1, g = mlp_inputs(MLP_SHAPES["S4"], torch.bfloat16, dev)
    _, h = mlp.mlp2_fwd_cuda(x, w0, b0, w1, b1)
    dzc = h.clone()  # any (B, hid) bfloat16 operand
    pairs = {
        "K3": {r: (lambda r=r: mlp.mlp2_fwd_cuda(x, w0, b0, w1, b1, route=r))
               for r in ("wgmma", "wmma")},
        "K4": {r: (lambda r=r: mlp.mlp2_vjp_cuda(x, w0, w1, h, g, route=r))
               for r in ("wgmma", "wmma")},
    }
    for kname, fns in pairs.items():
        got = {r: [] for r in fns}
        for r in ("wgmma", "wmma", "wmma", "wgmma"):
            got[r].append(profiled_ms(fns[r], calls=20, kernels=2)[0])
        mean = {r: sum(v) / len(v) for r, v in got.items()}
        bound = mlp_timing[("S4", torch.bfloat16)]["bound"][kname][0]
        mlp_timing[("S4", torch.bfloat16)][f"{kname}_wmma"] = mean["wmma"]
        print(f"[time] {card}: S4 bf16 {kname} in turns (wgmma, wmma, wmma, "
              f"wgmma; profiler over 20 calls each): wgmma "
              + "/".join(f"{t * 1e3:.2f}" for t in got["wgmma"])
              + " us, wmma " + "/".join(f"{t * 1e3:.2f}" for t in got["wmma"])
              + f" us; mean {mean['wgmma'] * 1e3:.2f} against "
              f"{mean['wmma'] * 1e3:.2f} us ({mean['wmma'] / mean['wgmma']:.2f}x"
              f"), {100 * bound / mean['wgmma']:.1f}% / "
              f"{100 * bound / mean['wmma']:.1f}% of the {bound * 1e3:.2f} us "
              "bound")
    parts = {"EpiBiasTanh": "h = tanh(x·W0 + b0)", "EpiBias<": "y = h·W1 + b1",
             "EpiDz": "launch 1 (dW1, dz, g sums)",
             "ColFinals": "launch 2 (dx, dW0, db0, db1)"}
    for kname in ("K3", "K4"):
        fn = pairs[kname]["wgmma"]
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
        rows = [f"{label} {e.self_device_time_total / e.count:.2f} us"
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.count
                for key, label in parts.items() if key in e.key]
        print(f"[time] {card}: S4 bf16 {kname} wgmma per kernel (profiler, "
              f"mean of 20 calls): {', '.join(rows)}")
    yard = {"K3": lambda: (x @ w0, h @ w1),
            "K4": lambda: (h.T @ g, g @ w1.T, x.T @ dzc, dzc @ w0.T)}
    lib = {k: profiled_ms(fn, calls=20)[0] for k, fn in yard.items()}
    print(f"[time] {card}: S4 bf16 yardstick the port never calls, bf16 "
          f"torch.matmul (cuBLAS) of the same products: K3's 2 "
          f"{lib['K3'] * 1e3:.2f} us, K4's 4 {lib['K4'] * 1e3:.2f} us per "
          "call (no epilogues, no column sums); profiler over 20 calls")
    mlp_timing[("S4", torch.bfloat16)]["cublas"] = lib

    elapsed("phase 6c (neural-ODE timings)")

    # -- 6d. forward mode and QuadratureAdjoint timings -------------------------
    for _ in range(2):  # the second forward is the one kept
        _, lv_times["forward"] = event_ms(
            lambda: lv_solve(P, dev, None, grad=False))
    setup32 = spiral_setup(P, torch.float32, dev, data64)
    arms = {"S1 forward": lambda: spiral_forward(
                P, setup32, spiral_arms["S1 fixed grid, unroll -> DirectAdjoint"]),
            "S2q gradient": lambda: spiral_gradient(P, setup32, s2q)}
    med = interleaved_ms(arms, rounds=5)
    for name, fn in arms.items():
        busy, wall = profiled_ms(fn)
        print(f"[time] {card}: spiral f32 {name} (QuadratureAdjoint): "
              f"{med[name]:.3f} ms ({med[name] / med['S1 forward']:.2f}x S1 "
              f"forward; CUDA events, median of 5 interleaved); profiled run: "
              f"kernels {busy:.3f} ms of {wall:.3f} ms wall, device idle "
              f"{100 * (1 - busy / wall):.1f}%")
    for n in SIZES:
        field = rd1d.make_rd1d_field(n, 1.0 / n)
        u0, p = flagship_inputs(n, torch.float32, dev)
        arms = {"forward": lambda: flagship_forward(P, field, u0, p),
                "(c) QuadratureAdjoint": lambda: flagship_gradient(
                    P, field, n, u0, p, P.QuadratureAdjoint())}
        med = interleaved_ms(arms)
        for name, fn in arms.items():
            busy, wall = profiled_ms(fn)
            print(f"[time] {card}: n={n} f32 {name}: {med[name]:.3f} ms "
                  f"({med[name] / med['forward']:.2f}x forward; CUDA events, "
                  f"median of {TIMING_REPS} interleaved); profiled run: "
                  f"kernels {busy:.3f} ms of {wall:.3f} ms wall, device idle "
                  f"{100 * (1 - busy / wall):.1f}%")
    del u0, p

    # Lotka-Volterra last: its traces hold the most launches of any
    for name, sensealg in [("forward", None)] + list(lv_runs.items()):
        ms = lv_times[name]
        busy, wall = profiled_ms(lambda: lv_solve(
            P, dev, sensealg, grad=name != "forward", t1=LV_TRACE_T1))
        print(f"[time] {card}: Lotka-Volterra f64 (11 saves, rtol 1e-10) "
              f"{name}{'' if name == 'forward' else ' gradient'}: {ms:.3f} ms "
              f"({ms / lv_times['forward']:.2f}x the forward; CUDA events "
              f"around one run, phase 5d's for a gradient); profiled run on "
              f"[0, {LV_TRACE_T1}]: kernels {busy:.3f} ms of {wall:.3f} ms "
              f"wall, device idle {100 * (1 - busy / wall):.1f}%")
    elapsed("phase 6d")

    n = SIZES[0]
    k1_bound = 8 * n / HBM_BYTES_PER_S * 1e3
    k2_bound = 12 * n / HBM_BYTES_PER_S * 1e3
    s4 = mlp_timing[("S4", torch.bfloat16)]
    kernels = [
        {"name": "rd1d_fwd (K1)", "route": "cuda",
         "source": "scimlsensitivity_jl_tpu_torch/csrc/rd1d.cu",
         "replaces": "scimlsensitivity_jl_tpu/ops/pallas_pde.py:58",
         "launches": launches["K1"] + pde_c_launches["K1"],
         "paths": {"PDE (a)+(b)": launches["K1"],
                   "PDE (c) QuadratureAdjoint": pde_c_launches["K1"]},
         "max_abs_err": max_abs["K1"],
         "ms": timing[n]["K1"], "plain_ms": timing[n]["K1_plain"],
         "cold_ms": timing[n]["K1_cold"],
         "kernels_per_call": k12_counts[n]["K1"][0],
         "bound_ms": k1_bound, "bound_by": "bytes", "library_ms": None},
        {"name": "rd1d_vjp (K2)", "route": "cuda",
         "source": "scimlsensitivity_jl_tpu_torch/csrc/rd1d.cu",
         "replaces": "scimlsensitivity_jl_tpu/ops/pallas_pde.py:66",
         "launches": launches["K2"] + pde_c_launches["K2"],
         "paths": {"PDE (a)+(b)": launches["K2"],
                   "PDE (c) QuadratureAdjoint": pde_c_launches["K2"]},
         "max_abs_err": max_abs["K2"],
         "ms": timing[n]["K2"], "plain_ms": timing[n]["K2_plain"],
         "cold_ms": timing[n]["K2_cold"],
         "kernels_per_call": k12_counts[n]["K2"][0],
         "bound_ms": k2_bound, "bound_by": "bytes", "library_ms": None},
        {"name": "mlp2_fwd (K3)", "route": "cuda",
         "source": "scimlsensitivity_jl_tpu_torch/csrc/mlp2.cu",
         "replaces": "scimlsensitivity_jl_tpu/ops/pallas_mlp.py:53",
         "launches": s1_s5_launches["K3"] + s2q_launches[0],
         "paths": {"S1-S5": s1_s5_launches["K3"],
                   "S2q QuadratureAdjoint": s2q_launches[0]},
         "max_abs_err": max_abs["K3"],
         "ms": s4["K3"], "plain_ms": s4["K3_plain"],
         "bound_ms": s4["bound"]["K3"][0], "bound_by": s4["bound"]["K3"][1],
         "library_ms": None},
        {"name": "mlp2_vjp (K4)", "route": "cuda",
         "source": "scimlsensitivity_jl_tpu_torch/csrc/mlp2.cu",
         "replaces": "scimlsensitivity_jl_tpu/ops/pallas_mlp.py:68",
         "launches": s1_s5_launches["K4"] + s2q_launches[1],
         "paths": {"S1-S5": s1_s5_launches["K4"],
                   "S2q QuadratureAdjoint": s2q_launches[1]},
         "max_abs_err": max_abs["K4"],
         "ms": s4["K4"], "plain_ms": s4["K4_plain"],
         "bound_ms": s4["bound"]["K4"][0], "bound_by": s4["bound"]["K4"][1],
         "library_ms": None},
    ]
    for name, label, line in (("K5", "rd1d_rk4_fwd", 223),
                              ("K6", "rd1d_rk4_vjp", 253)):
        bound, by = rk4_bound_ms(name, MEGA_N, MEGA_S, torch.float32)
        kernels.append(
            {"name": f"{label} ({name})", "route": "cuda",
             "source": "scimlsensitivity_jl_tpu_torch/csrc/rd1d_rk4.cu",
             "replaces": f"scimlsensitivity_jl_tpu/ops/pallas_pde.py:{line}",
             "launches": mega_launches[name],
             "paths": {"megakernel 64 steps": mega_launches[name]},
             "max_abs_err": max_abs[name],
             "ms": rk4_timing[name], "plain_ms": rk4_timing[f"{name}_plain"],
             "bound_ms": bound, "bound_by": by, "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
