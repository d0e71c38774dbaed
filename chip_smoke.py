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
    setting of the JAX package's tests/test_forward.py on (0, 1) (the
    test's span is (0, 10)), 11 save times, rtol 1e-10, atol 1e-12, loss
    Σ(ys - 1)² in u0 and p, under
    sensealg=None (ForwardDiffSensitivity), ForwardDiffSensitivity with
    chunk_size 2, ForwardSensitivity, QuadratureAdjoint and GaussAdjoint,
    and ODEForwardSensitivityProblem with extract_local_sensitivities (no
    kernel: forward mode through a kernel field is refused, which the
    phase checks); S2q, the spiral at S2's setting under QuadratureAdjoint
    (K3, K4); PDE (c), the flagship PDE under QuadratureAdjoint (K1, K2);
  * InterpolatingAdjoint, GaussKronrodAdjoint and Gauss checkpointed or
    pinned: the flagship PDE under (d) InterpolatingAdjoint() (auto-pinned
    to the forward's 64 steps), (d-) the same with pinned_reverse=False,
    (e) InterpolatingAdjoint(checkpointing=True) with a checkpoint every 8
    steps (8 intervals solved again), (f) GaussKronrodAdjoint() (K1, K2);
    the spiral at S2's setting under InterpolatingAdjoint() (S2i),
    GaussKronrodAdjoint() (S2k), GaussAdjoint(checkpointing=True) (S2c)
    and GaussAdjoint(pinned_reverse=True) (S2p) (K3, K4); Lotka–Volterra
    under InterpolatingAdjoint and GaussKronrodAdjoint, and the auto-pinned
    against the unpinned InterpolatingAdjoint on [0, 0.5];
  * events, dense output and save times: the flagship PDE with one dose
    (PresetTimeCallback at 24 ns, affect u ← 0.9u + 0.05u²), adaptive Tsit5
    on [0, 64 ns] from dt0 = 1e-9, float64 at n = 262,144 (rtol 1e-8,
    atol 1e-10) and float32 at n = 1,048,576 (rtol 1e-4, atol 1e-7), loss
    Σ ys[-1]², under sensealg=None (GaussAdjoint), BacksolveAdjoint,
    InterpolatingAdjoint and DirectAdjoint (K1, K2); the spiral at S2's
    setting with the continuous event ‖u‖² = 7.2555 (affect u ← 0.8u)
    under sensealg=None (GaussAdjoint), InterpolatingAdjoint,
    BacksolveAdjoint, QuadratureAdjoint and DirectAdjoint (S2e), with
    dense=True and the loss Σ sol(t)² over 50 query times under GaussAdjoint
    and InterpolatingAdjoint (S2d), and the gradient of a saveat tensor
    under GaussAdjoint (S2t) (K3, K4); the bouncing ball of
    bench.py:289-316 in float64 (no kernel);
  * the direct APIs: the flagship PDE at (d-)'s setting with dense output,
    the cost Σ u(t1)² given as dgdu_discrete at t1, under
    adjoint_sensitivities with InterpolatingAdjoint (the default),
    BacksolveAdjoint, GaussAdjoint and QuadratureAdjoint, and
    ODEAdjointProblem's Interpolating layout solved by hand with the
    port's solve (K1, K2); the dosed PDE under the Interpolating direct
    API with its callback=; the spiral at S2's setting under the Gauss
    direct API, the discrete cost 2(u − data) at its 30 save times, also
    with the continuous cost g = Σu² (K3, K4); Lotka–Volterra's Hessian on
    (0, 1) under DirectAdjoint and GaussAdjoint, reverse over reverse (no
    kernel); second order through the rd1d and the fused MLP field, which
    raises DoubleBackwardUnsupported.
  * DAEs on mass matrices: Robertson in semi-explicit form (M = diag(1, 1,
    0), the loss 1e4·Σ y2 + Σ y3 of the JAX package's tests/test_dae.py in
    log p and u0's differential part, on (0, 1e-3) at rtol 1e-5) under
    sensealg=None (ForwardDiffSensitivity), DirectAdjoint,
    InterpolatingAdjoint, GaussAdjoint and QuadratureAdjoint on SDIRK4 and
    GaussAdjoint on FBDF; the rotated non-diagonal mass under
    GaussAdjoint; dae_init="newton"; the spiral's field under an
    invertible 2×2 mass with Tsit5 and GaussAdjoint (K3, K4);
  * delay equations: u'(t) = mlp2(u(t - 0.25)) with S4's field (B = 1024,
    512->2048->512, float32) on [0, 1], history u0, under the RK4 fixed
    grid (dt = 1/64) and adaptive Tsit5 (rtol 1e-6), loss Σ ys[-1]² (K3,
    K4 in every stage and its pullback); the JAX package's stiff TRBDF2
    case.

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
     shape, float32 and bfloat16 also at an aligned ragged shape, each on
     the route mlp2_route picks and S4 also forced onto WMMA, with the
     per-route counters checked, and 2 kernels per K3 and per K4 call on
     each route in a profiler trace (S4 float32, whose products split,
     also one memset of their counters); K5, K6 in float64 and float32 at
     the flagship and a ragged geometry; K2, K4 and K6 return the same
     bits twice);
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
  5e. [interp f64]: PDE (d)-(f) at n = 262,144, the card against the port's
     CPU run, each arm with the reverse that ran checked ((d) pinned, one
     reverse step on each of the 64 intervals, which its K2 launches
     count; (e) 8 intervals solved again), its K1/K2 launches, then
     float32 against the card's float64 at both n; S2i, S2k, S2c and S2p,
     card against CPU, with their K3/K4 launches; the Lotka–Volterra rules
     on the card against ForwardDiffSensitivity, and the auto-pinned
     against the unpinned reverse on [0, 0.5], gradients and times;
  5f. [events f64]: the dosed PDE at n = 262,144 under each rule, the card
     against the port's CPU run, one dose recorded, sensealg=None on
     GaussAdjoint, K1/K2 launches, then float32 at n = 1,048,576 against
     the card's float64; S2e, S2d and S2t, card against CPU, with the same
     event count on both (at least one) and their K3/K4 launches, then in
     float32 on the card against the card's float64 (retcode, event
     count); the bouncing ball under GaussAdjoint against
     ForwardDiffSensitivity;
  5g. [direct f64]: each direct arm at n = 262,144, the card against the
     port's CPU run and against the card's solve gradient of its rule
     (adaptive reverse, the same reverse tolerances), its K1/K2 launches in
     the direct call (the float32 arms at n = 1,048,576 are 6g's timed
     calls, held there to the card's float64); the dosed PDE and the
     spiral arms, card against CPU and against the solve gradient, with
     their launches; the two Hessians
     symmetric and agreeing; the refusal of second order on the card;
  5i. [stiff f64]: Robertson's FBDF Gauss gradient and Rosenbrock23's
     Interpolating one, card against CPU and against ForwardDiff; FBDF
     under ForwardDiffSensitivity (the replayed history), card against
     CPU and against FBDF's Gauss gradient; Rosenbrock23 under
     DirectAdjoint through a saveat tensor, card against CPU in log p and
     the save times; the nonlinear solve; the kernel field's refusal;
  5j. [dae f64]: each Robertson arm on the card against the port's CPU
     run (1e-9 where the steps agree, else the stiff gate), the rotated
     DAE's continuous event under ForwardDiffSensitivity among them, the
     continuous rules and DirectAdjoint against ForwardDiffSensitivity
     (rtol 2e-3, as tests/test_dae.py), GaussAdjoint through the event
     against ForwardDiff (rtol 2e-3), dae_init against its closed form;
     the spiral under the mass, card against CPU, with its K3/K4
     launches; a DAE on the kernel field raising ForwardModeUnsupported
     with no launch;
  5k. [dde]: the delayed S4 field's gradients at full width in float32
     under RK4 and Tsit5 (K3/K4 launches per gradient, the simt route, the
     two against each other), then in float64 at B = 8, card against CPU;
     the stiff TRBDF2 case, card against CPU and against a fine RK4; TRBDF2
     on the kernel field raising ForwardModeUnsupported with no launch;
  5l. [nsde]: the neural SDE at S4's width (drift fused_mlp2(θ_f, u),
     diagonal diffusion 0.1·softplus(fused_mlp2(θ_g, u)), B = 1024,
     512->2048->512, float32 on the simt route, EulerMaruyama at dt 1/64
     on [0, 1], the port's own key, loss Σ ys[-1]²): K3 per forward and
     K3/K4 per gradient under DirectAdjoint, InterpolatingAdjoint and
     BacksolveAdjoint against the counts each rule should give, the same
     bits on a second call, Interpolating against Direct and Backsolve
     within the JAX package's tolerance; B = 8 float64 on the numpy-backed
     key, card against CPU; Milstein, RKMilGeneral, StrongTaylor15,
     ImplicitEM, EulerHeun (the Itô drift transform) and adaptive Milstein
     on the kernel fields raising ForwardModeUnsupported with no launch;
  5m. [fkpp]: the stochastic Fisher–KPP field (the flagship field as
     drift, diagonal noise 0.5·u, EulerMaruyama, 64 steps of 1e-9, n =
     1,048,576 float32) and its RODE form f + 0.5·u·W(t), under the three
     rules: K1/K2 launches per forward and gradient, the same bits twice,
     the rules against each other; n = 262,144 float64 on the numpy key,
     card against CPU (the SDE under each rule, the RODE under Direct);
     adaptive EulerMaruyama on the Brownian tree (a plain Fisher–KPP
     field on 8 cells) under the three rules: at near-deterministic noise
     card against CPU (a smoke test of the device path: the realised grid
     amplifies a last-bit difference) and the rules against each other,
     at the fixed-grid arms' noise 0.5·u the rules against each other on
     the card;
  5n. [shadow]: Lorenz (ρ = 28, d⟨z⟩/dρ ≈ 1.01) in float64 at the settings
     of the JAX package's tests/test_shadowing.py: ForwardLSS (Cos) and
     AdjointLSS (TimeDilation 10) on the 1001-row attractor (one
     trajectory handed to both devices), NILSS (nseg 30, nstep 101) and
     NILSAS (M 2) on (30, 60), each within the JAX test's tolerance of
     1.01 and against the port's CPU run; NILSAS segment_parallel against
     sequential; bench.py's lorenz_nilss in float32 (nseg 10, nstep 100,
     (0, 20), rtol 1e-6) timed sequential and segment_parallel with the
     solves' step counts (under load), the idle share from a trace of one
     segment. These host-paced arms (1-3 ms of host time per field
     evaluation, 10^4-10^5 evaluations) run in processes of their own
     (`--background`, three on the card and one on the CPU), started
     after the build, beside phases 3-5m, which take no timing, and
     joined here. NILSAS(nseg 4, M 2) through K3/K4 at S4's width in
     float32 (simt): K3/K4 launches per forward and per gradient against
     the counts the code gives, forward and gradient times and idle
     shares; B = 8 float64 card against CPU; ForwardLSS, AdjointLSS and
     NILSS on that field raising ForwardModeUnsupported with no launch;
  5o. [ensemble]: the spiral through K3/K4, 16 trajectories with u0 scaled
     by 1 + i/16 (bench.py:179-197), GaussAdjoint, float32: each
     trajectory's rows equal its own solve bit for bit, the time per
     trajectory against one trajectory's gradient;
  5p. [digits]: the digits model at bench.py:1238-1305's widths, three
     Adam steps at batch 32 (the loss falls; the third traced by
     utils.profile.trace for its idle share), the float64 gradient at
     batch 4 against the CPU; entry() on the card;
  5q. [shard]: the flagship PDE with its state split over two ranks that
     share the card over gloo (`--shard` processes; the card host has one
     GPU, and NCCL refuses two ranks on one device), u0 a DTensor with
     placement Shard(0): float32 at n = 1,048,576 and float64 at n =
     262,144, under sensealg=None (BacksolveAdjoint), DirectAdjoint and
     InterpolatingAdjoint, each rank's K1/K2 on its n/2 cells with one
     ghost cell per side from the other; u0 a Gaussian centred off the
     shards' cut (x = 0.4), so that the cut's two sides differ. The
     gradients against phase 4's gradient function run unsharded on the
     same problem in this process (float64 within 1e-10, float32 at phase
     5's float32 gates), and the float64 gate's reading with the exchange
     cut (each half solved alone with edge copies) printed and required
     to fail that gate; each
     rank's K1/K2 launches equal to the unsharded run's and each launch
     over n/2 cells; each arm's wall (CUDA events) beside the unsharded
     one, K1/K2 per launch at n/2 from a profiler trace, and the share of
     a gradient's wall spent inside the collectives (gloo stages CUDA
     tensors through host memory);
  6. timings: CUDA events (median of interleaved rounds) and a
     torch.profiler trace for kernel time and the device's idle share; per
     kernel device time against its bound and its plain version (K1, K2
     also cold: each call on other inputs, 128 MiB of them in turn); K3/K4
     at S4 bf16 on the wgmma and the WMMA route in turns, per kernel, and
     the cuBLAS products as a yardstick; the megakernel against the plain
     RK4 loop (64 steps) and against the plain loop with per-step
     torch.utils.checkpoint (512 steps), with the peak device memory of
     each; the Lotka–Volterra gradient of each rule against its forward
     (not traced), S2q against S1's forward and PDE (c) against the PDE
     forward (PDE (d)-(f), S2i-S2p and the spiral arms S1-S5 are checked
     in phase 5 but not timed, to keep the command near 800 s); phase 5f's
     arms (PDE dose f32 at n = 1,048,576, the ball; the spiral's S2e, S2d
     and S2t not timed, to keep the command under ~900 s) each against its
     own forward, with the device's idle share; phase 5g's PDE arms at
     n = 1,048,576 in float32, each direct call against the dense forward it reads, with
     the device's idle share, and its gradient from the warm-up round
     against the card's float64 one, with its K1/K2 launches; the spiral
     under the mass and the delayed S4 field (RK4 and Tsit5) each against
     its own forward, with the device's idle share (5i's and 5j's
     Robertson gradients are checked there and not timed, to keep the
     command under ~950 s with phase 5q);
     phase 5l's and 5m's forwards and gradients (the neural SDE at full
     width, the SDE and RODE Fisher–KPP at n = 1,048,576), each against
     its own forward, with the device's idle share; K3/K4 alone at S4's
     float32 shape on the simt route, per launch, and the float32 cuBLAS
     products of the same work as a yardstick, at S4's shape and at the
     spiral's (in the kernels line).

Any failed check raises, so the exit code is nonzero. The line before the
last is a JSON summary of the kernels; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import atexit
import itertools
import json
import math
import os
import re
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

SEED = 1234
STEPS, DT = 64, 1e-9
P_FLAGSHIP = (1e-7, 1.5)
ADJ = dict(adj_rtol=1e-3, adj_atol=1e-8, adj_max_steps=128)
# PDE (e): a checkpoint every 8 steps, 7 inside the span, 8 intervals
PDE_CHECKPOINTS = tuple(k * 8 * DT for k in range(1, STEPS // 8))
SIZES = (262144, 1048576)
TIMING_REPS = 5

# the neural-ODE family (bench.py:124-163, 956-1038; __graft_entry__.py:61)
SPIRAL_T1, SPIRAL_NT = 1.5, 30
SPIRAL_ADAPTIVE = dict(rtol=1e-3, atol=1e-6, max_steps=256)
S4_WIDTHS = (512, 2048, 512)
S4_B, S4_STEPS = 1024, 64
# ranks of phase 5q's sharded states; a row-split S4 batch gives each
# SHARD_WORLD-th of S4_B's rows
SHARD_WORLD = 2
S4_EVALS = 6 * S4_STEPS + 1  # Tsit5: 6 fresh evaluations per step + the first
# the last step's FSAL evaluation f(u1) reaches no output, so autograd never
# pulls it back: one K4 call fewer than K3 calls per gradient
S4_PULLBACKS = S4_EVALS - 1
MLP_SHAPES = {"spiral": (None, 2, 50, 2), "ragged": (37, 5, 67, 3),
              "S4": (S4_B,) + S4_WIDTHS,
              # a rank's rows of the row-split S4 batch (phase 5q), where
              # the float32 plan may take the other simt tile
              "S4 shard": (S4_B // SHARD_WORLD,) + S4_WIDTHS,
              # widths that are multiples of 8 but of no tile: the wgmma
              # route with partial tiles in every dimension
              "aligned": (1000, 264, 1032, 136)}
# K3/K4 checks on the card: (dtype, shape label, forced route or None for
# the one mlp2_route picks); bfloat16 S4 also on the WMMA route it left
MLP_CHECKS = ([(dt, label, None) for dt in (torch.float64, torch.float32)
               for label in ("spiral", "ragged", "S4")]
              + [(torch.float32, label, None) for label in ("aligned",
                                                             "S4 shard")]
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
# S2e, S2d, S2t card f32 vs card f64, relative L2 per leaf: their adaptive
# steps differ (atol 1e-6 sits near float32's resolution of |u| ~ 2); the
# port's CPU runs of the two types part by at most 2.1e-6
SPIRAL_F32_TOL = 1e-4
# S4 bf16 vs card f32: the bf16 state rounds at every stage (unit roundoff
# 2^-9 of |u| against increments of ~|u|/64), which compounds over 385
# stages to a few percent; an O(1) error is a wrong result
S4_BF16_TOL = 0.25

# the forward-mode and quadrature phase: Lotka–Volterra at the setting of
# the JAX package's tests/test_forward.py
# on (0, 1) (the JAX test: (0, 10), 779 steps): the phases 5d, 5e and 6d
# ran ~300 s of the command's 1200 s on (0, 10), and 5j/5k need the room
LV_T1, LV_NT = 1.0, 11
LV_TOL = dict(rtol=1e-10, atol=1e-12)
LV_RULE_TOL = 1e-6    # the rules against one another, as in that test
# the device trace for the idle share covers [0, 0.5] (a quarter of the steps):
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


# events, dense output and save times (phase 5f): the flagship field with
# one dose at 24 ns of the 64 ns span (affect u ← 0.9u + 0.05u², whose
# Jacobian is not the identity), adaptive Tsit5 from dt0 = 1e-9, float64
# at n = 262,144 and float32 at n = 1,048,576
EV_T1, EV_DOSE_T = STEPS * DT, 24e-9
EV_TOL = {torch.float64: dict(rtol=1e-8, atol=1e-10),
          torch.float32: dict(rtol=1e-4, atol=1e-7)}
EV_N = {torch.float64: 262144, torch.float32: 1048576}
# the spiral's event: ‖u‖² = c with affect u ← 0.8u, c the midpoint of
# ‖u‖² over S2's undisturbed forward at SEED (4.0 at t = 0, 10.511 at 1.5)
SPIRAL_EVENT_C = 7.2555
DENSE_NQ = 50  # sol(t) query times on the spiral
EV_RULE_TOL = 1e-6  # the bouncing ball: GaussAdjoint against ForwardDiff
EV_TIMING_ROUNDS = 2

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


def shard_inputs(n, dtype, device):
    """flagship_inputs with the Gaussian centred at x = 0.4, off the cut
    between two shards at x = 0.5, where its slope is then ~-7.4: a rank
    that took its own edge cell as the ghost at the cut, or swapped its
    two ghosts, would move the gradient far past phase 5q's gates."""
    x = torch.arange(n, dtype=dtype, device=device) / n
    u0 = torch.exp(-((x - 0.4) ** 2) * 100.0)
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
    With `kernels`, fn launches that many distinct kernels (or memsets)
    once each per call, and the time per call is the sum of the mean
    times of the trace's `kernels` most launched of them, which a trace that lost some
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
    fn; a trace without a kernel, one that lost its events, is taken
    again, seven times at most, each retry printing so (see profiled_ms)."""
    fn()
    torch.cuda.synchronize()
    for attempt in range(8):
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
        print(f"[kernels] trace {attempt + 1} recorded no kernel; again")
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


def interleaved_ms(fns, rounds=TIMING_REPS, outputs=None):
    """Median CUDA-event time of each fn, measured in turns (one call of
    each per round, the order rotating) after one warm-up round, whose
    results go into the dict `outputs` when one is given."""
    names = list(fns)
    for name in names:
        out = fns[name]()
        if outputs is not None:
            outputs[name] = out
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


def spiral_solve(P, setup, kw, params, solver=None, plain=False):
    """The spiral through K3/K4 (fused_mlp2) or, plain, through the plain
    version of the same MLP (forward mode, which the kernels refuse)."""
    from scimlsensitivity_jl_tpu_torch.ops.mlp import fused_mlp2, mlp2_reference

    _, u0, _, ts = setup
    if plain:
        field = lambda u, p, t: mlp2_reference(u ** 3, p["W0"], p["b0"],
                                               p["W1"], p["b1"])
    else:
        field = lambda u, p, t: fused_mlp2(p, u ** 3)
    prob = P.ODEProblem(field, u0, (0.0, SPIRAL_T1), params)
    return P.solve(prob, solver or P.Tsit5(), saveat=ts, **kw)


def spiral_gradient(P, setup, kw, solver=None, plain=False):
    """(d/dp of Σ(ys - data)² per leaf, solution)."""
    params = {k: v.detach().clone().requires_grad_()
              for k, v in setup[0].items()}
    sol = spiral_solve(P, setup, kw, params, solver, plain)
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
    integers and booleans)."""
    rows, entry, spills = [], None, (None, None)
    for line in log.splitlines():
        m = re.search(r"entry function '([^']+)'", line)
        if m:
            name = re.search(r"(rd1d_rk4_(?:fwd|bwd|bwd_reduce)_kernel)I([fd])"
                             r"((?:L[ib]\d+E)*)EEv", m.group(1))
            entry = m.group(1)
            if name:
                args = ["float" if name.group(2) == "f" else "double"]
                args += [v if t == "i" else ("false", "true")[int(v)]
                         for t, v in re.findall(r"L([ib])(\d+)E",
                                                name.group(3))]
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


def dose_affect(u, p, t):
    return 0.9 * u + 0.05 * u * u


def dose_solve(P, field, u0, p, sensealg, dtype, **extra):
    cb = P.PresetTimeCallback([EV_DOSE_T], dose_affect)
    return P.solve(P.ODEProblem(field, u0, (0.0, EV_T1), p), P.Tsit5(),
                   saveat=[0.0, EV_T1], dt0=DT, callback=cb,
                   sensealg=sensealg, **EV_TOL[dtype], **extra)


def dose_gradient(P, field, u0, p, sensealg, **extra):
    """(u0-grad, p-grad, solution) of Σ ys[-1]² of the dosed PDE."""
    uu = u0.clone().requires_grad_()
    pp = p.clone().requires_grad_()
    sol = dose_solve(P, field, uu, pp, sensealg, u0.dtype, **extra)
    gu, gp = torch.autograd.grad(torch.sum(sol.ys[-1] ** 2), (uu, pp))
    return gu, gp, sol


def dose_forward(P, field, u0, p):
    with torch.no_grad():
        return dose_solve(P, field, u0, p, None, u0.dtype).ys[-1]


def spiral_event_kw(P, kw):
    cb = P.ContinuousCallback(
        lambda u, p, t: u[0] ** 2 + u[1] ** 2 - SPIRAL_EVENT_C,
        lambda u, p, t: 0.8 * u)
    return dict(kw, callback=cb)


def spiral_dense_gradient(P, setup, kw):
    """(d/dp of Σ over DENSE_NQ query times of sol(t)², solution)."""
    params = {k: v.detach().clone().requires_grad_()
              for k, v in setup[0].items()}
    sol = spiral_solve(P, setup, dict(kw, dense=True), params)
    tq = torch.linspace(0.0, SPIRAL_T1, DENSE_NQ + 2,
                        dtype=torch.float64)[1:-1].tolist()
    grads = torch.autograd.grad(torch.sum(sol(tq) ** 2),
                                list(params.values()))
    return dict(zip(params, grads)), sol


def spiral_saveat_gradient(P, setup, kw):
    """(d/d[params, save times] of Σ(ys - data)², solution): the save
    times a CPU tensor that requires grad."""
    from scimlsensitivity_jl_tpu_torch.ops.mlp import fused_mlp2

    params0, u0, data, ts = setup
    params = {k: v.detach().clone().requires_grad_()
              for k, v in params0.items()}
    sv = torch.tensor(ts, dtype=torch.float64, requires_grad=True)
    prob = P.ODEProblem(lambda u, p, t: fused_mlp2(p, u ** 3), u0,
                        (0.0, SPIRAL_T1), params)
    sol = P.solve(prob, P.Tsit5(), saveat=sv, **kw)
    grads = torch.autograd.grad(torch.sum((sol.ys - data) ** 2),
                                list(params.values()) + [sv])
    return dict(zip(list(params) + ["saveat"], grads)), sol


def ball_solve(P, device, sensealg, grad):
    """The bouncing ball of bench.py:289-316 in float64: Σ ys[:, 0]² and
    its p-gradient (p = [g, restitution]), or the solution."""
    cb = P.ContinuousCallback(
        condition=lambda u, p, t: u[0],
        affect=lambda u, p, t: torch.stack([u[0], -p[1] * u[1]]),
        direction=-1)
    p = torch.tensor([9.8, 0.8], dtype=torch.float64, device=device)
    p.requires_grad_(grad)
    u0 = torch.tensor([1.0, 0.0], dtype=torch.float64, device=device)
    ts = torch.linspace(0.0, 1.2, 7, dtype=torch.float64).tolist()
    with torch.set_grad_enabled(grad):
        sol = P.solve(P.ODEProblem(
            lambda u, q, t: torch.stack([u[1], -q[0] + 0.0 * u[0]]), u0,
            (0.0, 1.2), p), P.Tsit5(), saveat=ts, rtol=1e-6, atol=1e-8,
            callback=cb, sensealg=sensealg, max_steps=256)
        if not grad:
            return sol
        (gp,) = torch.autograd.grad(torch.sum(sol.ys[:, 0] ** 2), (p,))
    return gp, sol


# the direct APIs (phase 5g): each arm's reverse at the tolerances of the
# solve gradient it is held to (PDE: ADJ; the dosed PDE and the spiral:
# their forward's), so that both run the same reverse; a Lotka–Volterra
# Hessian at the setting of the JAX package's tests/test_interface.py:98-170
DIRECT_PDE_RULES = ("InterpolatingAdjoint", "BacksolveAdjoint",
                    "GaussAdjoint", "QuadratureAdjoint")
DIRECT_TOL = ADJ["adj_rtol"]  # direct call vs the solve gradient, rel L2
LV_HESS = dict(rtol=1e-9, atol=1e-11, max_steps=1024)
HESS_SYM_TOL = 1e-6   # max|H − Hᵀ| / max|H|, and Direct vs Gauss
DIRECT_TIMING_ROUNDS = 3


def pde_cost(u, p, t, i):
    """∂/∂u of Σ u(t1)², the PDE's discrete cost at its one data time."""
    return 2.0 * u


def flagship_dense_forward(P, field, u0, p):
    """The PDE's forward with dense output, the solution the direct APIs
    read (the fixed grid of 64 steps, as PDE (d-))."""
    t1 = STEPS * DT
    with torch.no_grad():
        return P.solve(P.ODEProblem(field, u0, (0.0, t1), p), P.Tsit5(),
                       saveat=[0.0, t1], dt=DT, adaptive=False, dense=True)


def direct_pde(P, sol, rule):
    """(du0, dp) of Σ u(t1)² from adjoint_sensitivities under `rule` at
    the solve gradient's reverse tolerances (ADJ)."""
    return P.adjoint_sensitivities(
        sol, t=[STEPS * DT], dgdu_discrete=pde_cost,
        sensealg=getattr(P, rule)(), rtol=ADJ["adj_rtol"],
        atol=ADJ["adj_atol"], max_steps=ADJ["adj_max_steps"])


def adjoint_problem_pde(P, sol):
    """(du0, dp) of the same cost from ODEAdjointProblem's Interpolating
    layout, [λ; q] over the forward's dense output, solved by hand with
    the port's solve at ADJ's tolerances."""
    t1 = STEPS * DT
    spec = P.ODEAdjointProblem(sol, P.InterpolatingAdjoint(), t=[t1],
                               dgdu_discrete=pde_cost)
    with torch.no_grad():
        adj = P.solve(spec.prob, P.Tsit5(), callback=spec.callback,
                      tstops=spec.tstops, saveat=[t1, 0.0],
                      rtol=ADJ["adj_rtol"], atol=ADJ["adj_atol"],
                      max_steps=ADJ["adj_max_steps"])
    check(adj.retcode == 0, f"ODEAdjointProblem's solve retcode {adj.retcode}")
    return spec.extract(adj.u_final)


def direct_dose(P, field, u0, p):
    """(du0, dp) of the dosed PDE's Σ u(t1)² under the Interpolating
    direct API, with the forward's dose callback, at its tolerances."""
    cb = P.PresetTimeCallback([EV_DOSE_T], dose_affect)
    with torch.no_grad():
        sol = P.solve(P.ODEProblem(field, u0, (0.0, EV_T1), p), P.Tsit5(),
                      saveat=[0.0, EV_T1], dt0=DT, callback=cb, dense=True,
                      **EV_TOL[u0.dtype])
    return P.adjoint_sensitivities(sol, t=[EV_T1], dgdu_discrete=pde_cost,
                                   callback=cb, **EV_TOL[u0.dtype])


def direct_spiral(P, setup, with_g):
    """(dp per leaf, solution) of the spiral's Σ(ys − data)² (and, with_g,
    ∫ Σu² dt) under the Gauss direct API at S2's setting."""
    params, _, data, ts = setup
    sol = spiral_solve(P, setup, dict(SPIRAL_ADAPTIVE, dense=True), params)
    _, dp = P.adjoint_sensitivities(
        sol, t=ts, dgdu_discrete=lambda u, p, t, i: 2.0 * (u - data[i]),
        g=(lambda u, p, t: torch.sum(u ** 2)) if with_g else None,
        sensealg=P.GaussAdjoint(), **SPIRAL_ADAPTIVE)
    return dp, sol


def lv_hessian(P, device, sensealg):
    """Lotka–Volterra's Hessian of Σ ys² in p on (0, 1), 4 save times
    (tests/test_interface.py:98-170's setting on (0, 3), cut to a third:
    the Gauss Hessian took 57 s of the command there), in float64."""
    def lv(u, p, t):
        return torch.stack([p[0] * u[0] - p[1] * u[0] * u[1],
                            -p[2] * u[1] + p[3] * u[0] * u[1]])

    prob = P.ODEProblem(lv, torch.tensor([1.0, 1.0], dtype=torch.float64,
                                         device=device), (0.0, 1.0),
                        torch.tensor([1.5, 1.0, 3.0, 1.0],
                                     dtype=torch.float64, device=device))
    return P.second_order_sensitivities(
        lambda sol: torch.sum(sol.ys ** 2), prob, P.Tsit5(),
        sensealg=sensealg, saveat=[0.0, 1.0 / 3, 2.0 / 3, 1.0], **LV_HESS)


# the unrolled continuous rules (phase 5h): the spiral at bench.py:1121-1150's
# setting (gauss_unrolled), the dosed PDE of phase 5f with the scan's
# budget, and GBS as the forward and reverse stepper of the spiral at a
# tolerance where the continuous Backsolve meets the discrete
# ForwardDiffSensitivity (the plain MLP, since the kernels refuse forward
# mode); F1's save-time field u' = −a·u + sin(3t) under DirectAdjoint
UNROLL_SPIRAL = dict(rtol=1e-3, atol=1e-6, max_steps=64)
UNROLL_DOSE_MAX_STEPS = 256
GBS_SPIRAL = dict(rtol=1e-8, atol=1e-10, max_steps=256)
GBS_TOL = 1e-6        # Backsolve (GBS) vs ForwardDiff, per entry / max|leaf|
F1_A, F1_U0, F1_SV = 0.7, 1.3, (0.2, 0.5, 0.9)
F1_TOL = 1e-8         # DirectAdjoint dL/dtᵢ against the closed form

# the stiff arms (phase 5i): Robertson at bench.py:262-285's setting
# (p = [k1, k2 (y2·y3), k3 (y2²)], saves [0, 10, 100], Σ y1², FBDF under
# GaussAdjoint), its oracle ForwardDiffSensitivity on Rosenbrock23 at rtol
# 1e-6 (exact to ~1e-6; at the bench's 1e-4 it is 1.8e-4 off), and
# Rosenbrock23 under InterpolatingAdjoint over the stiff transient (0,
# 1e-2) with tests/test_stiff.py's loss 1e4·Σ y2 in log p (at the bench's
# 1e-3 reverse tolerance Interpolating's uncontrolled q is 60% off);
# tests/test_stiff.py:93's gate; bench.py:318's nonlinear residual
ROB_P, ROB_TS, ROB_T1 = (0.04, 1e4, 3e7), (0.0, 10.0, 100.0), 100.0
ROB_BENCH = dict(rtol=1e-4, atol=1e-8, adj_rtol=1e-3, adj_atol=1e-6,
                 max_steps=2048)
ROB_ORACLE = dict(rtol=1e-6, atol=1e-10, max_steps=4096)
ROB_R23 = dict(rtol=1e-6, atol=1e-10, adj_rtol=1e-5, adj_atol=1e-8,
               max_steps=4096)
ROB_R23_TS, ROB_R23_T1 = (1e-3, 1e-2), 1e-2
STIFF_GATE = dict(rtol=2e-4, atol=1e-8)
# time derivatives through the stiff steppers (phase 5i): DirectAdjoint
# through a saveat tensor with requires_grad on Rosenbrock23 over the
# transient, its gradient in log p and in the two save times
ROB_R23_SV = (1e-3, 5e-3)
NL_H, NL_FD_TOL = 1e-6, 1e-6  # central differences of Σu*², per entry / max


def f1_closed_form(ts):
    """dL/dtᵢ = f(u(tᵢ), tᵢ) of u' = −a·u + sin(3t), u(0) = u0."""
    import math

    a = F1_A
    c = F1_U0 + 3.0 / (a * a + 9.0)
    out = []
    for t in ts:
        u = c * math.exp(-a * t) + (a * math.sin(3 * t)
                                    - 3 * math.cos(3 * t)) / (a * a + 9.0)
        out.append(-a * u + math.sin(3 * t))
    return out


def f1_saveat_gradient(P, device):
    """DirectAdjoint's dL/dtᵢ of Σ ys on F1's save-time case."""
    a = torch.tensor([F1_A], dtype=torch.float64, device=device)
    sv = torch.tensor(F1_SV, dtype=torch.float64, device=device,
                      requires_grad=True)
    prob = P.ODEProblem(
        lambda u, p, t: -p[0] * u + torch.sin(
            3 * torch.as_tensor(t, dtype=u.dtype, device=u.device)),
        torch.tensor([F1_U0], dtype=torch.float64, device=device), (0.0, 1.0),
        a)
    sol = P.solve(prob, P.Tsit5(), saveat=sv, rtol=1e-10, atol=1e-12,
                  sensealg=P.DirectAdjoint(), max_steps=256)
    (g,) = torch.autograd.grad(sol.ys.sum(), sv)
    return g, sol


def rob_field(u, p, t):
    return torch.stack([-p[0] * u[0] + p[1] * u[1] * u[2],
                        p[0] * u[0] - p[1] * u[1] * u[2] - p[2] * u[1] ** 2,
                        p[2] * u[1] ** 2])


def rob_bench(P, device, solver, sensealg, kw, grad=True):
    """Robertson at the bench's setting: (d/dp of Σ y1², solution) or the
    solution."""
    p = torch.tensor(ROB_P, dtype=torch.float64, device=device)
    p.requires_grad_(grad)
    u0 = torch.tensor([1.0, 0.0, 0.0], dtype=torch.float64, device=device)
    with torch.set_grad_enabled(grad):
        sol = P.solve(P.ODEProblem(rob_field, u0, (0.0, ROB_T1), p), solver,
                      saveat=list(ROB_TS), sensealg=sensealg, **kw)
        if not grad:
            return sol
        (g,) = torch.autograd.grad(torch.sum(sol.ys[:, 0] ** 2), p)
    return g, sol


def rob_transient(P, device, sensealg, saveat=ROB_R23_TS, save_grad=False):
    """Rosenbrock23 on Robertson's transient: (d/dlog p of 1e4·Σ y2,
    solution); save_grad: the saves a tensor with requires_grad, and the
    gradient [d/dlog p, d/dsaveat]."""
    logp = torch.log(torch.tensor(ROB_P, dtype=torch.float64, device=device))
    logp.requires_grad_()
    u0 = torch.tensor([1.0, 0.0, 0.0], dtype=torch.float64, device=device)
    sv = (torch.tensor(saveat, dtype=torch.float64, device=device,
                       requires_grad=True) if save_grad else list(saveat))
    sol = P.solve(P.ODEProblem(rob_field, u0, (0.0, ROB_R23_T1),
                               torch.exp(logp)), P.Rosenbrock23(),
                  saveat=sv, sensealg=sensealg, **ROB_R23)
    wrt = (logp, sv) if save_grad else (logp,)
    g = torch.autograd.grad(1e4 * torch.sum(sol.ys[:, 1]), wrt)
    return torch.cat(g), sol


def nl_residual(u, q):
    return torch.tanh(q[:, None] * u[None, :]).sum(0) + u - 1.0


def nl_solve(P, device, p=None, grad=True):
    """bench.py:318's residual (8 unknowns, p of 4): (d/dp of Σu*²,
    solution), or the loss alone for grad=False."""
    if p is None:
        p = torch.linspace(0.1, 0.5, 4, dtype=torch.float64, device=device)
    p = p.detach().clone().requires_grad_(grad)
    u0 = torch.zeros(8, dtype=torch.float64, device=device)
    with torch.set_grad_enabled(grad):
        sol = P.solve_nonlinear(P.NonlinearProblem(nl_residual, u0, p))
        loss = torch.sum(sol.u ** 2)
        if not grad:
            return loss, sol
        (g,) = torch.autograd.grad(loss, p)
    return g, sol


# the DAEs on mass matrices (phase 5j): Robertson in semi-explicit form
# (JAX tests/test_dae.py:18-40, M = diag(1, 1, 0)) with that test's loss
# 1e4·Σ y2 + Σ y3 in log p and u0's differential part, on the span of
# tests/test_torch_dae.py, (0, 1e-3) at rtol 1e-5: on (0, 10) with saves
# [0.1, 1, 10] each reverse takes 186-295 stiff steps of ~0.2 s of host
# time on the CPU run alone (the card run pays it again), which 5j's six
# rules cannot afford; the rotated non-diagonal mass (tests/test_dae.py:
# 240-283); dae_init="newton" on y' = -y, 0 = z - p·y² (closed form);
# the spiral's field under an invertible non-diagonal 2×2 mass (K3/K4)
DAE_P, DAE_ROT_P = (0.04, 3e7, 1e4), (0.04, 1e4, 3e7)
DAE_TS, DAE_T1 = (1e-4, 5e-4, 1e-3), 1e-3
DAE_KW = dict(rtol=1e-5, atol=1e-9, dt0=1e-5, max_steps=200, adj_rtol=1e-5,
              adj_atol=1e-9)
DAE_ROT_T = ((1.0, 0.3), (0.2, 1.0))
DAE_RULE_TOL = 2e-3   # continuous DAE rules vs ForwardDiff (tests/test_dae.py)
DAE_INIT = dict(T=0.2, y0=1.3, p=0.8, rtol=1e-8, atol=1e-10, dt0=1e-3,
                adj_rtol=1e-8, adj_atol=1e-10)
DAE_INIT_TOL = 1e-5   # against the closed form, as tests/test_dae.py
SPIRAL_MASS = ((1.0, 0.2), (-0.1, 1.0))

# the delay equations (phase 5k): u'(t) = mlp2(u(t - τ)) with S4's field
# (B = 1024, 512→2048→512, float32: the simt route), history u0, on [0, 1]
# with τ = 0.25, the RK4 fixed grid at dt = 1/64 and adaptive Tsit5 at rtol
# 1e-6; loss Σ ys[-1]²; the card's float64 at B = 8 against the CPU's;
# tests/test_dde.py's stiff TRBDF2 case u' = -500(u - sin 2πt) + 5u(t - 1)
# at dt 0.02 on (0, 1.2) (tests/test_torch_dde.py's span)
DDE_TAU, DDE_DT, DDE_B_CPU = 0.25, 1.0 / 64, 8
DDE_ADAPTIVE = dict(rtol=1e-6, atol=1e-6)
DDE_CROSS_TOL = 1e-4  # RK4 against Tsit5 at full width (f32), rel L2
DDE_STIFF = dict(A=500.0, B=5.0, dt=0.02, t1=1.2, ref_dt=1e-3)


def dae_rob_field(u, p, t):
    return torch.stack([-p[0] * u[0] + p[2] * u[1] * u[2],
                        p[0] * u[0] - p[1] * u[1] ** 2 - p[2] * u[1] * u[2],
                        u[0] + u[1] + u[2] - 1.0])


def dae_rot_field(u, p, t):
    T = torch.tensor(DAE_ROT_T, dtype=u.dtype, device=u.device)
    f_d = torch.stack([-p[0] * u[0] + p[1] * u[1] * u[2],
                       p[0] * u[0] - p[1] * u[1] * u[2] - p[2] * u[1] ** 2])
    return torch.cat([T @ f_d, (u[0] + u[1] + u[2] - 1.0)[None]])


def dae_crossing(P):
    """tests/test_torch_dae.py's continuous event on the rotated DAE: y1
    falls through 0.99998 near t = 5e-4; the affect keeps the sum."""
    return P.ContinuousCallback(
        condition=lambda u, p, t: u[0] - 0.99998,
        affect=lambda u, p, t: torch.stack([u[0] - 0.001, u[1],
                                            u[2] + 0.001]),
        direction=-1)


def dae_gradient(P, device, sensealg, solver, rotated=False, grad=True,
                 event=False):
    """(d/d[log p, u0_d] of 1e4·Σ y2 + Σ y3 (rotated: Σ y1² + 1e4·Σ y2²
    + Σ y3²), solution) of a Robertson DAE; grad=False: the solution;
    event: with `dae_crossing`."""
    p0 = DAE_ROT_P if rotated else DAE_P
    logp = torch.log(torch.tensor(p0, dtype=torch.float64, device=device))
    u0d = torch.tensor([1.0, 0.0], dtype=torch.float64, device=device)
    logp.requires_grad_()
    u0d.requires_grad_()
    u0 = torch.stack([u0d[0], u0d[1], 1.0 - u0d[0] - u0d[1]])
    if rotated:
        mass = torch.zeros(3, 3, dtype=torch.float64)
        mass[:2, :2] = torch.tensor(DAE_ROT_T, dtype=torch.float64)
        field = dae_rot_field
    else:
        mass, field = torch.diag(torch.tensor([1.0, 1.0, 0.0])), dae_rob_field
    prob = P.ODEProblem(field, u0, (0.0, DAE_T1), torch.exp(logp),
                        mass_matrix=mass)
    with torch.set_grad_enabled(grad):
        sol = P.solve(prob, solver, saveat=list(DAE_TS), sensealg=sensealg,
                      callback=dae_crossing(P) if event else None, **DAE_KW)
    if not grad:
        return sol
    ys = sol.ys
    if rotated:
        loss = (torch.sum(ys[:, 0] ** 2) + 1e4 * torch.sum(ys[:, 1] ** 2)
                + torch.sum(ys[:, 2] ** 2))
    else:
        loss = 1e4 * torch.sum(ys[:, 1]) + torch.sum(ys[:, 2])
    return torch.cat(torch.autograd.grad(loss, (logp, u0d))), sol


def dae_init_gradient(P, device):
    """dae_init="newton" on y' = -y, 0 = z - p·y² from the guess z0 = 0:
    (d/d[y0, p] of y(T) + z(T) under ForwardDiffSensitivity, solution)."""
    c = DAE_INIT
    a = torch.tensor([c["y0"], c["p"]], dtype=torch.float64, device=device)
    a.requires_grad_()
    prob = P.ODEProblem(
        lambda u, p, t: torch.stack([-u[0], u[1] - p[0] * u[0] ** 2]),
        torch.stack([a[0], 0.0 * a[0]]), (0.0, c["T"]), a[1:],
        mass_matrix=torch.diag(torch.tensor([1.0, 0.0])))
    sol = P.solve(prob, P.SDIRK4(), saveat=[c["T"]], dae_init="newton",
                  sensealg=P.ForwardDiffSensitivity(),
                  **{k: c[k] for k in ("rtol", "atol", "dt0", "adj_rtol",
                                       "adj_atol")})
    (g,) = torch.autograd.grad(sol.ys[0, 0] + sol.ys[0, 1], a)
    return g, sol


def dae_init_exact():
    import math

    c = DAE_INIT
    e = math.exp(-c["T"])
    return [e + 2 * c["p"] * c["y0"] * e * e, c["y0"] ** 2 * e * e]


def spiral_mass_kw(P, kw):
    """S2's setting with the spiral's field under SPIRAL_MASS."""
    return dict(kw, mass=torch.tensor(SPIRAL_MASS, dtype=torch.float64))


def spiral_mass_gradient(P, setup, kw, grad=True):
    """(d/dp of Σ(ys - data)² per leaf, solution) of M u' = MLP(u³);
    grad=False: the solution."""
    from scimlsensitivity_jl_tpu_torch.ops.mlp import fused_mlp2

    params = {k: v.detach().clone().requires_grad_(grad)
              for k, v in setup[0].items()}
    _, u0, data, ts = setup
    kw = dict(kw)
    mass = kw.pop("mass")
    prob = P.ODEProblem(lambda u, p, t: fused_mlp2(p, u ** 3), u0,
                        (0.0, SPIRAL_T1), params, mass_matrix=mass)
    with torch.set_grad_enabled(grad):
        sol = P.solve(prob, P.Tsit5(), saveat=ts, **kw)
    if not grad:
        return sol
    grads = torch.autograd.grad(torch.sum((sol.ys - data) ** 2),
                                list(params.values()))
    return dict(zip(params, grads)), sol


def dde_setup(P, dtype, device, B=S4_B):
    """S4's seeded weights and u0 (s4_setup) for the delayed field."""
    params, u0, _ = s4_setup(P, dtype, device, B=B)
    return params, u0


def dde_solve(P, setup, params, adaptive):
    from scimlsensitivity_jl_tpu_torch.ops.mlp import fused_mlp2

    _, u0 = setup
    prob = P.DDEProblem(lambda u, h, p, t: fused_mlp2(p, h[0]), u0,
                        (0.0, 1.0), params, lags=(DDE_TAU,))
    kw = DDE_ADAPTIVE if adaptive else dict(dt=DDE_DT)
    return P.solve(prob, saveat=[0.0, 1.0], **kw)


def dde_gradient(P, setup, adaptive):
    """(d/dp of Σ ys[-1].float()² per leaf, solution) of the delayed S4
    field."""
    params = {k: v.detach().clone().requires_grad_()
              for k, v in setup[0].items()}
    sol = dde_solve(P, setup, params, adaptive)
    grads = torch.autograd.grad(torch.sum(sol.ys[-1].float() ** 2),
                                list(params.values()))
    return dict(zip(params, grads)), sol


def dde_forward(P, setup, adaptive):
    with torch.no_grad():
        return dde_solve(P, setup, setup[0], adaptive).ys[-1]


def dde_stiff(P, device, trbdf2):
    """tests/test_dde.py's stiff case at DDE_STIFF: u(t1), solution."""
    import math

    c = DDE_STIFF

    def rhs(u, h, p, t):
        return -c["A"] * (u - math.sin(2.0 * math.pi * float(t))) \
            + c["B"] * h[0]

    prob = P.DDEProblem(rhs, torch.ones(1, dtype=torch.float64, device=device),
                        (0.0, c["t1"]), None, lags=(1.0,))
    if trbdf2:
        sol = P.solve(prob, P.TRBDF2(), dt=c["dt"])
    else:
        sol = P.solve(prob, dt=c["ref_dt"])
    return sol.ys[-1, 0], sol


# the SDE arms (phases 5l, 5m and 6k): the neural SDE at S4's width
# (models/neural_ode.py:neural_sde's form with both MLPs through K3/K4:
# drift mlp2(θ_f, u), diagonal diffusion SDE_SIGMA·softplus(mlp2(θ_g, u)),
# B = 1024, 512→2048→512, float32, the simt route), EulerMaruyama at
# dt = 1/64 on [0, 1], loss Σ ys[-1]²; the stochastic Fisher–KPP field
# (the flagship field as drift, diagonal noise FK_NOISE·u, EulerMaruyama,
# 64 steps of 1e-9) and its RODE form f = rd1d(u) + FK_NOISE·u·W(t)
# (RandomEM); each under sensealg=None (DirectAdjoint) and the stored-node
# and reconstructed-node rules; the adaptive arm on the Brownian tree with
# a plain Fisher–KPP field on FK_ADAPTIVE_N cells, near-deterministic noise
# (the realised grid amplifies a last-bit difference ~10^3-fold per step
# at strong noise, so two devices agree step for step only where the
# drift's curvature sets the error)
SDE_DT, SDE_SIGMA, SDE_B_CPU = 1.0 / 64, 0.1, 8
SDE_RULES = ("DirectAdjoint", "InterpolatingAdjoint", "BacksolveAdjoint")
# the JAX package's tests/test_sde.py:test_sde_backsolve_adjoint_close
SDE_BACKSOLVE_TOL = 2e-2
# Interpolating against Direct: the same products in another order (the
# JAX test asserts 1e-10 in float64); float32 sums over 2048 terms
SDE_INTERP_TOL = {torch.float64: 1e-10, torch.float32: 1e-4}
FK_NOISE = 0.5
FK_ADAPTIVE_N, FK_ADAPTIVE_SIGMA = 8, 1e-3
FK_ADAPTIVE = dict(rtol=1e-5, atol=1e-8, max_steps=1024)
# the adaptive arm's card against CPU, a smoke test of the device path and
# not a precision check: the error norm's reduction rounds differently on
# the two, and the realised grid carries that difference into every later
# step size (6.6e-6 in the first chip run)
FK_ADAPTIVE_DEVICE_TOL = 1e-4
# the adaptive arm at the fixed-grid arms' noise (FK_NOISE), on the card
# alone: its rules against each other on one realised grid (210 steps)
FK_ADAPTIVE_NOISY = dict(rtol=1e-3, atol=1e-6, max_steps=1024)


def nsde_setup(P, dtype, device, B=S4_B):
    """Seeded drift and diffusion weights at S4's width, u0 = 0.1·randn."""
    gen = torch.Generator().manual_seed(SEED)
    params = {"drift": P.mlp_init(gen, S4_WIDTHS, dtype, device=device),
              "diffusion": P.mlp_init(gen, S4_WIDTHS, dtype, device=device)}
    u0 = 0.1 * torch.randn((B, S4_WIDTHS[0]), generator=gen)
    return params, u0.to(device=device, dtype=dtype)


def nsde_solve(P, setup, params, sensealg, key, solver=None, **kw):
    from scimlsensitivity_jl_tpu_torch.ops.mlp import fused_mlp2

    prob = P.SDEProblem(
        lambda u, p, t: fused_mlp2(p["drift"], u),
        lambda u, p, t: SDE_SIGMA * torch.nn.functional.softplus(
            fused_mlp2(p["diffusion"], u)),
        setup[1], (0.0, 1.0), params)
    if solver is None:
        solver = P.EulerMaruyama()
    kw = kw or dict(dt=SDE_DT)
    return P.solve(prob, solver, saveat=[0.0, 1.0], sensealg=sensealg,
                   key=key, **kw)


def nsde_gradient(P, setup, sensealg, key):
    """(d/dθ of Σ ys[-1].float()² per leaf, solution)."""
    params = {k: {kk: v.detach().clone().requires_grad_()
                  for kk, v in d.items()} for k, d in setup[0].items()}
    sol = nsde_solve(P, setup, params, sensealg, key)
    names = [(k, kk) for k in params for kk in params[k]]
    grads = torch.autograd.grad(torch.sum(sol.ys[-1].float() ** 2),
                                [params[k][kk] for k, kk in names])
    return {f"{k}.{kk}": g for (k, kk), g in zip(names, grads)}, sol


def nsde_forward(P, setup, key):
    with torch.no_grad():
        return nsde_solve(P, setup, setup[0], None, key).ys[-1]


def fk_solve(P, field, u0, p, sensealg, key, rode=False):
    t1 = STEPS * DT
    if rode:
        prob = P.RODEProblem(
            lambda u, q, t, W: field(u, q, t) + FK_NOISE * u * W, u0,
            (0.0, t1), p)
        return P.solve(prob, dt=DT, saveat=[0.0, t1], sensealg=sensealg,
                       key=key)
    prob = P.SDEProblem(field, lambda u, q, t: FK_NOISE * u, u0, (0.0, t1), p)
    return P.solve(prob, P.EulerMaruyama(), dt=DT, saveat=[0.0, t1],
                   sensealg=sensealg, key=key)


def fk_gradient(P, field, u0, p, sensealg, key, rode=False):
    """(u0-grad, p-grad, solution) of Σ ys[-1]²."""
    uu = u0.clone().requires_grad_()
    pp = p.clone().requires_grad_()
    sol = fk_solve(P, field, uu, pp, sensealg, key, rode)
    gu, gp = torch.autograd.grad(torch.sum(sol.ys[-1] ** 2), (uu, pp))
    return gu, gp, sol


def fk_forward(P, field, u0, p, key, rode=False):
    with torch.no_grad():
        return fk_solve(P, field, u0, p, None, key, rode).ys[-1]


def fk_plain_field(u, p, t):
    """The Fisher–KPP field in tensor operations on FK_ADAPTIVE_N periodic
    cells of width 1/FK_ADAPTIVE_N."""
    lap = torch.roll(u, 1) - 2.0 * u + torch.roll(u, -1)
    return p[0] * FK_ADAPTIVE_N ** 2 * lap + p[1] * u * (1.0 - u)


def fk_adaptive_gradient(P, device, sensealg, grad=True,
                         sigma=FK_ADAPTIVE_SIGMA, tols=FK_ADAPTIVE):
    x = torch.arange(FK_ADAPTIVE_N, dtype=torch.float64,
                     device=device) / FK_ADAPTIVE_N
    u0 = (0.2 + 0.6 * torch.exp(-((x - 0.5) ** 2) * 10.0)).requires_grad_()
    p = torch.tensor([1e-2, 1.5], dtype=torch.float64,
                     device=device).requires_grad_()
    prob = P.SDEProblem(fk_plain_field, lambda u, q, t: sigma * u, u0,
                        (0.0, 1.0), p)
    with torch.set_grad_enabled(grad):
        sol = P.solve(prob, saveat=[0.0, 0.5, 1.0], sensealg=sensealg,
                      key=P.NumpyKey(SEED), **tols)
    if not grad:
        return sol
    gu, gp = torch.autograd.grad(torch.sum(sol.ys ** 2), (u0, p))
    return gu, gp, sol


# the shadowing arms (phase 5n): (a) Lorenz at ρ = 28 (d⟨z⟩/dρ ≈ 1.01) in
# float64 at the settings of the JAX package's tests/test_shadowing.py:
# ForwardLSS (Cos) and AdjointLSS (TimeDilation 10) on the 1001-row
# attractor on (30, 40), NILSS (nseg 30, nstep 101) and NILSAS (M 2) on
# (30, 60), and NILSAS segment_parallel, on the card; NILSS and NILSAS
# on (30, 31.5) on the card and the CPU; (b) the NILSS of bench.py:358-398
# (lorenz_nilss) in float32, timed; these are host-paced (~1-3 ms of host
# time per evaluation of their tangent or adjoint fields, 10^4-10^5 of
# them), so they run in processes of their own (`--background`) beside
# phases 3-5m, which take no timing; (c) NILSAS through K3/K4 at S4's
# width; (d) the refusals on that field
LORENZ_U0 = (-2.259143724332269, -2.47457604992522, 18.939914218990612)
LORENZ_TS = [30.0 + 0.01 * i for i in range(1001)]
# the JAX tests' tolerances around 1.01 (test_shadowing.py)
SHADOW_ATOL = {"LSS": 0.12, "NIL": 0.25}
# card against CPU: LSS takes one trajectory on both (the same arithmetic
# but for the order of sums; 1.8e-11 in the first chip run). NILSS and
# NILSAS solve their own trajectories, whose adaptive steps part on a
# last-bit difference (a step accepted on one device, rejected on the
# other): over JAX's 30 time units the two are different shadowing
# estimates (NILSS 4.965e-3 apart in the first chip run, past its 1e-3
# gate), so card against CPU runs on (30, 31.5) in 3 segments, where a
# parted step moves the result by ~rtol times the growth e^(0.9·1.5);
# the (30, 60) arms run on the card, held to 1.01
SHADOW_DEVICE_TOL = {"LSS": 1e-10, "NIL": 1e-6}
SHADOW_SHORT = dict(tspan=(30.0, 31.5), nseg=3, nstep=26)
SHADOW_LONG = dict(tspan=(30.0, 60.0), nseg=30, nstep=101)
# NILSAS segment_parallel against sequential (the rtol of the JAX package's
# tests/test_parallel.py:132 for two executions of one algorithm)
NILSAS_PAR_RTOL = 1e-6
LORENZ_BENCH = dict(nseg=10, nstep=100)  # bench.py:bench_nilss
NILSAS_S4 = dict(nseg=4, nstep=17, M=2)
NILSAS_S4_TOLS = dict(rtol=1e-5, atol=1e-7, adj_rtol=1e-5, adj_atol=1e-7)
NILSAS_S4_B_CPU = 8
# the ensembles (phase 5o): the spiral through K3/K4, u0 scaled by
# 1 + i/ENS_TRAJ (bench.py:179-197), GaussAdjoint, float32; the bench's 256
# trajectories cut to 16 for time
ENS_TRAJ = 16
# digits and entry points (phase 5p): bench.py:1238-1305's widths (64→32
# encoder, 32→64→32 field, 10-way head), Adam(3e-3)
DIGITS_B, DIGITS_B_CPU = 32, 4


def lorenz_field(u, p, t):
    return torch.stack([10.0 * (u[1] - u[0]), u[0] * (p[0] - u[2]) - u[1],
                        u[0] * u[1] - (8.0 / 3.0) * u[2]])


def lorenz_g(u, p, t):
    return u[2]


def lorenz_prob(P, device, tspan, u0=LORENZ_U0, dtype=torch.float64):
    return P.ODEProblem(lorenz_field,
                        torch.tensor(u0, dtype=dtype, device=device), tspan,
                        torch.tensor([28.0], dtype=dtype, device=device))


def nilsas_s4_solve(P, setup, params, **kw):
    from scimlsensitivity_jl_tpu_torch.ops.mlp import fused_mlp2

    _, u0, _ = setup
    prob = P.ODEProblem(lambda u, p, t: fused_mlp2(p, u), u0, (0.0, 1.0),
                        params)
    return P.solve(prob, P.Tsit5(), saveat=torch.linspace(0.0, 1.0, 17),
                   sensealg=P.NILSAS(**NILSAS_S4), **NILSAS_S4_TOLS, **kw)


def nilsas_s4_gradient(P, setup):
    """(d/dθ of Σ over the save rows of mean(u²) per leaf, solution)."""
    params = {k: v.detach().clone().requires_grad_()
              for k, v in setup[0].items()}
    sol = nilsas_s4_solve(P, setup, params)
    loss = torch.sum(torch.mean(sol.ys.float() ** 2, dim=(1, 2)))
    grads = torch.autograd.grad(loss, list(params.values()))
    return dict(zip(params, grads)), sol


def nilsas_s4_forward(P, setup):
    with torch.no_grad():
        return nilsas_s4_solve(P, setup, setup[0])


def lorenz_bench_nilss(P, device, segment_parallel, tspan=(0.0, 20.0),
                       nseg=LORENZ_BENCH["nseg"], record=None):
    prob = lorenz_prob(P, device, tspan, u0=(1.0, 1.0, 25.0),
                       dtype=torch.float32)
    return P.shadow_forward(
        P.NILSSProblem(prob, P.NILSS(nseg=nseg, nstep=LORENZ_BENCH["nstep"]),
                       g=lorenz_g),
        rtol=1e-6, atol=1e-8, segment_parallel=segment_parallel,
        record=record)


def digits_setup(P, dtype, device, batch):
    """The digits batch (synthetic_digits, seeded) and weights."""
    from scimlsensitivity_jl_tpu_torch.models import digits

    x, y = digits.synthetic_digits(torch.Generator().manual_seed(SEED),
                                   n=batch, dtype=dtype, device=device)
    params = digits.digits_node_init(torch.Generator().manual_seed(SEED + 1),
                                     dtype=dtype, device=device)
    return params, x, y


def digits_gradient(P, setup):
    """(loss, d loss/dθ per leaf) of the digits cross-entropy."""
    from scimlsensitivity_jl_tpu_torch.models import digits

    params = {k: {kk: v.detach().clone().requires_grad_()
                  for kk, v in d.items()} for k, d in setup[0].items()}
    _, loss_fn = digits.make_digits_train_step(None)
    loss = loss_fn(params, setup[1], setup[2])
    names = [(k, kk) for k in params for kk in params[k]]
    grads = torch.autograd.grad(loss, [params[k][kk] for k, kk in names])
    return loss.detach(), {f"{k}.{kk}": g for (k, kk), g in zip(names, grads)}


def spiral_ensemble(P, setup):
    """The spiral's GaussAdjoint ensemble of ENS_TRAJ trajectories (u0
    scaled by 1 + i/ENS_TRAJ), backend "vmap": (d/dθ of Σ(ys − data)² per
    leaf, the stacked solution)."""
    from scimlsensitivity_jl_tpu_torch.ops.mlp import fused_mlp2

    params = {k: v.detach().clone().requires_grad_()
              for k, v in setup[0].items()}
    _, u0, data, ts = setup
    prob = P.ODEProblem(lambda u, p, t: fused_mlp2(p, u ** 3), u0,
                        (0.0, SPIRAL_T1), params)
    ens = P.EnsembleProblem(prob, prob_func=lambda pr, i: P.remake(
        pr, u0=pr.u0 * (1.0 + i / ENS_TRAJ)))
    sols = P.solve_ensemble(ens, P.Tsit5(), trajectories=ENS_TRAJ,
                            saveat=ts, sensealg=P.GaussAdjoint(),
                            **SPIRAL_ADAPTIVE)
    grads = torch.autograd.grad(torch.sum((sols.ys - data) ** 2),
                                list(params.values()))
    return dict(zip(params, grads)), sols


def lss_arm(P, device):
    """ForwardLSS (Cos) and AdjointLSS (TimeDilation 10) on the attractor,
    solved on the CPU (the same bits in every process), then handed to the
    device."""
    sol = P.solve(lorenz_prob(P, "cpu", (30.0, 40.0)), P.Tsit5(),
                  saveat=LORENZ_TS, rtol=1e-11, atol=1e-13, max_steps=16384)
    sol = P.ODESolution(ts=sol.ts, ys=sol.ys.to(device), stats=sol.stats,
                        retcode=sol.retcode,
                        prob=lorenz_prob(P, device, (30.0, 40.0)))
    fwd = P.shadow_forward(P.ForwardLSSProblem(sol, P.ForwardLSS(
        LSSregularizer=P.CosWindowing(), g=lorenz_g)))
    adj = P.shadow_adjoint(P.AdjointLSSProblem(sol, P.AdjointLSS(
        LSSregularizer=P.TimeDilation(10.0), g=lorenz_g)))
    return {"ForwardLSS Cos": float(fwd[0]),
            "AdjointLSS TimeDilation 10": float(adj[0])}


def nilss_arm(P, device, tspan, nseg, nstep):
    from scimlsensitivity_jl_tpu_torch.adjoints.continuous import AdjointRecord

    rec = AdjointRecord()
    res = P.shadow_forward(
        P.NILSSProblem(lorenz_prob(P, device, tspan),
                       P.NILSS(nseg=nseg, nstep=nstep), g=lorenz_g),
        rtol=1e-8, atol=1e-10, record=rec)
    return {"value": float(res[0]), "stats": tuple(rec.stats)}


def nilsas_arm(P, device, tspan, nseg, nstep, segment_parallel=False):
    from scimlsensitivity_jl_tpu_torch.adjoints.continuous import AdjointRecord

    rec = AdjointRecord()
    res = P.nilsas_shadow_adjoint(
        P.NILSASProblem(lorenz_prob(P, device, tspan),
                        P.NILSAS(nseg=nseg, nstep=nstep, M=2), g=lorenz_g),
        fwd_rtol=1e-10, max_steps=32768, record=rec,
        segment_parallel=segment_parallel)
    return {"value": float(res[0]), "stats": tuple(rec.stats),
            "primal": tuple(rec.primal)}


def bench_arm(P, device, segment_parallel):
    """bench.py's lorenz_nilss, timed (CUDA events around one run), with
    its solves' summed step counts."""
    from scimlsensitivity_jl_tpu_torch.adjoints.continuous import AdjointRecord

    rec = AdjointRecord()
    res, ms = event_ms(lambda: lorenz_bench_nilss(P, device, segment_parallel,
                                                  record=rec))
    return {"value": float(res[0]), "ms": ms, "stats": tuple(rec.stats)}


def nilsas_s4_cpu_arm(P, device):
    g, _ = nilsas_s4_gradient(P, s4_setup(P, torch.float64, device,
                                          B=NILSAS_S4_B_CPU))
    return {k: v.cpu() for k, v in g.items()}


def digits_cpu_arm(P, device):
    loss, g = digits_gradient(P, digits_setup(P, torch.float64, device,
                                              DIGITS_B_CPU))
    return {"loss": float(loss), **{k: v.cpu() for k, v in g.items()}}


# the background arms: name -> fn(P, device) -> dict of floats or CPU tensors
SHADOW_ARMS = {
    "LSS": lss_arm,
    "NILSS short": lambda P, d: nilss_arm(P, d, **SHADOW_SHORT),
    "NILSAS short": lambda P, d: nilsas_arm(P, d, **SHADOW_SHORT),
    "NILSS": lambda P, d: nilss_arm(P, d, **SHADOW_LONG),
    "NILSAS": lambda P, d: nilsas_arm(P, d, **SHADOW_LONG),
    "NILSAS segment_parallel": lambda P, d: nilsas_arm(
        P, d, segment_parallel=True, **SHADOW_LONG),
    "bench NILSS sequential": lambda P, d: bench_arm(P, d, False),
    "bench NILSS segment_parallel": lambda P, d: bench_arm(P, d, True),
    "NILSAS S4 f64": nilsas_s4_cpu_arm,
    "digits f64": digits_cpu_arm,
}
# process -> (device, arms). The card's arms take ~900 s of host time
# together (~230 s NILSS and ~200-225 s each NILSAS on (30, 60), ~200 s
# the bench pair), ~300 s in each of three processes, so that all end
# within phases 3-5m (~420 s)
BACKGROUND = {
    "card-nilss": ("cuda", ("NILSS", "bench NILSS segment_parallel")),
    "card-nilsas": ("cuda", ("NILSAS", "bench NILSS sequential")),
    "card-nilsas-parallel": ("cuda", ("NILSAS segment_parallel", "LSS",
                                      "NILSS short", "NILSAS short")),
    "cpu": ("cpu", ("LSS", "NILSS short", "NILSAS short", "NILSAS S4 f64",
                    "digits f64")),
}


def run_background(group: str, path: str) -> int:
    """`chip_smoke.py --background GROUP PATH`: the arms of BACKGROUND[GROUP]
    on its device, each result with its seconds, saved to PATH
    (torch.save; read back by the run that started this process)."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import scimlsensitivity_jl_tpu_torch as P

    device, arms = BACKGROUND[group]
    # the card's arms are host-paced Python; the CPU's S4-width NILSAS
    # takes a second thread
    torch.set_num_threads(1 if device == "cuda" else 2)
    torch.backends.cuda.matmul.allow_tf32 = False
    results = {}
    for arm in arms:
        t = time.perf_counter()
        results[arm] = SHADOW_ARMS[arm](P, device)
        if device == "cuda":
            torch.cuda.synchronize()
        results[arm]["seconds"] = time.perf_counter() - t
        print(f"[background {group}] {arm}: {time.perf_counter() - t:.1f} s",
              flush=True)
    torch.save(results, path)
    return 0


class Background:
    """The BACKGROUND processes of one run: started together, joined at
    phase 5n, killed at exit if still running."""

    def __init__(self, workdir: str):
        self.workdir, self.procs = workdir, {}
        for group in BACKGROUND:
            with open(os.path.join(workdir, f"{group}.log"), "w") as log:
                self.procs[group] = subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__),
                     "--background", group,
                     os.path.join(workdir, f"{group}.pt")],
                    stdout=log, stderr=subprocess.STDOUT)

    def results(self, timeout: float) -> dict:
        """{arm: results} per device ("cuda", "cpu"), waiting at most
        `timeout` seconds in all; a failed or late process fails the run
        with its log."""
        deadline = time.perf_counter() + timeout
        out = {"cuda": {}, "cpu": {}}
        for group, proc in self.procs.items():
            try:
                rc = proc.wait(max(deadline - time.perf_counter(), 1.0))
            except subprocess.TimeoutExpired:
                rc = None
            with open(os.path.join(self.workdir, f"{group}.log")) as log:
                text = log.read()
            print(f"[shadow] background {group}: exit {rc}; "
                  + " | ".join(line for line in text.splitlines()
                               if line.startswith("[background")))
            check(rc == 0, f"background {group} failed or ran late: "
                  f"{text[-3000:]}")
            out[BACKGROUND[group][0]].update(torch.load(
                os.path.join(self.workdir, f"{group}.pt"), weights_only=True))
        return out

    def stop(self):
        for proc in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(self.workdir, ignore_errors=True)


# the sharded flagship (phase 5q): two ranks on the one card, over gloo,
# which takes all_gather on CUDA tensors (it stages them through host
# memory) but not send / recv; (dtype, n) and the arms
SHARD_CASES = ((torch.float32, 1048576), (torch.float64, 262144))
SHARD_ARMS = ("None", "DirectAdjoint", "InterpolatingAdjoint")
SHARD_F64_TOL = 1e-10  # sharded vs unsharded card f64, relative L2
SHARD_TIMEOUT = 420.0
# the RK4 block split over the ranks: (dtype, n), MEGA_S steps per block,
# SHARD_MEGA_BLOCKS blocks chained, the step h set so that
# h·D·inv_dx2 = SHARD_MEGA_HDC (at MEGA_H's 1.1e-4 a step moves the cells
# beside the cut by less than float32 resolves, so a cut exchange would
# not show in float32); u0-grad the unsharded run's bits, p's within
# SHARD_MEGA_F64_TOL (float64: the ranks' partial sums add in another
# order) or phase 5's float32 gate
SHARD_MEGA = ((torch.float32, 1048576), (torch.float64, 262144))
SHARD_MEGA_BLOCKS = 4
SHARD_MEGA_HDC = 0.1
SHARD_MEGA_F64_TOL = 1e-12
# S4's field on a batch split by rows: (label, dtype, B, steps), float32 at
# full size against the unsharded card run and float64 at B = 8 against
# the CPU, under each of SHARD_S4_ARMS (sensealg=None: the fixed grid's
# discrete path), the reverse at SHARD_S4_ADJ's tolerances
SHARD_S4_SETS = (("S4", torch.float32, S4_B, S4_STEPS),
                 ("B8", torch.float64, 8, 4))
SHARD_S4_ARMS = ("None", "InterpolatingAdjoint")
SHARD_S4_ADJ = dict(adj_rtol=1e-3, adj_atol=1e-6)


# K1/K2 with a shard's ghost cells (phase 3): (n, u's offset, λ's offset)
# at each [shard] case's n/2, a ragged n, a tail alone, and off 16 bytes
RD1D_GHOST_CASES = [(524288, 0, 0), (131072, 0, 0), (262147, 0, 0),
                    (5, 0, 0), (131072, 1, 1), (131072, 0, 1)]


def check_ghosted_kernels(rd1d, dev):
    """K1/K2 given a shard's ghost cells against the plain versions with
    the same ghosts; returns the largest K1 and K2 errors in float32 at the
    [shard] float32 case's n/2."""
    out = {}
    for dtype in (torch.float64, torch.float32):
        for n, u_off, lam_off in RD1D_GHOST_CASES:
            u, lam = rd1d_case(n, u_off, lam_off, dtype, dev)
            p = torch.tensor(P_FLAGSHIP, device=dev, dtype=dtype)
            gen = torch.Generator(device=dev).manual_seed(SEED + n)
            ghosts = torch.rand(4, generator=gen, device=dev, dtype=dtype)
            inv_dx2 = float(n) * float(n)
            f = rd1d.rd1d_fwd_cuda(u, p, inv_dx2, ghosts[:2].contiguous())
            du, dp = rd1d.rd1d_vjp_cuda(u, p, inv_dx2, lam, ghosts)
            f0 = rd1d.rd1d_fwd_cuda(u, p, inv_dx2)
            torch.cuda.synchronize()
            f_ref = rd1d.rd1d_reference(u, p, inv_dx2, ghosts[:2])
            du_ref, _ = rd1d.rd1d_vjp_reference(u, p, inv_dx2, lam, ghosts)
            _, dp_ref = rd1d.rd1d_vjp_reference(u.double(), p.double(),
                                                inv_dx2, lam.double(),
                                                ghosts.double())
            e_f = float((f - f_ref).abs().max() / f_ref.abs().max())
            e_du = float((du - du_ref).abs().max() / du_ref.abs().max())
            diff = (dp.double() - dp_ref).abs()
            e_dp = torch.where(dp_ref != 0, diff / dp_ref.abs(), diff).tolist()
            # the ghosts move only the two end cells (for n > 2)
            inner = (n <= 2 or torch.equal(f[1:-1], f0[1:-1]))
            print(f"[kernels] {str(dtype)[6:]} n={n} (u at +{u_off}, λ at "
                  f"+{lam_off}) with a shard's ghosts: K1 max|f-f_ref|/max|f|"
                  f"={e_f:.3e}, K2 max|ū-ū_ref|/max|ū|={e_du:.3e} (tol "
                  f"{K_TOL[dtype]:g}), D̄ rel {e_dp[0]:.3e}, k̄ rel "
                  f"{e_dp[1]:.3e} (tol {KP_TOL[dtype]:g}); interior cells "
                  f"the edge-copy launch's bits: {inner}")
            check(e_f <= K_TOL[dtype] and e_du <= K_TOL[dtype]
                  and max(e_dp) <= KP_TOL[dtype] and inner,
                  f"K1/K2 with ghosts disagree at n={n}")
            if dtype == torch.float32 and n == 524288:
                out = {"K1": float((f - f_ref).abs().max()),
                       "K2": float((du - du_ref).abs().max())}
    return out


# K5/K6 with a shard's ghost cells (phase 3): (n, S, chunk, bwd_chunk) of one
# rank's cells, the [shard] float32 block's n/2 and a ragged geometry with
# a neighbour on each side or on one, and a one-tile shard (its halo still
# read); the pieces check: (n, world) split on tile ends
RK4_GHOST_GEOMS = ((524288, 16, 4096, 1024), (5000, 7, 1000, 500),
                   (1000, 4, 1000, 1000))
RK4_GHOST_SIDES = ((True, True), (True, False), (False, True))
RK4_PIECES = (262144, 4)


def check_ghosted_rk4(rd1d, dev):
    """K5/K6 given a shard's 4(S+1) ghost cells per side against the
    ghosted plain versions on the same inputs (the scan and the reverse
    sweep over the shard widened by its ghosts); and the whole grid with a
    null buffer against its pieces with ghosts, split on tile ends, bit for
    bit. Returns the largest K5 and K6 errors in float32 at the [shard]
    block's n/2."""
    out = {}
    for dtype in (torch.float64, torch.float32):
        for n, S, chunk, bwd_chunk in RK4_GHOST_GEOMS:
            H = 4 * (S + 1)
            u, lam, p, inv_dx2, h = rk4_check_inputs(n, dtype, dev)
            gen = torch.Generator(device=dev).manual_seed(SEED + n)
            ghosts = torch.rand(4 * H, generator=gen, device=dev,
                                dtype=dtype)
            for sides in RK4_GHOST_SIDES:
                y = rd1d.rd1d_rk4_fwd_cuda(u, p, inv_dx2, h, S, chunk,
                                           ghosts[:2 * H].contiguous(),
                                           *sides)
                du, dp = rd1d.rd1d_rk4_vjp_cuda(u, p, inv_dx2, h, S,
                                                bwd_chunk, lam, ghosts,
                                                *sides)
                torch.cuda.synchronize()
                y_ref = rd1d.rd1d_rk4_scan_shard_reference(
                    u, p, inv_dx2, h, S, ghosts[:2 * H], *sides)
                du_ref, dp_ref = rd1d.rd1d_rk4_block_vjp_shard_reference(
                    u, p, inv_dx2, h, S, lam, ghosts, *sides)
                e_y = float((y - y_ref).abs().max() / y_ref.abs().max())
                e_du = float((du - du_ref).abs().max() / du_ref.abs().max())
                e_dp = ((dp - dp_ref).abs() / dp_ref.abs()).tolist()
                print(f"[kernels] {str(dtype)[6:]} shard (n, S, chunk, "
                      f"bwd_chunk) = {(n, S, chunk, bwd_chunk)}, neighbours "
                      f"(left, right) {sides}, {H} ghost cells per side: K5 "
                      f"max|u-u_ref|/max|u|={e_y:.3e}, K6 max|ū-ū_ref|/max|ū|"
                      f"={e_du:.3e} (tol {K_TOL[dtype]:g}), D̄ rel "
                      f"{e_dp[0]:.3e}, k̄ rel {e_dp[1]:.3e} (tol "
                      f"{KP_TOL[dtype]:g}) against the ghosted plain versions")
                check(e_y <= K_TOL[dtype] and e_du <= K_TOL[dtype]
                      and max(e_dp) <= KP_TOL[dtype],
                      f"K5/K6 with ghosts disagree at {(n, S, sides)}")
                if (dtype == torch.float32 and n == RK4_GHOST_GEOMS[0][0]
                        and sides == (True, False)):
                    out = {"K5": float((y - y_ref).abs().max()),
                           "K6": float((du - du_ref).abs().max())}
                del y, du, y_ref, du_ref
        # a null buffer over the whole grid against the pieces with ghosts
        n, world = RK4_PIECES
        _, S, chunk, bwd_chunk = RK4_GHOST_GEOMS[0]
        H, m = 4 * (S + 1), n // world
        u, lam, p, inv_dx2, h = rk4_check_inputs(n, dtype, dev)
        y = rd1d.rd1d_rk4_fwd_cuda(u, p, inv_dx2, h, S, chunk)
        du, dp = rd1d.rd1d_rk4_vjp_cuda(u, p, inv_dx2, h, S, bwd_chunk, lam)
        ys, dus, dps = [], [], []
        for r in range(world):
            a, b = r * m, (r + 1) * m
            sides = (r > 0, r + 1 < world)

            def ghosts_of(x):
                return torch.cat([x[a - H:a] if sides[0] else x.new_zeros(H),
                                  x[b:b + H] if sides[1] else x.new_zeros(H)])

            g = ghosts_of(u)
            ys.append(rd1d.rd1d_rk4_fwd_cuda(u[a:b], p, inv_dx2, h, S, chunk,
                                             g, *sides))
            d, q = rd1d.rd1d_rk4_vjp_cuda(u[a:b], p, inv_dx2, h, S,
                                          bwd_chunk, lam[a:b],
                                          torch.cat([g, ghosts_of(lam)]),
                                          *sides)
            dus.append(d)
            dps.append(q.double())
        same_y = torch.equal(torch.cat(ys), y)
        same_du = torch.equal(torch.cat(dus), du)
        e_dp = ((sum(dps) - dp.double()).abs() / dp.double().abs()).tolist()
        print(f"[kernels] {str(dtype)[6:]} n={n}, S={S}: K5/K6 with a null "
              f"buffer over the whole grid against {world} pieces on tile "
              f"ends with ghosts: u the same bits {same_y}, ū the same bits "
              f"{same_du}, pieces' D̄, k̄ summed rel {e_dp[0]:.3e}, "
              f"{e_dp[1]:.3e} (tol {KP_TOL[dtype]:g})")
        check(same_y and same_du and max(e_dp) <= KP_TOL[dtype],
              "K5/K6 on pieces off the whole grid's null-buffer launch")
    return out


def shard_sensealg(P, arm):
    return None if arm == "None" else getattr(P, arm)()


def u0_dtensor(u0, mesh, rank, world):
    """u0 split over the mesh as a DTensor with placement Shard(0): this
    rank's rows as the local shard, no scatter (gloo has none for CUDA
    tensors)."""
    from torch.distributed.tensor import DTensor, Shard

    return DTensor.from_local(u0.chunk(world)[rank].contiguous(), mesh,
                              [Shard(0)], run_check=False, shape=u0.shape,
                              stride=u0.stride())


def shard_gradient(P, field, n, u0, p, arm, shard_of=None):
    """flagship_gradient with u0 whole, or split over the mesh when
    `shard_of` = (mesh, rank, world)."""
    if shard_of is not None:
        u0 = u0_dtensor(u0, *shard_of)
    return flagship_gradient(P, field, n, u0, p, shard_sensealg(P, arm))


def shard_counts(rd1d, reset=False):
    """(K1 launches, K2 launches, K1 cells, K2 cells) since the last reset."""
    k1, k2 = rd1d.rd1d_fwd_cuda, rd1d.rd1d_vjp_cuda
    got = (k1.launches, k2.launches, k1.cells, k2.cells)
    if reset:
        k1.launches = k2.launches = k1.cells = k2.cells = 0
    return got


def cut_gradient(P, rd1d, n, u0, p, arm):
    """shard_gradient's result if the halo exchange were cut, each rank
    taking its own edge cell as the ghost at the cut: each of the
    SHARD_WORLD pieces of u0 solved alone with edge copies at both ends
    (the loss is a sum over cells, so u0's gradient is the pieces' side
    by side and p's their sum)."""
    parts = [shard_gradient(P, rd1d.make_rd1d_field(len(piece), 1.0 / n),
                            len(piece), piece, p, arm)
             for piece in u0.chunk(SHARD_WORLD)]
    return (torch.cat([gu.detach() for gu, _, _ in parts]),
            sum(gp.detach() for _, gp, _ in parts))


def shard_mega_h(n):
    """The sharded block's step at n: h·D·inv_dx2 = SHARD_MEGA_HDC."""
    return SHARD_MEGA_HDC / (P_FLAGSHIP[0] * float(n) * float(n))


def mega_shard_gradient(block, n, u0, p, shard_of=None):
    """(u0-grad, p-grad) of Σ u² after SHARD_MEGA_BLOCKS chained RK4 blocks
    from u0 (inv_dx2 = n², h = shard_mega_h(n)), u0 whole or split over the
    mesh when `shard_of` = (mesh, rank, world)."""
    uu = u0 if shard_of is None else u0_dtensor(u0, *shard_of)
    uu = uu.clone().requires_grad_()
    pp = p.clone().requires_grad_()
    u = uu
    for _ in range(SHARD_MEGA_BLOCKS):
        u = block(u, pp, float(n) * float(n), shard_mega_h(n))
    return torch.autograd.grad(torch.sum(u ** 2), (uu, pp))


def mega_counts(rd1d, reset=False):
    """(K5 launches, K6 launches, K5 cells, K6 cells) since the last
    reset."""
    k5, k6 = rd1d.rd1d_rk4_fwd_cuda, rd1d.rd1d_rk4_vjp_cuda
    got = (k5.launches, k6.launches, k5.cells, k6.cells)
    if reset:
        k5.launches = k6.launches = k5.cells = k6.cells = 0
    return got


def s4_shard_gradient(P, setup, arm, shard_of=None):
    """s4_gradient under `arm` (SHARD_S4_ADJ's reverse tolerances), u0 whole
    or split by rows over the mesh (`shard_of`)."""
    from scimlsensitivity_jl_tpu_torch.ops.mlp import fused_mlp2

    params = {k: v.detach().clone().requires_grad_()
              for k, v in setup[0].items()}
    _, u0, steps = setup
    if shard_of is not None:
        u0 = u0_dtensor(u0, *shard_of)
    prob = P.ODEProblem(lambda u, p, t: fused_mlp2(p, u), u0, (0.0, 1.0),
                        params)
    sol = P.solve(prob, P.Tsit5(), saveat=[0.0, 1.0], dt=1.0 / steps,
                  adaptive=False, sensealg=shard_sensealg(P, arm),
                  **SHARD_S4_ADJ)
    grads = torch.autograd.grad(torch.sum(sol.ys[-1].float() ** 2),
                                list(params.values()))
    return dict(zip(params, grads)), sol


def mlp_counts(mlp, reset=False):
    """(K3 launches, K4 launches) since the last reset."""
    got = (mlp.mlp2_fwd_cuda.launches, mlp.mlp2_vjp_cuda.launches)
    if reset:
        mlp.mlp2_fwd_cuda.launches = mlp.mlp2_vjp_cuda.launches = 0
    return got


def _shard_spec(cases, arms, mega, s4) -> str:
    return json.dumps({"cases": [[str(d)[6:], n] for d, n in cases],
                       "arms": list(arms),
                       "mega": [[str(d)[6:], n] for d, n in mega],
                       "s4": list(s4)})


def _shard_unspec(spec: str):
    got = json.loads(spec)
    return ([(getattr(torch, d), n) for d, n in got["cases"]],
            tuple(got["arms"]),
            [(getattr(torch, d), n) for d, n in got["mega"]],
            tuple(got["s4"]))


def run_shard_rank(rank: int, world: int, port: int, path: str,
                   spec: str) -> int:
    """`chip_smoke.py --shard RANK WORLD PORT PATH SPEC`: one rank of phase
    5q on the card, for the flagship's (dtype, n) cases and arms, the RK4
    block's (dtype, n) cases and S4's arms of SPEC (JSON); its gradients'
    rows, launch counts and times saved to PATH (torch.save), read back by
    the run that started it."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    import scimlsensitivity_jl_tpu_torch as P
    from scimlsensitivity_jl_tpu_torch.ops import mlp, rd1d
    from scimlsensitivity_jl_tpu_torch.parallel import sharded

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    cases, arms, mega, s4_arms = _shard_unspec(spec)
    results = {}
    try:
        mesh = init_device_mesh("cuda", (world,))
        where = (mesh, rank, world)
        for dtype, n in cases:
            field = rd1d.make_rd1d_field(n, 1.0 / n)
            u0, p = shard_inputs(n, dtype, dev)
            for i, arm in enumerate(arms):
                def run():
                    return shard_gradient(P, field, n, u0, p, arm, where)

                shard = sharded.ShardContext.of(u0_dtensor(u0, *where))
                if i == 0:  # warm: the library's load, K2's workspace
                    run()
                shard_counts(rd1d, reset=True)
                comm0, ex0 = shard.comm_seconds, shard.exchanges
                (gu, gp, sol), ms = event_ms(run)
                adj = sol.adjoint.stats if sol.adjoint is not None else None
                results[(str(dtype), n, arm)] = {
                    "gu": gu.to_local().detach().cpu(),
                    "gp": gp.detach().cpu(), "ms": ms,
                    "counts": shard_counts(rd1d),
                    "comm_s": shard.comm_seconds - comm0,
                    "exchanges": shard.exchanges - ex0,
                    "sensealg": type(sol.sensealg).__name__,
                    "stats": tuple(sol.stats), "adj": adj and tuple(adj)}
        for dtype, n in mega:
            block = P.make_rd1d_rk4_block(n, MEGA_S)
            u0, p = shard_inputs(n, dtype, dev)
            shard = sharded.ShardContext.of(u0_dtensor(u0, *where))
            mega_shard_gradient(block, n, u0, p, where)  # warm
            mega_counts(rd1d, reset=True)
            comm0, ex0, cells0 = (shard.comm_seconds, shard.exchanges,
                                  shard.ghost_cells)
            (gu, gp), ms = event_ms(
                lambda: mega_shard_gradient(block, n, u0, p, where))
            results[("mega", str(dtype), n)] = {
                "gu": gu.to_local().detach().cpu(), "gp": gp.detach().cpu(),
                "ms": ms, "counts": mega_counts(rd1d),
                "comm_s": shard.comm_seconds - comm0,
                "exchanges": shard.exchanges - ex0,
                "ghost_cells": shard.ghost_cells - cells0}
        for label, dtype, B, steps in SHARD_S4_SETS if s4_arms else ():
            setup = s4_setup(P, dtype, dev, B=B, steps=steps)
            for i, arm in enumerate(s4_arms):
                def run():
                    return s4_shard_gradient(P, setup, arm, where)

                if i == 0:
                    run()
                mlp_counts(mlp, reset=True)
                (g, sol), ms = event_ms(run)
                adj = sol.adjoint.stats if sol.adjoint is not None else None
                results[(label, arm)] = {
                    "g": {k: v.detach().cpu() for k, v in g.items()},
                    "ms": ms, "counts": mlp_counts(mlp),
                    "sensealg": type(sol.sensealg).__name__,
                    "stats": tuple(sol.stats), "adj": adj and tuple(adj),
                    "reverse": (None if sol.adjoint is None
                                else sol.adjoint.reverse)}
            del setup
        # K1/K2 per launch at n/2 from a device trace of the first case's
        # sensealg=None gradient (rank 0 traces, rank 1 runs alongside)
        dtype, n = cases[0]
        field = rd1d.make_rd1d_field(n, 1.0 / n)
        u0, p = shard_inputs(n, dtype, dev)

        def traced():
            return shard_gradient(P, field, n, u0, p, "None", where)

        if rank == 0:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                traced()
                torch.cuda.synchronize()
            per = {}
            for e in prof.key_averages():
                if e.device_type == DeviceType.CUDA and e.count:
                    for name, key in (("K1", "rd1d_fwd_kernel"),
                                      ("K2", "rd1d_bwd_kernel")):
                        if key in e.key:
                            per[name] = (e.self_device_time_total / e.count,
                                         e.count)
            results["trace"] = per
        else:
            traced()
            torch.cuda.synchronize()
    finally:
        torch.save(results, path)
        dist.destroy_process_group()
    return 0


def _shard_unsharded_refs(P, rd1d, mlp, dev, cases, arms, mega, s4_arms):
    """Phase 5q's unsharded runs in this process: the flagship's (with the
    float64 gate's reading with the exchange cut), the RK4 block's (with its
    cut reading) and S4's, each with its launches and wall; B = 8 float64
    on the CPU."""
    ref = {}
    for dtype, n in cases:
        field = rd1d.make_rd1d_field(n, 1.0 / n)
        u0, p = shard_inputs(n, dtype, dev)
        for i, arm in enumerate(arms):
            run = (lambda field=field, n=n, u0=u0, p=p, arm=arm:
                   shard_gradient(P, field, n, u0, p, arm))
            if i == 0:  # warm, as the ranks do
                run()
            shard_counts(rd1d, reset=True)
            (gu, gp, sol), ms = event_ms(run)
            ref[(str(dtype), n, arm)] = {
                "gu": gu.detach().cpu(), "gp": gp.detach().cpu(), "ms": ms,
                "counts": shard_counts(rd1d),
                "sensealg": type(sol.sensealg).__name__}
            if dtype == torch.float64:
                # the gate's reading with the exchange cut: it must see it
                cu, cp = cut_gradient(P, rd1d, n, u0, p, arm)
                ref[(str(dtype), n, arm)]["cut"] = (
                    rel_l2(cu.cpu(), gu.detach().cpu()),
                    [abs(float(cp[i] - gp[i])) / abs(float(gp[i]))
                     for i in range(2)])
    for dtype, n in mega:
        block = P.make_rd1d_rk4_block(n, MEGA_S)
        u0, p = shard_inputs(n, dtype, dev)
        mega_shard_gradient(block, n, u0, p)  # warm
        mega_counts(rd1d, reset=True)
        (gu, gp), ms = event_ms(lambda: mega_shard_gradient(block, n, u0, p))
        counts = mega_counts(rd1d)
        # each half alone, edge copies at the cut: the exchange cut
        half = P.make_rd1d_rk4_block(n // SHARD_WORLD, MEGA_S)
        parts = []
        for piece in u0.chunk(SHARD_WORLD):
            uu = piece.clone().requires_grad_()
            pp = p.clone().requires_grad_()
            y = uu
            for _ in range(SHARD_MEGA_BLOCKS):
                y = half(y, pp, float(n) * float(n), shard_mega_h(n))
            parts.append(torch.autograd.grad(torch.sum(y ** 2), (uu, pp)))
        cut_u = torch.cat([q[0] for q in parts]).cpu()
        cut_p = sum(q[1] for q in parts).cpu()
        ref[("mega", str(dtype), n)] = {
            "gu": gu.detach().cpu(), "gp": gp.detach().cpu(), "ms": ms,
            "counts": counts, "cut_u": cut_u, "cut_p": cut_p}
    for label, dtype, B, steps in SHARD_S4_SETS if s4_arms else ():
        on = dev if label == "S4" else "cpu"  # B = 8: the CPU's run
        setup = s4_setup(P, dtype, on, B=B, steps=steps)
        for i, arm in enumerate(s4_arms):
            run = lambda arm=arm: s4_shard_gradient(P, setup, arm)
            if on != "cpu":
                if i == 0:
                    run()
                mlp_counts(mlp, reset=True)
                (g, sol), ms = event_ms(run)
            else:
                (g, sol), ms = run(), None
            ref[(label, arm)] = {
                "g": {k: v.detach().cpu() for k, v in g.items()}, "ms": ms,
                "counts": mlp_counts(mlp) if on != "cpu" else None,
                "sensealg": type(sol.sensealg).__name__,
                "stats": tuple(sol.stats)}
        del setup
    return ref


def shard_phase(P, rd1d, dev, card, cases=SHARD_CASES,
                arms=SHARD_ARMS, mega=SHARD_MEGA, s4_arms=SHARD_S4_ARMS):
    """Phase 5q [shard]: states split over SHARD_WORLD ranks that share the
    card over gloo (`--shard` processes), against the same runs unsharded
    in this process: the flagship for each (dtype, n) of `cases` under each
    of `arms`, the RK4 block for each (dtype, n) of `mega`, and S4 split by
    rows under each of `s4_arms` (float32 at full size on the card, and
    float64 at B = 8 against the CPU). Returns each rank's launches of
    K1-K6, and the kernels' per-launch times at the ranks' sizes."""
    from scimlsensitivity_jl_tpu_torch.ops import mlp

    shard_ref = _shard_unsharded_refs(P, rd1d, mlp, dev, cases, arms, mega,
                                      s4_arms)
    shard_dir = tempfile.mkdtemp(prefix="chip_smoke_shard_")
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    paths = [os.path.join(shard_dir, f"rank{r}.pt")
             for r in range(SHARD_WORLD)]
    logs = [open(os.path.join(shard_dir, f"rank{r}.log"), "w+")
            for r in range(SHARD_WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--shard", str(r),
         str(SHARD_WORLD), str(port), paths[r],
         _shard_spec(cases, arms, mega, s4_arms)],
        stdout=logs[r],
        stderr=subprocess.STDOUT) for r in range(SHARD_WORLD)]
    deadline = time.perf_counter() + SHARD_TIMEOUT
    rcs = []
    try:
        for proc in procs:
            try:
                rcs.append(proc.wait(max(deadline - time.perf_counter(),
                                         1.0)))
            except subprocess.TimeoutExpired:
                rcs.append(None)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for r, log in enumerate(logs):
        log.seek(0)
        text = log.read()
        log.close()
        check(rcs[r] == 0, f"[shard] rank {r} failed or ran late (exit "
              f"{rcs[r]}):\n{text[-4000:]}")
    ranks = [torch.load(path, weights_only=False) for path in paths]
    shutil.rmtree(shard_dir, ignore_errors=True)
    shard_launches = {f"[shard] rank {r}": dict.fromkeys(
        ("K1", "K2", "K3", "K4", "K5", "K6"), 0) for r in range(SHARD_WORLD)}
    for dtype, n in cases:
        for arm in arms:
            key = (str(dtype), n, arm)
            ref, got = shard_ref[key], [rk[key] for rk in ranks]
            gu = torch.cat([g["gu"] for g in got])
            e_u = rel_l2(gu, ref["gu"])
            e_p = [abs(float(got[0]["gp"][i] - ref["gp"][i]))
                   / abs(float(ref["gp"][i])) for i in range(2)]
            same_p = all(torch.equal(g["gp"], got[0]["gp"]) for g in got)
            label = f"{str(dtype)[6:]} n={n} {arm}"
            if dtype == torch.float64:
                gate = (f"tol {SHARD_F64_TOL:g} on u0-grad, dD and dk")
                ok = e_u <= SHARD_F64_TOL and max(e_p) <= SHARD_F64_TOL
            else:
                gate = (f"tol {F32_U0_TOL:g} on u0-grad, {F32_DK_TOL:g} on "
                        "dk; dD not gated, as in phase 5")
                ok = e_u <= F32_U0_TOL and e_p[1] <= F32_DK_TOL
            print(f"[shard] {label}: sharded vs unsharded card gradient: "
                  f"u0-grad rel L2 {e_u:.3e}, dD rel {e_p[0]:.3e}, dk rel "
                  f"{e_p[1]:.3e} ({gate}); p-grad the same on every rank: "
                  f"{same_p}; sensealg {got[0]['sensealg']} (unsharded "
                  f"{ref['sensealg']})")
            check(ok and same_p, f"[shard] {label} off the unsharded run")
            if "cut" in ref:
                c_u, c_p = ref["cut"]
                print(f"[shard] {label}: the same gate with the halo "
                      f"exchange cut (each half solved alone, edge copies "
                      f"at the cut): u0-grad rel L2 {c_u:.3e}, dD rel "
                      f"{c_p[0]:.3e}, dk rel {c_p[1]:.3e}")
                check(max(c_u, *c_p) > SHARD_F64_TOL,
                      f"[shard] {label}: the gate cannot see a cut exchange")
            check(got[0]["sensealg"] == ref["sensealg"],
                  f"[shard] {label} dispatched elsewhere")
            k1, k2 = ref["counts"][:2]
            for r, g in enumerate(got):
                l1, l2, c1, c2 = g["counts"]
                half = n // SHARD_WORLD
                print(f"[shard] {label} rank {r}: K1 {l1}, K2 {l2} launches "
                      f"(unsharded {k1}, {k2}), over {c1 / max(l1, 1):.0f} "
                      f"and {c2 / max(l2, 1):.0f} cells each (n/2 = {half}); "
                      f"{g['exchanges']} halo exchanges, "
                      f"{g['comm_s'] * 1e6 / max(g['exchanges'], 1):.0f} us "
                      "of collectives each (the adaptive reverses' norm "
                      "gathers included); wall "
                      f"{g['ms']:.3f} ms (unsharded {ref['ms']:.3f} ms, "
                      f"CUDA events, the two ranks sharing the card), "
                      f"{100 * g['comm_s'] * 1e3 / g['ms']:.1f}% of it "
                      "inside the collectives (gloo's host staging "
                      "included)")
                check((l1, l2) == (k1, k2) and c1 == l1 * half
                      and c2 == l2 * half,
                      f"[shard] {label} rank {r}: launches {g['counts']} "
                      f"against the unsharded {ref['counts']}")
                shard_launches[f"[shard] rank {r}"]["K1"] += l1
                shard_launches[f"[shard] rank {r}"]["K2"] += l2
    for dtype, n in mega:
        key = ("mega", str(dtype), n)
        ref, got = shard_ref[key], [rk[key] for rk in ranks]
        gu = torch.cat([g["gu"] for g in got])
        same_u = torch.equal(gu, ref["gu"])
        e_u = rel_l2(gu, ref["gu"])
        e_p = [abs(float(got[0]["gp"][i] - ref["gp"][i]))
               / abs(float(ref["gp"][i])) for i in range(2)]
        c_u = rel_l2(ref["cut_u"], ref["gu"])
        c_p = [abs(float(ref["cut_p"][i] - ref["gp"][i]))
               / abs(float(ref["gp"][i])) for i in range(2)]
        same_p = all(torch.equal(g["gp"], got[0]["gp"]) for g in got)
        label = (f"{str(dtype)[6:]} n={n} RK4 block S={MEGA_S} x "
                 f"{SHARD_MEGA_BLOCKS}")
        if dtype == torch.float64:
            gate = (f"u0-grad the same bits, dD and dk within "
                    f"{SHARD_MEGA_F64_TOL:g}")
            ok = max(e_p) <= SHARD_MEGA_F64_TOL
            cut_fails = c_u > 0 or max(c_p) > SHARD_MEGA_F64_TOL
        else:
            gate = (f"u0-grad the same bits, dk within {F32_DK_TOL:g}; dD "
                    "not gated, as in phase 5")
            ok = e_p[1] <= F32_DK_TOL
            cut_fails = c_u > 0 or c_p[1] > F32_DK_TOL
        print(f"[shard] {label}: sharded vs unsharded card gradient: u0-grad "
              f"the same bits {same_u} (rel L2 {e_u:.3e}), dD rel "
              f"{e_p[0]:.3e}, dk rel {e_p[1]:.3e} ({gate}); p-grad the same "
              f"on every rank: {same_p}; with the exchange cut (each half "
              f"alone, edge copies at the cut): u0-grad rel L2 {c_u:.3e}, dD "
              f"rel {c_p[0]:.3e}, dk rel {c_p[1]:.3e}, failing the gate: "
              f"{cut_fails}")
        check(same_u and ok and same_p,
              f"[shard] {label} off the unsharded run")
        check(cut_fails, f"[shard] {label}: the gate cannot see a cut "
              "exchange")
        k5, k6 = ref["counts"][:2]
        for r, g in enumerate(got):
            l5, l6, c5, c6 = g["counts"]
            half = n // SHARD_WORLD
            H = 4 * (MEGA_S + 1)
            print(f"[shard] {label} rank {r}: K5 {l5}, K6 {l6} launches "
                  f"(unsharded {k5}, {k6}), over {c5 / max(l5, 1):.0f} and "
                  f"{c6 / max(l6, 1):.0f} cells each (n/2 = {half}); "
                  f"{g['exchanges']} halo exchanges "
                  f"({g['exchanges'] // SHARD_MEGA_BLOCKS} per block call "
                  "and its pullback), "
                  f"{g['ghost_cells']} ghost values from its neighbour ({H} "
                  f"per inner side per array); wall {g['ms']:.3f} ms (unsharded "
                  f"{ref['ms']:.3f} ms, CUDA events, the two ranks sharing "
                  f"the card), {100 * g['comm_s'] * 1e3 / g['ms']:.1f}% of "
                  "it inside the collectives")
            check((l5, l6) == (k5, k6) and c5 == l5 * half
                  and c6 == l6 * half and g["exchanges"]
                  == 2 * SHARD_MEGA_BLOCKS,
                  f"[shard] {label} rank {r}: launches {g['counts']} "
                  f"against the unsharded {ref['counts']}")
            shard_launches[f"[shard] rank {r}"]["K5"] += l5
            shard_launches[f"[shard] rank {r}"]["K6"] += l6
    for label, dtype, B, steps in SHARD_S4_SETS if s4_arms else ():
        for arm in s4_arms:
            key = (label, arm)
            ref, got = shard_ref[key], [rk[key] for rk in ranks]
            errs = leaf_errors(got[0]["g"], ref["g"])
            same = all(torch.equal(g["g"][k], got[0]["g"][k])
                       for g in got for k in ref["g"])
            tol = S4_F32_TOL if label == "S4" else NODE_F64_TOL
            against = "the unsharded card run" if label == "S4" else "the CPU"
            print(f"[shard] {label} {str(dtype)[6:]} (B = {B} split "
                  f"{B // SHARD_WORLD} per rank, {S4_WIDTHS}, {steps} fixed "
                  f"Tsit5 steps) {arm}: dispatched to {got[0]['sensealg']} "
                  f"(unsharded {ref['sensealg']}), reverse "
                  f"{got[0]['reverse']} {got[0]['adj']}; weights' gradients "
                  f"vs {against} rel L2 {fmt_errors(errs)} (tol {tol:g}); the "
                  f"same on every rank: {same}")
            check(max(errs.values()) <= tol and same
                  and got[0]["sensealg"] == ref["sensealg"],
                  f"[shard] {label} {arm} off {against}")
            for r, g in enumerate(got):
                l3, l4 = g["counts"]
                line = (f"[shard] {label} {arm} rank {r}: K3 {l3}, K4 {l4} "
                        f"launches on its {B // SHARD_WORLD} rows")
                if ref["counts"] is not None:
                    line += (f" (unsharded {ref['counts'][0]}, "
                             f"{ref['counts'][1]}); wall {g['ms']:.3f} ms "
                             f"(unsharded {ref['ms']:.3f} ms, CUDA events, "
                             "the two ranks sharing the card)")
                    check((l3, l4) == ref["counts"],
                          f"[shard] {label} {arm} rank {r}: K3/K4 launches "
                          f"{g['counts']} against {ref['counts']}")
                print(line)
                shard_launches[f"[shard] rank {r}"]["K3"] += l3
                shard_launches[f"[shard] rank {r}"]["K4"] += l4
    trace = ranks[0]["trace"]
    check(set(trace) == {"K1", "K2"}, f"[shard] trace held {trace}")
    dtype, n = cases[0]
    elt = torch.tensor([], dtype=dtype).element_size()
    for name, (us, count) in trace.items():
        cells = (2 if name == "K1" else 3) * elt  # bytes per cell
        bound = cells * (n // SHARD_WORLD) / HBM_BYTES_PER_S * 1e6
        print(f"[time] {card}: [shard] {str(dtype)[6:]} n={n} "
              f"sensealg=None, rank 0: "
              f"{name} {us:.2f} us per launch at n/2 = {n // SHARD_WORLD} "
              f"cells over {count} launches (bound {bound:.2f} us at "
              f"{cells} B/cell; the other rank's launches share the card); "
              "profiler trace")
    return shard_launches, shard_kernel_times(rd1d, mlp, dev, card, mega,
                                              s4_arms)


def shard_kernel_times(rd1d, mlp, dev, card, mega, s4_arms):
    """K5/K6 and K3/K4 per launch at the [shard] ranks' sizes, rank 0's
    geometry (a neighbour on the right: its ghost buffer read), from
    profiler traces of 20 calls each, with the bound at that size."""
    out = {}
    if mega:
        dtype, n = mega[0]
        half, S = n // SHARD_WORLD, MEGA_S
        H = 4 * (S + 1)
        u, lam, p, inv_dx2, h = rk4_check_inputs(half, dtype, dev)
        ghosts = torch.rand(4 * H, device=dev, dtype=dtype)
        fns = {"K5": lambda: rd1d.rd1d_rk4_fwd_cuda(
                   u, p, inv_dx2, h, S, 4096, ghosts[:2 * H], True, False),
               "K6": lambda: rd1d.rd1d_rk4_vjp_cuda(
                   u, p, inv_dx2, h, S, 1024, lam, ghosts, True, False)}
        for name, fn in fns.items():
            busy, _ = profiled_ms(fn, calls=20, kernels=1 if name == "K5"
                                  else 2)
            bound, by = rk4_bound_ms(name, half, S, dtype)
            out[name] = (busy, bound, by)
            print(f"[time] {card}: [shard] {name} {str(dtype)[6:]} at n/2 = "
                  f"{half}, S = {S}, rank 0's shard (ghosts read at its "
                  f"cut): {busy * 1e3:.2f} us per launch (bound "
                  f"{bound * 1e3:.2f} us by {by}, {100 * bound / busy:.1f}% "
                  "of it); profiler over 20 calls")
    if not s4_arms:
        return out
    shape = (S4_B // SHARD_WORLD,) + S4_WIDTHS
    x, w0, b0, w1, b1, g = mlp_inputs(shape, torch.float32, dev)
    _, hh = mlp.mlp2_fwd_cuda(x, w0, b0, w1, b1)
    bounds = mlp_bound_ms(shape, torch.float32)
    route = mlp.mlp2_route(*x.shape, *w1.shape, torch.float32, True)
    for name, fn in (("K3", lambda: mlp.mlp2_fwd_cuda(x, w0, b0, w1, b1)),
                     ("K4", lambda: mlp.mlp2_vjp_cuda(x, w0, w1, hh, g))):
        # the call's kernels and memsets, each mean per launch summed; the
        # larger of two traces (a trace that lost launches reads low)
        ops = sum(kernels_per_call(fn))
        busy = max(profiled_ms(fn, calls=20, kernels=ops)[0]
                   for _ in range(2))
        bound, by = bounds[name]
        out[name] = (busy, bound, by)
        print(f"[time] {card}: [shard] {name} float32 at B/2 = {shape[0]} "
              f"rows ({shape}, route {route}): {busy * 1e3:.2f} us per call "
              f"(bound {bound * 1e3:.2f} us by {by}, "
              f"{100 * bound / busy:.1f}% of it); profiler over 20 calls")
    return out


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
            # arguments are R, its most threads and its blocks per SM, the
            # last of each kernel's whether it reads a ghost buffer
            for kernel, regs, st, ld in ptxas_rows(cuda_build.build_log(name)):
                print(f"[setup] ptxas rd1d_rk4: {kernel}: {regs} registers, "
                      f"spill stores {st} B, spill loads {ld} B")
            continue
        for line in cuda_build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"[setup] ptxas {name}: {line.strip()}")

    # the host-paced Lorenz arms of phase 5n, card and CPU, run beside
    # phases 3-5m in processes of their own
    background = Background(tempfile.mkdtemp(prefix="chip_smoke_"))
    atexit.register(background.stop)

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
    ghost_abs = check_ghosted_kernels(rd1d, dev)
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
                         ("S4", torch.bfloat16), ("S4", torch.float32)):
        x, w0, b0, w1, b1, g = mlp_inputs(MLP_SHAPES[label], dtype, dev)
        _, h = mlp.mlp2_fwd_cuda(x, w0, b0, w1, b1)
        route = mlp.mlp2_route(*x.shape, *w1.shape, dtype, True)
        counts = {"K3": kernels_per_call(lambda: mlp.mlp2_fwd_cuda(
                      x, w0, b0, w1, b1)),
                  "K4": kernels_per_call(lambda: mlp.mlp2_vjp_cuda(
                      x, w0, w1, h, g))}
        # a float32 call whose plan splits a product zeroes its counters
        memsets = int(dtype == torch.float32 and label == "S4")
        print(f"[kernels] {label} {str(dtype)[6:]} route {route}: kernels "
              f"(memsets) per call in the profiler trace: K3 "
              f"{counts['K3'][0]} ({counts['K3'][1]}), K4 {counts['K4'][0]} "
              f"({counts['K4'][1]})")
        check(counts == {"K3": (2, memsets), "K4": (2, memsets)},
              f"{label}: K3/K4 launched {counts} (kernels, memsets) per "
              f"call, not (2, {memsets})")

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

    ghost_rk4_abs = check_ghosted_rk4(rd1d, dev)
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
    lv_grads = {}
    t = time.perf_counter()
    for name, sensealg in lv_runs.items():
        # each gradient is timed in phase 6d, after the background processes
        g_cpu, _ = lv_solve(P, "cpu", sensealg, grad=True)
        g_card, sol = lv_solve(P, dev, sensealg, grad=True)
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

    # -- 5e. [interp f64]: InterpolatingAdjoint (pinned, adaptive,
    # checkpointed), GaussKronrodAdjoint and Gauss checkpointed or pinned --
    # PDE (d)-(f) on the flagship field: K1 in every forward and (e)'s
    # re-solves, K1 + K2 at every joined [λ; q] stage (f_and_vjp), K2 at
    # every λ stage and Gauss–Kronrod node of (f)
    pde_interp = {
        "(d)": ("InterpolatingAdjoint() (auto: pinned)",
                P.InterpolatingAdjoint(), "pinned"),
        "(d-)": ("InterpolatingAdjoint(pinned_reverse=False)",
                 P.InterpolatingAdjoint(pinned_reverse=False), "adaptive"),
        "(e)": (f"InterpolatingAdjoint(checkpointing=True, "
                f"{len(PDE_CHECKPOINTS)} checkpoints)",
                P.InterpolatingAdjoint(checkpointing=True,
                                       checkpoints=PDE_CHECKPOINTS),
                "checkpointed"),
        "(f)": ("GaussKronrodAdjoint()", P.GaussKronrodAdjoint(), "adaptive"),
    }

    def reverse_ran(rec):
        extra = f", {rec.resolves} intervals re-solved" if rec.resolves else ""
        return f"{rec.reverse} reverse{extra}"

    def interp_checks(arm, sol, tag, k2=None):
        """The reverse each arm must report: (d) rides the forward's grid,
        one reverse step on each of its STEPS intervals, and (e) solves
        every inter-checkpoint interval again. k2, the gradient's K2
        launches on the card, counts (d)'s steps apart from the walk's own
        tally: one pullback after t1's jump, 6 per step (Tsit5's stages
        after the first, which the step before hands on) and one after
        t0's jump. (The float32 forward ends in a 65th step narrower than
        the time-matching tolerance, which the walk steps over.)"""
        rec = sol.adjoint
        check(sol.retcode == 0 and rec.stats.retcode == 0,
              f"{tag} {arm} retcode {sol.retcode}/{rec.stats.retcode}")
        check(rec.reverse == pde_interp[arm][2],
              f"{tag} {arm} ran the {rec.reverse} reverse")
        if arm == "(d)":
            check(rec.stats.n_accepted == STEPS,
                  f"{tag} (d) stepped {rec.stats.n_accepted} of the grid's "
                  f"{STEPS} intervals")
            check(k2 is None or k2 == 2 + 6 * STEPS,
                  f"{tag} (d) launched K2 {k2} times, not 2 + 6 x {STEPS}")
        if arm == "(e)":
            check(rec.resolves == len(PDE_CHECKPOINTS) + 1,
                  f"{tag} (e) re-solved {rec.resolves} intervals")

    interp_launches = {}
    n = SIZES[0]
    field = rd1d.make_rd1d_field(n, 1.0 / n)
    t = time.perf_counter()
    for arm, (label, sensealg, _) in pde_interp.items():
        rd1d.rd1d_fwd_cuda.launches = 0
        rd1d.rd1d_vjp_cuda.launches = 0
        u0, p = flagship_inputs(n, torch.float64, dev)
        gu, gp, sol = flagship_gradient(P, field, n, u0, p, sensealg)
        torch.cuda.synchronize()
        got = {"K1": rd1d.rd1d_fwd_cuda.launches,
               "K2": rd1d.rd1d_vjp_cuda.launches}
        interp_launches[arm] = got
        u0c, pc = flagship_inputs(n, torch.float64, "cpu")
        gu_c, gp_c, sol_c = flagship_gradient(P, field, n, u0c, pc, sensealg)
        e_u = rel_l2(gu, gu_c)
        e_p = ((gp.cpu() - gp_c).abs() / gp_c.abs()).tolist()
        rec = sol.adjoint
        print(f"[interp f64] PDE {arm} n={n} {label}: {reverse_ran(rec)}"
              f"; forward {sol.stats}; reverse {rec.stats}; K1 {got['K1']} and "
              f"K2 {got['K2']} launches per gradient; card vs CPU u0-grad rel "
              f"L2 {e_u:.3e}, dD rel {e_p[0]:.3e}, dk rel {e_p[1]:.3e} (tol "
              f"{F64_GRAD_TOL:g}); p-grad {gp.tolist()}")
        interp_checks(arm, sol, "card", k2=got["K2"])
        interp_checks(arm, sol_c, "CPU")
        check(got["K1"] > 0 and got["K2"] > 0,
              f"PDE {arm} did not launch K1 and K2: {got}")
        check(e_u <= F64_GRAD_TOL and max(e_p) <= F64_GRAD_TOL,
              f"PDE {arm} f64 card gradient off the CPU run")
    del u0c, pc, gu_c, gp_c
    print(f"[interp f64] PDE (d)-(f) card and CPU runs: "
          f"{time.perf_counter() - t:.1f} s")
    for n in SIZES:
        field = rd1d.make_rd1d_field(n, 1.0 / n)
        for arm, (label, sensealg, _) in pde_interp.items():
            u0, p = flagship_inputs(n, torch.float64, dev)
            rd1d.rd1d_vjp_cuda.launches = 0
            gu64, gp64, sol64 = flagship_gradient(P, field, n, u0, p, sensealg)
            torch.cuda.synchronize()
            interp_checks(arm, sol64, f"f64 n={n}",
                          k2=rd1d.rd1d_vjp_cuda.launches)
            u0, p = flagship_inputs(n, torch.float32, dev)
            rd1d.rd1d_fwd_cuda.launches = 0
            rd1d.rd1d_vjp_cuda.launches = 0
            gu, gp, sol = flagship_gradient(P, field, n, u0, p, sensealg)
            torch.cuda.synchronize()
            got = (rd1d.rd1d_fwd_cuda.launches, rd1d.rd1d_vjp_cuda.launches)
            e_u = rel_l2(gu, gu64)
            e_dD = abs(float(gp[0]) - float(gp64[0])) / abs(float(gp64[0]))
            e_dk = abs(float(gp[1]) - float(gp64[1])) / abs(float(gp64[1]))
            print(f"[interp f32] PDE {arm} n={n} vs card f64: u0-grad rel L2 "
                  f"{e_u:.3e} (tol {F32_U0_TOL:g}), dk rel {e_dk:.3e} (tol "
                  f"{F32_DK_TOL:g}), dD rel {e_dD:.3e} (not gated, as in "
                  f"(a)); {sol.adjoint.reverse} reverse, forward {sol.stats}, "
                  f"reverse {sol.adjoint.stats}; K1 {got[0]} and K2 {got[1]} "
                  "launches")
            interp_checks(arm, sol, f"f32 n={n}", k2=got[1])
            check(min(got) > 0, f"f32 PDE {arm} n={n} launched K1, K2 {got}")
            check(e_u <= F32_U0_TOL and e_dk <= F32_DK_TOL,
                  f"PDE {arm} f32 n={n} gradient off the f64 one")
    del u0, p, gu, gp, gu64, gp64

    # the spiral at S2's setting: K3 in the forward and wherever a pullback
    # runs the field again, K4 at every reverse stage and quadrature node
    spiral_interp = {
        "S2i InterpolatingAdjoint()": dict(
            SPIRAL_ADAPTIVE, sensealg=P.InterpolatingAdjoint()),
        "S2k GaussKronrodAdjoint()": dict(
            SPIRAL_ADAPTIVE, sensealg=P.GaussKronrodAdjoint()),
        "S2c GaussAdjoint(checkpointing=True)": dict(
            SPIRAL_ADAPTIVE, sensealg=P.GaussAdjoint(checkpointing=True)),
        "S2p GaussAdjoint(pinned_reverse=True)": dict(
            SPIRAL_ADAPTIVE, sensealg=P.GaussAdjoint(pinned_reverse=True)),
    }
    interp_node_launches = {}
    for arm, kw in spiral_interp.items():
        (g_card, sol), got = count_path(
            lambda: spiral_gradient(P, setup_card, kw))
        g_cpu, _ = spiral_gradient(P, setup_cpu, kw)
        errs = leaf_errors(g_card, g_cpu)
        interp_node_launches[arm.split(" ")[0]] = got
        print(f"[interp f64] {arm}: {reverse_ran(sol.adjoint)}"
              f"; forward {sol.stats}; reverse {sol.adjoint.stats}; K3 "
              f"{got[0]} and K4 {got[1]} launches per gradient; card vs CPU "
              f"rel L2 {fmt_errors(errs)} (tol {NODE_F64_TOL:g})")
        check(sol.retcode == 0 and sol.adjoint.stats.retcode == 0,
              f"{arm} retcode")
        check(max(errs.values()) <= NODE_F64_TOL,
              f"{arm}: f64 card gradient off the CPU run")

    # Lotka–Volterra at phase 5d's setting, on the card, against the
    # ForwardDiffSensitivity gradient (JAX tests/test_forward.py's oracle)
    lv_interp = {"InterpolatingAdjoint": P.InterpolatingAdjoint(),
                 "GaussKronrodAdjoint": P.GaussKronrodAdjoint()}
    for name, sensealg in lv_interp.items():
        g_card, sol = lv_solve(P, dev, sensealg, grad=True)
        err = max_rel(g_card, lv_grads[LV_RULES[0]])
        print(f"[interp f64] Lotka-Volterra {name}: {sol.adjoint.reverse} "
              f"reverse; forward {sol.stats}; reverse {sol.adjoint.stats}; "
              f"against ForwardDiffSensitivity max relative difference per "
              f"entry {err:.2e} (tol {LV_RULE_TOL:g}); grad [u0, p] "
              f"{g_card.tolist()}")
        check(sol.retcode == 0 and sol.adjoint.stats.retcode == 0,
              f"LV {name} retcode")
        check(err <= LV_RULE_TOL, f"LV {name} off ForwardDiffSensitivity")
    lv_runs.update(lv_interp)

    elapsed("phase 5e [interp f64]")

    # -- 5f. [events f64]: events, dense output and save times -------------
    # PDE with a dose (PresetTimeCallback): K1 in every forward stage and for
    # f⁻/f⁺ at the dose, K2 at every reverse stage or quadrature node
    dose_rules = {"None (-> GaussAdjoint)": None,
                  "BacksolveAdjoint": P.BacksolveAdjoint(),
                  "InterpolatingAdjoint": P.InterpolatingAdjoint(),
                  "DirectAdjoint": P.DirectAdjoint()}
    dose_launches = {}
    dose_grads64 = {}
    t = time.perf_counter()
    n = EV_N[torch.float64]
    field = rd1d.make_rd1d_field(n, 1.0 / n)
    for name, sensealg in dose_rules.items():
        rd1d.rd1d_fwd_cuda.launches = 0
        rd1d.rd1d_vjp_cuda.launches = 0
        u0, p = flagship_inputs(n, torch.float64, dev)
        gu, gp, sol = dose_gradient(P, field, u0, p, sensealg)
        torch.cuda.synchronize()
        got = {"K1": rd1d.rd1d_fwd_cuda.launches,
               "K2": rd1d.rd1d_vjp_cuda.launches}
        dose_launches[name] = got
        u0c, pc = flagship_inputs(n, torch.float64, "cpu")
        gu_c, gp_c, sol_c = dose_gradient(P, field, u0c, pc, sensealg)
        e_u = rel_l2(gu, gu_c)
        e_p = ((gp.cpu() - gp_c).abs() / gp_c.abs()).tolist()
        print(f"[events f64] PDE dose n={n} {name}: {type(sol.sensealg).__name__}"
              f"; forward {sol.stats}, {sol.events.count} dose at "
              f"{float(sol.events.ts[0]):.6g}; K1 {got['K1']} and K2 "
              f"{got['K2']} launches per gradient; card vs CPU u0-grad rel L2 "
              f"{e_u:.3e}, dD rel {e_p[0]:.3e}, dk rel {e_p[1]:.3e} (tol "
              f"{F64_GRAD_TOL:g}); p-grad {gp.tolist()}")
        check(sol.retcode == 0 and sol_c.retcode == 0,
              f"PDE dose {name} retcode {sol.retcode}/{sol_c.retcode}")
        check(sol.events.count == 1 == sol_c.events.count,
              f"PDE dose {name}: {sol.events.count} doses recorded")
        if sensealg is None:
            check(isinstance(sol.sensealg, P.GaussAdjoint),
                  f"PDE dose sensealg=None ran {sol.sensealg!r}")
        check(got["K1"] > 0 and got["K2"] > 0,
              f"PDE dose {name} did not launch K1 and K2: {got}")
        check(e_u <= F64_GRAD_TOL and max(e_p) <= F64_GRAD_TOL,
              f"PDE dose {name} f64 card gradient off the CPU run")
    del u0c, pc, gu_c, gp_c
    n = EV_N[torch.float32]
    field = rd1d.make_rd1d_field(n, 1.0 / n)
    for name, sensealg in dose_rules.items():
        u0, p = flagship_inputs(n, torch.float64, dev)
        gu64, gp64, sol64 = dose_gradient(P, field, u0, p, sensealg)
        u0, p = flagship_inputs(n, torch.float32, dev)
        rd1d.rd1d_fwd_cuda.launches = 0
        rd1d.rd1d_vjp_cuda.launches = 0
        gu, gp, sol = dose_gradient(P, field, u0, p, sensealg)
        torch.cuda.synchronize()
        got = (rd1d.rd1d_fwd_cuda.launches, rd1d.rd1d_vjp_cuda.launches)
        e_u = rel_l2(gu, gu64)
        e_dk = abs(float(gp[1]) - float(gp64[1])) / abs(float(gp64[1]))
        print(f"[events f32] PDE dose n={n} {name} vs card f64: u0-grad rel "
              f"L2 {e_u:.3e} (tol {F32_U0_TOL:g}), dk rel {e_dk:.3e} (not "
              f"gated); forward {sol.stats} (f64 {sol64.stats}); "
              f"{sol.events.count} dose; K1 {got[0]} and K2 {got[1]} launches")
        check(sol.retcode == 0 and sol64.retcode == 0 and sol.events.count
              == 1, f"f32 PDE dose {name}: retcode {sol.retcode}, "
              f"{sol.events.count} doses")
        check(min(got) > 0, f"f32 PDE dose {name} launched K1, K2 {got}")
        check(e_u <= F32_U0_TOL, f"PDE dose {name} f32 gradient off the f64 one")
    del u0, p, gu, gp, gu64, gp64
    print(f"[events f64] PDE dose card and CPU runs: "
          f"{time.perf_counter() - t:.1f} s")

    # the spiral with a continuous event (‖u‖² = c, u ← 0.8u) at S2's
    # setting: K3 in every stage and for f⁻/f⁺ at the event, K4 at every
    # reverse stage or quadrature node
    event_rules = {"S2e None (-> GaussAdjoint)": None,
                   "S2e InterpolatingAdjoint": P.InterpolatingAdjoint(),
                   "S2e BacksolveAdjoint": P.BacksolveAdjoint(),
                   "S2e QuadratureAdjoint": P.QuadratureAdjoint(),
                   "S2e DirectAdjoint": P.DirectAdjoint()}
    event_arms = {name: spiral_event_kw(P, dict(SPIRAL_ADAPTIVE, sensealg=s))
                  for name, s in event_rules.items()}
    dense_arms = {"S2d GaussAdjoint dense": dict(
                      SPIRAL_ADAPTIVE, sensealg=P.GaussAdjoint()),
                  "S2d InterpolatingAdjoint dense": dict(
                      SPIRAL_ADAPTIVE, sensealg=P.InterpolatingAdjoint())}
    saveat_kw = dict(SPIRAL_ADAPTIVE, sensealg=P.GaussAdjoint())
    event_node_launches = {}
    grads64 = {}
    t = time.perf_counter()
    runs = [(name, kw, spiral_gradient) for name, kw in event_arms.items()]
    runs += [(name, kw, spiral_dense_gradient)
             for name, kw in dense_arms.items()]
    runs.append(("S2t GaussAdjoint saveat", saveat_kw, spiral_saveat_gradient))
    for name, kw, grad_fn in runs:
        (g_card, sol), got = count_path(
            lambda: grad_fn(P, setup_card, kw))
        g_cpu, sol_c = grad_fn(P, setup_cpu, kw)
        errs = leaf_errors(g_card, g_cpu)
        event_node_launches[name.split(" ")[0] + " " + name.split(" ")[1]] = got
        grads64[name] = (g_card, sol)
        ev = ("" if sol.events is None else
              f"; {sol.events.count} events (CPU {sol_c.events.count}) at "
              f"{[round(float(x), 6) for x in sol.events.ts[:sol.events.count]]}")
        print(f"[events f64] {name}: {type(sol.sensealg).__name__}; forward "
              f"{sol.stats}{ev}; K3 {got[0]} and K4 {got[1]} launches per "
              f"gradient; card vs CPU rel L2 {fmt_errors(errs)} (tol "
              f"{NODE_F64_TOL:g})")
        check(sol.retcode == 0 and sol_c.retcode == 0, f"{name} retcode")
        if sol.events is not None:
            check(sol.events.count == sol_c.events.count >= 1,
                  f"{name}: {sol.events.count} events on the card, "
                  f"{sol_c.events.count} on the CPU")
        if "None" in name:
            check(isinstance(sol.sensealg, P.GaussAdjoint),
                  f"{name} ran {sol.sensealg!r}")
        check(max(errs.values()) <= NODE_F64_TOL,
              f"{name}: f64 card gradient off the CPU run")
    print(f"[events f64] spiral event, dense and saveat card and CPU runs: "
          f"{time.perf_counter() - t:.1f} s")
    # the same arms in float32 on the card, untimed (K3/K4 on the float32
    # engine at B = 1): retcodes, the f64 run's event count, and each
    # gradient against the card's f64 one
    t = time.perf_counter()
    setup32 = spiral_setup(P, torch.float32, dev, data64)
    for name, kw, grad_fn in runs:
        g32, sol32 = grad_fn(P, setup32, kw)
        g64, sol64 = grads64[name]
        errs = leaf_errors(g32, g64)
        ev = ("" if sol32.events is None else
              f"; {sol32.events.count} events (f64 {sol64.events.count})")
        print(f"[events f32] {name}: forward {sol32.stats} (f64 "
              f"{sol64.stats}){ev}; against the card's f64 gradient rel L2 "
              f"{fmt_errors(errs)} (tol {SPIRAL_F32_TOL:g})")
        check(sol32.retcode == 0, f"f32 {name} retcode {sol32.retcode}")
        if sol32.events is not None:
            check(sol32.events.count == sol64.events.count,
                  f"f32 {name}: {sol32.events.count} events, f64 "
                  f"{sol64.events.count}")
        check(max(errs.values()) <= SPIRAL_F32_TOL,
              f"{name}: f32 card gradient off the f64 one")
    del setup32, grads64
    print(f"[events f32] spiral event, dense and saveat float32 runs: "
          f"{time.perf_counter() - t:.1f} s")

    # the bouncing ball (bench.py:289-316) in float64, a field of plain
    # tensor operations on the card: GaussAdjoint against ForwardDiff
    g_gauss, sol_b = ball_solve(P, dev, P.GaussAdjoint(), grad=True)
    g_fds, _ = ball_solve(P, dev, P.ForwardDiffSensitivity(), grad=True)
    err = max_rel(g_gauss, g_fds)
    print(f"[events f64] bouncing ball: {sol_b.events.count} bounces at "
          f"{[round(float(x), 6) for x in sol_b.events.ts[:sol_b.events.count]]}"
          f"; forward {sol_b.stats}; GaussAdjoint against "
          f"ForwardDiffSensitivity max relative difference per entry "
          f"{err:.2e} (tol {EV_RULE_TOL:g}); p-grad {g_gauss.tolist()}")
    check(sol_b.retcode == 0 and sol_b.events.count >= 1, "ball retcode")
    check(err <= EV_RULE_TOL, "ball GaussAdjoint off ForwardDiffSensitivity")
    elapsed("phase 5f [events f64]")

    # -- 5g. [direct f64]: adjoint_sensitivities and ODEAdjointProblem -----
    # the flagship PDE at (d-)'s setting (64 fixed steps, dense output),
    # the cost Σ u(t1)² given as dgdu_discrete at t1: K1 and K2 in every
    # reverse stage (f_and_vjp, vjp_u), Gauss or Gauss–Kronrod node (vjp_p)
    # and Backsolve's reconstruction; each arm held to the card's solve
    # gradient of its rule (the adaptive reverse, ADJ's tolerances)
    from scimlsensitivity_jl_tpu_torch.ops.vjp import DoubleBackwardUnsupported

    solve_rule = {"InterpolatingAdjoint": P.InterpolatingAdjoint(
                      pinned_reverse=False),
                  "BacksolveAdjoint": P.BacksolveAdjoint(),
                  "GaussAdjoint": P.GaussAdjoint(),
                  "QuadratureAdjoint": P.QuadratureAdjoint()}
    direct_arms = {rule: (lambda sol, r=rule: direct_pde(P, sol, r))
                   for rule in DIRECT_PDE_RULES}
    direct_arms["ODEAdjointProblem (Interpolating, by hand)"] = (
        lambda sol: adjoint_problem_pde(P, sol))
    direct_launches = {}
    t = time.perf_counter()
    n = SIZES[0]
    field = rd1d.make_rd1d_field(n, 1.0 / n)
    u0c, pc = flagship_inputs(n, torch.float64, "cpu")
    sol_c = flagship_dense_forward(P, field, u0c, pc)
    u0, p = flagship_inputs(n, torch.float64, dev)
    sol = flagship_dense_forward(P, field, u0, p)
    for arm, fn in direct_arms.items():
        rd1d.rd1d_fwd_cuda.launches = 0
        rd1d.rd1d_vjp_cuda.launches = 0
        gu, gp = fn(sol)
        torch.cuda.synchronize()
        got = {"K1": rd1d.rd1d_fwd_cuda.launches,
               "K2": rd1d.rd1d_vjp_cuda.launches}
        direct_launches[arm] = got
        gu_c, gp_c = fn(sol_c)
        rule = arm if arm in solve_rule else "InterpolatingAdjoint"
        gu_s, gp_s, _ = flagship_gradient(P, field, n, u0, p,
                                          solve_rule[rule])
        e_u = rel_l2(gu, gu_c)
        e_p = ((gp.cpu() - gp_c).abs() / gp_c.abs()).tolist()
        e_s = max([rel_l2(gu, gu_s)]
                  + ((gp - gp_s).abs() / gp_s.abs()).tolist())
        print(f"[direct f64] PDE n={n} {arm}: K1 {got['K1']} and K2 "
              f"{got['K2']} launches in the direct call; card vs CPU "
              f"u0-grad rel L2 {e_u:.3e}, dD rel {e_p[0]:.3e}, dk rel "
              f"{e_p[1]:.3e} (tol {F64_GRAD_TOL:g}); against the card's "
              f"solve gradient under {rule} (adaptive reverse) max rel "
              f"{e_s:.3e} (tol {DIRECT_TOL:g}, the reverse rtol); p-grad "
              f"{gp.tolist()}")
        check(got["K1"] > 0 and got["K2"] > 0,
              f"direct {arm} did not launch K1 and K2: {got}")
        check(e_u <= F64_GRAD_TOL and max(e_p) <= F64_GRAD_TOL,
              f"direct {arm} f64 card gradient off the CPU run")
        check(e_s <= DIRECT_TOL, f"direct {arm} off the solve gradient")
    del u0c, pc, sol_c, gu_c, gp_c, gu_s, gp_s, sol

    # the dosed PDE with its callback under the Interpolating direct API,
    # against the card's solve gradient under InterpolatingAdjoint
    n = EV_N[torch.float64]
    field = rd1d.make_rd1d_field(n, 1.0 / n)
    u0, p = flagship_inputs(n, torch.float64, dev)
    rd1d.rd1d_fwd_cuda.launches = 0
    rd1d.rd1d_vjp_cuda.launches = 0
    gu, gp = direct_dose(P, field, u0, p)
    torch.cuda.synchronize()
    got = {"K1": rd1d.rd1d_fwd_cuda.launches,
           "K2": rd1d.rd1d_vjp_cuda.launches}
    direct_launches["dosed PDE (Interpolating, callback=)"] = got
    gu_c, gp_c = direct_dose(P, field, *flagship_inputs(n, torch.float64,
                                                        "cpu"))
    gu_s, gp_s, _ = dose_gradient(P, field, u0, p, P.InterpolatingAdjoint())
    e_u = rel_l2(gu, gu_c)
    e_p = ((gp.cpu() - gp_c).abs() / gp_c.abs()).tolist()
    e_s = max([rel_l2(gu, gu_s)] + ((gp - gp_s).abs() / gp_s.abs()).tolist())
    print(f"[direct f64] PDE dose n={n} Interpolating with callback=: K1 "
          f"{got['K1']} and K2 {got['K2']} launches (forward and reverse); "
          f"card vs CPU u0-grad rel L2 {e_u:.3e}, dD rel {e_p[0]:.3e}, dk "
          f"rel {e_p[1]:.3e} (tol {F64_GRAD_TOL:g}); against the solve "
          f"gradient max rel {e_s:.3e} (tol "
          f"{EV_TOL[torch.float64]['rtol']:g}, the reverse rtol)")
    check(got["K1"] > 0 and got["K2"] > 0, f"direct dose launched {got}")
    check(e_u <= F64_GRAD_TOL and max(e_p) <= F64_GRAD_TOL,
          "direct dose f64 card gradient off the CPU run")
    check(e_s <= EV_TOL[torch.float64]["rtol"],
          "direct dose off the solve gradient")
    del u0, p, gu, gp, gu_c, gp_c, gu_s, gp_s

    # the spiral at S2's setting under the Gauss direct API: the discrete
    # cost 2(u − data) at the 30 save times (against the card's solve
    # gradient under GaussAdjoint), then with g = Σu² added (card vs CPU)
    g_s, _ = spiral_gradient(P, setup_card, dict(SPIRAL_ADAPTIVE,
                                                 sensealg=P.GaussAdjoint()))
    for arm, with_g in (("S2g Gauss direct, discrete cost", False),
                        ("S2g Gauss direct, discrete cost + g = Σu²", True)):
        (g_card, sol), got = count_path(
            lambda: direct_spiral(P, setup_card, with_g))
        direct_launches[arm] = {"K3": got[0], "K4": got[1]}
        g_cpu, _ = direct_spiral(P, setup_cpu, with_g)
        errs = leaf_errors(g_card, g_cpu)
        vs = ""
        if not with_g:
            e_s = max(leaf_errors(g_card, g_s).values())
            vs = (f"; against the card's solve gradient under GaussAdjoint "
                  f"max rel L2 {e_s:.3e} (tol {SPIRAL_ADAPTIVE['rtol']:g}, "
                  "the reverse rtol)")
            check(e_s <= SPIRAL_ADAPTIVE["rtol"],
                  f"{arm} off the solve gradient")
        print(f"[direct f64] {arm}: forward {sol.stats}; K3 {got[0]} and K4 "
              f"{got[1]} launches (forward and reverse); card vs CPU rel L2 "
              f"{fmt_errors(errs)} (tol {NODE_F64_TOL:g}){vs}")
        check(max(errs.values()) <= NODE_F64_TOL,
              f"{arm}: f64 card gradient off the CPU run")

    # Lotka–Volterra's Hessian (no kernel) under DirectAdjoint and
    # GaussAdjoint, reverse over reverse: symmetric, the two agreeing
    hess = {}
    for name, sensealg in (("DirectAdjoint", P.DirectAdjoint()),
                           ("GaussAdjoint", P.GaussAdjoint())):
        H = lv_hessian(P, dev, sensealg)
        hess[name] = H
        asym = float((H - H.T).abs().max() / H.abs().max())
        print(f"[direct f64] Lotka-Volterra Hessian under {name}: "
              f"max|H - H^T| / max|H| {asym:.2e} (tol "
              f"{HESS_SYM_TOL:g}); row 0 {H[0].tolist()}")
        check(bool(torch.isfinite(H).all()) and asym <= HESS_SYM_TOL,
              f"{name} Hessian not symmetric")
    err = float((hess["GaussAdjoint"] - hess["DirectAdjoint"]).abs().max()
                / hess["DirectAdjoint"].abs().max())
    print(f"[direct f64] Lotka-Volterra Hessian, Gauss against Direct: max "
          f"rel {err:.2e} (tol {HESS_SYM_TOL:g})")
    check(err <= HESS_SYM_TOL, "Gauss Hessian off the Direct one")

    # second order through a kernel field is refused by name on the card
    n = 4096
    field = rd1d.make_rd1d_field(n, 1.0 / n)
    u0, p = flagship_inputs(n, torch.float64, dev)
    refusals = {
        "FusedRD1D": lambda: P.second_order_sensitivity_product(
            lambda sol: torch.sum(sol.ys[-1] ** 2),
            P.ODEProblem(field, u0, (0.0, STEPS * DT), p), [1.0, 0.0],
            P.Tsit5(), sensealg=P.GaussAdjoint(), saveat=[0.0, STEPS * DT],
            dt=DT, adaptive=False),
        "FusedMLP2": lambda: P.second_order_sensitivity_product(
            lambda sol: torch.sum((sol.ys - setup_card[2]) ** 2),
            P.ODEProblem(lambda u, q, t: mlp.fused_mlp2(q, u ** 3),
                         setup_card[1], (0.0, SPIRAL_T1), setup_card[0]),
            torch.ones(sum(v.numel() for v in setup_card[0].values()),
                       dtype=torch.float64), P.Tsit5(),
            sensealg=P.DirectAdjoint(), saveat=setup_card[3],
            dt=SPIRAL_T1 / (SPIRAL_NT - 1), adaptive=False, unroll=True)}
    for name, fn in refusals.items():
        try:
            fn()
        except DoubleBackwardUnsupported as e:
            check(name in str(e), f"the refusal does not name {name}: {e}")
            print(f"[direct f64] second order through {name} on the card "
                  f"raises DoubleBackwardUnsupported: {str(e)[:60]}...")
        else:
            raise AssertionError(f"second order through {name} returned")
    del u0, p
    print(f"[direct f64] phase 5g: {time.perf_counter() - t:.1f} s")
    elapsed("phase 5g [direct f64]")

    # -- 5h. [unroll f64]: the unrolled continuous rules and GBS -------------
    # unroll=True runs the while driver's eager loop with the masked scan's
    # budget, so every arm should equal its rule's while driver bit for bit
    t = time.perf_counter()
    unroll_launches = {}
    for rule in ("GaussAdjoint", "BacksolveAdjoint"):
        name = f"S2u {rule} unroll"
        kw_u = dict(UNROLL_SPIRAL, sensealg=getattr(P, rule)(), unroll=True)
        kw_w = dict(UNROLL_SPIRAL, sensealg=getattr(P, rule)())
        (g_u, sol), got = count_path(lambda: spiral_gradient(P, setup_card,
                                                             kw_u))
        g_w, sol_w = spiral_gradient(P, setup_card, kw_w)
        g_c, sol_c = spiral_gradient(P, setup_cpu, kw_u)
        diff = max(float((g_u[k] - g_w[k]).abs().max()) for k in g_u)
        errs = leaf_errors(g_u, g_c)
        unroll_launches[name] = {"K3": got[0], "K4": got[1]}
        print(f"[unroll f64] {name}: forward {sol.stats} (while {sol_w.stats})"
              f"; reverse {sol.adjoint.stats}; against the while driver max "
              f"|diff| {diff:.3e} (bit for bit: 0); card vs CPU rel L2 "
              f"{fmt_errors(errs)} (tol {NODE_F64_TOL:g}); K3 {got[0]} and K4 "
              f"{got[1]} launches per gradient")
        check(sol.retcode == 0 and sol_w.retcode == 0 and sol_c.retcode == 0,
              f"{name} retcode")
        check(sol.stats.n_accepted == sol_w.stats.n_accepted,
              f"{name} took other steps than its while driver")
        check(diff == 0.0, f"{name} differs from its while driver")
        check(max(errs.values()) <= NODE_F64_TOL,
              f"{name}: f64 card gradient off the CPU run")
    # the dosed PDE (phase 5f's f64 arm) under Backsolve and the adaptive
    # Interpolating reverse, which unroll runs instead of the pinned one
    n = EV_N[torch.float64]
    field = rd1d.make_rd1d_field(n, 1.0 / n)
    for rule, while_alg in (("BacksolveAdjoint", P.BacksolveAdjoint()),
                            ("InterpolatingAdjoint",
                             P.InterpolatingAdjoint(pinned_reverse=False))):
        name = f"PDE dose {rule} unroll"
        extra = dict(unroll=True, max_steps=UNROLL_DOSE_MAX_STEPS)
        u0, p = flagship_inputs(n, torch.float64, dev)
        rd1d.rd1d_fwd_cuda.launches = 0
        rd1d.rd1d_vjp_cuda.launches = 0
        gu, gp, sol = dose_gradient(P, field, u0, p, getattr(P, rule)(),
                                    **extra)
        torch.cuda.synchronize()
        got = {"K1": rd1d.rd1d_fwd_cuda.launches,
               "K2": rd1d.rd1d_vjp_cuda.launches}
        unroll_launches[name] = got
        gu_w, gp_w, sol_w = dose_gradient(P, field, u0, p, while_alg,
                                          max_steps=UNROLL_DOSE_MAX_STEPS)
        u0c, pc = flagship_inputs(n, torch.float64, "cpu")
        gu_c, gp_c, sol_c = dose_gradient(P, field, u0c, pc,
                                          getattr(P, rule)(), **extra)
        diff = max(float((gu - gu_w).abs().max()),
                   float((gp - gp_w).abs().max()))
        e_u = rel_l2(gu, gu_c)
        e_p = ((gp.cpu() - gp_c).abs() / gp_c.abs()).tolist()
        print(f"[unroll f64] {name} n={n}: forward {sol.stats}, "
              f"{sol.events.count} dose; reverse {sol.adjoint.stats} "
              f"({sol.adjoint.reverse}); against the while driver max |diff| "
              f"{diff:.3e} (bit for bit: 0); card vs CPU u0-grad rel L2 "
              f"{e_u:.3e}, dD rel {e_p[0]:.3e}, dk rel {e_p[1]:.3e} (tol "
              f"{F64_GRAD_TOL:g}); K1 {got['K1']} and K2 {got['K2']} launches "
              f"per gradient")
        check(sol.retcode == 0 and sol_w.retcode == 0 and sol_c.retcode == 0,
              f"{name} retcode")
        check(sol.events.count == 1 == sol_c.events.count,
              f"{name}: {sol.events.count} doses")
        check(got["K1"] > 0 and got["K2"] > 0,
              f"{name} did not launch K1 and K2: {got}")
        check(diff == 0.0, f"{name} differs from its while driver")
        check(e_u <= F64_GRAD_TOL and max(e_p) <= F64_GRAD_TOL,
              f"{name}: f64 card gradient off the CPU run")
    del u0, p, gu, gp, gu_w, gp_w, u0c, pc, gu_c, gp_c
    # GBS as the forward and reverse stepper: Backsolve through K3/K4 on
    # the card and the CPU, ForwardDiffSensitivity through the plain MLP
    gbs_kw = dict(GBS_SPIRAL, sensealg=P.BacksolveAdjoint(),
                  bwd_solver=P.GBS())
    (g_g, sol), got = count_path(lambda: spiral_gradient(
        P, setup_card, gbs_kw, solver=P.GBS()))
    unroll_launches["S2g GBS BacksolveAdjoint"] = {"K3": got[0], "K4": got[1]}
    g_gc, sol_c = spiral_gradient(P, setup_cpu, gbs_kw, solver=P.GBS())
    g_f, sol_f = spiral_gradient(
        P, setup_card, dict(GBS_SPIRAL, sensealg=P.ForwardDiffSensitivity()),
        solver=P.GBS(), plain=True)
    errs = leaf_errors(g_g, g_gc)
    rule_err = max(float((g_g[k] - g_f[k]).abs().max() / g_f[k].abs().max())
                   for k in g_f)
    print(f"[unroll f64] S2g GBS(levels=4) BacksolveAdjoint (rtol "
          f"{GBS_SPIRAL['rtol']:g}): forward {sol.stats}; reverse "
          f"{sol.adjoint.stats}; card vs CPU rel L2 {fmt_errors(errs)} (tol "
          f"{NODE_F64_TOL:g}); against ForwardDiffSensitivity on the plain "
          f"MLP (forward {sol_f.stats}) max |diff| / max|leaf| {rule_err:.3e} "
          f"(tol {GBS_TOL:g}); K3 {got[0]} and K4 {got[1]} launches")
    check(sol.retcode == 0 and sol_c.retcode == 0 and sol_f.retcode == 0,
          "S2g GBS retcode")
    check(max(errs.values()) <= NODE_F64_TOL,
          "S2g GBS: f64 card gradient off the CPU run")
    check(rule_err <= GBS_TOL, "S2g GBS Backsolve off ForwardDiffSensitivity")
    # F1's save-time case on the card (no kernel)
    g_t, sol = f1_saveat_gradient(P, dev)
    ref = f1_closed_form(F1_SV)
    err = max(abs(a - b) for a, b in zip(g_t.tolist(), ref))
    print(f"[unroll f64] F1 u' = -a u + sin(3t) DirectAdjoint dL/dt_i "
          f"{[round(v, 6) for v in g_t.tolist()]}, closed form "
          f"{[round(v, 6) for v in ref]}: max |diff| {err:.3e} (tol "
          f"{F1_TOL:g}); forward {sol.stats}")
    check(sol.retcode == 0 and err <= F1_TOL,
          "F1 DirectAdjoint save-time gradient off the closed form")
    print(f"[unroll f64] phase 5h: {time.perf_counter() - t:.1f} s")
    elapsed("phase 5h [unroll f64]")

    # -- 5i. [stiff f64]: the stiff solvers and the nonlinear solve (host
    # path: no kernel; torch.linalg on the card) -----------------------------
    t = time.perf_counter()
    g_fb, sol_fb = rob_bench(P, dev, P.FBDF(), P.GaussAdjoint(), ROB_BENCH)
    g_fbc, sol_fbc = rob_bench(P, "cpu", P.FBDF(), P.GaussAdjoint(),
                               ROB_BENCH)
    g_or, sol_or = rob_bench(P, dev, P.Rosenbrock23(),
                             P.ForwardDiffSensitivity(), ROB_ORACLE)
    same = (sol_fb.stats.n_accepted == sol_fbc.stats.n_accepted
            and sol_fb.adjoint.stats.n_accepted
            == sol_fbc.adjoint.stats.n_accepted)
    e_c = max_rel(g_fb, g_fbc)
    gate = bool(torch.allclose(g_fb.cpu(), g_or.cpu(), **STIFF_GATE))
    print(f"[stiff f64] Robertson FBDF GaussAdjoint (bench setting): forward "
          f"{sol_fb.stats} (CPU {sol_fbc.stats}); reverse "
          f"{sol_fb.adjoint.stats} (CPU {sol_fbc.adjoint.stats}); p-grad "
          f"{g_fb.tolist()}; card vs CPU max rel {e_c:.3e} (tol "
          f"{F64_GRAD_TOL:g} where the step counts agree: {same}); against "
          f"Rosenbrock23 ForwardDiffSensitivity at rtol "
          f"{ROB_ORACLE['rtol']:g} ({g_or.tolist()}, forward "
          f"{sol_or.stats}): max rel {max_rel(g_fb, g_or):.3e} (allclose "
          f"rtol {STIFF_GATE['rtol']:g} atol {STIFF_GATE['atol']:g}: {gate})")
    check(sol_fb.retcode == 0 and sol_fbc.retcode == 0
          and sol_or.retcode == 0, "Robertson FBDF retcode")
    check(not same or e_c <= F64_GRAD_TOL,
          "Robertson FBDF card gradient off the CPU run")
    check(gate, "Robertson FBDF GaussAdjoint off ForwardDiffSensitivity")
    g_ri, sol_ri = rob_transient(P, dev, P.InterpolatingAdjoint())
    g_ric, sol_ric = rob_transient(P, "cpu", P.InterpolatingAdjoint())
    g_rf, sol_rf = rob_transient(P, dev, P.ForwardDiffSensitivity())
    same = (sol_ri.stats.n_accepted == sol_ric.stats.n_accepted
            and sol_ri.adjoint.stats.n_accepted
            == sol_ric.adjoint.stats.n_accepted)
    e_c = max_rel(g_ri, g_ric)
    gate = bool(torch.allclose(g_ri.cpu(), g_rf.cpu(), **STIFF_GATE))
    print(f"[stiff f64] Robertson transient Rosenbrock23 InterpolatingAdjoint:"
          f" forward {sol_ri.stats} (CPU {sol_ric.stats}); reverse "
          f"{sol_ri.adjoint.stats} ({sol_ri.adjoint.reverse}; CPU "
          f"{sol_ric.adjoint.stats}); log p-grad {g_ri.tolist()}; card vs CPU "
          f"max rel {e_c:.3e} (tol {F64_GRAD_TOL:g} where the step counts "
          f"agree: {same}); against ForwardDiffSensitivity "
          f"{g_rf.tolist()}: max rel {max_rel(g_ri, g_rf):.3e} (allclose "
          f"rtol {STIFF_GATE['rtol']:g} atol {STIFF_GATE['atol']:g}: {gate})")
    check(sol_ri.retcode == 0 and sol_ric.retcode == 0
          and sol_rf.retcode == 0, "Robertson Rosenbrock23 retcode")
    check(not same or e_c <= F64_GRAD_TOL,
          "Robertson Rosenbrock23 card gradient off the CPU run")
    check(gate, "Robertson Rosenbrock23 Interpolating off ForwardDiff")
    # time derivatives through the stiff steppers: ForwardDiffSensitivity
    # replays FBDF with its history's tangents, held to FBDF's Gauss
    # gradient above; DirectAdjoint differentiates Rosenbrock23's steps in
    # their lengths through a saveat tensor
    wall_s = time.perf_counter()
    g_ff, sol_ff = rob_bench(P, dev, P.FBDF(), P.ForwardDiffSensitivity(),
                             ROB_BENCH)
    wall_s = time.perf_counter() - wall_s
    g_ffc, sol_ffc = rob_bench(P, "cpu", P.FBDF(),
                               P.ForwardDiffSensitivity(), ROB_BENCH)
    same = sol_ff.stats.n_accepted == sol_ffc.stats.n_accepted
    e_c = rel_l2(g_ff, g_ffc)
    gate = bool(torch.allclose(g_ff.cpu(), g_fb.cpu(), **STIFF_GATE))
    print(f"[stiff f64] Robertson FBDF ForwardDiffSensitivity (bench "
          f"setting): card wall {wall_s:.3f} s; forward {sol_ff.stats} (CPU "
          f"{sol_ffc.stats}); p-grad {g_ff.tolist()}; card vs CPU rel L2 "
          f"{e_c:.3e} (tol {F64_GRAD_TOL:g} where the step counts agree: "
          f"{same}); against FBDF GaussAdjoint: max rel "
          f"{max_rel(g_ff, g_fb):.3e} (allclose rtol {STIFF_GATE['rtol']:g} "
          f"atol {STIFF_GATE['atol']:g}: {gate})")
    check(sol_ff.retcode == 0 and sol_ffc.retcode == 0,
          "Robertson FBDF ForwardDiff retcode")
    check(e_c <= F64_GRAD_TOL if same else bool(torch.allclose(
        g_ff.cpu(), g_ffc, **STIFF_GATE)),
        "Robertson FBDF ForwardDiff card gradient off the CPU run")
    check(gate, "Robertson FBDF ForwardDiff off FBDF GaussAdjoint")
    wall_s = time.perf_counter()
    g_rd, sol_rd = rob_transient(P, dev, P.DirectAdjoint(), ROB_R23_SV,
                                 save_grad=True)
    wall_s = time.perf_counter() - wall_s
    g_rdc, sol_rdc = rob_transient(P, "cpu", P.DirectAdjoint(), ROB_R23_SV,
                                   save_grad=True)
    same = sol_rd.stats.n_accepted == sol_rdc.stats.n_accepted
    e_c = rel_l2(g_rd, g_rdc)
    print(f"[stiff f64] Robertson transient Rosenbrock23 DirectAdjoint "
          f"through a saveat tensor {ROB_R23_SV}: card wall {wall_s:.3f} s; "
          f"forward {sol_rd.stats} (CPU {sol_rdc.stats}); grad [log p, "
          f"saveat] {g_rd.tolist()}; card vs CPU rel L2 {e_c:.3e} (tol "
          f"{F64_GRAD_TOL:g} where the step counts agree: {same})")
    check(sol_rd.retcode == 0 and sol_rdc.retcode == 0
          and bool(torch.isfinite(g_rd).all()),
          "Robertson Rosenbrock23 DirectAdjoint retcode")
    check(e_c <= F64_GRAD_TOL if same else bool(torch.allclose(
        g_rd.cpu(), g_rdc, **STIFF_GATE)),
        "Robertson Rosenbrock23 DirectAdjoint card gradient off the CPU run")
    # the nonlinear solve: IFT gradient against central differences
    g_nl, sol_nl = nl_solve(P, dev)
    g_nlc, _ = nl_solve(P, "cpu")
    p_nl = torch.linspace(0.1, 0.5, 4, dtype=torch.float64, device=dev)
    fd = []
    for i in range(4):
        e = torch.zeros_like(p_nl)
        e[i] = NL_H
        fd.append((float(nl_solve(P, dev, p_nl + e, grad=False)[0])
                   - float(nl_solve(P, dev, p_nl - e, grad=False)[0]))
                  / (2 * NL_H))
    fd = torch.tensor(fd, dtype=torch.float64)
    e_fd = float((g_nl.cpu() - fd).abs().max() / fd.abs().max())
    e_c = rel_l2(g_nl, g_nlc)
    print(f"[stiff f64] solve_nonlinear (bench.py:318 residual, 8 unknowns): "
          f"retcode {sol_nl.retcode}, {sol_nl.iters} Newton iterations, "
          f"residual {float(sol_nl.resid):.3e}; IFT p-grad {g_nl.tolist()}; "
          f"against central differences (h {NL_H:g}) max |diff| / max "
          f"{e_fd:.3e} (tol {NL_FD_TOL:g}); card vs CPU rel L2 {e_c:.3e} "
          f"(tol {F64_GRAD_TOL:g})")
    check(sol_nl.retcode == 0 and e_fd <= NL_FD_TOL
          and e_c <= F64_GRAD_TOL, "solve_nonlinear gradient")
    # a stiff step takes ∂f/∂u by forward mode, which the kernel refuses
    from scimlsensitivity_jl_tpu_torch.ops.vjp import ForwardModeUnsupported

    n = EV_N[torch.float64]
    field = rd1d.make_rd1d_field(n, 1.0 / n)
    u0, p = flagship_inputs(n, torch.float64, dev)
    for solver in (P.Rosenbrock23(), P.FBDF()):
        try:
            P.solve(P.ODEProblem(field, u0, (0.0, STEPS * DT), p), solver,
                    dt0=DT, sensealg=P.GaussAdjoint(), max_steps=4)
        except ForwardModeUnsupported as err:
            print(f"[stiff f64] {solver!r} on the PDE kernel field raises "
                  f"ForwardModeUnsupported: {str(err)[:70]}...")
        else:
            raise AssertionError(f"{solver!r} on the kernel field did not "
                                 "raise ForwardModeUnsupported")
    del u0, p
    print(f"[stiff f64] phase 5i: {time.perf_counter() - t:.1f} s")
    elapsed("phase 5i [stiff f64]")

    # -- 5j. [dae f64]: DAEs on mass matrices (host path, torch.linalg on the
    # card), the card against the port's CPU run ---------------------------
    t = time.perf_counter()
    # (sensealg, solver, rotated, with dae_crossing)
    dae_arms = {
        "sensealg=None": (None, P.SDIRK4, False, False),
        "DirectAdjoint": (P.DirectAdjoint(), P.SDIRK4, False, False),
        "InterpolatingAdjoint": (P.InterpolatingAdjoint(), P.SDIRK4, False,
                                 False),
        "GaussAdjoint": (P.GaussAdjoint(), P.SDIRK4, False, False),
        "QuadratureAdjoint": (P.QuadratureAdjoint(), P.SDIRK4, False, False),
        "FBDF GaussAdjoint": (P.GaussAdjoint(), P.FBDF, False, False),
        "rotated GaussAdjoint": (P.GaussAdjoint(), P.SDIRK4, True, False),
        "rotated event ForwardDiffSensitivity": (
            P.ForwardDiffSensitivity(), P.SDIRK4, True, True),
    }
    dae_grads = {}
    for arm, (sensealg, solver, rotated, event) in dae_arms.items():
        g_cpu, sol_c = dae_gradient(P, "cpu", sensealg, solver(), rotated,
                                    event=event)
        wall_s = time.perf_counter()
        g, sol = dae_gradient(P, dev, sensealg, solver(), rotated,
                              event=event)
        wall_s = time.perf_counter() - wall_s
        dae_grads[arm] = g
        rev = sol.adjoint.stats if sol.adjoint is not None else None
        rev_c = sol_c.adjoint.stats if sol_c.adjoint is not None else None
        same = (sol.stats.n_accepted == sol_c.stats.n_accepted
                and (rev is None or rev.n_accepted == rev_c.n_accepted))
        e_c = rel_l2(g, g_cpu)
        print(f"[dae f64] Robertson{' rotated' if rotated else ''} "
              f"{solver.__name__} {arm}: dispatched to "
              f"{type(sol.sensealg).__name__}; card wall {wall_s:.3f} s; "
              f"forward {sol.stats} (CPU {sol_c.stats}); events "
              f"{None if sol.events is None else sol.events.count}; reverse "
              f"{rev} (CPU {rev_c}); grad [log p, "
              f"u0_d] {g.tolist()}; card vs CPU rel L2 {e_c:.3e} (tol "
              f"{F64_GRAD_TOL:g} where the step counts agree: {same})")
        check(sol.retcode == 0 and sol_c.retcode == 0
              and (rev is None or rev.retcode == 0), f"DAE {arm} retcode")
        # cuSOLVER's LU against LAPACK's may move a stiff step (ROADMAP §3):
        # then the stiff gate holds the card to the CPU run
        check(e_c <= F64_GRAD_TOL if same else bool(torch.allclose(
            g.cpu(), g_cpu, **STIFF_GATE)),
            f"DAE {arm}: card gradient off the CPU's")
        if event:
            check(sol.events.count == 1 and sol_c.events.count == 1,
                  f"DAE {arm}: the event did not fire once")
        if sensealg is None:
            check(type(sol.sensealg) is P.ForwardDiffSensitivity,
                  f"DAE sensealg=None dispatched to {sol.sensealg!r}")
    for arm, ref in (("InterpolatingAdjoint", "sensealg=None"),
                     ("GaussAdjoint", "sensealg=None"),
                     ("QuadratureAdjoint", "sensealg=None"),
                     ("DirectAdjoint", "sensealg=None"),
                     ("FBDF GaussAdjoint", "sensealg=None")):
        gate = bool(torch.allclose(dae_grads[arm].cpu(),
                                   dae_grads[ref].cpu(), rtol=DAE_RULE_TOL,
                                   atol=1e-7))
        print(f"[dae f64] {arm} against ForwardDiffSensitivity ({ref}): max "
              f"rel {max_rel(dae_grads[arm], dae_grads[ref]):.3e} (allclose "
              f"rtol {DAE_RULE_TOL:g}, atol 1e-7: {gate})")
        check(gate, f"DAE {arm} off ForwardDiffSensitivity")
    # GaussAdjoint through the event on the card, held to ForwardDiff at
    # the JAX test's rtol (tests/test_dae.py:382)
    wall_s = time.perf_counter()
    g, sol = dae_gradient(P, dev, P.GaussAdjoint(), P.SDIRK4(), True,
                          event=True)
    wall_s = time.perf_counter() - wall_s
    ref = dae_grads["rotated event ForwardDiffSensitivity"]
    gate = bool(torch.allclose(g.cpu(), ref.cpu(), rtol=DAE_RULE_TOL,
                               atol=0.0))
    print(f"[dae f64] Robertson rotated SDIRK4 event GaussAdjoint: card "
          f"wall {wall_s:.3f} s; forward {sol.stats}; events "
          f"{sol.events.count}; reverse {sol.adjoint.stats}; grad [log p, "
          f"u0_d] {g.tolist()}; "
          f"against ForwardDiffSensitivity: max rel {max_rel(g, ref):.3e} "
          f"(allclose rtol {DAE_RULE_TOL:g}, atol 0: {gate})")
    check(sol.retcode == 0 and sol.adjoint.stats.retcode == 0
          and sol.events.count == 1 and gate,
          "DAE event GaussAdjoint off ForwardDiffSensitivity")
    g_in, sol_in = dae_init_gradient(P, dev)
    g_inc, _ = dae_init_gradient(P, "cpu")
    exact = torch.tensor(dae_init_exact(), dtype=torch.float64)
    e_x = max_rel(g_in, exact)
    e_c = rel_l2(g_in, g_inc)
    print(f"[dae f64] dae_init=\"newton\" (y' = -y, 0 = z - p y², z0 = 0) "
          f"ForwardDiffSensitivity: forward {sol_in.stats}; grad [y0, p] "
          f"{g_in.tolist()}, closed form {exact.tolist()}: max rel "
          f"{e_x:.3e} (tol {DAE_INIT_TOL:g}); card vs CPU rel L2 {e_c:.3e} "
          f"(tol {F64_GRAD_TOL:g})")
    check(sol_in.retcode == 0 and e_x <= DAE_INIT_TOL
          and e_c <= F64_GRAD_TOL, "dae_init gradient")
    # the spiral's field under an invertible mass: folded in once, K3/K4
    # on every stage of the forward and of the Gauss reverse
    dae_launches = {}
    kw = spiral_mass_kw(P, dict(SPIRAL_ADAPTIVE, sensealg=P.GaussAdjoint()))
    (g, sol), got = count_path(lambda: spiral_mass_gradient(P, setup_card, kw))
    dae_launches["S2m invertible-mass GaussAdjoint"] = {"K3": got[0],
                                                        "K4": got[1]}
    g_c, _ = spiral_mass_gradient(P, setup_cpu, kw)
    errs = leaf_errors(g, g_c)
    print(f"[dae f64] S2m spiral (S2 setting) under the invertible mass "
          f"{SPIRAL_MASS} GaussAdjoint: forward {sol.stats}; reverse "
          f"{sol.adjoint.stats}; card vs CPU rel L2 {fmt_errors(errs)} (tol "
          f"{NODE_F64_TOL:g}); K3 {got[0]} and K4 {got[1]} launches per "
          f"gradient")
    check(sol.retcode == 0 and sol.adjoint.stats.retcode == 0, "S2m retcode")
    check(max(errs.values()) <= NODE_F64_TOL, "S2m card gradient off the CPU")
    # a singular mass on the kernel field: the stiff stepper's Jacobians
    # take forward mode, refused before anything launches
    from scimlsensitivity_jl_tpu_torch.ops.vjp import ForwardModeUnsupported

    mlp.mlp2_fwd_cuda.launches = 0
    mlp.mlp2_vjp_cuda.launches = 0
    _, u0s, _, _ = setup_card
    try:
        P.solve(P.ODEProblem(
            lambda u, p, t: mlp.fused_mlp2(p, u ** 3), u0s, (0.0, 0.1),
            setup_card[0], mass_matrix=torch.diag(torch.tensor([1.0, 0.0]))),
            P.SDIRK4(), dt0=1e-3, sensealg=P.GaussAdjoint())
    except ForwardModeUnsupported as err:
        refusal = str(err)
    else:
        raise AssertionError("a DAE on the kernel field did not raise")
    got = (mlp.mlp2_fwd_cuda.launches, mlp.mlp2_vjp_cuda.launches)
    print(f"[dae f64] a DAE on the spiral's kernel field raises "
          f"ForwardModeUnsupported after K3 {got[0]} and K4 {got[1]} "
          f"launches: {refusal[:70]}...")
    check(got == (0, 0) and "FusedMLP2" in refusal,
          "the DAE kernel-field refusal launched or did not name FusedMLP2")
    print(f"[dae f64] phase 5j: {time.perf_counter() - t:.1f} s")
    elapsed("phase 5j [dae f64]")

    # -- 5k. [dde]: the method of steps at S4's width, K3/K4 in every stage
    # and its pullback ------------------------------------------------------
    t = time.perf_counter()
    dde_launches = {}
    dde32 = dde_setup(P, torch.float32, dev)
    dde_full = {}
    for arm, adaptive in (("RK4 dt 1/64", False),
                          ("Tsit5 rtol 1e-6", True)):
        (g, sol), got = count_path(lambda: dde_gradient(P, dde32, adaptive))
        dde_launches[f"DDE S4 f32 {arm}"] = {"K3": got[0], "K4": got[1]}
        dde_full[arm] = g
        print(f"[dde f32] u'(t) = mlp2(u(t - {DDE_TAU})) at S4's width "
              f"(B = {S4_B}, {S4_WIDTHS}) {arm}: {sol.solver}, {sol.stats}; "
              f"K3 {got[0]} and K4 {got[1]} launches per gradient, routes "
              f"{path_routes}; max|grad| per leaf "
              f"{ {k: float(v.abs().max()) for k, v in g.items()} }")
        check(sol.retcode == 0, f"DDE {arm} retcode {sol.retcode}")
        check(all(bool(torch.isfinite(v).all()) for v in g.values()),
              f"DDE {arm}: non-finite gradient")
        check(path_routes["K3"] == {"simt": got[0]},
              f"DDE {arm}: K3 off the simt route: {path_routes}")
    cross = max(rel_l2(dde_full["RK4 dt 1/64"][k],
                       dde_full["Tsit5 rtol 1e-6"][k]) for k in dde_full[
        "RK4 dt 1/64"])
    print(f"[dde f32] RK4 against Tsit5 at full width: max rel L2 per leaf "
          f"{cross:.3e} (tol {DDE_CROSS_TOL:g})")
    check(cross <= DDE_CROSS_TOL, "DDE RK4 and Tsit5 gradients disagree")
    del dde_full
    for arm, adaptive in (("RK4 dt 1/64", False),
                          ("Tsit5 rtol 1e-6", True)):
        (g, sol), got = count_path(lambda: dde_gradient(
            P, dde_setup(P, torch.float64, dev, B=DDE_B_CPU), adaptive))
        dde_launches[f"DDE B={DDE_B_CPU} f64 {arm}"] = {"K3": got[0],
                                                        "K4": got[1]}
        g_c, sol_c = dde_gradient(
            P, dde_setup(P, torch.float64, "cpu", B=DDE_B_CPU), adaptive)
        errs = leaf_errors(g, g_c)
        print(f"[dde f64] B = {DDE_B_CPU} {arm}: {sol.stats} (CPU "
              f"{sol_c.stats}); card vs CPU rel L2 {fmt_errors(errs)} (tol "
              f"{F64_GRAD_TOL:g}); K3 {got[0]} and K4 {got[1]} launches")
        check(sol.retcode == 0 and sol.stats == sol_c.stats,
              f"DDE B={DDE_B_CPU} {arm}: retcode or steps off the CPU's")
        check(max(errs.values()) <= F64_GRAD_TOL,
              f"DDE B={DDE_B_CPU} {arm}: card gradient off the CPU's")
    # tests/test_dde.py's stiff case: TRBDF2 through its Newton sweeps
    y_tr, sol_tr = dde_stiff(P, dev, True)
    y_trc, _ = dde_stiff(P, "cpu", True)
    y_ref, _ = dde_stiff(P, dev, False)
    e_c = abs(float(y_tr) - float(y_trc)) / abs(float(y_trc))
    e_r = abs(float(y_tr) - float(y_ref)) / abs(float(y_ref))
    print(f"[dde f64] stiff u' = -{DDE_STIFF['A']:g}(u - sin 2πt) + "
          f"{DDE_STIFF['B']:g} u(t - 1) on (0, {DDE_STIFF['t1']:g}): TRBDF2 "
          f"at dt {DDE_STIFF['dt']:g} u(t1) {float(y_tr):.10f} ({sol_tr.stats}); "
          f"card vs CPU rel {e_c:.3e} (tol {F64_GRAD_TOL:g}); against RK4 at "
          f"dt {DDE_STIFF['ref_dt']:g} rel {e_r:.3e} (tol 5e-2, "
          f"tests/test_dde.py)")
    check(e_c <= F64_GRAD_TOL and e_r <= 5e-2, "stiff DDE TRBDF2")
    mlp.mlp2_fwd_cuda.launches = 0
    for solver_kw in (dict(dt=DDE_DT), {}):
        try:
            P.solve(P.DDEProblem(lambda u, h, p, t: mlp.fused_mlp2(p, h[0]),
                                 dde32[1], (0.0, 1.0), dde32[0],
                                 lags=(DDE_TAU,)), P.TRBDF2(), **solver_kw)
        except ForwardModeUnsupported as err:
            refusal = str(err)
        else:
            raise AssertionError("TRBDF2 on the kernel field did not raise")
    print(f"[dde f32] TRBDF2 (fixed and adaptive) on the kernel field raises "
          f"ForwardModeUnsupported after {mlp.mlp2_fwd_cuda.launches} K3 "
          f"launches: {refusal[:70]}...")
    check(mlp.mlp2_fwd_cuda.launches == 0 and "FusedMLP2" in refusal,
          "the stiff DDE kernel-field refusal launched or did not name it")
    print(f"[dde] phase 5k: {time.perf_counter() - t:.1f} s")
    elapsed("phase 5k [dde]")

    # -- 5l. [nsde]: the neural SDE at S4's width, K3 in every drift and
    # diffusion evaluation, K4 in every pullback -----------------------------
    t = time.perf_counter()
    steps = round(1.0 / SDE_DT)
    key32 = P.PRNGKey(SEED)
    # per forward step 2 K3 (drift, diffusion); per gradient: DirectAdjoint
    # the forward's and their pullbacks; Interpolating the forward's and
    # one step-map vjp per step (2 K3 + 2 K4); Backsolve the forward's and
    # per step 6 Picard step maps and the vjp (14 K3 + 2 K4)
    nsde_want = {"DirectAdjoint": (2 * steps, 2 * steps),
                 "InterpolatingAdjoint": (4 * steps, 2 * steps),
                 "BacksolveAdjoint": (16 * steps, 2 * steps)}
    nsde_launches = {}
    nsde32 = nsde_setup(P, torch.float32, dev)
    for w in wrappers:
        w.launches = 0
    y_a = nsde_forward(P, nsde32, key32)
    torch.cuda.synchronize()
    got = tuple(w.launches for w in wrappers)
    y_b = nsde_forward(P, nsde32, key32)
    print(f"[nsde f32] neural SDE at S4's width (B = {S4_B}, {S4_WIDTHS}, "
          f"EulerMaruyama dt 1/{steps}) forward: K3 {got[0]} and K4 {got[1]} "
          f"launches (expected {2 * steps} and 0); a second call on the same "
          f"key equal bit for bit: {bool(torch.equal(y_a, y_b))}")
    check(got == (2 * steps, 0), f"neural SDE forward launched {got}")
    check(torch.equal(y_a, y_b), "the same key drew other noise")
    nsde_full = {}
    for rule in SDE_RULES:
        (g, sol), got = count_path(lambda: nsde_gradient(
            P, nsde32, getattr(P, rule)(), key32))
        nsde_launches[f"NSDE S4 f32 {rule}"] = {"K3": got[0], "K4": got[1]}
        nsde_full[rule] = g
        print(f"[nsde f32] {rule}: {sol.stats}; K3 {got[0]} and K4 {got[1]} "
              f"launches per gradient (expected {nsde_want[rule]}), routes "
              f"{path_routes}; max|grad| per leaf "
              f"{ {k: float(v.abs().max()) for k, v in g.items()} }")
        check(got == nsde_want[rule], f"neural SDE {rule} launched {got}")
        check(path_routes["K3"] == {"simt": got[0]},
              f"neural SDE {rule}: K3 off the simt route")
        check(all(bool(torch.isfinite(v).all()) for v in g.values()),
              f"neural SDE {rule}: non-finite gradient")
    e_i = max(rel_l2(nsde_full["InterpolatingAdjoint"][k],
                     nsde_full["DirectAdjoint"][k]) for k in nsde_full[
        "DirectAdjoint"])
    e_b = max(rel_l2(nsde_full["BacksolveAdjoint"][k],
                     nsde_full["DirectAdjoint"][k]) for k in nsde_full[
        "DirectAdjoint"])
    print(f"[nsde f32] against DirectAdjoint, max rel L2 per leaf: "
          f"Interpolating {e_i:.3e} (tol {SDE_INTERP_TOL[torch.float32]:g}), "
          f"Backsolve {e_b:.3e} (tol {SDE_BACKSOLVE_TOL:g}, the JAX "
          f"package's tests/test_sde.py)")
    check(e_i <= SDE_INTERP_TOL[torch.float32]
          and e_b <= SDE_BACKSOLVE_TOL, "neural SDE rules disagree")
    del nsde_full
    # B = 8 float64 through the numpy-backed key: the same path on both
    nsde_card = nsde_setup(P, torch.float64, dev, B=SDE_B_CPU)
    nsde_cpu = nsde_setup(P, torch.float64, "cpu", B=SDE_B_CPU)
    for rule in SDE_RULES:
        (g, sol), got = count_path(lambda: nsde_gradient(
            P, nsde_card, getattr(P, rule)(), P.NumpyKey(SEED)))
        nsde_launches[f"NSDE B={SDE_B_CPU} f64 {rule}"] = {"K3": got[0],
                                                            "K4": got[1]}
        g_c, _ = nsde_gradient(P, nsde_cpu, getattr(P, rule)(),
                               P.NumpyKey(SEED))
        errs = leaf_errors(g, g_c)
        print(f"[nsde f64] B = {SDE_B_CPU} {rule}: card vs CPU rel L2 "
              f"{fmt_errors(errs)} (tol {F64_GRAD_TOL:g}); K3 {got[0]} and "
              f"K4 {got[1]} launches")
        check(max(errs.values()) <= F64_GRAD_TOL,
              f"neural SDE B={SDE_B_CPU} {rule}: card gradient off the CPU's")
    # the schemes that differentiate the kernel diffusion (or the drift) by
    # forward mode refuse before anything launches
    for w in wrappers:
        w.launches = 0
    refused = []
    for name, solver, kw in (
            ("Milstein", P.Milstein(), None),
            ("RKMilGeneral", P.RKMilGeneral(), None),
            ("StrongTaylor15", P.StrongTaylor15(), None),
            ("ImplicitEM", P.ImplicitEM(), None),
            ("EulerHeun (Itô drift transform)", P.EulerHeun(), None),
            ("adaptive Milstein", P.Milstein(), dict(rtol=1e-3, atol=1e-6))):
        try:
            nsde_solve(P, nsde32, nsde32[0], None, key32, solver=solver,
                       **(kw or {}))
        except ForwardModeUnsupported as err:
            refused.append(name)
            check("FusedMLP2" in str(err), f"{name}: refusal unnamed")
        else:
            raise AssertionError(f"{name} on the kernel field did not raise")
    got = tuple(w.launches for w in wrappers)
    print(f"[nsde f32] {', '.join(refused)} on the kernel fields raise "
          f"ForwardModeUnsupported after K3 {got[0]} and K4 {got[1]} launches")
    check(got == (0, 0), "an SDE kernel-field refusal launched a kernel")
    del nsde_card, nsde_cpu
    print(f"[nsde] phase 5l: {time.perf_counter() - t:.1f} s")
    elapsed("phase 5l [nsde]")

    # -- 5m. [fkpp]: the stochastic Fisher–KPP field, K1 in every drift
    # evaluation, K2 in every pullback; its RODE form; the adaptive arm ------
    t = time.perf_counter()
    fk_want = {"DirectAdjoint": (STEPS, STEPS),
               "InterpolatingAdjoint": (2 * STEPS, STEPS),
               "BacksolveAdjoint": (8 * STEPS, STEPS)}
    fk_launches = {}
    n = SIZES[1]
    field = rd1d.make_rd1d_field(n, 1.0 / n)
    u0, p = flagship_inputs(n, torch.float32, dev)
    for rode in (False, True):
        arm = "RODE" if rode else "SDE"
        rd1d.rd1d_fwd_cuda.launches = 0
        rd1d.rd1d_vjp_cuda.launches = 0
        y_a = fk_forward(P, field, u0, p, key32, rode)
        torch.cuda.synchronize()
        got = (rd1d.rd1d_fwd_cuda.launches, rd1d.rd1d_vjp_cuda.launches)
        y_b = fk_forward(P, field, u0, p, key32, rode)
        print(f"[fkpp f32] {arm} n={n} forward: K1 {got[0]} and K2 {got[1]} "
              f"launches; a second call equal bit for bit: "
              f"{bool(torch.equal(y_a, y_b))}")
        check(got == (STEPS, 0) and torch.equal(y_a, y_b),
              f"Fisher–KPP {arm} forward: {got} launches, or other bits")
        full = {}
        for rule in SDE_RULES:
            rd1d.rd1d_fwd_cuda.launches = 0
            rd1d.rd1d_vjp_cuda.launches = 0
            gu, gp, sol = fk_gradient(P, field, u0, p, getattr(P, rule)(),
                                      key32, rode)
            torch.cuda.synchronize()
            got = (rd1d.rd1d_fwd_cuda.launches, rd1d.rd1d_vjp_cuda.launches)
            fk_launches[f"FKPP {arm} f32 {rule}"] = {"K1": got[0],
                                                     "K2": got[1]}
            full[rule] = (gu, gp)
            print(f"[fkpp f32] {arm} {rule}: K1 {got[0]} and K2 {got[1]} "
                  f"launches per gradient (expected {fk_want[rule]}); "
                  f"dL/dp {gp.tolist()}")
            check(got == fk_want[rule], f"Fisher–KPP {arm} {rule}: {got}")
            check(bool(torch.isfinite(gu).all() and torch.isfinite(gp).all()),
                  f"Fisher–KPP {arm} {rule}: non-finite gradient")
        e_i = max(rel_l2(a, b) for a, b in zip(full["InterpolatingAdjoint"],
                                              full["DirectAdjoint"]))
        e_b = max(rel_l2(a, b) for a, b in zip(full["BacksolveAdjoint"],
                                              full["DirectAdjoint"]))
        print(f"[fkpp f32] {arm} against DirectAdjoint (u0, p), max rel L2: "
              f"Interpolating {e_i:.3e}, Backsolve {e_b:.3e}")
        check(e_i <= SDE_INTERP_TOL[torch.float32]
              and e_b <= SDE_BACKSOLVE_TOL,
              f"Fisher–KPP {arm}: rules disagree")
    del u0, p, full
    n = SIZES[0]
    field = rd1d.make_rd1d_field(n, 1.0 / n)
    u0, p = flagship_inputs(n, torch.float64, dev)
    u0_c, p_c = flagship_inputs(n, torch.float64, "cpu")
    # the RODE's rules share one step map: its Direct arm suffices here
    for rode, rules in ((False, SDE_RULES), (True, ("DirectAdjoint",))):
        arm = "RODE" if rode else "SDE"
        for rule in rules:
            rd1d.rd1d_fwd_cuda.launches = 0
            rd1d.rd1d_vjp_cuda.launches = 0
            gu, gp, _ = fk_gradient(P, field, u0, p, getattr(P, rule)(),
                                    P.NumpyKey(SEED), rode)
            torch.cuda.synchronize()
            fk_launches[f"FKPP {arm} f64 {rule}"] = {
                "K1": rd1d.rd1d_fwd_cuda.launches,
                "K2": rd1d.rd1d_vjp_cuda.launches}
            gu_c, gp_c, _ = fk_gradient(P, field, u0_c, p_c,
                                        getattr(P, rule)(), P.NumpyKey(SEED),
                                        rode)
            e_u, e_p = rel_l2(gu, gu_c), rel_l2(gp, gp_c)
            print(f"[fkpp f64] {arm} n={n} {rule}: card vs CPU rel L2 u0 "
                  f"{e_u:.3e}, p {e_p:.3e} (tol {F64_GRAD_TOL:g})")
            check(max(e_u, e_p) <= F64_GRAD_TOL,
                  f"Fisher–KPP f64 {arm} {rule}: card off the CPU")
    del u0, p, u0_c, p_c
    ad = {}
    for rule in SDE_RULES:
        gu, gp, sol = fk_adaptive_gradient(P, dev, getattr(P, rule)())
        gu_c, gp_c, sol_c = fk_adaptive_gradient(P, "cpu", getattr(P, rule)())
        ad[rule] = (gu, gp)
        e_c = max(rel_l2(gu, gu_c), rel_l2(gp, gp_c))
        print(f"[fkpp f64] adaptive EM on the tree, {FK_ADAPTIVE_N} cells, "
              f"{rule}: {sol.stats} (CPU {sol_c.stats}); card vs CPU rel L2 "
              f"{e_c:.3e} (tol {FK_ADAPTIVE_DEVICE_TOL:g})")
        check(sol.retcode == 0 and e_c <= FK_ADAPTIVE_DEVICE_TOL,
              f"adaptive Fisher–KPP {rule}")
    e_i = max(rel_l2(a, b) for a, b in zip(ad["InterpolatingAdjoint"],
                                          ad["DirectAdjoint"]))
    e_b = max(rel_l2(a, b) for a, b in zip(ad["BacksolveAdjoint"],
                                          ad["DirectAdjoint"]))
    print(f"[fkpp f64] adaptive against DirectAdjoint: Interpolating "
          f"{e_i:.3e} (tol 1e-9), Backsolve {e_b:.3e} (tol 1e-3; the JAX "
          f"package's tests/test_sde_highorder.py)")
    check(e_i <= 1e-9 and e_b <= 1e-3, "adaptive Fisher–KPP rules disagree")
    # at the fixed-grid arms' noise: the rules on one realised grid
    for rule in SDE_RULES:
        gu, gp, sol = fk_adaptive_gradient(P, dev, getattr(P, rule)(),
                                           sigma=FK_NOISE,
                                           tols=FK_ADAPTIVE_NOISY)
        gu_c, gp_c, sol_c = fk_adaptive_gradient(
            P, "cpu", getattr(P, rule)(), sigma=FK_NOISE,
            tols=FK_ADAPTIVE_NOISY)
        ad[rule] = (gu, gp)
        finite = all(bool(torch.isfinite(g).all()) for g in (gu, gp))
        print(f"[fkpp f64] adaptive EM at noise {FK_NOISE}u, {rule}: "
              f"{sol.stats} (CPU {sol_c.stats}); card vs CPU rel L2 "
              f"{max(rel_l2(gu, gu_c), rel_l2(gp, gp_c)):.3e} (not gated: "
              "the grids part)")
        check(sol.retcode == 0 and finite,
              f"adaptive Fisher–KPP at noise {FK_NOISE}u {rule}")
    e_i = max(rel_l2(a, b) for a, b in zip(ad["InterpolatingAdjoint"],
                                          ad["DirectAdjoint"]))
    e_b = max(rel_l2(a, b) for a, b in zip(ad["BacksolveAdjoint"],
                                          ad["DirectAdjoint"]))
    print(f"[fkpp f64] adaptive at noise {FK_NOISE}u against DirectAdjoint "
          f"on the card: Interpolating {e_i:.3e} (tol 1e-9), Backsolve "
          f"{e_b:.3e} (tol 1e-3)")
    check(e_i <= 1e-9 and e_b <= 1e-3,
          f"adaptive Fisher–KPP at noise {FK_NOISE}u: rules disagree")
    print(f"[fkpp] phase 5m: {time.perf_counter() - t:.1f} s")
    elapsed("phase 5m [fkpp]")

    # -- 5n. [shadow]: (b) the bench's float32 NILSS, timed; (a) the
    # background processes' Lorenz arms, card against CPU; (c) NILSAS
    # through K3/K4 at S4's width; (d) the refusals on that field ----------
    t = time.perf_counter()
    shadow_launches = {}
    bg = background.results(timeout=600.0)
    card_r, cpu_r = bg["cuda"], bg["cpu"]
    # the idle share of (b) from a trace of one of its segments in this
    # process, after the join: the whole run is ~10^6 launches, too many to
    # read back
    busy, wall = profiled_ms(lambda: lorenz_bench_nilss(
        P, dev, False, tspan=(0.0, 1.0), nseg=1))
    lb = {par: card_r[f"bench NILSS {par}"]
          for par in ("sequential", "segment_parallel")}
    for par, r in lb.items():
        print(f"[time] {card}: Lorenz NILSS f32 (bench.py lorenz_nilss: nseg "
              f"{LORENZ_BENCH['nseg']}, nstep {LORENZ_BENCH['nstep']}, (0, "
              f"20), rtol 1e-6) {par}: {r['ms']:.3f} ms (CUDA events around "
              f"one run, UNDER LOAD: in a background process beside phases "
              f"3-5m and two other card processes); solves' summed steps "
              f"{r['stats']}; d<z>/dρ {r['value']:.6f}")
        check(math.isfinite(r["value"]), f"bench NILSS {par}: {r['value']}")
    print(f"[time] {card}: Lorenz NILSS f32 segment_parallel / sequential "
          f"{lb['segment_parallel']['ms'] / lb['sequential']['ms']:.3f}; one "
          f"segment (0, 1) profiled in this process: kernels {busy:.3f} ms of "
          f"{wall:.3f} ms wall, device idle {100 * (1 - busy / wall):.1f}%")
    for key in ("ForwardLSS Cos", "AdjointLSS TimeDilation 10"):
        v_card, v_cpu = card_r["LSS"][key], cpu_r["LSS"][key]
        rel = abs(v_card - v_cpu) / abs(v_cpu)
        print(f"[shadow f64] Lorenz {key} on the 1001-row attractor: card "
              f"{v_card:.12f} ({card_r['LSS']['seconds']:.1f} s), CPU "
              f"{v_cpu:.12f} ({cpu_r['LSS']['seconds']:.1f} s); card vs CPU "
              f"rel {rel:.3e} (tol {SHADOW_DEVICE_TOL['LSS']:g}); |card - "
              f"1.01| {abs(v_card - 1.01):.4f} (tol {SHADOW_ATOL['LSS']:g}, "
              "the JAX test's)")
        check(rel <= SHADOW_DEVICE_TOL["LSS"], f"{key}: card off the CPU")
        check(abs(v_card - 1.01) <= SHADOW_ATOL["LSS"],
              f"{key}: {v_card} is not d<z>/dρ ≈ 1.01")
    for arm in ("NILSS short", "NILSAS short"):
        v_card, v_cpu = card_r[arm]["value"], cpu_r[arm]["value"]
        rel = abs(v_card - v_cpu) / abs(v_cpu)
        print(f"[shadow f64] Lorenz {arm} ({SHADOW_SHORT}): card "
              f"{v_card:.12f} ({card_r[arm]['stats']}), CPU {v_cpu:.12f} "
              f"({cpu_r[arm]['stats']}); card vs CPU rel {rel:.3e} (tol "
              f"{SHADOW_DEVICE_TOL['NIL']:g})")
        check(rel <= SHADOW_DEVICE_TOL["NIL"], f"{arm}: card off the CPU")
    for arm in ("NILSS", "NILSAS", "NILSAS segment_parallel"):
        r = card_r[arm]
        print(f"[shadow f64] Lorenz {arm} on (30, 60), 30 segments, on the "
              f"card: {r['value']:.12f} in {r['seconds']:.1f} s (segments "
              f"{r['stats']}{', primal ' + str(r['primal']) if 'primal' in r else ''}"
              f"); |card - 1.01| {abs(r['value'] - 1.01):.4f} (tol "
              f"{SHADOW_ATOL['NIL']:g}, the JAX test's)")
        check(abs(r["value"] - 1.01) <= SHADOW_ATOL["NIL"],
              f"{arm}: {r['value']} is not d<z>/dρ ≈ 1.01")
    v_par = card_r["NILSAS segment_parallel"]["value"]
    v_seq = card_r["NILSAS"]["value"]
    rel = abs(v_par - v_seq) / abs(v_seq)
    print(f"[shadow f64] Lorenz NILSAS segment_parallel against sequential "
          f"on the card (one dense primal each): rel {rel:.3e} (tol "
          f"{NILSAS_PAR_RTOL:g}, tests/test_parallel.py:132)")
    check(rel <= NILSAS_PAR_RTOL, "NILSAS segment_parallel off sequential")

    # (c) NILSAS through K3/K4 at S4's width, float32 on the simt route
    ns32 = s4_setup(P, torch.float32, dev)
    for w in wrappers:
        w.launches = 0
    sol_f, ms_f = event_ms(lambda: nilsas_s4_forward(P, ns32))
    torch.cuda.synchronize()
    got_f = tuple(w.launches for w in wrappers)
    att = sol_f.stats.n_accepted + sol_f.stats.n_rejected
    want_f = (2 + 6 * att, 0)  # f0, the initial step's probe, 6 per attempt
    print(f"[shadow f32] NILSAS({NILSAS_S4}) at S4's width (B = {S4_B}, "
          f"{S4_WIDTHS}, Tsit5 {NILSAS_S4_TOLS}) forward: {sol_f.stats}; K3 "
          f"{got_f[0]} and K4 {got_f[1]} launches (expected {want_f})")
    check(got_f == want_f, f"NILSAS S4 forward launched {got_f}")
    (g_ns, sol_ns), got = count_path(lambda: nilsas_s4_gradient(P, ns32))
    shadow_launches["NILSAS S4 f32"] = {"K3": got[0], "K4": got[1]}
    rec = sol_ns.adjoint
    seg_evals = (2 * NILSAS_S4["nseg"]
                 + 6 * (rec.stats.n_accepted + rec.stats.n_rejected))
    want = (2 + 6 * (sol_ns.stats.n_accepted + sol_ns.stats.n_rejected)
            + 2 + 6 * (rec.primal.n_accepted + rec.primal.n_rejected) + 1
            + seg_evals, 3 * seg_evals)
    print(f"[shadow f32] NILSAS S4 gradient: forward {sol_ns.stats}, primal "
          f"{rec.primal}, segments {rec.stats}; K3 {got[0]} and K4 {got[1]} "
          f"launches per gradient (expected {want}: one K3 and M+1 = 3 K4 per "
          f"evaluation of the adjoint field), routes {path_routes}; max|grad| "
          f"per leaf {({k: float(v.abs().max()) for k, v in g_ns.items()})}")
    check(got == want, f"NILSAS S4 gradient launched {got}")
    check(path_routes["K3"] == {"simt": got[0]}, "NILSAS S4 off simt")
    check(rec.stats.retcode == 0 and all(
        bool(torch.isfinite(v).all()) for v in g_ns.values()),
        "NILSAS S4 gradient failed or not finite")
    _, ms_g = event_ms(lambda: nilsas_s4_gradient(P, ns32))
    busy_f, wall_f = profiled_ms(lambda: nilsas_s4_forward(P, ns32))
    busy_g, wall_g = profiled_ms(lambda: nilsas_s4_gradient(P, ns32))
    print(f"[time] {card}: NILSAS S4 f32 forward {ms_f:.3f} ms, gradient "
          f"{ms_g:.3f} ms ({ms_g / ms_f:.2f}x; CUDA events, one run each); "
          f"profiled runs: forward kernels {busy_f:.3f} ms of {wall_f:.3f} "
          f"ms, idle {100 * (1 - busy_f / wall_f):.1f}%; gradient kernels "
          f"{busy_g:.3f} ms of {wall_g:.3f} ms, idle "
          f"{100 * (1 - busy_g / wall_g):.1f}%")
    (g_c, sol_c), got = count_path(lambda: nilsas_s4_gradient(
        P, s4_setup(P, torch.float64, dev, B=NILSAS_S4_B_CPU)))
    shadow_launches[f"NILSAS B={NILSAS_S4_B_CPU} f64"] = {"K3": got[0],
                                                          "K4": got[1]}
    g_cpu = {k: v for k, v in cpu_r["NILSAS S4 f64"].items()
             if k != "seconds"}
    errs = leaf_errors(g_c, g_cpu)
    print(f"[shadow f64] NILSAS B = {NILSAS_S4_B_CPU} at S4's width: card vs "
          f"CPU rel L2 {fmt_errors(errs)} (tol {F64_GRAD_TOL:g}); "
          f"{sol_c.adjoint.stats}; K3 {got[0]} and K4 {got[1]} launches; the "
          f"CPU's in {cpu_r['NILSAS S4 f64']['seconds']:.1f} s")
    check(max(errs.values()) <= F64_GRAD_TOL, "NILSAS S4 f64 off the CPU")
    # (d) the forward-mode rules on the kernel field refuse, no launch
    for w in wrappers:
        w.launches = 0
    refused = []
    s4_sol = P.ODESolution(ts=sol_f.ts, ys=sol_f.ys, stats=sol_f.stats,
                           retcode=0, prob=sol_f.prob)
    sg = lambda u, q, t: torch.mean(u ** 2)  # noqa: E731
    for name, build in (
            ("ForwardLSS", lambda: P.ForwardLSSProblem(
                s4_sol, P.ForwardLSS(g=sg))),
            ("AdjointLSS", lambda: P.AdjointLSSProblem(
                s4_sol, P.AdjointLSS(g=sg))),
            ("NILSS", lambda: P.shadow_forward(P.NILSSProblem(
                sol_f.prob, P.NILSS(nseg=4, nstep=17), g=sg)))):
        try:
            build()
        except ForwardModeUnsupported as err:
            refused.append(name)
            check("FusedMLP2" in str(err), f"{name}: refusal unnamed")
        else:
            raise AssertionError(f"{name} on the kernel field did not raise")
    got = tuple(w.launches for w in wrappers)
    print(f"[shadow f32] {', '.join(refused)} on the S4 kernel field raise "
          f"ForwardModeUnsupported after K3 {got[0]} and K4 {got[1]} launches")
    check(got == (0, 0), "a shadowing refusal launched a kernel")
    del ns32, sol_f, s4_sol, g_ns, sol_ns
    print(f"[shadow] phase 5n: {time.perf_counter() - t:.1f} s")
    elapsed("phase 5n [shadow]")

    # -- 5o. [ensemble]: the spiral through K3/K4, ENS_TRAJ trajectories
    t = time.perf_counter()
    ens32 = spiral_setup(P, torch.float32, dev, data64)
    ((g, sols), ms), got = count_path(lambda: event_ms(
        lambda: spiral_ensemble(P, ens32)))
    ens_launches = {"ensemble": {"K3": got[0], "K4": got[1]}}
    check(bool((sols.retcode == 0).all()), "ensemble failed")
    from scimlsensitivity_jl_tpu_torch.ops.mlp import fused_mlp2
    own = []
    for i in range(ENS_TRAJ):
        with torch.no_grad():
            s = P.solve(P.ODEProblem(
                lambda u, p, t_: fused_mlp2(p, u ** 3),
                ens32[1] * (1.0 + i / ENS_TRAJ), (0.0, SPIRAL_T1), ens32[0]),
                P.Tsit5(), saveat=ens32[3], sensealg=P.GaussAdjoint(),
                **SPIRAL_ADAPTIVE)
        own.append(torch.equal(s.ys, sols.ys[i]))
    _, ms_one = event_ms(lambda: spiral_gradient(
        P, ens32, dict(SPIRAL_ADAPTIVE, sensealg=P.GaussAdjoint())))
    print(f"[ensemble f32] the spiral through K3/K4, {ENS_TRAJ} trajectories "
          f"(u0·(1 + i/{ENS_TRAJ})), GaussAdjoint, rtol 1e-3, backend "
          f"\"vmap\": each trajectory's rows equal its own solve bit for "
          f"bit: {all(own)}; K3/K4 launches {ens_launches}; max|grad| per "
          f"leaf {({k: float(v.abs().max()) for k, v in g.items()})}")
    check(all(own), "an ensemble trajectory differs from its own solve")
    check(all(bool(torch.isfinite(v).all()) for v in g.values()),
          "ensemble gradient not finite")
    per = ms / ENS_TRAJ
    print(f"[time] {card}: spiral ensemble f32 gradient {ms:.3f} ms (the "
          f"first run): {per:.3f} ms per trajectory against {ms_one:.3f} ms "
          f"for one trajectory's own gradient ({per / ms_one:.3f}x; CUDA "
          f"events, one run each)")
    del g, sols, ens32
    print(f"[ensemble] phase 5o: {time.perf_counter() - t:.1f} s")
    elapsed("phase 5o [ensemble]")

    # -- 5p. [digits]: two training steps at batch DIGITS_B on the card, the
    # f64 gradient at batch DIGITS_B_CPU against the CPU, one step traced by
    # utils.profile.trace, entry() on the card
    t = time.perf_counter()
    from scimlsensitivity_jl_tpu_torch.entry import entry
    from scimlsensitivity_jl_tpu_torch.models import digits
    from scimlsensitivity_jl_tpu_torch.utils import profile as sml_profile

    params, x, y = digits_setup(P, torch.float32, dev, DIGITS_B)
    leaves = [v.requires_grad_() for d in params.values() for v in d.values()]
    opt = torch.optim.Adam(leaves, lr=3e-3)
    step, _ = digits.make_digits_train_step(opt)
    losses = []
    for _ in range(2):
        losses.append(float(step(params, x, y)))
    with sml_profile.trace(os.path.join(background.workdir, "trace")) as tr:
        losses.append(float(step(params, x, y)))
    print(f"[digits f32] batch {DIGITS_B} (64→32 encoder, 32→64→32 field, "
          f"10-way head, Backsolve checkpointed, Tsit5 rtol 1e-3), Adam 3e-3 "
          f"on one batch: loss {losses[0]:.6f} -> {losses[1]:.6f} -> "
          f"{losses[2]:.6f}")
    check(losses[1] < losses[0], "digits loss did not fall")
    print(f"[time] {card}: digits f32 training step at batch {DIGITS_B} "
          f"under utils.profile.trace: {tr.wall_ms:.3f} ms wall, kernels "
          f"{tr.device_ms():.3f} ms, device idle {100 * tr.idle_share():.1f}%")
    loss_c, g_c = digits_gradient(P, digits_setup(P, torch.float64, dev,
                                                  DIGITS_B_CPU))
    ref = cpu_r["digits f64"]
    errs = leaf_errors(g_c, {k: v for k, v in ref.items()
                             if k not in ("loss", "seconds")})
    e_loss = abs(float(loss_c) - ref["loss"]) / abs(ref["loss"])
    print(f"[digits f64] batch {DIGITS_B_CPU}: card vs CPU loss rel "
          f"{e_loss:.3e}, gradient rel L2 {fmt_errors(errs)} (tol "
          f"{F64_GRAD_TOL:g})")
    check(max(errs.values()) <= F64_GRAD_TOL and e_loss <= F64_GRAD_TOL,
          "digits f64 card off the CPU")
    fn, args = entry()
    loss_e, grads_e = fn(*args)
    check(bool(torch.isfinite(loss_e)) and all(
        bool(torch.isfinite(v).all()) and v.is_cuda for v in grads_e.values()),
        "entry() on the card")
    print(f"[entry] entry() on the card: loss {float(loss_e):.6f}, gradient "
          f"leaves {sorted(grads_e)} on {grads_e['W0'].device}")
    del params, x, y, leaves, opt
    print(f"[digits] phase 5p: {time.perf_counter() - t:.1f} s")
    elapsed("phase 5p [digits]")

    # -- 5q. [shard]: the flagship with its state split over two ranks on
    # the card (gloo), against phase 4's gradient function run unsharded
    t = time.perf_counter()
    shard_launches, shard_times = shard_phase(P, rd1d, dev, card)
    print(f"[shard] phase 5q: {time.perf_counter() - t:.1f} s")
    elapsed("phase 5q [shard]")

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
        # launches, which a trace's sum over the calls does not; the
        # kernels' larger of two traces (a trace that lost events reads low)
        traces = [profiled_ms(fn, calls=calls, kernels={
            "K5": 1, "K6": 2}.get(name)) for _ in range(1 + (calls == 20))]
        busy, wall = max(traces)
        rk4_timing[name] = busy
        kname = name[:2]
        bound, by = rk4_bound_ms(kname, MEGA_N, MEGA_S, torch.float32)
        flops = MEGA_S * RK4_FLOPS[kname] * MEGA_N
        print(f"[time] {card}: n={MEGA_N} S={MEGA_S} f32 {name}: device "
              f"{busy * 1e3:.2f} us per call ({flops / (busy * 1e-3) / 1e12:.2f}"
              f" TFLOP/s of the function's {flops / 1e9:.3f} GFLOP), bound "
              f"{bound * 1e3:.2f} us by {by} ({100 * bound / busy:.1f}% of it),"
              f" host-paced {wall * 1e3:.2f} us per call; profiler over "
              f"{calls} calls, "
              + " and ".join(f"{b * 1e3:.2f}" for b, _ in traces)
              + " us in the traces taken")
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

    # -- 6c. neural-ODE timings: S4 bf16 and the kernels (the spiral arms
    # are not timed, to keep the command near 800 s; PERF.md keeps their
    # last times; 5b checks those arms every run) ---------------------------
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
        # device operations per call: 2 kernels, and the memset of the
        # split counters where a float32 product splits (as at S4)
        ops = 2 + int(dtype == torch.float32 and label == "S4")
        for name, fn in versions.items():
            busy, wall = profiled_ms(fn, calls=calls,
                                     kernels=None if "_" in name else ops)
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
             "ColFinals": "launch 2 (dx, dW0, db0, db1)",
             "Memset": "memset of the split counters"}

    def per_launch(fn, calls, ops=2):
        """'label µs' per launch of each of fn's two kernels (and its
        memset: ops 3), profiler means; a trace that lost one is taken
        again, four times at most (see profiled_ms)."""
        fn()
        torch.cuda.synchronize()
        for _ in range(5):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
            rows = [f"{label} {e.self_device_time_total / e.count:.2f} us"
                    for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA and e.count
                    for key, label in parts.items() if key in e.key]
            if len(rows) == ops:
                break
        return rows

    for kname in ("K3", "K4"):
        rows = per_launch(pairs[kname]["wgmma"], 20)
        print(f"[time] {card}: S4 bf16 {kname} wgmma per kernel (profiler, "
              f"mean of 20 calls): {', '.join(rows)}")
    yard = {"K3": lambda: (x @ w0, h @ w1),
            "K4": lambda: (h.T @ g, g @ w1.T, x.T @ dzc, dzc @ w0.T)}
    # the larger of two traces: a trace that lost launches reads low
    lib = {k: max(profiled_ms(fn, calls=20)[0] for _ in range(2))
           for k, fn in yard.items()}
    print(f"[time] {card}: S4 bf16 yardstick the port never calls, bf16 "
          f"torch.matmul (cuBLAS) of the same products: K3's 2 "
          f"{lib['K3'] * 1e3:.2f} us, K4's 4 {lib['K4'] * 1e3:.2f} us per "
          "call (no epilogues, no column sums); the larger of two profiler "
          "traces over 20 calls")
    mlp_timing[("S4", torch.bfloat16)]["cublas"] = lib

    # S4 float32 on the simt route: each launch, and the float32 cuBLAS
    # products of the same work (full float32: TF32 would round the inputs)
    check(not torch.backends.cuda.matmul.allow_tf32,
          "the float32 yardstick would run in TF32")
    x, w0, b0, w1, b1, g = mlp_inputs(MLP_SHAPES["S4"], torch.float32, dev)
    _, h = mlp.mlp2_fwd_cuda(x, w0, b0, w1, b1)
    dzc = h.clone()  # any (B, hid) float32 operand
    for kname, fn in (("K3", lambda: mlp.mlp2_fwd_cuda(x, w0, b0, w1, b1)),
                      ("K4", lambda: mlp.mlp2_vjp_cuda(x, w0, w1, h, g))):
        print(f"[time] {card}: S4 f32 {kname} simt per kernel (profiler, "
              f"mean of 5 calls): {', '.join(per_launch(fn, 5, ops=3))}")
    yard = {"K3": lambda: (x @ w0, h @ w1),
            "K4": lambda: (h.T @ g, g @ w1.T, x.T @ dzc, dzc @ w0.T)}
    lib32 = {k: max(profiled_ms(fn, calls=5)[0] for _ in range(2))
             for k, fn in yard.items()}
    t32 = mlp_timing[("S4", torch.float32)]
    print(f"[time] {card}: S4 f32 yardstick the port never calls, float32 "
          f"torch.matmul (cuBLAS, allow_tf32 False) of the same products: "
          f"K3's 2 {lib32['K3'] * 1e3:.2f} us, K4's 4 "
          f"{lib32['K4'] * 1e3:.2f} us per call (no epilogues, no column "
          f"sums); the simt kernels {t32['K3'] / lib32['K3']:.2f}x and "
          f"{t32['K4'] / lib32['K4']:.2f}x of it; the larger of two profiler "
          "traces over 5 calls")
    t32["cublas"] = lib32
    # the same yardstick at the spiral's float32 shape (B = 1, 2→50→2)
    x, w0, b0, w1, b1, g = mlp_inputs(MLP_SHAPES["spiral"], torch.float32,
                                      dev)
    _, h = mlp.mlp2_fwd_cuda(x, w0, b0, w1, b1)
    dzc = h.clone()
    yard = {"K3": lambda: (x @ w0, h @ w1),
            "K4": lambda: (h.T @ g, g @ w1.T, x.T @ dzc, dzc @ w0.T)}
    lib_sp = {k: max(profiled_ms(fn, calls=100)[0] for _ in range(2))
              for k, fn in yard.items()}
    t_sp = mlp_timing[("spiral", torch.float32)]
    print(f"[time] {card}: spiral f32 yardstick the port never calls, "
          f"float32 torch.matmul (cuBLAS, allow_tf32 False) of the same "
          f"products: K3's 2 {lib_sp['K3'] * 1e3:.2f} us, K4's 4 "
          f"{lib_sp['K4'] * 1e3:.2f} us per call (no epilogues, no column "
          f"sums); the simt kernels {t_sp['K3'] / lib_sp['K3']:.2f}x and "
          f"{t_sp['K4'] / lib_sp['K4']:.2f}x of it; the larger of two "
          "profiler traces over 100 calls")
    t_sp["cublas"] = lib_sp
    del x, w0, b0, w1, b1, g, h, dzc

    elapsed("phase 6c (neural-ODE timings)")

    # -- 6d. forward mode and QuadratureAdjoint timings -------------------------
    lv_times = {}
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

    # -- 6e. [interp] timings: not taken, to keep the command near 800 s
    # (PERF.md keeps the last times of PDE (d)-(f) and S2i-S2p); 5e checks
    # those arms every run

    # -- 6f. [events] timings: each arm against its own forward, CUDA events
    # (median of EV_TIMING_ROUNDS interleaved rounds after a warm-up round,
    # whose results the float32 checks read) and one profiled run for the
    # device's idle share, for the arms that `traced` names: not the
    # spiral's gradients in 6h and 6j (idle 95-97% as PERF.md records)
    def ev_time(tag, arms, checks=None, traced=lambda name: True,
                rounds=EV_TIMING_ROUNDS):
        out = {}
        med = interleaved_ms(arms, rounds=rounds, outputs=out)
        fwd = next(iter(arms))
        for name, fn in arms.items():
            idle = "not traced"
            if traced(name):
                busy, wall = profiled_ms(fn)
                idle = (f"profiled run: kernels {busy:.3f} ms of {wall:.3f} "
                        f"ms wall, device idle {100 * (1 - busy / wall):.1f}%")
            extra = "" if checks is None else checks(name, out[name])
            print(f"[time] {card}: {tag} {name}: {med[name]:.3f} ms "
                  f"({med[name] / med[fwd]:.2f}x its forward; CUDA events, "
                  f"median of {rounds} interleaved); {idle}{extra}")

    n = EV_N[torch.float32]
    field = rd1d.make_rd1d_field(n, 1.0 / n)
    u0, p = flagship_inputs(n, torch.float32, dev)
    arms = {"forward": lambda: dose_forward(P, field, u0, p)}
    for name, sensealg in dose_rules.items():
        arms[f"{name} gradient"] = (lambda s=sensealg: dose_gradient(
            P, field, u0, p, s))
    ev_time(f"PDE dose n={n} f32", arms)
    del u0, p

    def spiral_checks(name, out):
        if "forward" in name:
            return ""
        sol = out[1]
        ev = sol.events
        check(sol.retcode == 0 and (ev is None or ev.count >= 1),
              f"f32 {name}: retcode {sol.retcode}")
        return (f"; forward {sol.stats}"
                + ("" if ev is None else f", {ev.count} events"))

    # the spiral's event, dense and saveat arms (S2e, S2d, S2t) are checked
    # in 5f (float64 card against CPU, float32 against float64) and not
    # timed here, to keep the command under ~900 s (PERF.md keeps their
    # last times)
    arms = {"forward": lambda: ball_solve(P, dev, None, grad=False),
            "GaussAdjoint gradient": lambda: ball_solve(
                P, dev, P.GaussAdjoint(), grad=True),
            "ForwardDiffSensitivity gradient": lambda: ball_solve(
                P, dev, P.ForwardDiffSensitivity(), grad=True)}
    ev_time("bouncing ball f64", arms)
    elapsed("phase 6f [events] timings")

    # -- 6g. [direct] timings: each direct call at n = 1,048,576 f32
    # against the dense forward it reads (CUDA events, median of
    # DIRECT_TIMING_ROUNDS interleaved rounds after a warm-up round, and
    # one profiled run for the device's idle share); the warm-up round's
    # gradients are held to the card's float64 ones, with their K1/K2
    # launches
    n = SIZES[1]
    field = rd1d.make_rd1d_field(n, 1.0 / n)
    u0, p = flagship_inputs(n, torch.float32, dev)
    sol32 = flagship_dense_forward(P, field, u0, p)

    def launched(fn, sol):
        """fn(sol) with the K1 and K2 launches it made."""
        k1, k2 = rd1d.rd1d_fwd_cuda.launches, rd1d.rd1d_vjp_cuda.launches
        out = fn(sol)
        return out, (rd1d.rd1d_fwd_cuda.launches - k1,
                     rd1d.rd1d_vjp_cuda.launches - k2)

    arms = {"dense forward": lambda: flagship_dense_forward(P, field, u0, p)}
    for arm, fn in direct_arms.items():
        arms[f"{arm} direct call"] = (lambda fn=fn: launched(fn, sol32))
    outs = {}
    med = interleaved_ms(arms, rounds=DIRECT_TIMING_ROUNDS, outputs=outs)
    sol64 = flagship_dense_forward(P, field, *flagship_inputs(
        n, torch.float64, dev))
    for arm, fn in direct_arms.items():
        gu64, _ = fn(sol64)
        (gu, _), got = outs[f"{arm} direct call"]
        e_u = rel_l2(gu, gu64)
        print(f"[direct f32] PDE n={n} {arm} vs card f64: u0-grad rel L2 "
              f"{e_u:.3e} (tol {F32_U0_TOL:g}); K1 {got[0]} and K2 {got[1]} "
              "launches")
        check(min(got) > 0, f"f32 direct {arm} launched K1, K2 {got}")
        check(e_u <= F32_U0_TOL, f"direct {arm} f32 gradient off the f64 one")
    del sol64, gu64, gu, outs
    for name, fn in arms.items():
        busy, wall = profiled_ms(fn)
        print(f"[time] {card}: PDE n={n} f32 {name}: {med[name]:.3f} ms "
              f"({med[name] / med['dense forward']:.2f}x the dense forward; "
              f"CUDA events, median of {DIRECT_TIMING_ROUNDS} interleaved); "
              f"profiled run: kernels {busy:.3f} ms of {wall:.3f} ms wall, "
              f"device idle {100 * (1 - busy / wall):.1f}%")
    del u0, p, sol32
    # the GaussAdjoint Hessian (~14 s a run) is not timed, for time
    _, ms = event_ms(lambda: lv_hessian(P, dev, P.DirectAdjoint()))
    print(f"[time] {card}: Lotka-Volterra f64 Hessian under DirectAdjoint "
          f"(reverse over reverse): {ms:.1f} ms (CUDA events around one run, "
          "after phase 5g's)")
    elapsed("phase 6g [direct] timings")

    # -- 6h. [unroll] and [stiff] timings: each arm against its own
    # baseline, CUDA events (median of EV_TIMING_ROUNDS interleaved rounds
    # after a warm-up round) and one profiled run for the device's idle
    # share: the spiral f32 with unrolled Gauss against its while driver
    # (the gradients not traced, as in 6f), the nonlinear solve against its
    # forward. Robertson's FBDF GaussAdjoint gradient is checked in 5i and
    # not timed, to keep the command under ~950 s with phase 5q
    setup32 = spiral_setup(P, torch.float32, dev, data64)
    arms = {"S2u forward": lambda: spiral_forward(P, setup32, UNROLL_SPIRAL),
            "S2u GaussAdjoint while gradient": lambda: spiral_gradient(
                P, setup32, dict(UNROLL_SPIRAL, sensealg=P.GaussAdjoint())),
            "S2u GaussAdjoint unroll gradient": lambda: spiral_gradient(
                P, setup32, dict(UNROLL_SPIRAL, sensealg=P.GaussAdjoint(),
                                 unroll=True))}
    ev_time("spiral f32", arms, spiral_checks,
            traced=lambda name: "forward" in name)
    del setup32
    arms = {"forward": lambda: nl_solve(P, dev, grad=False),
            "IFT gradient": lambda: nl_solve(P, dev)}
    ev_time("solve_nonlinear f64 (8 unknowns)", arms)
    elapsed("phase 6h [unroll] and [stiff] timings")

    # -- 6j. [dae] and [dde] timings: each gradient against its own forward;
    # the spiral under the invertible mass and the delayed S4 field at full
    # width, CUDA events (median of EV_TIMING_ROUNDS interleaved rounds
    # after a warm-up round) and one profiled run for the idle share. The
    # Robertson DAE gradients are checked in 5j and not timed, to keep the
    # command under ~950 s with phase 5q
    setup32 = spiral_setup(P, torch.float32, dev, data64)
    kw32 = spiral_mass_kw(P, dict(SPIRAL_ADAPTIVE, sensealg=P.GaussAdjoint()))
    arms = {"S2m forward": lambda: spiral_mass_gradient(P, setup32, kw32,
                                                        grad=False),
            "S2m invertible-mass GaussAdjoint gradient":
                lambda: spiral_mass_gradient(P, setup32, kw32)}
    ev_time("spiral f32", arms, spiral_checks,
            traced=lambda name: "forward" in name)
    del setup32
    for arm, adaptive in (("RK4 dt 1/64", False),
                          ("Tsit5 rtol 1e-6", True)):
        arms = {f"{arm} forward": lambda a=adaptive: dde_forward(P, dde32, a),
                f"{arm} gradient": lambda a=adaptive: dde_gradient(
                    P, dde32, a)}
        ev_time(f"DDE S4 f32 (B = {S4_B}, τ = {DDE_TAU})", arms,
                lambda name, out: "" if "forward" in name else
                f"; steps {out[1].stats}")
    del dde32
    elapsed("phase 6j [dae] and [dde] timings")

    # -- 6k. [sde] timings: forward and each rule's gradient of 5l and 5m's
    # kernel arms, CUDA events (one round after a warm-up round) and one
    # profiled run for the device's idle share; not the adaptive arm (host
    # paced at ~95% idle in PR 13's first chip run, and its traces of
    # ~10^4 launches took most of the phase's 73 s)
    nsde32 = nsde_setup(P, torch.float32, dev)
    arms = {"forward": lambda: nsde_forward(P, nsde32, key32)}
    for rule in SDE_RULES:
        arms[f"{rule} gradient"] = (lambda r=rule: nsde_gradient(
            P, nsde32, getattr(P, r)(), key32))
    ev_time(f"neural SDE S4 f32 (B = {S4_B}, EulerMaruyama dt 1/{steps})",
            arms, rounds=1)
    del nsde32
    n = SIZES[1]
    field = rd1d.make_rd1d_field(n, 1.0 / n)
    u0, p = flagship_inputs(n, torch.float32, dev)
    for rode in (False, True):
        arms = {"forward": lambda r=rode: fk_forward(P, field, u0, p, key32,
                                                      r)}
        for rule in SDE_RULES:
            arms[f"{rule} gradient"] = (lambda s=rule, r=rode: fk_gradient(
                P, field, u0, p, getattr(P, s)(), key32, r))
        ev_time(f"stochastic Fisher–KPP {'RODE' if rode else 'SDE'} n={n} "
                f"f32 ({STEPS} steps)", arms, rounds=1)
    del u0, p
    elapsed("phase 6k [sde] timings")

    # Lotka-Volterra last: its traces hold the most launches of any
    # the auto-pinned against the unpinned reverse on [0, LV_TRACE_T1], in
    # turns: whether pinning pays here (ROADMAP M5)
    lv_pin = {
        "pinned": P.InterpolatingAdjoint(),
        "adaptive": P.InterpolatingAdjoint(pinned_reverse=False)}
    lv_pin_fns = {name: (lambda s=s: lv_solve(P, dev, s, grad=True,
                                              t1=LV_TRACE_T1))
                  for name, s in lv_pin.items()}
    lv_pin_out = {}
    med = interleaved_ms(lv_pin_fns, rounds=3, outputs=lv_pin_out)
    err = max_rel(lv_pin_out["adaptive"][0], lv_pin_out["pinned"][0])
    for name, (_, sol) in lv_pin_out.items():
        print(f"[time] {card}: Lotka-Volterra f64 on [0, {LV_TRACE_T1}] "
              f"InterpolatingAdjoint, {sol.adjoint.reverse} reverse: "
              f"{med[name]:.3f} ms (CUDA events, median of 3 interleaved); "
              f"forward {sol.stats}; reverse {sol.adjoint.stats}")
        check(sol.retcode == 0 and sol.adjoint.stats.retcode == 0
              and sol.adjoint.reverse == name, f"LV [0, {LV_TRACE_T1}] "
              f"{name}: {sol.adjoint.reverse} reverse, retcode")
    print(f"[interp f64] Lotka-Volterra on [0, {LV_TRACE_T1}]: adaptive "
          f"against pinned max relative difference per entry {err:.2e} (tol "
          f"{LV_RULE_TOL:g}); pinned {med['adaptive'] / med['pinned']:.2f}x "
          "faster")
    check(err <= LV_RULE_TOL, "LV adaptive reverse off the pinned one")

    for name, sensealg in lv_runs.items():
        _, lv_times[name] = event_ms(
            lambda: lv_solve(P, dev, sensealg, grad=True))
    # (not traced, to keep the command under ~900 s: PERF.md keeps the
    # idle shares, 93-97%, of the last traces on [0, 0.5])
    for name in ["forward"] + list(lv_runs):
        ms = lv_times[name]
        print(f"[time] {card}: Lotka-Volterra f64 (11 saves, rtol 1e-10) "
              f"{name}{'' if name == 'forward' else ' gradient'}: {ms:.3f} ms "
              f"({ms / lv_times['forward']:.2f}x the forward; CUDA events "
              f"around one run, after phase 5d's warm one)")
    elapsed("phase 6d")

    n = SIZES[0]
    k1_bound = 8 * n / HBM_BYTES_PER_S * 1e3
    k2_bound = 12 * n / HBM_BYTES_PER_S * 1e3
    s4 = mlp_timing[("S4", torch.bfloat16)]

    def s4_f32(kname):
        """The kernel on the simt route at S4's float32 shape, the shape of
        the device-bound cells (DDE, neural SDE, NILSAS), and at the
        spiral's (B = 1), each with its cuBLAS yardstick and bound."""
        out = {}
        for label in ("S4", "spiral"):
            t32 = mlp_timing[(label, torch.float32)]
            pre = f"{label.lower()}_f32"
            out.update({f"{pre}_simt_ms": t32[kname],
                        f"{pre}_library_ms": t32["cublas"][kname],
                        f"{pre}_bound_ms": t32["bound"][kname][0],
                        f"{pre}_bound_by": t32["bound"][kname][1]})
        return out
    def shard_timing(kname):
        """The kernel per launch at the [shard] ranks' sizes (phase 5q)."""
        busy, bound, by = shard_times[kname]
        return {"shard_ms": busy, "shard_bound_ms": bound,
                "shard_bound_by": by}

    shard_k = {k: sum(got[k] for got in shard_launches.values())
               for k in ("K3", "K4", "K5", "K6")}
    interp_k = {k: sum(got[k] for got in interp_launches.values())
                for k in ("K1", "K2")}
    interp_node = [sum(got[i] for got in interp_node_launches.values())
                   for i in (0, 1)]
    dose_k = {k: sum(got[k] for got in dose_launches.values())
              for k in ("K1", "K2")}
    event_node = [sum(got[i] for got in event_node_launches.values())
                  for i in (0, 1)]
    direct_k = {k: sum(got.get(k, 0) for got in direct_launches.values())
                for k in ("K1", "K2", "K3", "K4")}
    unroll_k = {k: sum(got.get(k, 0) for got in unroll_launches.values())
                for k in ("K1", "K2", "K3", "K4")}
    new_paths = dict(dae_launches, **dde_launches, **nsde_launches,
                     **shadow_launches, **ens_launches)
    new_k = {k: sum(got[k] for got in new_paths.values())
             for k in ("K3", "K4")}
    fk_k = {k: sum(got[k] for got in fk_launches.values())
            for k in ("K1", "K2")}
    kernels = [
        {"name": "rd1d_fwd (K1)", "route": "cuda",
         "source": "scimlsensitivity_jl_tpu_torch/csrc/rd1d.cu",
         "replaces": "scimlsensitivity_jl_tpu/ops/pallas_pde.py:58",
         "launches": (launches["K1"] + pde_c_launches["K1"]
                      + interp_k["K1"] + dose_k["K1"] + direct_k["K1"]
                      + unroll_k["K1"] + fk_k["K1"]
                      + sum(got["K1"] for got in shard_launches.values())),
         "paths": {"PDE (a)+(b)": launches["K1"],
                   **{rank: got["K1"]
                      for rank, got in shard_launches.items()},
                   "PDE (c) QuadratureAdjoint": pde_c_launches["K1"],
                   **{f"PDE {arm}": got["K1"]
                      for arm, got in interp_launches.items()},
                   **{f"PDE dose {arm}": got["K1"]
                      for arm, got in dose_launches.items()},
                   **{f"direct {arm}": got["K1"]
                      for arm, got in direct_launches.items() if "K1" in got},
                   **{arm: got["K1"]
                      for arm, got in unroll_launches.items() if "K1" in got},
                   **{arm: got["K1"] for arm, got in fk_launches.items()}},
         "max_abs_err": max_abs["K1"],
         "shard_max_abs_err": ghost_abs["K1"],
         "ms": timing[n]["K1"], "plain_ms": timing[n]["K1_plain"],
         "cold_ms": timing[n]["K1_cold"],
         "kernels_per_call": k12_counts[n]["K1"][0],
         "bound_ms": k1_bound, "bound_by": "bytes", "library_ms": None},
        {"name": "rd1d_vjp (K2)", "route": "cuda",
         "source": "scimlsensitivity_jl_tpu_torch/csrc/rd1d.cu",
         "replaces": "scimlsensitivity_jl_tpu/ops/pallas_pde.py:66",
         "launches": (launches["K2"] + pde_c_launches["K2"]
                      + interp_k["K2"] + dose_k["K2"] + direct_k["K2"]
                      + unroll_k["K2"] + fk_k["K2"]
                      + sum(got["K2"] for got in shard_launches.values())),
         "paths": {"PDE (a)+(b)": launches["K2"],
                   **{rank: got["K2"]
                      for rank, got in shard_launches.items()},
                   "PDE (c) QuadratureAdjoint": pde_c_launches["K2"],
                   **{f"PDE {arm}": got["K2"]
                      for arm, got in interp_launches.items()},
                   **{f"PDE dose {arm}": got["K2"]
                      for arm, got in dose_launches.items()},
                   **{f"direct {arm}": got["K2"]
                      for arm, got in direct_launches.items() if "K2" in got},
                   **{arm: got["K2"]
                      for arm, got in unroll_launches.items() if "K2" in got},
                   **{arm: got["K2"] for arm, got in fk_launches.items()}},
         "max_abs_err": max_abs["K2"],
         "shard_max_abs_err": ghost_abs["K2"],
         "ms": timing[n]["K2"], "plain_ms": timing[n]["K2_plain"],
         "cold_ms": timing[n]["K2_cold"],
         "kernels_per_call": k12_counts[n]["K2"][0],
         "bound_ms": k2_bound, "bound_by": "bytes", "library_ms": None},
        {"name": "mlp2_fwd (K3)", "route": "cuda",
         "source": "scimlsensitivity_jl_tpu_torch/csrc/mlp2.cu",
         "replaces": "scimlsensitivity_jl_tpu/ops/pallas_mlp.py:53",
         "launches": (s1_s5_launches["K3"] + s2q_launches[0]
                      + interp_node[0] + event_node[0] + direct_k["K3"]
                      + unroll_k["K3"] + new_k["K3"] + shard_k["K3"]),
         "paths": {"S1-S5": s1_s5_launches["K3"],
                   **{rank: got["K3"]
                      for rank, got in shard_launches.items()},
                   "S2q QuadratureAdjoint": s2q_launches[0],
                   **{arm: got[0]
                      for arm, got in interp_node_launches.items()},
                   **{arm: got[0]
                      for arm, got in event_node_launches.items()},
                   **{f"direct {arm}": got["K3"]
                      for arm, got in direct_launches.items() if "K3" in got},
                   **{arm: got["K3"]
                      for arm, got in unroll_launches.items() if "K3" in got},
                   **{arm: got["K3"] for arm, got in new_paths.items()}},
         "max_abs_err": max_abs["K3"],
         "ms": s4["K3"], "plain_ms": s4["K3_plain"],
         "bound_ms": s4["bound"]["K3"][0], "bound_by": s4["bound"]["K3"][1],
         "library_ms": s4["cublas"]["K3"], **s4_f32("K3"),
         **shard_timing("K3")},
        {"name": "mlp2_vjp (K4)", "route": "cuda",
         "source": "scimlsensitivity_jl_tpu_torch/csrc/mlp2.cu",
         "replaces": "scimlsensitivity_jl_tpu/ops/pallas_mlp.py:68",
         "launches": (s1_s5_launches["K4"] + s2q_launches[1]
                      + interp_node[1] + event_node[1] + direct_k["K4"]
                      + unroll_k["K4"] + new_k["K4"] + shard_k["K4"]),
         "paths": {"S1-S5": s1_s5_launches["K4"],
                   **{rank: got["K4"]
                      for rank, got in shard_launches.items()},
                   "S2q QuadratureAdjoint": s2q_launches[1],
                   **{arm: got[1]
                      for arm, got in interp_node_launches.items()},
                   **{arm: got[1]
                      for arm, got in event_node_launches.items()},
                   **{f"direct {arm}": got["K4"]
                      for arm, got in direct_launches.items() if "K4" in got},
                   **{arm: got["K4"]
                      for arm, got in unroll_launches.items() if "K4" in got},
                   **{arm: got["K4"] for arm, got in new_paths.items()}},
         "max_abs_err": max_abs["K4"],
         "ms": s4["K4"], "plain_ms": s4["K4_plain"],
         "bound_ms": s4["bound"]["K4"][0], "bound_by": s4["bound"]["K4"][1],
         "library_ms": s4["cublas"]["K4"], **s4_f32("K4"),
         **shard_timing("K4")},
    ]
    for name, label, line in (("K5", "rd1d_rk4_fwd", 223),
                              ("K6", "rd1d_rk4_vjp", 253)):
        bound, by = rk4_bound_ms(name, MEGA_N, MEGA_S, torch.float32)
        kernels.append(
            {"name": f"{label} ({name})", "route": "cuda",
             "source": "scimlsensitivity_jl_tpu_torch/csrc/rd1d_rk4.cu",
             "replaces": f"scimlsensitivity_jl_tpu/ops/pallas_pde.py:{line}",
             "launches": mega_launches[name] + shard_k[name],
             "paths": {"megakernel 64 steps": mega_launches[name],
                       **{rank: got[name]
                          for rank, got in shard_launches.items()}},
             "max_abs_err": max_abs[name],
             "shard_max_abs_err": ghost_rk4_abs[name],
             **shard_timing(name),
             "ms": rk4_timing[name], "plain_ms": rk4_timing[f"{name}_plain"],
             "bound_ms": bound, "bound_by": by, "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--background"]:
        sys.exit(run_background(sys.argv[2], sys.argv[3]))
    if sys.argv[1:2] == ["--shard"]:
        sys.exit(run_shard_rank(int(sys.argv[2]), int(sys.argv[3]),
                                int(sys.argv[4]), sys.argv[5], sys.argv[6]))
    sys.exit(main())
