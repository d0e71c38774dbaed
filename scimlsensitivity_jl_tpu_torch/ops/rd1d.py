"""1-D reaction-diffusion field with a hand-written CUDA forward and fused
pullback, and the S-step RK4 block megakernel with its exact discrete
pullback (PyTorch port).

Counterpart of `scimlsensitivity_jl_tpu/ops/pallas_pde.py`:
`rd1d_reference` (:48), `fused_rd1d` (:87) with its Pallas forward
(`_rd_fwd` :92, kernel `_fwd_kernel` :58) and fused Pallas pullback
(`_rd_bwd_rule` :114, kernel `_bwd_kernel` :66), `make_rd1d_field`
(:474), and the RK4 block: `_rk4_one` (:164), `rd1d_rk4_scan_reference`
(:172), `_chunk_geometry` (:184) and `make_rd1d_rk4_block` (:374) with its
forward megakernel (`_block_fwd` :404, kernel `_rk4_fwd_kernel_factory`
:223, K5 here) and exact discrete pullback (`block_bwd_rule` :428, kernel
`_rk4_bwd_kernel_factory` :253, K6 here), in `csrc/rd1d_rk4.cu`.

    f_i = D·inv_dx2·(u_{i-1} − 2u_i + u_{i+1}) + k·u_i(1 − u_i),  p = [D, k]

with an edge-copy ghost cell, L(u)_0 = u_1 − u_0 and
L(u)_{n−1} = u_{n−2} − u_{n−1}. L is symmetric, so the pullback is

    ū = D·inv_dx2·L(λ) + k(1 − 2u)λ,   D̄ = inv_dx2·Σ λ·L(u),   k̄ = Σ λ·u(1 − u).

Each kernel sits behind a `torch.library` operator, `rd1d_fwd` (K1) and
`rd1d_vjp` (K2). A CPU tensor goes to the plain version (`rd1d_reference`,
`rd1d_vjp_reference`); a CUDA tensor launches the kernel of
`csrc/rd1d.cu` (`rd1d_fwd_cuda`, `rd1d_vjp_cuda`) or raises. Being
dispatcher operators, they receive plain tensors even inside
`torch.func.vjp`, whose own wrappers have no data pointer to hand a kernel.
Each CUDA wrapper counts its launches in `.launches`.

What bounds the kernels on an H100, and what the design does about it, is
noted in `csrc/rd1d.cu` and `csrc/rd1d_rk4.cu`: K1 and K2 stream memory
(8 and 12 bytes per float32 cell), K5 and K6 keep the window on chip
through every stage and are bound by operations. All read D and k from the
device vector p, so no launch waits on a host read, and reduce dD and dk
in a fixed order.

The RK4 block's operators `rd1d_rk4_fwd` (K5) and `rd1d_rk4_vjp` (K6)
follow the same rule: a CPU tensor runs the plain version over the whole
grid (`rd1d_rk4_scan_reference`, `rd1d_rk4_block_vjp_reference`), a CUDA
tensor launches the kernel over haloed windows or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from .cuda_build import load_library
from .vjp import refuse_forward_mode

__all__ = ["rd1d_reference", "rd1d_vjp_reference", "rd1d_fwd", "rd1d_vjp",
           "rd1d_fwd_cuda", "rd1d_vjp_cuda", "fused_rd1d", "FusedRD1D",
           "make_rd1d_field", "load_rd1d_library",
           "rd1d_rk4_scan_reference", "rd1d_rk4_block_vjp_reference",
           "rd1d_rk4_fwd", "rd1d_rk4_vjp", "rd1d_rk4_fwd_cuda",
           "rd1d_rk4_vjp_cuda", "RD1DRK4Block", "make_rd1d_rk4_block",
           "load_rd1d_rk4_library", "rd1d_rk4_tile"]


# -- plain versions ----------------------------------------------------------


def _lap(u: torch.Tensor) -> torch.Tensor:
    ul = torch.cat([u[:1], u[:-1]])
    ur = torch.cat([u[1:], u[-1:]])
    return ul - 2.0 * u + ur


def rd1d_reference(u: torch.Tensor, p: torch.Tensor, inv_dx2: float):
    """Plain-torch field (the JAX counterpart takes D and k separately)."""
    D, k = p[0], p[1]
    return D * inv_dx2 * _lap(u) + k * u * (1.0 - u)


def rd1d_vjp_reference(u, p, inv_dx2: float, lam):
    """Plain-torch pullback: (ū, [D̄, k̄]) for the cotangent λ."""
    D, k = p[0], p[1]
    du = D * inv_dx2 * _lap(lam) + k * (1.0 - 2.0 * u) * lam
    dD = inv_dx2 * torch.sum(lam * _lap(u))
    dk = torch.sum(lam * u * (1.0 - u))
    return du, torch.stack([dD, dk])


# -- CUDA wrappers -------------------------------------------------------------


def load_rd1d_library() -> ctypes.CDLL:
    """Build (first use only) and load csrc/rd1d.cu with typed entry points."""
    lib = load_library("rd1d")
    if not getattr(lib, "_rd1d_typed", False):
        ptr, i64, i32, f64 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                              ctypes.c_double)
        for name in ("rd1d_fwd_f32", "rd1d_fwd_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [ptr, ptr, f64, ptr, i64, ptr]
            fn.restype = ctypes.c_int
        for name in ("rd1d_bwd_f32", "rd1d_bwd_f64"):
            fn = getattr(lib, name)
            # u, p, lam, inv_dx2, du, slots, dp, n, vec, stream
            fn.argtypes = [ptr, ptr, ptr, f64, ptr, ptr, ptr, i64, i32, ptr]
            fn.restype = ctypes.c_int
        lib.rd1d_bwd_blocks.argtypes = [i64, i32, i32]
        lib.rd1d_bwd_blocks.restype = i64
        lib.rd1d_bwd_empty_slot.argtypes = []
        lib.rd1d_bwd_empty_slot.restype = i64
        lib._rd1d_typed = True
    return lib


_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _check_cuda_args(u, p, *same_as_u):
    if not u.is_cuda:
        raise ValueError(f"expected a CUDA tensor, got {u.device}")
    if u.dtype not in _SUFFIX:
        raise TypeError(f"rd1d kernels take float32/float64, got {u.dtype}")
    if u.dim() != 1 or u.numel() == 0:
        raise ValueError(f"u must be a non-empty vector, got {tuple(u.shape)}")
    if tuple(p.shape) != (2,):
        raise ValueError(f"p must be [D, k], got shape {tuple(p.shape)}")
    for name, t in [("u", u), ("p", p)] + [("lam", x) for x in same_as_u]:
        if t.device != u.device or t.dtype != u.dtype:
            raise ValueError(f"{name}: {t.device}/{t.dtype}, expected "
                             f"{u.device}/{u.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for x in same_as_u:
        if x.shape != u.shape:
            raise ValueError(f"shape {tuple(x.shape)} != {tuple(u.shape)}")


def _like(u: torch.Tensor) -> torch.Tensor:
    """An empty tensor of u's shape and type whose address matches u's
    modulo 16 bytes, as the kernels' 16-byte vector layout needs: a view
    into a buffer a few elements longer when u is not 16-byte aligned."""
    off = u.data_ptr() % 16 // u.element_size()
    if off == 0:
        return torch.empty_like(u)
    return torch.empty(u.numel() + off, dtype=u.dtype, device=u.device)[off:]


def rd1d_fwd_cuda(u: torch.Tensor, p: torch.Tensor, inv_dx2: float):
    """K1 on the current stream: f = field(u; p), one launch."""
    _check_cuda_args(u, p)
    launch = getattr(load_rd1d_library(), f"rd1d_fwd_{_SUFFIX[u.dtype]}")
    f = _like(u)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(u.data_ptr(), p.data_ptr(), float(inv_dx2), f.data_ptr(),
                    u.numel(), stream)
    if rc != 0:
        raise RuntimeError(f"rd1d_fwd launch failed: cudaError {rc}")
    rd1d_fwd_cuda.launches += 1
    return f


rd1d_fwd_cuda.launches = 0

# (device index, stream, dtype, blocks) -> K2's slots: a 64-bit word per
# block and sum for the block's float64 (D̄, k̄) partial, empty before and
# after every launch on that stream
_K2_WORKSPACE = {}


@functools.lru_cache(maxsize=None)
def _k2_blocks(n: int, elt: int, vec: bool) -> int:
    return load_rd1d_library().rd1d_bwd_blocks(n, elt, int(vec))


def rd1d_vjp_cuda(u: torch.Tensor, p: torch.Tensor, inv_dx2: float,
                  lam: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2 on the current stream: (ū, [D̄, k̄]) in one launch; the grid's
    last block sums the blocks' partials in block order (the same bits every
    call). On 16-byte vectors when lam's address matches u's modulo 16, else
    on single cells."""
    _check_cuda_args(u, p, lam)
    launch = getattr(load_rd1d_library(), f"rd1d_bwd_{_SUFFIX[u.dtype]}")
    vec = (u.data_ptr() - lam.data_ptr()) % 16 == 0
    blocks = _k2_blocks(u.numel(), u.element_size(), vec)
    du = _like(u)
    dp = torch.empty(2, dtype=u.dtype, device=u.device)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        key = (u.device.index, stream, u.dtype, blocks)
        slots = _K2_WORKSPACE.get(key)
        if slots is None:
            # under capture torch.full is only recorded, so the slots would
            # not be empty when an eager launch first reads them
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    "rd1d_vjp: K2's workspace for this stream is made by an "
                    "eager call; call rd1d_vjp once on the capturing stream "
                    "before CUDA graph capture")
            slots = _K2_WORKSPACE[key] = torch.full(
                (2 * blocks,), load_rd1d_library().rd1d_bwd_empty_slot(),
                dtype=torch.int64, device=u.device)
        rc = launch(u.data_ptr(), p.data_ptr(), lam.data_ptr(),
                    float(inv_dx2), du.data_ptr(), slots.data_ptr(),
                    dp.data_ptr(), u.numel(), int(vec), stream)
    if rc != 0:
        raise RuntimeError(f"rd1d_vjp launch failed: cudaError {rc}")
    rd1d_vjp_cuda.launches += 1
    return du, dp


rd1d_vjp_cuda.launches = 0


# -- operators: CPU -> plain version, CUDA -> kernel ----------------------------


@torch.library.custom_op("scimlsens_torch::rd1d_fwd", mutates_args=(),
                         device_types="cpu")
def rd1d_fwd(u: torch.Tensor, p: torch.Tensor, inv_dx2: float) -> torch.Tensor:
    """K1 operator: the field value."""
    return rd1d_reference(u, p, inv_dx2)


@torch.library.custom_op("scimlsens_torch::rd1d_vjp", mutates_args=(),
                         device_types="cpu")
def rd1d_vjp(u: torch.Tensor, p: torch.Tensor, inv_dx2: float,
             lam: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2 operator: (ū, [D̄, k̄])."""
    return rd1d_vjp_reference(u, p, inv_dx2, lam)


rd1d_fwd.register_kernel("cuda")(rd1d_fwd_cuda)
rd1d_vjp.register_kernel("cuda")(rd1d_vjp_cuda)


# -- the field ---------------------------------------------------------------------


class FusedRD1D(torch.autograd.Function):
    """f(u; p) through K1 with the pullback through K2. In the
    `setup_context` form, so `torch.func.vjp` accepts it."""

    @staticmethod
    def forward(u, p, inv_dx2):
        return rd1d_fwd(u, p, float(inv_dx2))

    @staticmethod
    def setup_context(ctx, inputs, output):
        u, p, inv_dx2 = inputs
        ctx.save_for_backward(u, p)
        ctx.inv_dx2 = float(inv_dx2)

    @staticmethod
    def backward(ctx, lam):
        u, p = ctx.saved_tensors
        du, dp = rd1d_vjp(u, p, ctx.inv_dx2, lam.contiguous())
        return du, dp, None

    @staticmethod
    def jvp(ctx, *tangents):
        raise refuse_forward_mode("FusedRD1D (K1/K2)")


def fused_rd1d(u: torch.Tensor, p: torch.Tensor, inv_dx2: float):
    """The field with its fused pullback (`pallas_pde.py:fused_rd1d`, which
    takes D and k as separate scalars)."""
    return FusedRD1D.apply(u, p, inv_dx2)


def make_rd1d_field(n: int, dx: float):
    """ODE field f(u, p, t) on a length-n grid with p = [D, k]; every
    evaluation is one K1 launch and every pullback one K2 launch."""
    inv_dx2 = 1.0 / (dx * dx)

    def field(u, p, t):
        return fused_rd1d(u, p, inv_dx2)

    return field


# -- the RK4 block: plain versions ---------------------------------------------


def _rk4_one(u, p, inv_dx2: float, h: float):
    """One fixed-h RK4 step of the field, in the JAX package's order."""
    k1 = rd1d_reference(u, p, inv_dx2)
    k2 = rd1d_reference(u + 0.5 * h * k1, p, inv_dx2)
    k3 = rd1d_reference(u + 0.5 * h * k2, p, inv_dx2)
    k4 = rd1d_reference(u + h * k3, p, inv_dx2)
    return u + (h / 6.0) * (k1 + 2.0 * (k2 + k3) + k4)


def rd1d_rk4_scan_reference(u, p, inv_dx2: float, h: float, n_steps: int):
    """n_steps fixed-h RK4 steps over the whole grid (the JAX scan as a
    loop); K5's plain version with n_steps = S. autograd differentiates it
    directly."""
    for _ in range(n_steps):
        u = _rk4_one(u, p, inv_dx2, h)
    return u


def rd1d_rk4_block_vjp_reference(u, p, inv_dx2: float, h: float, S: int,
                                 lam) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6's plain version: (ū, [D̄, k̄]) of S RK4 steps from u for the
    cotangent λ, by the hand-derived reverse sweep of the TPU kernel
    (pallas_pde.py:253-345) over the whole grid, without windows. Per
    reverse step, with Jᵀ(x)v = D·inv_dx2·L(v) + k(1−2x)·v:

        w4 = (h/6)λ ;            s4 = J(u4)ᵀ w4
        w3 = (2h/6)λ + h·s4 ;    s3 = J(u3)ᵀ w3
        w2 = (2h/6)λ + h/2·s3 ;  s2 = J(u2)ᵀ w2
        w1 = (h/6)λ + h/2·s2 ;   s1 = J(u)ᵀ w1
        λ ← λ + s1 + s2 + s3 + s4

    D̄ sums inv_dx2·(L w_i)·u_i (L is symmetric) and k̄ sums
    w_i·u_i(1 − u_i) over the four stages of every step."""
    D, k = p[0], p[1]
    stages = []
    x = u
    for _ in range(S):
        k1 = rd1d_reference(x, p, inv_dx2)
        x2 = x + 0.5 * h * k1
        k2 = rd1d_reference(x2, p, inv_dx2)
        x3 = x + 0.5 * h * k2
        k3 = rd1d_reference(x3, p, inv_dx2)
        x4 = x + h * k3
        k4 = rd1d_reference(x4, p, inv_dx2)
        stages.append((x, x2, x3, x4))
        x = x + (h / 6.0) * (k1 + 2.0 * (k2 + k3) + k4)
    acc_d = torch.zeros_like(u)
    acc_k = torch.zeros_like(u)
    for x, x2, x3, x4 in reversed(stages):
        w4 = (h / 6.0) * lam
        lw4 = _lap(w4)
        s4 = D * inv_dx2 * lw4 + k * (1.0 - 2.0 * x4) * w4
        w3 = (2.0 * h / 6.0) * lam + h * s4
        lw3 = _lap(w3)
        s3 = D * inv_dx2 * lw3 + k * (1.0 - 2.0 * x3) * w3
        w2 = (2.0 * h / 6.0) * lam + 0.5 * h * s3
        lw2 = _lap(w2)
        s2 = D * inv_dx2 * lw2 + k * (1.0 - 2.0 * x2) * w2
        w1 = (h / 6.0) * lam + 0.5 * h * s2
        lw1 = _lap(w1)
        s1 = D * inv_dx2 * lw1 + k * (1.0 - 2.0 * x) * w1
        acc_d = acc_d + (lw1 * x + lw2 * x2 + lw3 * x3 + lw4 * x4)
        acc_k = acc_k + (w1 * x * (1.0 - x) + w2 * x2 * (1.0 - x2)
                         + w3 * x3 * (1.0 - x3) + w4 * x4 * (1.0 - x4))
        lam = lam + s1 + s2 + s3 + s4
    return lam, torch.stack([inv_dx2 * torch.sum(acc_d), torch.sum(acc_k)])


def _chunk_geometry(n: int, S: int, chunk: int):
    """(C, H, W, G): G interior tiles of C cells, each advanced S steps from
    a window of W = C + 2H cells. The stencil reaches 4 cells per RK4 step,
    so H = 4(S+1) covers S steps plus the reverse pass's stage reach. One
    tile (C = n) needs no halo. The contracts of the TPU version hold: n
    divisible by the chunk, and chunks at least one halo wide (a narrower
    chunk would let a clipped edge window miss its interior cells)."""
    C = min(chunk, n)
    H = 0 if C >= n else 4 * (S + 1)
    W = min(C + 2 * H, n)
    G = -(-n // C)
    if G * C != n:
        raise ValueError(
            f"rd1d megakernel needs n divisible by the chunk; "
            f"n={n}, chunk={C}"
        )
    if H and C < H:
        raise ValueError(
            f"rd1d megakernel chunk ({C}) must be >= the halo width "
            f"4*(S+1) = {H}; lower S or raise chunk"
        )
    return C, H, W, G


# -- the RK4 block: CUDA wrappers ---------------------------------------------


def load_rd1d_rk4_library() -> ctypes.CDLL:
    """Build (first use only) and load csrc/rd1d_rk4.cu with typed entry
    points."""
    lib = load_library("rd1d_rk4")
    if not getattr(lib, "_rd1d_rk4_typed", False):
        ptr, i64, i32, f64 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                              ctypes.c_double)
        geometry = [i64, i32, i32, i32, i32, ptr]  # n, S, C, H, W, stream
        for name in ("rd1d_rk4_fwd_f32", "rd1d_rk4_fwd_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [ptr, ptr, f64, f64, ptr] + geometry
            fn.restype = ctypes.c_int
        for name in ("rd1d_rk4_bwd_f32", "rd1d_rk4_bwd_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [ptr, ptr, ptr, f64, f64, ptr, ptr, ptr] + geometry
            fn.restype = ctypes.c_int
        # which (0 K5, 1 K6), W, S, bytes per value -> R, threads, smem, max
        lib.rd1d_rk4_tile.argtypes = [i32, i32, i32, i32, ptr, ptr, ptr, ptr]
        lib.rd1d_rk4_tile.restype = ctypes.c_int
        lib.rd1d_rk4_smem_limit.argtypes = [i32]
        lib.rd1d_rk4_smem_limit.restype = i64
        lib._rd1d_rk4_typed = True
    return lib


def rd1d_rk4_tile(which: str, W: int, S: int, dtype: torch.dtype):
    """(R, threads, smem bytes, most threads) of a K5 (`which="fwd"`) or K6
    (`"bwd"`) block over a window of W cells at S steps: each thread holds R
    consecutive cells in registers; K6 adds its entry-state cache in shared
    memory."""
    lib = load_rd1d_rk4_library()
    R, threads, max_threads = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    smem = ctypes.c_int64()
    elt = torch.tensor([], dtype=dtype).element_size()
    rc = lib.rd1d_rk4_tile(0 if which == "fwd" else 1, W, S, elt,
                           ctypes.byref(R), ctypes.byref(threads),
                           ctypes.byref(smem), ctypes.byref(max_threads))
    if rc != 0:
        raise ValueError(f"no rd1d RK4 {which} kernel for {dtype}")
    return R.value, threads.value, smem.value, max_threads.value


# (which, n, S, chunk, dtype, device index) -> (geometry, tiles): the checks
# below run once per geometry, kernel, type and device
_RK4_CHECKED = {}


def _rk4_launch_args(u, S: int, chunk: int, which: str):
    """The geometry and a check that the window fits the kernel's register
    tile and, for K6, the card's shared memory, for K5 (`which="fwd"`) or K6
    (`"bwd"`)."""
    n = u.numel()
    key = (which, n, S, chunk, u.dtype, u.device.index)
    hit = _RK4_CHECKED.get(key)
    if hit is not None:
        return hit
    C, H, W, G = _chunk_geometry(n, S, chunk)
    R, threads, need, max_threads = rd1d_rk4_tile(which, W, S, u.dtype)
    knob = "chunk" if which == "fwd" else "bwd_chunk"
    limit = load_rd1d_rk4_library().rd1d_rk4_smem_limit(u.device.index)
    if need > limit:
        raise ValueError(
            f"rd1d RK4 {which} kernel: a window of {W} cells at S={S} needs "
            f"{need} bytes of shared memory, the card allows {limit}; lower "
            f"the {knob} or S")
    if threads > max_threads:
        raise ValueError(
            f"rd1d RK4 {which} kernel: a window of {W} cells needs {threads} "
            f"threads of {R} cells, and its register tile holds at most "
            f"{max_threads} threads ({max_threads * R} cells); lower the "
            f"{knob}")
    _RK4_CHECKED[key] = hit = ((n, S, C, H, W), G)
    return hit


def rd1d_rk4_fwd_cuda(u: torch.Tensor, p: torch.Tensor, inv_dx2: float,
                      h: float, S: int, chunk: int) -> torch.Tensor:
    """K5 on the current stream: u after S RK4 steps, one block per
    interior tile of `chunk` cells."""
    _check_cuda_args(u, p)
    geometry, _ = _rk4_launch_args(u, S, chunk, "fwd")
    launch = getattr(load_rd1d_rk4_library(),
                     f"rd1d_rk4_fwd_{_SUFFIX[u.dtype]}")
    out = torch.empty_like(u)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(u.data_ptr(), p.data_ptr(), float(inv_dx2), float(h),
                    out.data_ptr(), *geometry, stream)
    if rc != 0:
        raise RuntimeError(f"rd1d_rk4_fwd launch failed: cudaError {rc}")
    rd1d_rk4_fwd_cuda.launches += 1
    return out


rd1d_rk4_fwd_cuda.launches = 0


def rd1d_rk4_vjp_cuda(u: torch.Tensor, p: torch.Tensor, inv_dx2: float,
                      h: float, S: int, chunk: int,
                      lam: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6 on the current stream: (ū, [D̄, k̄]) of S RK4 steps from u, one
    block per interior tile of `chunk` cells, then a one-block pass that
    sums the per-tile (D̄, k̄) partials in a fixed order (no atomics)."""
    _check_cuda_args(u, p, lam)
    geometry, G = _rk4_launch_args(u, S, chunk, "bwd")
    launch = getattr(load_rd1d_rk4_library(),
                     f"rd1d_rk4_bwd_{_SUFFIX[u.dtype]}")
    du = torch.empty_like(u)
    partials = torch.empty(2 * G, dtype=u.dtype, device=u.device)
    dp = torch.empty(2, dtype=u.dtype, device=u.device)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(u.data_ptr(), p.data_ptr(), lam.data_ptr(),
                    float(inv_dx2), float(h), du.data_ptr(),
                    partials.data_ptr(), dp.data_ptr(), *geometry, stream)
    if rc != 0:
        raise RuntimeError(f"rd1d_rk4_vjp launch failed: cudaError {rc}")
    rd1d_rk4_vjp_cuda.launches += 1
    return du, dp


rd1d_rk4_vjp_cuda.launches = 0


# -- the RK4 block: operators and the block function -------------------------


@torch.library.custom_op("scimlsens_torch::rd1d_rk4_fwd", mutates_args=(),
                         device_types="cpu")
def rd1d_rk4_fwd(u: torch.Tensor, p: torch.Tensor, inv_dx2: float, h: float,
                 S: int, chunk: int) -> torch.Tensor:
    """K5 operator: u after S RK4 steps (`chunk` sets the CUDA tiling)."""
    return rd1d_rk4_scan_reference(u, p, inv_dx2, h, S)


@torch.library.custom_op("scimlsens_torch::rd1d_rk4_vjp", mutates_args=(),
                         device_types="cpu")
def rd1d_rk4_vjp(u: torch.Tensor, p: torch.Tensor, inv_dx2: float, h: float,
                 S: int, chunk: int,
                 lam: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6 operator: (ū, [D̄, k̄]) of the S-step block."""
    return rd1d_rk4_block_vjp_reference(u, p, inv_dx2, h, S, lam)


rd1d_rk4_fwd.register_kernel("cuda")(rd1d_rk4_fwd_cuda)
rd1d_rk4_vjp.register_kernel("cuda")(rd1d_rk4_vjp_cuda)


class RD1DRK4Block(torch.autograd.Function):
    """S RK4 steps through K5 with the exact discrete pullback through K6.
    Only the block's entry state is kept for the backward pass: K6 steps
    the window again from it. In the `setup_context` form."""

    @staticmethod
    def forward(u, p, inv_dx2, h, S, chunk, bwd_chunk):
        return rd1d_rk4_fwd(u, p, float(inv_dx2), float(h), int(S), int(chunk))

    @staticmethod
    def setup_context(ctx, inputs, output):
        u, p, inv_dx2, h, S, _chunk, bwd_chunk = inputs
        ctx.save_for_backward(u, p)
        ctx.args = (float(inv_dx2), float(h), int(S), int(bwd_chunk))

    @staticmethod
    def backward(ctx, lam):
        u, p = ctx.saved_tensors
        inv_dx2, h, S, bwd_chunk = ctx.args
        du, dp = rd1d_rk4_vjp(u, p, inv_dx2, h, S, bwd_chunk, lam.contiguous())
        return du, dp, None, None, None, None, None

    @staticmethod
    def jvp(ctx, *tangents):
        raise refuse_forward_mode("RD1DRK4Block (K5/K6)")


def make_rd1d_rk4_block(n: int, S: int, chunk: int = 4096,
                        bwd_chunk: int = 1024):
    """S-step RK4 megakernel over a length-n grid: returns
    `block(u, p, inv_dx2, h)`, u after S fixed-h RK4 steps of the rd1d
    field, p = [D, k] a tensor on u's device (the JAX version takes D and k
    separately). Differentiable in u and p by the exact discrete adjoint.

    On a card, `chunk` is K5's interior tile and `bwd_chunk` K6's: each
    CUDA block advances one tile of that many cells from a window of
    tile + 2·4(S+1) cells, R consecutive cells per thread in registers
    (`rd1d_rk4_tile`). The defaults differ from the JAX package's
    (chunk=65536, bwd_chunk=chunk//2), whose windows no block holds: a K5
    thread holds 8 cells (16 in windows above 4608 float32 or 4096 float64
    cells), a block at most 640 threads of 16 in float32 (384 in float64),
    so windows up to 10,240 (6,144) cells; K6 keeps the S step-entry states
    of its window in shared memory, 80 KB (float32) and 160 KB (float64) at
    1024 and S = 16, two blocks per SM in float32. Both contracts of
    `_chunk_geometry` are checked here, as in JAX; a window that a kernel
    does not take raises at launch.
    On the CPU the block runs the plain versions over the whole grid."""
    C, _, _, _ = _chunk_geometry(n, S, chunk)
    Cb, _, _, _ = _chunk_geometry(n, S, bwd_chunk)

    def block(u, p, inv_dx2, h):
        if tuple(u.shape) != (n,):
            raise ValueError(f"block of n={n} got u of shape {tuple(u.shape)}")
        return RD1DRK4Block.apply(u, p, inv_dx2, h, S, C, Cb)

    return block
