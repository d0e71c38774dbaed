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

On a state split over the ranks of a process group (a DTensor,
`parallel/sharded.py`) the field runs on each rank's shard: K1 and K2 take
the shard's two ghost cells, its neighbours' edge cells (the edge copy at
the global ends), from a small device tensor (`ghosts`, [left, right] of u,
then of λ for K2): one halo exchange per evaluation and one of u's and λ's
edge cells per pullback. D̄ and k̄ are then the rank's partial sums.

Each kernel sits behind a `torch.library` operator, `rd1d_fwd` (K1) and
`rd1d_vjp` (K2). A CPU tensor goes to the plain version (`rd1d_reference`,
`rd1d_vjp_reference`); a CUDA tensor launches the kernel of
`csrc/rd1d.cu` (`rd1d_fwd_cuda`, `rd1d_vjp_cuda`) or raises. Being
dispatcher operators, they receive plain tensors even inside
`torch.func.vjp`, whose own wrappers have no data pointer to hand a kernel.
Each CUDA wrapper counts its launches in `.launches`. The pullback
operators (K2, K6) register a backward that raises
`ops.vjp.DoubleBackwardUnsupported`, so a second derivative through a
kernel fails by name instead of missing the kernel's terms, and the
Functions refuse a complex input before launch.

What bounds the kernels on an H100, and what the design does about it, is
noted in `csrc/rd1d.cu` and `csrc/rd1d_rk4.cu`: K1 and K2 stream memory
(8 and 12 bytes per float32 cell), K5 and K6 keep the window on chip
through every stage and are bound by operations. All read D and k from the
device vector p, so no launch waits on a host read, and reduce dD and dk
in a fixed order.

The RK4 block's operators `rd1d_rk4_fwd` (K5) and `rd1d_rk4_vjp` (K6)
follow the same rule: a CPU tensor runs the plain version over the whole
grid (`rd1d_rk4_scan_reference`, `rd1d_rk4_block_vjp_reference`), a CUDA
tensor launches the kernel over haloed windows or raises. On a sharded
state the block runs on each rank's shard (`ShardedRD1DRK4Block`): one
exchange per block call gives the shard H = 4(S+1) ghost cells per side
(u's; u's and λ's in the pullback), K5 and K6 read the part of a window
that lies across a cut from that buffer, and the plain versions run over
the shard widened by its ghosts.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from ..parallel import sharded
from .cuda_build import load_library
from .vjp import (refuse_complex_state, refuse_double_backward,
                  refuse_forward_mode, register_kernel_function)

__all__ = ["rd1d_reference", "rd1d_vjp_reference", "rd1d_fwd", "rd1d_vjp",
           "rd1d_fwd_cuda", "rd1d_vjp_cuda", "fused_rd1d", "FusedRD1D",
           "make_rd1d_field", "load_rd1d_library",
           "rd1d_rk4_scan_reference", "rd1d_rk4_block_vjp_reference",
           "rd1d_rk4_fwd", "rd1d_rk4_vjp", "rd1d_rk4_fwd_cuda",
           "rd1d_rk4_vjp_cuda", "RD1DRK4Block", "ShardedRD1DRK4Block",
           "make_rd1d_rk4_block", "load_rd1d_rk4_library", "rd1d_rk4_tile"]


# -- plain versions ----------------------------------------------------------


def _lap(u: torch.Tensor, ghosts=None) -> torch.Tensor:
    """L(u) with the edge-copy ghosts, or with ghosts = [left, right]."""
    left, right = (u[:1], u[-1:]) if ghosts is None else (ghosts[:1],
                                                          ghosts[1:2])
    ul = torch.cat([left, u[:-1]])
    ur = torch.cat([u[1:], right])
    return ul - 2.0 * u + ur


def rd1d_reference(u: torch.Tensor, p: torch.Tensor, inv_dx2: float,
                   ghosts=None):
    """Plain-torch field (the JAX counterpart takes D and k separately);
    ghosts: None (the edge copy) or a shard's [left, right] ghost cells."""
    D, k = p[0], p[1]
    return D * inv_dx2 * _lap(u, ghosts) + k * u * (1.0 - u)


def rd1d_vjp_reference(u, p, inv_dx2: float, lam, ghosts=None):
    """Plain-torch pullback: (ū, [D̄, k̄]) for the cotangent λ; ghosts:
    None or a shard's [u left, u right, λ left, λ right]."""
    D, k = p[0], p[1]
    gu, gl = (None, None) if ghosts is None else (ghosts[:2], ghosts[2:])
    du = D * inv_dx2 * _lap(lam, gl) + k * (1.0 - 2.0 * u) * lam
    dD = inv_dx2 * torch.sum(lam * _lap(u, gu))
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
            # u, p, inv_dx2, f, n, ghosts (or null), stream
            fn.argtypes = [ptr, ptr, f64, ptr, i64, ptr, ptr]
            fn.restype = ctypes.c_int
        for name in ("rd1d_bwd_f32", "rd1d_bwd_f64"):
            fn = getattr(lib, name)
            # u, p, lam, inv_dx2, du, slots, dp, n, vec, ghosts, stream
            fn.argtypes = [ptr, ptr, ptr, f64, ptr, ptr, ptr, i64, i32, ptr,
                           ptr]
            fn.restype = ctypes.c_int
        lib.rd1d_bwd_blocks.argtypes = [i64, i32, i32]
        lib.rd1d_bwd_blocks.restype = i64
        lib.rd1d_bwd_empty_slot.argtypes = []
        lib.rd1d_bwd_empty_slot.restype = i64
        lib._rd1d_typed = True
    return lib


_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _check_ghosts(u, ghosts, count: int):
    """The device pointer of a shard's ghost cells (count values on u's
    device and type), or None for the edge copy."""
    if ghosts is None:
        return None
    if (ghosts.device != u.device or ghosts.dtype != u.dtype
            or tuple(ghosts.shape) != (count,)
            or not ghosts.is_contiguous()):
        raise ValueError(f"ghosts: {count} contiguous values on {u.device}/"
                         f"{u.dtype}, got {tuple(ghosts.shape)} on "
                         f"{ghosts.device}/{ghosts.dtype}")
    return ghosts.data_ptr()


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


def rd1d_fwd_cuda(u: torch.Tensor, p: torch.Tensor, inv_dx2: float,
                  ghosts=None):
    """K1 on the current stream: f = field(u; p), one launch; ghosts: None
    (the edge copy) or a shard's [left, right] ghost cells on the device.
    Counts its launches in `.launches` and the cells they covered in
    `.cells`."""
    _check_cuda_args(u, p)
    gptr = _check_ghosts(u, ghosts, 2)
    launch = getattr(load_rd1d_library(), f"rd1d_fwd_{_SUFFIX[u.dtype]}")
    f = _like(u)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(u.data_ptr(), p.data_ptr(), float(inv_dx2), f.data_ptr(),
                    u.numel(), gptr, stream)
    if rc != 0:
        raise RuntimeError(f"rd1d_fwd launch failed: cudaError {rc}")
    rd1d_fwd_cuda.launches += 1
    rd1d_fwd_cuda.cells += u.numel()
    return f


rd1d_fwd_cuda.launches = rd1d_fwd_cuda.cells = 0

# (device index, stream, dtype, blocks) -> K2's slots: a 64-bit word per
# block and sum for the block's float64 (D̄, k̄) partial, empty before and
# after every launch on that stream
_K2_WORKSPACE = {}


@functools.lru_cache(maxsize=None)
def _k2_blocks(n: int, elt: int, vec: bool) -> int:
    return load_rd1d_library().rd1d_bwd_blocks(n, elt, int(vec))


def rd1d_vjp_cuda(u: torch.Tensor, p: torch.Tensor, inv_dx2: float,
                  lam: torch.Tensor,
                  ghosts=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2 on the current stream: (ū, [D̄, k̄]) in one launch; the grid's
    last block sums the blocks' partials in block order (the same bits every
    call). On 16-byte vectors when lam's address matches u's modulo 16, else
    on single cells. ghosts: None (the edge copy) or a shard's [u left,
    u right, λ left, λ right] on the device. Counts `.launches` and
    `.cells` as K1 does."""
    _check_cuda_args(u, p, lam)
    gptr = _check_ghosts(u, ghosts, 4)
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
                    dp.data_ptr(), u.numel(), int(vec), gptr, stream)
    if rc != 0:
        raise RuntimeError(f"rd1d_vjp launch failed: cudaError {rc}")
    rd1d_vjp_cuda.launches += 1
    rd1d_vjp_cuda.cells += u.numel()
    return du, dp


rd1d_vjp_cuda.launches = rd1d_vjp_cuda.cells = 0


# -- operators: CPU -> plain version, CUDA -> kernel ----------------------------


@torch.library.custom_op("scimlsens_torch::rd1d_fwd", mutates_args=(),
                         device_types="cpu")
def rd1d_fwd(u: torch.Tensor, p: torch.Tensor, inv_dx2: float,
             ghosts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K1 operator: the field value (ghosts: a shard's, or None)."""
    return rd1d_reference(u, p, inv_dx2, ghosts)


@torch.library.custom_op("scimlsens_torch::rd1d_vjp", mutates_args=(),
                         device_types="cpu")
def rd1d_vjp(u: torch.Tensor, p: torch.Tensor, inv_dx2: float,
             lam: torch.Tensor, ghosts: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2 operator: (ū, [D̄, k̄]) (ghosts: a shard's, or None)."""
    return rd1d_vjp_reference(u, p, inv_dx2, lam, ghosts)


rd1d_fwd.register_kernel("cuda")(rd1d_fwd_cuda)
rd1d_vjp.register_kernel("cuda")(rd1d_vjp_cuda)


def _refuse_k2_backward(ctx, *grads):
    raise refuse_double_backward("FusedRD1D (K1/K2)")


rd1d_vjp.register_autograd(_refuse_k2_backward)


# -- the field ---------------------------------------------------------------------


class FusedRD1D(torch.autograd.Function):
    """f(u; p) through K1 with the pullback through K2. In the
    `setup_context` form, so `torch.func.vjp` accepts it."""

    @staticmethod
    def forward(u, p, inv_dx2):
        if u.is_complex():
            raise refuse_complex_state("FusedRD1D (K1/K2)", u.dtype)
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


register_kernel_function(FusedRD1D, "FusedRD1D (K1/K2)")


def fused_rd1d(u: torch.Tensor, p: torch.Tensor, inv_dx2: float):
    """The field with its fused pullback (`pallas_pde.py:fused_rd1d`, which
    takes D and k as separate scalars)."""
    return FusedRD1D.apply(u, p, inv_dx2)


class ShardedRD1D(torch.autograd.Function):
    """The field on one rank's shard of a sharded state: K1 with the
    shard's ghost cells from one halo exchange, the pullback K2 with u's
    and λ's from one more, D̄ and k̄ the rank's partial sums. In the
    `setup_context` form."""

    @staticmethod
    def forward(u, p, inv_dx2, shard):
        if u.is_complex():
            raise refuse_complex_state("FusedRD1D (K1/K2)", u.dtype)
        ghosts = shard.halo(u)
        return rd1d_fwd(u, p, float(inv_dx2), ghosts)

    @staticmethod
    def setup_context(ctx, inputs, output):
        u, p, inv_dx2, shard = inputs
        ctx.save_for_backward(u, p)
        ctx.inv_dx2, ctx.shard = float(inv_dx2), shard

    @staticmethod
    def backward(ctx, lam):
        u, p = ctx.saved_tensors
        lam = lam.contiguous()
        # one exchange of u's and λ's edge cells
        ghosts = ctx.shard.halo(u, lam)
        du, dp = rd1d_vjp(u, p, ctx.inv_dx2, lam, ghosts)
        return du, dp, None, None

    @staticmethod
    def jvp(ctx, *tangents):
        raise refuse_forward_mode("FusedRD1D (K1/K2)")


register_kernel_function(ShardedRD1D, "FusedRD1D (K1/K2)")


def sharded_rd1d(u, p, inv_dx2: float):
    """The field on a sharded state u (a DTensor, `parallel/sharded.py`):
    K1 on this rank's shard with one ghost cell per side from its
    neighbours, the value a DTensor split like u. p: a replicated DTensor
    or a plain tensor, whose gradient is summed over the ranks."""
    shard = sharded.ShardContext.of(u)
    f = ShardedRD1D.apply(sharded.to_local(u, shard),
                          sharded.replicated_local(p, shard), inv_dx2, shard)
    return sharded.from_local(f, shard)


def make_rd1d_field(n: int, dx: float):
    """ODE field f(u, p, t) on a length-n grid with p = [D, k]; every
    evaluation is one K1 launch and every pullback one K2 launch. On a
    sharded state (a DTensor u) each rank launches them on its shard,
    exchanging one ghost cell per side (`sharded_rd1d`)."""
    inv_dx2 = 1.0 / (dx * dx)

    def field(u, p, t):
        if sharded.is_sharded(u):
            return sharded_rd1d(u, p, inv_dx2)
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
                                 lam, own=None
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6's plain version: (ū, [D̄, k̄]) of S RK4 steps from u for the
    cotangent λ, by the hand-derived reverse sweep of the TPU kernel
    (pallas_pde.py:253-345) over the whole grid, without windows; own =
    (a, b) sums D̄ and k̄ over cells [a, b) only (a shard's own cells
    between its ghosts). Per reverse step, with
    Jᵀ(x)v = D·inv_dx2·L(v) + k(1−2x)·v:

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
    if own is not None:
        acc_d, acc_k = acc_d[own[0]:own[1]], acc_k[own[0]:own[1]]
    return lam, torch.stack([inv_dx2 * torch.sum(acc_d), torch.sum(acc_k)])


def _widened(x, ghosts, H: int, left: bool, right: bool):
    """[left ghosts | x | right ghosts] of a shard: the H cells beyond each
    inner end from `ghosts` ([left H | right H]), none at a global end."""
    parts = ([ghosts[:H]] if left else []) + [x] + (
        [ghosts[H:2 * H]] if right else [])
    return torch.cat(parts)


def rd1d_rk4_scan_shard_reference(u, p, inv_dx2: float, h: float, S: int,
                                  ghosts, left: bool, right: bool):
    """K5's plain version on a shard: the scan over the shard widened by
    its ghosts, its own cells kept. The edge copy at a widened end reaches
    4 cells per step, S·4 < H, so the own cells are the whole grid's."""
    H = 4 * (S + 1)
    y = rd1d_rk4_scan_reference(_widened(u, ghosts, H, left, right), p,
                                inv_dx2, h, S)
    a = H if left else 0
    return y[a:a + u.numel()]


def rd1d_rk4_block_vjp_shard_reference(u, p, inv_dx2: float, h: float,
                                       S: int, lam, ghosts, left: bool,
                                       right: bool):
    """K6's plain version on a shard: the reverse sweep over the shard
    widened by u's and λ's ghosts ([u left | u right | λ left | λ right],
    H each), ū of its own cells and the partial D̄, k̄ summed over them."""
    H = 4 * (S + 1)
    a = H if left else 0
    du, dp = rd1d_rk4_block_vjp_reference(
        _widened(u, ghosts[:2 * H], H, left, right), p, inv_dx2, h, S,
        _widened(lam, ghosts[2 * H:], H, left, right),
        own=(a, a + u.numel()))
    return du[a:a + u.numel()], dp


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


def _shard_geometry(n: int, S: int, chunk: int, left: bool, right: bool):
    """(C, H, W, G, gl, gr) of one rank's shard of n cells: `_chunk_geometry`'s
    contracts on the local length, with H = 4(S+1) whatever the tile count
    (a one-tile shard with a neighbour still needs its halo), gl / gr = H
    ghost cells on a side with a neighbour and 0 at a global end, and
    W = min(C + 2H, gl + n + gr), so that every window lies inside the
    widened shard."""
    H = 4 * (S + 1)
    if n < H:
        raise sharded.ShardedStateError(
            f"the RK4 block (K5/K6) on a sharded state needs every shard to "
            f"hold at least 4*(S+1) = {H} cells, the ghost width its "
            f"neighbours read; a shard holds {n}: use fewer ranks, more "
            "cells or a lower S")
    C = min(chunk, n)
    if n % C:
        raise sharded.ShardedStateError(
            f"the RK4 block (K5/K6) needs each shard's length divisible by "
            f"the chunk; a shard of {n} cells, chunk={C}")
    G = n // C
    if G > 1 and C < H:
        raise sharded.ShardedStateError(
            f"rd1d megakernel chunk ({C}) must be >= the halo width "
            f"4*(S+1) = {H}; lower S or raise chunk")
    gl, gr = (H if left else 0), (H if right else 0)
    return C, H, min(C + 2 * H, gl + n + gr), G, gl, gr


# -- the RK4 block: CUDA wrappers ---------------------------------------------


def load_rd1d_rk4_library() -> ctypes.CDLL:
    """Build (first use only) and load csrc/rd1d_rk4.cu with typed entry
    points."""
    lib = load_library("rd1d_rk4")
    if not getattr(lib, "_rd1d_rk4_typed", False):
        ptr, i64, i32, f64 = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                              ctypes.c_double)
        # n, S, C, H, W, ghosts (or null), gl, gr, stream
        geometry = [i64, i32, i32, i32, i32, ptr, i32, i32, ptr]
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


def _rk4_launch_args(u, S: int, chunk: int, which: str, sides=None):
    """The geometry and a check that the window fits the kernel's register
    tile and, for K6, the card's shared memory, for K5 (`which="fwd"`) or K6
    (`"bwd"`); sides: None for a whole grid, or a shard's (left, right),
    whether it has a neighbour there."""
    n = u.numel()
    key = (which, n, S, chunk, u.dtype, u.device.index, sides)
    hit = _RK4_CHECKED.get(key)
    if hit is not None:
        return hit
    if sides is None:
        C, H, W, G = _chunk_geometry(n, S, chunk)
        gl = gr = 0
    else:
        C, H, W, G, gl, gr = _shard_geometry(n, S, chunk, *sides)
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
    _RK4_CHECKED[key] = hit = ((n, S, C, H, W), G, (gl, gr))
    return hit


def _rk4_ghost_args(u, S: int, ghosts, left: bool, right: bool,
                    count: int):
    """(sides, pointer) of K5's / K6's ghost buffer: (None, None) for a
    whole grid, else the shard's sides and the device pointer of its
    `count` × 4(S+1) ghost cells."""
    if ghosts is None:
        if left or right:
            raise ValueError("a shard's sides need its ghost buffer")
        return None, None
    return (bool(left), bool(right)), _check_ghosts(u, ghosts,
                                                    count * 4 * (S + 1))


def rd1d_rk4_fwd_cuda(u: torch.Tensor, p: torch.Tensor, inv_dx2: float,
                      h: float, S: int, chunk: int, ghosts=None,
                      left: bool = False, right: bool = False
                      ) -> torch.Tensor:
    """K5 on the current stream: u after S RK4 steps, one block per
    interior tile of `chunk` cells. ghosts: None (a whole grid), or a
    shard's [left H | right H] cells beyond its ends on the device, with
    `left` / `right` whether it has a neighbour there (H = 4(S+1)). Counts
    its launches in `.launches` and the cells they advanced in `.cells`."""
    _check_cuda_args(u, p)
    sides, gptr = _rk4_ghost_args(u, S, ghosts, left, right, 2)
    geometry, _, edges = _rk4_launch_args(u, S, chunk, "fwd", sides)
    launch = getattr(load_rd1d_rk4_library(),
                     f"rd1d_rk4_fwd_{_SUFFIX[u.dtype]}")
    out = torch.empty_like(u)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(u.data_ptr(), p.data_ptr(), float(inv_dx2), float(h),
                    out.data_ptr(), *geometry, gptr, *edges, stream)
    if rc != 0:
        raise RuntimeError(f"rd1d_rk4_fwd launch failed: cudaError {rc}")
    rd1d_rk4_fwd_cuda.launches += 1
    rd1d_rk4_fwd_cuda.cells += u.numel()
    return out


rd1d_rk4_fwd_cuda.launches = rd1d_rk4_fwd_cuda.cells = 0


def rd1d_rk4_vjp_cuda(u: torch.Tensor, p: torch.Tensor, inv_dx2: float,
                      h: float, S: int, chunk: int, lam: torch.Tensor,
                      ghosts=None, left: bool = False, right: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6 on the current stream: (ū, [D̄, k̄]) of S RK4 steps from u, one
    block per interior tile of `chunk` cells, then a one-block pass that
    sums the per-tile (D̄, k̄) partials in a fixed order (no atomics).
    ghosts: None, or a shard's [u left | u right | λ left | λ right], H
    cells each, with `left` / `right` as for K5; ū is then the shard's own
    cells' and D̄, k̄ the sums over them. Counts `.launches` and `.cells`."""
    _check_cuda_args(u, p, lam)
    sides, gptr = _rk4_ghost_args(u, S, ghosts, left, right, 4)
    geometry, G, edges = _rk4_launch_args(u, S, chunk, "bwd", sides)
    launch = getattr(load_rd1d_rk4_library(),
                     f"rd1d_rk4_bwd_{_SUFFIX[u.dtype]}")
    du = torch.empty_like(u)
    partials = torch.empty(2 * G, dtype=u.dtype, device=u.device)
    dp = torch.empty(2, dtype=u.dtype, device=u.device)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(u.data_ptr(), p.data_ptr(), lam.data_ptr(),
                    float(inv_dx2), float(h), du.data_ptr(),
                    partials.data_ptr(), dp.data_ptr(), *geometry, gptr,
                    *edges, stream)
    if rc != 0:
        raise RuntimeError(f"rd1d_rk4_vjp launch failed: cudaError {rc}")
    rd1d_rk4_vjp_cuda.launches += 1
    rd1d_rk4_vjp_cuda.cells += u.numel()
    return du, dp


rd1d_rk4_vjp_cuda.launches = rd1d_rk4_vjp_cuda.cells = 0


# -- the RK4 block: operators and the block function -------------------------


@torch.library.custom_op("scimlsens_torch::rd1d_rk4_fwd", mutates_args=(),
                         device_types="cpu")
def rd1d_rk4_fwd(u: torch.Tensor, p: torch.Tensor, inv_dx2: float, h: float,
                 S: int, chunk: int, ghosts: Optional[torch.Tensor] = None,
                 left: bool = False, right: bool = False) -> torch.Tensor:
    """K5 operator: u after S RK4 steps (`chunk` sets the CUDA tiling);
    ghosts, left, right: a shard's, as `rd1d_rk4_fwd_cuda` takes them."""
    if ghosts is None:
        return rd1d_rk4_scan_reference(u, p, inv_dx2, h, S)
    return rd1d_rk4_scan_shard_reference(u, p, inv_dx2, h, S, ghosts, left,
                                         right)


@torch.library.custom_op("scimlsens_torch::rd1d_rk4_vjp", mutates_args=(),
                         device_types="cpu")
def rd1d_rk4_vjp(u: torch.Tensor, p: torch.Tensor, inv_dx2: float, h: float,
                 S: int, chunk: int, lam: torch.Tensor,
                 ghosts: Optional[torch.Tensor] = None, left: bool = False,
                 right: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6 operator: (ū, [D̄, k̄]) of the S-step block (ghosts, left,
    right: a shard's, as `rd1d_rk4_vjp_cuda` takes them)."""
    if ghosts is None:
        return rd1d_rk4_block_vjp_reference(u, p, inv_dx2, h, S, lam)
    return rd1d_rk4_block_vjp_shard_reference(u, p, inv_dx2, h, S, lam,
                                              ghosts, left, right)


rd1d_rk4_fwd.register_kernel("cuda")(rd1d_rk4_fwd_cuda)
rd1d_rk4_vjp.register_kernel("cuda")(rd1d_rk4_vjp_cuda)


def _refuse_k6_backward(ctx, *grads):
    raise refuse_double_backward("RD1DRK4Block (K5/K6)")


rd1d_rk4_vjp.register_autograd(_refuse_k6_backward)


class RD1DRK4Block(torch.autograd.Function):
    """S RK4 steps through K5 with the exact discrete pullback through K6.
    Only the block's entry state is kept for the backward pass: K6 steps
    the window again from it. In the `setup_context` form."""

    @staticmethod
    def forward(u, p, inv_dx2, h, S, chunk, bwd_chunk):
        if u.is_complex():
            raise refuse_complex_state("RD1DRK4Block (K5/K6)", u.dtype)
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


register_kernel_function(RD1DRK4Block, "RD1DRK4Block (K5/K6)")


class ShardedRD1DRK4Block(torch.autograd.Function):
    """The block on one rank's shard: K5 with the shard's 4(S+1) ghost
    cells per side from one halo exchange, the pullback K6 with u's and
    λ's from one more; ū is the shard's own cells' (each K6 tile's
    windowed adjoint, no scatter of ghost cotangents), D̄ and k̄ the rank's
    partial sums. In the `setup_context` form."""

    @staticmethod
    def forward(u, p, inv_dx2, h, S, chunk, bwd_chunk, shard):
        if u.is_complex():
            raise refuse_complex_state("RD1DRK4Block (K5/K6)", u.dtype)
        ghosts = shard.halo(u, width=4 * (S + 1))
        return rd1d_rk4_fwd(u, p, float(inv_dx2), float(h), int(S),
                            int(chunk), ghosts, *shard.sides)

    @staticmethod
    def setup_context(ctx, inputs, output):
        u, p, inv_dx2, h, S, _chunk, bwd_chunk, shard = inputs
        ctx.save_for_backward(u, p)
        ctx.args = (float(inv_dx2), float(h), int(S), int(bwd_chunk))
        ctx.shard = shard

    @staticmethod
    def backward(ctx, lam):
        u, p = ctx.saved_tensors
        inv_dx2, h, S, bwd_chunk = ctx.args
        lam = lam.contiguous()
        ghosts = ctx.shard.halo(u, lam, width=4 * (S + 1))
        du, dp = rd1d_rk4_vjp(u, p, inv_dx2, h, S, bwd_chunk, lam, ghosts,
                              *ctx.shard.sides)
        return du, dp, None, None, None, None, None, None

    @staticmethod
    def jvp(ctx, *tangents):
        raise refuse_forward_mode("RD1DRK4Block (K5/K6)")


register_kernel_function(ShardedRD1DRK4Block, "RD1DRK4Block (K5/K6)")


def _sharded_block(u, p, inv_dx2, h, S, chunk, bwd_chunk):
    """The block on a sharded state u (a DTensor): each rank's shard through
    `ShardedRD1DRK4Block`, the value a DTensor split like u. Every shard's
    geometry is checked on every rank, so a shard that the kernels cannot
    take raises `ShardedStateError` on all of them before any exchange."""
    shard = sharded.ShardContext.of(u)
    for r, size in enumerate(shard.sizes):
        sides = (r > 0, r + 1 < shard.world)
        for c in (chunk, bwd_chunk):
            _shard_geometry(size, S, c, *sides)
    out = ShardedRD1DRK4Block.apply(
        sharded.to_local(u, shard), sharded.replicated_local(p, shard),
        inv_dx2, h, S, chunk, bwd_chunk, shard)
    return sharded.from_local(out, shard)


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
    On the CPU the block runs the plain versions over the whole grid.

    A sharded u (a DTensor with placement Shard(0), `parallel/sharded.py`)
    returns a DTensor placed the same way; p stays a plain tensor (or a
    replicated DTensor), and its gradient is whole and the same on every
    rank. Each rank advances its own shard with the tile geometry of its
    length (the chunk contracts above hold per shard; a shard of fewer than
    4(S+1) cells raises `ShardedStateError` before any launch), reading the
    4(S+1) cells beyond each inner end from one halo exchange per call
    (`ShardedRD1DRK4Block`)."""
    C, _, _, _ = _chunk_geometry(n, S, chunk)
    Cb, _, _, _ = _chunk_geometry(n, S, bwd_chunk)

    def block(u, p, inv_dx2, h):
        if sharded.is_sharded(u):
            if tuple(u.shape) != (n,):
                raise ValueError(
                    f"block of n={n} got u of shape {tuple(u.shape)}")
            return _sharded_block(u, p, inv_dx2, h, S, chunk, bwd_chunk)
        if tuple(u.shape) != (n,):
            raise ValueError(f"block of n={n} got u of shape {tuple(u.shape)}")
        return RD1DRK4Block.apply(u, p, inv_dx2, h, S, C, Cb)

    return block
