"""1-D reaction-diffusion field with a hand-written CUDA forward and fused
pullback (PyTorch port).

Counterpart of `scimlsensitivity_jl_tpu/ops/pallas_pde.py`:
`rd1d_reference` (:48), `fused_rd1d` (:87) with its Pallas forward
(`_rd_fwd` :92, kernel `_fwd_kernel` :58) and fused Pallas pullback
(`_rd_bwd_rule` :114, kernel `_bwd_kernel` :66), and `make_rd1d_field`
(:474). The RK4 block megakernel of the same file waits (ROADMAP K5, K6).

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
noted in `csrc/rd1d.cu`: both stream memory (8 and 12 bytes per float32
cell), read D and k from the device vector p so no launch waits on a host
read, and reduce dD and dk in a fixed order.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .cuda_build import load_library

__all__ = ["rd1d_reference", "rd1d_vjp_reference", "rd1d_fwd", "rd1d_vjp",
           "rd1d_fwd_cuda", "rd1d_vjp_cuda", "fused_rd1d", "FusedRD1D",
           "make_rd1d_field", "load_rd1d_library"]


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
        ptr, i64, f64 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double
        for name in ("rd1d_fwd_f32", "rd1d_fwd_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [ptr, ptr, f64, ptr, i64, ptr]
            fn.restype = ctypes.c_int
        for name in ("rd1d_bwd_f32", "rd1d_bwd_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [ptr, ptr, ptr, f64, ptr, ptr, ptr, i64, ptr]
            fn.restype = ctypes.c_int
        lib.rd1d_bwd_num_partials.argtypes = [i64]
        lib.rd1d_bwd_num_partials.restype = i64
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


def rd1d_fwd_cuda(u: torch.Tensor, p: torch.Tensor, inv_dx2: float):
    """K1 on the current stream: f = field(u; p)."""
    _check_cuda_args(u, p)
    launch = getattr(load_rd1d_library(), f"rd1d_fwd_{_SUFFIX[u.dtype]}")
    f = torch.empty_like(u)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(u.data_ptr(), p.data_ptr(), float(inv_dx2), f.data_ptr(),
                    u.numel(), stream)
    if rc != 0:
        raise RuntimeError(f"rd1d_fwd launch failed: cudaError {rc}")
    rd1d_fwd_cuda.launches += 1
    return f


rd1d_fwd_cuda.launches = 0


def rd1d_vjp_cuda(u: torch.Tensor, p: torch.Tensor, inv_dx2: float,
                  lam: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2 on the current stream: (ū, [D̄, k̄]); two passes, no atomics."""
    _check_cuda_args(u, p, lam)
    lib = load_rd1d_library()
    launch = getattr(lib, f"rd1d_bwd_{_SUFFIX[u.dtype]}")
    du = torch.empty_like(u)
    partials = torch.empty(2 * lib.rd1d_bwd_num_partials(u.numel()),
                           dtype=u.dtype, device=u.device)
    dp = torch.empty(2, dtype=u.dtype, device=u.device)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = launch(u.data_ptr(), p.data_ptr(), lam.data_ptr(),
                    float(inv_dx2), du.data_ptr(), partials.data_ptr(),
                    dp.data_ptr(), u.numel(), stream)
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
