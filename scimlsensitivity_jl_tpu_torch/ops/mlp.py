"""Fused 2-layer tanh MLP field with a hand-written CUDA forward and fused
pullback (PyTorch port).

Counterpart of `scimlsensitivity_jl_tpu/ops/pallas_mlp.py`:
`mlp2_reference` (:37), `fused_mlp2` (:147) with its Pallas forward
(`_fused_fwd_call` :98, kernel `_fwd_kernel` :53) and fused Pallas pullback
(`_fused_bwd` :123, kernel `_bwd_kernel` :68).

    h = tanh(x·W0 + b0),   y = h·W1 + b1
    dW1 = hᵀg,  db1 = Σ_b g,  dz = (g·W1ᵀ)·(1 − h²),
    db0 = Σ_b dz,  dW0 = xᵀ·dz,  dx = dz·W0ᵀ

Dtype rules are the kernels' (pallas_mlp.py:46-89), not those of a plain
framework matmul: products accumulate in promote(dtype, float32) (float64
for float64, float32 for float32 and bfloat16), h is stored in x's dtype and
the second product reads that rounded h, and dz is rounded to x's dtype
before it enters dW0 and dx (db0 sums the unrounded dz).

Each kernel sits behind a `torch.library` operator, `mlp2_fwd` (K3) and
`mlp2_vjp` (K4). A CPU tensor goes to the plain version; a CUDA tensor
launches the kernels of `csrc/mlp2.cu` (`mlp2_fwd_cuda`, `mlp2_vjp_cuda`) or
raises. `mlp2_route` picks the engine before launch: wgmma tiles fed by TMA
for aligned bfloat16 widths, WMMA tiles for other bfloat16 shapes, CUDA-core
tiles for float32 (pipelined, the depth of a product split over blocks
where its tiles alone would leave SMs idle) and float64; nothing on the
card falls back to the plain version. Each CUDA wrapper counts its calls
in `.launches` and, per route, in `.routes`. What bounds the kernels on an
H100 and what the design does about it is noted in `csrc/mlp2.cu`. The pullback operator (K4) registers a
backward that raises `ops.vjp.DoubleBackwardUnsupported`, and `FusedMLP2`
refuses a complex input before launch.

On a batch split by rows over the ranks of a process group (a 2-D
DTensor x with placement Shard(0), `parallel/sharded.py`) `fused_mlp2`
runs `FusedMLP2` on each rank's rows: the weights are replicated, their
cotangents the rank's partial sums, and no product goes through DTensor's
matmul rules.

The JAX `fused_mlp2` sends shapes above ~12 MB of TPU VMEM back to the
plain XLA version; that gate is a TPU workaround and is not ported: every
shape goes through the kernels (ROADMAP §3).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from ..parallel import sharded
from .cuda_build import load_library
from .vjp import (refuse_complex_state, refuse_double_backward,
                  refuse_forward_mode, register_kernel_function)

__all__ = ["mlp2_reference", "mlp2_fwd_reference", "mlp2_vjp_reference",
           "mlp2_fwd", "mlp2_vjp", "mlp2_fwd_cuda", "mlp2_vjp_cuda",
           "mlp2_route", "FusedMLP2", "fused_mlp2", "load_mlp2_library"]


# -- plain versions ----------------------------------------------------------


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def mlp2_fwd_reference(x, w0, b0, w1, b1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain (y, h) for x of shape (B, din), under the kernel's dtype rules."""
    dt = x.dtype
    acc = _acc_dtype(dt)
    h = torch.tanh(x.to(acc) @ w0.to(acc) + b0.to(acc)).to(dt)
    y = h.to(acc) @ w1.to(acc) + b1.to(acc)
    return y.to(dt), h


def mlp2_reference(x, w0, b0, w1, b1) -> torch.Tensor:
    """Plain y = tanh(x·W0 + b0)·W1 + b1 (x: (din,) or (B, din))."""
    single = x.dim() == 1
    y, _ = mlp2_fwd_reference(x[None] if single else x, w0, b0, w1, b1)
    return y[0] if single else y


def mlp2_vjp_reference(x, w0, w1, h, g):
    """Plain pullback (dx, dW0, db0, dW1, db1) of the cotangent g of y."""
    dt = x.dtype
    acc = _acc_dtype(dt)
    gf, hf = g.to(acc), h.to(acc)
    dw1 = (hf.T @ gf).to(dt)
    db1 = gf.sum(0).to(dt)
    dz = (gf @ w1.to(acc).T) * (1.0 - hf * hf)
    db0 = dz.sum(0).to(dt)
    dzc = dz.to(dt).to(acc)
    dw0 = (x.to(acc).T @ dzc).to(dt)
    dx = (dzc @ w0.to(acc).T).to(dt)
    return dx, dw0, db0, dw1, db1


# -- CUDA wrappers -------------------------------------------------------------


_ROUTE_DTYPES = {"wgmma": (torch.bfloat16,), "wmma": (torch.bfloat16,),
                 "simt": (torch.float32, torch.float64)}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64", torch.bfloat16: "bf16"}
# rows of g per column partial, and the fewest rows of a dz tile on any
# route (db0's partials are one row per row tile)
_ROWS_PER_PART = 64


def mlp2_route(B: int, din: int, hid: int, dout: int, dtype: torch.dtype,
               aligned: bool) -> str:
    """The engine of `csrc/mlp2.cu` that K3 and K4 take at this shape:
    "wgmma" (TMA + wgmma tiles) for bfloat16 when din, hid and dout are
    multiples of 8 and every operand is 16-byte aligned (`aligned`), since
    TMA reads rows of a multiple of 16 bytes from aligned bases; "wmma" for
    the other bfloat16 shapes; "simt" (CUDA cores) for float32 and float64.
    B may be anything: TMA fills the rows past it with zeros."""
    if dtype in _ROUTE_DTYPES["simt"]:
        return "simt"
    if dtype != torch.bfloat16:
        raise TypeError(f"mlp2 kernels take float32/float64/bfloat16, got {dtype}")
    if aligned and din % 8 == 0 and hid % 8 == 0 and dout % 8 == 0:
        return "wgmma"
    return "wmma"


def load_mlp2_library() -> ctypes.CDLL:
    """Build (first use only) and load csrc/mlp2.cu with typed entry points,
    one pair per route and dtype."""
    lib = load_library("mlp2")
    if not getattr(lib, "_mlp2_typed", False):
        ptr, i64 = ctypes.c_void_p, ctypes.c_int64
        for route, dtypes in _ROUTE_DTYPES.items():
            for dtype in dtypes:
                fn = getattr(lib, f"mlp2_fwd_{route}_{_SUFFIX[dtype]}")
                fn.argtypes = [ptr] * 8 + [i64] * 4 + [ptr]
                fn.restype = ctypes.c_int
                fn = getattr(lib, f"mlp2_bwd_{route}_{_SUFFIX[dtype]}")
                fn.argtypes = [ptr] * 13 + [i64] * 4 + [ptr]
                fn.restype = ctypes.c_int
        lib.mlp2_simt_f32_workspace.argtypes = [i64] * 4 + [ctypes.c_int]
        lib.mlp2_simt_f32_workspace.restype = i64
        lib._mlp2_typed = True
    return lib


def _check_args(x, w0, b0, w1, b1, h=None, g=None, route=None):
    """(B, din, hid, dout, route) of a kernel call; raises, before any
    launch, on a dtype, shape, layout or device the kernels do not take, and
    on a forced `route` that cannot take this call."""
    if x.dtype not in _SUFFIX:
        raise TypeError(f"mlp2 kernels take float32/float64/bfloat16, got "
                        f"{x.dtype}")
    if x.dim() != 2 or w0.dim() != 2 or w1.dim() != 2:
        raise ValueError("x, W0, W1 must be matrices, got "
                         f"{tuple(x.shape)}, {tuple(w0.shape)}, {tuple(w1.shape)}")
    B, din = x.shape
    hid, dout = w1.shape
    if B == 0 or din == 0 or hid == 0 or dout == 0:
        raise ValueError("mlp2 kernels take non-empty shapes")
    want = {"W0": (din, hid), "W1": (hid, dout), "h": (B, hid), "g": (B, dout)}
    if b0 is not None:
        want.update(b0=(hid,), b1=(dout,))
    named = {"x": x, "W0": w0, "b0": b0, "W1": w1, "b1": b1, "h": h, "g": g}
    given = [t for t in named.values() if t is not None]
    for name, t in named.items():
        if t is None:
            continue
        if name in want and tuple(t.shape) != want[name]:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{want[name]}")
        if t.device != x.device or t.dtype != x.dtype:
            raise ValueError(f"{name}: {t.device}/{t.dtype}, expected "
                             f"{x.device}/{x.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    aligned = all(t.data_ptr() % 16 == 0 for t in given)
    natural = mlp2_route(B, din, hid, dout, x.dtype, aligned)
    if route is None:
        route = natural
    elif route not in _ROUTE_DTYPES:
        raise ValueError(f"unknown route {route!r}; the routes are "
                         f"{sorted(_ROUTE_DTYPES)}")
    elif x.dtype not in _ROUTE_DTYPES[route] or (route == "wgmma"
                                                 and natural != "wgmma"):
        raise ValueError(
            f"route {route!r} cannot take {x.dtype} at (B, din, hid, dout) = "
            f"{(B, din, hid, dout)} with 16-byte aligned operands {aligned}; "
            f"mlp2_route gives {natural!r}")
    if not x.is_cuda:
        raise ValueError(f"expected a CUDA tensor, got {x.device}")
    return B, din, hid, dout, route


@functools.lru_cache(maxsize=None)
def _split_words(device: int, B: int, din: int, hid: int, dout: int,
                 bwd: bool) -> int:
    """4-byte words of the float32 route's split workspace for K3 or K4 at
    these widths on that device (the plan follows its SM count); 0 where
    the plan splits no product."""
    with torch.cuda.device(device):
        return load_mlp2_library().mlp2_simt_f32_workspace(
            B, din, hid, dout, int(bwd))


def _split_workspace(x, route, B, din, hid, dout, bwd):
    """The float32 call's split workspace on the simt route, new each call
    (the partial tiles and their arrival counters, which the launcher
    zeroes on the call's stream), or None where the plan splits nothing and
    on the other routes."""
    if route != "simt" or x.dtype != torch.float32:
        return None
    words = _split_words(x.device.index, B, din, hid, dout, bwd)
    if words == 0:
        return None
    return torch.empty(words, dtype=torch.float32, device=x.device)


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def mlp2_fwd_cuda(x, w0, b0, w1, b1, *, route=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3 on the current stream: (y, h), two launches. `route` (private:
    tests and chip_smoke.py) forces an engine that can take the call."""
    B, din, hid, dout, route = _check_args(x, w0, b0, w1, b1, route=route)
    launch = getattr(load_mlp2_library(),
                     f"mlp2_fwd_{route}_{_SUFFIX[x.dtype]}")
    y = x.new_empty((B, dout))
    h = x.new_empty((B, hid))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        work = _split_workspace(x, route, B, din, hid, dout, False)
        rc = launch(x.data_ptr(), w0.data_ptr(), b0.data_ptr(), w1.data_ptr(),
                    b1.data_ptr(), y.data_ptr(), h.data_ptr(), _ptr(work),
                    B, din, hid, dout, stream)
    if rc != 0:
        raise RuntimeError(f"mlp2_fwd ({route}) launch failed: cudaError {rc}")
    mlp2_fwd_cuda.launches += 1
    mlp2_fwd_cuda.routes[route] += 1
    return y, h


mlp2_fwd_cuda.launches = 0
mlp2_fwd_cuda.routes = dict.fromkeys(_ROUTE_DTYPES, 0)


def mlp2_vjp_cuda(x, w0, w1, h, g, *, route=None):
    """K4 on the current stream: (dx, dW0, db0, dW1, db1) in two launches;
    every sum runs in a fixed order (split products add their partials in
    split order), so two calls give the same bits. `route` as for
    `mlp2_fwd_cuda`."""
    B, din, hid, dout, route = _check_args(x, w0, None, w1, None, h, g,
                                           route=route)
    launch = getattr(load_mlp2_library(),
                     f"mlp2_bwd_{route}_{_SUFFIX[x.dtype]}")
    dx = torch.empty_like(x)
    dw0 = torch.empty_like(w0)
    db0 = x.new_empty((hid,))
    dw1 = torch.empty_like(w1)
    db1 = x.new_empty((dout,))
    dzc = torch.empty_like(h)
    # column partials of dz (db0) and of g (db1), one row per 64 rows
    part = torch.empty(-(-B // _ROWS_PER_PART) * (hid + dout),
                       dtype=_acc_dtype(x.dtype), device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        work = _split_workspace(x, route, B, din, hid, dout, True)
        rc = launch(x.data_ptr(), w0.data_ptr(), w1.data_ptr(), h.data_ptr(),
                    g.data_ptr(), dx.data_ptr(), dw0.data_ptr(),
                    db0.data_ptr(), dw1.data_ptr(), db1.data_ptr(),
                    dzc.data_ptr(), part.data_ptr(), _ptr(work), B, din, hid,
                    dout, stream)
    if rc != 0:
        raise RuntimeError(f"mlp2_vjp ({route}) launch failed: cudaError {rc}")
    mlp2_vjp_cuda.launches += 1
    mlp2_vjp_cuda.routes[route] += 1
    return dx, dw0, db0, dw1, db1


mlp2_vjp_cuda.launches = 0
mlp2_vjp_cuda.routes = dict.fromkeys(_ROUTE_DTYPES, 0)


# -- operators: CPU -> plain version, CUDA -> kernel ----------------------------


@torch.library.custom_op("scimlsens_torch::mlp2_fwd", mutates_args=(),
                         device_types="cpu")
def mlp2_fwd(x: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor,
             w1: torch.Tensor, b1: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3 operator: (y, h)."""
    return mlp2_fwd_reference(x, w0, b0, w1, b1)


@torch.library.custom_op("scimlsens_torch::mlp2_vjp", mutates_args=(),
                         device_types="cpu")
def mlp2_vjp(x: torch.Tensor, w0: torch.Tensor, w1: torch.Tensor,
             h: torch.Tensor, g: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                        torch.Tensor, torch.Tensor]:
    """K4 operator: (dx, dW0, db0, dW1, db1)."""
    return mlp2_vjp_reference(x, w0, w1, h, g)


mlp2_fwd.register_kernel("cuda")(mlp2_fwd_cuda)
mlp2_vjp.register_kernel("cuda")(mlp2_vjp_cuda)


def _refuse_k4_backward(ctx, *grads):
    raise refuse_double_backward("FusedMLP2 (K3/K4)")


mlp2_vjp.register_autograd(_refuse_k4_backward)


# -- the field ---------------------------------------------------------------------


class FusedMLP2(torch.autograd.Function):
    """(y, h) through K3 with the pullback through K4. In the
    `setup_context` form, so `torch.func.vjp` accepts it: that form sees only
    inputs and outputs, so h, which K4 needs, is a second output, marked
    non-differentiable."""

    @staticmethod
    def forward(x, w0, b0, w1, b1):
        if x.is_complex():
            raise refuse_complex_state("FusedMLP2 (K3/K4)", x.dtype)
        return mlp2_fwd(x, w0, b0, w1, b1)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w0, _b0, w1, _b1 = inputs
        _y, h = output
        ctx.save_for_backward(x, w0, w1, h)
        ctx.mark_non_differentiable(h)

    @staticmethod
    def backward(ctx, gy, _gh):
        x, w0, w1, h = ctx.saved_tensors
        return mlp2_vjp(x, w0, w1, h, gy.contiguous())

    @staticmethod
    def jvp(ctx, *tangents):
        raise refuse_forward_mode("FusedMLP2 (K3/K4)")


register_kernel_function(FusedMLP2, "FusedMLP2 (K3/K4)")


def fused_mlp2(params: Dict[str, torch.Tensor], x: torch.Tensor):
    """Fused 2-layer tanh MLP: y = tanh(x·W0 + b0)·W1 + b1.

    params: {'W0','b0','W1','b1'} (the `mlp_init` layout); x: (din,) or
    (B, din). Differentiable with respect to x and params through K4.
    Parameters of another dtype than x are cast to x's (the JAX kernel
    promotes them inside its products; the values are the same).

    A batch split by rows (x a (B, din) DTensor with placement Shard(0))
    runs K3, and K4 in the pullback, on this rank's rows; the parameters
    are replicated DTensors or plain tensors, whose gradients are the
    ranks' partial sums summed (`sharded.replicated_local`), and the value
    is a DTensor split like x. Another placement of x, or a parameter split
    over the ranks, is refused before any launch.
    """
    if sharded.is_sharded(x):
        return _sharded_mlp2(params, x)
    if any(sharded.is_sharded(t) for t in params.values()):
        raise sharded.refuse("fused_mlp2 (K3/K4) with DTensor weights and a "
                             "whole x")
    single = x.dim() == 1
    x2 = (x[None] if single else x).contiguous()
    w = [params[k].to(x.dtype).contiguous() for k in ("W0", "b0", "W1", "b1")]
    y, _h = FusedMLP2.apply(x2, *w)
    return y[0] if single else y


def _sharded_mlp2(params: Dict[str, torch.Tensor], x):
    """fused_mlp2 on a batch split by rows: FusedMLP2 on this rank's rows,
    the result wrapped back as Shard(0)."""
    from torch.distributed.tensor import Replicate, Shard

    whole = sharded.unwrapped(x)
    if x.dim() != 2 or tuple(whole.placements) != (Shard(0),):
        raise sharded.refuse(
            f"fused_mlp2 (K3/K4) on a {x.dim()}-D x placed "
            f"{tuple(whole.placements)} (a batch is split by rows, a 2-D "
            "state with placement Shard(0); a state split along dim 1 is "
            "not)")
    for key, w in params.items():
        if sharded.is_sharded(w) and tuple(
                sharded.unwrapped(w).placements) != (Replicate(),):
            raise sharded.refuse(f"fused_mlp2 (K3/K4) with the weight {key} "
                                 "split over the ranks (a DTensor weight is "
                                 "replicated)")
    shard = sharded.ShardContext.of(x)
    rows = sharded.to_local(x, shard).contiguous()
    w = [sharded.replicated_local(params[k], shard).to(rows.dtype)
         .contiguous() for k in ("W0", "b0", "W1", "b1")]
    y, _h = FusedMLP2.apply(rows, *w)
    return sharded.from_local(y, shard)
