"""The VJP engine (PyTorch port).

Counterpart of `scimlsensitivity_jl_tpu/ops/vjp.py:make_vjp_kernels`, the
`AutoVJP` route only: `f_and_vjp`, `vjp_u` and `vjp_p`, built on
`torch.func.vjp`. The Jacobian, finite-difference and user-hook routes and
`jvp` / `jac_u` wait for ROADMAP M2.

A field whose pullback is a kernel (`ops.rd1d.fused_rd1d`) is a
`torch.autograd.Function` in the `setup_context` form, which is the form
`torch.func.vjp` accepts; its backward then runs inside every call here.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..sensealg import AutoVJP, VJPChoice
from ..utils.pytree import ravel_pytree

__all__ = ["VJPKernels", "make_vjp_kernels"]


class VJPKernels(NamedTuple):
    """Derivative products of a field f(u, p, t) over flat states.

    Parameter cotangents come back shaped like p."""

    # (uvec, p, t, lamvec) -> (f value, λᵀ∂f/∂u [flat], λᵀ∂f/∂p [like p])
    f_and_vjp: Callable
    # (uvec, p, t, lamvec) -> λᵀ∂f/∂u
    vjp_u: Callable
    # (uvec, p, t, lamvec) -> λᵀ∂f/∂p
    vjp_p: Callable
    # (uvec, p, t) -> f value
    fvec: Callable
    unravel_u: Callable
    n: int


def make_vjp_kernels(f: Callable, u0, p_example,
                     *, vjp_choice: VJPChoice = AutoVJP()) -> VJPKernels:
    """Build the derivative products of f(u, p, t) -> du."""
    if not isinstance(vjp_choice, AutoVJP):
        raise NotImplementedError(
            f"{type(vjp_choice).__name__}: the port has only AutoVJP so far "
            "(ROADMAP M2)")
    u0vec, unravel_u = ravel_pytree(u0)

    def fvec(uvec, p, t):
        return ravel_pytree(f(unravel_u(uvec), p, t))[0].to(uvec.dtype)

    def f_and_vjp(uvec, p, t, lamvec):
        if p is None:
            fval, pullback = torch.func.vjp(lambda u_: fvec(u_, None, t), uvec)
            (ubar,) = pullback(lamvec.to(fval.dtype))
            return fval, ubar, None
        fval, pullback = torch.func.vjp(lambda u_, p_: fvec(u_, p_, t),
                                        uvec, p)
        ubar, pbar = pullback(lamvec.to(fval.dtype))
        return fval, ubar, pbar

    def vjp_u(uvec, p, t, lamvec):
        fval, pullback = torch.func.vjp(lambda u_: fvec(u_, p, t), uvec)
        (ubar,) = pullback(lamvec.to(fval.dtype))
        return ubar

    def vjp_p(uvec, p, t, lamvec):
        fval, pullback = torch.func.vjp(lambda p_: fvec(uvec, p_, t), p)
        (pbar,) = pullback(lamvec.to(fval.dtype))
        return pbar

    return VJPKernels(f_and_vjp=f_and_vjp, vjp_u=vjp_u, vjp_p=vjp_p,
                      fvec=fvec, unravel_u=unravel_u, n=u0vec.shape[0])
