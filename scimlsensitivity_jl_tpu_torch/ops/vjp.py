"""The VJP engine (PyTorch port).

Counterpart of `scimlsensitivity_jl_tpu/ops/vjp.py:make_vjp_kernels`, every
route: `AutoVJP` (one `torch.func.vjp` pullback), `JacVJP` (∂f/∂u
materialized by forward mode, then contracted), `FiniteDiffVJP` (central
differences at `eps`), and the user hooks `prob.jac`, `prob.vjp` and
`prob.paramjac` with the JAX package's precedence; beside the pullbacks,
`jvp` (forward mode, `torch.func.jvp`) and `jac_u` (`torch.func.jacfwd`,
or the user's Jacobian).

A field whose pullback is a kernel (`ops.rd1d.fused_rd1d`,
`ops.mlp.fused_mlp2`, the RK4 block) is a `torch.autograd.Function` in the
`setup_context` form, which is the form `torch.func.vjp` accepts; its
backward then runs inside every pullback here. Such a Function has no
forward-mode rule: its `jvp` raises `ForwardModeUnsupported`, as the JAX
package's `custom_vjp` kernels refuse `jax.jvp`. Its pullback has no
derivative either: a second derivative through it raises
`DoubleBackwardUnsupported`, and a complex input `ComplexStateUnsupported`
before launch.
"""

from __future__ import annotations

import re
from typing import Callable, NamedTuple, Optional

import torch

from ..sensealg import AutoVJP, FiniteDiffVJP, JacVJP, VJPChoice
from ..utils.pytree import ravel_pytree

__all__ = ["VJPKernels", "make_vjp_kernels", "ForwardModeUnsupported",
           "jacfwd", "probe_forward_mode", "register_kernel_function",
           "refuse_forward_mode", "DoubleBackwardUnsupported",
           "refuse_double_backward", "ComplexStateUnsupported",
           "refuse_complex_state"]


class ForwardModeUnsupported(NotImplementedError):
    """Forward-mode AD reached a kernel Function that has only a pullback."""


class DoubleBackwardUnsupported(NotImplementedError):
    """A second derivative reached a kernel's pullback, which has none."""


class ComplexStateUnsupported(TypeError):
    """A complex tensor reached a kernel Function, whose kernels take real
    dtypes only."""


def refuse_double_backward(function: str):
    """The error that the backward of a kernel's pullback raises: the
    pullback kernel computes its result outside autograd, so a second
    derivative through it would miss its terms."""
    return DoubleBackwardUnsupported(
        f"{function} has no second derivative: its pullback is a kernel "
        "with no derivative of its own, as the JAX package's custom_vjp "
        "kernels have no higher-order rule. second_order_sensitivities, "
        "second_order_sensitivity_product and torch.autograd.grad(..., "
        "create_graph=True) followed by a second grad need a field of plain "
        "tensor operations")


def refuse_complex_state(function: str, dtype):
    """The error that a kernel Function raises on a complex input, before
    any launch."""
    return ComplexStateUnsupported(
        f"{function} takes real float32/float64/bfloat16 tensors, got "
        f"{dtype}: its kernels have no complex arithmetic. Solve a complex "
        "state with a field of plain tensor operations")


def refuse_forward_mode(function: str):
    """The error a kernel Function's `jvp` raises."""
    return ForwardModeUnsupported(
        f"{function} has no forward-mode (jvp) rule: its kernel has a "
        "pullback only, as the JAX package's custom_vjp kernels refuse "
        "jax.jvp. ForwardDiffSensitivity, ForwardSensitivity and "
        "ODEForwardSensitivityProblem need forward mode through the field; "
        "differentiate it with a reverse-mode sensealg (GaussAdjoint, "
        "QuadratureAdjoint, BacksolveAdjoint, DirectAdjoint) instead")


# kernel Function class name -> the label of its forward-mode refusal
_KERNEL_FUNCTIONS = {}


def register_kernel_function(cls, label: str):
    """Register a kernel Function by its class name: vmap refuses such a
    Function by that name before it runs, so `jacfwd` and
    `probe_forward_mode` raise its forward-mode refusal without a launch."""
    _KERNEL_FUNCTIONS[cls.__name__] = label
    return cls


def _named_refusal(err: RuntimeError):
    """The forward-mode refusal of the registered kernel Function that a
    vmap error names, or None."""
    m = re.search(r"vmap over (\w+)", str(err))
    label = _KERNEL_FUNCTIONS.get(m.group(1)) if m else None
    return None if label is None else refuse_forward_mode(label)


def jacfwd(fn: Callable, u: torch.Tensor) -> torch.Tensor:
    """`torch.func.jacfwd(fn)(u)`, where a kernel Function's own refusal
    comes first: jacfwd vmaps the jvp over an n×n basis, so on a kernel
    field torch's complaint about the Function's missing vmap rule, or at
    a PDE's n the basis's allocation, would hide `ForwardModeUnsupported`.
    A vmap error that names a registered kernel Function raises its
    refusal (nothing has launched); on another error one plain jvp probes
    the field, then the error stands."""
    try:
        return torch.func.jacfwd(fn)(u)
    except RuntimeError as err:
        named = _named_refusal(err)
        if named is not None:
            raise named from err
        torch.func.jvp(fn, (u,), (torch.zeros_like(u),))
        raise


def probe_forward_mode(fn: Callable, u: torch.Tensor) -> None:
    """Raise `ForwardModeUnsupported` when fn reaches a kernel Function,
    before anything launches: one jvp, vmapped over a single zero tangent
    as `jacfwd` vmaps it. The stiff DAE and DDE paths call it before their
    first field evaluation; on a plain field it costs one jvp."""
    try:
        torch.func.vmap(lambda v: torch.func.jvp(fn, (u,), (v,))[1])(
            torch.zeros_like(u)[None])
    except RuntimeError as err:
        named = _named_refusal(err)
        if named is not None:
            raise named from err
        raise


class VJPKernels(NamedTuple):
    """Derivative products of a field f(u, p, t) over flat states.

    Parameter cotangents and tangents are shaped like p."""

    # (uvec, p, t, lamvec) -> (f value, λᵀ∂f/∂u [flat], λᵀ∂f/∂p [like p])
    f_and_vjp: Callable
    # (uvec, p, t, lamvec) -> λᵀ∂f/∂u
    vjp_u: Callable
    # (uvec, p, t, lamvec) -> λᵀ∂f/∂p
    vjp_p: Callable
    # (uvec, p, t, duvec, dp) -> (f value, ∂f/∂u·du + ∂f/∂p·dp); dp None = 0
    jvp: Callable
    # (uvec, p, t) -> dense (n, n) ∂f/∂u
    jac_u: Callable
    # (uvec, p, t) -> f value
    fvec: Callable
    unravel_u: Callable
    n: int


def make_vjp_kernels(f: Callable, u0, p_example,
                     *, vjp_choice: VJPChoice = AutoVJP(),
                     user_jac: Optional[Callable] = None,
                     user_vjp: Optional[Callable] = None,
                     user_paramjac: Optional[Callable] = None) -> VJPKernels:
    """Build the derivative products of f(u, p, t) -> du.

    user_jac(u, p, t) -> (n, n) ∂f/∂u; user_vjp(λ, u, p, t) -> λᵀ∂f/∂u like
    u; user_paramjac(λ, u, p, t) -> λᵀ∂f/∂p like p (λ and u as trees)."""
    u0vec, unravel_u = ravel_pytree(u0)
    use_jac = isinstance(vjp_choice, JacVJP)
    use_fd = isinstance(vjp_choice, FiniteDiffVJP)
    fd_eps = getattr(vjp_choice, "eps", 1e-6)

    def fvec(uvec, p, t):
        return ravel_pytree(f(unravel_u(uvec), p, t))[0].to(uvec.dtype)

    def _fd_jac_u(uvec, p, t):
        cols = []
        for j in range(uvec.shape[0]):
            e = torch.zeros_like(uvec)
            e[j] = fd_eps
            cols.append((fvec(uvec + e, p, t) - fvec(uvec - e, p, t))
                        / (2 * fd_eps))
        return torch.stack(cols, dim=1)

    def _fd_vjp_p(uvec, p, t, lamvec):
        if p is None:
            return None
        pflat, unravel_p = ravel_pytree(p)
        rows = []
        for j in range(pflat.shape[0]):
            e = torch.zeros_like(pflat)
            e[j] = fd_eps
            rows.append((fvec(uvec, unravel_p(pflat + e), t)
                         - fvec(uvec, unravel_p(pflat - e), t)) / (2 * fd_eps))
        return unravel_p(torch.stack(rows) @ lamvec)

    def _auto_f_and_vjp(uvec, p, t, lamvec):
        if p is None:
            fval, pullback = torch.func.vjp(lambda u_: fvec(u_, None, t), uvec)
            (ubar,) = pullback(lamvec.to(fval.dtype))
            return fval, ubar, None
        fval, pullback = torch.func.vjp(lambda u_, p_: fvec(u_, p_, t),
                                        uvec, p)
        ubar, pbar = pullback(lamvec.to(fval.dtype))
        return fval, ubar, pbar

    def _auto_vjp_p(uvec, p, t, lamvec):
        if p is None:
            return None
        fval, pullback = torch.func.vjp(lambda p_: fvec(uvec, p_, t), p)
        (pbar,) = pullback(lamvec.to(fval.dtype))
        return pbar

    if user_jac is not None:
        def jac_u(uvec, p, t):
            return torch.as_tensor(user_jac(unravel_u(uvec), p, t),
                                   dtype=uvec.dtype, device=uvec.device)
    else:
        def jac_u(uvec, p, t):
            return jacfwd(lambda u_: fvec(u_, p, t), uvec)

    def vjp_u(uvec, p, t, lamvec):
        if user_vjp is not None:
            return ravel_pytree(user_vjp(unravel_u(lamvec), unravel_u(uvec),
                                         p, t))[0]
        if use_fd:
            return _fd_jac_u(uvec, p, t).T @ lamvec
        if use_jac:
            return jac_u(uvec, p, t).T @ lamvec
        fval, pullback = torch.func.vjp(lambda u_: fvec(u_, p, t), uvec)
        (ubar,) = pullback(lamvec.to(fval.dtype))
        return ubar

    def vjp_p(uvec, p, t, lamvec):
        if user_paramjac is not None:
            return user_paramjac(unravel_u(lamvec), unravel_u(uvec), p, t)
        if use_fd:
            return _fd_vjp_p(uvec, p, t, lamvec)
        return _auto_vjp_p(uvec, p, t, lamvec)

    if user_vjp is not None or user_paramjac is not None:
        def f_and_vjp(uvec, p, t, lamvec):
            fval, ubar, pbar = _auto_f_and_vjp(uvec, p, t, lamvec)
            if user_vjp is not None:
                ubar = vjp_u(uvec, p, t, lamvec)
            if user_paramjac is not None:
                pbar = vjp_p(uvec, p, t, lamvec)
            return fval, ubar, pbar
    elif use_fd or use_jac:
        def f_and_vjp(uvec, p, t, lamvec):
            return (fvec(uvec, p, t), vjp_u(uvec, p, t, lamvec),
                    vjp_p(uvec, p, t, lamvec))
    else:
        f_and_vjp = _auto_f_and_vjp

    def jvp(uvec, p, t, duvec, dp):
        if p is None:
            return torch.func.jvp(lambda u_: fvec(u_, None, t), (uvec,),
                                  (duvec,))
        if dp is None:
            pflat, unravel_p = ravel_pytree(p)
            dp = unravel_p(torch.zeros_like(pflat))
        return torch.func.jvp(lambda u_, p_: fvec(u_, p_, t), (uvec, p),
                              (duvec, dp))

    return VJPKernels(f_and_vjp=f_and_vjp, vjp_u=vjp_u, vjp_p=vjp_p, jvp=jvp,
                      jac_u=jac_u, fvec=fvec, unravel_u=unravel_u,
                      n=u0vec.shape[0])
