"""Rosenbrock23, Shampine's 2(3) Rosenbrock-W method (PyTorch port).

Counterpart of `scimlsensitivity_jl_tpu/solvers/rosenbrock.py:Rosenbrock23`
(:31-70). One Jacobian and one LU per step, three triangular solves:
J = ∂f/∂u from the field's `.jac(u, t)` hook when it has one (the stiff
reverse passes attach −(∂f/∂u)ᵀ there), else `torch.func.jacfwd`; ∂f/∂t
by one `torch.func.jvp` in t; the LU is `torch.linalg.lu_factor` and the
solves `torch.linalg.lu_solve` (LAPACK on the CPU, cuSOLVER/cuBLAS on the
card, where JAX uses XLA's getrf: pivots and roundoff may differ).

    d = 1/(2+√2), W = I − h·d·J
    k1 = W⁻¹ (f(y) + h·d·T)
    F1 = f(t+h/2, y + h/2·k1)
    k2 = k1 + W⁻¹ (F1 − k1)
    y1 = y + h·k2
    F2 = f(t+h, y1)
    k3 = W⁻¹ (F2 − e32·(k2 − F1) − 2·(k1 − f(y)) + h·d·T),  e32 = 6+√2
    err = W⁻¹ (h/6 · (k1 − 2k2 + k3))

The scalar coefficients (h·d, h/2, h/6) are rounded in the time dtype on
the host, as JAX rounds its traced step length against them. Where the
step's start or length carries a derivative (`t_off`, `ddt`: zero-valued
tensors, as `ExplicitRK.step` takes them), each coefficient is the tensor
`explicit.scaled` makes, J is taken at the start time t_off + t, T by a
jvp at that tensor time (so T's own derivative in t flows, as JAX's jvp of
a jvp gives it), and each stage time goes through `explicit.stage_time`:
the values are unchanged and autograd or forward mode sees t and h as JAX's
traced times. The module also holds what the port's other implicit
steppers share: `jacobian` and `lu_solve`.
"""

from __future__ import annotations

import math

import torch

from ..ops.vjp import jacfwd
from .explicit import scaled, stage_time
from .integrate import kind_torch_dtype

__all__ = ["Rosenbrock23", "jacobian", "lu_solve"]


def jacobian(fvec, u, t):
    """∂f/∂u at (u, t): the field's `.jac` hook, else forward mode. A
    kernel field refuses forward mode (`ops.vjp.ForwardModeUnsupported`)."""
    jac_fn = getattr(fvec, "jac", None)
    if jac_fn is not None:
        return jac_fn(u, t).to(u.dtype)
    return jacfwd(lambda uu: fvec(uu, t), u)


def lu_solve(lu, b):
    """W⁻¹ b from `torch.linalg.lu_factor`'s (LU, pivots)."""
    return torch.linalg.lu_solve(lu[0], lu[1], b[:, None])[:, 0]


class Rosenbrock23:
    order = 2  # propagating order (2nd, with a 3rd-order error estimate)
    fsal = True
    n_stages = 3
    name = "Rosenbrock23"

    def __init__(self, autodiff=True):
        self.autodiff = autodiff
        self.d = 1.0 / (2.0 + math.sqrt(2.0))
        self.e32 = 6.0 + math.sqrt(2.0)

    def __repr__(self):
        return "Rosenbrock23()"

    def step(self, fvec, t, dt, u, f0, need_err: bool = True, ddt=None,
             t_off=None):
        kind = type(t)
        n = u.shape[0]
        t_a = stage_time(t, t, 0.0, None, t_off)
        J = jacobian(fvec, u, t_a)
        tt = (torch.tensor(t, dtype=kind_torch_dtype(kind), device=u.device)
              if t_off is None else t_a)
        _, T = torch.func.jvp(lambda s: fvec(u, s), (tt,),
                              (torch.ones_like(tt),))
        hd = scaled(dt, self.d, ddt)
        W = torch.eye(n, dtype=u.dtype, device=u.device) - hd * J
        lu = torch.linalg.lu_factor(W)

        hdT = hd * T
        k1 = lu_solve(lu, f0 + hdT)
        F1 = fvec(u + scaled(dt, 0.5, ddt) * k1,
                  stage_time(t, kind(t + kind(scaled(dt, 0.5))), 0.5, ddt,
                             t_off))
        k2 = k1 + lu_solve(lu, F1 - k1)
        u1 = u + scaled(dt, 1.0, ddt) * k2
        F2 = fvec(u1, stage_time(t, kind(t + dt), 1.0, ddt, t_off))
        if not need_err:
            return u1, F2, None
        k3 = lu_solve(lu, F2 - self.e32 * (k2 - F1) - 2.0 * (k1 - f0) + hdT)
        # Shampine's estimate filtered through W⁻¹: without it the raw
        # h³ difference picks up the stiff residual
        h6 = float(kind(dt / kind(6.0)))
        if ddt is not None:
            h6 = ddt / 6.0 + h6
        err = lu_solve(lu, h6 * (k1 - 2.0 * k2 + k3))
        return u1, F2, err
