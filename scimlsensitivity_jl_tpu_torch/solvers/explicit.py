"""Explicit Runge-Kutta steppers (PyTorch port).

Counterpart of `scimlsensitivity_jl_tpu/solvers/explicit.py:ExplicitRK`
(`step`, explicit.py:38-72) and its Tsit5 / Dopri5 / BS3 / Heun / Midpoint /
Euler constructors.

The stages are summed in the JAX package's order, term by term, so float64
results agree with it to roundoff. Times are host scalars of the time
dtype (`numpy.float32`, `numpy.float64`, or `bfloat16_scalar` on the
bfloat16 fixed grid): every scalar coefficient `dt * a_ij` is rounded in
that dtype, as JAX rounds it, before it scales a stage on the device.
"""

from __future__ import annotations

import torch

from .integrate import kind_torch_dtype
from .tableaus import BOSH3, DOPRI5, EULER, HEUN, MIDPOINT, TSIT5, ButcherTableau

__all__ = ["ExplicitRK", "scaled", "stage_time", "Tsit5", "Dopri5", "BS3", "Heun", "Midpoint", "Euler"]


def _scale(dt, coef):
    """dt * coef in dt's own floating type (a numpy scalar)."""
    kind = type(dt)
    return kind(dt * kind(coef))


def scaled(dt, c, ddt=None):
    """dt·c rounded in dt's own floating type, as a Python float; where the
    step's length carries a derivative (`ddt`, a zero-valued tensor), the
    0-d tensor c·ddt + dt·c, which has the same value and the derivative.
    Every stepper scales its stages with it."""
    value = float(_scale(dt, c))
    return value if ddt is None else ddt * float(c) + value


def stage_time(t, host, c, ddt=None, t_off=None):
    """The time a stage at t + c·dt hands the field: the host value, or,
    where the step carries derivative offsets (`ddt` of its length, `t_off`
    of its start, zero-valued tensors), the 0-d tensor
    t_off + c·ddt + host, which has the host value and the derivatives."""
    if ddt is None and t_off is None:
        return host
    off = None if ddt is None else ddt * float(c)
    if t_off is not None:
        off = t_off if off is None else t_off + off
    return off + float(host)


class ExplicitRK:
    """Tableau-driven ERK stepper.

    step(fvec, t, dt, u, f0) -> (u1, f1, err):
      u1  : propagated state,
      f1  : fvec(u1, t+dt) (reused FSAL-style by the integrator),
      err : embedded local-error vector, or None when the tableau has no
            embedded pair or the caller passed `need_err=False` (a fixed-grid
            march reads no error, so it skips those device passes).
    t and dt are host scalars of the time dtype; u and f0 are tensors. The
    stages run in promote(state dtype, time dtype): a bfloat16 state under
    float32 time steps in float32, as JAX promotes it against its float32
    dt, and the integrator casts u1 and f1 back.
    ddt: a zero-valued tensor that carries the derivative of dt (DirectAdjoint
    through a save or event time); each coefficient dt·a becomes
    dt·a + ddt·a (`scaled`), the same value, so u1 and f1 are unchanged and
    autograd sees dt as JAX's traced step length. t_off: the zero-valued derivative
    of t. Where either is given, the field gets each stage time as a 0-d
    tensor t_off + cᵢ·ddt + (t + cᵢ·dt), so a field that reads t sees the
    derivatives as JAX's traced times carry them; without them the stage
    times are host values.
    """

    def __init__(self, tableau: ButcherTableau, name: str):
        self.tableau = tableau
        self.order = tableau.order
        self.fsal = tableau.fsal
        self.n_stages = len(tableau.b)
        self.name = name

    def __repr__(self):
        return f"{self.name}()"

    def step(self, fvec, t, dt, u, f0, need_err: bool = True, ddt=None,
             t_off=None):
        tab = self.tableau
        kind = type(t)

        def at(c):
            return stage_time(t, kind(t + _scale(dt, c)), c, ddt, t_off)

        wide = torch.promote_types(u.dtype, kind_torch_dtype(kind))
        if wide != u.dtype:
            u, f0 = u.to(wide), f0.to(wide)
        ks = [f0]
        for i, row in enumerate(tab.a):
            du = None
            for aij, k in zip(row, ks):
                if aij == 0.0:
                    continue
                contrib = k * scaled(dt, aij, ddt)
                du = contrib if du is None else du + contrib
            ui = u if du is None else u + du
            ks.append(fvec(ui, at(tab.c[i + 1])))

        u1 = u
        for bi, k in zip(tab.b, ks):
            if bi == 0.0:
                continue
            u1 = u1 + k * scaled(dt, bi, ddt)

        f1 = ks[-1] if tab.fsal else fvec(u1, at(1.0))

        err = None
        if tab.b_err and need_err:
            for ei, k in zip(tab.b_err, ks):
                if ei == 0.0:
                    continue
                term = k * float(_scale(dt, ei))
                err = term if err is None else err + term
        return u1, f1, err


def Tsit5():
    return ExplicitRK(TSIT5, "Tsit5")


def Dopri5():
    return ExplicitRK(DOPRI5, "Dopri5")


def BS3():
    return ExplicitRK(BOSH3, "BS3")


def Heun():
    return ExplicitRK(HEUN, "Heun")


def Midpoint():
    return ExplicitRK(MIDPOINT, "Midpoint")


def Euler():
    return ExplicitRK(EULER, "Euler")
