"""Butcher tableaus for the explicit Runge-Kutta solvers (PyTorch port).

Counterpart of `scimlsensitivity_jl_tpu/solvers/tableaus.py`, with the same
coefficients written the same way, so both packages multiply by the same
doubles (Tsitouras 2011; Dormand & Prince 1980; Bogacki & Shampine 1989).

Error weights `b_err` are `b - b̂`: `err = dt * Σᵢ b_errᵢ kᵢ`.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

__all__ = ["ButcherTableau", "TSIT5", "DOPRI5", "BOSH3", "HEUN", "EULER",
           "MIDPOINT"]


class ButcherTableau(NamedTuple):
    a: Tuple[Tuple[float, ...], ...]  # strictly lower rows; a[i] has i+1 entries
    b: Tuple[float, ...]
    b_err: Tuple[float, ...]  # b - b_hat; empty => no embedded estimate
    c: Tuple[float, ...]
    order: int  # order of the propagating solution
    fsal: bool  # last stage == f(t+dt, u1)


TSIT5 = ButcherTableau(
    a=(
        (0.161,),
        (-0.008480655492356989, 0.335480655492357),
        (2.8971530571054935, -6.359448489975075, 4.3622954328695815),
        (5.325864828439257, -11.748883564062828, 7.4955393428898365, -0.09249506636175525),
        (5.86145544294642, -12.92096931784711, 8.159367898576159, -0.071584973281401,
         -0.028269050394068383),
        (0.09646076681806523, 0.01, 0.4798896504144996, 1.379008574103742,
         -3.290069515436081, 2.324710524099774),
    ),
    b=(0.09646076681806523, 0.01, 0.4798896504144996, 1.379008574103742,
       -3.290069515436081, 2.324710524099774, 0.0),
    b_err=(-0.00178001105222577714, -0.0008164344596567469, 0.007880878010261995,
           -0.1447110071732629, 0.5823571654525552, -0.45808210592918697,
           0.015151515151515152),
    c=(0.0, 0.161, 0.327, 0.9, 0.9800255409045097, 1.0, 1.0),
    order=5,
    fsal=True,
)

DOPRI5 = ButcherTableau(
    a=(
        (1 / 5,),
        (3 / 40, 9 / 40),
        (44 / 45, -56 / 15, 32 / 9),
        (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
        (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
        (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
    ),
    b=(35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0),
    b_err=(71 / 57600, 0.0, -71 / 16695, 71 / 1920, -17253 / 339200, 22 / 525, -1 / 40),
    c=(0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0),
    order=5,
    fsal=True,
)

BOSH3 = ButcherTableau(
    a=(
        (1 / 2,),
        (0.0, 3 / 4),
        (2 / 9, 1 / 3, 4 / 9),
    ),
    b=(2 / 9, 1 / 3, 4 / 9, 0.0),
    b_err=(2 / 9 - 7 / 24, 1 / 3 - 1 / 4, 4 / 9 - 1 / 3, -1 / 8),
    c=(0.0, 1 / 2, 3 / 4, 1.0),
    order=3,
    fsal=True,
)

# Heun 2(1): trapezoidal predictor-corrector with explicit-Euler embedded error.
HEUN = ButcherTableau(
    a=((1.0,),),
    b=(1 / 2, 1 / 2),
    b_err=(-1 / 2, 1 / 2),
    c=(0.0, 1.0),
    order=2,
    fsal=False,
)

MIDPOINT = ButcherTableau(
    a=((1 / 2,),),
    b=(0.0, 1.0),
    b_err=(-1.0, 1.0),
    c=(0.0, 1 / 2),
    order=2,
    fsal=False,
)

# Explicit Euler: no embedded error, so only usable with a fixed dt.
EULER = ButcherTableau(
    a=(),
    b=(1.0,),
    b_err=(),
    c=(0.0,),
    order=1,
    fsal=False,
)
