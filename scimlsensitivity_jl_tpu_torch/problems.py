"""Problem types (PyTorch port).

Counterpart of `scimlsensitivity_jl_tpu/problems.py:ODEProblem` and
`:remake`. Only the ODE problem is ported; SDE, RODE, DDE and nonlinear
problems wait (ROADMAP M10, M12, M13).

    ODEProblem(f, u0, tspan, p)          f(u, p, t) -> du

`f` is a pure, out-of-place function of tensors (or dicts of tensors).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Optional

__all__ = ["ODEProblem", "remake"]


@dataclass(frozen=True)
class ODEProblem:
    """Initial value problem u' = f(u, p, t).

    f: callable (u, p, t) -> du.
    u0: tensor or tree of tensors; its device and dtype are the solve's.
    tspan: (t0, t1) as Python floats.
    p: tensor or tree of tensors (may be None).
    mass_matrix, jac, vjp, paramjac: kept for parity with the JAX problem;
        `solve` raises NotImplementedError when any is set (ROADMAP M2, M9).
    """

    f: Callable
    u0: Any
    tspan: tuple
    p: Any = None
    mass_matrix: Optional[Any] = None
    jac: Optional[Callable] = None
    vjp: Optional[Callable] = None
    paramjac: Optional[Callable] = None


def remake(prob, **kwargs):
    """Rebuild a problem with some fields replaced (SciMLBase.remake)."""
    return dataclasses.replace(prob, **kwargs)
