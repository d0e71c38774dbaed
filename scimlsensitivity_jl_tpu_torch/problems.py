"""Problem types (PyTorch port).

Counterpart of `scimlsensitivity_jl_tpu/problems.py`: `ODEProblem`,
`remake`, `SecondOrderODEProblem` (:205-227), `NonlinearProblem` and
`SteadyStateProblem` with `to_nonlinear` (:166-189). SDE, RODE and DDE
problems wait (ROADMAP M12, M13).

    ODEProblem(f, u0, tspan, p)          f(u, p, t) -> du
    NonlinearProblem(f, u0, p)           f(u, p) = 0
    SteadyStateProblem(f, u0, p)         f(u, p, t=∞) = 0

`f` is a pure, out-of-place function of tensors (or dicts of tensors).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Optional

__all__ = ["ODEProblem", "remake", "SecondOrderODEProblem",
           "NonlinearProblem", "SteadyStateProblem"]


@dataclass(frozen=True)
class ODEProblem:
    """Initial value problem u' = f(u, p, t).

    f: callable (u, p, t) -> du.
    u0: tensor or tree of tensors; its device and dtype are the solve's.
    tspan: (t0, t1) as Python floats.
    p: tensor or tree of tensors (may be None).
    mass_matrix: kept for parity with the JAX problem; `solve` raises
        NotImplementedError when it is set (ROADMAP M9b).
    jac(u, p, t) -> (n, n) ∂f/∂u, vjp(λ, u, p, t) -> λᵀ∂f/∂u,
    paramjac(λ, u, p, t) -> λᵀ∂f/∂p: hooks that the continuous adjoint rules
        use in place of autograd (`ops.vjp.make_vjp_kernels`).
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


@dataclass(frozen=True)
class NonlinearProblem:
    """Root-finding problem f(u, p) = 0."""

    f: Callable
    u0: Any
    p: Any = None


@dataclass(frozen=True)
class SteadyStateProblem:
    """Steady state of an ODE: solve f(u, p, t=∞) = 0."""

    f: Callable
    u0: Any
    p: Any = None

    def to_nonlinear(self) -> NonlinearProblem:
        f = self.f
        return NonlinearProblem(lambda u, p: f(u, p, float("inf")), self.u0,
                                self.p)


def SecondOrderODEProblem(f, du0, u0, tspan, p=None, **kwargs):
    """u'' = f(u', u, p, t) as a first-order system over the tuple state
    (du, u): every sensealg works on it unchanged, and gradients come back
    per leaf. f: (v, u, p, t) -> dv; du0 / u0: initial velocity and
    position (matching trees). sol.ys is the (velocity, position) pair of
    stacked trajectories."""
    def first_order(z, pp, t):
        v, u = z
        return (f(v, u, pp, t), v)

    return ODEProblem(first_order, (du0, u0), tspan, p, **kwargs)
