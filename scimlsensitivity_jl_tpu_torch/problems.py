"""Problem types (PyTorch port).

Counterpart of `scimlsensitivity_jl_tpu/problems.py`: `ODEProblem` (with
its mass matrix, :54-78), `DDEProblem` (:131-160), `remake`,
`SecondOrderODEProblem` (:205-227), `NonlinearProblem` and
`SteadyStateProblem` with `to_nonlinear` (:166-189), `SDEProblem` and
`RODEProblem` (:88-128).

    ODEProblem(f, u0, tspan, p)          f(u, p, t) -> du
    ODEProblem(..., mass_matrix=M)       M u' = f(u, p, t)
    DDEProblem(f, u0, tspan, p, lags=)   f(u, hist, p, t) -> du
    SDEProblem(f, g, u0, tspan, p)       du = f dt + g dW
    RODEProblem(f, u0, tspan, p)         u' = f(u, p, t, W(t))
    NonlinearProblem(f, u0, p)           f(u, p) = 0
    SteadyStateProblem(f, u0, p)         f(u, p, t=∞) = 0

`f` is a pure, out-of-place function of tensors (or dicts of tensors).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Optional

__all__ = ["ODEProblem", "DDEProblem", "SDEProblem", "RODEProblem", "remake",
           "SecondOrderODEProblem", "NonlinearProblem", "SteadyStateProblem"]


@dataclass(frozen=True)
class ODEProblem:
    """Initial value problem u' = f(u, p, t), or M u' = f for a constant
    mass matrix M.

    f: callable (u, p, t) -> du.
    u0: tensor or tree of tensors; its device and dtype are the solve's.
    tspan: (t0, t1) as Python floats.
    p: tensor or tree of tensors (may be None).
    mass_matrix: optional (n, n) matrix over the *flattened* state (a
        tensor or an array); None means identity, a plain ODE. An
        invertible M is folded into the field once (u' = M⁻¹f); a singular
        M is a semi-explicit index-1 DAE: its zero rows are the algebraic
        equations 0 = f_a, solved with a mass-capable implicit stepper
        (SDIRK4, Seulex / Rodas4Like, FBDF) and an explicit dt0.
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


@dataclass(frozen=True)
class DDEProblem:
    """Delay differential equation u'(t) = f(u(t), (u(t−τ₁), ...), p, t).

    f: (u, hist, p, t) -> du, hist the tuple of delayed states (then the
        distributed-lag integrals).
    lags: tuple whose entries are positive floats (constant lags) or
        callables lag(u, p, t) -> scalar (state-dependent lags; gradients
        flow through the lag via the interpolant's time argument). A
        callable lag must stay at or above dt at run time: a smaller one
        would make the step implicit, and poisons the solution with NaN
        (retcode 3, DDELagViolation).
    history: callable t -> u for t <= t0 (default: the constant u0).
    max_lag: a bound on every lag, sizing the history buffer before t0;
        required when a lag is callable (default: the largest constant
        lag).
    dist_kernels: tuple of callables K(s, p) -> scalar for distributed
        lags: each adds I(t) = ∫₀^max_lag K(s, p)·u(t − s) ds after the
        delayed states in f's hist tuple, a trapezoid over the dt grid
        (fixed grid only; max_lag must be a multiple of dt).
    """

    f: Callable
    u0: Any
    tspan: tuple
    p: Any = None
    lags: tuple = ()
    history: Optional[Callable] = None
    max_lag: Optional[float] = None
    dist_kernels: tuple = ()


@dataclass(frozen=True)
class SDEProblem:
    """SDE du = f(u, p, t) dt + g(u, p, t) dW.

    noise: "diagonal" (g like u, elementwise), "scalar" (g like u, one
        shared Wiener process) or "general" (g an (n, m) matrix over the
        flattened state, m = noise_dim Wiener processes).
    interpretation: "ito" or "stratonovich", the problem's calculus; a
        scheme of the other calculus gets the drift correction.
    noise_process: an observed path, `ops.brownian.NoiseGrid(ts, W)` on the
        solve grid or a callable W(t) (a VirtualBrownianTree, say); None:
        the solve's own replayable noise from its key.
    """

    f: Callable
    g: Callable
    u0: Any
    tspan: tuple
    p: Any = None
    noise: str = "diagonal"
    interpretation: str = "ito"
    noise_dim: Optional[int] = None
    noise_process: Any = None


@dataclass(frozen=True)
class RODEProblem:
    """Random ODE u' = f(u, p, t, W(t)) driven by a Wiener path W of shape
    (noise_dim,) (default: like the flattened state); noise_process as for
    SDEProblem."""

    f: Callable
    u0: Any
    tspan: tuple
    p: Any = None
    noise_dim: Optional[int] = None
    noise_process: Any = None


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
