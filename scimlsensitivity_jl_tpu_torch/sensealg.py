"""Sensitivity-algorithm configuration types (PyTorch port).

Counterpart of `scimlsensitivity_jl_tpu/sensealg.py`: every configuration
dataclass, `default_sensealg` with its rows unchanged (sensealg.py:390-452)
and `setvjp`. The classes are pure configuration, so they are ported whole
even where the rule behind one is not ported yet; `solve` says which
ROADMAP item brings it.

As in the JAX package, a kernel attaches at the FIELD (a
`torch.autograd.Function` such as `ops.rd1d.fused_rd1d`), so every
sensealg's reverse pass uses it through `ops.vjp` without further code.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

__all__ = [
    "AbstractSensealg",
    "AbstractAdjointSensealg",
    "VJPChoice",
    "AutoVJP",
    "JacVJP",
    "FiniteDiffVJP",
    "ForwardSensitivity",
    "ForwardDiffSensitivity",
    "BacksolveAdjoint",
    "InterpolatingAdjoint",
    "QuadratureAdjoint",
    "GaussAdjoint",
    "GaussKronrodAdjoint",
    "DirectAdjoint",
    "ForwardDiffOverAdjoint",
    "SteadyStateAdjoint",
    "UnconstrainedOptimizationAdjoint",
    "ForwardLSS",
    "AdjointLSS",
    "NILSS",
    "NILSAS",
    "CosWindowing",
    "Cos2Windowing",
    "TimeDilation",
    "default_sensealg",
    "setvjp",
]


# -- VJP backend choices -----------------------------------------------------


@dataclass(frozen=True)
class VJPChoice:
    pass


@dataclass(frozen=True)
class AutoVJP(VJPChoice):
    """One `torch.func.vjp` pullback per field evaluation."""


@dataclass(frozen=True)
class JacVJP(VJPChoice):
    """Materialize ∂f/∂u and ∂f/∂p, then contract (ROADMAP M2)."""


@dataclass(frozen=True)
class FiniteDiffVJP(VJPChoice):
    """Central-finite-difference Jacobians contracted with λ (ROADMAP M2)."""

    eps: float = 1e-6


# -- sensealgs -----------------------------------------------------------------


class AbstractSensealg:
    pass


class AbstractAdjointSensealg(AbstractSensealg):
    pass


class AbstractShadowingSensealg(AbstractSensealg):
    pass


@dataclass(frozen=True)
class ForwardSensitivity(AbstractSensealg):
    """Continuous forward sensitivity over the augmented [u; S] ODE."""

    autojacvec: VJPChoice = AutoVJP()


@dataclass(frozen=True)
class ForwardDiffSensitivity(AbstractSensealg):
    """Discrete forward mode through the solver loop."""

    chunk_size: int = 0  # 0 => all directions in one sweep


@dataclass(frozen=True)
class BacksolveAdjoint(AbstractAdjointSensealg):
    """O(1)-memory adjoint: augmented reverse state [λ; q; u], the ODE
    solved again backwards; `checkpointing` snaps u back to the forward
    saveat values at each save time.

    recon_guard: backward re-integration of u is exponentially unstable for
    dissipative dynamics. The reverse ends at t0, where the true u0 is
    known; if the reconstructed u(t0) drifts by more than `recon_guard`
    relative (‖u_rec−u0‖/(1+‖u0‖)), the gradient is NaN and the adjoint
    retcode is 6 (BacksolveReconstructionDrift; the JAX package reports 3).
    With `checkpointing`, the same check runs on every segment: u as
    reconstructed at each save time against the stored forward value,
    before the snap overwrites it. None disables the check."""

    autojacvec: VJPChoice = AutoVJP()
    checkpointing: bool = True
    recon_guard: Optional[float] = 1e-2


@dataclass(frozen=True)
class InterpolatingAdjoint(AbstractAdjointSensealg):
    """Adjoint ODE over [λ; q] with the forward trajectory from dense
    interpolation or per-interval re-solves."""

    autojacvec: VJPChoice = AutoVJP()
    checkpointing: bool = False
    checkpoints: Optional[tuple] = None
    pinned_reverse: Optional[bool] = None
    pinned_fallback: bool = True


@dataclass(frozen=True)
class QuadratureAdjoint(AbstractAdjointSensealg):
    """Reverse solve of λ only, then dG/dp by adaptive Gauss–Kronrod
    quadrature of λᵀ∂f/∂p."""

    autojacvec: VJPChoice = AutoVJP()
    abstol: float = 1e-6
    reltol: float = 1e-3
    max_depth: int = 6


@dataclass(frozen=True)
class GaussAdjoint(AbstractAdjointSensealg):
    """Reverse solve of λ with dG/dp accumulated by Gauss quadrature on each
    accepted reverse step."""

    autojacvec: VJPChoice = AutoVJP()
    checkpointing: bool = False
    n_nodes: int = 7
    checkpoints: Optional[tuple] = None
    pinned_reverse: Optional[bool] = None


@dataclass(frozen=True)
class GaussKronrodAdjoint(AbstractAdjointSensealg):
    """GaussAdjoint with a Gauss–Kronrod (7,15) pair per reverse step."""

    autojacvec: VJPChoice = AutoVJP()
    checkpointing: bool = False
    abstol: float = 1e-8
    reltol: float = 1e-6
    max_depth: int = 2
    pinned_reverse: Optional[bool] = None


@dataclass(frozen=True)
class DirectAdjoint(AbstractSensealg):
    """Discrete (discretize-then-optimize) reverse AD through the solver
    loop. In the port this is autograd through the eager step loop; an
    adaptive solve has the masked scan's budget of max_steps attempts.
    remat=True runs each adaptive step attempt under
    torch.utils.checkpoint: the backward pass evaluates its stages again
    instead of keeping them."""

    max_steps: int = 0  # 0 => inherit solve's max_steps
    remat: bool = False


@dataclass(frozen=True)
class ForwardDiffOverAdjoint(AbstractSensealg):
    """Forward mode over a continuous adjoint (second order)."""

    adjalg: AbstractSensealg = None


@dataclass(frozen=True)
class SteadyStateAdjoint(AbstractAdjointSensealg):
    """Implicit-function-theorem adjoint for f(u, p) = 0."""

    autojacvec: VJPChoice = AutoVJP()
    linsolve: Optional[str] = None
    dense_cutoff: int = 50
    linsolve_reltol: float = 1e-10
    check_reltol: float = 1e-6
    dense_fallback_cutoff: int = 2000


@dataclass(frozen=True)
class UnconstrainedOptimizationAdjoint(SteadyStateAdjoint):
    """Differentiates argmin_u φ(u, p) by IFT on ∇_u φ = 0."""


# -- shadowing -------------------------------------------------------------------


@dataclass(frozen=True)
class AbstractWindowing:
    pass


@dataclass(frozen=True)
class CosWindowing(AbstractWindowing):
    """cos windowing of the LSS time average."""


@dataclass(frozen=True)
class Cos2Windowing(AbstractWindowing):
    """cos^2 windowing."""


@dataclass(frozen=True)
class TimeDilation(AbstractWindowing):
    """Time-dilation regularization of strength `alpha`."""

    alpha: float = 10.0
    t0skip: float = 0.0
    t1skip: float = 0.0


@dataclass(frozen=True)
class ForwardLSS(AbstractShadowingSensealg):
    """Least-squares shadowing, forward formulation."""

    LSSregularizer: AbstractWindowing = field(default_factory=CosWindowing)
    g: Optional[object] = None


@dataclass(frozen=True)
class AdjointLSS(AbstractShadowingSensealg):
    LSSregularizer: AbstractWindowing = field(
        default_factory=lambda: TimeDilation(10.0))
    g: Optional[object] = None


@dataclass(frozen=True)
class NILSS(AbstractShadowingSensealg):
    """Non-intrusive LSS."""

    nseg: int = 10
    nstep: int = 100
    nus: Optional[int] = None
    rng_seed: int = 1234
    g: Optional[object] = None


@dataclass(frozen=True)
class NILSAS(AbstractShadowingSensealg):
    """Adjoint-mode NILSS."""

    nseg: int = 10
    nstep: int = 100
    M: int = 2
    rng_seed: int = 1234
    g: Optional[object] = None


# -- default heuristic -------------------------------------------------------------


def default_sensealg(n: int, np_: int, has_params: bool, is_ode: bool = True,
                     has_callbacks: bool = False, fixed_grid: bool = False,
                     unroll: bool = False) -> AbstractSensealg:
    """The JAX package's rules, row for row (sensealg.py:390-452):

      unroll=True, ODE                      -> DirectAdjoint
      fixed grid, n >= 16384, p <= 128,
      ODE, no callbacks                     -> BacksolveAdjoint
      n + p <= 100                          -> ForwardDiffSensitivity
      no parameters                         -> QuadratureAdjoint
      plain ODE                             -> GaussAdjoint
      otherwise                             -> InterpolatingAdjoint

    The execution-mode rows were measured on another device; they stay
    until the H100 gives its own evidence.
    """
    if unroll and is_ode:
        return DirectAdjoint()
    if (fixed_grid and is_ode and has_params and not has_callbacks
            and n >= 16384 and np_ <= 128):
        return BacksolveAdjoint()
    if n + np_ <= 100 and not has_callbacks:
        return ForwardDiffSensitivity()
    if not has_params:
        return QuadratureAdjoint()
    if is_ode:
        return GaussAdjoint()
    return InterpolatingAdjoint()


def setvjp(sensealg: AbstractSensealg, vjp: VJPChoice) -> AbstractSensealg:
    """Replace the VJP backend of a sensealg."""
    if hasattr(sensealg, "autojacvec"):
        return dataclasses.replace(sensealg, autojacvec=vjp)
    return sensealg


# -- aliases of the reference's names (JAX sensealg.py:463-538) -----------------
# The port differentiates with torch.autograd alone, so the reference's five
# discrete-AD adjoints collapse onto DirectAdjoint and its per-backend VJP
# menu onto AutoVJP. The factories accept and ignore the reference's
# configuration arguments (compile=, mode=, allow_nothing=, ...).


def _alias(ref_name, ref_line, target, what):
    def make(*_args, **_kwargs):
        return target()

    make.__name__ = make.__qualname__ = ref_name
    make.__doc__ = (
        f"Reference {what} (sensitivity_algorithms.jl:{ref_line}): an alias "
        f"of {target.__name__}(); its configuration arguments are accepted "
        "and ignored.")
    return make


TrackerAdjoint = _alias("TrackerAdjoint", 744, DirectAdjoint,
                        "discrete-AD adjoint")
MooncakeAdjoint = _alias("MooncakeAdjoint", 769, DirectAdjoint,
                         "discrete-AD adjoint")
ReverseDiffAdjoint = _alias("ReverseDiffAdjoint", 791, DirectAdjoint,
                            "discrete-AD adjoint")
ZygoteAdjoint = _alias("ZygoteAdjoint", 814, DirectAdjoint,
                       "discrete-AD adjoint")
EnzymeAdjoint = _alias("EnzymeAdjoint", 845, DirectAdjoint,
                       "discrete-AD adjoint")
ZygoteVJP = _alias("ZygoteVJP", 1454, AutoVJP, "VJP backend")
EnzymeVJP = _alias("EnzymeVJP", 1488, AutoVJP, "VJP backend")
TrackerVJP = _alias("TrackerVJP", 1522, AutoVJP, "VJP backend")
ReverseDiffVJP = _alias("ReverseDiffVJP", 1555, AutoVJP, "VJP backend")
MooncakeVJP = _alias("MooncakeVJP", 1574, AutoVJP, "VJP backend")
ReactantVJP = _alias("ReactantVJP", 1599, AutoVJP, "VJP backend")


def supports_functor_params(_sensealg) -> bool:
    """Reference trait (sensitivity_algorithms.jl:1697): whether a sensealg
    takes structured parameters. Every rule here takes a tree `p`, so the
    answer is always True (JAX sensealg.py:530-534)."""
    return True


__all__ += [
    "TrackerAdjoint", "MooncakeAdjoint", "ReverseDiffAdjoint",
    "ZygoteAdjoint", "EnzymeAdjoint",
    "ZygoteVJP", "EnzymeVJP", "TrackerVJP", "ReverseDiffVJP",
    "MooncakeVJP", "ReactantVJP", "supports_functor_params",
]
