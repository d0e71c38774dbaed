"""PyTorch port of scimlsensitivity_jl_tpu, for NVIDIA Hopper GPUs.

Counterpart of `scimlsensitivity_jl_tpu/__init__.py`, the public subset that
is ported: `ODEProblem`, `solve`, the explicit Runge-Kutta solvers, and the
sensealg configurations. Gradients run under `BacksolveAdjoint` and
`DirectAdjoint` (fixed grid); see ROADMAP.md for the rest.

The package imports torch, never jax. Importing it builds and loads no
kernel: the CUDA kernels of `ops/rd1d.py` are compiled at their first launch
on a CUDA tensor.
"""

from .problems import ODEProblem, remake
from .sensealg import (
    AdjointLSS,
    AutoVJP,
    BacksolveAdjoint,
    DirectAdjoint,
    FiniteDiffVJP,
    ForwardDiffSensitivity,
    ForwardSensitivity,
    GaussAdjoint,
    GaussKronrodAdjoint,
    InterpolatingAdjoint,
    JacVJP,
    NILSAS,
    NILSS,
    ForwardLSS,
    QuadratureAdjoint,
    SteadyStateAdjoint,
    default_sensealg,
    setvjp,
)
from .solution import RETCODE_NAMES, ODESolution
from .solve import solve
from .solvers.explicit import BS3, Dopri5, Euler, ExplicitRK, Heun, Midpoint, Tsit5

__all__ = [
    "ODEProblem", "remake", "solve", "ODESolution", "RETCODE_NAMES",
    "ExplicitRK", "Tsit5", "Dopri5", "BS3", "Heun", "Midpoint", "Euler",
    "AutoVJP", "JacVJP", "FiniteDiffVJP",
    "BacksolveAdjoint", "DirectAdjoint", "InterpolatingAdjoint",
    "GaussAdjoint", "GaussKronrodAdjoint", "QuadratureAdjoint",
    "ForwardSensitivity", "ForwardDiffSensitivity", "SteadyStateAdjoint",
    "ForwardLSS", "AdjointLSS", "NILSS", "NILSAS",
    "default_sensealg", "setvjp",
]
