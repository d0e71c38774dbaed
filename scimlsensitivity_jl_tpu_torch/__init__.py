"""PyTorch port of scimlsensitivity_jl_tpu, for NVIDIA Hopper GPUs.

Counterpart of `scimlsensitivity_jl_tpu/__init__.py`, the public subset that
is ported: `ODEProblem`, `solve`, the explicit Runge-Kutta solvers, and the
sensealg configurations. Gradients run under `BacksolveAdjoint`,
`GaussAdjoint` (without checkpointing) and `DirectAdjoint` (fixed grid);
see ROADMAP.md for the rest. Beside them: the neural-ODE models
(`models/neural_ode.py`) and the fused MLP field `fused_mlp2`
(`ops/mlp.py`), which the JAX package keeps in its submodules.

The package imports torch, never jax. Importing it builds and loads no
kernel: the CUDA kernels of `ops/rd1d.py` and `ops/mlp.py` are compiled at
their first launch on a CUDA tensor.
"""

from .models.neural_ode import (
    mlp_apply,
    mlp_init,
    mnist_node_apply,
    mnist_node_init,
    neural_ode_field,
    spiral_data,
    spiral_neural_ode,
)
from .ops.mlp import fused_mlp2
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
    "fused_mlp2", "mlp_init", "mlp_apply", "neural_ode_field", "spiral_data",
    "spiral_neural_ode", "mnist_node_init", "mnist_node_apply",
]
