"""PyTorch port of scimlsensitivity_jl_tpu, for NVIDIA Hopper GPUs.

Counterpart of `scimlsensitivity_jl_tpu/__init__.py`, the public subset that
is ported: `ODEProblem`, `solve`, the explicit Runge-Kutta solvers, and the
sensealg configurations, the direct forward-sensitivity API
(`ODEForwardSensitivityProblem`, `extract_local_sensitivities`). Gradients
run under `ForwardDiffSensitivity`, `ForwardSensitivity`,
`BacksolveAdjoint`, `GaussAdjoint` (without checkpointing),
`QuadratureAdjoint` and `DirectAdjoint` (fixed grid and adaptive, with
`remat`), so `sensealg=None` differentiates every plain ODE; see
ROADMAP.md for the rest. Beside them: the classic, neural-ODE and PDE
models (`models/classic.py`, `models/neural_ode.py`, `models/pde.py`), the
fused MLP field `fused_mlp2` (`ops/mlp.py`) and the RK4 block megakernel
`make_rd1d_rk4_block` (`ops/rd1d.py`), which the JAX package keeps in its
submodules.

The package imports torch, never jax. Importing it builds and loads no
kernel: the CUDA kernels of `ops/rd1d.py` and `ops/mlp.py` are compiled at
their first launch on a CUDA tensor.
"""

from .adjoints.forward import (
    ODEForwardSensitivityProblem,
    extract_local_sensitivities,
)
from .models.classic import (
    lorenz,
    lorenz_problem,
    lotka_volterra,
    lotka_volterra_problem,
    robertson,
    robertson_problem,
)
from .models.neural_ode import (
    mlp_apply,
    mlp_init,
    mnist_node_apply,
    mnist_node_init,
    neural_ode_field,
    spiral_data,
    spiral_neural_ode,
)
from .models.pde import (
    brusselator_2d_field,
    brusselator_2d_problem,
    heat1d_field,
    heat1d_problem,
)
from .ops.mlp import fused_mlp2
from .ops.rd1d import make_rd1d_rk4_block
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
    "ODEForwardSensitivityProblem", "extract_local_sensitivities",
    "lotka_volterra", "lotka_volterra_problem", "robertson",
    "robertson_problem", "lorenz", "lorenz_problem",
    "fused_mlp2", "mlp_init", "mlp_apply", "neural_ode_field", "spiral_data",
    "spiral_neural_ode", "mnist_node_init", "mnist_node_apply",
    "heat1d_field", "heat1d_problem", "brusselator_2d_field",
    "brusselator_2d_problem", "make_rd1d_rk4_block",
]
