"""PyTorch port of scimlsensitivity_jl_tpu, for NVIDIA Hopper GPUs.

Counterpart of `scimlsensitivity_jl_tpu/__init__.py`, the public subset that
is ported: `ODEProblem` (with mass matrices: semi-explicit index-1 DAEs),
`DDEProblem` (the fixed-grid and adaptive method of steps), `SDEProblem`
and `RODEProblem` (the SDE schemes `EulerMaruyama`, `EulerHeun`,
`Milstein`, `RKMilCommute`, `RKMilGeneral`, `SRA1`, `StrongTaylor15` with
`SRIW1` / `SOSRI`, `ImplicitEM`, `AdaptiveMilstein`, on replayable
counter-based noise: `PRNGKey`, `NoiseGrid`, `VirtualBrownianTree`),
`SecondOrderODEProblem`, `solve` (real and complex states, `save_idxs`,
`unroll=True` under every rule, `dae_init="newton"`), the
explicit Runge-Kutta solvers, the stiff solvers (`Rosenbrock23`, `TRBDF2`,
`Kvaerno3`, `SDIRK4`, `Seulex`, `Rodas4Like`, `FBDF`) and the
extrapolation ones (`GBS`, `Vern9Like`), the nonlinear solves
(`NonlinearProblem`, `SteadyStateProblem`, `solve_nonlinear`,
`solve_unconstrained_optimization`, `NonlinearSolution`) under
`SteadyStateAdjoint`, the sensealg configurations with the
reference's aliases (`ZygoteAdjoint` ... -> `DirectAdjoint`, `ZygoteVJP`
... -> `AutoVJP`, `supports_functor_params`), the direct APIs
(`adjoint_sensitivities`, `ODEAdjointProblem`,
`AdjointSensitivityIntegrand`, `ODEForwardSensitivityProblem`,
`extract_local_sensitivities`, `second_order_sensitivities`,
`second_order_sensitivity_product`) and the callbacks
(`ContinuousCallback`, `DiscreteCallback`, `VectorContinuousCallback`,
`PresetTimeCallback`, `PeriodicCallback`, `TerminateSteadyState`,
`CallbackSet`). Gradients run under `ForwardDiffSensitivity`,
`ForwardSensitivity`, `BacksolveAdjoint`, `InterpolatingAdjoint`,
`GaussAdjoint`, `GaussKronrodAdjoint`, `QuadratureAdjoint`,
`DirectAdjoint` (fixed grid and adaptive, with `remat`) and the shadowing
rules `ForwardLSS`, `AdjointLSS`, `NILSS` and `NILSAS`, whose problems
(`ForwardLSSProblem`, `AdjointLSSProblem`, `NILSSProblem`,
`NILSASProblem`, `shadow_forward`, `shadow_adjoint`,
`nilsas_shadow_adjoint`) are public too; ensembles (`EnsembleProblem`,
`solve_ensemble`, `ensemble_summary`, `make_mesh`). Every public name of
the JAX package is here. Beside them: the classic, neural-ODE, PDE and
digits models (`models/`), the fused MLP field `fused_mlp2` (`ops/mlp.py`),
the RK4 block megakernel `make_rd1d_rk4_block` (`ops/rd1d.py`), which the
JAX package keeps in its submodules, the profiling helpers
(`utils/profile.py`) and the entry points (`entry.py`).

The package imports torch, never jax. Importing it builds and loads no
kernel: the CUDA kernels of `ops/rd1d.py` and `ops/mlp.py` are compiled at
their first launch on a CUDA tensor.
"""

from .adjoints.adjoint_problem import (
    AdjointProblemSpec,
    AdjointSensitivityIntegrand,
    ODEAdjointProblem,
    RODEAdjointProblem,
    SDEAdjointProblem,
)
from .adjoints.interface import adjoint_sensitivities
from .adjoints.shadowing import (
    AdjointLSSProblem,
    ForwardLSSProblem,
    NILSASProblem,
    NILSSProblem,
    nilsas_shadow_adjoint,
    shadow_adjoint,
    shadow_forward,
)
from .adjoints.steadystate import (
    NonlinearSolution,
    solve_nonlinear,
    solve_unconstrained_optimization,
)
from .adjoints.second_order import (
    second_order_sensitivities,
    second_order_sensitivity_product,
)
from .callbacks import (
    CallbackSet,
    ContinuousCallback,
    DiscreteCallback,
    PeriodicCallback,
    PresetTimeCallback,
    TerminateSteadyState,
    VectorContinuousCallback,
)
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
    neural_sde,
    spiral_data,
    spiral_neural_ode,
)
from .models.pde import (
    brusselator_2d_field,
    brusselator_2d_problem,
    heat1d_field,
    heat1d_problem,
)
from .ops.brownian import NoiseGrid, NumpyKey, PRNGKey, VirtualBrownianTree
from .ops.mlp import fused_mlp2
from .ops.rd1d import make_rd1d_rk4_block
from .parallel.ensemble import (
    EnsembleProblem,
    ensemble_summary,
    make_mesh,
    solve_ensemble,
)
from .problems import (DDEProblem, NonlinearProblem, ODEProblem,
                       RODEProblem, SDEProblem, SecondOrderODEProblem,
                       SteadyStateProblem, remake)
from .sensealg import (
    NILSAS,
    NILSS,
    AdjointLSS,
    AutoVJP,
    BacksolveAdjoint,
    Cos2Windowing,
    CosWindowing,
    DirectAdjoint,
    EnzymeAdjoint,
    EnzymeVJP,
    FiniteDiffVJP,
    ForwardDiffOverAdjoint,
    ForwardDiffSensitivity,
    ForwardLSS,
    ForwardSensitivity,
    GaussAdjoint,
    GaussKronrodAdjoint,
    InterpolatingAdjoint,
    JacVJP,
    MooncakeAdjoint,
    MooncakeVJP,
    QuadratureAdjoint,
    ReactantVJP,
    ReverseDiffAdjoint,
    ReverseDiffVJP,
    SteadyStateAdjoint,
    TimeDilation,
    TrackerAdjoint,
    TrackerVJP,
    UnconstrainedOptimizationAdjoint,
    ZygoteAdjoint,
    ZygoteVJP,
    default_sensealg,
    setvjp,
    supports_functor_params,
)
from .solution import RETCODE_NAMES, ODESolution
from .solve import solve
from .solvers.explicit import BS3, Dopri5, Euler, ExplicitRK, Heun, Midpoint, Tsit5
from .solvers.extrapolation import GBS, Vern9Like
from .solvers.fbdf import FBDF
from .solvers.rosenbrock import Rosenbrock23
from .solvers.sdirk import SDIRK4, TRBDF2, Kvaerno3
from .solvers.sde import (SOSRI, SRA1, SRIW1, AdaptiveMilstein, EulerHeun,
                          EulerMaruyama, ImplicitEM, Milstein, RKMilCommute,
                          RKMilGeneral, StrongTaylor15)
from .solvers.seulex import Rodas4Like, Seulex

__all__ = [
    "ODEProblem", "DDEProblem", "remake", "solve", "ODESolution",
    "RETCODE_NAMES",
    "SDEProblem", "RODEProblem", "NoiseGrid", "VirtualBrownianTree",
    "PRNGKey", "NumpyKey",
    "EulerMaruyama", "EulerHeun", "Milstein", "RKMilCommute", "RKMilGeneral",
    "SRA1", "SRIW1", "SOSRI", "StrongTaylor15", "AdaptiveMilstein",
    "ImplicitEM",
    "SecondOrderODEProblem", "NonlinearProblem", "SteadyStateProblem",
    "NonlinearSolution", "solve_nonlinear", "solve_unconstrained_optimization",
    "ExplicitRK", "Tsit5", "Dopri5", "BS3", "Heun", "Midpoint", "Euler",
    "Rosenbrock23", "TRBDF2", "Kvaerno3", "SDIRK4", "Seulex", "Rodas4Like",
    "GBS", "Vern9Like", "FBDF",
    "AutoVJP", "JacVJP", "FiniteDiffVJP",
    "BacksolveAdjoint", "DirectAdjoint", "InterpolatingAdjoint",
    "GaussAdjoint", "GaussKronrodAdjoint", "QuadratureAdjoint",
    "ForwardSensitivity", "ForwardDiffSensitivity", "SteadyStateAdjoint",
    "ForwardLSS", "AdjointLSS", "NILSS", "NILSAS",
    "ForwardDiffOverAdjoint", "UnconstrainedOptimizationAdjoint",
    "CosWindowing", "Cos2Windowing", "TimeDilation",
    "default_sensealg", "setvjp", "supports_functor_params",
    "TrackerAdjoint", "MooncakeAdjoint", "ReverseDiffAdjoint",
    "ZygoteAdjoint", "EnzymeAdjoint",
    "ZygoteVJP", "EnzymeVJP", "TrackerVJP", "ReverseDiffVJP",
    "MooncakeVJP", "ReactantVJP",
    "ODEForwardSensitivityProblem", "extract_local_sensitivities",
    "adjoint_sensitivities", "ODEAdjointProblem", "AdjointProblemSpec",
    "SDEAdjointProblem", "RODEAdjointProblem",
    "AdjointSensitivityIntegrand",
    "second_order_sensitivities", "second_order_sensitivity_product",
    "ContinuousCallback", "DiscreteCallback", "VectorContinuousCallback",
    "PresetTimeCallback", "PeriodicCallback", "TerminateSteadyState",
    "CallbackSet",
    "lotka_volterra", "lotka_volterra_problem", "robertson",
    "robertson_problem", "lorenz", "lorenz_problem",
    "fused_mlp2", "mlp_init", "mlp_apply", "neural_ode_field", "spiral_data",
    "spiral_neural_ode", "mnist_node_init", "mnist_node_apply", "neural_sde",
    "heat1d_field", "heat1d_problem", "brusselator_2d_field",
    "brusselator_2d_problem", "make_rd1d_rk4_block",
    "ForwardLSSProblem", "AdjointLSSProblem", "NILSSProblem",
    "NILSASProblem", "shadow_forward", "shadow_adjoint",
    "nilsas_shadow_adjoint",
    "EnsembleProblem", "solve_ensemble", "ensemble_summary", "make_mesh",
]
