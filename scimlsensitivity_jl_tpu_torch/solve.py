"""`solve`, the user-facing entry point (PyTorch port).

Counterpart of `scimlsensitivity_jl_tpu/solve.py:solve` -> `_solve_ode` for
plain ODEs: saveat validation, the default-sensealg dispatch (solve.py:
404-431, with its `fixed_grid_continuous` rule), the fixed-grid branch
(solve.py:538-547), the continuous rules with the problem's jac / vjp /
paramjac hooks (solve.py:577-581), ForwardSensitivity (solve.py:606-609)
and adaptive DirectAdjoint (solve.py:611-619). Gradients follow
`sensealg` through torch.autograd.
Other problem types, callbacks, mass matrices and the sensealgs whose rules
are not ported raise NotImplementedError naming the ROADMAP item.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .adjoints.continuous import SolveOptions, make_ode_solve_fn
from .problems import ODEProblem
from .sensealg import (AbstractSensealg, BacksolveAdjoint, DirectAdjoint,
                       ForwardDiffSensitivity, ForwardSensitivity, GaussAdjoint,
                       GaussKronrodAdjoint, InterpolatingAdjoint,
                       QuadratureAdjoint, default_sensealg)
from .solution import ODESolution
from .solvers.explicit import Tsit5
from .solvers.integrate import time_dtype
from .utils.pytree import ravel_pytree, tree_size

__all__ = ["solve"]

_CONTINUOUS_RULES = (
    InterpolatingAdjoint,
    BacksolveAdjoint,
    GaussAdjoint,
    GaussKronrodAdjoint,
    QuadratureAdjoint,
    ForwardDiffSensitivity,
)


def solve(
    prob,
    solver=None,
    *,
    saveat=None,
    rtol: Optional[float] = None,
    atol: Optional[float] = None,
    dt0=None,
    dt=None,
    max_steps: int = 4096,
    tstops=None,
    sensealg: Optional[AbstractSensealg] = None,
    dense: bool = False,
    adj_rtol=None,
    adj_atol=None,
    adj_max_steps=None,
    bwd_solver=None,
    callback=None,
    adaptive: bool = True,
    unroll: bool = False,
    verbose: bool = False,
    dtmax=None,
):
    """Solve an ODE problem; gradients through the result follow `sensealg`.

    saveat: 1-D times (default: the two endpoints), as a list, numpy array
    or tensor. Save times get no gradient in the port.
    """
    if not isinstance(prob, ODEProblem):
        raise NotImplementedError(
            f"solve for {type(prob).__name__}: the port solves ODEProblem "
            "only so far (ROADMAP M9-M13)")
    if callback is not None:
        raise NotImplementedError("callbacks and events: ROADMAP M8")
    if prob.mass_matrix is not None:
        raise NotImplementedError("mass matrices and DAEs: ROADMAP M9")
    if rtol is None:
        rtol = 1e-7
    if atol is None:
        atol = 1e-9
    return _solve_ode(
        prob, solver, saveat=saveat, rtol=rtol, atol=atol, dt0=dt0, dt=dt,
        max_steps=max_steps, tstops=tstops, sensealg=sensealg, dense=dense,
        adj_rtol=adj_rtol, adj_atol=adj_atol, adj_max_steps=adj_max_steps,
        bwd_solver=bwd_solver, adaptive=adaptive, unroll=unroll,
        verbose=verbose, dtmax=dtmax,
    )


def _solve_ode(prob, solver, *, saveat, rtol, atol, dt0, dt, max_steps,
               tstops, sensealg, dense, adj_rtol, adj_atol, adj_max_steps,
               bwd_solver, adaptive=True, unroll=False, verbose=False,
               dtmax=None):
    solver = solver or Tsit5()
    t0, t1 = prob.tspan
    u0vec, unravel_u = ravel_pytree(prob.u0)
    kind = time_dtype(u0vec.dtype)
    n = u0vec.shape[0]
    np_ = tree_size(prob.p) if prob.p is not None else 0

    if saveat is None:
        saveat = np.asarray([t0, t1], dtype=kind)
    else:
        if isinstance(saveat, torch.Tensor):
            saveat = saveat.detach().cpu().numpy()
        saveat = np.asarray(saveat, dtype=kind).reshape(-1)
        # strictly monotone in the direction of integration: duplicates and
        # reversals would silently mis-capture
        d = np.diff(saveat) * (1.0 if float(t1) >= float(t0) else -1.0)
        if saveat.size > 1 and not (d > 0).all():
            raise ValueError("saveat must be strictly monotone in the "
                             f"integration direction; got {saveat}")

    # Fixed-grid solves (adaptive=False) take the discrete-AD path, except
    # where default_sensealg picks the fixed-grid continuous Backsolve
    # (large n, few parameters), while an explicit continuous sensealg
    # always rides its continuous rule with the forward marching the grid.
    explicit_sensealg = sensealg is not None
    if sensealg is None:
        sensealg = default_sensealg(n, np_, prob.p is not None,
                                    fixed_grid=not adaptive, unroll=unroll)

    if dt is not None and dt0 is None:
        dt0 = dt

    fixed_grid_continuous = (
        not adaptive
        and isinstance(sensealg, _CONTINUOUS_RULES)
        and (explicit_sensealg or isinstance(sensealg, BacksolveAdjoint))
    )
    opts = SolveOptions(
        rtol=rtol, atol=atol, dt0=dt0, max_steps=max_steps, tstops=tstops,
        dense=dense, adj_rtol=adj_rtol, adj_atol=adj_atol,
        adj_max_steps=adj_max_steps, dtmax=dtmax, verbose=verbose,
        fixed_dt=(dt if fixed_grid_continuous else None),
    )

    # deliberate divergence on either fixed-grid path: JAX's discrete march
    # (solve.py:544) takes one step of t1 - t0 when dt points away from t1,
    # and its continuous one marches by |dt| toward t1 (ROADMAP §3)
    if not adaptive and dt is not None and (
            (float(t1) - float(t0)) * float(dt) < 0):
        raise ValueError(
            f"adaptive=False: dt={dt} points away from t1 on the span "
            f"({t0}, {t1}); give dt the sign of t1 - t0")

    if adaptive and unroll and not isinstance(sensealg, DirectAdjoint):
        raise NotImplementedError(
            "unroll=True with adaptive=True (the unrolled masked-scan "
            "integrators): ROADMAP M3/M4")

    if fixed_grid_continuous:
        if dt is None:
            raise ValueError("adaptive=False requires dt=...")
        if unroll:
            raise NotImplementedError(
                "unroll=True applies to the fixed-grid discrete path "
                "(sensealg=None) and DirectAdjoint; continuous adjoints run "
                "the loop integrators")
        # size the forward to the grid; interior saveat/tstops each split
        # one step. The adaptive reverse keeps the caller's step budget.
        n_grid = max(int(round((float(t1) - float(t0)) / float(dt))), 1)
        n_extra = saveat.shape[0] + (0 if tstops is None
                                     else int(np.asarray(tstops).shape[0]))
        opts = dataclasses.replace(
            opts,
            max_steps=min(max_steps, n_grid + n_extra + 16),
            adj_max_steps=(adj_max_steps if adj_max_steps is not None
                           else max_steps),
        )

    if not adaptive and not fixed_grid_continuous:
        if dt is None:
            raise ValueError("adaptive=False requires dt=...")
        from .adjoints.direct import make_fixed_grid_solve_fn

        n_steps = max(int(round((float(t1) - float(t0)) / float(dt))), 1)
        fn = make_fixed_grid_solve_fn(prob.f, solver, opts, t0, t1,
                                      n_steps=n_steps, unroll=unroll)
        ys, aux = fn(prob.u0, prob.p, saveat)
    elif isinstance(sensealg, _CONTINUOUS_RULES):
        if getattr(sensealg, "checkpoints", None) is not None:
            raise NotImplementedError("checkpoints=...: ROADMAP M4")
        fn = make_ode_solve_fn(prob.f, solver, sensealg, opts, t0, t1,
                               user_jac=prob.jac, user_vjp=prob.vjp,
                               user_paramjac=prob.paramjac,
                               bwd_solver=bwd_solver)
        ys, aux = fn(prob.u0, prob.p, saveat)
    elif isinstance(sensealg, DirectAdjoint):
        from .adjoints.direct import make_direct_solve_fn

        fn = make_direct_solve_fn(prob.f, solver, sensealg, opts, t0, t1,
                                  unroll=unroll)
        ys, aux = fn(prob.u0, prob.p, saveat)
    elif isinstance(sensealg, ForwardSensitivity):
        from .adjoints.forward import make_forward_sensitivity_solve_fn

        fn = make_forward_sensitivity_solve_fn(prob.f, solver, sensealg, opts,
                                               t0, t1)
        ys, aux = fn(prob.u0, prob.p, saveat)
    else:
        raise NotImplementedError(
            f"sensealg {sensealg!r}: not ported (ROADMAP M4 onward)")

    if verbose and aux.stats.retcode != 0:
        print(f"solve: non-success retcode {aux.stats.retcode} (1=MaxIters, "
              "2=DtMin); gradients through this solution are NaN")

    return ODESolution(
        ts=torch.from_numpy(saveat),
        ys=ys,
        stats=aux.stats,
        retcode=aux.stats.retcode,
        prob=prob,
        solver=solver,
        sensealg=sensealg,
        dense=aux.dense,
        unravel_u=unravel_u,
        u_final=aux.u_final,
        t_final=aux.t_final,
        adjoint=aux.adjoint,
    )
