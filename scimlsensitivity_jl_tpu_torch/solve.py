"""`solve`, the user-facing entry point (PyTorch port).

Counterpart of `scimlsensitivity_jl_tpu/solve.py:solve` -> `_solve_ode` for
plain ODEs: saveat validation, the default-sensealg dispatch (solve.py:
404-431, with its `fixed_grid_continuous` rule), the fixed-grid branch
(solve.py:538-547), the continuous rules with the problem's jac / vjp /
paramjac hooks and a checkpoint grid (`checkpoints=`, solve.py:548-581),
ForwardSensitivity (solve.py:606-609)
and adaptive DirectAdjoint (solve.py:611-619), with the callback dispatch
(solve.py:327-545: lowering, terminal callbacks, p-modifying events lifted
into the state) and the mass-matrix branch (solve.py:230-325: an
invertible M folded in once, a singular one a semi-explicit index-1 DAE on
a mass-capable stepper, with `dae_init="newton"`). Gradients follow
`sensealg` through torch.autograd, including those of a saveat tensor that
requires grad. DDEProblem goes to `adjoints/dde` (solve.py:152-171: the
fixed grid with dt=, else the adaptive method of steps); NonlinearProblem
and SteadyStateProblem to `adjoints/steadystate.solve_nonlinear`
(solve.py:177-190, SteadyStateAdjoint only); SDEProblem to
`adjoints/sde.solve_sde` (solve.py:111-150: rtol / atol default to 1e-3 /
1e-6, and parameter-modifying callbacks lift p into the state,
`callbacks.lift_p_into_state_sde`) and RODEProblem to
`adjoints/sde.solve_rode` (solve.py:172-176; callbacks refused). The
shadowing sensealgs (ForwardLSS, AdjointLSS, NILSS, NILSAS) take the
shadowing rule (solve.py:620-631, `_make_shadowing_solve_fn` :681-804).
A u0 split over the ranks of a process group (a DTensor with placement
Shard(0), `parallel/sharded.py`) takes `_solve_sharded`: the counterpart of
`jax.jit(..., in_shardings=(None, shard))` over a solve, which the JAX
package leaves to XLA's partitioner (its tests/test_parallel.py:72, :204).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .adjoints.continuous import (SolveOptions, host_matrix,
                                  make_ode_solve_fn)
from .callbacks import (any_modifies_p, as_callback_set,
                        check_callback_closures, lift_p_into_state,
                        lower_time_callbacks)
from .ops.vjp import probe_forward_mode
from .parallel import sharded
from .problems import (DDEProblem, NonlinearProblem, ODEProblem,
                       RODEProblem, SDEProblem, SteadyStateProblem, remake)
from .sensealg import (NILSAS, NILSS, AbstractSensealg, AdjointLSS,
                       BacksolveAdjoint, DirectAdjoint, ForwardDiffSensitivity,
                       ForwardLSS, ForwardSensitivity, GaussAdjoint,
                       GaussKronrodAdjoint, InterpolatingAdjoint,
                       QuadratureAdjoint, SteadyStateAdjoint,
                       default_sensealg)
from .solution import ODESolution
from .solvers.explicit import Tsit5
from .solvers.integrate import LOCAL_NORMS, time_dtype
from .utils.pytree import ravel_pytree, tree_leaves, tree_size

__all__ = ["solve"]

_SHADOWING_RULES = (ForwardLSS, AdjointLSS, NILSS, NILSAS)

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
    max_events: int = 32,
    adaptive: bool = True,
    unroll: bool = False,
    verbose: bool = False,
    dtmax=None,
    save_idxs=None,
    dae_init=None,
    key=None,
):
    """Solve a problem; gradients through the result follow `sensealg`.

    saveat: 1-D times (default: the two endpoints), as a list, numpy array
    or tensor; a tensor that requires grad gets dL/dtᵢ = Δᵢ·f(u(tᵢ)) under
    the continuous rules and the discrete derivative under DirectAdjoint.
    callback: a callback of `callbacks.py`, a list of them or a
    CallbackSet; `sol.events` then holds the record (at most max_events
    firings; more give retcode 4).
    save_idxs: state components to keep in ys (indices into the second
    axis of every leaf, JAX solve.py:654-662); gradients flow through the
    gather. The dense output and u_final keep the whole state.
    unroll: with adaptive=True, DirectAdjoint or a continuous rule runs
    JAX's masked-scan budget: max_steps attempts (rejected ones included)
    in the forward and adj_max_steps + |saveat| + 4 in the reverse, then
    MaxIters, with no DtMin check. Eager torch has no loop to unroll, so
    the steps are the while driver's and, inside the budget, so is every
    value and gradient, bit for bit; it is not a CUDA graph. On the fixed
    grid it takes JAX's unrolled stage times.
    dae_init: "newton" solves the algebraic rows of a singular-mass
    problem's u0 (0 = f_a(u0)) before the solve, differentiably.
    A DDEProblem takes dt= for the fixed-grid method of steps (RK4, or
    TRBDF2 for a stiff one), else the adaptive one (Tsit5, Dopri5, BS3 or
    an ESDIRK stepper, dt capped at the smallest lag, `dtmax` for
    state-dependent lags); gradients are autograd through its loop.
    An SDEProblem takes dt= for the fixed grid (any scheme of
    `solvers/sde.py`), else the adaptive path on a VirtualBrownianTree
    (EulerMaruyama or Milstein); an RODEProblem takes dt=. key: the noise's
    key (`ops.brownian.PRNGKey`, an int, or any object of its protocol;
    default PRNGKey(0)). Under NILSS or NILSAS, key is the key of their
    random initial tangents or terminal adjoints (default
    NumpyKey(sensealg.rng_seed)).
    """
    # a strong-order ~1 SDE scheme at rtol 1e-7 would starve max_steps
    if rtol is None:
        rtol = 1e-3 if isinstance(prob, SDEProblem) else 1e-7
    if atol is None:
        atol = 1e-6 if isinstance(prob, SDEProblem) else 1e-9
    if sharded.is_sharded(getattr(prob, "u0", None)):
        return _solve_sharded(
            prob, solver, saveat=saveat, rtol=rtol, atol=atol, dt0=dt0, dt=dt,
            max_steps=max_steps, tstops=tstops, sensealg=sensealg,
            dense=dense, adj_rtol=adj_rtol, adj_atol=adj_atol,
            adj_max_steps=adj_max_steps, bwd_solver=bwd_solver,
            callback=callback, adaptive=adaptive, unroll=unroll,
            verbose=verbose, dtmax=dtmax, save_idxs=save_idxs,
            dae_init=dae_init)
    if isinstance(prob, (NonlinearProblem, SteadyStateProblem)):
        from .adjoints.steadystate import solve_nonlinear

        kw = {}
        if sensealg is not None:
            if not isinstance(sensealg, SteadyStateAdjoint):
                raise NotImplementedError(
                    "nonlinear problems support SteadyStateAdjoint, got "
                    f"{sensealg!r}")
            kw["sensealg"] = sensealg
        return solve_nonlinear(prob, **kw)
    if isinstance(prob, SDEProblem):
        return _solve_sde_branch(prob, solver, saveat=saveat, dt=dt,
                                 sensealg=sensealg, max_steps=max_steps,
                                 key=key, rtol=rtol, atol=atol,
                                 callback=callback)
    if isinstance(prob, RODEProblem):
        if callback is not None:
            raise NotImplementedError(
                f"callbacks on {type(prob).__name__} are not supported — "
                "don't pass callback=, it would be silently ignored")
        from .adjoints.sde import solve_rode

        return solve_rode(prob, dt=dt, saveat=saveat, key=key,
                          sensealg=sensealg)
    if isinstance(prob, DDEProblem):
        if callback is not None:
            raise NotImplementedError(
                f"callbacks on {type(prob).__name__} are not supported — "
                "don't pass callback=, it would be silently ignored")
        from .adjoints.dde import solve_dde, solve_dde_adaptive

        if dt is None:
            # the constrained method of steps: dt capped at the smallest lag
            return solve_dde_adaptive(
                prob, solver, rtol=rtol, atol=atol, saveat=saveat,
                max_steps=max_steps, dt0=dt0, dtmax=dtmax, sensealg=sensealg)
        return solve_dde(prob, solver, dt=dt, saveat=saveat,
                         sensealg=sensealg)
    if not isinstance(prob, ODEProblem):
        raise NotImplementedError(
            f"solve not implemented for {type(prob).__name__}")
    return _solve_ode(
        prob, solver, saveat=saveat, rtol=rtol, atol=atol, dt0=dt0, dt=dt,
        max_steps=max_steps, tstops=tstops, sensealg=sensealg, dense=dense,
        adj_rtol=adj_rtol, adj_atol=adj_atol, adj_max_steps=adj_max_steps,
        bwd_solver=bwd_solver, adaptive=adaptive, unroll=unroll,
        verbose=verbose, dtmax=dtmax, callback=callback,
        max_events=max_events, save_idxs=save_idxs, dae_init=dae_init,
        key=key,
    )


def _solve_sde_branch(prob, solver, *, saveat, dt, sensealg, max_steps, key,
                      rtol, atol, callback):
    """JAX solve.py:111-150: parameter-modifying callbacks lift p into
    the state (zero drift and noise rows), and the solution is un-lifted;
    its replay record then goes, as the direct API cannot rebuild the
    doses from the original problem."""
    from .adjoints.sde import solve_sde
    from .callbacks import lift_p_into_state_sde

    kw = dict(saveat=saveat, dt=dt, sensealg=sensealg, max_steps=max_steps,
              key=key, rtol=rtol, atol=atol)
    items = None
    if callback is not None:
        items = tuple(callback) if isinstance(callback, (list, tuple)) \
            else (callback,)
    if not items or not any(getattr(c, "modifies_p", False) for c in items):
        return solve_sde(prob, solver, callback=callback, **kw)
    prob_z, cbs_z, n_u = lift_p_into_state_sde(prob, items)
    sol = solve_sde(prob_z, solver, callback=list(cbs_z), **kw)
    return dataclasses.replace(
        sol, ys=sol.ys[0], unravel_u=ravel_pytree(prob.u0)[1], prob=prob,
        u_final=None if sol.u_final is None else sol.u_final[:n_u],
        solve_args=None)


def _mass_matrix_branch(prob, solver, sensealg, dt0, dt, dae_init, u0vec,
                        unravel_u):
    """JAX solve.py:230-325: (prob, solver, sensealg) for a problem with a
    mass matrix. The determinant test runs on M's host values, once. An
    invertible M is folded in once, f ↦ M⁻¹f (the rules then differentiate
    the transformed field). A singular M is a semi-explicit index-1 DAE:
    it moves onto the stepper (`with_mass_matrix`), which needs an explicit
    dt0; sensealg=None becomes ForwardDiffSensitivity; DirectAdjoint and
    the dense Interpolating, Gauss, GaussKronrod and Quadrature rules are
    taken; dae_init="newton" solves the algebraic rows of u0 (the zero rows
    of M) with `solve_nonlinear`, whose IFT adjoint differentiates the
    initialization. A kernel field is refused before anything launches: the
    stepper's Jacobians need forward mode."""
    M_host = host_matrix(prob.mass_matrix)
    M = torch.as_tensor(M_host, dtype=u0vec.dtype, device=u0vec.device)
    if abs(float(np.linalg.det(M_host))) >= 1e-300:
        if dae_init not in (None, "none"):
            raise ValueError("dae_init applies only to singular-mass-matrix "
                             "(DAE) problems")
        Minv = torch.linalg.inv(M)
        f_orig = prob.f

        def f_mass(u, p_, t):
            duvec, unrav = ravel_pytree(f_orig(u, p_, t))
            return unrav(Minv.to(duvec.dtype) @ duvec)

        return remake(prob, f=f_mass, mass_matrix=None), solver, sensealg
    if not hasattr(solver, "with_mass_matrix"):
        raise NotImplementedError(
            "singular mass matrices need an implicit solver with "
            "mass-matrix stages (SDIRK4)")
    solver = solver.with_mass_matrix(M)
    if dt0 is None and dt is None:
        raise ValueError("singular-mass-matrix solves need an explicit dt0")
    if sensealg is None:
        sensealg = ForwardDiffSensitivity()
    elif isinstance(sensealg, (InterpolatingAdjoint, GaussAdjoint,
                               GaussKronrodAdjoint, QuadratureAdjoint)):
        if getattr(sensealg, "checkpointing", False):
            raise NotImplementedError(
                "continuous DAE adjoints need the dense (non-checkpointed) "
                "variant")
    elif not isinstance(sensealg, (ForwardDiffSensitivity, DirectAdjoint)):
        raise NotImplementedError(
            "DAE gradients: ForwardDiffSensitivity, DirectAdjoint, or the "
            "continuous InterpolatingAdjoint / GaussAdjoint / "
            "QuadratureAdjoint (algebraic-λ projection, index-1 diagonal "
            "mass)")
    t0 = prob.tspan[0]
    probe_forward_mode(
        lambda uv: ravel_pytree(prob.f(unravel_u(uv), prob.p, t0))[0], u0vec)
    if dae_init == "newton":
        # consistent initialization: 0 = f_a(u0_d, u0_a, p) for u0_a
        from .adjoints.steadystate import solve_nonlinear

        a_idx = torch.as_tensor(np.where(np.all(M_host == 0.0, axis=1))[0],
                                dtype=torch.long, device=u0vec.device)
        f_dae = prob.f

        def alg_res(ua, pp):
            u0v, pr = pp
            uv = u0v.index_put((a_idx,), ua)
            return ravel_pytree(f_dae(unravel_u(uv), pr, t0))[0][a_idx]

        ns = solve_nonlinear(NonlinearProblem(alg_res, u0vec[a_idx],
                                              (u0vec, prob.p)))
        prob = remake(prob, u0=unravel_u(u0vec.index_put((a_idx,), ns.u)))
    elif dae_init not in (None, "none"):
        raise ValueError(f"dae_init: None or 'newton', got {dae_init!r}")
    return remake(prob, mass_matrix=None), solver, sensealg


# the rules a sharded state runs under: every reverse-mode rule, with any of
# its options but an autojacvec other than AutoVJP
_SHARDED_RULES = (BacksolveAdjoint, InterpolatingAdjoint, GaussAdjoint,
                  GaussKronrodAdjoint, QuadratureAdjoint, DirectAdjoint)


def _check_sharded(prob, solver, *, bwd_solver, sensealg, saveat, dense,
                   callback, unroll, save_idxs, dae_init, adaptive, **_):
    """Refuse, before anything launches, what a sharded state does not run
    yet (ROADMAP §1): every problem type but a plain ODEProblem, a state
    split along another dim than 0, steppers other than explicit
    Runge-Kutta, sensealgs outside `_SHARDED_RULES` (sensealg=None where it
    resolves to one of them, or to the fixed grid's discrete path, runs),
    an autojacvec other than AutoVJP, callbacks, dense output and the other
    differentiable outputs."""
    from torch.distributed.tensor import Shard

    from .sensealg import AutoVJP
    from .solvers.explicit import ExplicitRK

    if not isinstance(prob, ODEProblem):
        raise sharded.refuse(f"{type(prob).__name__}")
    placements = tuple(sharded.unwrapped(prob.u0).placements)
    if placements != (Shard(0),):
        raise sharded.refuse(f"a state placed {placements} (split along "
                             "another dim than 0)")
    if prob.mass_matrix is not None or dae_init not in (None, "none"):
        raise sharded.refuse("a mass matrix (DAE)")
    for name, step in (("solver", solver), ("bwd_solver", bwd_solver)):
        if step is not None and not isinstance(step, ExplicitRK):
            raise sharded.refuse(f"{name}={step!r} (stiff, extrapolation "
                                 "and multistep steppers)")
    if sensealg is None:
        sensealg = default_sensealg(prob.u0.numel(), tree_size(prob.p),
                                    prob.p is not None,
                                    fixed_grid=not adaptive, unroll=unroll)
        if not adaptive and not isinstance(sensealg, BacksolveAdjoint):
            sensealg = None  # the fixed grid's discrete path
    if sensealg is not None:
        if not isinstance(sensealg, _SHARDED_RULES):
            raise sharded.refuse(f"sensealg={sensealg!r}")
        vjp = getattr(sensealg, "autojacvec", AutoVJP())
        if not isinstance(vjp, AutoVJP):
            raise sharded.refuse(f"{sensealg!r} (autojacvec={vjp!r}: a "
                                 "sharded state takes AutoVJP)")
    for what, given in (("callbacks and events", callback is not None),
                        ("dense output (dense=True, sol(t))", dense),
                        ("save_idxs", save_idxs is not None),
                        ("a saveat tensor that requires grad",
                         isinstance(saveat, torch.Tensor)
                         and saveat.requires_grad),
                        ("prob.jac, prob.vjp and prob.paramjac",
                         any(h is not None for h in
                             (prob.jac, prob.vjp, prob.paramjac)))):
        if given:
            raise sharded.refuse(what)
    if prob.u0.is_complex():
        raise sharded.refuse("a complex state")
    if any(sharded.is_sharded(x) for x in tree_leaves(prob.p)):
        raise sharded.refuse("a DTensor p (p is replicated: pass plain "
                             "tensors)")


def _solve_sharded(prob, solver, **kw):
    """`solve` of a state split over the ranks (`parallel/sharded.py`):
    each rank solves its shard, the field sees the whole DTensor, and the
    outputs are DTensors split like u0 (ys along its state axis). u0's
    gradient comes back split like u0, p's whole on every rank."""
    _check_sharded(prob, solver, **kw)
    shard = sharded.ShardContext.of(prob.u0)
    local = remake(prob, f=shard.local_field(prob.f),
                   u0=sharded.to_local(prob.u0, shard),
                   p=sharded.sum_over_ranks(prob.p, shard))
    sol = _solve_ode(local, solver, **kw, n_global=shard.numel,
                     norms=sharded.ShardNorms(shard))
    return dataclasses.replace(
        sol, ys=sharded.from_local(sol.ys, shard, dim=1), prob=prob,
        dense=None, unravel_u=None,
        u_final=(None if sol.u_final is None else sharded.from_local(
            sol.unravel_u(sol.u_final), shard)))


def _check_unrolled_continuous(solver, bwd_solver, sensealg, max_steps,
                               adj_max_steps):
    """JAX's four refusals of unroll=True under a continuous rule
    (solve.py:436-485), with its messages."""
    from .solvers.explicit import ExplicitRK

    if getattr(solver, "mass_matrix", None) is not None:
        raise NotImplementedError(
            "unroll=True + continuous adjoints needs a plain ODE "
            "(no mass matrix); use the while driver (unroll=False)")
    if not isinstance(solver, ExplicitRK) or (
            bwd_solver is not None and not isinstance(bwd_solver, ExplicitRK)):
        raise NotImplementedError(
            "unroll=True + continuous adjoints needs explicit-RK "
            "forward/reverse steppers (masked-scan driver); "
            "stiff/multistep solvers run the while driver")
    # Backsolve's checkpointing is the snap at save times, no nested solve
    if getattr(sensealg, "checkpointing", False) and not isinstance(
            sensealg, BacksolveAdjoint):
        raise NotImplementedError(
            "unroll=True does not compose with checkpointing=True "
            "(the checkpointed reverse nests interval re-solves); "
            "use unroll=False")
    if max_steps > 512 or (adj_max_steps or 0) > 512:
        raise ValueError(
            "unroll=True emits max_steps (and adj_max_steps + "
            "|saveat| + 4 reverse) straight-line iterations; bound "
            "both <= 512 (compile time grows with them)")


def _take_rows(tree, rows: torch.Tensor, axis: int = 0):
    """`leaf[rows]` (axis 0) or `leaf[:, rows]` (axis 1) of every leaf of a
    tree of (nt, ...) tensors; a 0-dim `rows` drops the axis."""
    if isinstance(tree, dict):
        return {key: _take_rows(tree[key], rows, axis) for key in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_take_rows(x, rows, axis) for x in tree)
    rows = rows.to(tree.device)
    return tree[rows] if axis == 0 else tree[:, rows]


def _solve_ode(prob, solver, *, saveat, rtol, atol, dt0, dt, max_steps,
               tstops, sensealg, dense, adj_rtol, adj_atol, adj_max_steps,
               bwd_solver, adaptive=True, unroll=False, verbose=False,
               dtmax=None, callback=None, max_events=32, save_idxs=None,
               dae_init=None, key=None, n_global=None, norms=LOCAL_NORMS):
    """n_global: a sharded state's whole length (prob.u0 is this rank's
    shard), which the default sensealg reads, as JAX reads the global
    shape; norms: the error norms' reductions of every solve it runs (over
    every rank's shard for a sharded state)."""
    solver = solver or Tsit5()
    t0, t1 = prob.tspan
    u0vec, unravel_u = ravel_pytree(prob.u0)
    kind = time_dtype(u0vec.dtype)
    n = u0vec.shape[0] if n_global is None else n_global
    np_ = tree_size(prob.p) if prob.p is not None else 0

    sv_t = None  # the caller's saveat tensor, when it wants a gradient
    if saveat is None:
        saveat = np.asarray([t0, t1], dtype=kind)
    else:
        if isinstance(saveat, torch.Tensor):
            if saveat.requires_grad:
                sv_t = saveat.reshape(-1)
            saveat = saveat.detach().cpu().numpy()
        saveat = np.asarray(saveat, dtype=kind).reshape(-1)
        # strictly monotone in the direction of integration: duplicates and
        # reversals would silently mis-capture
        d = np.diff(saveat) * (1.0 if float(t1) >= float(t0) else -1.0)
        if saveat.size > 1 and not (d > 0).all():
            raise ValueError("saveat must be strictly monotone in the "
                             f"integration direction; got {saveat}")

    if prob.mass_matrix is not None:
        prob, solver, sensealg = _mass_matrix_branch(
            prob, solver, sensealg, dt0, dt, dae_init, u0vec, unravel_u)
        u0vec = ravel_pytree(prob.u0)[0]
    elif dae_init not in (None, "none"):
        raise ValueError(
            "dae_init applies only to singular-mass-matrix (DAE) problems")

    cbs, lifted = None, False
    if callback is not None:
        # PresetTime/Periodic -> tstop-pinned DiscreteCallbacks;
        # TerminateSteadyState closes over this problem's field
        callback, extra_stops = lower_time_callbacks(callback, prob.f, t0,
                                                     t1, kind)
        if extra_stops is not None:
            tstops = extra_stops if tstops is None else np.union1d(
                np.asarray(tstops, float), extra_stops)
        cbs = as_callback_set(callback)
        if any(getattr(c, "terminal", False)
               for c in tuple(cbs.continuous) + tuple(cbs.discrete)):
            # the continuous rules reverse from the dynamic t_final; the
            # discrete ones differentiate the truncated program
            if sensealg is None:
                sensealg = DirectAdjoint()
            elif not isinstance(sensealg, (DirectAdjoint,
                                           *_CONTINUOUS_RULES)):
                raise NotImplementedError(
                    "terminal callbacks (terminate!/TerminateSteadyState): "
                    "use DirectAdjoint, ForwardDiffSensitivity, or a dense "
                    "continuous adjoint (Interpolating/Gauss/GK/Quadrature/"
                    "Backsolve)")
        if isinstance(sensealg, ForwardSensitivity):
            raise NotImplementedError(
                "ForwardSensitivity with callbacks: the forward-sensitivity "
                "ODE has no event tangent map; use ForwardDiffSensitivity")
        if any_modifies_p(cbs) and getattr(solver, "mass_matrix",
                                           None) is not None:
            raise NotImplementedError(
                "parameter-modifying events + singular-mass DAEs are not "
                "supported (the p-lift would change the state size under "
                "the mass matrix); fold the modified parameters into the "
                "state manually")
        if any_modifies_p(cbs):
            # p joins the integration state, so conditions and affects can
            # read and write it and every rule differentiates the swap
            prob, cbs = lift_p_into_state(prob, cbs)
            lifted = True
            u0vec, unravel_u = ravel_pytree(prob.u0)
            n, np_ = u0vec.shape[0], 0

    # Fixed-grid solves (adaptive=False) take the discrete-AD path, except
    # where default_sensealg picks the fixed-grid continuous Backsolve
    # (large n, few parameters), while an explicit continuous sensealg
    # always rides its continuous rule with the forward marching the grid.
    explicit_sensealg = sensealg is not None
    if sensealg is None:
        sensealg = default_sensealg(n, np_, prob.p is not None,
                                    has_callbacks=cbs is not None,
                                    fixed_grid=not adaptive, unroll=unroll)
    if cbs is not None and isinstance(sensealg, _CONTINUOUS_RULES):
        check_callback_closures(cbs)

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
        callback=cbs, max_events=max_events, norms=norms,
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
        if not isinstance(sensealg, _CONTINUOUS_RULES):
            raise NotImplementedError(
                "unroll=True with adaptive=True is supported by "
                "DirectAdjoint (masked-scan driver) and the continuous "
                "adjoints (unrolled forward+reverse); this sensealg runs "
                "the while_loop driver. Use sensealg=DirectAdjoint() or "
                "adaptive=False.")
        _check_unrolled_continuous(solver, bwd_solver, sensealg, max_steps,
                                   adj_max_steps)
        opts = dataclasses.replace(opts, unroll=True)

    if fixed_grid_continuous:
        if dt is None:
            raise ValueError("adaptive=False requires dt=...")
        if cbs is not None:
            raise NotImplementedError(
                "callbacks + adaptive=False + a continuous sensealg are not "
                "supported; use the adaptive integrator (events are localized "
                "within adaptive steps)")
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
        if cbs is not None:
            raise NotImplementedError("callbacks need the adaptive integrator")
        from .adjoints.direct import make_fixed_grid_solve_fn

        n_steps = max(int(round((float(t1) - float(t0)) / float(dt))), 1)
        fn = make_fixed_grid_solve_fn(prob.f, solver, opts, t0, t1,
                                      n_steps=n_steps, unroll=unroll)
        ys, aux = fn(prob.u0, prob.p, saveat)
    elif isinstance(sensealg, _CONTINUOUS_RULES):
        # a checkpoint grid of its own (JAX solve.py:548-578): the
        # checkpoint times join the internal save grid, so the forward
        # keeps the states there and the checkpointed reverse re-solves the
        # finer intervals; the caller's rows are gathered back out
        saveat_solve, user_rows = saveat, None
        ckpts = getattr(sensealg, "checkpoints", None)
        if ckpts is not None:
            if not getattr(sensealg, "checkpointing", False):
                raise ValueError("checkpoints=... requires checkpointing=True")
            ck = np.asarray(ckpts, dtype=float)
            if ck.size and (ck.min() < float(min(t0, t1)) - 1e-12
                            or ck.max() > float(max(t0, t1)) + 1e-12):
                raise ValueError("checkpoints must lie inside tspan")
            merged = np.union1d(saveat.astype(float), ck)
            user_rows = torch.from_numpy(
                np.searchsorted(merged, saveat.astype(float)))
            saveat_solve = merged.astype(kind)
        if sv_t is not None:
            # the caller's times, differentiably, at their merged rows
            base = torch.from_numpy(np.asarray(saveat_solve, dtype=kind))
            saveat_solve = (sv_t.to(base.dtype) if user_rows is None else
                            base.index_put((user_rows,), sv_t.to(base.dtype)))
        fn = make_ode_solve_fn(prob.f, solver, sensealg, opts, t0, t1,
                               user_jac=prob.jac, user_vjp=prob.vjp,
                               user_paramjac=prob.paramjac,
                               bwd_solver=bwd_solver)
        ys, aux = fn(prob.u0, prob.p, saveat_solve)
        if user_rows is not None:
            ys = _take_rows(ys, user_rows)
    elif isinstance(sensealg, DirectAdjoint):
        from .adjoints.direct import make_direct_solve_fn

        fn = make_direct_solve_fn(prob.f, solver, sensealg, opts, t0, t1,
                                  unroll=unroll)
        ys, aux = fn(prob.u0, prob.p, saveat if sv_t is None else sv_t)
    elif isinstance(sensealg, ForwardSensitivity):
        from .adjoints.forward import make_forward_sensitivity_solve_fn

        fn = make_forward_sensitivity_solve_fn(prob.f, solver, sensealg, opts,
                                               t0, t1)
        ys, aux = fn(prob.u0, prob.p, saveat)
    elif isinstance(sensealg, _SHADOWING_RULES):
        if cbs is not None:
            raise NotImplementedError(
                "shadowing sensealgs are incompatible with callbacks "
                "(as in the reference)")
        ys, aux = _shadowing_solve(prob, solver, sensealg, opts, t0, t1,
                                   saveat, sv_t, key)
    else:
        raise NotImplementedError(
            f"sensealg {sensealg!r} not supported for ODEs")

    if verbose and aux.stats.retcode != 0:
        print(f"solve: non-success retcode {aux.stats.retcode} (1=MaxIters, "
              "2=DtMin); gradients through this solution are NaN")
    if lifted:
        # the u-part of the lifted (u, p) rows; cotangents on it reach u0
        # and p through the lifted initial state
        ys = ys[0]
    if save_idxs is not None:
        ys = _take_rows(ys, torch.as_tensor(np.asarray(save_idxs),
                                            dtype=torch.long), axis=1)

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
        events=getattr(aux, "events", None),
    )


class _ShadowingSolve(torch.autograd.Function):
    """(u0vec, pflat, save times) -> (saveat rows, u_final); the backward
    runs the shadowing problem on the saved rows and gives p its
    gradient. u0 and the save times get zeros (the reference's
    NoTangent), and u_final's cotangent is dropped, as in JAX."""

    @staticmethod
    def forward(ctx, u0vec, pflat, sv, run):
        ys, u_final = run.forward(u0vec, pflat)
        ctx.run = run
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(u0vec, pflat, sv, ys)
        return ys, u_final

    @staticmethod
    def backward(ctx, d_ys, d_uf):
        u0vec, pflat, sv, ys = ctx.saved_tensors
        if d_ys is None:
            d_ys = torch.zeros_like(ys)
        dp = ctx.run.backward(u0vec, pflat, ys, d_ys)
        return torch.zeros_like(u0vec), dp, torch.zeros_like(sv), None


class _ShadowingRule:
    """The forward and backward of one shadowing `solve` (JAX
    solve.py:620-631, `_make_shadowing_solve_fn` :681-804).

    The forward is the continuous rules' forward solve. The backward
    builds dgdu_discrete from the cotangent rows Δᵢ (a plain sum loss over
    a uniform saveat grid then gives the sensitivity of the time average):
    ForwardLSS and AdjointLSS take the rows at the save times; NILSS and
    NILSAS, which run on their own segment grids, lift them to the
    piecewise-constant field of the nearest save time (JAX :737-765; as
    JAX states, the reference's jevery instead zeroes dgdu between data
    times and divides by every internal step). Their segment solves take
    adj_rtol / adj_atol (default JAX's 1e-8 / 1e-10); NILSAS's primal
    solve takes the solve's rtol / atol and max_steps (JAX: fwd_rtol
    1e-11, fwd_atol 1e-13, max_steps 16384, its test's solve settings)."""

    def __init__(self, prob, solver, sensealg, opts, t0, t1, saveat,
                 unravel_u, unravel_p, record, key):
        self.prob, self.solver, self.sensealg, self.opts = (prob, solver,
                                                            sensealg, opts)
        self.t0, self.t1, self.saveat = t0, t1, saveat
        self.unravel_u, self.unravel_p, self.record = (unravel_u, unravel_p,
                                                       record)
        self.key = key
        self.stats = self.dense = self.t_final = None

    def forward(self, u0vec, pflat):
        from .adjoints.common import forward_saveat_solve
        from .ops.vjp import make_vjp_kernels

        p, opts = self.unravel_p(pflat), self.opts
        kern = make_vjp_kernels(self.prob.f, self.prob.u0, p)
        fwd = forward_saveat_solve(
            self.solver, lambda uv, t: kern.fvec(uv, p, t), u0vec, self.t0,
            self.t1, self.saveat, rtol=opts.rtol, atol=opts.atol,
            dt0=opts.dt0, max_steps=opts.max_steps, tstops=opts.tstops,
            store_dense=opts.dense, dtmax=opts.dtmax)
        self.stats, self.dense, self.t_final = (fwd.stats, fwd.dense,
                                                fwd.t_final)
        return fwd.ys_save, fwd.u_final

    def backward(self, u0vec, pflat, ys, d_ys):
        from .adjoints import shadowing as sh
        from .solvers.integrate import Stats

        sensealg, opts, saveat = self.sensealg, self.opts, self.saveat
        p = self.unravel_p(pflat)
        prob = remake(self.prob, u0=self.unravel_u(u0vec), p=p)
        delta = d_ys.reshape(ys.shape[0], -1)
        if isinstance(sensealg, (ForwardLSS, AdjointLSS)):
            sol = ODESolution(ts=torch.from_numpy(saveat), ys=ys,
                              stats=Stats(0, 0, 0, 0), retcode=0, prob=prob)
            lss = (sh.ForwardLSSProblem if isinstance(sensealg, ForwardLSS)
                   else sh.AdjointLSSProblem)(
                sol, sensealg, dgdu_discrete=lambda u, pp, t, i: delta[i])
            dp = (sh.shadow_forward(lss) if isinstance(sensealg, ForwardLSS)
                  else sh.shadow_adjoint(lss))
            return dp.to(pflat.dtype)
        nt = saveat.shape[0]

        def delta_dgdu(u, pp, t):
            # the nearest save time's row (piecewise constant in t)
            i = min(max(int(np.searchsorted(saveat, t)), 0), nt - 1)
            im = max(i - 1, 0)
            near = abs(saveat[i] - t) <= abs(saveat[im] - t)
            return delta[i if near else im]

        tols = dict(rtol=1e-8 if opts.adj_rtol is None else opts.adj_rtol,
                    atol=1e-10 if opts.adj_atol is None else opts.adj_atol,
                    record=self.record, key=self.key)
        if isinstance(sensealg, NILSS):
            if getattr(sensealg, "g", None) is None:
                raise ValueError(
                    "NILSS under a gradient of solve needs NILSS(g=...): the "
                    "time-dilation terms evaluate the objective itself "
                    "(reference check_for_g, nilss.jl:638-640)")
            dp = sh.nilss_shadow_forward(
                sh.NILSSProblem(prob, sensealg, g=sensealg.g,
                                dgdu_continuous=delta_dgdu),
                self.solver, **tols)
        else:
            # Δ has no direct p-dependence: p-terms of the loss are
            # differentiated by the surrounding autograd
            dp = sh.nilsas_shadow_adjoint(
                sh.NILSASProblem(
                    prob, sensealg, dgdu_continuous=delta_dgdu,
                    dgdp_continuous=lambda u, pp, t: torch.zeros_like(pflat)),
                self.solver, fwd_rtol=opts.rtol, fwd_atol=opts.atol,
                max_steps=opts.max_steps, **tols)
        return dp.to(pflat.dtype)


def _shadowing_solve(prob, solver, sensealg, opts, t0, t1, saveat, sv_t,
                     key=None):
    """(ys, AuxOut) of a solve under ForwardLSS, AdjointLSS, NILSS or
    NILSAS; the gradient reaches p only."""
    from .adjoints.continuous import AdjointRecord, AuxOut

    u0vec, unravel_u = ravel_pytree(prob.u0)
    if prob.p is None:
        raise ValueError("shadowing sensitivities need parameters")
    pflat, unravel_p = ravel_pytree(prob.p)
    kind = time_dtype(u0vec.dtype)
    record = AdjointRecord()
    rule = _ShadowingRule(prob, solver, sensealg, opts, kind(t0), kind(t1),
                          np.asarray(saveat, dtype=kind), unravel_u,
                          unravel_p, record, key)
    sv = sv_t if sv_t is not None else torch.from_numpy(
        np.asarray(saveat, dtype=kind))
    ys_save, u_final = _ShadowingSolve.apply(u0vec, pflat, sv, rule)
    return unravel_u(ys_save), AuxOut(
        dense=rule.dense, t_final=rule.t_final, u_final=u_final,
        stats=rule.stats, adjoint=record)
