"""The public reverse-problem constructors (PyTorch port).

Counterpart of `scimlsensitivity_jl_tpu/adjoints/adjoint_problem.py`:
`AdjointProblemSpec` (:57), `ODEAdjointProblem` (:84-418, with the
event-jump callback `_event_callback` :211) and
`AdjointSensitivityIntegrand` (:419-443). The user builds the reverse
problem, solves it with the port's own `solve` and extracts the gradient:

    spec = ODEAdjointProblem(sol, InterpolatingAdjoint(), t=ts,
                             dgdu_discrete=dg)
    adj = solve(spec.prob, Tsit5(), callback=spec.callback,
                tstops=spec.tstops, saveat=[t1, t0], rtol=..., atol=...)
    du0, dp = spec.extract(adj.u_final)

`spec.prob` is an ordinary `ODEProblem` over the augmented reverse state
with the span reversed, (t1, t0); `spec.callback` a `PresetTimeCallback`
that adds the discrete cost's λ jumps at the interior data times (jumps
at t1 start z, those at t0 are added by `extract`), and for an event
solution a second one applying the recorded events' reverse jumps. The
layouts:

    InterpolatingAdjoint : z = [λ; q], u(t) from sol's dense output; on a
                           mass-matrix solution with the block mass
                           [Mᵀ 0; 0 I] and the projected jumps (JAX
                           :326-380); solve it with SDIRK4 and a dt0
    QuadratureAdjoint    : z = λ; dG/dp by integrating
                           `AdjointSensitivityIntegrand` afterwards
    BacksolveAdjoint     : z = [λ; q; u], u integrated backwards

JAX groups the event records by time into a `lax.switch`; here the
affect looks the group up on the host. Every tensor the spec closes over
is detached, so the reverse solve builds no graph and its callbacks pass
`solve`'s closure check.

`SDEAdjointProblem` (JAX :440-759) returns the time-flipped Stratonovich
reverse SDE in τ = t0 + t1 − t, driven by the forward path read backwards
as a NoiseGrid (ΔW̃_j = −ΔW_{N−1−j}), for a fixed-grid SDE solution:
Backsolve's z = [λ; q; u] or Interpolating's z = [λ; q] with u
interpolated from sol.ys; solve it with EulerHeun() at `spec.dt` and
`callback=spec.callback`, then `spec.extract(adj.ys[-1])`.
`RODEAdjointProblem` (:761-855) returns the pathwise reverse ODE over the
replayed path (an ODEProblem, any ODE solver). Both re-discretise the
reverse flow, so they meet the discrete adjoints of `solve` and
`adjoint_sensitivities` as dt → 0; adaptive and event solutions are
refused.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..callbacks import PresetTimeCallback
from ..ops.interp import dense_eval
from ..ops.vjp import make_vjp_kernels
from ..parallel import sharded
from ..problems import ODEProblem
from ..sensealg import (BacksolveAdjoint, InterpolatingAdjoint,
                        QuadratureAdjoint)
from ..solvers.integrate import time_dtype
from ..utils.pytree import ravel_pytree
from .common import match_cotangents
from .continuous import (_dae_project_jumps, _flat, _make_event_apply,
                         host_matrix)
from .interface import (continuous_cost, event_set_of, flat_of, host_times,
                        refuse_other_problems)

__all__ = ["AdjointProblemSpec", "ODEAdjointProblem", "SDEAdjointProblem",
           "RODEAdjointProblem", "AdjointSensitivityIntegrand"]


@dataclass
class AdjointProblemSpec:
    """A reverse problem to solve by hand: `prob` (span reversed), the
    λ-jump `callback` (None, one callback or a list), the data and event
    `tstops`, `extract` mapping the reverse solution's final state to
    (dG/du0, dG/dp), and `note`, the layout in words."""

    prob: ODEProblem
    callback: Optional[Any]
    tstops: np.ndarray
    n: int
    npf: int
    extract: Callable
    sensealg: Any
    note: str = ""
    dt: Optional[float] = None  # the SDE/RODE forward's grid step


def _detached(tree):
    """A tree of tensors, detached (None stays None)."""
    if tree is None:
        return None
    flat, unravel = ravel_pytree(tree)
    return unravel(flat.detach())


@torch.no_grad()
def ODEAdjointProblem(
    sol,
    sensealg=None,
    t=None,
    dgdu_discrete: Optional[Callable] = None,
    dgdu_continuous: Optional[Callable] = None,
    dgdp_continuous: Optional[Callable] = None,
    g: Optional[Callable] = None,
    callback=None,
) -> AdjointProblemSpec:
    """The reversed augmented adjoint problem of an ODE solution.

    sol must carry dense output for the Interpolating and Quadrature
    layouts (`solve(..., dense=True)`), and for `dgdu_discrete` (its λ
    jumps are taken at u(tᵢ) from it); Backsolve integrates u backwards
    from sol.u_final. Costs as in `adjoint_sensitivities`.

    Event solutions: pass the forward `callback=` (the same callbacks given
    to solve); the recorded events' reverse jumps are bundled as a second
    PresetTimeCallback at the recorded times, records at one time applied
    newest first. Interpolating and Backsolve layouts, events that neither
    terminate nor modify p and lie inside the span, as in JAX.

    Mass-matrix problems (a singular M rides on sol.solver, JAX
    :102-151): the Interpolating layout only, without events; `spec.prob`
    carries the block mass [Mᵀ 0; 0 I], its λ jumps are projected through
    the constraint (`_dae_project_jumps`) and dG/du0 = Mᵀλ(t0).
    """
    sharded.refuse_sharded(sol.prob, "ODEAdjointProblem")
    refuse_other_problems(sol, "ODEAdjointProblem")
    sensealg = sensealg if sensealg is not None else InterpolatingAdjoint()
    if not isinstance(sensealg, (InterpolatingAdjoint, BacksolveAdjoint,
                                 QuadratureAdjoint)):
        raise NotImplementedError(
            f"ODEAdjointProblem has the Interpolating, Quadrature and "
            f"Backsolve layouts, got {sensealg!r}")
    # solve() moves a singular mass matrix onto the stepper (the problem is
    # remade with mass_matrix=None), so look in both places
    M_fwd = sol.prob.mass_matrix
    if M_fwd is None:
        M_fwd = getattr(sol.solver, "mass_matrix", None)
    if M_fwd is not None and not isinstance(sensealg, InterpolatingAdjoint):
        raise NotImplementedError(
            "ODEAdjointProblem on mass-matrix problems exposes the "
            "InterpolatingAdjoint layout (block [Mᵀ 0; 0 I]); use "
            "adjoint_sensitivities for the other designs")
    if M_fwd is not None and sol.events is not None:
        raise NotImplementedError(
            "events + mass-matrix DAEs: use adjoint_sensitivities")
    if sol.events is not None and isinstance(sensealg, QuadratureAdjoint):
        raise NotImplementedError(
            "QuadratureAdjoint's λ-only layout cannot carry the event "
            "q-jumps; use the Interpolating or Backsolve layout")
    needs_dense = (not isinstance(sensealg, BacksolveAdjoint)
                   or dgdu_discrete is not None)
    if needs_dense and sol.dense is None:
        raise ValueError(
            "ODEAdjointProblem needs solve(..., dense=True) for this layout "
            "or for dgdu_discrete")
    prob = sol.prob
    p, u0 = _detached(prob.p), _detached(prob.u0)
    t0, t1 = prob.tspan
    u0vec, unravel_u = ravel_pytree(u0)
    pflat, unravel_p = ravel_pytree(p)
    if p is None:
        pflat = u0vec.new_zeros(0)
    n, npf, dtype = u0vec.numel(), pflat.numel(), u0vec.dtype
    kind = time_dtype(dtype)
    dense = sol.dense
    if dense is not None:
        dense = dense._replace(ys=dense.ys.detach(), fs=dense.fs.detach())
    kern = make_vjp_kernels(prob.f, u0, p, user_jac=prob.jac,
                            user_vjp=prob.vjp, user_paramjac=prob.paramjac)
    ts = host_times(sol.ts if t is None else t, kind)
    nt = ts.shape[0]
    cbs, event_set = event_set_of(
        sol, callback, p, unravel_u, kind,
        None if sol.events is None else sol.events.ts.shape[0],
        "ODEAdjointProblem")
    if event_set is not None:
        if any(getattr(c, "terminal", False)
               for c in tuple(cbs.continuous) + tuple(cbs.discrete)):
            raise NotImplementedError(
                "terminal events reverse from the dynamic t_final; use "
                "adjoint_sensitivities or differentiate solve(...)")
    cost_u, cost_p, _, run_cost = continuous_cost(
        g, dgdu_continuous, dgdp_continuous, p, unravel_u, u0vec, npf,
        event_set)
    zeros_p = u0vec.new_zeros(npf)

    if dgdu_discrete is None:
        lam_jumps = u0vec.new_zeros(nt, n)
    else:
        lam_jumps = torch.stack([flat_of(dgdu_discrete(
            unravel_u(dense_eval(dense, ts[i])), p, ts[i], i), u0vec)
            for i in range(nt)])

    # jumps at the reverse start (t1) go into z0, those at its end (t0)
    # into `extract`; the interior ones are a PresetTimeCallback, which
    # fires at interior step ends only
    at_end = np.abs(ts - kind(t1)) <= 1e-12 * max(1.0, abs(float(t1)))
    at_start = np.abs(ts - kind(t0)) <= 1e-12 * max(1.0, abs(float(t0)))
    interior = ~(at_end | at_start)
    prob_kw, z_jumps = {}, lam_jumps
    if M_fwd is not None:
        # the reverse DAE Mᵀλ' = −Jᵀλ − ∂g/∂u, q' = −f_pᵀλ − ∂g/∂p with the
        # block mass [Mᵀ 0; 0 I]; every λ jump projected through the
        # constraint, with its q-jump, dG/du0 = Mᵀλ(t0)
        du0_map, lamjs, qjs = _dae_project_jumps(M_fwd, kern, p, dense, ts,
                                                 lam_jumps)
        z_jumps = torch.cat([lamjs, qjs.to(lamjs.dtype)], dim=1)
        m_aug = np.eye(n + npf)
        m_aug[:n, :n] = host_matrix(M_fwd).T
        prob_kw["mass_matrix"] = torch.as_tensor(m_aug, dtype=dtype,
                                                 device=u0vec.device)
    pick = lambda mask: z_jumps[torch.from_numpy(mask).to(
        z_jumps.device)].sum(0)
    z_init, z_final = pick(at_end), pick(at_start)
    lam_init, lam_final = z_init[:n], z_final[:n]

    def jump_affect(z, _p, tt):
        i = int(np.argmin(np.abs(ts - kind(tt))))
        if not interior[i]:
            return z
        w = z_jumps[i].numel()
        return torch.cat([z[:w] + z_jumps[i], z[w:]])

    cb = None
    if dgdu_discrete is not None and interior.any():
        cb = PresetTimeCallback(ts=ts[interior], affect=jump_affect)

    def cotangents(lam, q):
        du0, dp = match_cotangents(lam, q, (u0vec, pflat))
        return unravel_u(du0), (None if p is None else unravel_p(dp))

    if isinstance(sensealg, QuadratureAdjoint):
        def aug_f(z, p_, tt):
            y = dense_eval(dense, tt)
            return -kern.vjp_u(y, p_, tt, z) - cost_u(y, tt)

        z0 = lam_init
        extract = lambda z: cotangents(z + lam_final, zeros_p)
        note = ("QuadratureAdjoint: z = λ, λ(t0) = dG/du0; integrate "
                "AdjointSensitivityIntegrand for dG/dp")
    elif isinstance(sensealg, BacksolveAdjoint):
        def aug_f(z, p_, tt):
            lam, y = z[:n], z[n + npf:]
            fval, ubar, pbar = kern.f_and_vjp(y, p_, tt, lam)
            return torch.cat([-ubar - cost_u(y, tt),
                              -(_flat(pbar, ubar) + cost_p(y, tt)),
                              fval])

        z0 = torch.cat([lam_init, zeros_p.to(lam_init.dtype),
                        sol.u_final.detach()])
        extract = lambda z: cotangents(z[:n] + lam_final, z[n:n + npf])
        note = "BacksolveAdjoint: z = [λ; q; u]"
    elif M_fwd is not None:
        def aug_f(z, p_, tt):
            y = dense_eval(dense, tt)
            _, ubar, pbar = kern.f_and_vjp(y, p_, tt, z[:n])
            return torch.cat([-ubar - cost_u(y, tt),
                              -(_flat(pbar, ubar) + cost_p(y, tt))])

        z0 = z_init
        extract = lambda z: cotangents(du0_map(z[:n] + lam_final),
                                       z[n:n + npf] + z_final[n:])
        note = ("InterpolatingAdjoint DAE: z = [λ; q], mass [Mᵀ 0; 0 I]; "
                "solve with SDIRK4() and an explicit dt0; dG/du0 = Mᵀλ(t0) "
                "(algebraic rows 0 by convention)")
    else:
        def aug_f(z, p_, tt):
            y = dense_eval(dense, tt)
            _, ubar, pbar = kern.f_and_vjp(y, p_, tt, z[:n])
            return torch.cat([-ubar - cost_u(y, tt),
                              -(_flat(pbar, ubar) + cost_p(y, tt))])

        z0 = torch.cat([lam_init, zeros_p.to(lam_init.dtype)])
        extract = lambda z: cotangents(z[:n] + lam_final, z[n:n + npf])
        note = "InterpolatingAdjoint: z = [λ; q]"

    ev_cb, ev_times = None, np.zeros(0)
    if event_set is not None:
        ev_cb, ev_times = _event_callback(
            sol, kern, p, event_set, n, npf, kind, run_cost,
            u_snap_start=(n + npf) if isinstance(sensealg, BacksolveAdjoint)
            else None)
    cbs = [c for c in (cb, ev_cb) if c is not None]
    return AdjointProblemSpec(
        prob=ODEProblem(aug_f, z0, (t1, t0), p, **prob_kw), callback=(
            None if not cbs else cbs[0] if len(cbs) == 1 else cbs),
        tstops=np.union1d(ts[interior].astype(float), ev_times),
        n=n, npf=npf, extract=extract, sensealg=sensealg, note=note)


def _event_callback(sol, kern, p, event_set, n, npf, kind, run_cost,
                    u_snap_start=None):
    """The reverse event-jump PresetTimeCallback at the recorded event
    times (JAX `_event_callback`), and those times; run_cost adds the
    running cost's moving-boundary term."""
    ev = sol.events
    apply = _make_event_apply(kern, p, event_set, ev, n, npf, q_slice=n,
                              u_snap_start=u_snap_start, run_cost=run_cost)
    k_ev = min(ev.count, ev.ts.shape[0])
    if k_ev == 0:
        return None, np.zeros(0)
    ev_ts = ev.ts.numpy()[:k_ev].astype(float)
    t0, t1 = (float(x) for x in sol.prob.tspan)
    span = max(abs(t0), abs(t1), 1.0)
    if (np.any(np.abs(ev_ts - t0) <= 1e-10 * span)
            or np.any(np.abs(ev_ts - t1) <= 1e-10 * span)):
        raise NotImplementedError(
            "events at the integration endpoints: differentiate solve(...) "
            "(there the endpoint jumps fold into z0 and extract)")
    # each record applied once, at its own time, newest first
    uniq = np.unique(ev_ts)
    groups = [np.flatnonzero(ev_ts == tu).tolist() for tu in uniq]

    def event_affect(z, _p, tt):
        for i in reversed(groups[int(np.argmin(np.abs(uniq - float(tt))))]):
            z = apply(i, kind(tt), z, None)[0]
        return z

    return PresetTimeCallback(ts=uniq, affect=event_affect), uniq


def AdjointSensitivityIntegrand(sol, adj_sol, sensealg=None):
    """ρ(t) = λ(t)ᵀ∂f/∂p as a callable of forward time, flat (JAX :419-443):
    QuadratureAdjoint's integrand. Integrate it over [t0, t1] (any rule)
    for dG/dp. adj_sol: the solution of `ODEAdjointProblem(sol,
    QuadratureAdjoint())`'s problem, solved with dense=True."""
    prob = sol.prob
    if sol.dense is None or adj_sol.dense is None:
        raise ValueError("AdjointSensitivityIntegrand needs dense=True on "
                         "both the forward and adjoint solutions")
    p = _detached(prob.p)
    kern = make_vjp_kernels(prob.f, prob.u0, p, user_jac=prob.jac,
                            user_vjp=prob.vjp, user_paramjac=prob.paramjac)
    fwd_dense, adj_dense = sol.dense, adj_sol.dense

    def rho(t):
        with torch.no_grad():
            y = dense_eval(fwd_dense, t).detach()
            lam = dense_eval(adj_dense, t).detach()
            return ravel_pytree(kern.vjp_p(y, p, t, lam))[0]

    return rho


def _fixed_grid_meta(sol, kind):
    """(t0, t1, dt, n_steps, key) of a fixed-grid SDE/RODE solution."""
    sa = getattr(sol, "solve_args", None)
    if sa is None or sa.get("kind") != kind:
        raise NotImplementedError(
            f"{'SDE' if kind == 'sde' else 'RODE'}AdjointProblem needs a "
            f"FIXED-GRID solution from this package's solve() (adaptive "
            f"solutions: use adjoint_sensitivities, which replays the "
            f"realized grid exactly)")
    t0, t1 = sol.prob.tspan
    dt = float(sa["dt"])
    n_steps = int(round((float(t1) - float(t0)) / dt))
    return float(t0), float(t1), dt, n_steps, sa["key"]


def _forward_noise_nodes(prob, key, n_steps, dt, w_shape, dtype, device):
    """W at the forward grid nodes: drawn again from the key (the solve
    never stored it), or read from the problem's noise_process."""
    from ..ops.brownian import NoiseGrid, grid_path

    src = prob.noise_process
    if src is None:
        return grid_path(key, n_steps, w_shape, dt, device).to(dtype)
    if isinstance(src, NoiseGrid):
        return torch.as_tensor(np.asarray(src.W) if not isinstance(
            src.W, torch.Tensor) else src.W, dtype=dtype, device=device)
    if callable(src):
        t0 = float(prob.tspan[0])
        return torch.stack([torch.broadcast_to(torch.as_tensor(
            src(t0 + dt * i), device=device), w_shape).to(dtype)
            for i in range(n_steps + 1)])
    raise TypeError(f"noise_process: NoiseGrid or callable, got {src!r}")


def _sde_data_jumps(sol, t, dgdu_discrete, p, like):
    """(save times, λ jump rows there): SDE/RODE solutions have no dense
    output, so the cotangents anchor to the stored save rows."""
    if dgdu_discrete is None:
        raise ValueError(
            "SDE/RODE adjoint problems need dgdu_discrete (continuous "
            "costs on SDE paths: put a running cost in an augmented "
            "quadrature state instead)")
    kind = time_dtype(like.dtype)
    ts_sol = host_times(sol.ts, kind)
    ts = ts_sol if t is None else host_times(t, kind)
    if ts.shape != ts_sol.shape or not np.allclose(ts, ts_sol):
        raise ValueError(
            "t= must equal the solution's save times (cotangent rows "
            "anchor to sol.ys); re-solve with saveat=t")
    ys = _detached(sol.ys)
    rows = []
    for i in range(ts.shape[0]):
        ui = _tree_row(ys, i)
        rows.append(flat_of(dgdu_discrete(ui, p, ts[i], i), like))
    return ts.astype(float), torch.stack(rows)


def _tree_row(tree, i):
    if isinstance(tree, dict):
        return {k: _tree_row(v, i) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_row(v, i) for v in tree)
    return tree[i]


def _reverse_jump_plumbing(ts, lam_jumps, t0, t1, n):
    """Data-time jumps split into the z0 seed at t1, the fold at t0 (in
    extract) and a PresetTimeCallback at the interior ones, in the
    reversed time τ = t0 + t1 − t."""
    at_end = np.abs(ts - t1) <= 1e-12 * max(1.0, abs(t1))
    at_start = np.abs(ts - t0) <= 1e-12 * max(1.0, abs(t0))
    zero = lam_jumps.new_zeros(lam_jumps.shape[1])
    lam_init = sum((lam_jumps[i] for i in np.flatnonzero(at_end)), zero)
    lam_final = sum((lam_jumps[i] for i in np.flatnonzero(at_start)), zero)
    interior = ~(at_end | at_start)
    tau_ts = (t0 + t1) - ts

    def jump_affect(z, _p, tau):
        i = int(np.argmin(np.abs(tau_ts - float(tau))))
        if not interior[i]:
            return z
        return torch.cat([z[:n] + lam_jumps[i], z[n:]])

    cb_times = tau_ts[interior]
    cb = (PresetTimeCallback(ts=cb_times, affect=jump_affect)
          if interior.any() else None)
    return lam_init, lam_final, cb, cb_times


def _interp_rows(ts, rows, tt):
    """Rows (len(ts), ...) linearly interpolated at the host time tt,
    clamped outside ts (jnp.interp's convention)."""
    tt = float(tt)
    if tt <= ts[0]:
        return rows[0]
    if tt >= ts[-1]:
        return rows[-1]
    k = int(np.searchsorted(ts, tt, side="right")) - 1
    w = (tt - ts[k]) / (ts[k + 1] - ts[k])
    return rows[k] + w * (rows[k + 1] - rows[k])


def _flat_rows(sol):
    ys = _detached(sol.ys)
    return torch.stack([ravel_pytree(_tree_row(ys, i))[0]
                        for i in range(len(sol.ts))])


def SDEAdjointProblem(sol, sensealg=None, t=None, dgdu_discrete=None):
    """The user-solvable reverse SDE of a fixed-grid SDE solution (JAX
    :519-759), the time-flipped Stratonovich augmented system in
    τ = t0 + t1 − t on the reversed forward path (T = t0 + t1,
    W̃(τ) = W(T − τ)):

        BacksolveAdjoint (default)  z = [λ; q; u]:
            dz = [+(∂f̃/∂u)ᵀλ; +(∂f̃/∂p)ᵀλ; −f̃] dτ
                 + Σ_j [−(∂g_j/∂u)ᵀλ; −(∂g_j/∂p)ᵀλ; +g_j] ∘dW̃_j
        InterpolatingAdjoint        z = [λ; q], u(T − τ) interpolated
                                    from sol.ys (save densely)

    f̃ the Stratonovich drift (an Itô problem gets −½(∂g/∂u)g). Solve
    spec.prob with EulerHeun() at dt=spec.dt and callback=spec.callback;
    discrete costs only (dgdu_discrete)."""
    from ..ops.brownian import NoiseGrid
    from ..problems import SDEProblem
    from ..solvers.sde import _drift_correction
    from .sde import pullback, pullbacks

    sensealg = sensealg if sensealg is not None else BacksolveAdjoint()
    if getattr(sol, "events", None) is not None:
        raise NotImplementedError(
            "SDEAdjointProblem on event solutions: differentiate solve")
    prob = sol.prob
    if not isinstance(prob, SDEProblem):
        raise TypeError(f"SDEAdjointProblem needs an SDEProblem solution, "
                        f"got {type(prob).__name__}")
    t0, t1, dt, n_steps, key = _fixed_grid_meta(sol, "sde")
    p = _detached(prob.p)
    u0vec, unravel_u = ravel_pytree(_detached(prob.u0))
    pflat, unravel_p = ravel_pytree(p)
    if p is None:
        pflat = u0vec.new_zeros(0)
    n, npf = u0vec.shape[0], pflat.shape[0]
    dtype, dev = u0vec.dtype, u0vec.device
    if prob.noise == "general":
        m, w_shape = prob.noise_dim, (prob.noise_dim,)
    elif prob.noise == "scalar":
        m, w_shape = 1, ()
    else:
        m, w_shape = n, (n,)
    general = prob.noise == "general"

    def p_of(pf):
        return unravel_p(pf) if p is not None else None

    def f_of(uu, pf, tt):
        return ravel_pytree(prob.f(unravel_u(uu), p_of(pf), tt))[0]

    def g_of(uu, pf, tt):
        if general:
            return torch.as_tensor(prob.g(unravel_u(uu), p_of(pf), tt))
        return ravel_pytree(prob.g(unravel_u(uu), p_of(pf), tt))[0]

    def f_strat(uu, pf, tt):
        fv = f_of(uu, pf, tt)
        if prob.interpretation != "ito":
            return fv
        return fv - _drift_correction(lambda x, s: g_of(x, pf, s), uu, tt)

    W_rev = torch.flip(_forward_noise_nodes(prob, key, n_steps, dt, w_shape,
                                            dtype, dev), [0])
    if prob.noise == "scalar":
        W_rev = W_rev[:, None]
    tau_nodes = t0 + dt * np.arange(n_steps + 1)
    noise_rev = NoiseGrid(ts=tau_nodes, W=W_rev)

    ts, lam_jumps = _sde_data_jumps(sol, t, dgdu_discrete, p, u0vec)
    lam_init, lam_final, cb, cb_times = _reverse_jump_plumbing(
        ts, lam_jumps, t0, t1, n)

    def drift_pullback(uv, tt, lam):
        """((∂f̃/∂u)ᵀλ, (∂f̃/∂p)ᵀλ) at the physical time tt."""
        return pullback(lambda uu, pf: f_strat(uu, pf, tt), uv, pflat, lam)

    def noise_pullback(uv, tt, lam):
        """Per noise column j: ((∂g_j/∂u)ᵀλ, (∂g_j/∂p)ᵀλ), (m, n) and
        (m, npf)."""
        if general:
            eye = torch.eye(m, dtype=dtype, device=dev)
            cots = [lam[:, None] * eye[j][None, :] for j in range(m)]
        elif prob.noise == "scalar":
            cots = [lam]
        else:  # diagonal: g_j = g(u)_j e_j, cotangent λ_j e_j
            cots = list(torch.diag(lam))
        outs = pullbacks(lambda uu, pf: g_of(uu, pf, tt), uv, pflat, cots)
        return (torch.stack([o[0] for o in outs]),
                torch.stack([o[1] for o in outs]))

    def g_cols(uv, tt):
        """The noise matrix's columns g_j(u) as (m, n)."""
        gv = g_of(uv, pflat, tt)
        if general:
            return gv.T
        if prob.noise == "scalar":
            return gv[None, :]
        return torch.diag(gv)

    T = t0 + t1
    if isinstance(sensealg, BacksolveAdjoint):
        def aug_f(z, _p, tau):
            tt = T - tau
            lam, u_cur = z[:n], z[n + npf:]
            ub, pb = drift_pullback(u_cur, tt, lam)
            return torch.cat([ub, pb, -f_strat(u_cur, pflat, tt)])

        def aug_g(z, _p, tau):
            # signs of the discrete time flip ΔW̃_j = −ΔW_{N−1−j}
            tt = T - tau
            lam, u_cur = z[:n], z[n + npf:]
            gu, gp = noise_pullback(u_cur, tt, lam)
            return torch.cat([-gu, -gp, g_cols(u_cur, tt)], dim=1).T

        u_end = _flat_rows(sol)[-1]
        z0 = torch.cat([lam_init, u0vec.new_zeros(npf), u_end])
        note = "BacksolveAdjoint: z = [λ; q; u], u re-integrated backward"
    elif isinstance(sensealg, InterpolatingAdjoint):
        ys_flat, ts_sol = _flat_rows(sol), np.asarray(ts, float)

        def aug_f(z, _p, tau):
            tt = T - tau
            ub, pb = drift_pullback(_interp_rows(ts_sol, ys_flat, tt), tt,
                                    z[:n])
            return torch.cat([ub, pb])

        def aug_g(z, _p, tau):
            tt = T - tau
            gu, gp = noise_pullback(_interp_rows(ts_sol, ys_flat, tt), tt,
                                    z[:n])
            return torch.cat([-gu, -gp], dim=1).T

        z0 = torch.cat([lam_init, u0vec.new_zeros(npf)])
        note = ("InterpolatingAdjoint: z = [λ; q], u(t) interpolated from "
                "sol.ys — save densely for accuracy")
    else:
        raise NotImplementedError(
            f"SDEAdjointProblem supports BacksolveAdjoint/"
            f"InterpolatingAdjoint layouts, got {sensealg!r}")

    adj_prob = SDEProblem(aug_f, aug_g, z0, (t0, t1), p, noise="general",
                          interpretation="stratonovich", noise_dim=m,
                          noise_process=noise_rev)

    def extract(z):
        return unravel_u(z[:n] + lam_final), p_of(z[n:n + npf])

    return AdjointProblemSpec(
        prob=adj_prob, callback=cb, tstops=cb_times, n=n, npf=npf,
        extract=extract, sensealg=sensealg,
        note=note + "; solve with EulerHeun() on the same dt", dt=dt)


def RODEAdjointProblem(sol, sensealg=None, t=None, dgdu_discrete=None):
    """The reverse problem of a fixed-grid RODE solution (JAX :761-855): a
    pathwise ODE in τ = t0 + t1 − t, dλ/dτ = +(∂f/∂u)ᵀλ, dq/dτ =
    +(∂f/∂p)ᵀλ, whose field reads W(T − τ) from the replayed forward path
    (linear between the grid nodes). InterpolatingAdjoint (default)
    interpolates u from sol.ys; BacksolveAdjoint appends −f rows. An
    ODEProblem: solve it with any ODE solver on a grid near spec.dt."""
    from ..problems import RODEProblem
    from .sde import pullback

    sensealg = sensealg if sensealg is not None else InterpolatingAdjoint()
    prob = sol.prob
    if not isinstance(prob, RODEProblem):
        raise TypeError(f"RODEAdjointProblem needs an RODEProblem solution, "
                        f"got {type(prob).__name__}")
    t0, t1, dt, n_steps, key = _fixed_grid_meta(sol, "rode")
    p = _detached(prob.p)
    u0vec, unravel_u = ravel_pytree(_detached(prob.u0))
    pflat, unravel_p = ravel_pytree(p)
    if p is None:
        pflat = u0vec.new_zeros(0)
    n, npf = u0vec.shape[0], pflat.shape[0]
    dtype, dev = u0vec.dtype, u0vec.device
    w_shape = (prob.noise_dim,) if prob.noise_dim else (n,)
    W_fwd = _forward_noise_nodes(prob, key, n_steps, dt, w_shape, dtype, dev)
    fwd_nodes = t0 + dt * np.arange(n_steps + 1)

    def p_of(pf):
        return unravel_p(pf) if p is not None else None

    def W_of(tt):
        return _interp_rows(fwd_nodes, W_fwd, tt)

    ts, lam_jumps = _sde_data_jumps(sol, t, dgdu_discrete, p, u0vec)
    lam_init, lam_final, cb, cb_times = _reverse_jump_plumbing(
        ts, lam_jumps, t0, t1, n)
    T = t0 + t1

    def f_of(uu, pf, tt, wv):
        return ravel_pytree(prob.f(unravel_u(uu), p_of(pf), tt, wv))[0]

    def f_pullback(uv, tt, wv, lam):
        return pullback(lambda uu, pf: f_of(uu, pf, tt, wv), uv, pflat, lam)

    if isinstance(sensealg, BacksolveAdjoint):
        def aug_f(z, _p, tau):
            tt = T - tau
            wv = W_of(tt)
            lam, u_cur = z[:n], z[n + npf:]
            ub, pb = f_pullback(u_cur, tt, wv, lam)
            return torch.cat([ub, pb, -f_of(u_cur, pflat, tt, wv)])

        u_end = _flat_rows(sol)[-1]
        z0 = torch.cat([lam_init, u0vec.new_zeros(npf), u_end])
        note = "BacksolveAdjoint: z = [λ; q; u]"
    else:
        ys_flat, ts_sol = _flat_rows(sol), np.asarray(ts, float)

        def aug_f(z, _p, tau):
            tt = T - tau
            ub, pb = f_pullback(_interp_rows(ts_sol, ys_flat, tt), tt,
                                W_of(tt), z[:n])
            return torch.cat([ub, pb])

        z0 = torch.cat([lam_init, u0vec.new_zeros(npf)])
        note = ("InterpolatingAdjoint: z = [λ; q], u(t) interpolated from "
                "sol.ys — save densely for accuracy")

    def extract(z):
        return unravel_u(z[:n] + lam_final), p_of(z[n:n + npf])

    return AdjointProblemSpec(
        prob=ODEProblem(aug_f, z0, (t0, t1), p), callback=cb,
        tstops=cb_times, n=n, npf=npf, extract=extract, sensealg=sensealg,
        note=note + (f"; an ODEProblem over τ = t0+t1−t reading the "
                     f"replayed path — solve on a fixed grid near "
                     f"dt={dt} (the RHS is Brownian-rough)"), dt=dt)
