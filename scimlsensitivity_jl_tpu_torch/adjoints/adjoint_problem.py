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
`solve`'s closure check. `SDEAdjointProblem` and `RODEAdjointProblem`
raise: SDE and RODE problems are ROADMAP M12.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..callbacks import PresetTimeCallback
from ..ops.interp import dense_eval
from ..ops.vjp import make_vjp_kernels
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


def SDEAdjointProblem(sol, sensealg=None, t=None, dgdu_discrete=None):
    """The reverse SDE of an SDE solution: not ported (ROADMAP M12)."""
    raise NotImplementedError(
        "SDEAdjointProblem: SDE problems are ROADMAP M12")


def RODEAdjointProblem(sol, sensealg=None, t=None, dgdu_discrete=None):
    """The reverse problem of an RODE solution: not ported (ROADMAP M12)."""
    raise NotImplementedError(
        "RODEAdjointProblem: RODE problems are ROADMAP M12")
