"""Events and callbacks (PyTorch port).

Counterpart of `scimlsensitivity_jl_tpu/callbacks.py`: the callback types
(`ContinuousCallback`, `DiscreteCallback`, `VectorContinuousCallback`,
`PresetTimeCallback`, `PeriodicCallback`, `TerminateSteadyState`,
`CallbackSet`), their solve-time lowering (`lower_time_callbacks`,
`as_callback_set`), the flat-state `EventSet` (`build_event_set`),
`any_modifies_p`, `lift_p_into_state`, its SDE form
`lift_p_into_state_sde` (:450-537) and the closure guard
`check_callback_closures`.

condition(u, p, t) -> scalar (continuous: an event at a zero crossing) or
bool (discrete: checked at accepted step ends); affect(u, p, t) -> u⁺, or
(u⁺, p⁺) with modifies_p=True. Both are pure functions of tensors. A
continuous condition may receive t as a 0-dim tensor of the time dtype
(the crossing search samples it on the device), a discrete one gets the
host scalar.

Deliberate divergence (ROADMAP §3): `PresetTimeCallback` takes a step end
as a preset time within `solvers.integrate.match_tol` of it, relative to
the span below 1, where JAX uses 64 eps · max(1, |t|). On a span shorter
than that float32 tolerance (7.6e-6) JAX's lowered condition holds at
every step end and doses at every step.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .solvers.integrate import match_tol
from .utils.pytree import ravel_pytree

__all__ = [
    "ContinuousCallback",
    "DiscreteCallback",
    "VectorContinuousCallback",
    "PresetTimeCallback",
    "PeriodicCallback",
    "TerminateSteadyState",
    "CallbackSet",
    "EventSet",
    "build_event_set",
    "lower_time_callbacks",
    "as_callback_set",
    "any_modifies_p",
    "check_callback_closures",
    "lift_p_into_state",
    "lift_p_into_state_sde",
]


@dataclass(frozen=True)
class ContinuousCallback:
    """An event where condition(u, p, t) crosses zero inside an accepted
    step (direction -1: downward only, +1: upward only, 0: both). terminal:
    the affect is applied, then integration stops at the event time with
    retcode 5 (Terminated)."""

    condition: Callable
    affect: Callable
    direction: int = 0
    modifies_p: bool = False
    terminal: bool = False


@dataclass(frozen=True)
class DiscreteCallback:
    """An event at every accepted step end where condition(u, p, t) holds."""

    condition: Callable
    affect: Callable
    modifies_p: bool = False
    terminal: bool = False


@dataclass(frozen=True)
class VectorContinuousCallback:
    """`len` zero-crossing conditions sharing one indexed affect:
    condition(u, p, t) -> (len,), affect(u, p, t, idx) -> u⁺. Lowered to
    `len` scalar ContinuousCallbacks, so each component is its own event."""

    condition: Callable
    affect: Callable
    len: int
    direction: int = 0
    modifies_p: bool = False
    terminal: bool = False

    def lower(self) -> tuple:
        def comp(i):
            return ContinuousCallback(
                condition=lambda u, p, t, i=i: torch.as_tensor(
                    self.condition(u, p, t))[i],
                affect=lambda u, p, t, i=i: self.affect(u, p, t, i),
                direction=self.direction,
                modifies_p=self.modifies_p,
                terminal=self.terminal,
            )

        return tuple(comp(i) for i in range(self.len))


@dataclass(frozen=True)
class PresetTimeCallback:
    """Apply `affect` at the given times (the dosing surface). Lowered to a
    DiscreteCallback that fires where a step end lands on a preset time,
    with the times forced as tstops so step ends land there."""

    ts: Any
    affect: Callable
    modifies_p: bool = False
    terminal: bool = False

    def lower(self, t0, t1, kind=np.float64):
        """(DiscreteCallback, sorted preset times inside (t0, t1]); `kind`
        is the solve's time dtype, the matcher's."""
        t0, t1 = float(t0), float(t1)
        ts = np.atleast_1d(np.asarray(self.ts, float))
        lo, hi = min(t0, t1), max(t0, t1)
        ts_arr = np.sort(ts[(ts > lo) & (ts <= hi)])
        targets = ts_arr.astype(kind)
        span = kind(t1 - t0)

        def condition(u, p, t):
            t = kind(t)
            return any(abs(kind(t - s)) <= match_tol(kind, span, t)
                       for s in targets)

        cb = DiscreteCallback(condition=condition, affect=self.affect,
                              modifies_p=self.modifies_p,
                              terminal=self.terminal)
        return cb, ts_arr


@dataclass(frozen=True)
class PeriodicCallback:
    """Apply `affect` every `period`, first at t0 + period; lowered to a
    PresetTimeCallback over the span."""

    affect: Callable
    period: float
    modifies_p: bool = False
    terminal: bool = False

    def lower(self, t0, t1, kind=np.float64):
        span = abs(float(t1) - float(t0))
        k = int(np.floor(span / float(self.period) + 1e-12))
        sign = 1.0 if float(t1) >= float(t0) else -1.0
        ts = float(t0) + sign * float(self.period) * np.arange(1, k + 1)
        return PresetTimeCallback(ts=ts, affect=self.affect,
                                  modifies_p=self.modifies_p,
                                  terminal=self.terminal).lower(t0, t1, kind)


@dataclass(frozen=True)
class TerminateSteadyState:
    """Terminate where every |f(u, p, t)| <= abstol + reltol·|u| at an
    accepted step end (and t >= min_t when given). Lowered to a terminal
    DiscreteCallback over the problem's field."""

    abstol: float = 1e-8
    reltol: float = 1e-6
    min_t: Optional[float] = None

    def lower(self, f, unused_t0=None):
        def condition(u, p, t):
            du = ravel_pytree(f(u, p, t))[0]
            uv = ravel_pytree(u)[0]
            ok = bool(torch.all(du.abs() <= self.abstol
                                + self.reltol * uv.abs()))
            if self.min_t is not None:
                ok = ok and float(t) >= self.min_t
            return ok

        return DiscreteCallback(condition=condition,
                                affect=lambda u, p, t: u, terminal=True)


@dataclass(frozen=True)
class CallbackSet:
    continuous: Tuple[ContinuousCallback, ...] = ()
    discrete: Tuple[DiscreteCallback, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "continuous", tuple(self.continuous))
        object.__setattr__(self, "discrete", tuple(self.discrete))


def lower_time_callbacks(cb, f, t0, t1, kind=np.float64):
    """Lower PresetTime/Periodic callbacks to tstop-pinned
    DiscreteCallbacks and TerminateSteadyState to one over `f`. Returns
    (lowered list, extra tstops array or None). Takes one callback, a list
    or tuple, or a CallbackSet."""
    items = list(cb) if isinstance(cb, (list, tuple)) else [cb]
    if isinstance(cb, CallbackSet):
        items = list(cb.continuous) + list(cb.discrete)
    out, stops = [], []
    for c in items:
        if isinstance(c, (PresetTimeCallback, PeriodicCallback)):
            dc, ts = c.lower(t0, t1, kind)
            out.append(dc)
            stops.append(np.asarray(ts))
        elif isinstance(c, TerminateSteadyState):
            out.append(c.lower(f))
        else:
            out.append(c)
    extra = np.sort(np.unique(np.concatenate(stops))) if stops else None
    return out, extra


def as_callback_set(cb) -> Optional[CallbackSet]:
    if cb is None:
        return None
    if isinstance(cb, CallbackSet):
        return cb
    if isinstance(cb, VectorContinuousCallback):
        return CallbackSet(continuous=cb.lower())
    if isinstance(cb, ContinuousCallback):
        return CallbackSet(continuous=(cb,))
    if isinstance(cb, DiscreteCallback):
        return CallbackSet(discrete=(cb,))
    if isinstance(cb, (list, tuple)):
        cont, disc = [], []
        for c in cb:
            if isinstance(c, VectorContinuousCallback):
                cont.extend(c.lower())
            elif isinstance(c, ContinuousCallback):
                cont.append(c)
            elif isinstance(c, DiscreteCallback):
                disc.append(c)
            else:
                raise TypeError(
                    f"not a callback (or needs lower_time_callbacks): {c!r}")
        return CallbackSet(continuous=tuple(cont), discrete=tuple(disc))
    raise TypeError(f"not a callback: {cb!r}")


class EventSet(NamedTuple):
    """Flat-state event functions for the integrator.

    cond(uvec, t) -> (n_cont,) tensor; disc_cond(uvec, t) -> list of
    n_disc bools (or 0-dim bool tensors); affect_p(uvec, p, t, j) -> flat
    u⁺ of callback j (continuous ones first, then discrete), affect(uvec,
    t, j) the same at the solve's p; directions and terminals: per
    callback, host lists."""

    cond: Optional[Callable]
    affect: Callable
    disc_cond: Optional[Callable]
    n_cont: int
    n_disc: int
    max_events: int
    directions: Any = None
    affect_p: Any = None
    terminals: Any = None
    cond_j: Any = None  # (uvec, p, t, j) -> condition j, continuous only


def build_event_set(cbs: CallbackSet, p, unravel_u,
                    max_events: int) -> EventSet:
    """Lower a CallbackSet to flat-state functions, closing over p."""
    conts, discs = cbs.continuous, cbs.discrete
    n_cont, n_disc = len(conts), len(discs)
    all_affects = [c.affect for c in conts] + [d.affect for d in discs]

    def cond_j(uvec, p_, t, j):
        return torch.as_tensor(conts[j].condition(unravel_u(uvec), p_, t))

    cond = None
    if n_cont:
        def cond(uvec, t):
            return torch.stack([cond_j(uvec, p, t, j) for j in range(n_cont)])

    disc_cond = None
    if n_disc:
        def disc_cond(uvec, t):
            u = unravel_u(uvec)
            return [d.condition(u, p, t) for d in discs]

    def affect_p(uvec, p_, t, j):
        return ravel_pytree(all_affects[j](unravel_u(uvec), p_, t))[0].to(
            uvec.dtype)

    def affect(uvec, t, j):
        return affect_p(uvec, p, t, j)

    term_flags = [bool(getattr(c, "terminal", False))
                  for c in tuple(conts) + tuple(discs)]
    return EventSet(cond=cond, affect=affect, disc_cond=disc_cond,
                    n_cont=n_cont, n_disc=n_disc, max_events=max_events,
                    directions=[int(c.direction) for c in conts] or None,
                    affect_p=affect_p,
                    terminals=term_flags if any(term_flags) else None,
                    cond_j=cond_j)


def any_modifies_p(cbs: CallbackSet) -> bool:
    return any(getattr(c, "modifies_p", False)
               for c in tuple(cbs.continuous) + tuple(cbs.discrete))


def _closure_grad_tensors(fn, _depth=0):
    """Tensors with requires_grad in `fn`'s closure, recursing through
    captured functions, partials and containers (depth-bounded)."""
    if _depth > 4:
        return []
    found = []

    def scan(v):
        if isinstance(v, torch.Tensor):
            if v.requires_grad:
                found.append(v)
        elif isinstance(v, (list, tuple)):
            for x in v:
                scan(x)
        elif isinstance(v, dict):
            for x in v.values():
                scan(x)
        elif isinstance(v, functools.partial):
            for x in v.args:
                scan(x)
            for x in v.keywords.values():
                scan(x)
            found.extend(_closure_grad_tensors(v.func, _depth + 1))
        elif callable(v) and hasattr(v, "__closure__"):
            found.extend(_closure_grad_tensors(v, _depth + 1))

    for cell in getattr(fn, "__closure__", None) or ():
        try:
            scan(cell.cell_contents)
        except ValueError:  # empty cell
            pass
    return found


def check_callback_closures(cbs: CallbackSet) -> None:
    """Refuse a condition or affect that closes over a tensor with
    requires_grad under a continuous rule: its torch.autograd.Function
    sees u0 and p only, so such a tensor would silently get no gradient
    (JAX's guard refuses closure-captured AD tracers for the same
    reason)."""
    for c in tuple(cbs.continuous) + tuple(cbs.discrete):
        for role in ("condition", "affect"):
            fn = getattr(c, role, None)
            if fn is not None and _closure_grad_tensors(fn):
                raise ValueError(
                    f"the {role} of a {type(c).__name__} closes over a "
                    "tensor with requires_grad. Continuous adjoints run "
                    "through a torch.autograd.Function that differentiates "
                    "u0 and p only, so that tensor would get no gradient. "
                    "Pass it through the problem's p instead (condition and "
                    "affect receive (u, p, t)), or use "
                    "sensealg=DirectAdjoint() (autograd through the steps).")


def _zeros_like_tree(tree):
    if isinstance(tree, dict):
        return {key: _zeros_like_tree(tree[key]) for key in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zeros_like_tree(x) for x in tree)
    return torch.zeros_like(tree)


def lift_p_into_state(prob, cbs: CallbackSet):
    """Rewrite (prob, callbacks) so p joins the integration state: z = (u,
    p), f_z = (f(u, p, t), 0); conditions and affects read p from the state
    and p-modifying affects write it. Gradients with respect to the
    original p come out as the p-part of du0 of the lifted problem.
    Returns (prob_z, cbs_z)."""
    from .problems import ODEProblem

    f = prob.f

    def f_z(z, _p, t):
        u, pp = z
        return (f(u, pp, t), _zeros_like_tree(pp))

    def lift_affect(cb):
        aff = cb.affect
        if cb.modifies_p:
            return lambda z, _p, t: aff(z[0], z[1], t)
        return lambda z, _p, t: (aff(z[0], z[1], t), z[1])

    def lift_cond(cb):
        cond = cb.condition
        return lambda z, _p, t: cond(z[0], z[1], t)

    cbs_z = CallbackSet(
        continuous=tuple(
            ContinuousCallback(condition=lift_cond(c), affect=lift_affect(c),
                               direction=c.direction, terminal=c.terminal)
            for c in cbs.continuous),
        discrete=tuple(
            DiscreteCallback(condition=lift_cond(c), affect=lift_affect(c),
                             terminal=c.terminal)
            for c in cbs.discrete),
    )
    prob_z = ODEProblem(f_z, (prob.u0, prob.p), prob.tspan, None)
    return prob_z, cbs_z


def lift_p_into_state_sde(prob, callbacks: tuple):
    """The SDE form of `lift_p_into_state` (JAX callbacks.py:450-537): p
    rides the state z = (u, p) with zero drift and zero noise rows, so
    the solution and every discrete adjoint are those of the original
    problem but for the doses on p. Returns (prob_z, callbacks_z, n_u),
    n_u the flat size of the original state."""
    from .problems import SDEProblem

    if prob.noise_process is not None:
        raise NotImplementedError(
            "modifies_p SDE callbacks + user noise_process: the p-lift "
            "changes the state (and noise) dimension, which a fixed user "
            "path cannot follow — use framework noise or fold p into the "
            "state manually")
    f, g = prob.f, prob.g
    n_u = ravel_pytree(prob.u0)[0].shape[0]
    np_flat = ravel_pytree(prob.p)[0].shape[0] if prob.p is not None else 0

    def f_z(z, _p, t):
        u, pp = z
        return (f(u, pp, t), _zeros_like_tree(pp))

    if prob.noise == "general":
        def g_z(z, _p, t):
            u, pp = z
            G = torch.as_tensor(g(u, pp, t))
            return torch.cat([G, G.new_zeros((np_flat, G.shape[1]))], dim=0)
    else:
        def g_z(z, _p, t):
            u, pp = z
            return (g(u, pp, t), _zeros_like_tree(pp))

    def wrap_affect(aff, modifies_p):
        if modifies_p:
            return lambda z, _p, t: aff(z[0], z[1], t)
        return lambda z, _p, t: (aff(z[0], z[1], t), z[1])

    def lift_cb(c):
        if isinstance(c, ContinuousCallback):
            cond = c.condition
            return ContinuousCallback(
                condition=lambda z, _p, t, cond=cond: cond(z[0], z[1], t),
                affect=wrap_affect(c.affect, c.modifies_p),
                direction=c.direction, terminal=c.terminal)
        if isinstance(c, DiscreteCallback):
            cond = c.condition
            return DiscreteCallback(
                condition=lambda z, _p, t, cond=cond: cond(z[0], z[1], t),
                affect=wrap_affect(c.affect, c.modifies_p),
                terminal=c.terminal)
        if isinstance(c, PresetTimeCallback):
            return PresetTimeCallback(
                ts=c.ts, affect=wrap_affect(c.affect, c.modifies_p),
                terminal=c.terminal)
        if isinstance(c, PeriodicCallback):
            return PeriodicCallback(
                affect=wrap_affect(c.affect, c.modifies_p),
                period=c.period, terminal=c.terminal)
        raise NotImplementedError(
            f"modifies_p lift: unsupported SDE callback type "
            f"{type(c).__name__}")

    prob_z = SDEProblem(
        f=f_z, g=g_z, u0=(prob.u0, prob.p), tspan=prob.tspan, p=None,
        noise=prob.noise, interpretation=prob.interpretation,
        noise_dim=prob.noise_dim)
    return prob_z, tuple(lift_cb(c) for c in callbacks), n_u
