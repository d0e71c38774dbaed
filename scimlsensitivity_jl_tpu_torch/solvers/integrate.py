"""Adaptive and fixed-grid time stepping (PyTorch port).

Counterpart of `scimlsensitivity_jl_tpu/solvers/integrate.py`:
`hairer_norm`, `initial_step_size` and `integrate` (integrate.py:118-300),
the PI-controlled adaptive loop with its `fixed_dt=` march, tstops landed
exactly, a per-accepted-step hook, a stop transform and events
(`event_set`, `solvers/events.py`: each accepted step is truncated to its
earliest event, and the post-event state continues from a zero-width
dense row). `fixed_trip=True` gives it the budget of the masked
`integrate_scan` (:498), the loop that DirectAdjoint and the unrolled
continuous rules run; the scan itself is not needed, since autograd
records the eager loop. Multistep (stateful) steppers thread their
history through the loop.

The JAX `lax.while_loop` becomes an eager Python loop. Time, step size and
controller state stay on the host as numpy scalars of the time dtype, so
they round exactly as the JAX package's device scalars do, and the state
stays on the device. The fixed-grid march therefore reads nothing back
from the device. The adaptive loop reads one number per step, the
weighted error norm (`error_norm`): the only place a later CUDA-graph
integrator has to replace.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from ..ops.interp import DenseOutput

__all__ = [
    "IntegrateResult",
    "Stats",
    "integrate",
    "Norms",
    "LOCAL_NORMS",
    "hairer_norm",
    "error_norm",
    "weight_count",
    "match_tol",
    "next_stop",
    "initial_step_size",
    "time_dtype",
    "state_kind",
    "kind_torch_dtype",
    "bfloat16_scalar",
    "RETCODE_SUCCESS",
    "RETCODE_MAXITERS",
    "RETCODE_DTMIN",
    "RETCODE_EVENT_OVERFLOW",
    "RETCODE_TERMINATED",
]

RETCODE_SUCCESS = 0
RETCODE_MAXITERS = 1
RETCODE_DTMIN = 2
# 3 (DDE lag violations) waits for ROADMAP M13; 6: BacksolveAdjoint
# reconstruction drift (adjoints/continuous.py).
RETCODE_EVENT_OVERFLOW = 4  # more event firings than max_events slots
RETCODE_TERMINATED = 5

# step-size controller constants of the JAX integrator's defaults: PI
# coefficients (scaled by 1/(order+1)), safety factor, growth bounds
_PI = (0.7, 0.4)
_SAFETY = 0.9
_FACTOR_MIN = 0.2
_FACTOR_MAX = 10.0


class Stats(NamedTuple):
    n_accepted: int
    n_rejected: int
    n_fevals: int  # approximate: stages * attempts
    retcode: int


class IntegrateResult(NamedTuple):
    dense: Optional[DenseOutput]
    t_final: np.floating
    u_final: torch.Tensor
    stats: Stats
    hook_carry: Any
    # with an event_set: the EventRecord, and per firing step (index of the
    # accepted step, its StepEvents), the replay of ForwardDiffSensitivity
    events: Any = None
    event_log: Any = None


def _round_bf16(x: float) -> float:
    """x rounded to the nearest bfloat16 (ties to even), through float32."""
    if not math.isfinite(x):
        return x
    bits = int(np.float32(x).view(np.uint32))
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return float(np.uint32(bits).view(np.float32))


class bfloat16_scalar(float):
    """A host scalar rounded to bfloat16, which numpy lacks: every
    construction rounds, so `kind(a * b)` rounds a product of two such
    scalars as bfloat16 arithmetic does (the exact product fits a double)."""

    def __new__(cls, x):
        return float.__new__(cls, _round_bf16(float(x)))


_KIND_TORCH = {np.float16: torch.float16, np.float32: torch.float32,
               np.float64: torch.float64, bfloat16_scalar: torch.bfloat16}
_STATE_KIND = {dtype: kind for kind, dtype in _KIND_TORCH.items()}


def _real_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype of a complex state's real part; a real dtype itself."""
    return {torch.complex64: torch.float32,
            torch.complex128: torch.float64}.get(dtype, dtype)


def time_dtype(dtype: torch.dtype):
    """numpy scalar type of the time and controller variables of a solve
    whose state has `dtype`: promote(real(dtype), float32), as the JAX
    integrator keeps it (integrate.py:175-180). A bfloat16 or float16 state
    keeps float32 time, and its stage arithmetic runs promoted; a complex
    state keeps the time of its real part."""
    dtype = _real_dtype(dtype)
    if dtype in (torch.float16, torch.bfloat16, torch.float32):
        return np.float32
    if dtype == torch.float64:
        return np.float64
    raise NotImplementedError(
        f"state dtype {dtype}: the port solves floating-point states")


def state_kind(dtype: torch.dtype):
    """Host scalar type of the state dtype itself (of its real part for a
    complex state): the fixed-grid discrete path keeps dt and the grid
    times in it (JAX adjoints/direct.py:44-48)."""
    dtype = _real_dtype(dtype)
    if dtype not in _STATE_KIND:
        raise NotImplementedError(
            f"state dtype {dtype}: the port solves floating-point states")
    return _STATE_KIND[dtype]


def kind_torch_dtype(kind) -> torch.dtype:
    """The torch dtype of a host scalar type (numpy float or bfloat16)."""
    return _KIND_TORCH[kind]


class Norms:
    """The reductions that the step controller takes over a state vector:
    here over the vector itself. A solve of a state split over the ranks
    of a process group passes `parallel.sharded.ShardNorms`, which reduces
    over every rank's shard; `integrate`, the reverse solves and the
    continuous rules take them as `norms=` (`SolveOptions.norms`)."""

    def mean_sq(self, x: torch.Tensor) -> torch.Tensor:
        """mean(|x|²) over the whole vector (a device scalar)."""
        return torch.mean(x.abs() ** 2)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """Σ x over the whole vector (a device scalar)."""
        return torch.sum(x)

    def vector_norm(self, x: torch.Tensor) -> torch.Tensor:
        """‖x‖₂ over the whole vector."""
        return torch.linalg.vector_norm(x)

    def partial_norm(self, x: torch.Tensor) -> torch.Tensor:
        """‖x‖₂ of a vector of per-rank partial sums (an estimate of p's
        integral, its error), summed over the ranks first; here x is
        whole."""
        return torch.linalg.vector_norm(x)

    def with_partial_rows(self, start: int, stop: int) -> "Norms":
        """These norms over vectors whose rows [start, stop) are per-rank
        partial sums (a joined reverse state's q rows); a whole vector has
        none."""
        return self

    def summed(self, x: torch.Tensor) -> torch.Tensor:
        """x with its partial-sum rows summed over the ranks, the same on
        every rank, for a function of x that is not linear in them (the
        initial step's scale |u|·rtol + atol); here x itself."""
        return x


LOCAL_NORMS = Norms()


def hairer_norm(x: torch.Tensor, norms: Norms = LOCAL_NORMS) -> torch.Tensor:
    """RMS norm of the Hairer-Wanner error controller (a device scalar)."""
    return torch.sqrt(norms.mean_sq(x))


def initial_step_size(fvec, t0, u0, f0, order, rtol, atol, tdir,
                      norms: Norms = LOCAL_NORMS):
    """Hairer-Norsett-Wanner automatic initial dt (Solving ODEs I, II.4).
    Scalars are host values of the time dtype; reads three norms. A
    state below float32 is promoted to the time dtype, as JAX promotes it
    against its float32 rtol."""
    kind = type(t0)
    wide = torch.promote_types(u0.dtype, kind_torch_dtype(kind))
    u0, f0 = u0.to(wide), f0.to(wide)
    # the scale from partial-sum rows summed over the ranks: then it is the
    # same on every rank, and x / sc of a partial-sum row stays a partial sum
    sc = norms.summed(u0).abs() * float(rtol) + float(atol)
    d0, d1 = (kind(v) for v in torch.stack(
        [hairer_norm(u0 / sc, norms),
         hairer_norm(f0 / sc, norms)]).tolist())
    small = kind(1e-6)
    if d0 < kind(1e-5) or d1 < kind(1e-5):
        h0 = small
    else:
        h0 = kind(kind(kind(0.01) * d0) / d1)
    step = kind(tdir * h0)
    f1 = fvec(u0 + f0 * float(step), kind(t0 + step))
    d2 = kind(kind(hairer_norm((f1 - f0) / sc, norms).item()) / h0)
    dmax = max(d1, d2)
    if dmax <= kind(1e-15):
        h1 = max(small, kind(h0 * kind(1e-3)))
    else:
        # XLA rewrites pow(x, 0.5) as sqrt(x), correctly rounded: an
        # order-1 stepper's first step then matches the JAX package's bit
        # for bit (the adaptive SDE grid amplifies an ulp step by step)
        ratio = kind(kind(0.01) / dmax)
        h1 = (kind(np.sqrt(ratio)) if order == 1
              else kind(ratio ** kind(1.0 / (order + 1.0))))
    return kind(tdir * min(kind(kind(100.0) * h0), h1))


def next_stop(t, t1, tstops, tdir):
    """The stop a step from t is clipped to: the nearest of tstops strictly
    ahead of t and before t1, else t1; and its index in tstops (None for
    t1)."""
    if tstops is None or tstops.shape[0] == 0:
        return t1, None
    kind = type(t)
    key = tstops * tdir
    ahead = key > kind(t * tdir) + kind(kind(1e-12) * max(kind(1.0), abs(t)))
    before_end = key < kind(t1 * tdir)
    masked = np.where(ahead & before_end, key, np.inf)
    i = int(np.argmin(masked))
    if not np.isfinite(masked[i]):
        return t1, None
    return kind(key[i] * tdir), i


def error_norm(err, u, u1, rtol, atol, err_weights=None,
               weight_count=None, norms: Norms = LOCAL_NORMS) -> torch.Tensor:
    """The RMS of the error scaled by atol + rtol·max(|u|, |u1|), over the
    weighted components only when `err_weights` is given (weight-0 rows,
    pure quadrature accumulators, must not dilute the mean); a device
    scalar."""
    sc = (torch.maximum(u.abs(), u1.abs()).to(err.dtype) * float(rtol)
          + float(atol))
    if err_weights is None:
        return hairer_norm(err / sc, norms)
    scaled = (err_weights * (err / sc)).abs() ** 2
    return torch.sqrt(norms.sum(scaled) / weight_count)


def weight_count(err_weights: torch.Tensor,
                 norms: Norms = LOCAL_NORMS) -> int:
    """The number of components with a nonzero error weight, at least 1."""
    return max(int(norms.sum(err_weights > 0).item()), 1)


def match_tol(kind, span, *ts):
    """The tolerance to which every stop, save and jump matcher of the port
    takes two times as one: 64 eps · max(|t|..., min(1, |span|)) in the
    time dtype, span the length of the solve. JAX's floor is 1 time unit
    (64 eps · max(|t|..., 1)); for spans of 1 or more the two agree, and
    below 1 the port's floor shrinks with the span, so that a short solve's
    steps and save times stay apart where 64 float32 eps (7.6e-6) can
    exceed the whole span (a deliberate divergence, ROADMAP §3)."""
    eps = kind(np.finfo(kind).eps)
    floor = min(kind(1.0), abs(kind(span)))
    return kind(kind(kind(64.0) * eps) * max([floor] + [abs(t) for t in ts]))


class _OffsetClock:
    """The derivatives of the host clock's times, as zero-valued tensors
    beside the host values (DirectAdjoint through save or event times),
    with the reach of JAX's traced times: a step clipped to a stop that has
    an offset, or taken from a time that has one, gets its length's as
    `ddt` (stop - t); the current time keeps its offset until the next
    clipped step, and an event time brings its own."""

    def __init__(self, stop_offsets):
        self.stop_offsets = stop_offsets or {}
        self.t = None    # the current time's offset, or None
        self.end = None  # the offset of this step's end

    def begin(self, clipped: bool, stop_i):
        """Start a step; returns its length's offset ddt, or None."""
        stop_off = (self.stop_offsets.get(stop_i)
                    if clipped and stop_i is not None else None)
        self.end = stop_off if clipped else self.t
        if not clipped or (stop_off is None and self.t is None):
            return None
        if self.t is None:
            return stop_off
        return -self.t if stop_off is None else stop_off - self.t

    def truncate(self, se):
        """The step ends at an event: a continuous one moves its time."""
        if se.theta is not None:
            self.end = se.t_e_off


def integrate(
    stepper,
    fvec: Callable,
    t0,
    t1,
    u0: torch.Tensor,
    *,
    rtol=1e-7,
    atol=1e-9,
    dt0=None,
    max_steps: int = 4096,
    tstops=None,
    hook: Optional[Callable] = None,
    hook_carry: Any = None,
    store_dense: bool = True,
    err_weights: Optional[torch.Tensor] = None,
    stop_transform: Optional[Callable] = None,
    dtmax=None,
    fixed_dt=None,
    fixed_trip: bool = False,
    event_set=None,
    stop_offsets=None,
    always_accept: bool = False,
    norms: Norms = LOCAL_NORMS,
) -> IntegrateResult:
    """Integrate du/dt = fvec(u, t) from t0 to t1 (t1 < t0 allowed).

    fixed_dt: march the grid t0 + k·fixed_dt instead of adapting: every
        step is accepted, the controller is bypassed and no error is
        computed, steps still clip to tstops exactly. Instability shows as
        NaN states, which the adjoint rules turn into NaN gradients.
    fvec: (uvec, t) -> duvec over flat state vectors; t is a host scalar.
    stepper: `.order` and `.step(fvec, t, dt, u, f0, need_err)`. A stepper
        with `stateful = True` (FBDF) has `init_state(fvec, t0, u0, f0,
        rtol, atol)` and `step(fvec, t, dt, u, f0, state) -> (u1, f1, err,
        state')`; the state advances on accepted steps only, restarts
        (`reset_state(state, t, u, t_off=)`, t_off the restart time's
        offset or None) after an event or a jump,
        `controller_order(state)` sets the PI exponents, and its
        `factor_max` bounds the growth (JAX integrate.py:161-163,
        :221-223, :255, :282-284, :431-441). The fixed_trip driver
        refuses it, as JAX's scan driver does (:550).
    hook: `(step_record, carry) -> carry` on accepted steps, with
        step_record = (t_old, t_new, y0, f0, y1, f1).
    stop_transform: `(t, u, carry) -> (u', carry', fired)` when an accepted
        step lands exactly on a stop (the PresetTimeCallback analogue). When
        it fires, f is evaluated again at u' and a zero-width dense row
        holds the post-jump state.
    fixed_trip: the budget of JAX's `integrate_scan` (integrate.py:774-800):
        max_steps attempts, rejected ones included, then MaxIters; no DtMin
        check (a vanishing step runs the budget out); n_fevals reports
        max_steps·stages, the scan's fixed trip count; no event-overflow
        retcode (the scan loop has none).
    event_set: `callbacks.EventSet`. An accepted step with an event is
        truncated to it (its dense row holds the pre-affect state), a
        zero-width row holds the post-affect state and counts in
        n_accepted, and the hook sees the post-affect state. A terminal
        event stops the loop there with retcode 5 (Terminated); more
        firings than max_events give retcode 4 (EventRecordOverflow).
    stop_offsets: {index into tstops: zero-valued tensor} carrying the
        derivative of those stops (DirectAdjoint's save times): a step
        clipped to a stop gets the length stop - t as a tensor, `ddt`, and
        time keeps a zero-valued offset until the next clipped step, as
        JAX's traced times do. Events add the event time's offset.
    always_accept: the previsible controller of JAX's adaptive SDE paths
        (integrate.py:531-535): every step with a finite error is taken,
        and the error only sizes the next one.
    norms: the error norms' reductions (`Norms`; over every rank's shard
        for a sharded state).
    """
    stateful = getattr(stepper, "stateful", False)
    if stateful and fixed_trip:
        raise NotImplementedError(
            f"{stepper!r} is a multistep (stateful) stepper; it needs the "
            "adaptive while_loop driver (integrate). Use a one-step stiff "
            "solver (Rosenbrock23/TRBDF2/SDIRK4/Seulex) here.")
    dtype = u0.dtype
    kind = time_dtype(dtype)
    t0, t1 = kind(t0), kind(t1)
    tdir = kind(1.0) if t1 >= t0 else kind(-1.0)
    order = stepper.order
    rtol, atol = kind(rtol), kind(atol)
    if tstops is not None:
        tstops = np.asarray(tstops, dtype=kind)
    n_weighted = None
    if err_weights is not None:
        n_weighted = weight_count(err_weights, norms)

    f0 = fvec(u0, t0).to(dtype)
    if fixed_dt is not None:
        dt = kind(tdir * abs(kind(fixed_dt)))
    elif dt0 is None:
        dt = initial_step_size(fvec, t0, u0, f0, order, rtol, atol, tdir,
                               norms)
    else:
        dt = kind(tdir * abs(kind(dt0)))

    beta1 = kind(_PI[0] / (order + 1.0))
    beta2 = kind(_PI[1] / (order + 1.0))
    safety, factor_min, factor_max = (kind(_SAFETY), kind(_FACTOR_MIN),
                                      kind(_FACTOR_MAX))
    # a multistep stepper's own growth bound, and its state
    factor_max = min(factor_max, kind(getattr(stepper, "factor_max",
                                              factor_max)))
    sstate = (stepper.init_state(fvec, t0, u0, f0, rtol, atol) if stateful
              else None)

    t, u, f = t0, u0, f0
    err_prev = kind(1.0)
    n_acc = n_rej = n_iter = n_steps = 0
    status = -1
    rows_t, rows_y, rows_f, rows_off = [t0], [u0], [f0], [None]
    record, event_log = None, []
    if event_set is not None:
        from .events import (finish_record, init_event_buffers,
                             process_step_events)

        record = init_event_buffers(event_set, t1, u0.shape[0], dtype, kind,
                                    u0.device)
    clock = (_OffsetClock(stop_offsets)
             if stop_offsets is not None or event_set is not None else None)

    def add_row(t_row, u_row, f_row):
        if store_dense:
            rows_t.append(t_row)
            rows_y.append(u_row)
            rows_f.append(f_row)
            rows_off.append(None if clock is None else clock.end)

    while status < 0:
        stop, stop_i = next_stop(t, t1, tstops, tdir)
        remaining = kind(stop - t)
        clipped = abs(dt) >= abs(remaining)
        dt_eff = remaining if clipped else dt
        t_off = None if clock is None else clock.t
        ddt = None if clock is None else clock.begin(clipped, stop_i)

        step_kw = {key: v for key, v in (("ddt", ddt), ("t_off", t_off))
                   if v is not None}
        if stateful:
            u1, f1, err, sstate_new = stepper.step(fvec, t, dt_eff, u, f,
                                                   sstate, **step_kw)
        else:
            u1, f1, err = stepper.step(fvec, t, dt_eff, u, f,
                                       need_err=fixed_dt is None, **step_kw)
        u1, f1 = u1.to(dtype), f1.to(dtype)

        if fixed_dt is None:
            err_norm = kind(error_norm(err, u, u1, rtol, atol, err_weights,
                                       n_weighted, norms).item())
            bad = not np.isfinite(err_norm)
            if bad:
                err_norm = kind(2.0)
            accept = (always_accept or bool(err_norm <= kind(1.0))) and not bad
            # PI controller on |dt| (Soderlind), from this and the last error
            err_cl = max(err_norm, kind(1e-10))
            b1, b2 = beta1, beta2
            if stateful and hasattr(stepper, "controller_order"):
                # a variable-order method: the exponents follow its order
                ordd = kind(kind(stepper.controller_order(sstate_new))
                            + kind(1.0))
                b1 = kind(kind(_PI[0]) / ordd)
                b2 = kind(kind(_PI[1]) / ordd)
            factor = kind(kind(safety * kind(err_cl ** -b1))
                          * kind(err_prev ** b2))
            if bad:
                factor = factor_min
            factor = min(max(factor, factor_min), factor_max)
            dt_next = kind(dt_eff * factor)
            if dtmax is not None:
                cap = abs(kind(dtmax))
                dt_next = min(max(dt_next, -cap), cap)
            if accept:
                err_prev = err_cl
        else:
            accept = True
            dt_next = kind(tdir * abs(kind(fixed_dt)))

        se = None
        if accept:
            t_new = kind(t + dt_eff)
            u_new, f_new = u1, f1
            if event_set is not None:
                se = process_step_events(event_set, fvec, t, dt_eff, u, f,
                                         u1, f1, record, t_off=clock.t,
                                         dt_off=ddt)
            if se is not None:
                # truncate the step to the event (pre-affect state)
                t_new, u_new, f_new = se.t_e, se.u_pre, se.f_pre
                clock.truncate(se)
                event_log.append((n_steps, se))
            n_acc += 1
            add_row(t_new, u_new, f_new)
            if se is not None:
                # the post-affect state continues from a zero-width row
                u_new, f_new = se.u_post, se.f_post
                n_acc += 1
                add_row(t_new, u_new, f_new)
            if hook is not None:
                hook_carry = hook((t, t_new, u, f, u_new, f_new), hook_carry)
            n_steps += 1
            if clock is not None:
                clock.t = clock.end
            fired = False
            if stop_transform is not None and clipped and se is None:
                # evaluate f one stop-matching tolerance into the direction
                # of integration, on the far side of the jump
                t_eval = kind(t_new + kind(tdir * match_tol(
                    kind, t1 - t0, t_new)))
                u_new, hook_carry, fired = stop_transform(t_new, u_new,
                                                          hook_carry)
                if fired:
                    if clock is not None and clock.t is not None:
                        t_eval = clock.t + float(t_eval)
                    f_new = fvec(u_new, t_eval).to(dtype)
                    n_acc += 1
                    add_row(t_new, u_new, f_new)
            if stateful:
                sstate = sstate_new
                # a jump (an event, a stop transform) restarts the history
                if se is not None or fired:
                    sstate = stepper.reset_state(
                        sstate, t_new, u_new,
                        t_off=None if clock is None else clock.t)
        else:
            t_new, u_new, f_new = t, u, f
            n_rej += 1

        done = accept and kind(kind(t1 - t_new) * tdir) <= kind(
            kind(abs(t1) * kind(1e-14)) + kind(1e-300))
        dt_floor = kind(kind(1e-14) * max(kind(1.0), abs(t_new)))
        if fixed_trip:
            underflow = False
            out_of_steps = n_iter + 1 >= max_steps and not done
        else:
            underflow = abs(dt_next) < dt_floor and not done
            out_of_steps = (n_acc >= max_steps
                            or n_iter + 1 >= 4 * max_steps) and not done
        if se is not None and se.terminated:
            status = RETCODE_TERMINATED  # a deliberate stop wins
        elif done:
            status = RETCODE_SUCCESS
        elif out_of_steps:
            status = RETCODE_MAXITERS
        elif underflow:
            status = RETCODE_DTMIN

        t, u, f, dt = t_new, u_new, f_new, dt_next
        n_iter += 1

    dense = None
    if store_dense:
        dense = DenseOutput(ts=np.asarray(rows_t, dtype=kind),
                            ys=torch.stack(rows_y), fs=torch.stack(rows_f),
                            n_steps=len(rows_t) - 1, tdir=tdir,
                            ts_off=(rows_off if any(o is not None
                                                    for o in rows_off)
                                    else None))
    trips = max_steps if fixed_trip else n_iter
    events = None
    if record is not None:
        events = finish_record(record)
        # more firings than record slots: the extra affects were applied
        # but are not in the record, so every record-consuming reverse pass
        # would be wrong; the adjoint rules poison on the retcode
        if (not fixed_trip and events.count > event_set.max_events
                and status in (RETCODE_SUCCESS, RETCODE_TERMINATED)):
            status = RETCODE_EVENT_OVERFLOW
    stats = Stats(n_accepted=n_acc, n_rejected=n_rej,
                  n_fevals=trips * getattr(stepper, "n_stages", 1),
                  retcode=status)
    return IntegrateResult(dense=dense, t_final=t, u_final=u, stats=stats,
                           hook_carry=hook_carry, events=events,
                           event_log=event_log)
