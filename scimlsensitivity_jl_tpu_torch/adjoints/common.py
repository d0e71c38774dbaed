"""Shared adjoint machinery (PyTorch port).

Counterpart of `scimlsensitivity_jl_tpu/adjoints/common.py`:
`forward_saveat_solve` (:430) with `save_hook_factory` (:407), its
`extra_hook` and the event set, `reverse_joined_solve` (:185) with
loss-cotangent jumps, checkpoint snaps, the per-accepted-step hook, the
reverse dense output (`collect_dense`) and the recorded events' reverse
transforms (`event_times`, `event_count`, `event_apply`),
`reverse_pinned_solve` (:35, without `collect_lam_nodes`, which nothing
calls) and `match_cotangents` (:551).

Save times, jump times and snap times are host values, so matching them
against the integrator's host clock reads nothing from the device. Every
matcher takes two times as one within `solvers.integrate.match_tol`,
relative to the solve's span below 1 where JAX's floor is 1 (ROADMAP §3).
"""

from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops.interp import DenseOutput
from ..solvers.integrate import (LOCAL_NORMS, Stats, error_norm, integrate,
                                 match_tol, time_dtype, weight_count)
from ..utils.pytree import ravel_pytree

__all__ = [
    "ForwardResult",
    "forward_saveat_solve",
    "reverse_joined_solve",
    "reverse_pinned_solve",
    "save_hook_factory",
    "save_carry0",
    "saved_rows",
    "augmented_fvec",
    "match_cotangents",
]


class ForwardResult(NamedTuple):
    ys_save: torch.Tensor  # (nt, n) states at saveat
    dense: Optional[DenseOutput]
    t_final: np.floating
    u_final: torch.Tensor
    stats: Stats
    events: Any = None  # solvers.events.EventRecord with an event set
    event_log: Any = None  # per firing step: (accepted-step index, events)


def save_hook_factory(saveat: np.ndarray, tdir, span):
    """Accepted-step hook that captures u at each save time.

    `saveat` is merged into the stops, so the integrator lands on each save time
    exactly up to roundoff; the hook records the state the first time
    t_new reaches saveat[k] (within `match_tol` of the solve's `span`).
    Carry: (list of rows, k)."""
    nt = saveat.shape[0]
    kind = saveat.dtype.type

    def hook(rec, carry):
        _t_old, t_new, _y0, _f0, y1, _f1 = rec
        rows, k = carry
        if k >= nt:
            return rows, k
        target = saveat[k]
        tol = match_tol(kind, span, target, t_new)
        if kind(kind(t_new - target) * tdir) >= -tol:
            rows[k] = y1
            k += 1
        return rows, k

    return hook


def save_carry0(saveat: np.ndarray, t0, tdir, u0vec: torch.Tensor, span):
    """The save hook's first carry: save times at or before t0 (normally
    just saveat[0] == t0) hold u0."""
    kind = saveat.dtype.type
    tol0 = match_tol(kind, span, t0)
    rows: List[Optional[torch.Tensor]] = [None] * saveat.shape[0]
    k0 = 0
    for i in range(saveat.shape[0]):
        if kind(kind(saveat[i] - t0) * tdir) <= tol0:
            rows[i] = u0vec
            k0 += 1
    return rows, k0


def saved_rows(carry, u_final: torch.Tensor) -> torch.Tensor:
    """(nt, n) rows from the save hook's last carry. Save times never
    reached (MaxIters/DtMin truncation) hold the final state, as the dense
    output clamps; the retcode flags the failure."""
    rows, k = carry
    return torch.stack([rows[i] if i < k else u_final
                        for i in range(len(rows))])


def forward_saveat_solve(
    stepper,
    fvec: Callable,
    u0vec: torch.Tensor,
    t0,
    t1,
    saveat,
    *,
    rtol,
    atol,
    dt0=None,
    max_steps: int,
    tstops=None,
    store_dense: bool = True,
    dtmax=None,
    fixed_dt=None,
    fixed_trip: bool = False,
    extra_hook: Optional[Callable] = None,
    event_set=None,
    saveat_offsets=None,
    always_accept: bool = False,
    norms=LOCAL_NORMS,
) -> ForwardResult:
    """Forward solve capturing the saveat states exactly; `fixed_trip` and
    `event_set` as in `integrate`. `extra_hook(step_record)` runs on every
    accepted step (the JAX function threads a carry through it; a Python
    closure keeps its own state). saveat_offsets: (nt,) zero-valued tensor
    carrying the save times' derivatives (DirectAdjoint), passed to
    `integrate` as its stop offsets. Save times past a terminal stop hold
    the terminal state. always_accept: `integrate`'s previsible controller
    (the adaptive SDE path); norms: its error norms' reductions."""
    kind = time_dtype(u0vec.dtype)
    t0, t1 = kind(t0), kind(t1)
    saveat = np.asarray(saveat, dtype=kind)
    tdir = kind(1.0) if t1 >= t0 else kind(-1.0)

    all_stops = saveat if tstops is None else np.sort(
        np.concatenate([saveat, np.asarray(tstops, dtype=kind)]))
    stop_offsets = None
    if saveat_offsets is not None:
        # a stop that is both a save time and a tstop takes the save time's
        # derivative (JAX's stop is the saveat entry, traced)
        stop_offsets = {}
        for i, s_i in enumerate(saveat):
            j = int(np.flatnonzero(all_stops == s_i)[0])
            stop_offsets.setdefault(j, saveat_offsets[i])

    hook = save_hook_factory(saveat, tdir, t1 - t0)
    if extra_hook is not None:
        save_hook = hook

        def hook(rec, carry):
            extra_hook(rec)
            return save_hook(rec, carry)

    res = integrate(
        stepper, fvec, t0, t1, u0vec,
        rtol=rtol, atol=atol, dt0=dt0, max_steps=max_steps,
        tstops=all_stops, hook=hook,
        hook_carry=save_carry0(saveat, t0, tdir, u0vec, t1 - t0),
        store_dense=store_dense, dtmax=dtmax, fixed_dt=fixed_dt,
        fixed_trip=fixed_trip, event_set=event_set,
        stop_offsets=stop_offsets, always_accept=always_accept,
        norms=norms,
    )
    ys_save = saved_rows(res.hook_carry, res.u_final)
    return ForwardResult(ys_save=ys_save, dense=res.dense,
                         t_final=res.t_final, u_final=res.u_final,
                         stats=res.stats, events=res.events,
                         event_log=res.event_log)


def reverse_joined_solve(
    stepper,
    aug_rhs: Callable,
    times,
    lam_jumps: torch.Tensor,
    z_init: torch.Tensor,
    n_lam: int,
    *,
    rtol,
    atol,
    max_steps: int,
    dt0=None,
    hook: Optional[Callable] = None,
    hook_carry: Any = None,
    snap_values: Optional[torch.Tensor] = None,
    snap_start: Optional[int] = None,
    on_snap: Optional[Callable] = None,
    err_weights=None,
    t_span=None,
    collect_dense: bool = False,
    event_times=None,
    event_count: int = 0,
    event_apply: Optional[Callable] = None,
    event_unroll: int = 3,
    fixed_trip: bool = False,
    norms=LOCAL_NORMS,
) -> Tuple[torch.Tensor, Any, Stats, Optional[DenseOutput]]:
    """ONE adaptive reverse solve over [t_hi -> t_lo], adding the loss
    cotangents `lam_jumps[k]` into z[:n_lam] exactly when the integrator lands
    on times[k] (the ReverseLossCallback jumps, applied through the integrator's
    stop transform, so the controller is set up once, not per segment).

    times: ascending host times, shape (m,); lam_jumps (m, n_lam).
    snap_values (m, s) with snap_start: overwrite z[snap_start:] with
    snap_values[j] at times[j] (Backsolve's checkpoint snap);
    `on_snap(z[snap_start:], snap_values[j])` sees each segment's end state
    just before it is overwritten (Backsolve's drift guard).
    hook: `(step_record, carry) -> carry` on every accepted reverse step,
    before the jumps at its end fire (GaussAdjoint's quadrature), with
    step_record = (t_old, t_new, z0, f0, z1, f1) as in `integrate`.
    Every row that coincides with a stop fires there; the JAX function
    unrolls a fixed three checks (`jump_unroll`), which covers every stop
    `times` can hold.

    collect_dense: keep the reverse solve's dense output over z (every
    accepted step, and a zero-width row with the post-jump state at each
    stop where a jump fired), as QuadratureAdjoint's λ interpolant.

    event_times (host, ascending, the first min(event_count, max_events)
    recorded times), event_apply(i, t, z, hc) -> (z, hc): the reverse
    transform of recorded event i, applied when the reverse lands on its
    time, after the loss jumps there and last-recorded first, at most
    `event_unroll` per stop (JAX: max(3, callbacks)). Events at or above
    t_hi fire before the reverse starts (an event at t1, or the terminal
    event at a dynamic t_final).

    dt0: the reverse's first step (the DAE rules pass the forward's dt0:
    the automatic one assumes u' = f).

    fixed_trip: the masked scan's budget of max_steps + m + 4 attempts
    (`integrate(fixed_trip=True)`), JAX's unrolled reverse (`unroll_scan`).

    norms: `integrate`'s error norms' reductions.

    Returns (z at t_lo after all jumps, the hook's carry, reverse Stats,
    the dense output or None). The JAX function returns the retcode where
    this returns the Stats that hold it (the eager integrator counts the
    reverse steps for free).
    """
    kind = time_dtype(z_init.dtype)
    times = np.asarray(times, dtype=kind)
    m = times.shape[0]
    if t_span is None:
        t_lo, t_hi = times[0], times[-1]
    else:
        t_lo, t_hi = kind(t_span[0]), kind(t_span[1])
    span = kind(t_hi - t_lo)

    def add_row(z, k):
        z[:n_lam] += lam_jumps[k]
        if snap_values is not None:
            if on_snap is not None:
                on_snap(z[snap_start:], snap_values[k])
            z[snap_start:] = snap_values[k]

    # every jump row at or above t_hi fires now (the t1 row and a save
    # time that coincides with it)
    z0 = z_init.clone()
    k0 = m - 1
    tol0 = match_tol(kind, span, t_hi)
    while k0 >= 0 and times[k0] >= kind(t_hi - tol0):
        add_row(z0, k0)
        k0 -= 1

    have_events = event_apply is not None and event_count > 0
    ev_t = (np.asarray(event_times, dtype=kind)[:event_count] if have_events
            else np.zeros(0, dtype=kind))
    ke0 = ev_t.shape[0] - 1
    while ke0 >= 0 and ev_t[ke0] >= kind(t_hi - tol0):
        z0, hook_carry = event_apply(ke0, t_hi, z0, hook_carry)
        ke0 -= 1

    def stop_transform(t, z, carry):
        # every row that coincides with this stop fires (a save time that
        # duplicates the t0 extension gives two), then the events there
        hc, k, ke = carry
        tol = match_tol(kind, span, t, t_hi)
        k_start, ke_start = k, ke
        while k >= 0 and abs(kind(times[k] - t)) <= tol:
            if k == k_start:
                z = z.clone()
            add_row(z, k)
            k -= 1
        for _ in range(event_unroll):
            if ke >= 0 and abs(kind(ev_t[ke] - t)) <= tol:
                z, hc = event_apply(ke, t, z, hc)
                ke -= 1
        return z, (hc, k, ke), k != k_start or ke != ke_start

    wrapped_hook = None
    if hook is not None:
        wrapped_hook = lambda rec, carry: (hook(rec, carry[0]), *carry[1:])

    all_stops = times if not have_events else np.sort(
        np.concatenate([times, ev_t]))
    res = integrate(
        stepper, aug_rhs, t_hi, t_lo, z0,
        rtol=rtol, atol=atol, dt0=dt0, max_steps=max_steps + m + 4,
        tstops=all_stops,
        hook=wrapped_hook, hook_carry=(hook_carry, k0, ke0),
        stop_transform=stop_transform, store_dense=collect_dense,
        err_weights=err_weights, fixed_trip=fixed_trip, norms=norms,
    )
    return res.u_final, res.hook_carry[0], res.stats, res.dense


def reverse_pinned_solve(
    stepper,
    make_interval_rhs: Callable,
    dense: DenseOutput,
    times,
    lam_jumps: torch.Tensor,
    z_init: torch.Tensor,
    n_lam: int,
    *,
    rtol,
    atol,
    hook: Optional[Callable] = None,
    hook_carry: Any = None,
    err_weights: Optional[torch.Tensor] = None,
    jump_unroll: int = 3,
    norms=LOCAL_NORMS,
) -> Tuple[torch.Tensor, Any, Stats]:
    """Reverse solve PINNED to the forward's accepted grid: one `stepper`
    step per stored forward interval, walking the dense buffer backwards by
    index, with no controller and no interval search.

    make_interval_rhs(i) -> rhs(z, t): the reverse field over interval i,
    with y from that interval's directly indexed Hermite rows. The loss
    cotangents `lam_jumps[k]` are added into z[:n_lam] when the walk
    reaches a node matching times[k], with the matcher and tolerance of
    `reverse_joined_solve`, at most `jump_unroll` rows per node (JAX's
    default 3, 4 with dense-node cotangents, whose node rows join the save
    rows); the FSAL derivative is evaluated again
    after a jump. Rows no wider than the matching tolerance are zero-width:
    they step nowhere and add nothing (neither step nor hook runs there;
    JAX steps and masks the result).

    The weighted embedded error is computed on every step and kept on the
    device; the largest is read once at the end, and above 100 (JAX's
    `guard`, in units of the tolerance) the retcode is 2 (DtMin), which
    poisons the gradient (a NaN error compares false, as in JAX).
    hook(rec, carry): once per interval, rec = (ta, tb, z_a, f_a, z_b, f_b,
    i), ta > tb walking backwards. norms: the error norm's reductions.

    Returns (z at t0 after all jumps, the hook's carry, Stats with one
    accepted step per interval stepped)."""
    dtype = z_init.dtype
    kind = time_dtype(dtype)
    times = np.asarray(times, dtype=kind)
    ts, n_steps = dense.ts, dense.n_steps
    t_hi = ts[n_steps]
    span = kind(t_hi - ts[0])
    n_weighted = None
    if err_weights is not None:
        n_weighted = weight_count(err_weights, norms)

    # every jump row at or above t_hi fires now
    z = z_init.clone()
    k = times.shape[0] - 1
    tol0 = match_tol(kind, span, t_hi)
    while k >= 0 and times[k] >= kind(t_hi - tol0):
        z[:n_lam] += lam_jumps[k]
        k -= 1

    f = make_interval_rhs(max(n_steps - 1, 0))(z, t_hi).to(dtype)
    worst = None
    n_stepped, n_fevals = 0, 1
    for i in range(n_steps - 1, -1, -1):
        ta, tb = ts[i + 1], ts[i]
        dt = kind(tb - ta)  # the forward step width, negated
        rhs = make_interval_rhs(i)
        z1, f1 = z, f
        if abs(dt) > match_tol(kind, span, ta):
            z1, f1, err = stepper.step(rhs, ta, dt, z, f)
            z1, f1 = z1.to(dtype), f1.to(dtype)
            n_stepped += 1
            n_fevals += stepper.n_stages
            if err is not None:
                e = error_norm(err, z, z1, rtol, atol, err_weights,
                               n_weighted, norms)
                worst = e if worst is None else torch.maximum(worst, e)
            if hook is not None:
                hook_carry = hook((ta, tb, z, f, z1, f1, i), hook_carry)
        tol = match_tol(kind, span, tb, t_hi)
        fired = False
        for _ in range(jump_unroll):
            if k >= 0 and abs(kind(times[k] - tb)) <= tol:
                if not fired:
                    z1 = z1.clone()
                z1[:n_lam] += lam_jumps[k]
                k -= 1
                fired = True
        if fired:
            f1 = rhs(z1, tb).to(dtype)
            n_fevals += 1
        z, f = z1, f1
    # jump rows below the final node (t0 duplicates)
    if k >= 0:
        z = z.clone()
    while k >= 0:
        z[:n_lam] += lam_jumps[k]
        k -= 1
    retcode = 2 if worst is not None and worst.item() > 100.0 else 0
    stats = Stats(n_accepted=n_stepped, n_rejected=0, n_fevals=n_fevals,
                  retcode=retcode)
    return z, hook_carry, stats


def augmented_fvec(kern, p, n: int, seeds_p: torch.Tensor):
    """Tangent field over z = [u; S.flatten()], S of shape (k, n): row j of S
    moves as Ṡⱼ = ∂f/∂u·Sⱼ + ∂f/∂p·seeds_p[j], one `kern.jvp` per row,
    vmapped over the rows (JAX `adjoints/forward.py:_augmented_fvec`, which
    takes the row counts and builds the seeds). seeds_p: (k, npf), the
    parameter direction of each row (zeros for a u0-direction).

    The first evaluation also takes one row's jvp outside vmap: a kernel
    Function then raises its own forward-mode refusal
    (`ops.vjp.ForwardModeUnsupported`), where under vmap torch's complaint
    about the Function's missing vmap rule would come first."""
    _, unravel_p = ravel_pytree(p)
    k = seeds_p.shape[0]
    probed = []

    def aug(z, t):
        u = z[:n]

        def row(sj, ej):
            return kern.jvp(u, p, t, sj, None if p is None else unravel_p(ej))[1]

        S = z[n:].reshape(k, n)
        if k and not probed:
            row(S[0], seeds_p[0])
            probed.append(True)
        dS = torch.func.vmap(row)(S, seeds_p) if k else S
        return torch.cat([kern.fvec(u, p, t), dS.reshape(-1)])

    return aug


def match_cotangents(du0, dp, primals):
    """Cotangents take the dtypes of their primals: a real primal takes the
    real part of a complex cotangent (a complex state with real p), as JAX
    does."""
    u0_p, p_p = primals

    def cast(c, x):
        if c.is_complex() and not x.is_complex():
            c = c.real
        return c.to(x.dtype)

    return (_map2(cast, du0, u0_p),
            None if p_p is None else _map2(cast, dp, p_p))


def _map2(fn, a, b):
    if isinstance(a, dict):
        return {key: _map2(fn, a[key], b[key]) for key in a}
    if isinstance(a, (list, tuple)):
        return type(a)(_map2(fn, x, y) for x, y in zip(a, b))
    return fn(a, b)
