"""Shared adjoint machinery (PyTorch port).

Counterpart of `scimlsensitivity_jl_tpu/adjoints/common.py`:
`forward_saveat_solve` (:430) with `save_hook_factory` (:407),
`reverse_joined_solve` (:185) with loss-cotangent jumps, checkpoint snaps
and the per-accepted-step hook (event arguments wait for ROADMAP M8), and
`match_cotangents` (:551).

Save times, jump times and snap times are host values, so matching them
against the integrator's host clock reads nothing from the device.
"""

from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops.interp import DenseOutput
from ..solvers.integrate import Stats, integrate, time_dtype

__all__ = [
    "ForwardResult",
    "forward_saveat_solve",
    "reverse_joined_solve",
    "save_hook_factory",
    "match_cotangents",
]


class ForwardResult(NamedTuple):
    ys_save: torch.Tensor  # (nt, n) states at saveat
    dense: Optional[DenseOutput]
    t_final: np.floating
    u_final: torch.Tensor
    stats: Stats


def _match_tol(kind, *ts):
    """64 eps · max(|t|..., 1) in the time dtype: the tolerance every stop,
    save and jump matcher of the JAX package uses."""
    eps = kind(np.finfo(kind).eps)
    return kind(kind(kind(64.0) * eps) * max([kind(1.0)] + [abs(t) for t in ts]))


def save_hook_factory(saveat: np.ndarray, tdir):
    """Accepted-step hook that captures u at each save time.

    `saveat` is merged into the stops, so the integrator lands on each save time
    exactly up to roundoff; the hook records the state the first time
    t_new reaches saveat[k]. Carry: (list of rows, k)."""
    nt = saveat.shape[0]
    kind = saveat.dtype.type

    def hook(rec, carry):
        _t_old, t_new, _y0, _f0, y1, _f1 = rec
        rows, k = carry
        if k >= nt:
            return rows, k
        target = saveat[k]
        tol = _match_tol(kind, target, t_new)
        if kind(kind(t_new - target) * tdir) >= -tol:
            rows[k] = y1
            k += 1
        return rows, k

    return hook


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
) -> ForwardResult:
    """Forward solve capturing the saveat states exactly."""
    kind = time_dtype(u0vec.dtype)
    t0, t1 = kind(t0), kind(t1)
    saveat = np.asarray(saveat, dtype=kind)
    tdir = kind(1.0) if t1 >= t0 else kind(-1.0)
    nt = saveat.shape[0]

    all_stops = saveat if tstops is None else np.sort(
        np.concatenate([saveat, np.asarray(tstops, dtype=kind)]))

    # save times at/before t0 (normally just saveat[0] == t0) are captured now
    tol0 = _match_tol(kind, t0)
    rows: List[Optional[torch.Tensor]] = [None] * nt
    k0 = 0
    for i in range(nt):
        if kind(kind(saveat[i] - t0) * tdir) <= tol0:
            rows[i] = u0vec
            k0 += 1

    res = integrate(
        stepper, fvec, t0, t1, u0vec,
        rtol=rtol, atol=atol, dt0=dt0, max_steps=max_steps,
        tstops=all_stops, hook=save_hook_factory(saveat, tdir),
        hook_carry=(rows, k0), store_dense=store_dense, dtmax=dtmax,
        fixed_dt=fixed_dt,
    )
    rows, k = res.hook_carry
    # save times never reached (MaxIters/DtMin truncation) hold the final
    # state, as the dense output clamps; the retcode flags the failure
    ys_save = torch.stack([rows[i] if i < k else res.u_final
                           for i in range(nt)])
    return ForwardResult(ys_save=ys_save, dense=res.dense,
                         t_final=res.t_final, u_final=res.u_final,
                         stats=res.stats)


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
    hook: Optional[Callable] = None,
    hook_carry: Any = None,
    snap_values: Optional[torch.Tensor] = None,
    snap_start: Optional[int] = None,
    err_weights=None,
    t_span=None,
) -> Tuple[torch.Tensor, Any, Stats]:
    """ONE adaptive reverse solve over [t_hi -> t_lo], adding the loss
    cotangents `lam_jumps[k]` into z[:n_lam] exactly when the integrator lands
    on times[k] (the ReverseLossCallback jumps, applied through the integrator's
    stop transform, so the controller is set up once, not per segment).

    times: ascending host times, shape (m,); lam_jumps (m, n_lam).
    snap_values (m, s) with snap_start: overwrite z[snap_start:] with
    snap_values[j] at times[j] (Backsolve's checkpoint snap).
    hook: `(step_record, carry) -> carry` on every accepted reverse step,
    before the jumps at its end fire (GaussAdjoint's quadrature), with
    step_record = (t_old, t_new, z0, f0, z1, f1) as in `integrate`.
    Every row that coincides with a stop fires there; the JAX function
    unrolls a fixed three checks (`jump_unroll`), which covers every stop
    `times` can hold.

    Returns (z at t_lo after all jumps, the hook's carry, reverse Stats).
    The JAX function returns the retcode where this returns the Stats that
    hold it (the eager integrator counts the reverse steps for free); its
    dense collection waits for the rules that use it (ROADMAP M4).
    """
    kind = time_dtype(z_init.dtype)
    times = np.asarray(times, dtype=kind)
    m = times.shape[0]
    if t_span is None:
        t_lo, t_hi = times[0], times[-1]
    else:
        t_lo, t_hi = kind(t_span[0]), kind(t_span[1])

    def add_row(z, k):
        z[:n_lam] += lam_jumps[k]
        if snap_values is not None:
            z[snap_start:] = snap_values[k]

    # every jump row at or above t_hi fires now (the t1 row and a save
    # time that coincides with it)
    z0 = z_init.clone()
    k0 = m - 1
    tol0 = _match_tol(kind, t_hi)
    while k0 >= 0 and times[k0] >= kind(t_hi - tol0):
        add_row(z0, k0)
        k0 -= 1

    def stop_transform(t, z, carry):
        # every row that coincides with this stop fires (a save time that
        # duplicates the t0 extension gives two)
        hc, k = carry
        tol = _match_tol(kind, t, t_hi)
        k_start = k
        while k >= 0 and abs(kind(times[k] - t)) <= tol:
            if k == k_start:
                z = z.clone()
            add_row(z, k)
            k -= 1
        return z, (hc, k), k != k_start

    wrapped_hook = None
    if hook is not None:
        wrapped_hook = lambda rec, carry: (hook(rec, carry[0]), carry[1])

    res = integrate(
        stepper, aug_rhs, t_hi, t_lo, z0,
        rtol=rtol, atol=atol, max_steps=max_steps + m + 4, tstops=times,
        hook=wrapped_hook, hook_carry=(hook_carry, k0),
        stop_transform=stop_transform, store_dense=False,
        err_weights=err_weights,
    )
    return res.u_final, res.hook_carry[0], res.stats


def match_cotangents(du0, dp, primals):
    """Cotangents take the dtypes of their primals."""
    u0_p, p_p = primals
    cast = lambda c, x: c.to(x.dtype)
    return (_map2(cast, du0, u0_p),
            None if p_p is None else _map2(cast, dp, p_p))


def _map2(fn, a, b):
    if isinstance(a, dict):
        return {key: _map2(fn, a[key], b[key]) for key in a}
    if isinstance(a, (list, tuple)):
        return type(a)(_map2(fn, x, y) for x, y in zip(a, b))
    return fn(a, b)
