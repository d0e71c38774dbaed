"""Adaptive and fixed-grid time stepping (PyTorch port).

Counterpart of `scimlsensitivity_jl_tpu/solvers/integrate.py`:
`hairer_norm`, `initial_step_size` and `integrate` (integrate.py:118-300),
the PI-controlled adaptive loop with its `fixed_dt=` march, tstops landed
exactly, a per-accepted-step hook and a stop transform. `fixed_trip=True`
gives it the budget of the masked `integrate_scan` (:498), the loop that
DirectAdjoint differentiates; the scan itself is not needed, since autograd
records the eager loop. Events and the unrolled integrators are not ported
(ROADMAP M8).

The JAX `lax.while_loop` becomes an eager Python loop. Time, step size and
controller state stay on the host as numpy scalars of the time dtype, so
they round exactly as the JAX package's device scalars do, and the state
stays on the device. The fixed-grid march therefore reads nothing back
from the device. The adaptive loop reads one number per step, the
weighted error norm, in `_error_norm`: the only place a later CUDA-graph
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
    "hairer_norm",
    "initial_step_size",
    "time_dtype",
    "state_kind",
    "kind_torch_dtype",
    "bfloat16_scalar",
    "RETCODE_SUCCESS",
    "RETCODE_MAXITERS",
    "RETCODE_DTMIN",
    "RETCODE_TERMINATED",
]

RETCODE_SUCCESS = 0
RETCODE_MAXITERS = 1
RETCODE_DTMIN = 2
# 3 (DDE lag violations) and 4 (event record overflow) wait for ROADMAP M8,
# M13; 6: BacksolveAdjoint reconstruction drift (adjoints/continuous.py).
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


def time_dtype(dtype: torch.dtype):
    """numpy scalar type of the time and controller variables of a solve
    whose state has `dtype`: promote(real(dtype), float32), as the JAX
    integrator keeps it (integrate.py:180). A bfloat16 or float16 state
    keeps float32 time, and its stage arithmetic runs promoted."""
    if dtype in (torch.float16, torch.bfloat16, torch.float32):
        return np.float32
    if dtype == torch.float64:
        return np.float64
    raise NotImplementedError(
        f"state dtype {dtype}: the port solves real floating-point states")


def state_kind(dtype: torch.dtype):
    """Host scalar type of the state dtype itself: the fixed-grid discrete
    path keeps dt and the grid times in it (JAX adjoints/direct.py:44-48)."""
    if dtype not in _STATE_KIND:
        raise NotImplementedError(
            f"state dtype {dtype}: the port solves real floating-point states")
    return _STATE_KIND[dtype]


def kind_torch_dtype(kind) -> torch.dtype:
    """The torch dtype of a host scalar type (numpy float or bfloat16)."""
    return _KIND_TORCH[kind]


def hairer_norm(x: torch.Tensor) -> torch.Tensor:
    """RMS norm of the Hairer-Wanner error controller (a device scalar)."""
    return torch.sqrt(torch.mean(x.abs() ** 2))


def initial_step_size(fvec, t0, u0, f0, order, rtol, atol, tdir):
    """Hairer-Norsett-Wanner automatic initial dt (Solving ODEs I, II.4).
    Scalars are host values of the time dtype; reads three norms. A
    state below float32 is promoted to the time dtype, as JAX promotes it
    against its float32 rtol."""
    kind = type(t0)
    wide = torch.promote_types(u0.dtype, kind_torch_dtype(kind))
    u0, f0 = u0.to(wide), f0.to(wide)
    sc = u0.abs() * float(rtol) + float(atol)
    d0, d1 = (kind(v) for v in torch.stack(
        [hairer_norm(u0 / sc), hairer_norm(f0 / sc)]).tolist())
    small = kind(1e-6)
    if d0 < kind(1e-5) or d1 < kind(1e-5):
        h0 = small
    else:
        h0 = kind(kind(kind(0.01) * d0) / d1)
    step = kind(tdir * h0)
    f1 = fvec(u0 + f0 * float(step), kind(t0 + step))
    d2 = kind(kind(hairer_norm((f1 - f0) / sc).item()) / h0)
    dmax = max(d1, d2)
    if dmax <= kind(1e-15):
        h1 = max(small, kind(h0 * kind(1e-3)))
    else:
        h1 = kind(kind(kind(0.01) / dmax) ** kind(1.0 / (order + 1.0)))
    return kind(tdir * min(kind(kind(100.0) * h0), h1))


def _next_stop(t, t1, tstops, tdir):
    """Nearest upcoming stop strictly ahead of t (including t1)."""
    if tstops is None or tstops.shape[0] == 0:
        return t1
    kind = type(t)
    key = tstops * tdir
    ahead = key > kind(t * tdir) + kind(kind(1e-12) * max(kind(1.0), abs(t)))
    before_end = key < kind(t1 * tdir)
    candidates = key[ahead & before_end]
    if candidates.size == 0:
        return t1
    return kind(candidates.min() * tdir)


def _error_norm(err, u, u1, rtol, atol, err_weights, weight_count) -> float:
    """The adaptive integrator's one device->host read per step: the RMS of the
    error scaled by atol + rtol·max(|u|, |u1|), over the weighted components
    only when `err_weights` is given (weight-0 rows, pure quadrature
    accumulators, must not dilute the mean)."""
    sc = (torch.maximum(u.abs(), u1.abs()).to(err.dtype) * float(rtol)
          + float(atol))
    if err_weights is None:
        return hairer_norm(err / sc).item()
    scaled = (err_weights * (err / sc)).abs() ** 2
    return torch.sqrt(torch.sum(scaled) / weight_count).item()


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
) -> IntegrateResult:
    """Integrate du/dt = fvec(u, t) from t0 to t1 (t1 < t0 allowed).

    fixed_dt: march the grid t0 + k·fixed_dt instead of adapting: every
        step is accepted, the controller is bypassed and no error is
        computed, steps still clip to tstops exactly. Instability shows as
        NaN states, which the adjoint rules turn into NaN gradients.
    fvec: (uvec, t) -> duvec over flat state vectors; t is a host scalar.
    stepper: `.order` and `.step(fvec, t, dt, u, f0, need_err)`.
    hook: `(step_record, carry) -> carry` on accepted steps, with
        step_record = (t_old, t_new, y0, f0, y1, f1).
    stop_transform: `(t, u, carry) -> (u', carry', fired)` when an accepted
        step lands exactly on a stop (the PresetTimeCallback analogue). When
        it fires, f is evaluated again at u' and a zero-width dense row
        holds the post-jump state.
    fixed_trip: the budget of JAX's `integrate_scan` (integrate.py:774-800):
        max_steps attempts, rejected ones included, then MaxIters; no DtMin
        check (a vanishing step runs the budget out); n_fevals reports
        max_steps·stages, the scan's fixed trip count.
    """
    dtype = u0.dtype
    kind = time_dtype(dtype)
    t0, t1 = kind(t0), kind(t1)
    tdir = kind(1.0) if t1 >= t0 else kind(-1.0)
    order = stepper.order
    rtol, atol = kind(rtol), kind(atol)
    if tstops is not None:
        tstops = np.asarray(tstops, dtype=kind)
    eps = kind(np.finfo(kind).eps)
    weight_count = None
    if err_weights is not None:
        weight_count = max(int((err_weights > 0).sum().item()), 1)

    f0 = fvec(u0, t0).to(dtype)
    if fixed_dt is not None:
        dt = kind(tdir * abs(kind(fixed_dt)))
    elif dt0 is None:
        dt = initial_step_size(fvec, t0, u0, f0, order, rtol, atol, tdir)
    else:
        dt = kind(tdir * abs(kind(dt0)))

    beta1 = kind(_PI[0] / (order + 1.0))
    beta2 = kind(_PI[1] / (order + 1.0))
    safety, factor_min, factor_max = (kind(_SAFETY), kind(_FACTOR_MIN),
                                      kind(_FACTOR_MAX))

    t, u, f = t0, u0, f0
    err_prev = kind(1.0)
    n_acc = n_rej = n_iter = 0
    status = -1
    rows_t, rows_y, rows_f = [t0], [u0], [f0]

    while status < 0:
        stop = _next_stop(t, t1, tstops, tdir)
        remaining = kind(stop - t)
        clipped = abs(dt) >= abs(remaining)
        dt_eff = remaining if clipped else dt

        u1, f1, err = stepper.step(fvec, t, dt_eff, u, f,
                                   need_err=fixed_dt is None)
        u1, f1 = u1.to(dtype), f1.to(dtype)

        if fixed_dt is None:
            err_norm = kind(_error_norm(err, u, u1, rtol, atol, err_weights,
                                        weight_count))
            bad = not np.isfinite(err_norm)
            if bad:
                err_norm = kind(2.0)
            accept = bool(err_norm <= kind(1.0)) and not bad
            # PI controller on |dt| (Soderlind), from this and the last error
            err_cl = max(err_norm, kind(1e-10))
            factor = kind(kind(safety * kind(err_cl ** -beta1))
                          * kind(err_prev ** beta2))
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

        if accept:
            t_new = kind(t + dt_eff)
            u_new, f_new = u1, f1
            n_acc += 1
            if store_dense:
                rows_t.append(t_new)
                rows_y.append(u_new)
                rows_f.append(f_new)
            if hook is not None:
                hook_carry = hook((t, t_new, u, f, u_new, f_new), hook_carry)
            if stop_transform is not None and clipped:
                # evaluate f one stop-matching tolerance into the direction
                # of integration, on the far side of the jump
                t_eval = kind(t_new + kind(tdir * kind(
                    kind(kind(64.0) * eps) * max(kind(1.0), abs(t_new)))))
                u_new, hook_carry, fired = stop_transform(t_new, u_new,
                                                          hook_carry)
                if fired:
                    f_new = fvec(u_new, t_eval).to(dtype)
                    n_acc += 1
                    if store_dense:
                        rows_t.append(t_new)
                        rows_y.append(u_new)
                        rows_f.append(f_new)
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
        if done:
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
                            n_steps=len(rows_t) - 1, tdir=tdir)
    trips = max_steps if fixed_trip else n_iter
    stats = Stats(n_accepted=n_acc, n_rejected=n_rej,
                  n_fevals=trips * getattr(stepper, "n_stages", 1),
                  retcode=status)
    return IntegrateResult(dense=dense, t_final=t, u_final=u, stats=stats,
                           hook_carry=hook_carry)
