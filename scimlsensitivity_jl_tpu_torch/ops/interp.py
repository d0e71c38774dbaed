"""Dense output: cubic-Hermite interpolation over accepted steps (PyTorch
port).

Counterpart of `scimlsensitivity_jl_tpu/ops/interp.py:hermite_eval` and
`:dense_eval`. The JAX package keeps node times on the device and locates
an interval with a masked sum; here node times live on the host (the eager
integrator knows them), so locating an interval reads nothing from the device.
Where a node time carries a derivative (DirectAdjoint through a save or
event time, ForwardDiffSensitivity through an event time), `ts_off` holds
it as a zero-valued tensor, and the interval is evaluated in tensor
arithmetic (`hermite_at`), with the same values.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

__all__ = ["DenseOutput", "hermite_eval", "hermite_at", "dense_eval"]


class DenseOutput(NamedTuple):
    """Piecewise cubic-Hermite interpolant over accepted solver steps.

    ts: (n_steps+1,) numpy node times in the time dtype.
    ys: (n_steps+1, n) states at the nodes (flat).
    fs: (n_steps+1, n) du/dt at the nodes.
    n_steps: number of accepted steps.
    tdir: +1 / -1 integration direction (time dtype).
    ts_off: None, or per node None or a zero-valued tensor carrying the
        node time's derivative (DirectAdjoint, ForwardDiffSensitivity).
    """

    ts: np.ndarray
    ys: torch.Tensor
    fs: torch.Tensor
    n_steps: int
    tdir: np.floating
    ts_off: Any = None


def hermite_eval(t, t0, t1, y0, f0, y1, f1):
    """Cubic Hermite value at host time t on the step [t0, t1] (guards
    h -> 0). Times are numpy scalars of one dtype; y*, f* are tensors."""
    kind = type(t0)
    h = kind(t1 - t0)
    if h == 0:
        return y0
    theta = kind(kind(t - t0) / h)
    one, two = kind(1.0), kind(2.0)
    w = float(theta * (theta - one))
    dy = y1 - y0
    inner = (dy * float(one - two * theta) + f0 * float((theta - one) * h)
             + f1 * float(theta * h))
    return y0 * float(one - theta) + y1 * float(theta) + inner * w


def hermite_at(tt, ta, tb, y0, f0, y1, f1):
    """Cubic Hermite on the step [ta, tb] at device times `tt` (a 0-dim
    tensor, or (m,) for m rows), in the operation order of JAX's
    `hermite_eval`; ta and tb are 0-dim tensors of the time dtype, and the
    step has nonzero width."""
    h = tb - ta
    theta = (tt - ta) / h
    if tt.dim():
        theta = theta[:, None]
    w = theta * (theta - 1.0)
    dy = y1 - y0
    inner = (dy * (1.0 - 2.0 * theta) + f0 * ((theta - 1.0) * h)
             + f1 * (theta * h))
    return y0 * (1.0 - theta) + y1 * theta + inner * w


def _locate(dense: DenseOutput, t) -> int:
    """Index i of the step interval holding t, clipped to valid steps."""
    keys = dense.ts * dense.tdir
    i = int(np.sum(keys <= t * dense.tdir)) - 1
    return min(max(i, 0), max(dense.n_steps - 1, 0))


def dense_eval(dense: DenseOutput, t):
    """Evaluate the interpolant at scalar time t -> flat state vector. A
    0-d tensor t (a time with a derivative, e.g. a stiff stepper's ∂f/∂t
    through the reverse field) is located by its value and evaluated in
    tensor arithmetic, so the derivative flows through u(t)."""
    kind = type(dense.ts[0])
    t_arg = t if isinstance(t, torch.Tensor) else None
    t = kind(float(t))
    if dense.n_steps == 0:
        return dense.ys[0]
    i = _locate(dense, t)
    rows = (dense.ys[i], dense.fs[i], dense.ys[i + 1], dense.fs[i + 1])
    off = dense.ts_off
    off_a = None if off is None else off[i]
    off_b = None if off is None else off[i + 1]
    if t_arg is not None or off_a is not None or off_b is not None:
        ta, tb = dense.ts[i], dense.ts[i + 1]
        if ta != tb:
            tdt = torch.float64 if type(ta) is np.float64 else torch.float32
            new = lambda v: torch.tensor(v, dtype=tdt, device=rows[0].device)
            ta_t = new(ta) if off_a is None else new(ta) + off_a
            tb_t = new(tb) if off_b is None else new(tb) + off_b
            tt = new(t) if t_arg is None else t_arg.to(tdt)
            return hermite_at(tt, ta_t, tb_t, rows[0], rows[1], rows[2],
                              rows[3])
    return hermite_eval(t, dense.ts[i], dense.ts[i + 1], *rows)
