"""Per-step event detection and application (PyTorch port).

Counterpart of `scimlsensitivity_jl_tpu/solvers/events.py`:
`init_event_buffers` and `process_step_events`, with the same arithmetic.
Continuous conditions are sampled at 9 points of the accepted step's
cubic-Hermite interpolant; the first sign change of each (subject to its
direction, and to the refractory guard at θ = 0: no crossing out of a
sample within √eps · max|g| of zero) is bisected 40 times and polished by
2 Newton steps through a `torch.func.jvp` of g(θ), then clipped to [0, 1].
Every condition crossing within √eps of the earliest θ is applied in
callback order, each recorded with its own pre-affect state; without a
crossing, the discrete conditions are checked at the step end.

The samples, the bisection and the Newton steps run on the device: one
batched Hermite evaluation of the 9 samples, `torch.where` on the bracket
(one evaluation of g per round: g at the bracket's low end is kept from
the round that set it), one host read for "crossed?" per accepted step
and one for θ per crossing step. The Newton steps and the interpolant never call the field,
so forward mode never reaches a kernel.

Differentiable mode (DirectAdjoint, autograd through the step loop): the
JAX package keeps θ, and with it the event time, differentiable through
the Newton steps. The port's times are host scalars, so `t_off` and
`dt_off` bring the derivatives of the step's start and length as
zero-valued tensors, and the event time's comes back as `t_e_off`
(value 0): the derivative reaches the pre-event state through the
interpolant, the affect through u⁻, and later steps through the integrator's
clipped step lengths. The field and the affects get the event time as a
0-d tensor with that derivative, as JAX's traced time carries it.
"""

from __future__ import annotations

from typing import Any, List, NamedTuple, Optional

import numpy as np
import torch

from ..ops.interp import hermite_at
from .integrate import kind_torch_dtype

__all__ = ["EventRecord", "StepEvents", "init_event_buffers",
           "finish_record", "process_step_events"]


class EventRecord(NamedTuple):
    """The forward's event log, JAX's fixed-size buffers: ts (max_events,)
    event times padded with t1 (a CPU tensor of the time dtype), u_pre
    (max_events, n) pre-affect states, idx (max_events,) the callback that
    fired (continuous ones first, then discrete; -1 pads), count: firings,
    which may exceed max_events (retcode 4)."""

    ts: torch.Tensor
    u_pre: torch.Tensor
    idx: torch.Tensor
    count: int


class StepEvents(NamedTuple):
    """What fired on one accepted step: the truncation target (t_e, u_pre,
    f_pre), the post-affect continuation (u_post, f_post), the callbacks
    fired in order, theta (None for discrete firings), whether a terminal
    one fired, and t_e_off (differentiable mode, else None)."""

    t_e: Any
    u_pre: torch.Tensor
    f_pre: torch.Tensor
    u_post: torch.Tensor
    f_post: torch.Tensor
    fired: List[int]
    u_pres: List[torch.Tensor]
    theta: Any
    terminated: bool
    t_e_off: Optional[torch.Tensor] = None
    cause: Optional[int] = None  # the condition whose θ is the earliest


def init_event_buffers(event_set, t1, n, dtype, kind, device):
    """Host lists for the record: ts, the pre-affect rows, idx and the
    count; `finish_record` turns them into an EventRecord."""
    me = event_set.max_events
    return {"ts": [kind(t1)] * me, "u_pre": [None] * me, "idx": [-1] * me,
            "count": 0, "n": n, "dtype": dtype, "device": device,
            "kind": kind}


def finish_record(buf) -> EventRecord:
    zero = torch.zeros(buf["n"], dtype=buf["dtype"], device=buf["device"])
    rows = [zero if r is None else r for r in buf["u_pre"]]
    u_pre = (torch.stack(rows) if rows else
             torch.zeros(0, buf["n"], dtype=buf["dtype"],
                         device=buf["device"]))
    return EventRecord(
        ts=torch.from_numpy(np.asarray(buf["ts"], dtype=buf["kind"])),
        u_pre=u_pre, idx=torch.tensor(buf["idx"], dtype=torch.int32),
        count=buf["count"])


def process_step_events(event_set, fvec, t_a, dt_eff, u_a, f_a, u_b, f_b,
                        record, *, t_off=None, dt_off=None):
    """Detect and apply the events of the accepted step [t_a, t_a + dt_eff]
    (host times of the time dtype) and record them in `record`. Returns a
    StepEvents, or None when nothing fired."""
    kind = type(t_a)
    t_b = kind(t_a + dt_eff)
    k_cont, k_disc = event_set.n_cont, event_set.n_disc
    eps = kind(np.finfo(kind).eps)
    sqrt_eps = kind(np.sqrt(eps))
    sd = u_a.dtype
    tdt = kind_torch_dtype(kind)
    dev = u_a.device
    fires: List[int] = []
    u_pres: List[torch.Tensor] = []
    theta_host = None
    t_e_off = None
    i_min = None

    if k_cont:
        ta_t = torch.tensor(t_a, dtype=tdt, device=dev)
        dt_t = torch.tensor(dt_eff, dtype=tdt, device=dev)
        if t_off is not None:
            ta_t = ta_t + t_off
        if dt_off is not None:
            dt_t = dt_t + dt_off
        tb_t = ta_t + dt_t
        herm = lambda tt: hermite_at(tt, ta_t, tb_t, u_a, f_a, u_b, f_b)
        th_grid = torch.arange(9, dtype=tdt, device=dev) / 8.0
        tt_grid = ta_t + th_grid * dt_t
        # one batched call: conditions are pure tensor functions, as JAX
        # needs them traceable
        g_smp = torch.func.vmap(event_set.cond)(herm(tt_grid), tt_grid)
        g_smp = g_smp.reshape(9, k_cont)
        gl, gr = g_smp[:-1], g_smp[1:]
        pair = (gl * gr < 0) | ((gr == 0) & (gl != 0))
        g_scale = torch.amax(g_smp.abs(), dim=0)
        tol_g = float(sqrt_eps) * (g_scale + 1e-300)
        pair[0] = pair[0] & (g_smp[0].abs() > tol_g)
        if event_set.directions is not None:
            dirs = torch.tensor(event_set.directions, device=dev)[None, :]
            pair = pair & ((dirs == 0) | ((dirs == -1) & (gl > 0))
                           | ((dirs == 1) & (gl < 0)))
        crossed_t = pair.any(dim=0)
        first = torch.argmax(pair.to(torch.int8), dim=0)
        # the one read per accepted step: which conditions crossed, where
        packed = torch.stack([crossed_t.to(torch.int64), first]).tolist()
        crossed = [bool(c) for c in packed[0]]

        if any(crossed):
            def locate(i, m):
                def gtheta(th):
                    tt = ta_t + th * dt_t
                    return event_set.cond(herm(tt), tt)[i]

                lo, hi = th_grid[m], th_grid[m + 1]
                g_lo = gtheta(lo)
                for _ in range(40):
                    # JAX evaluates g(lo) afresh each round; it is g at
                    # the last mid that moved lo, or at the first lo
                    mid = 0.5 * (lo + hi)
                    g_mid = gtheta(mid)
                    same = g_mid * g_lo >= 0
                    lo, hi = torch.where(same, mid, lo), torch.where(
                        same, hi, mid)
                    g_lo = torch.where(same, g_mid, g_lo)
                th = 0.5 * (lo + hi)
                for _ in range(2):  # Newton polish keeps τ differentiable
                    g_v, dg = torch.func.jvp(gtheta, (th,),
                                             (torch.ones_like(th),))
                    safe = dg.abs() > 1e-30
                    th = th - torch.where(safe, g_v / torch.where(
                        safe, dg, torch.ones_like(dg)), torch.zeros_like(g_v))
                return torch.clamp(th, 0.0, 1.0)

            th_t = {i: locate(i, packed[1][i]) for i in range(k_cont)
                    if crossed[i]}
            keys = sorted(th_t)
            vals = [kind(v) for v in torch.stack(
                [th_t[i] for i in keys]).tolist()]  # the θ read
            thetas = dict(zip(keys, vals))
            i_min = min(keys, key=lambda i: (thetas[i], i))
            theta_host = thetas[i_min]
            t_e = kind(t_a + kind(theta_host * dt_eff))
            te_t = ta_t + th_t[i_min] * dt_t
            if te_t.requires_grad:
                t_e_off = te_t - te_t.detach()
            u_pre0 = herm(te_t).to(sd)
            # the field and the affects see the event time's derivative
            te_arg = t_e if t_e_off is None else t_e_off + float(t_e)
            f_pre0 = fvec(u_pre0, te_arg).to(sd)
            state = u_pre0
            for j in range(k_cont):
                if crossed[j] and thetas[j] <= kind(theta_host + sqrt_eps):
                    u_pres.append(state)
                    fires.append(j)
                    state = event_set.affect(state, te_arg, j)
            state = state.to(sd)
            u_post, f_post = state, fvec(state, te_arg).to(sd)

    if not fires and k_disc:
        t_e = t_b
        tb_arg = t_b
        if t_off is not None or dt_off is not None:
            tb_off = [o for o in (t_off, dt_off) if o is not None]
            tb_arg = sum(tb_off[1:], tb_off[0]) + float(t_b)
        dc = event_set.disc_cond(u_b, t_b)
        if any(isinstance(v, torch.Tensor) for v in dc):
            dc = torch.stack([torch.as_tensor(v, device=dev)
                              for v in dc]).tolist()
        state = u_b
        for jd in range(k_disc):
            if bool(dc[jd]):
                j = k_cont + jd
                u_pres.append(state)
                fires.append(j)
                state = event_set.affect(state, tb_arg, j)
        if fires:
            u_pre0, f_pre0 = u_b, f_b
            state = state.to(sd)
            u_post, f_post = state, fvec(state, tb_arg).to(sd)

    if not fires:
        return None

    me = event_set.max_events
    for j, u_pre_j in zip(fires, u_pres):
        slot = min(record["count"], me - 1)
        record["ts"][slot] = t_e
        record["u_pre"][slot] = u_pre_j.detach()
        record["idx"][slot] = j
        record["count"] += 1

    terminated = (event_set.terminals is not None
                  and any(event_set.terminals[j] for j in fires))
    return StepEvents(t_e=t_e, u_pre=u_pre0, f_pre=f_pre0, u_post=u_post,
                      f_post=f_post, fired=fires, u_pres=u_pres,
                      theta=theta_host, terminated=terminated,
                      t_e_off=t_e_off, cause=i_min)
