"""Delay differential equations by the method of steps (PyTorch port).

Counterpart of `scimlsensitivity_jl_tpu/adjoints/dde.py`: `solve_dde`, the
fixed grid (:302-558: explicit RK4, or TRBDF2 for stiff DDEs), and
`solve_dde_adaptive`, the PI-controlled constrained method of steps
(:43-300: Tsit5, Dopri5, BS3 or an ESDIRK stepper). A delayed state is a
cubic-Hermite read of the node buffers (u, u̇) written so far
(`ops.interp.hermite_eval`), and the history callable below t0.
Gradients are autograd through the loop, as JAX's are plain AD through its
scan: the exact discrete adjoint of the scheme.

The JAX scans become eager loops over Python lists of node rows. A
constant lag's delayed time is a host value, so its interval is found on
the host and its read costs no device round trip. A state-dependent lag
(a callable) gives a device time: the fixed grid finds its interval by
index arithmetic on the device, the adaptive path by a masked sum over
the node times, both over the nodes stacked once per step, and the lag
check (dt ≤ lag ≤ max_lag on the fixed grid, lag ≥ dt adaptively)
accumulates on the device, read once per solve for the retcode: a
violation poisons the outputs with NaN and gives retcode 3
(DDELagViolation), as in JAX. The adaptive loop keeps JAX's budget of
max_steps attempts (rejected ones included, then MaxIters) and reads one
error norm per attempt, as `solvers/integrate.py` does. Times are host
values of the dtype JAX keeps them in (the state's on the fixed grid, the
solver's time dtype adaptively), so they round as JAX's do; the history
callable and the fields get them as host scalars, a history queried at a
device time (a state-dependent lag) as a 0-d tensor.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.interp import DenseOutput, dense_eval, hermite_at, hermite_eval
from ..ops.vjp import probe_forward_mode
from ..problems import DDEProblem
from ..solution import ODESolution
from ..solvers.integrate import (RETCODE_MAXITERS, RETCODE_SUCCESS, Stats,
                                 error_norm, kind_torch_dtype, next_stop,
                                 state_kind, time_dtype)
from ..utils.pytree import ravel_pytree
from .interface import host_times

__all__ = ["solve_dde", "solve_dde_adaptive", "RETCODE_LAG_VIOLATION"]

# solution.RETCODE_NAMES[3]
RETCODE_LAG_VIOLATION = 3


def _history(prob, u0vec, tdt):
    """hist(t) -> flat state for t <= t0 (the constant u0 without a
    history callable); t a host time or a 0-d tensor, handed to the
    callable as a 0-d tensor of the dtype `tdt`."""
    history = prob.history

    def hist_at(t):
        if history is None:
            return u0vec
        if not isinstance(t, torch.Tensor):
            t = torch.tensor(float(t), dtype=tdt, device=u0vec.device)
        return ravel_pytree(history(t))[0].to(u0vec.dtype)

    return hist_at


def _poisoned(rows, u_final, bad):
    """NaN added to the outputs when `bad` (a host bool): added, not
    selected, so the gradient is NaN too (JAX's additive poisoning)."""
    if not bad:
        return rows, u_final
    return rows + float("nan"), u_final + float("nan")


def _lag_flag(bad, flag):
    """bad | flag, where either may be a host bool or a device bool."""
    if isinstance(flag, torch.Tensor):
        return flag | bad
    if isinstance(bad, torch.Tensor):
        return bad | flag
    return bad or flag


def _host_bool(flag) -> bool:
    """The lag check's one device read per solve."""
    return bool(flag.item()) if isinstance(flag, torch.Tensor) else bool(flag)


def solve_dde(prob: DDEProblem, solver=None, *, dt, saveat=None,
              sensealg=None) -> ODESolution:
    """The fixed-grid method of steps (JAX `solve_dde`): solver=None is
    classical RK4 (order ~4 with the Hermite delays), TRBDF2() the
    L-stable implicit TR-BDF2 for stiff DDEs (6 Newton sweeps per stage,
    each with a Jacobian by forward mode through the delayed reads; with
    lag ≥ dt the delayed states never involve the unknown stage). A lag
    need not divide dt; distributed lags (`dist_kernels`) are a trapezoid
    over the node grid. The delayed reads of a constant lag, the history
    and the saved rows are host-indexed; nothing is read back from the
    device but a state-dependent lag's check, once at the end."""
    from ..solvers.sdirk import ESDIRK

    dist_kernels = tuple(getattr(prob, "dist_kernels", ()) or ())
    if not prob.lags and not dist_kernels:
        raise ValueError("DDEProblem needs at least one lag or dist_kernel")
    t0, t1 = float(prob.tspan[0]), float(prob.tspan[1])
    dt_f = float(dt)
    const_lags = [lag for lag in prob.lags if not callable(lag)]
    has_dep = len(const_lags) < len(prob.lags)
    for lag in const_lags:
        if lag < dt_f - 1e-12:
            raise ValueError(
                f"lag {lag} < dt {dt_f}: overlapping delays make the step "
                "implicit; shrink dt below the smallest lag")
    if has_dep and prob.max_lag is None:
        raise ValueError(
            "state-dependent (callable) lags need DDEProblem.max_lag to "
            "size the pre-t0 history buffer")
    if dist_kernels and prob.max_lag is None:
        raise ValueError(
            "distributed lags (dist_kernels) need DDEProblem.max_lag — the "
            "truncation window of the ∫K(s)u(t−s)ds integral")
    max_lag = prob.max_lag if prob.max_lag is not None else max(const_lags)
    if const_lags and max_lag < max(const_lags) - 1e-12:
        # an undersized history buffer would silently clamp the read and
        # extrapolate the first Hermite interval
        raise ValueError(
            f"DDEProblem.max_lag={max_lag} is smaller than the largest "
            f"constant lag {max(const_lags)}; max_lag must bound EVERY lag")
    n_steps = max(int(round((t1 - t0) / dt_f)), 1)

    u0vec, unravel_u = ravel_pytree(prob.u0)
    dtype, dev = u0vec.dtype, u0vec.device
    kind = state_kind(dtype)
    tdt = kind_torch_dtype(kind)
    p, f_user = prob.p, prob.f
    hist_at = _history(prob, u0vec, tdt)

    def hist_dot(t):
        if prob.history is None:
            return torch.zeros_like(u0vec)
        tt = torch.tensor(float(kind(t)), dtype=tdt, device=dev)
        return torch.func.jvp(hist_at, (tt,), (torch.ones_like(tt),))[1]

    # history nodes cover [t0 - max_lag - dt, t0]
    m_hist = int(math.ceil(max_lag / dt_f + 1e-9)) + 1
    t_base = t0 - m_hist * dt_f  # the time of node 0
    pre_ts = [t_base + i * dt_f for i in range(m_hist)]
    # u' jumps at t0 (the history's slope against f(u0)): the t0 node keeps
    # two slopes, the solution side in fb[m_hist] (step 0's k1) and the
    # history side here, read when an interval ends at t0
    f_hist_t0 = hist_dot(t0)
    ub = [hist_at(t).to(dtype) for t in pre_ts] + [u0vec]
    fb = [hist_dot(t).to(dtype) for t in pre_ts] + [torch.zeros_like(u0vec)]
    n_rows = m_hist + n_steps + 1  # the JAX buffers' length

    dt_a, t_base_a, max_lag_a = kind(dt_f), kind(t_base), kind(max_lag)
    lags_a = [None if callable(lag) else kind(lag) for lag in prob.lags]

    if dist_kernels:
        # the distributed-lag trapezoid over s_j = j·dt on (0, max_lag];
        # its j = 0 term (weight dt/2) takes the stage state itself
        mq = int(round(max_lag / dt_f))
        if abs(mq * dt_f - max_lag) > 1e-9 * max(1.0, abs(max_lag)):
            raise ValueError(
                f"dist_kernels need max_lag ({max_lag}) to be an integer "
                f"multiple of dt ({dt_f}) — the trapezoid rides the node "
                "grid")
        s_host = [kind(dt_a * kind(j)) for j in range(1, mq + 1)]
        s_grid = torch.tensor([float(s) for s in s_host], dtype=tdt,
                              device=dev)
        wq = torch.full((mq,), float(dt_a), dtype=dtype, device=dev)
        wq[-1] = float(kind(kind(0.5) * dt_a))
        # the kernels' values on the grid, once (they depend on p only)
        kvals = [torch.func.vmap(lambda s, K=K: torch.as_tensor(
            K(s, p), dtype=dtype, device=dev))(s_grid) for K in dist_kernels]
        k0 = [torch.as_tensor(K(torch.zeros((), dtype=tdt, device=dev), p),
                              dtype=dtype, device=dev)
              for K in dist_kernels]

    def row(buf, k):
        # a row the march has not written reads as zeros, as JAX's buffer
        return buf[k] if k < len(buf) else torch.zeros_like(u0vec)

    memo = {}

    def gather(td):
        """The Hermite read at host time td on the uniform node grid; an
        exact-node query lands on the right end of the left interval, so
        only written slopes are read. Memoized within a step (the Newton
        sweeps of a stage read the same times)."""
        if td in memo:
            return memo[td]
        memo[td] = out = _gather(td)
        return out

    def _gather(td):
        x = kind(kind(td - t_base_a) / dt_a)
        base = min(max(int(np.floor(kind(x - kind(1e-9)))), 0), n_rows - 2)
        ta = kind(t_base_a + kind(kind(base) * dt_a))
        f1 = f_hist_t0 if base + 1 == m_hist else row(fb, base + 1)
        return hermite_eval(td, ta, kind(ta + dt_a), row(ub, base),
                            row(fb, base), row(ub, base + 1), f1)

    stacked = {}

    def gather_device(td):
        """The Hermite read at a device time (a state-dependent lag): the
        interval by index arithmetic on the device, over the nodes stacked
        once per step."""
        if "u" not in stacked:
            stacked["u"] = torch.stack(ub)
            stacked["f"] = torch.stack(fb)
            fr = list(fb)
            fr[m_hist] = f_hist_t0
            stacked["fr"] = torch.stack(fr)
        su, sf, sfr = stacked["u"], stacked["f"], stacked["fr"]
        x = (td - float(t_base_a)) / float(dt_a)
        base = torch.clamp(torch.floor(x - 1e-9), 0,
                           min(n_rows, su.shape[0]) - 2).detach().long()
        ta = float(t_base_a) + base.to(td.dtype) * float(dt_a)
        return hermite_at(td, ta, ta + float(dt_a), su[base], sf[base],
                          su[base + 1], sfr[base + 1])

    def fvec(uvec, t):
        """The stage derivative at host time t, and the stage's lag flag
        (a state-dependent lag outside [dt, max_lag])."""
        u = unravel_u(uvec)
        outs, bad = [], False
        for lag_fn, la in zip(prob.lags, lags_a):
            if la is None:
                lv = lag_fn(u, p, t)
                if isinstance(lv, torch.Tensor):
                    lv = lv.to(tdt)
                    bad = _lag_flag(bad, (lv < float(dt_a) * (1.0 - 1e-12))
                                    | (lv > float(max_lag_a) * (1 + 1e-12)))
                    # the clamp keeps the read in the written region; when
                    # it acts the outputs are poisoned anyway
                    td = torch.clamp(t - lv, float(t_base_a),
                                     float(kind(t - dt_a)))
                    outs.append(unravel_u(gather_device(td)))
                    continue
                lv = kind(lv)
                bad = _lag_flag(bad, bool(lv < dt_a * kind(1.0 - 1e-12))
                                or bool(lv > max_lag_a * kind(1 + 1e-12)))
                td = min(max(kind(t - lv), t_base_a), kind(t - dt_a))
            else:
                td = kind(t - la)
            outs.append(unravel_u(gather(td)))
        if dist_kernels:
            states = torch.stack([gather(kind(t - s)) for s in s_host])
            for kv, kz in zip(kvals, k0):
                integral = (float(kind(kind(0.5) * dt_a)) * kz * uvec
                            + torch.einsum("j,j,jk->k", wq, kv, states))
                outs.append(unravel_u(integral))
        du = ravel_pytree(f_user(u, tuple(outs), p, t))[0]
        return du.to(dtype), bad

    implicit = isinstance(solver, ESDIRK)
    if implicit and getattr(solver, "name", "") != "TRBDF2":
        raise NotImplementedError(
            f"stiff method-of-steps implements TRBDF2(); got {solver.name}")
    if solver is not None and not implicit:
        raise NotImplementedError(
            "DDE method of steps supports solver=None (explicit RK4) or "
            f"TRBDF2() (stiff, implicit); got {solver!r}")
    if implicit:
        # TR-BDF2 constants (Bank et al.)
        gam = 2.0 - math.sqrt(2.0)
        c_bdf1 = 1.0 / (gam * (2.0 - gam))
        c_bdf2 = -((1.0 - gam) ** 2) / (gam * (2.0 - gam))
        c_bdf3 = (1.0 - gam) / (2.0 - gam)
        # its Jacobians take forward mode, which a kernel field refuses:
        # before anything launches
        probe_forward_mode(lambda v: fvec(v, kind(t0))[0], u0vec)

        def newton(res_fn, v0):
            """Dense Newton, six sweeps, each with the Jacobian by forward
            mode through the delayed reads; the lag flag of the last
            evaluation."""
            from ..ops.vjp import jacfwd

            v, bad = v0, False
            for _ in range(6):
                r, bad = res_fn(v)
                J = jacfwd(lambda w: res_fn(w)[0], v)
                v = v - torch.linalg.solve(J, r)
            return v, bad

        c_tr = float(kind(kind(0.5 * gam) * dt_a))
        c_g = float(kind(kind(gam) * dt_a))
        c_b3 = float(kind(kind(c_bdf3) * dt_a))

    half = float(kind(kind(0.5) * dt_a))
    sixth = float(kind(dt_a / kind(6.0)))
    bad = False
    for i in range(n_steps):
        stacked.clear()
        memo.clear()
        uvec = ub[m_hist + i]
        t = kind(kind(t0) + kind(dt_a * kind(i)))
        k1, b1 = fvec(uvec, t)
        # this node's slope, written before the interior stages read it
        if i == 0:
            fb[m_hist] = k1
        else:
            fb.append(k1)
        stacked.clear()
        memo.clear()
        if implicit:
            t_g = kind(t + kind(kind(gam) * dt_a))

            def res_tr(v):
                fv, b = fvec(v, t_g)
                return v - uvec - c_tr * (k1 + fv), b

            u_g, b2 = newton(res_tr, uvec + c_g * k1)
            t_1 = kind(t + dt_a)

            def res_bdf(w):
                fw, b = fvec(w, t_1)
                return w - c_bdf1 * u_g - c_bdf2 * uvec - c_b3 * fw, b

            u1, b3 = newton(res_bdf, u_g)
            b4 = False
        else:
            t_h = kind(t + kind(kind(0.5) * dt_a))
            k2, b2 = fvec(uvec + half * k1, t_h)
            k3, b3 = fvec(uvec + half * k2, t_h)
            k4, b4 = fvec(uvec + float(dt_a) * k3, kind(t + dt_a))
            u1 = uvec + sixth * (k1 + 2 * k2 + 2 * k3 + k4)
        ub.append(u1)
        for b in (b1, b2, b3, b4):
            bad = _lag_flag(bad, b)

    saveat_np = (np.asarray([t0, t1], dtype=kind) if saveat is None
                 else host_times(saveat, kind))
    save_idx = np.clip(np.rint((saveat_np.astype(np.float64) - t0) / dt_f)
                       .astype(np.int64), 0, n_steps)
    rows = torch.stack([ub[m_hist + int(k)] for k in save_idx])
    bad = _host_bool(bad)
    rows, u_final = _poisoned(rows, ub[-1], bad)
    retcode = RETCODE_LAG_VIOLATION if bad else RETCODE_SUCCESS
    stats = Stats(n_accepted=n_steps, n_rejected=0,
                  n_fevals=((1 + 2 * 6 * 2) * n_steps if implicit
                            else 4 * n_steps),
                  retcode=retcode)
    return ODESolution(
        ts=torch.from_numpy(saveat_np), ys=unravel_u(rows), stats=stats,
        retcode=retcode, prob=prob,
        solver=("MethodOfStepsTRBDF2Hermite" if implicit
                else "MethodOfStepsRK4Hermite"),
        sensealg=sensealg, dense=None, unravel_u=unravel_u, u_final=u_final)


def solve_dde_adaptive(prob: DDEProblem, solver=None, *, rtol=1e-6,
                       atol=1e-9, saveat=None, max_steps: int = 512,
                       dt0=None, dtmax=None, sensealg=None) -> ODESolution:
    """The adaptive constrained method of steps (JAX `solve_dde_adaptive`,
    DelayDiffEq's MethodOfSteps(Tsit5(), constrained=true)): a PI
    controller with dt capped at the smallest constant lag (and `dtmax`),
    so every stage's delayed query lies left of the step; the breaking
    points t0 + k·τᵢ (k up to the stepper's order) and the save times are
    forced stops. Delayed states are Hermite reads of the accepted nodes,
    the history callable below t0. The budget is JAX's scan's: max_steps
    attempts, rejected ones included, then MaxIters with NaN outputs.
    State-dependent lags need dtmax (a lower bound on every lag); a
    realized lag below the step poisons the solution (retcode 3). Stiff
    DDEs: an ESDIRK stepper (TRBDF2, Kvaerno3, SDIRK4), constant lags
    only. sol(t) reads the accepted nodes' dense output."""
    from ..solvers.explicit import ExplicitRK, Tsit5
    from ..solvers.sdirk import ESDIRK

    if getattr(prob, "dist_kernels", None):
        raise NotImplementedError(
            "distributed lags (dist_kernels) ride the fixed node grid; use "
            "the fixed-grid path (pass dt=...)")
    if not prob.lags:
        raise ValueError("DDEProblem needs at least one lag")
    if solver is None:
        solver = Tsit5()
    implicit = isinstance(solver, ESDIRK)
    if not isinstance(solver, ExplicitRK) and not implicit:
        raise NotImplementedError(
            "adaptive method of steps supports explicit RK steppers "
            "(Tsit5/Dopri5/BS3) and ESDIRK (TRBDF2/Kvaerno3/SDIRK4) for "
            f"stiff DDEs; got {solver!r}")
    if implicit and getattr(solver, "mass_matrix", None) is not None:
        raise NotImplementedError(
            "DDE method of steps does not support mass matrices")
    if implicit and any(callable(lag) for lag in prob.lags):
        raise NotImplementedError(
            "state-dependent lags under the ADAPTIVE stiff method of steps "
            "are not supported; use an explicit adaptive stepper (with "
            "dtmax=) or the fixed-grid TRBDF2 path (dt=...)")
    t0, t1 = float(prob.tspan[0]), float(prob.tspan[1])
    if not t1 > t0:
        raise ValueError("adaptive DDE integrates forward: need t1 > t0")
    const_lags = [float(lag) for lag in prob.lags if not callable(lag)]
    has_dep = len(const_lags) < len(prob.lags)
    if has_dep and dtmax is None:
        raise ValueError(
            "state-dependent lags under the adaptive method of steps need "
            "dtmax= (a static lower bound on every realizable lag; the "
            "constrained-mode step cap)")
    dt_cap = min(const_lags + ([float(dtmax)] if dtmax is not None else []))
    if dt_cap <= 0:
        raise ValueError(f"step cap must be positive; got {dt_cap}")

    u0vec, unravel_u = ravel_pytree(prob.u0)
    dtype, dev = u0vec.dtype, u0vec.device
    kind = time_dtype(dtype)
    tdt = kind_torch_dtype(kind)
    p, f_user = prob.p, prob.f
    hist_at = _history(prob, u0vec, tdt)
    t0_a, t1_a = kind(t0), kind(t1)
    lags_a = [None if callable(lag) else kind(lag) for lag in prob.lags]

    # the stops: the save times, the breaking points t0 + k·τ (k ≤ order)
    # and t1
    saveat_np = (np.asarray([t0, t1], dtype=kind) if saveat is None
                 else host_times(saveat, kind))
    breaks = []
    for lag in const_lags:
        k = 1
        while (k <= solver.order
               and t0 + k * lag < t1 - 1e-12 * max(1.0, abs(t1))):
            breaks.append(t0 + k * lag)
            k += 1
    tstops = np.sort(np.concatenate(
        [saveat_np, np.asarray(breaks + [t1], dtype=kind)]))

    # the accepted nodes
    ts, ys, fs = [t0_a], [u0vec], [None]
    ts_arr = np.asarray(ts, dtype=kind)
    stacked, memo = {}, {}

    def read(td):
        """u at a delayed host time td ≥ t0 from the accepted nodes (the
        interval located on the host; the first interval before any step is
        accepted). Memoized within an attempt."""
        if td not in memo:
            memo[td] = _read(td)
        return memo[td]

    def _read(td):
        n_acc = len(ts) - 1
        i = int(np.searchsorted(ts_arr, td, side="right")) - 1
        i = min(max(i, 0), max(n_acc - 1, 0))
        if n_acc == 0:
            return ys[0]
        return hermite_eval(td, ts[i], ts[i + 1], ys[i], fs[i], ys[i + 1],
                            fs[i + 1])

    def read_device(td):
        """u at a delayed device time (a state-dependent lag): the interval
        by a masked sum over the node times, as JAX locates it, over the
        nodes stacked once per step."""
        n_acc = len(ts) - 1
        if n_acc == 0:
            return ys[0]
        if "u" not in stacked:
            stacked["t"] = torch.as_tensor(ts_arr, dtype=tdt, device=dev)
            stacked["u"] = torch.stack(ys)
            stacked["f"] = torch.stack(fs)
        st, su, sf = stacked["t"], stacked["u"], stacked["f"]
        i = torch.clamp((st <= td).sum() - 1, 0, n_acc - 1).detach()
        return hermite_at(td, st[i], st[i + 1], su[i], sf[i], su[i + 1],
                          sf[i + 1])

    def fvec_full(uvec, t, dt_now, flags):
        """The stage derivative at host time t; a state-dependent lag's
        violation flag (lag < dt_now, or not finite) joins `flags`."""
        u = unravel_u(uvec)
        outs = []
        for lag_fn, la in zip(prob.lags, lags_a):
            if la is None:
                lv = lag_fn(u, p, t)
                if isinstance(lv, torch.Tensor):
                    lv = lv.to(tdt)
                    flags.append((lv < float(dt_now) * (1.0 - 1e-12))
                                 | ~torch.isfinite(lv))
                    td = t - lv
                    # the history side is exact; the clamp only guards the
                    # read
                    td_g = torch.clamp(td, float(t0_a), float(t))
                    sol_val = read_device(td_g)
                    hist_val = hist_at(torch.clamp(td, max=float(t0_a)))
                    outs.append(unravel_u(torch.where(td <= float(t0_a),
                                                      hist_val, sol_val)))
                    continue
                lv = kind(lv)
                flags.append(bool(lv < dt_now * kind(1.0 - 1e-12))
                             or not np.isfinite(lv))
            else:
                lv = la
            td = kind(t - lv)
            if td <= t0_a:
                outs.append(unravel_u(hist_at(td)))
            else:
                outs.append(unravel_u(read(min(td, kind(t)))))
        du = ravel_pytree(f_user(u, tuple(outs), p, t))[0]
        return du.to(dtype)

    rtol_k, atol_k = kind(rtol), kind(atol)
    order = solver.order
    beta1 = kind(0.7 / (order + 1.0))
    beta2 = kind(0.4 / (order + 1.0))
    dt_cap_a = kind(dt_cap)

    if implicit:
        # the stepper's Jacobian takes forward mode, which a kernel field
        # refuses: before anything launches
        probe_forward_mode(lambda v: fvec_full(v, t0_a, dt_cap_a, []), u0vec)
    f0 = fvec_full(u0vec, t0_a, dt_cap_a, [])
    fs[0] = f0
    if dt0 is None:
        dt = min(dt_cap_a, kind(0.1 * (t1 - t0) ** 0.5 * 0.1))
        dt = min(dt, kind((t1 - t0) / 8.0))
    else:
        dt = min(kind(abs(float(dt0))), dt_cap_a)

    t, u, f = t0_a, u0vec, f0
    err_prev = kind(1.0)
    n_acc = n_rej = 0
    status = -1
    bad = False
    for _ in range(max_steps):
        if status >= 0:
            break
        stacked.clear()
        memo.clear()
        stop, _ = next_stop(t, t1_a, tstops, kind(1.0))
        remaining = kind(stop - t)
        dt_eff = remaining if dt >= remaining else dt
        flags = []
        fv = lambda uu, tt: fvec_full(uu, tt, dt_eff, flags)
        u1, f1, err = solver.step(fv, t, dt_eff, u, f)
        u1, f1 = u1.to(dtype), f1.to(dtype)
        err_norm = kind(error_norm(err, u, u1, rtol_k, atol_k).item())
        nonfinite = not np.isfinite(err_norm)
        if nonfinite:
            err_norm = kind(2.0)
        accept = bool(err_norm <= kind(1.0)) and not nonfinite
        err_cl = max(err_norm, kind(1e-10))
        factor = kind(kind(kind(0.9) * kind(err_cl ** -beta1))
                      * kind(err_prev ** beta2))
        if nonfinite:
            factor = kind(0.2)
        factor = min(max(factor, kind(0.2)), kind(10.0))
        dt_next = min(kind(dt_eff * factor), dt_cap_a)
        if accept:
            t = kind(t + dt_eff)
            u, f = u1, f1
            # a violated state-dependent lag matters on an accepted step
            # only (a rejected trial may overshoot it)
            for flag in flags:
                bad = _lag_flag(bad, flag)
            n_acc += 1
            err_prev = err_cl
            ts.append(t)
            ys.append(u)
            fs.append(f)
            ts_arr = np.asarray(ts, dtype=kind)
            if kind(t1_a - t) <= kind(kind(abs(t1_a) * kind(1e-14))
                                      + kind(1e-300)):
                status = RETCODE_SUCCESS
        else:
            n_rej += 1
        dt = dt_next
    if status < 0:
        status = RETCODE_MAXITERS
    if _host_bool(bad):
        status = RETCODE_LAG_VIOLATION

    dense = DenseOutput(ts=ts_arr, ys=torch.stack(ys), fs=torch.stack(fs),
                        n_steps=len(ts) - 1, tdir=kind(1.0))
    rows = torch.stack([dense_eval(dense, tk) for tk in saveat_np])
    rows, u_final = _poisoned(rows, u, status != RETCODE_SUCCESS)
    fevals = (solver.n_stages * (1 + 4 * solver.newton_iters) if implicit
              else solver.n_stages)
    stats = Stats(n_accepted=n_acc, n_rejected=n_rej,
                  n_fevals=max_steps * fevals, retcode=status)
    return ODESolution(
        ts=torch.from_numpy(saveat_np), ys=unravel_u(rows), stats=stats,
        retcode=status, prob=prob,
        solver=f"MethodOfStepsAdaptive{solver.name}", sensealg=sensealg,
        dense=dense, unravel_u=unravel_u, u_final=u_final)
