"""SDE and RODE solves with their adjoints (PyTorch port).

Counterpart of `scimlsensitivity_jl_tpu/adjoints/sde.py`: `solve_sde` on
the fixed grid (:289-818), `solve_rode` (:85-275) and the adaptive
`_solve_sde_adaptive` on a VirtualBrownianTree (:819-1092).

Noise is counter-based (`ops/brownian.py`): step i's increment is drawn
from (key, i), so the forward, the reverse and a second call draw the
same bits and no path is stored. Each rule is the exact discrete adjoint
of the realised scheme:

  * DirectAdjoint / None: autograd through the step loop;
  * InterpolatingAdjoint: the forward keeps the node states, and the
    reverse takes one pullback of the step map per step (:708);
  * BacksolveAdjoint: O(1) states, each node reconstructed backwards by 6
    Picard sweeps of u_j = u_{j+1} − Δ(u_j) on the same noise, snapped to
    the stored save rows at each save node (with `checkpointing`, the
    default).

Callbacks on the fixed grid (:339-444): discrete conditions at each node,
preset and periodic doses on grid indices, continuous crossings localised
in the step by linear interpolation and re-stepped on Brownian-bridge
increments (:604), and terminal callbacks (a frozen tail, DirectAdjoint
only), each affect composed into the step map, so every rule
differentiates it. The adaptive path runs `solvers/integrate.py`'s loop
with JAX's always-accept controller and its scan budget (max_steps
attempts, then MaxIters): one error-norm read per step, as the adaptive
ODE loop has; the tree's queries are memoised per solve, so the reverse
reads the forward's W without drawing again. On the fixed grid nothing is
read back from the device per step; a terminal callback's stop is read
once, at the end.

Save times, grid times and dt are host scalars of the state's dtype, as
JAX keeps them in jnp scalars of that dtype.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..ops.brownian import (DRAW_DTYPE, NoiseGrid, VirtualBrownianTree,
                            as_key, grid_increment, grid_iterated,
                            grid_levy_area, grid_path)
from ..ops.vjp import probe_forward_mode
from ..problems import RODEProblem, SDEProblem
from ..sensealg import BacksolveAdjoint, DirectAdjoint, InterpolatingAdjoint
from ..solution import ODESolution
from ..solvers.integrate import Stats, match_tol, state_kind, time_dtype
from ..solvers.sde import (AdaptiveEM, AdaptiveMilstein, EulerHeun,
                           EulerMaruyama, Milstein, ito_to_stratonovich_drift,
                           stratonovich_to_ito_drift)
from ..utils.pytree import ravel_pytree

__all__ = ["solve_sde", "solve_rode"]


def _grid_save_steps(saveat: np.ndarray, t0, t1, n_steps, kind: str):
    """Save times -> fixed-grid node indices, on the host; a time off the
    dt grid raises (JAX :54-84, whose traced branch has no counterpart:
    the port's save times are always host values)."""
    steps_f = (np.asarray(saveat, float) - float(t0)) / (
        (float(t1) - float(t0)) / n_steps)
    steps = np.rint(steps_f).astype(np.int64)
    if not np.allclose(steps_f, steps, atol=1e-8):
        raise ValueError(f"{kind} saveat times must lie on the dt grid; got "
                         f"offsets {steps_f}")
    if (steps < 0).any() or (steps > n_steps).any():
        raise ValueError(f"{kind} saveat times must lie inside tspan")
    return steps


def _host_saveat(saveat, t0, t1, kind):
    if saveat is None:
        return np.asarray([t0, t1], dtype=kind)
    if isinstance(saveat, torch.Tensor):
        saveat = saveat.detach().cpu().numpy()
    return np.asarray(saveat, dtype=kind).reshape(-1)


def _check_grid(noise_src, ts_nodes, t0, t1, what):
    ts_u = noise_src.ts
    if isinstance(ts_u, torch.Tensor):
        ts_u = ts_u.detach().cpu().numpy()
    if not np.allclose(np.asarray(ts_u, float), ts_nodes.astype(float),
                       atol=1e-9 * max(1.0, abs(t1 - t0))):
        n_steps = ts_nodes.shape[0] - 1
        raise ValueError(
            f"NoiseGrid.ts must equal the {what} grid t0 + i*dt "
            f"(dt={float(ts_nodes[1] - ts_nodes[0])}, n_steps={n_steps})")


def _grid_tensor(W, dtype, device):
    if isinstance(W, torch.Tensor):
        return W.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(W), dtype=dtype, device=device)


def pullbacks(fn, u, pflat, cots):
    """[((∂fn/∂u)ᵀc, (∂fn/∂p)ᵀc) for c in cots] at (u, pflat): one
    evaluation of fn on fresh leaves, then one autograd pass per
    cotangent (about a tenth of the host time of `torch.func.vjp` per
    call on small states)."""
    with torch.enable_grad():
        uu = u.detach().requires_grad_()
        pp = pflat.detach().requires_grad_()
        out = fn(uu, pp)
        outs = []
        for k, cot in enumerate(cots):
            grads = (None, None)
            if out.requires_grad:
                grads = torch.autograd.grad(
                    out, (uu, pp), cot, allow_unused=True,
                    retain_graph=k + 1 < len(cots))
            outs.append(tuple(torch.zeros_like(x) if gr is None else gr
                              for x, gr in zip((u, pflat), grads)))
    return outs


def pullback(fn, u, pflat, cot):
    """((∂fn/∂u)ᵀcot, (∂fn/∂p)ᵀcot) at (u, pflat): the reverse walks'
    unit, one step map pulled back."""
    return pullbacks(fn, u, pflat, [cot])[0]


class _Walk(NamedTuple):
    """A realised forward as the reverse walk reads it: `step(uv, p, j)`
    maps node j to node j + 1 on the forward's noise (affects included),
    `hits[j]` lists the save rows that land on node j, and `traj` holds the
    node states (InterpolatingAdjoint) or is None (BacksolveAdjoint
    reconstructs them)."""

    step: Callable
    n_steps: int
    hits: dict
    traj: Optional[list]


class _Rule:
    """One solve's forward, `run(u0v, pflat, record, keep_states)` ->
    (save rows, final state, its _Walk when record), and the reverse walk
    of InterpolatingAdjoint (stored nodes) and BacksolveAdjoint
    (reconstructed nodes, snapped to the save rows with `checkpointing`),
    on the fixed grid and on the adaptive path's realised times alike."""

    def __init__(self, run, unravel_p, has_p):
        self.run, self.unravel_p, self.has_p = run, unravel_p, has_p
        self.keep_states = self.snap = False

    def p_of(self, pflat):
        return self.unravel_p(pflat) if self.has_p else None

    def reverse(self, walk, pflat, d_buf, u_f, buf):
        p = self.p_of(pflat)
        lam = torch.zeros_like(u_f)
        q = torch.zeros_like(pflat)
        u_rec = u_f
        for j in range(walk.n_steps - 1, -1, -1):
            for k in walk.hits.get(j + 1, ()):
                lam = lam + d_buf[k]
                if self.snap:
                    u_rec = buf[k]
            if walk.traj is not None:
                u_j = walk.traj[j]
            else:
                u_j = u_rec
                for _ in range(6):
                    u_j = u_rec - (walk.step(u_j, p, j) - u_j)
            lam, pbar = pullback(
                lambda uv, pf: walk.step(uv, self.p_of(pf), j), u_j, pflat,
                lam)
            q = q + pbar
            u_rec = u_j
        for k in walk.hits.get(0, ()):
            lam = lam + d_buf[k]
        return lam, q


class _WalkSolve(torch.autograd.Function):
    """(u0vec, pflat) -> save rows; backward = the rule's reverse walk."""

    @staticmethod
    def forward(ctx, u0vec, pflat, rule):
        buf, u_f, walk = rule.run(u0vec, pflat, record=True,
                                  keep_states=rule.keep_states)
        ctx.rule, ctx.walk, ctx.u_f = rule, walk, u_f
        ctx.save_for_backward(pflat, buf)
        return buf

    @staticmethod
    def backward(ctx, d_buf):
        pflat, buf = ctx.saved_tensors
        lam, q = ctx.rule.reverse(ctx.walk, pflat, d_buf, ctx.u_f, buf)
        return lam, q, None


def _run_rule(rule, sensealg, u0vec, pflat, what):
    """The save rows under DirectAdjoint (autograd through the loop) or
    the Interpolating / Backsolve reverse walks."""
    if sensealg is None or isinstance(sensealg, DirectAdjoint):
        return rule.run(u0vec, pflat)[0]
    if isinstance(sensealg, (InterpolatingAdjoint, BacksolveAdjoint)):
        rule.keep_states = isinstance(sensealg, InterpolatingAdjoint)
        rule.snap = (not rule.keep_states) and getattr(
            sensealg, "checkpointing", True)
        return _WalkSolve.apply(u0vec, pflat, rule)
    raise NotImplementedError(f"{what} sensealg {sensealg!r} unsupported")


def _grid_hits(save_steps):
    """{grid index: the save rows on that node}."""
    hits = {}
    for k, s in enumerate(save_steps.tolist()):
        hits.setdefault(int(s), []).append(k)
    return hits


def _grid_rule(step_map, n_steps, save_steps, unravel_p, has_p):
    """The fixed-grid loop of one solve: step_map(uv, p, i) from node i
    to i + 1, the save rows at their grid indices."""
    hits = _grid_hits(save_steps)

    def run(u0v, pflat, record=False, keep_states=False):
        p = rule.p_of(pflat)
        rows = {k: u0v for k in hits.get(0, ())}
        u = u0v
        traj = [u0v] if keep_states else None
        for i in range(n_steps):
            u = step_map(u, p, i)
            if keep_states:
                traj.append(u)
            for k in hits.get(i + 1, ()):
                rows[k] = u
        buf = torch.stack([rows[k] for k in range(len(rows))])
        walk = _Walk(step_map, n_steps, hits, traj) if record else None
        return buf, u, walk

    rule = _Rule(run, unravel_p, has_p)
    return rule


def _pflat(p, like):
    if p is None:
        return like.new_zeros(0), None
    return ravel_pytree(p)


def _w_shape(prob, n):
    if prob.noise == "general":
        if prob.noise_dim is None:
            raise ValueError("general noise needs noise_dim=m")
        return (prob.noise_dim,)
    if prob.noise == "scalar":
        return ()
    return (n,)


def solve_rode(prob, *, dt, saveat=None, key=None,
               sensealg=None) -> ODESolution:
    """Random ODE u' = f(u, p, t, W(t)) on a fixed grid (RandomEM), W
    from the counter-based increments (`grid_path`) or the problem's
    noise_process. DirectAdjoint (None), InterpolatingAdjoint and
    BacksolveAdjoint, each the exact discrete adjoint over the path."""
    assert isinstance(prob, RODEProblem)
    if dt is None:
        raise ValueError("RODE solves run on a fixed grid: pass dt=...")
    key = as_key(key)
    t0, t1 = float(prob.tspan[0]), float(prob.tspan[1])
    n_steps = max(int(round((t1 - t0) / float(dt))), 1)
    u0vec, unravel_u = ravel_pytree(prob.u0)
    dtype, dev = u0vec.dtype, u0vec.device
    kind = state_kind(dtype)
    n = u0vec.shape[0]
    dt_a = kind((t1 - t0) / n_steps)
    ts_nodes = (kind(t0) + dt_a * np.arange(n_steps + 1).astype(kind)
                ).astype(kind)
    w_shape = (prob.noise_dim,) if prob.noise_dim else (n,)
    noise_src = prob.noise_process
    if noise_src is not None:
        if isinstance(noise_src, NoiseGrid):
            W = _grid_tensor(noise_src.W, dtype, dev)
            if tuple(W.shape) != (n_steps + 1,) + w_shape:
                raise ValueError(
                    f"NoiseGrid.W must have shape {(n_steps + 1,) + w_shape}"
                    f"; got {tuple(W.shape)}")
            _check_grid(noise_src, ts_nodes, t0, t1, "RODE solve")
        elif callable(noise_src):
            W = torch.stack([torch.broadcast_to(torch.as_tensor(
                noise_src(t), device=dev), w_shape).to(dtype)
                for t in ts_nodes])
        else:
            raise TypeError(
                f"noise_process: NoiseGrid or callable W(t), got "
                f"{noise_src!r}")
    else:
        W = grid_path(key, n_steps, w_shape, dt_a, dev).to(dtype)

    saveat = _host_saveat(saveat, t0, t1, kind)
    save_steps = _grid_save_steps(saveat, t0, t1, n_steps, "RODE")
    f_user = prob.f

    def step_map(uv, p, i):
        du = ravel_pytree(f_user(unravel_u(uv), p, ts_nodes[i], W[i]))[0]
        return uv + dt_a * du

    pflat, unravel_p = _pflat(prob.p, u0vec)
    rule = _grid_rule(step_map, n_steps, save_steps, unravel_p,
                      prob.p is not None)
    ys_flat = _run_rule(rule, sensealg, u0vec, pflat, "RODE")
    stats = Stats(n_accepted=n_steps, n_rejected=0, n_fevals=n_steps,
                  retcode=0)
    return ODESolution(
        ts=torch.from_numpy(saveat), ys=unravel_u(ys_flat), stats=stats,
        retcode=0, prob=prob, solver="RandomEM", sensealg=sensealg,
        dense=None, unravel_u=unravel_u,
        solve_args={"kind": "rode", "dt": dt, "key": key})


def _resolve_drift(prob, solver, fvec, gvec):
    """Match the problem's calculus to the scheme's by a drift transform."""
    pi = prob.interpretation
    si = getattr(solver, "interpretation", "ito")
    if pi == si:
        return fvec
    if pi == "ito" and si == "stratonovich":
        return ito_to_stratonovich_drift(fvec, gvec)
    if pi == "stratonovich" and si == "ito":
        return stratonovich_to_ito_drift(fvec, gvec)
    raise ValueError(f"unknown interpretation pair {pi}/{si}")


def _flat_fields(prob, unravel_u, p):
    f_user, g_user = prob.f, prob.g

    def fvec(uv, t):
        return ravel_pytree(f_user(unravel_u(uv), p, t))[0]

    if prob.noise == "general":
        def gvec(uv, t):
            return torch.as_tensor(g_user(unravel_u(uv), p, t))
    else:
        def gvec(uv, t):
            return ravel_pytree(g_user(unravel_u(uv), p, t))[0]
    return fvec, gvec


def _probe_fields(prob, unravel_u, u0vec, t0, which):
    """Refuse a kernel field (pullback only) in a position the scheme
    differentiates by forward mode, before anything launches."""
    fvec, gvec = _flat_fields(prob, unravel_u, prob.p)
    for name in ("f", "g"):
        if name in which:
            fn = fvec if name == "f" else gvec
            probe_forward_mode(lambda uv, fn=fn: fn(uv, t0), u0vec)


def _classify_callbacks(callback, t0, t1, n_steps, solver, sensealg):
    """JAX :339-444: (discrete, preset (steps, affect), continuous,
    terminal), with its refusals."""
    from ..callbacks import (ContinuousCallback, DiscreteCallback,
                             PeriodicCallback, PresetTimeCallback)

    cb_disc, cb_preset, cb_cont, cb_term = [], [], [], []
    items = list(callback) if isinstance(callback, (list, tuple)) else [
        callback]
    for c in items:
        if isinstance(c, PeriodicCallback):
            kper = int(np.floor(abs(t1 - t0) / float(c.period) + 1e-12))
            sgn = 1.0 if t1 >= t0 else -1.0
            c = PresetTimeCallback(
                ts=t0 + sgn * float(c.period) * np.arange(1, kper + 1),
                affect=c.affect, modifies_p=c.modifies_p,
                terminal=c.terminal)
        if getattr(c, "modifies_p", False):
            raise NotImplementedError(
                "SDE callbacks: modifies_p — call solve(), which lifts "
                "p into the state automatically")
        if getattr(c, "terminal", False):
            if isinstance(c, (DiscreteCallback, ContinuousCallback)):
                cb_term.append(c)
                continue
            raise NotImplementedError(
                "terminal SDE callbacks: Discrete/Continuous only")
        if isinstance(c, PresetTimeCallback):
            psteps = _grid_save_steps(np.asarray(c.ts, float).reshape(-1),
                                      t0, t1, n_steps,
                                      "SDE PresetTimeCallback")
            cb_preset.append((set(int(s) for s in psteps), c.affect))
        elif isinstance(c, DiscreteCallback):
            cb_disc.append(c)
        elif isinstance(c, ContinuousCallback):
            cb_cont.append(c)
        else:
            raise NotImplementedError(
                f"unsupported SDE callback type {type(c).__name__}")
    if (cb_cont or cb_term) and (getattr(solver, "needs_dz", False)
                                 or getattr(solver, "needs_levy", False)):
        raise NotImplementedError(
            "continuous/terminal SDE events need plain-increment "
            "schemes (EulerMaruyama/EulerHeun/Milstein): iterated-"
            "integral solvers cannot split a step at τ")
    if cb_term and not (sensealg is None
                        or isinstance(sensealg, DirectAdjoint)):
        raise NotImplementedError(
            "terminal SDE events differentiate under DirectAdjoint "
            "(AD through the masked scan); Interpolating/Backsolve "
            "reverse walks do not model the frozen tail")
    if isinstance(sensealg, BacksolveAdjoint) and (
            cb_disc or cb_preset or cb_cont):
        raise NotImplementedError(
            "BacksolveAdjoint + SDE callbacks: the backward Picard "
            "reconstruction cannot invert an event jump — use "
            "DirectAdjoint or InterpolatingAdjoint")
    return cb_disc, cb_preset, cb_cont, cb_term


def _where(fire, a, b):
    """a where fire else b; a host condition picks without a launch."""
    if isinstance(fire, torch.Tensor):
        return torch.where(fire, a, b)
    return a if bool(fire) else b


def _crossing(c, uv_tree, u1_tree, p, t, t_next, dt_a, dtype):
    """(crossed, θ) of a continuous condition across a step, θ the linear
    interpolation of its zero, parked at ½ off a crossing so reverse AD of
    the bridge's √(θ(1−θ)) stays finite (JAX :560-585)."""
    c0 = torch.as_tensor(c.condition(uv_tree, p, t)).reshape(())
    c1 = torch.as_tensor(c.condition(u1_tree, p, t_next)).reshape(())
    crossed = c0 * c1 < 0
    if c.direction:
        crossed = crossed & ((c1 - c0) * c.direction > 0)
    den = torch.where(c0 == c1, torch.ones_like(c0), c0 - c1)
    theta = torch.where(crossed, torch.clamp(c0 / den, 0.0, 1.0),
                        torch.full_like(c0, 0.5)).to(dtype)
    return crossed, theta


def solve_sde(prob: SDEProblem, solver=None, *, saveat=None, dt=None,
              key=None, sensealg=None, max_steps=None, rtol=1e-3, atol=1e-6,
              callback=None) -> ODESolution:
    """Solve an SDE on the fixed grid (dt=) with any scheme of
    `solvers/sde.py`, or adaptively on a VirtualBrownianTree (no dt:
    EulerMaruyama / AdaptiveEM or Milstein / AdaptiveMilstein)."""
    key = as_key(key)
    if dt is None:
        if prob.noise_process is not None:
            raise NotImplementedError(
                "user-supplied noise_process runs on the fixed grid: pass "
                "dt=... (the adaptive path draws from its own "
                "VirtualBrownianTree)")
        if solver is None or isinstance(solver, (EulerMaruyama, AdaptiveEM)):
            adaptive_kind = "em"
        elif isinstance(solver, (Milstein, AdaptiveMilstein)):
            adaptive_kind = "milstein"
        else:
            raise NotImplementedError(
                f"adaptive SDE stepping (no dt=...) runs Euler-Maruyama "
                f"(step-doubling error) or Milstein (embedded Milstein-EM "
                f"error) on the VirtualBrownianTree; {solver!r} is only "
                f"available on the fixed grid — pass dt=...")
        return _solve_sde_adaptive(
            prob, saveat=saveat, key=key, sensealg=sensealg,
            max_steps=max_steps or 1024, rtol=rtol, atol=atol,
            adaptive_kind=adaptive_kind, callback=callback)
    if solver is None:
        solver = EulerMaruyama() if prob.interpretation == "ito" else \
            EulerHeun()
    if sensealg is None:
        sensealg = DirectAdjoint()

    t0, t1 = float(prob.tspan[0]), float(prob.tspan[1])
    n_steps = max(int(round((t1 - t0) / float(dt))), 1)
    u0vec, unravel_u = ravel_pytree(prob.u0)
    dtype, dev = u0vec.dtype, u0vec.device
    kind = state_kind(dtype)
    n = u0vec.shape[0]
    dt_a = kind((t1 - t0) / n_steps)
    ts_nodes = (kind(t0) + dt_a * np.arange(n_steps + 1).astype(kind)
                ).astype(kind)
    saveat = _host_saveat(saveat, t0, t1, kind)
    save_steps = _grid_save_steps(saveat, t0, t1, n_steps, "SDE")

    cb_disc, cb_preset, cb_cont, cb_term = [], [], [], []
    if callback is not None:
        cb_disc, cb_preset, cb_cont, cb_term = _classify_callbacks(
            callback, t0, t1, n_steps, solver, sensealg)

    w_shape = _w_shape(prob, n)
    needs_dz = bool(getattr(solver, "needs_dz", False))
    # Lévy areas exist for true matrix noise only
    needs_levy = (bool(getattr(solver, "needs_levy", False))
                  and prob.noise == "general")
    which = set(getattr(solver, "forward_mode", ()))
    if prob.interpretation != getattr(solver, "interpretation", "ito"):
        which.add("g")
    _probe_fields(prob, unravel_u, u0vec, kind(t0), which)

    noise_src = prob.noise_process
    if noise_src is not None:
        if needs_levy:
            raise NotImplementedError(
                f"{solver!r} needs Lévy areas, which an observed path does "
                "not determine; use EulerMaruyama/EulerHeun/"
                "Milstein(commutative=True) with noise_process")
        if needs_dz:
            raise NotImplementedError(
                f"{solver!r} needs iterated integrals ∫(W(s)-W(t))ds, which "
                "an observed path does not determine; use "
                "EulerMaruyama/EulerHeun/Milstein with noise_process")
        if isinstance(noise_src, NoiseGrid):
            Wgrid = _grid_tensor(noise_src.W, dtype, dev)
            if Wgrid.shape[0] != n_steps + 1 or tuple(
                    Wgrid.shape[1:]) != w_shape:
                raise ValueError(
                    f"NoiseGrid.W must have shape (n_steps+1,)+noise_shape ="
                    f" {(n_steps + 1,) + w_shape}; got {tuple(Wgrid.shape)}")
            _check_grid(noise_src, ts_nodes, t0, t1, "solve")

            def dw_at(i):
                return Wgrid[i + 1] - Wgrid[i]
        elif callable(noise_src):
            def dw_at(i):
                wa = torch.as_tensor(noise_src(ts_nodes[i]), device=dev)
                wb = torch.as_tensor(noise_src(ts_nodes[i + 1]), device=dev)
                return torch.broadcast_to(wb - wa, w_shape).to(dtype)
        else:
            raise TypeError(
                f"noise_process: NoiseGrid or callable W(t), got "
                f"{noise_src!r}")
    else:
        def dw_at(i):
            return grid_increment(key, i, w_shape, dt_a, dev).to(dtype)

    def make_field(p):
        fvec, gvec = _flat_fields(prob, unravel_u, p)
        return _resolve_drift(prob, solver, fvec, gvec), gvec

    def bridge_substep(uv, p, i, theta, tag):
        """u(tᵢ + θ·dt) by the scheme's own sub-step on the Brownian-bridge
        increment θ·ΔW + z, z ~ N(0, θ(1−θ)dt) from (key, i, tag); an
        observed path takes the bridge mean (z = 0)."""
        fvec, gvec = make_field(p)
        dw = dw_at(i)
        if noise_src is None:
            xi = key.fold_in(i).fold_in(tag).normal(
                w_shape, DRAW_DTYPE, dev).to(dtype)
            z = torch.sqrt(torch.clamp(theta * (1.0 - theta), min=0.0)
                           * float(abs(dt_a))) * xi
        else:
            z = torch.zeros(w_shape, dtype=dtype, device=dev)
        dw_part = theta * dw + z
        return (solver.step(fvec, gvec, ts_nodes[i], theta * dt_a, uv,
                            dw_part), dw_part)

    def step_map(uv, p, i):
        """One scheme step from node i to i + 1, with the callbacks'
        affects at its end: the unit of the adjoints' vjp."""
        fvec, gvec = make_field(p)
        t = ts_nodes[i]
        dw = dw_at(i)
        if needs_dz:
            dz = grid_iterated(key, i, w_shape, dt_a, dw).to(dtype)
            u1 = solver.step(fvec, gvec, t, dt_a, uv, dw, dz)
        elif needs_levy:
            levy_a = grid_levy_area(key, i, w_shape[0], dt_a, dw,
                                    terms=solver.levy_terms).to(dtype)
            u1 = solver.step(fvec, gvec, t, dt_a, uv, dw, levy_a)
        else:
            u1 = solver.step(fvec, gvec, t, dt_a, uv, dw)
        t_next = ts_nodes[i + 1]
        for ci, c in enumerate(cb_cont):
            crossed, theta = _crossing(c, unravel_u(uv), unravel_u(u1), p,
                                       t, t_next, dt_a, dtype)
            tau = t + theta * dt_a
            u_tau, dw_part = bridge_substep(uv, p, i, theta, 0x1000 + ci)
            u_post = ravel_pytree(c.affect(unravel_u(u_tau), p, tau))[0]
            u1_ev = solver.step(fvec, gvec, tau, (1.0 - theta) * dt_a,
                                u_post, dw - dw_part)
            u1 = torch.where(crossed, u1_ev, u1)
        for d in cb_disc:
            u = unravel_u(u1)
            fire = d.condition(u, p, t_next)
            u1 = _where(fire, ravel_pytree(d.affect(u, p, t_next))[0], u1)
        for psteps, aff in cb_preset:
            if i + 1 in psteps:
                u1 = ravel_pytree(aff(unravel_u(u1), p, t_next))[0]
        return u1

    def step_term(uv, p, i):
        """Terminal-event unit: (u_next, fired, τ); a firing freezes the
        state at the affect-applied event state."""
        from ..callbacks import DiscreteCallback

        u1 = step_map(uv, p, i)
        t, t_next = ts_nodes[i], ts_nodes[i + 1]
        fired = torch.zeros((), dtype=torch.bool, device=dev)
        tau = torch.full((), float(t_next), dtype=dtype, device=dev)
        u_stop = u1
        for cj, c in enumerate(cb_term):
            if isinstance(c, DiscreteCallback):
                hit = torch.as_tensor(c.condition(unravel_u(u1), p, t_next),
                                      device=dev).reshape(())
                u_aff = ravel_pytree(c.affect(unravel_u(u1), p, t_next))[0]
                tau_c = torch.full((), float(t_next), dtype=dtype,
                                   device=dev)
            else:
                hit, theta = _crossing(c, unravel_u(uv), unravel_u(u1), p, t,
                                       t_next, dt_a, dtype)
                tau_c = (t + theta * dt_a).to(dtype)
                u_tau, _ = bridge_substep(uv, p, i, theta, 0x2000 + cj)
                u_aff = ravel_pytree(c.affect(unravel_u(u_tau), p, tau_c))[0]
            first = hit & ~fired
            u_stop = torch.where(first, u_aff, u_stop)
            tau = torch.where(first, tau_c, tau)
            fired = fired | hit
        return u_stop, fired, tau

    pflat, unravel_p = _pflat(prob.p, u0vec)
    has_p = prob.p is not None
    retcode, t_final = 0, None
    if cb_term:
        p_run = unravel_p(pflat) if has_p else None
        hits = _grid_hits(save_steps)
        rows = {k: u0vec for k in hits.get(0, ())}
        u = u0vec
        done = torch.zeros((), dtype=torch.bool, device=dev)
        tfin = torch.full((), t1, dtype=dtype, device=dev)
        for i in range(n_steps):
            u1, fired, tau = step_term(u, p_run, i)
            first = fired & ~done
            u = torch.where(done, u, u1)
            tfin = torch.where(first, tau, tfin)
            done = done | fired
            for k in hits.get(i + 1, ()):
                rows[k] = u
        ys_flat = torch.stack([rows[k] for k in range(len(rows))])
        retcode = 5 if bool(done) else 0
        t_final = tfin
    else:
        rule = _grid_rule(step_map, n_steps, save_steps, unravel_p, has_p)
        ys_flat = _run_rule(rule, sensealg, u0vec, pflat, "SDE")
    stats = Stats(n_accepted=n_steps, n_rejected=0, n_fevals=n_steps,
                  retcode=retcode)
    return ODESolution(
        ts=torch.from_numpy(saveat), ys=unravel_u(ys_flat), stats=stats,
        retcode=retcode, prob=prob, solver=solver, sensealg=sensealg,
        dense=None, unravel_u=unravel_u, t_final=t_final,
        solve_args={"kind": "sde", "dt": dt, "key": key})


def _node_hits(saveat, ts_nodes, tolt):
    """{node index: save rows on it} for the adaptive path's realised
    times, matched from the last row backwards within tolt (duplicate save
    times share one node)."""
    kind = type(tolt)
    hits, kk = {}, saveat.shape[0] - 1
    for j in range(len(ts_nodes) - 1, -1, -1):
        for _ in range(3):
            if kk >= 0 and abs(kind(saveat[kk] - ts_nodes[j])) <= tolt:
                hits.setdefault(j, []).append(kk)
                kk -= 1
    return hits


def _solve_sde_adaptive(prob, *, saveat, key, sensealg, max_steps, rtol,
                        atol, adaptive_kind="em", callback=None):
    """The adaptive path on a VirtualBrownianTree (depth 28) with JAX's
    previsible always-accept controller, so the realised grid is the same
    for the forward and the reverse: DirectAdjoint (autograd through the
    loop), InterpolatingAdjoint (stored nodes) or BacksolveAdjoint (the
    realised times only, states reconstructed from the same tree and
    snapped at each save node). Callbacks (DirectAdjoint only) run on the
    event engine of the adaptive ODE loop, preset times as stops."""
    from ..callbacks import (any_modifies_p, as_callback_set,
                             build_event_set, lower_time_callbacks)
    from .common import forward_saveat_solve
    from .direct import _RematStepper

    if sensealg is None:
        sensealg = DirectAdjoint()
    if not isinstance(sensealg, (DirectAdjoint, InterpolatingAdjoint,
                                 BacksolveAdjoint)):
        raise NotImplementedError(
            "adaptive SDE gradients: DirectAdjoint, InterpolatingAdjoint "
            "(stored nodes), or BacksolveAdjoint (reconstructed nodes)")
    t0, t1 = float(prob.tspan[0]), float(prob.tspan[1])
    u0vec, unravel_u = ravel_pytree(prob.u0)
    dtype, dev = u0vec.dtype, u0vec.device
    kind = time_dtype(dtype)
    n = u0vec.shape[0]
    w_shape = _w_shape(prob, n)
    if adaptive_kind == "milstein":
        _probe_fields(prob, unravel_u, u0vec, kind(t0), ("g",))
    vbt = VirtualBrownianTree.create(key, t0, t1, shape=w_shape, depth=28,
                                     dtype=dtype, device=dev)

    cbs, cb_stops = None, None
    if callback is not None:
        if not isinstance(sensealg, DirectAdjoint):
            raise NotImplementedError(
                "adaptive-SDE callbacks differentiate under DirectAdjoint "
                "(reverse AD through the masked scan); for "
                "Interpolating/Backsolve use the fixed grid (dt=...)")
        lowered, cb_stops = lower_time_callbacks(callback, prob.f, t0, t1,
                                                 kind)
        cbs = as_callback_set(lowered)
        if any_modifies_p(cbs):
            raise NotImplementedError(
                "modifies_p on SDE paths: call solve(), which lifts p "
                "into the state automatically")

    saveat = _host_saveat(saveat, t0, t1, kind)

    def make_stepper(gvec):
        if adaptive_kind == "milstein":
            return AdaptiveMilstein(gvec, vbt)
        return AdaptiveEM(gvec, vbt)

    remat = getattr(sensealg, "remat", False)

    runs = []  # each forward's stats
    tolt = match_tol(kind, kind(t1) - kind(t0), kind(t0), kind(t1))

    def step_map(uv, p, ta, tb):
        """The forward step [ta, tb] again, on the same tree reads."""
        fvec, gvec = _flat_fields(prob, unravel_u, p)
        return make_stepper(gvec).step(fvec, ta, kind(tb - ta), uv,
                                       fvec(uv, ta))[0]

    def run(u0v, pflat, record=False, keep_states=False):
        p = rule.p_of(pflat)
        fvec, gvec = _flat_fields(prob, unravel_u, p)
        stepper = make_stepper(gvec)
        if remat:
            stepper = _RematStepper(stepper)
        event_set = (build_event_set(cbs, p, unravel_u, 32)
                     if cbs is not None else None)
        ts_nodes, us_nodes = [kind(t0)], [u0v]

        def keep(rec):
            ts_nodes.append(rec[1])
            us_nodes.append(rec[4])

        fwd = forward_saveat_solve(
            stepper, fvec, u0v, t0, t1, saveat, rtol=rtol, atol=atol,
            max_steps=max_steps, tstops=cb_stops, store_dense=False,
            fixed_trip=True, event_set=event_set, always_accept=True,
            extra_hook=keep if record else None)
        runs.append(fwd.stats)
        walk = None
        if record:
            walk = _Walk(
                lambda uv, pp, j: step_map(uv, pp, ts_nodes[j],
                                           ts_nodes[j + 1]),
                len(ts_nodes) - 1, _node_hits(saveat, ts_nodes, tolt),
                us_nodes if keep_states else None)
        return fwd.ys_save, fwd.u_final, walk

    pflat, unravel_p = _pflat(prob.p, u0vec)
    rule = _Rule(run, unravel_p, prob.p is not None)
    ys_flat = _run_rule(rule, sensealg, u0vec, pflat, "adaptive SDE")
    stats = runs[-1]
    label = ("AdaptiveMilstein(VBT)" if adaptive_kind == "milstein"
             else "AdaptiveEM(VBT)")
    return ODESolution(
        ts=torch.from_numpy(saveat), ys=unravel_u(ys_flat), stats=stats,
        retcode=stats.retcode, prob=prob, solver=label, sensealg=sensealg,
        dense=None, unravel_u=unravel_u,
        solve_args={"kind": "sde_adaptive", "key": key, "rtol": rtol,
                    "atol": atol, "max_steps": max_steps})
