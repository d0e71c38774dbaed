"""DirectAdjoint: autograd through the step loop (PyTorch port).

Counterpart of `scimlsensitivity_jl_tpu/adjoints/direct.py`:
`make_fixed_grid_solve_fn` (direct.py:28) and the adaptive
`make_direct_solve_fn` (:109, with events, :141-186). The JAX package
differentiates a `lax.scan`
of the steps (the masked fixed-trip `integrate_scan` when adaptive, or an
unrolled trace); here the eager step loop records the autograd graph
itself, so the gradient is the exact discrete adjoint of the scheme on the
realized grid. The controller's decisions (step sizes, accept or reject)
are host floats, outside the graph: the counterpart of the scan's
`stop_gradient`s (integrate.py:573, 636). A rejected attempt's result is
never used, so it leaves no node behind. `unroll=` is kept for API parity
(the fixed grid takes the JAX unrolled path's stage times from it; the
adaptive path runs the same loop either way, behind the same
max_steps <= 256 guard).

Save times and event times carry derivatives as JAX's traced times do:
a saveat tensor that requires grad reaches the gradient through the
length of each step clipped to it (`remaining = stop - t`, JAX
direct.py:131), and an event time through its Newton-polished θ
(`solvers/events.py`); the integrator carries both as zero-valued tensors
beside its host clock, and so do the dense nodes whose times they move.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..ops.vjp import make_vjp_kernels
from ..solvers.integrate import (RETCODE_TERMINATED, Stats, kind_torch_dtype,
                                 state_kind, time_dtype)
from ..utils.pytree import ravel_pytree
from .common import forward_saveat_solve
from .continuous import AuxOut, SolveOptions

__all__ = ["make_fixed_grid_solve_fn", "make_direct_solve_fn"]


def make_fixed_grid_solve_fn(f, solver, opts: SolveOptions, t0, t1, *,
                             n_steps: int, unroll: bool = False):
    """Fixed-grid solve, differentiable by autograd. saveat times must lie on
    the grid. The march reads nothing back from the device."""
    # grid math in Python floats, as the JAX factory does it
    dt_py = (float(t1) - float(t0)) / n_steps
    ts_nodes_py = [float(t0) + dt_py * i for i in range(n_steps + 1)]

    def solve_fn(u0, p, saveat):
        u0vec, unravel_u = ravel_pytree(u0)
        # dt and the grid times in the state dtype (bfloat16 included), as
        # the JAX factory keeps them
        kind = state_kind(u0vec.dtype)
        kern = make_vjp_kernels(f, u0, p)
        fvec = lambda uv, t: kern.fvec(uv, p, t)
        dt = kind(dt_py)

        save_t = np.array([float(kind(s)) for s in
                           np.asarray(saveat, dtype=np.float64).reshape(-1)])
        steps_f = (save_t - float(t0)) / dt_py
        if not np.allclose(steps_f, np.rint(steps_f), atol=1e-4):
            raise ValueError("fixed-grid saveat times must lie on the dt "
                             f"grid; got offsets {steps_f}")
        save_idx = np.clip(np.rint(steps_f).astype(np.int64), 0, n_steps)
        wanted = set(save_idx.tolist())

        nodes = {0: u0vec}
        u = u0vec
        fcur = fvec(u, kind(t0))
        for i in range(n_steps):
            if unroll:
                t_i = kind(ts_nodes_py[i])
            else:
                t_i = kind(kind(t0) + kind(dt * kind(i)))
            u, fcur, _ = solver.step(fvec, t_i, dt, u, fcur, need_err=False)
            if i + 1 in wanted:
                nodes[i + 1] = u

        ys_save = torch.stack([nodes[int(j)] for j in save_idx])
        stats = Stats(n_accepted=n_steps, n_rejected=0,
                      n_fevals=n_steps * getattr(solver, "n_stages", 1),
                      retcode=0)
        aux = AuxOut(dense=None, t_final=kind(t1), u_final=u, stats=stats)
        return unravel_u(ys_save), aux

    return solve_fn


class _RematStepper:
    """`remat=True`: each step attempt runs under `torch.utils.checkpoint`
    (non-reentrant), so autograd keeps only the step's inputs and the
    backward pass evaluates the step's stages again, the counterpart of
    `jax.checkpoint` over the scan body (integrate.py:767-771). The fields
    are deterministic, so no random state is saved and restored (saving the
    CUDA generator's state would read it back to the host every step)."""

    def __init__(self, stepper):
        self.stepper = stepper
        self.order = stepper.order
        self.n_stages = getattr(stepper, "n_stages", 1)

    def step(self, fvec, t, dt, u, f0, need_err: bool = True, **offsets):
        return checkpoint(self.stepper.step, fvec, t, dt, u, f0, need_err,
                          use_reentrant=False, preserve_rng_state=False,
                          **offsets)


def make_direct_solve_fn(f, solver, sensealg, opts: SolveOptions, t0, t1,
                         unroll: bool = False):
    """Adaptive solve, differentiable by autograd through the accepted
    steps. The step budget is the scan's: `max_steps` attempts (rejected
    ones included), then MaxIters, and no DtMin check. On MaxIters the
    values, the dense output and the gradients are NaN; save times never
    reached hold the final state."""
    max_steps = sensealg.max_steps or opts.max_steps
    if unroll and max_steps > 256:
        raise ValueError(
            "solve(adaptive=True, unroll=True) emits max_steps straight-line "
            f"solver steps; max_steps={max_steps} would explode compile "
            "time. Bound max_steps (or sensealg.max_steps) to ≤ 256."
        )
    stepper = _RematStepper(solver) if sensealg.remat else solver

    def solve_fn(u0, p, saveat):
        u0vec, unravel_u = ravel_pytree(u0)
        kern = make_vjp_kernels(f, u0, p)
        sv_off = None
        if isinstance(saveat, torch.Tensor):
            if saveat.requires_grad and torch.is_grad_enabled():
                tdt = kind_torch_dtype(time_dtype(u0vec.dtype))
                sv = saveat.to(dtype=tdt, device=u0vec.device)
                sv_off = sv - sv.detach()
            saveat = saveat.detach().cpu().numpy()
        event_set = None
        if opts.callback is not None:
            from ..callbacks import build_event_set

            event_set = build_event_set(opts.callback, p, unravel_u,
                                        opts.max_events)
        fwd = forward_saveat_solve(
            stepper, lambda uv, t: kern.fvec(uv, p, t), u0vec, t0, t1, saveat,
            rtol=opts.rtol, atol=opts.atol, dt0=opts.dt0, max_steps=max_steps,
            tstops=opts.tstops, store_dense=opts.dense, fixed_trip=True,
            event_set=event_set, saveat_offsets=sv_off, norms=opts.norms)
        ys_save, u_final, dense = fwd.ys_save, fwd.u_final, fwd.dense
        if fwd.stats.retcode not in (0, RETCODE_TERMINATED):
            # additive and tied to u_final, as direct.py:172-176: a NaN
            # cotangent then reaches every step (NaN·0 = NaN), where a bare
            # NaN constant would leave the gradient silently zero
            nan_term = float("nan") * (1.0 + 0.0 * torch.sum(u_final))
            ys_save = ys_save + nan_term
            u_final = u_final + nan_term
            if dense is not None:
                dense = dense._replace(ys=dense.ys + nan_term)
        aux = AuxOut(dense=dense, t_final=fwd.t_final, u_final=u_final,
                     stats=fwd.stats, events=fwd.events)
        return unravel_u(ys_save), aux

    return solve_fn
