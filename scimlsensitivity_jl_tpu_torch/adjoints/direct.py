"""DirectAdjoint on a fixed grid: autograd through the step loop (PyTorch
port).

Counterpart of `scimlsensitivity_jl_tpu/adjoints/direct.py:
make_fixed_grid_solve_fn` (direct.py:28). The JAX package differentiates a
`lax.scan` (or, with unroll=True, an unrolled trace) of the fixed-grid
steps; here the eager step loop records the autograd graph itself, so the
gradient is the exact discrete adjoint of the scheme. `unroll=` is kept for
API parity: it selects the JAX unrolled path's stage times (grid nodes
computed in Python floats) and otherwise runs the same loop. The adaptive
`make_direct_solve_fn` waits (ROADMAP M3).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.vjp import make_vjp_kernels
from ..solvers.integrate import Stats, state_kind
from ..utils.pytree import ravel_pytree
from .continuous import AuxOut, SolveOptions

__all__ = ["make_fixed_grid_solve_fn"]


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
