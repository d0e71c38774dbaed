"""The direct sensitivity API, `adjoint_sensitivities` (PyTorch port).

Counterpart of `scimlsensitivity_jl_tpu/adjoints/interface.py:
adjoint_sensitivities` (:141-563) and `_finish` (:45), the ODE branch:
given a solved trajectory, (dG/du0, dG/dp) for a cost

    G = Σᵢ g_d(u(tᵢ), p, tᵢ, i)  +  ∫_{t0}^{t1} g(u, p, t) dt

from derivative callbacks (`dgdu_discrete`, `dgdp_discrete`,
`dgdu_continuous`, `dgdp_continuous`) or a scalar `g`, whose missing
derivatives come from `torch.func.grad`. The continuous cost enters the
reverse field (dλ/dt gains −∂g/∂u, dq/dt gains −∂g/∂p); the discrete one
jumps λ at each tᵢ.

Each rule family runs its own reverse over the engine of the solve
adjoints (`adjoints/common.py:reverse_joined_solve`,
`adjoints/continuous.py`): BacksolveAdjoint the augmented [λ; q; u] with u
integrated backwards, InterpolatingAdjoint (the default) the joined
[λ; q] over the forward's dense output, GaussAdjoint and
GaussKronrodAdjoint λ with the quadrature hook (`make_gauss_quad_hook`),
QuadratureAdjoint λ with its dense output and then `adaptive_gk_dp`. The
reverse is always adaptive, as in JAX (no pinned or checkpointed reverse
here). A terminated solution (retcode 5) reverses over [t0, sol.t_final];
a solution solved with `callback=` needs the same callback, whose recorded
events the reverse jumps over (`_make_event_apply`), with the running
cost's moving-boundary term (g⁻ − g⁺)·dτ when `g=` is given.

A semi-explicit index-1 DAE solution (its stepper carries the singular
mass matrix, JAX :342-455) reverses with mass Mᵀ (Interpolating: the
augmented blockdiag(Mᵀ, I)) on the DAE reverse stepper, with the discrete
cotangents projected through the constraint (`_dae_project_jumps`), the
algebraic λ rows re-solved at each quadrature node with the running cost
in them (`_dae_lam_fix`), the DAE event jump, and dG/du0 = Mᵀλ(t0);
Backsolve and t_grads raise there, as in JAX.

The JAX function evaluates the data-time derivatives under `vmap`; here
they are a loop, so the user's callbacks need not be batchable. Time is a
host value: the callbacks get t as a numpy scalar of the time dtype.
Everything runs under `torch.no_grad()`; the results carry no graph.

An SDE or RODE solution (JAX :63-120, :182-205) is replayed: its solve
runs again from `sol.solve_args` on the same noise (same key, dt or
tolerances), one autograd pullback of (u0, p) -> ys takes the data-time
cotangents, and the gradient is the exact discrete adjoint of the
realised scheme. Continuous costs and t_grads are refused there, as in
JAX. Parameter-modifying events raise NotImplementedError (as in JAX).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..ops.interp import dense_eval
from ..ops.vjp import make_vjp_kernels
from ..parallel import sharded
from ..problems import ODEProblem
from ..sensealg import (BacksolveAdjoint, GaussAdjoint, GaussKronrodAdjoint,
                        InterpolatingAdjoint, QuadratureAdjoint)
from ..solvers.integrate import (RETCODE_TERMINATED, match_tol, time_dtype)
from ..utils.pytree import ravel_pytree, tree_leaves
from .common import match_cotangents, reverse_joined_solve
from .continuous import (_dae_lam_fix, _dae_project_jumps,
                         _dae_reverse_stepper, _err_weights, _flat,
                         _joined_rhs, _lam_rhs, _make_dae_event_apply,
                         _make_event_apply, adaptive_gk_dp, event_kwargs,
                         host_matrix, make_gauss_quad_hook)

__all__ = ["adjoint_sensitivities"]


def host_times(t, kind) -> np.ndarray:
    """Times given as a tensor, list or array -> a 1-D host array of the
    time dtype (always real)."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    return np.asarray(t, dtype=kind).reshape(-1)


def refuse_other_problems(sol, who: str):
    """The ODE reverse designs take ODE solutions only."""
    prob = sol.prob
    if not isinstance(prob, ODEProblem):
        raise NotImplementedError(
            f"{who} on a {type(prob).__name__} solution is not supported")


def _replay_direct(sol, *, t, dgdu_discrete, dgdp_discrete, sensealg,
                   callback):
    """Direct sensitivities of an SDE/RODE solution by replay (JAX
    :63-120): solve again over the same noise from sol.solve_args, and
    pull the data-time cotangent rows, evaluated at the primal solution,
    back through (u0, p) -> ys."""
    from ..problems import remake
    from ..solve import solve as _solve
    from ..solvers.sde import Milstein

    prob = sol.prob
    p = prob.p
    sa = sol.solve_args
    if sa is None:
        raise ValueError(
            "this SDE/RODE solution carries no replay metadata "
            "(solve_args); re-solve with the package's solve()")
    kind = time_dtype(ravel_pytree(prob.u0)[0].dtype)
    ts_sol = host_times(sol.ts, kind)
    ts = ts_sol if t is None else host_times(t, kind)
    if ts.shape != ts_sol.shape or not np.allclose(ts, ts_sol):
        raise ValueError(
            "t= must equal the solution's save times for SDE/RODE "
            "direct sensitivities (cotangent rows align with sol.ys); "
            "re-solve with saveat=t")
    if dgdu_discrete is None:
        raise ValueError("SDE/RODE direct sensitivities need dgdu_discrete")
    alg = sensealg if sensealg is not None else sol.sensealg
    kw = dict(saveat=ts_sol, sensealg=alg, key=sa["key"])
    solver_arg = None
    if sa["kind"] == "sde_adaptive":
        kw.update(rtol=sa["rtol"], atol=sa["atol"],
                  max_steps=sa["max_steps"])
        # JAX builds AdaptiveMilstein() here, which needs its tree: the
        # port replays through Milstein(), which solve maps to it
        if "Milstein" in str(sol.solver):
            solver_arg = Milstein()
    else:
        kw.update(dt=sa["dt"])
        if not isinstance(sol.solver, str):
            solver_arg = sol.solver
    if callback is not None:
        kw["callback"] = callback

    def detached(tree):
        if tree is None:
            return None
        if isinstance(tree, dict):
            return {k: detached(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(detached(v) for v in tree)
        return tree.detach().clone().requires_grad_()

    u0_l, p_l = detached(prob.u0), detached(p)
    nt = ts.shape[0]
    like = ravel_pytree(prob.u0)[0]
    rows = [_row(sol.ys, i) for i in range(nt)]
    cot = torch.stack([flat_of(dgdu_discrete(rows[i], p, ts[i], i), like)
                       for i in range(nt)])
    leaves = tree_leaves(u0_l) + tree_leaves(p_l)
    with torch.enable_grad():
        s = _solve(remake(prob, u0=u0_l, p=p_l), solver_arg, **kw)
        ys_rows = torch.stack([ravel_pytree(_row(s.ys, i))[0]
                               for i in range(nt)])
        grads = torch.autograd.grad(ys_rows, leaves, grad_outputs=cot,
                                    allow_unused=True)
    grads = [torch.zeros_like(x) if gr is None else gr
             for x, gr in zip(leaves, grads)]
    nu = len(tree_leaves(u0_l))
    du0 = _rebuild(prob.u0, grads[:nu])
    dp = _rebuild(p, grads[nu:]) if p is not None else None
    if dgdp_discrete is not None:
        pflat, unravel_p = ravel_pytree(p)
        extra = sum(flat_of(dgdp_discrete(rows[i], p, ts[i], i), pflat)
                    for i in range(nt))
        dp = unravel_p(ravel_pytree(dp)[0] + extra)
    return du0, dp


def _row(ys, i):
    """Row i of every leaf of a tree of (nt, ...) tensors."""
    if isinstance(ys, dict):
        return {k: _row(v, i) for k, v in ys.items()}
    if isinstance(ys, (list, tuple)):
        return type(ys)(_row(v, i) for v in ys)
    return ys[i]


def _rebuild(tree, leaves):
    """A tree shaped like `tree` from its leaves in flattening order."""
    flat = torch.cat([x.reshape(-1) for x in leaves]) if leaves else None
    return ravel_pytree(tree)[1](flat)


def event_set_of(sol, callback, p, unravel_u, kind, max_events, who):
    """The event set of a solution's forward callbacks, lowered as `solve`
    lowers them, or None; refuses a missing or a stray callback and
    parameter-modifying events, as JAX does."""
    from ..callbacks import (any_modifies_p, as_callback_set,
                             build_event_set, lower_time_callbacks)

    if sol.events is None:
        if callback is not None:
            raise ValueError(
                "callback passed but the solution carries no event records "
                "(was the forward solve run with callback=...?)")
        return None, None
    if callback is None:
        raise ValueError(
            "this solution carries event records (it was solved with "
            f"callbacks): pass the same callback=... to {who}, so that the "
            "reverse pass applies the event-jump VJPs (integrating through "
            "the discontinuities silently gives wrong gradients)")
    t0, t1 = sol.prob.tspan
    lowered, _ = lower_time_callbacks(callback, sol.prob.f, t0, t1, kind)
    cbs = as_callback_set(lowered)
    if any_modifies_p(cbs):
        raise NotImplementedError(
            "parameter-modifying events need the p-lifted state: "
            "differentiate solve(...) itself")
    return cbs, build_event_set(cbs, p, unravel_u, max_events)


def flat_of(tree, like: torch.Tensor) -> torch.Tensor:
    """A user callback's result (a tree of tensors or numbers) as a flat
    vector on `like`'s device, in its dtype."""
    if not isinstance(tree, (dict, list, tuple, torch.Tensor)):
        tree = torch.as_tensor(tree)
    flat = ravel_pytree(tree)[0]
    return flat.to(device=like.device, dtype=like.dtype)


def continuous_cost(g, dgdu_continuous, dgdp_continuous, p, unravel_u,
                    u0vec, npf, event_set):
    """(cost_u, cost_p, extra_p, run_cost) of the continuous cost over flat
    states: −∂g/∂u and −∂g/∂p enter the reverse field, extra_p (None
    without ∂g/∂p) the quadratures, run_cost (g's value, None without g)
    the events' moving-boundary term. The derivatives g's callbacks lack
    come from torch.func.grad. A continuous event with a derivative-only
    cost is refused, as in JAX: its boundary term needs g's value."""
    run_cost = None
    if g is not None:
        run_cost = lambda yvec, tt: g(unravel_u(yvec), p, tt)
        if dgdu_continuous is None:
            dgdu_continuous = torch.func.grad(g, argnums=0)
        if dgdp_continuous is None and npf > 0:
            dgdp_continuous = torch.func.grad(g, argnums=1)
    elif (event_set is not None and event_set.n_cont > 0
          and (dgdu_continuous is not None or dgdp_continuous is not None)):
        raise NotImplementedError(
            "continuous cost + continuous-event solutions: pass g= (not "
            "just dgdu_continuous/dgdp_continuous); the moving-boundary "
            "term (g⁻ − g⁺)·dτ/d(·) at each event time needs the cost VALUE")
    zeros_p = u0vec.new_zeros(npf)

    def cost_u(yvec, tt):
        if dgdu_continuous is None:
            return torch.zeros_like(yvec)
        return flat_of(dgdu_continuous(unravel_u(yvec), p, tt), yvec)

    def cost_p(yvec, tt):
        if dgdp_continuous is None:
            return zeros_p
        return flat_of(dgdp_continuous(unravel_u(yvec), p, tt), yvec)

    extra_p = None if dgdp_continuous is None else cost_p
    return cost_u, cost_p, extra_p, run_cost


@torch.no_grad()
def adjoint_sensitivities(
    sol,
    solver=None,
    *,
    t=None,
    dgdu_discrete: Optional[Callable] = None,
    dgdp_discrete: Optional[Callable] = None,
    dgdu_continuous: Optional[Callable] = None,
    dgdp_continuous: Optional[Callable] = None,
    g: Optional[Callable] = None,
    sensealg=None,
    rtol=1e-7,
    atol=1e-9,
    max_steps: int = 4096,
    callback=None,
    max_events: int = 32,
    t_grads: bool = False,
):
    """(dG/du0, dG/dp) from a solved trajectory.

    sol must carry dense output (`solve(..., dense=True)`); `solver` (the
    reverse stepper) defaults to the forward's. t: the discrete cost's data
    times (default sol.ts).
    dgdu_discrete(u, p, t, i) -> ∂g_d/∂u (like u);
    dgdp_discrete(u, p, t, i) -> ∂g_d/∂p (like p);
    dgdu_continuous(u, p, t) -> ∂g/∂u; dgdp_continuous(u, p, t) -> ∂g/∂p;
    g(u, p, t) -> scalar: the continuous derivatives it lacks come from
    torch.func.grad. rtol / atol / max_steps: the reverse solve's.
    callback: the same callback the forward ran with, required when sol
    carries event records.
    t_grads=True also returns (dG/dt0, dG/dt1) as 0-dim tensors:

        dG/dt1 = g(u(t1), p, t1)    (0 when a terminal event stopped
                                     the solve before t1)
        dG/dt0 = −g(u(t0), p, t0) − Re(λ(t0)ᴴ f(u(t0), p, t0))

    A failed forward or reverse solve (retcode other than 0 or 5) gives NaN
    gradients, as JAX's `_finish` poisons them. Returns (du0, dp), dp None
    for a problem without parameters, or (du0, dp, (dGdt0, dGdt1)).
    Complex states follow torch's convention: the cotangents are the
    conjugates of JAX's, and a real parameter's gradient is real.
    """
    from ..problems import RODEProblem, SDEProblem

    sharded.refuse_sharded(sol.prob, "adjoint_sensitivities")
    if isinstance(sol.prob, (SDEProblem, RODEProblem)):
        if (g is not None or dgdu_continuous is not None
                or dgdp_continuous is not None):
            raise NotImplementedError(
                "adjoint_sensitivities on SDE/RODE solutions supports "
                "discrete costs (dgdu_discrete/dgdp_discrete); put a "
                "running cost in an augmented quadrature state instead")
        if t_grads:
            raise NotImplementedError(
                "t_grads on SDE/RODE solutions is not supported (the "
                "realized noise grid is tied to the tspan)")
        return _replay_direct(sol, t=t, dgdu_discrete=dgdu_discrete,
                              dgdp_discrete=dgdp_discrete,
                              sensealg=sensealg, callback=callback)
    refuse_other_problems(sol, "adjoint_sensitivities")
    if sol.dense is None:
        raise ValueError("adjoint_sensitivities needs solve(..., dense=True)")
    if not isinstance(sensealg, (type(None), BacksolveAdjoint,
                                 InterpolatingAdjoint, GaussAdjoint,
                                 GaussKronrodAdjoint, QuadratureAdjoint)):
        raise NotImplementedError(
            f"adjoint_sensitivities does not support {sensealg!r}")
    solver = solver or sol.solver
    sensealg = sensealg or InterpolatingAdjoint()
    prob = sol.prob
    p, u0 = prob.p, prob.u0
    u0vec, unravel_u = ravel_pytree(u0)
    pflat, unravel_p = ravel_pytree(p)
    if p is None:
        pflat = u0vec.new_zeros(0)
    dtype, n, npf = u0vec.dtype, u0vec.numel(), pflat.numel()
    kind = time_dtype(dtype)
    t0, t1 = kind(prob.tspan[0]), kind(prob.tspan[1])
    # a terminated solution reverses over [t0, t_final] (JAX :221-228)
    tf = kind(sol.t_final) if sol.t_final is not None else t1
    dense = sol.dense
    vjp_choice = getattr(sensealg, "autojacvec", None)
    kern = make_vjp_kernels(
        prob.f, u0, p, user_jac=prob.jac, user_vjp=prob.vjp,
        user_paramjac=prob.paramjac,
        **({} if vjp_choice is None else {"vjp_choice": vjp_choice}))
    ts = host_times(sol.ts if t is None else t, kind)
    nt = ts.shape[0]

    _, event_set = event_set_of(sol, callback, p, unravel_u, kind,
                                max_events, "adjoint_sensitivities")
    cost_u, cost_p, extra_p, run_cost = continuous_cost(
        g, dgdu_continuous, dgdp_continuous, p, unravel_u, u0vec, npf,
        event_set)

    # λ jumps at the data times, and the discrete cost's ∂g_d/∂p summed
    u_at = [unravel_u(dense_eval(dense, ti)) for ti in ts]
    if dgdu_discrete is not None:
        lam_jumps = torch.stack([flat_of(dgdu_discrete(u_at[i], p, ts[i], i),
                                         u0vec) for i in range(nt)])
    else:
        lam_jumps = u0vec.new_zeros(nt, n)
    qdtype = torch.promote_types(dtype, torch.float32)
    dp_disc = torch.zeros(npf, dtype=qdtype, device=u0vec.device)
    if dgdp_discrete is not None:
        for i in range(nt):
            dp_disc = dp_disc + flat_of(
                dgdp_discrete(u_at[i], p, ts[i], i), dp_disc)

    times = np.concatenate([[t0], ts, [t1]]).astype(kind)
    zero = u0vec.new_zeros(1, n)
    jumps = torch.cat([zero, lam_jumps, zero])
    adj = dict(rtol=rtol, atol=atol, max_steps=max_steps, t_span=(t0, tf))

    def ev(**where):
        """reverse_joined_solve's event arguments for this layout."""
        if event_set is None:
            return {}
        return event_kwargs(sol.events, event_set, _make_event_apply(
            kern, p, event_set, sol.events, n, npf, run_cost=run_cost,
            **where))

    M_fwd = getattr(solver, "mass_matrix", None)
    if M_fwd is not None:
        lam0, q, rstats = _dae_reverse(
            sensealg, solver, M_fwd, kern, p, dense, times, jumps, u0vec,
            npf, adj, cost_u, extra_p, event_set, sol.events, run_cost,
            t_grads, (t0, t1), qdtype)
    elif isinstance(sensealg, BacksolveAdjoint):
        # [λ; q; u], the ODE itself integrated backwards from u(t1)
        def aug_rhs(z, tt):
            lam, y = z[:n], z[n + npf:]
            fval, ubar, pbar = kern.f_and_vjp(y, p, tt, lam)
            return torch.cat([-ubar - cost_u(y, tt),
                              -(_flat(pbar, ubar) + cost_p(y, tt)),
                              fval])

        z0 = torch.cat([u0vec.new_zeros(n + npf), dense_eval(dense, t1)])
        z, _, rstats, _ = reverse_joined_solve(
            solver, aug_rhs, times, jumps, z0, n,
            err_weights=_err_weights(u0vec, n, npf, n), **adj,
            **ev(q_slice=n, u_snap_start=n + npf))
        lam0, q = z[:n], z[n:n + npf]
    elif isinstance(sensealg, InterpolatingAdjoint):
        # the joined [λ; q] over the forward's dense output
        def aug_rhs(z, tt):
            y = dense_eval(dense, tt)
            _, ubar, pbar = kern.f_and_vjp(y, p, tt, z[:n])
            return torch.cat([-ubar - cost_u(y, tt),
                              -(_flat(pbar, ubar) + cost_p(y, tt))])

        z, _, rstats, _ = reverse_joined_solve(
            solver, aug_rhs, times, jumps, u0vec.new_zeros(n + npf), n,
            err_weights=_err_weights(u0vec, n, npf), **adj, **ev(q_slice=n))
        lam0, q = z[:n], z[n:]
    else:
        # λ alone; dG/dp by the Gauss hook on every reverse step, or by
        # Gauss–Kronrod over λ's dense output afterwards (Quadrature)
        def aug_rhs(lam, tt):
            y = dense_eval(dense, tt)
            return -kern.vjp_u(y, p, tt, lam) - cost_u(y, tt)

        quadrature = isinstance(sensealg, QuadratureAdjoint)
        hook, finish = None, (lambda q_: q_)
        q0 = torch.zeros(npf, dtype=qdtype, device=u0vec.device)
        if npf and not quadrature:
            hook, q0, finish = make_gauss_quad_hook(
                kern, p, dense, sensealg, t0, t1, qdtype, extra_p=extra_p)
        lam0, q, rstats, lam_dense = reverse_joined_solve(
            solver, aug_rhs, times, jumps, u0vec.new_zeros(n), n,
            hook=hook, hook_carry=q0, collect_dense=quadrature, **adj,
            **ev(q_in_hc=True))
        if quadrature:
            q = adaptive_gk_dp(kern, p, dense, lam_dense, sensealg, q,
                               extra_p=extra_p)
        else:
            q = finish(q)

    # NaN on a failed forward or reverse (JAX `_finish`); Terminated is a
    # deliberate stop, and an event-record overflow is the forward's
    # retcode 4
    fwd_rc = sol.retcode
    bad = rstats.retcode != 0 or fwd_rc not in (0, RETCODE_TERMINATED)
    q = q + dp_disc.to(q.dtype)
    if bad:
        lam0 = torch.full_like(lam0, float("nan"))
        q = torch.full_like(q, float("nan"))
    lam0, q = match_cotangents(lam0, q, (u0vec, pflat))
    du0, dp = unravel_u(lam0), (None if p is None else unravel_p(q))
    if not t_grads:
        return du0, dp

    y0, y1 = dense_eval(dense, t0), dense_eval(dense, t1)
    tdt = torch.promote_types(lam0.real.dtype, torch.float32)

    def g_at(y, tt):
        if g is None:
            return torch.zeros((), dtype=tdt, device=u0vec.device)
        return torch.as_tensor(g(unravel_u(y), p, tt)).to(
            device=u0vec.device, dtype=tdt)

    # λ here is conj(JAX's λ): λ_JAXᵀf = λᴴf
    lam_f = torch.sum(lam0.conj() * kern.fvec(y0, p, t0)).real.to(tdt)
    dgdt0 = -g_at(y0, t0) - lam_f
    tdir = kind(1.0) if t1 >= t0 else kind(-1.0)
    stopped_early = kind(kind(t1 - tf) * tdir) > match_tol(kind, t1 - t0, t1)
    dgdt1 = torch.zeros((), dtype=tdt, device=u0vec.device) if stopped_early \
        else g_at(y1, t1)
    return du0, dp, (dgdt0, dgdt1)


def _dae_reverse(sensealg, solver, M_fwd, kern, p, dense, times, jumps,
                 u0vec, npf, adj, cost_u, extra_p, event_set, events,
                 run_cost, t_grads, tspan, qdtype):
    """(Mᵀλ(t0), dG/dp without the discrete cost's, reverse Stats) of a
    semi-explicit index-1 DAE solution (JAX interface.py:342-455): the
    direct-API mirror of the rules' DAE branches. The reverse stepper is
    `_dae_reverse_stepper(None, solver)` with mass Mᵀ (Interpolating: the
    joined [λ; q] with blockdiag(Mᵀ, I)); the continuous cost's ∂g/∂u
    enters the reverse field and, through `_dae_lam_fix`, the algebraic
    rows at each quadrature node."""
    if t_grads:
        raise NotImplementedError(
            "t_grads on mass-matrix/DAE solutions is not supported (the "
            "endpoint term pairs through μᵀu̇, which needs a consistent u̇); "
            "drop t_grads=True")
    if isinstance(sensealg, BacksolveAdjoint):
        raise NotImplementedError(
            "BacksolveAdjoint re-integrates the DAE backwards, which is not "
            "supported; use InterpolatingAdjoint / GaussAdjoint / "
            "QuadratureAdjoint on mass-matrix solutions")
    n = u0vec.numel()
    du0_map, lamjs, qjs = _dae_project_jumps(M_fwd, kern, p, dense, times,
                                             jumps)
    lam_fix = _dae_lam_fix(M_fwd, kern, p, gu_fn=cost_u)
    M_host = host_matrix(M_fwd)
    on = lambda a: torch.as_tensor(a, dtype=u0vec.dtype, device=u0vec.device)

    def ev(**where):
        if event_set is None:
            return {}
        return event_kwargs(events, event_set, _make_dae_event_apply(
            kern, p, event_set, events, n, npf, M_fwd, run_cost=run_cost,
            **where))

    if isinstance(sensealg, InterpolatingAdjoint):
        y_of = lambda tt: dense_eval(dense, tt)
        base = _joined_rhs(kern, p, n, y_of)

        def aug_rhs(z, tt):
            out = base(z, tt)
            return torch.cat([out[:n] - cost_u(y_of(tt), tt),
                              out[n:] - (extra_p(y_of(tt), tt).to(out.dtype)
                                         if extra_p is not None else 0.0)])

        # the cost terms do not depend on z: the adjoint Jacobian stands
        aug_rhs.jac = base.jac

        m_aug = np.eye(n + npf)
        m_aug[:n, :n] = M_host.T
        stepper = _dae_reverse_stepper(None, solver).with_mass_matrix(
            on(m_aug))
        z, _, rstats, _ = reverse_joined_solve(
            stepper, aug_rhs, times,
            torch.cat([lamjs, qjs.to(lamjs.dtype)], dim=1),
            u0vec.new_zeros(n + npf), n + npf,
            err_weights=_err_weights(u0vec, n, npf), **adj, **ev(q_slice=n))
        return du0_map(z[:n]), z[n:], rstats
    y_of = lambda tt: dense_eval(dense, tt)
    base = _lam_rhs(kern, p, y_of)

    def aug_rhs(lam, tt):
        return base(lam, tt) - cost_u(y_of(tt), tt)

    aug_rhs.jac = base.jac
    stepper = _dae_reverse_stepper(None, solver).with_mass_matrix(
        on(M_host.T))
    quadrature = isinstance(sensealg, QuadratureAdjoint)
    hook, finish = None, (lambda q_: q_)
    q0 = torch.zeros(npf, dtype=qdtype, device=u0vec.device)
    if npf and not quadrature:
        t0, t1 = tspan
        hook, q0, finish = make_gauss_quad_hook(
            kern, p, dense, sensealg, t0, t1, qdtype, extra_p=extra_p,
            lam_fix=lam_fix)
    lam, q, rstats, lam_dense = reverse_joined_solve(
        stepper, aug_rhs, times, lamjs, u0vec.new_zeros(n), n, hook=hook,
        hook_carry=q0, collect_dense=quadrature, **adj, **ev(q_in_hc=True))
    if quadrature:
        q = adaptive_gk_dp(kern, p, dense, lam_dense, sensealg, q,
                           extra_p=extra_p, lam_fix=lam_fix)
    else:
        q = finish(q)
    return du0_map(lam), q + qjs.sum(0).to(q.dtype), rstats
