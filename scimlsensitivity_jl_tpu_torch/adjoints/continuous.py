"""Continuous adjoints and discrete forward mode as
`torch.autograd.Function`s over solve (PyTorch port).

Counterpart of `scimlsensitivity_jl_tpu/adjoints/continuous.py`:
`SolveOptions`, `AuxOut` and `make_ode_solve_fn` with the backward rules of
`BacksolveAdjoint` (`_bwd_backsolve`, continuous.py:1402-1467),
`GaussAdjoint` without checkpointing (`_bwd_gauss`, :1471-1568, the branch
at :1548-1568, with the Gauss–Legendre branch of `make_gauss_quad_hook`
:290-310, :412-423), `QuadratureAdjoint` (`_bwd_quadrature`, :1572-1650,
the ODE branch, with `adaptive_gk_dp` :426-518) and
`ForwardDiffSensitivity` (`_bwd_forwarddiff`, :1653-1766, without events
and dense-output cotangents). The JAX `custom_vjp` becomes a
`torch.autograd.Function` whose backward is another solve:

  BacksolveAdjoint  — reverse solve of the augmented [λ; q; u], the ODE
                      itself integrated backwards, with u snapped back to
                      the stored forward value at each save time
                      (checkpointing=True); the forward may march a fixed
                      grid while the reverse adapts at adj_rtol / adj_atol.
  GaussAdjoint      — reverse solve of λ alone over the forward's dense
                      output; dL/dp = ∫ λᵀ∂f/∂p dt accumulates by an n_nodes
                      Gauss–Legendre rule on every accepted reverse step.
  QuadratureAdjoint — the same λ-only reverse, keeping λ's dense output;
                      afterwards dL/dp by one GK(7,15) panel per recorded
                      reverse step, then bisection of the panel with the
                      largest embedded error under abstol / reltol /
                      max_depth.
  ForwardDiffSensitivity — discretize-then-optimize forward mode: the
                      forward records its accepted steps; the backward
                      replays exactly that step sequence (clipped steps and
                      tstops included) on the tangent system [u; S], S one
                      torch.func.jvp per seed direction vmapped over a chunk
                      of chunk_size of them (u0's first, then p's), and
                      contracts the tangents of ys and u_final with their
                      cotangents. The JAX rule gets the same derivative from
                      jax.jvp through its while_loop with the step size
                      under stop_gradient.

The JAX hooks vmap the quadrature nodes; the custom kernel ops have no vmap
rule, so the port loops over them.

Sign conventions (continuous adjoint with discrete cost injections):
  dλ/dt = -(∂f/∂u)ᵀλ,   λ(t_i⁻) += Δᵢ   (loss cotangent at save time i)
  dq/dt = -λᵀ∂f/∂p from q(T) = 0  ⇒  q(t0) = dL/dp,   dL/du0 = λ(t0).

The forward solve is shared by every rule; only the backward differs. The
Interpolating and GaussKronrod backward rules, and Gauss with
checkpointing or a pinned reverse, wait (ROADMAP M4): their forward runs,
and asking for their gradient raises. Save times are host values and get
no gradient, and gradients through dense output `sol(t)` wait too (M4).

Deliberate divergences from the JAX package (ROADMAP §3): Backsolve's
reconstruction drift has its own retcode (6, where JAX reuses 3, a DDE lag
violation), and with checkpointing the drift guard checks every segment
before its snap (JAX checks u at t0 only, after the t0 snap has restored
it).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from ..ops.interp import dense_eval, hermite_eval
from ..ops.quadrature import gauss_kronrod_01, gl_01
from ..ops.vjp import make_vjp_kernels
from ..sensealg import (BacksolveAdjoint, ForwardDiffSensitivity, GaussAdjoint,
                        GaussKronrodAdjoint, InterpolatingAdjoint,
                        QuadratureAdjoint)
from ..solvers.integrate import RETCODE_TERMINATED, Stats, time_dtype
from ..utils.pytree import ravel_pytree
from .common import (augmented_fvec, forward_saveat_solve, match_cotangents,
                     reverse_joined_solve, save_carry0, save_hook_factory,
                     saved_rows)

__all__ = ["SolveOptions", "AuxOut", "AdjointRecord", "make_ode_solve_fn",
           "make_gauss_quad_hook", "adaptive_gk_dp", "RETCODE_RECON_DRIFT"]

# Backsolve reconstruction drift (solution.RETCODE_NAMES[6]); the JAX
# package reports it as 3, the code of a DDE lag violation
RETCODE_RECON_DRIFT = 6

_UNPORTED_RULES = {
    InterpolatingAdjoint: "ROADMAP M4",
    GaussAdjoint: "ROADMAP M4 (checkpointing=True, pinned_reverse=True)",
    GaussKronrodAdjoint: "ROADMAP M4",
}


@dataclass(frozen=True)
class SolveOptions:
    rtol: float = 1e-7
    atol: float = 1e-9
    dt0: Any = None
    max_steps: int = 4096
    tstops: Any = None
    dense: bool = False  # user-requested dense output
    # reverse-pass controls
    adj_rtol: Any = None
    adj_atol: Any = None
    adj_max_steps: Any = None
    dtmax: Any = None
    verbose: bool = False
    # fixed-grid forward under a continuous sensealg: the forward marches
    # this dt, the reverse adapts at adj_rtol / adj_atol
    fixed_dt: Any = None


@dataclass
class AdjointRecord:
    """Filled in by the backward pass: the reverse solve's Stats, whose
    retcode is the worst of the forward, the reverse and the drift guard
    (nonzero means the gradient is NaN). None until a backward ran."""

    stats: Optional[Stats] = None


class AuxOut(NamedTuple):
    dense: Any
    t_final: np.floating
    u_final: torch.Tensor
    stats: Stats
    adjoint: Optional[AdjointRecord] = None


def _flat(tree, like: torch.Tensor) -> torch.Tensor:
    if tree is None:
        return like.new_zeros(0)
    return ravel_pytree(tree)[0]


class _StepLog:
    """A stepper that records the (t, dt) of the step it last took, and the
    accepted-step hook that keeps it: ForwardDiffSensitivity's record of
    the forward's step sequence."""

    def __init__(self, stepper):
        self.stepper = stepper
        self.order = stepper.order
        self.n_stages = getattr(stepper, "n_stages", 1)
        self.last = None
        self.steps = []

    def step(self, fvec, t, dt, u, f0, need_err: bool = True):
        self.last = (t, dt)
        return self.stepper.step(fvec, t, dt, u, f0, need_err)

    def accepted(self, _rec):
        self.steps.append(self.last)


class _ContinuousRule:
    """Forward and reverse solves of one `solve` call. It keeps none of the
    Function's outputs (those go through save_for_backward), so no
    reference cycle runs through the autograd graph."""

    def __init__(self, f, solver, sensealg, opts, t0, t1, saveat, u0_tree,
                 unravel_p, has_p, bwd_solver, record, hooks):
        self.f, self.solver, self.sensealg, self.opts = f, solver, sensealg, opts
        self.t0, self.t1, self.saveat = t0, t1, saveat
        self.u0_tree, self.unravel_p, self.has_p = u0_tree, unravel_p, has_p
        self.bwd_stepper = bwd_solver or solver
        self.record, self.hooks = record, hooks
        # the λ-only reverses read u(t) from the forward's dense output
        self.store_dense = opts.dense or type(sensealg) in (GaussAdjoint,
                                                            QuadratureAdjoint)
        self.dense = self.stats = self.t_final = None
        self.step_log = (_StepLog(solver)
                         if isinstance(sensealg, ForwardDiffSensitivity)
                         else None)

    def _p(self, pflat):
        return self.unravel_p(pflat) if self.has_p else None

    def _kern(self, p):
        vjp_choice = getattr(self.sensealg, "autojacvec", None)
        kw = {} if vjp_choice is None else {"vjp_choice": vjp_choice}
        return make_vjp_kernels(self.f, self.u0_tree, p, **kw, **self.hooks)

    def forward(self, u0vec, pflat):
        p = self._p(pflat)
        kern = self._kern(p)
        opts, log = self.opts, self.step_log
        fwd = forward_saveat_solve(
            log or self.solver, lambda uv, t: kern.fvec(uv, p, t), u0vec,
            self.t0, self.t1, self.saveat,
            rtol=opts.rtol, atol=opts.atol, dt0=opts.dt0,
            max_steps=opts.max_steps, tstops=opts.tstops,
            store_dense=self.store_dense, dtmax=opts.dtmax,
            fixed_dt=opts.fixed_dt,
            extra_hook=None if log is None else log.accepted,
        )
        self.dense, self.stats, self.t_final = fwd.dense, fwd.stats, fwd.t_final
        return fwd

    def backward(self, u0vec, pflat, ys_save, u_final, d_ys, d_uf):
        """The reverse pass of the rule (`solve_fn` refuses a gradient under
        an unported rule before the forward runs)."""
        n, nt = u0vec.numel(), ys_save.shape[0]
        lam_jumps = (d_ys.reshape(nt, n) if d_ys is not None
                     else u0vec.new_zeros(nt, n))
        p = self._p(pflat)
        kern = self._kern(p)
        if self.step_log is not None:
            du0, dp = self._backward_forwarddiff(u0vec, pflat, p, kern,
                                                 lam_jumps, d_uf)
            return match_cotangents(du0, dp, (u0vec, pflat))
        kind = time_dtype(u0vec.dtype)
        # loss cotangents as λ jumps at [t0, saveat..., t1]
        times = np.concatenate([[self.t0], self.saveat, [self.t1]]).astype(kind)
        zero = u0vec.new_zeros(1, n)
        jumps = torch.cat([zero, lam_jumps, zero])
        if d_uf is not None:  # sol.u_final cotangent: a λ jump at t1
            jumps[-1] += d_uf.reshape(-1)
        opts = self.opts
        adj = dict(
            rtol=opts.adj_rtol if opts.adj_rtol is not None else opts.rtol,
            atol=opts.adj_atol if opts.adj_atol is not None else opts.atol,
            max_steps=(opts.adj_max_steps if opts.adj_max_steps is not None
                       else opts.max_steps),
            t_span=(self.t0, self.t_final))
        if isinstance(self.sensealg, BacksolveAdjoint):
            lam0, q, rstats, worst = self._backward_backsolve(
                u0vec, pflat, p, kern, times, jumps, ys_save, u_final, adj)
        else:
            lam0, q, rstats, worst = self._backward_lambda(
                u0vec, pflat, p, kern, times, jumps, adj)

        fwd_rc = self.stats.retcode
        retcode = max(0 if fwd_rc == RETCODE_TERMINATED else fwd_rc, worst)
        self.record.stats = rstats._replace(retcode=retcode)
        if retcode != 0:
            if opts.verbose:
                print(f"adjoint: non-success retcode {retcode} in the forward "
                      "or reverse solve (1=MaxIters, 2=DtMin, 6=Backsolve "
                      "u-reconstruction drift); gradients are NaN")
            lam0 = torch.full_like(lam0, float("nan"))
            q = torch.full_like(q, float("nan"))
        return match_cotangents(lam0, q, (u0vec, pflat))

    def _backward_backsolve(self, u0vec, pflat, p, kern, times, jumps,
                            ys_save, u_final, adj):
        """(λ(t0), q(t0), reverse Stats, worst retcode) of BacksolveAdjoint."""
        sensealg = self.sensealg
        n, npf = u0vec.numel(), pflat.numel()

        def aug_rhs(z, t):
            lam, y = z[:n], z[n + npf:]
            fval, ubar, pbar = kern.f_and_vjp(y, p, t, lam)
            return torch.cat([-ubar, -_flat(pbar, ubar), fval])

        def rel_drift(u_rec, u_true):
            return (torch.linalg.vector_norm(u_rec - u_true)
                    / (1.0 + torch.linalg.vector_norm(u_true)))

        z0 = torch.cat([u0vec.new_zeros(n + npf), u_final])
        snap_values = snap_start = on_snap = None
        drifts = []
        guard = sensealg.recon_guard
        if sensealg.checkpointing:
            snap_values = torch.cat([u0vec[None], ys_save, u_final[None]])
            snap_start = n + npf
            if guard is not None:
                on_snap = lambda u_rec, u_true: drifts.append(
                    rel_drift(u_rec, u_true))
        wts = torch.cat([u0vec.new_ones(n), u0vec.new_zeros(npf),
                         u0vec.new_ones(n)])
        z, _, rstats, _ = reverse_joined_solve(
            self.bwd_stepper, aug_rhs, times, jumps, z0, n,
            snap_values=snap_values, snap_start=snap_start, on_snap=on_snap,
            err_weights=wts, **adj)
        worst = rstats.retcode
        # A drifted reconstruction means Jᵀλ and f_pᵀλ were taken on the
        # wrong trajectory. Without checkpoints the reverse ends at t0, where
        # the true u0 is known; with them, every segment ends at a stored
        # forward value, compared before the snap restores it.
        # `not (drift <= guard)` also trips on NaN/inf.
        if guard is not None:
            if not drifts:
                drifts.append(rel_drift(z[n + npf:], u0vec))
            drift = torch.stack(drifts).max().item()
            if not drift <= guard:
                worst = max(worst, RETCODE_RECON_DRIFT)
        return z[:n], z[n:n + npf], rstats, worst

    def _backward_lambda(self, u0vec, pflat, p, kern, times, jumps, adj):
        """(λ(t0), dL/dp, reverse Stats, worst retcode) of GaussAdjoint and
        QuadratureAdjoint: λ alone runs backwards over the forward's dense
        output (no error weights: every row is controlled). Gauss's hook
        integrates λᵀ∂f/∂p on each accepted step; Quadrature keeps λ's
        dense output and integrates afterwards."""
        dense, n, npf = self.dense, u0vec.numel(), pflat.numel()
        quadrature = isinstance(self.sensealg, QuadratureAdjoint)

        def aug_rhs(lam, t):
            return -kern.vjp_u(dense_eval(dense, t), p, t, lam)

        q0 = torch.zeros(npf, dtype=torch.promote_types(u0vec.dtype,
                                                        torch.float32),
                         device=u0vec.device)
        hook = None
        if self.has_p and not quadrature:
            hook = make_gauss_quad_hook(kern, p, dense, self.sensealg.n_nodes)
        lam, q, rstats, lam_dense = reverse_joined_solve(
            self.bwd_stepper, aug_rhs, times, jumps, u0vec.new_zeros(n), n,
            hook=hook, hook_carry=q0, collect_dense=quadrature, **adj)
        if quadrature:
            q = adaptive_gk_dp(kern, p, dense, lam_dense, self.sensealg, q)
        return lam, q, rstats, rstats.retcode

    def _backward_forwarddiff(self, u0vec, pflat, p, kern, lam, d_uf):
        """(dL/du0, dL/dp) of ForwardDiffSensitivity: the tangents of the
        forward's discrete program, contracted with the cotangents. Each
        chunk of chunk_size seed directions replays the recorded steps on
        the tangent system [u; S] (`augmented_fvec`): an explicit RK step is
        the same linear combination of its stages for u and for each
        tangent, so this is exactly the jvp of the replayed program, without
        tracing the stepper's arithmetic."""
        n, npf, dtype = u0vec.numel(), pflat.numel(), u0vec.dtype
        saveat, t0 = self.saveat, self.t0
        tdir = type(t0)(1.0) if self.t1 >= t0 else type(t0)(-1.0)
        save_hook = save_hook_factory(saveat, tdir)
        seeds = torch.eye(n + npf, dtype=dtype, device=u0vec.device)
        parts = []
        for block in torch.split(seeds, self.sensealg.chunk_size or n + npf):
            aug = augmented_fvec(kern, p, n, block[:, n:])
            z = torch.cat([u0vec, block[:, :n].reshape(-1)])
            fz = aug(z, t0).to(dtype)
            carry = save_carry0(saveat, t0, tdir, z)
            for t, dt in self.step_log.steps:
                z1, f1, _ = self.solver.step(aug, t, dt, z, fz,
                                             need_err=False)
                z1, f1 = z1.to(dtype), f1.to(dtype)
                carry = save_hook((t, type(t)(t + dt), z, fz, z1, f1), carry)
                z, fz = z1, f1
            k = block.shape[0]
            tangents = saved_rows(carry, z)[:, n:].reshape(-1, k, n)
            part = torch.einsum("ti,tki->k", lam, tangents)
            if d_uf is not None:
                part = part + z[n:].reshape(k, n) @ d_uf.reshape(-1)
            parts.append(part)
        contracted = torch.cat(parts)
        return contracted[:n], contracted[n:]


def make_gauss_quad_hook(kern, p, dense, n_nodes: int):
    """Per-accepted-step hook of a λ-only reverse solve that accumulates
    dL/dp = ∫ λᵀ∂f/∂p dt in its carry (the Gauss–Legendre branch of the JAX
    `make_gauss_quad_hook`). λ at a node comes from the step's own Hermite
    interpolant, u from the forward's dense output. The carry is the
    running sum, in promote(state dtype, float32): a bfloat16 running sum
    would lose the mantissa."""
    xg, wg = gl_01(n_nodes)

    def hook(rec, qflat):
        ta, tb, lam_a, fa, lam_b, fb = rec
        kind = type(ta)
        width = kind(tb - ta)  # negative: the reverse walks backwards
        total = None
        for xj, wj in zip(xg, wg):
            tj = kind(ta + kind(width * kind(xj)))
            lam_j = hermite_eval(tj, ta, tb, lam_a, fa, lam_b, fb)
            vj = ravel_pytree(kern.vjp_p(dense_eval(dense, tj), p, tj, lam_j))[0]
            term = vj.to(qflat.dtype) * float(kind(wj))
            total = term if total is None else total + term
        # q += ∫_{ta}^{tb} (−λᵀ∂f/∂p) dt
        return qflat - total * float(width)

    return hook


def adaptive_gk_dp(kern, p, dense, lam_dense, sensealg, q_init):
    """QuadratureAdjoint's dL/dp after the λ-only reverse: h-adaptive
    Gauss–Kronrod over λ's recorded dense output (JAX `adaptive_gk_dp`).
    The base partition is one GK(7,15) panel per recorded reverse step, the
    reverse solver's own adapted grid, which holds every λ-jump time, so no
    panel straddles a discontinuity (zero-width rows at the jumps add
    nothing and are skipped). A budgeted worklist then bisects the panel
    with the largest embedded error until Σerr ≤ max(abstol, reltol·‖q‖),
    at most max_depth splits deep and 4·2^max_depth (≤ 512) splits in all.
    Each panel's estimate is kept, where the JAX loop evaluates a split
    panel once more. q_init: the running sum to add to (its dtype is the
    sum's)."""
    if p is None:
        return q_init
    qdtype = q_init.dtype
    kind = type(lam_dense.ts[0])
    xk, wk, wg = gauss_kronrod_01(7)
    w_est = torch.as_tensor(wk, dtype=qdtype, device=q_init.device)
    w_err = torch.as_tensor(wk - wg, dtype=qdtype, device=q_init.device)

    def integrand(tj):
        lam_j = dense_eval(lam_dense, tj)
        return ravel_pytree(kern.vjp_p(dense_eval(dense, tj), p, tj,
                                       lam_j))[0].to(qdtype)

    def gk_panel(ta, tb):
        width = kind(tb - ta)  # negative: the reverse orientation
        vals = torch.stack([integrand(kind(ta + kind(width * kind(xj))))
                            for xj in xk])
        # the forward-orientation integral over the panel
        est = (w_est @ vals) * float(-width)
        err = torch.linalg.vector_norm(w_err @ vals) * float(abs(width))
        return est, err

    grid = lam_dense.ts
    a, b, ests, errs = [], [], [], []
    for ta, tb in zip(grid[:-1], grid[1:]):
        if ta != tb:
            est, err = gk_panel(ta, tb)
            a.append(ta), b.append(tb), ests.append(est), errs.append(err)
    if not ests:
        return q_init
    q = torch.stack(ests).sum(0) + q_init
    errs = torch.stack(errs).tolist()

    depth_cap = max(int(sensealg.max_depth), 0)
    budget = min(4 * 2 ** depth_cap, 512) if depth_cap > 0 else 0
    depth = [0] * len(errs)
    for _ in range(budget):
        tol = max(sensealg.abstol,
                  sensealg.reltol * torch.linalg.vector_norm(q).item())
        refinable = [e if d < depth_cap else -1.0 for e, d in zip(errs, depth)]
        i = int(np.argmax(refinable))
        if not (sum(errs) > tol and refinable[i] > 0.0):
            break
        ai, bi = a[i], b[i]
        tm = kind(kind(0.5) * kind(ai + bi))
        e_l, r_l = gk_panel(ai, tm)
        e_r, r_r = gk_panel(tm, bi)
        q = q + (e_l + e_r - ests[i])
        r_l, r_r = torch.stack([r_l, r_r]).tolist()
        b[i], ests[i], errs[i] = tm, e_l, r_l
        depth[i] += 1
        a.append(tm), b.append(bi), ests.append(e_r), errs.append(r_r)
        depth.append(depth[i])
    return q


class _ContinuousSolve(torch.autograd.Function):
    """(u0vec, pflat) -> (saveat rows, u_final); backward = reverse solve."""

    @staticmethod
    def forward(ctx, u0vec, pflat, rule):
        fwd = rule.forward(u0vec, pflat)
        ctx.rule = rule
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(u0vec, pflat, fwd.ys_save, fwd.u_final)
        return fwd.ys_save, fwd.u_final

    @staticmethod
    def backward(ctx, d_ys, d_uf):
        if d_ys is None and d_uf is None:
            return None, None, None
        du0, dp = ctx.rule.backward(*ctx.saved_tensors, d_ys, d_uf)
        return du0, dp, None


def make_ode_solve_fn(f, solver, sensealg, opts: SolveOptions, t0, t1, *,
                      user_jac=None, user_vjp=None, user_paramjac=None,
                      bwd_solver=None):
    """Build `fn(u0, p, saveat) -> (ys, AuxOut)` whose gradient follows
    `sensealg`. saveat: host array of save times. user_*: the problem's
    jac / vjp / paramjac hooks (`ops.vjp.make_vjp_kernels`)."""
    grads_ported = isinstance(sensealg, (BacksolveAdjoint, QuadratureAdjoint,
                                         ForwardDiffSensitivity)) or (
        type(sensealg) is GaussAdjoint and not sensealg.checkpointing
        and not sensealg.pinned_reverse)
    if not grads_ported and not isinstance(sensealg, tuple(_UNPORTED_RULES)):
        raise NotImplementedError(f"no ODE adjoint rule for {sensealg!r}")
    hooks = dict(user_jac=user_jac, user_vjp=user_vjp,
                 user_paramjac=user_paramjac)
    reverse_solve = not isinstance(sensealg, ForwardDiffSensitivity)

    def solve_fn(u0, p, saveat):
        u0vec, unravel_u = ravel_pytree(u0)
        pflat, unravel_p = ravel_pytree(p)
        if p is None:
            pflat = u0vec.new_zeros(0)
        wants_grad = torch.is_grad_enabled() and (u0vec.requires_grad
                                                  or pflat.requires_grad)
        if wants_grad and not grads_ported:
            raise NotImplementedError(
                f"gradients under {type(sensealg).__name__}: "
                f"{_UNPORTED_RULES[type(sensealg)]}; the port has "
                "BacksolveAdjoint, GaussAdjoint, QuadratureAdjoint, "
                "ForwardDiffSensitivity, ForwardSensitivity and "
                "DirectAdjoint so far")
        if wants_grad and opts.dense:
            raise NotImplementedError(
                "gradients through dense output sol(t): ROADMAP M4")
        kind = time_dtype(u0vec.dtype)
        record = AdjointRecord() if reverse_solve else None
        rule = _ContinuousRule(f, solver, sensealg, opts, kind(t0), kind(t1),
                               np.asarray(saveat, dtype=kind), u0, unravel_p,
                               p is not None, bwd_solver, record, hooks)
        ys_save, u_final = _ContinuousSolve.apply(u0vec, pflat, rule)
        aux = AuxOut(dense=rule.dense, t_final=rule.t_final, u_final=u_final,
                     stats=rule.stats, adjoint=record)
        return unravel_u(ys_save), aux

    return solve_fn
