"""Continuous adjoints as `torch.autograd.Function`s over solve (PyTorch
port).

Counterpart of `scimlsensitivity_jl_tpu/adjoints/continuous.py`:
`SolveOptions`, `AuxOut` and `make_ode_solve_fn` for `BacksolveAdjoint`
(`_bwd_backsolve`, continuous.py:1402-1467) and `GaussAdjoint` without
checkpointing (`_bwd_gauss`, :1471-1568, the branch at :1548-1568, with
`_gl_nodes` :149 and the Gauss–Legendre branch of `make_gauss_quad_hook`
:290-310, :412-423). The JAX `custom_vjp` becomes a
`torch.autograd.Function` whose backward is another solve:

  BacksolveAdjoint — reverse solve of the augmented [λ; q; u], the ODE
                     itself integrated backwards, with u snapped back to the
                     stored forward value at each save time
                     (checkpointing=True); the forward may march a fixed
                     grid while the reverse adapts at adj_rtol / adj_atol.
  GaussAdjoint     — reverse solve of λ alone over the forward's dense
                     output; dL/dp = ∫ λᵀ∂f/∂p dt accumulates by an n_nodes
                     Gauss–Legendre rule on every accepted reverse step.
                     The JAX hook vmaps the nodes; the custom kernel ops
                     have no vmap rule, so the port loops over them.

Sign conventions (continuous adjoint with discrete cost injections):
  dλ/dt = -(∂f/∂u)ᵀλ,   λ(t_i⁻) += Δᵢ   (loss cotangent at save time i)
  dq/dt = -λᵀ∂f/∂p from q(T) = 0  ⇒  q(t0) = dL/dp,   dL/du0 = λ(t0).

The forward solve is shared by every continuous rule; only the backward
differs. The Interpolating, GaussKronrod, Quadrature and ForwardDiff
backward rules, and Gauss with checkpointing or a pinned reverse, wait
(ROADMAP M4, M7): their forward runs, and asking for their gradient
raises. Save times are host values and get no gradient, and gradients
through dense output `sol(t)` wait too (M4).

Deliberately as in the JAX package (ROADMAP M4 keeps the fixes open): the
drift guard reuses retcode 3, and it checks u only at t0.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from ..ops.interp import dense_eval, hermite_eval
from ..ops.vjp import make_vjp_kernels
from ..sensealg import (BacksolveAdjoint, ForwardDiffSensitivity, GaussAdjoint,
                        GaussKronrodAdjoint, InterpolatingAdjoint,
                        QuadratureAdjoint)
from ..solvers.integrate import RETCODE_TERMINATED, Stats, time_dtype
from ..utils.pytree import ravel_pytree
from .common import (forward_saveat_solve, match_cotangents,
                     reverse_joined_solve)

__all__ = ["SolveOptions", "AuxOut", "AdjointRecord", "make_ode_solve_fn",
           "make_gauss_quad_hook", "RETCODE_RECON_DRIFT"]

# Backsolve reconstruction drift; the JAX package shares code 3 with DDE lag
# violations (ROADMAP M4 gives it its own code later).
RETCODE_RECON_DRIFT = 3

_UNPORTED_RULES = {
    InterpolatingAdjoint: "ROADMAP M4",
    GaussAdjoint: "ROADMAP M4 (checkpointing=True, pinned_reverse=True)",
    GaussKronrodAdjoint: "ROADMAP M4",
    QuadratureAdjoint: "ROADMAP M4",
    ForwardDiffSensitivity: "ROADMAP M7",
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


class _ContinuousRule:
    """Forward and reverse solves of one `solve` call. It keeps none of the
    Function's outputs (those go through save_for_backward), so no
    reference cycle runs through the autograd graph."""

    def __init__(self, f, solver, sensealg, opts, t0, t1, saveat, u0_tree,
                 unravel_p, has_p, bwd_solver, record):
        self.f, self.solver, self.sensealg, self.opts = f, solver, sensealg, opts
        self.t0, self.t1, self.saveat = t0, t1, saveat
        self.u0_tree, self.unravel_p, self.has_p = u0_tree, unravel_p, has_p
        self.bwd_stepper = bwd_solver or solver
        self.record = record
        # GaussAdjoint's reverse reads u(t) from the forward's dense output
        self.store_dense = opts.dense or type(sensealg) is GaussAdjoint
        self.dense = self.stats = self.t_final = None

    def _p(self, pflat):
        return self.unravel_p(pflat) if self.has_p else None

    def _kern(self, p):
        vjp_choice = getattr(self.sensealg, "autojacvec", None)
        kw = {} if vjp_choice is None else {"vjp_choice": vjp_choice}
        return make_vjp_kernels(self.f, self.u0_tree, p, **kw)

    def forward(self, u0vec, pflat):
        p = self._p(pflat)
        kern = self._kern(p)
        opts = self.opts
        fwd = forward_saveat_solve(
            self.solver, lambda uv, t: kern.fvec(uv, p, t), u0vec,
            self.t0, self.t1, self.saveat,
            rtol=opts.rtol, atol=opts.atol, dt0=opts.dt0,
            max_steps=opts.max_steps, tstops=opts.tstops,
            store_dense=self.store_dense, dtmax=opts.dtmax,
            fixed_dt=opts.fixed_dt,
        )
        self.dense, self.stats, self.t_final = fwd.dense, fwd.stats, fwd.t_final
        return fwd

    def backward(self, u0vec, pflat, ys_save, u_final, d_ys, d_uf):
        """The reverse pass of the rule (`solve_fn` refuses a gradient under
        an unported rule before the forward runs)."""
        n, nt = u0vec.numel(), ys_save.shape[0]
        kind = time_dtype(u0vec.dtype)
        p = self._p(pflat)
        kern = self._kern(p)
        # loss cotangents as λ jumps at [t0, saveat..., t1]
        lam_jumps = (d_ys.reshape(nt, n) if d_ys is not None
                     else u0vec.new_zeros(nt, n))
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
        if type(self.sensealg) is GaussAdjoint:
            lam0, q, rstats, worst = self._backward_gauss(
                u0vec, pflat, p, kern, times, jumps, adj)
        else:
            lam0, q, rstats, worst = self._backward_backsolve(
                u0vec, pflat, p, kern, times, jumps, ys_save, u_final, adj)

        fwd_rc = self.stats.retcode
        retcode = max(0 if fwd_rc == RETCODE_TERMINATED else fwd_rc, worst)
        self.record.stats = rstats._replace(retcode=retcode)
        if retcode != 0:
            if opts.verbose:
                print(f"adjoint: non-success retcode {retcode} in the forward "
                      "or reverse solve (1=MaxIters, 2=DtMin, 3=Backsolve "
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

        z0 = torch.cat([u0vec.new_zeros(n + npf), u_final])
        snap_values = snap_start = None
        if sensealg.checkpointing:
            snap_values = torch.cat([u0vec[None], ys_save, u_final[None]])
            snap_start = n + npf
        wts = torch.cat([u0vec.new_ones(n), u0vec.new_zeros(npf),
                         u0vec.new_ones(n)])
        z, _, rstats = reverse_joined_solve(
            self.bwd_stepper, aug_rhs, times, jumps, z0, n,
            snap_values=snap_values, snap_start=snap_start, err_weights=wts,
            **adj)
        worst = rstats.retcode
        # The reverse ends at t0, where the true u0 is known: a drifted
        # reconstruction means Jᵀλ and f_pᵀλ were taken on the wrong
        # trajectory. `not (drift <= guard)` also trips on NaN/inf.
        guard = sensealg.recon_guard
        if guard is not None:
            drift = (torch.linalg.vector_norm(z[n + npf:] - u0vec)
                     / (1.0 + torch.linalg.vector_norm(u0vec))).item()
            if not drift <= guard:
                worst = max(worst, RETCODE_RECON_DRIFT)
        return z[:n], z[n:n + npf], rstats, worst

    def _backward_gauss(self, u0vec, pflat, p, kern, times, jumps, adj):
        """(λ(t0), dL/dp, reverse Stats, worst retcode) of GaussAdjoint: λ
        alone runs backwards over the forward's dense output (no error
        weights: every row is controlled), the hook integrates λᵀ∂f/∂p."""
        dense = self.dense

        def aug_rhs(lam, t):
            return -kern.vjp_u(dense_eval(dense, t), p, t, lam)

        hook, q0 = make_gauss_quad_hook(kern, p, dense, self.sensealg.n_nodes,
                                        u0vec.dtype, pflat.numel(),
                                        u0vec.device)
        lam, q, rstats = reverse_joined_solve(
            self.bwd_stepper, aug_rhs, times, jumps,
            u0vec.new_zeros(u0vec.numel()), u0vec.numel(),
            hook=hook if self.has_p else None, hook_carry=q0, **adj)
        return lam, q, rstats, rstats.retcode


def _gl_nodes(order: int):
    """Gauss–Legendre nodes and weights on [0, 1], float64 numpy."""
    x, w = np.polynomial.legendre.leggauss(order)
    return 0.5 * (x + 1.0), 0.5 * w


def make_gauss_quad_hook(kern, p, dense, n_nodes: int, dtype, npf: int,
                         device):
    """Per-accepted-step hook of a λ-only reverse solve that accumulates
    dL/dp = ∫ λᵀ∂f/∂p dt in its carry (the Gauss–Legendre branch of the JAX
    `make_gauss_quad_hook`). λ at a node comes from the step's own Hermite
    interpolant, u from the forward's dense output. The sum runs in
    promote(dtype, float32): a bfloat16 running sum would lose the mantissa.
    Returns (hook, carry0)."""
    qdtype = torch.promote_types(dtype, torch.float32)
    xg, wg = _gl_nodes(n_nodes)

    def hook(rec, qflat):
        ta, tb, lam_a, fa, lam_b, fb = rec
        kind = type(ta)
        width = kind(tb - ta)  # negative: the reverse walks backwards
        total = None
        for xj, wj in zip(xg, wg):
            tj = kind(ta + kind(width * kind(xj)))
            lam_j = hermite_eval(tj, ta, tb, lam_a, fa, lam_b, fb)
            vj = ravel_pytree(kern.vjp_p(dense_eval(dense, tj), p, tj, lam_j))[0]
            term = vj.to(qdtype) * float(kind(wj))
            total = term if total is None else total + term
        # q += ∫_{ta}^{tb} (−λᵀ∂f/∂p) dt
        return qflat - total * float(width)

    return hook, torch.zeros(npf, dtype=qdtype, device=device)


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
                      bwd_solver=None):
    """Build `fn(u0, p, saveat) -> (ys, AuxOut)` whose gradient follows
    `sensealg`. saveat: host array of save times."""
    grads_ported = isinstance(sensealg, BacksolveAdjoint) or (
        type(sensealg) is GaussAdjoint and not sensealg.checkpointing
        and not sensealg.pinned_reverse)
    if not grads_ported and not isinstance(sensealg, tuple(_UNPORTED_RULES)):
        raise NotImplementedError(f"no ODE adjoint rule for {sensealg!r}")

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
                "BacksolveAdjoint, GaussAdjoint and DirectAdjoint so far")
        if wants_grad and opts.dense:
            raise NotImplementedError(
                "gradients through dense output sol(t): ROADMAP M4")
        kind = time_dtype(u0vec.dtype)
        record = AdjointRecord()
        rule = _ContinuousRule(f, solver, sensealg, opts, kind(t0), kind(t1),
                              np.asarray(saveat, dtype=kind), u0, unravel_p,
                              p is not None, bwd_solver, record)
        ys_save, u_final = _ContinuousSolve.apply(u0vec, pflat, rule)
        aux = AuxOut(dense=rule.dense, t_final=rule.t_final, u_final=u_final,
                     stats=rule.stats, adjoint=record)
        return unravel_u(ys_save), aux

    return solve_fn
