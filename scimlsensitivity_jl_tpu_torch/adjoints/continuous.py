"""Continuous adjoints and discrete forward mode as
`torch.autograd.Function`s over solve (PyTorch port).

Counterpart of `scimlsensitivity_jl_tpu/adjoints/continuous.py`:
`SolveOptions`, `AuxOut` and `make_ode_solve_fn` (routing :1765-1779,
pinned-reverse eligibility `_pinned_on` :746-775, the interval fields
`_make_interval_rhs_lam` / `_make_interval_rhs_joined` :777-803, dense
storage :805-813) with the backward rules of `InterpolatingAdjoint` and
checkpointed Gauss (`_bwd_interpolating`, :1101-1398: the dense branch,
pinned or adaptive, and the checkpointed one, without the DAE branch and
events), `BacksolveAdjoint` (`_bwd_backsolve`, :1402-1467), `GaussAdjoint`
and `GaussKronrodAdjoint` (`_bwd_gauss`, :1471-1568, adaptive or pinned,
with `make_gauss_quad_hook` :290-423), `QuadratureAdjoint`
(`_bwd_quadrature`, :1572-1650, the ODE branch, with `adaptive_gk_dp`
:426-518) and `ForwardDiffSensitivity` (`_bwd_forwarddiff`, :1653-1766),
the shared setup `_common_bwd_setup` (:861-1050: save-time gradients,
dense-output cotangents) and the event jumps (`_make_event_apply`,
`_event_kwargs`, :519-617). The JAX `custom_vjp` becomes a
`torch.autograd.Function` whose backward is another solve:

  InterpolatingAdjoint — reverse solve of the joined z = [λ; q] over the
                      forward's dense output, q with error weight 0. Auto
                      (pinned_reverse=None) pins it to the forward's grid
                      (`reverse_pinned_solve`: one step per forward
                      interval) and, with pinned_fallback, reruns the
                      adaptive reverse when the pinned pass trips its
                      error guard. checkpointing=True (and
                      GaussAdjoint/GaussKronrodAdjoint(checkpointing=True))
                      instead re-solves each inter-save interval forward
                      from its stored start, from the top down, and runs
                      the adaptive joined reverse over that local
                      interpolant.

  BacksolveAdjoint  — reverse solve of the augmented [λ; q; u], the ODE
                      itself integrated backwards, with u snapped back to
                      the stored forward value at each save time
                      (checkpointing=True); the forward may march a fixed
                      grid while the reverse adapts at adj_rtol / adj_atol.
  GaussAdjoint      — reverse solve of λ alone over the forward's dense
                      output; dL/dp = ∫ λᵀ∂f/∂p dt accumulates by an n_nodes
                      Gauss–Legendre rule on every accepted reverse step;
                      pinned_reverse=True walks the forward's grid instead.
  GaussKronrodAdjoint — the same, with a GK(7,15) pair on every step,
                      bisected down to max_depth where its embedded error
                      exceeds max(abstol·|Δt|/T, reltol·‖estimate‖) (one
                      host read per check, where JAX uses lax.cond).
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
                      cotangents; a multistep stepper (FBDF) replays each
                      BDF solve at the forward's logged order and history
                      times, the rows threading the history's tangents.
                      The JAX rule gets the same derivative from
                      jax.jvp through its while_loop with the step size
                      under stop_gradient.

The JAX hooks vmap the quadrature nodes; the custom kernel ops have no vmap
rule, so the port loops over them.

Sign conventions (continuous adjoint with discrete cost injections):
  dλ/dt = -(∂f/∂u)ᵀλ,   λ(t_i⁻) += Δᵢ   (loss cotangent at save time i)
  dq/dt = -λᵀ∂f/∂p from q(T) = 0  ⇒  q(t0) = dL/dp,   dL/du0 = λ(t0).

  Save times:  dL/dtᵢ = Δᵢ·f(u(tᵢ), p, tᵢ), 0 past a terminal stop.
  Dense nodes: node k of sol(t) is an output at tₖ: a λ jump
               Δyₖ + f_uᵀΔfₖ there, and f_pᵀΔfₖ into dL/dp (node times
               are not differentiated: the step grid is frozen;
               ForwardDiffSensitivity differentiates those that
               continuous events move).
  Events:      λ⁻ = (∂A/∂u)ᵀλ⁺ − ∇g·((∂A/∂u·f⁻ − f⁺)·λ⁺)/ġ at each
               recorded continuous event (f⁺ = 0 at a terminal one; the
               first product is f⁻·(∂A/∂u)ᵀλ⁺, so no forward mode is
               needed), dL/dp += (∂A/∂p)ᵀλ⁺ for a p-dependent affect.

The forward solve is shared by every rule; only the backward differs. Save
times are host values for the solve; a saveat tensor that requires grad
gets the cotangent above. In the checkpointed reverse, intervals at or
above the forward's t_final are skipped and the top one is clamped to
t_final, as in JAX (:1311-1332): that covers the zero-width top interval
when saveat ends at t1, a truncated forward and a terminal stop; each live
interval's local forward re-fires its events, and the local reverse
applies the recorded ones.

Deliberate divergences from the JAX package (ROADMAP §3): times match
relative to the solve's span where it is below 1 (`match_tol`; JAX's
floor of 64 eps, 7.6e-6 in float32, took every save time of a shorter
float32 solve as reached at t0, every interval as zero-width and every
jump as due at t1), Backsolve's
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

from ..ops.interp import dense_eval, hermite_at, hermite_eval
from ..ops.quadrature import gauss_kronrod_01, gl_01
from ..ops.vjp import make_vjp_kernels
from ..sensealg import (BacksolveAdjoint, ForwardDiffSensitivity, GaussAdjoint,
                        GaussKronrodAdjoint, InterpolatingAdjoint,
                        QuadratureAdjoint)
from ..solvers.explicit import ExplicitRK
from ..solvers.fbdf import HCAP
from ..solvers.rosenbrock import jacobian
from ..solvers.integrate import (LOCAL_NORMS, RETCODE_TERMINATED, Norms,
                                 Stats, integrate, kind_torch_dtype,
                                 match_tol, next_stop, time_dtype)
from ..utils.pytree import ravel_pytree
from .common import (augmented_fvec, forward_saveat_solve,
                     match_cotangents, reverse_joined_solve,
                     reverse_pinned_solve, save_carry0, save_hook_factory,
                     saved_rows)

__all__ = ["SolveOptions", "AuxOut", "AdjointRecord", "make_ode_solve_fn",
           "make_gauss_quad_hook", "adaptive_gk_dp", "event_kwargs",
           "RETCODE_RECON_DRIFT"]

# Backsolve reconstruction drift (solution.RETCODE_NAMES[6]); the JAX
# package reports it as 3, the code of a DDE lag violation
RETCODE_RECON_DRIFT = 6

_GAUSS_RULES = (GaussAdjoint, GaussKronrodAdjoint)
_RULES = (BacksolveAdjoint, InterpolatingAdjoint, *_GAUSS_RULES,
          QuadratureAdjoint, ForwardDiffSensitivity)


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
    callback: Any = None  # callbacks.CallbackSet, lowered
    max_events: int = 32
    # unroll=True: the forward and the reverse take the masked scan's
    # budget (`integrate(fixed_trip=True)`), with the while driver's steps
    unroll: bool = False
    # the error norms' reductions of every solve in the rule: over every
    # rank's shard for a sharded state (`parallel.sharded.ShardNorms`)
    norms: Norms = LOCAL_NORMS


@dataclass
class AdjointRecord:
    """Filled in by the backward pass: the reverse solve's Stats, whose
    retcode is the worst of the forward, the reverse and the drift guard
    (nonzero means the gradient is NaN); `reverse`, the reverse solve that ran
    ("adaptive", "pinned", "pinned, then adaptive" when the auto-pinned
    pass tripped its guard, or "checkpointed"); `resolves`, the intervals
    of nonzero width that the checkpointed reverse solved forward again.
    The checkpointed Stats sum the local reverse solves. Under NILSS and
    NILSAS (`solve`'s shadowing rule) `reverse` names the method and
    `stats` sums its segment solves. None until a backward ran."""

    stats: Optional[Stats] = None
    reverse: Optional[str] = None
    resolves: int = 0
    # NILSAS under `solve`: its primal solve's Stats (the segment solves'
    # go to `stats`)
    primal: Optional[Stats] = None


class AuxOut(NamedTuple):
    dense: Any
    t_final: np.floating
    u_final: torch.Tensor
    stats: Stats
    adjoint: Optional[AdjointRecord] = None
    events: Any = None  # solvers.events.EventRecord with callbacks


def _flat(tree, like: torch.Tensor) -> torch.Tensor:
    if tree is None:
        return like.new_zeros(0)
    return ravel_pytree(tree)[0]


class _StepLog:
    """A stepper that records the step it last took, and the accepted-step
    hook that keeps it: ForwardDiffSensitivity's record of the forward's
    step sequence. Each entry is (t, dt, state): state is None for a
    one-step stepper, and for a multistep one (FBDF) the state the step
    started from without its device history (`u_hist=None`): the times,
    counts and order the replay solves at. `resets` holds the indices of
    the accepted steps after which the history restarted (an event)."""

    def __init__(self, stepper):
        self.stepper = stepper
        self.order = stepper.order
        self.n_stages = getattr(stepper, "n_stages", 1)
        self.stateful = getattr(stepper, "stateful", False)
        self.last = None
        self.steps = []
        self.resets = set()

    def __getattr__(self, name):
        # a multistep stepper's protocol (init_state, controller_order,
        # factor_max) passes through
        return getattr(self.__dict__["stepper"], name)

    def step(self, fvec, t, dt, u, f0, *args, **offsets):
        if self.stateful:
            self.last = (t, dt, args[0]._replace(u_hist=None))
        else:
            self.last = (t, dt, None)
        return self.stepper.step(fvec, t, dt, u, f0, *args, **offsets)

    def reset_state(self, state, t, u, **kw):
        self.resets.add(len(self.steps) - 1)
        return self.stepper.reset_state(state, t, u, **kw)

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
        self.bwd_solver, self.bwd_stepper = bwd_solver, bwd_solver or solver
        self.record, self.hooks = record, hooks
        # a singular mass matrix rides on the stepper (`solve` moved it
        # there): the DAE branches of the rules
        self.mass = getattr(solver, "mass_matrix", None)
        # the reverses over the forward's interpolant read u(t) from its
        # dense output; the checkpointed ones re-solve instead
        self.checkpointed = getattr(sensealg, "checkpointing", False) and (
            isinstance(sensealg, (InterpolatingAdjoint, *_GAUSS_RULES)))
        needs_dense = (isinstance(sensealg, (QuadratureAdjoint,
                                             InterpolatingAdjoint,
                                             *_GAUSS_RULES))
                       and not self.checkpointed)
        self.store_dense = bool(needs_dense or opts.dense)
        self.dense = self.stats = self.t_final = None
        self.events = self.event_log = None
        self.node_times = False
        # ForwardDiffSensitivity records the forward's steps to replay them
        # (a multistep stepper's with the orders and history times of each)
        fds = isinstance(sensealg, ForwardDiffSensitivity)
        self.step_log = _StepLog(solver) if fds else None

    def _p(self, pflat):
        return self.unravel_p(pflat) if self.has_p else None

    def _event_set(self, p):
        if self.opts.callback is None:
            return None
        from ..callbacks import build_event_set

        return build_event_set(self.opts.callback, p,
                               ravel_pytree(self.u0_tree)[1],
                               self.opts.max_events)

    def _kern(self, p):
        vjp_choice = getattr(self.sensealg, "autojacvec", None)
        kw = {} if vjp_choice is None else {"vjp_choice": vjp_choice}
        return make_vjp_kernels(self.f, self.u0_tree, p, **kw, **self.hooks)

    def forward(self, u0vec, pflat):
        p = self._p(pflat)
        kern = self._kern(p)
        opts, log = self.opts, self.step_log
        if opts.unroll and opts.dtmax is not None:
            raise NotImplementedError(
                "unroll=True (scan driver) does not take dtmax/fixed_dt; "
                "use the while driver (unroll=False) for those")
        event_set = self._event_set(p)
        fwd = forward_saveat_solve(
            log or self.solver, lambda uv, t: kern.fvec(uv, p, t), u0vec,
            self.t0, self.t1, self.saveat,
            rtol=opts.rtol, atol=opts.atol, dt0=opts.dt0,
            max_steps=opts.max_steps, tstops=opts.tstops,
            store_dense=self.store_dense, dtmax=opts.dtmax,
            fixed_dt=opts.fixed_dt,
            extra_hook=None if log is None else log.accepted,
            event_set=event_set, fixed_trip=opts.unroll, norms=opts.norms,
        )
        # ForwardDiffSensitivity differentiates the node times, which a
        # continuous event moves (JAX's jvp through its dense ts); the
        # continuous rules freeze the grid
        self.node_times = bool(log is not None and event_set is not None
                               and event_set.n_cont)
        self.dense, self.stats, self.t_final = fwd.dense, fwd.stats, fwd.t_final
        self.events, self.event_log = fwd.events, fwd.event_log
        return fwd

    def backward(self, u0vec, pflat, sv, ys_save, u_final, d_ys, d_uf,
                 d_dys, d_dfs, want_sv, d_dts=None):
        """The reverse pass of the rule: the cotangents of the save rows, of
        u_final and of the dense nodes' states, slopes and (node_times)
        times -> those of u0, p and (want_sv) the save times `sv`. On a
        sharded state, each rank's λ rows and its partial sums of p's."""
        n, nt = u0vec.numel(), ys_save.shape[0]
        lam_jumps = (d_ys.reshape(nt, n) if d_ys is not None
                     else u0vec.new_zeros(nt, n))
        p = self._p(pflat)
        kern = self._kern(p)
        d_saveat = None
        if want_sv and d_ys is not None:
            # a DAE's save times keep the zero, as in JAX (du_a/dt needs the
            # constraint differentiated implicitly)
            d_saveat = (torch.zeros_like(sv) if self.mass is not None else
                        self._saveat_grad(kern, p, ys_save, lam_jumps, sv))
        have_dense = d_dys is not None or d_dfs is not None
        if self.step_log is not None:
            du0, dp = self._backward_forwarddiff(u0vec, pflat, p, kern,
                                                 lam_jumps, d_uf, d_dys, d_dfs,
                                                 d_dts)
            return (*match_cotangents(du0, dp, (u0vec, pflat)), d_saveat)
        kind = time_dtype(u0vec.dtype)
        # loss cotangents as λ jumps at [t0, saveat..., t1]
        times = np.concatenate([[self.t0], self.saveat, [self.t1]]).astype(kind)
        zero = u0vec.new_zeros(1, n)
        jumps = torch.cat([zero, lam_jumps, zero])
        if d_uf is not None:  # sol.u_final cotangent: a λ jump at t1
            jumps[-1] += d_uf.reshape(-1)
        # Backsolve's snap rows, aligned with `times`
        snaps = torch.cat([u0vec[None], ys_save, u_final[None]])
        q_extra, jump_unroll = None, 3
        if have_dense:
            times, jumps, snaps, q_extra = self._merge_dense_nodes(
                kern, p, times, jumps, snaps, d_dys, d_dfs)
            # every save time is also a step node: one more coincident row
            jump_unroll = 4
        event_set = self._event_set(p)
        opts = self.opts
        self.record.reverse, self.record.resolves = "adaptive", 0
        adj = dict(
            rtol=opts.adj_rtol if opts.adj_rtol is not None else opts.rtol,
            atol=opts.adj_atol if opts.adj_atol is not None else opts.atol,
            max_steps=(opts.adj_max_steps if opts.adj_max_steps is not None
                       else opts.max_steps),
            t_span=(self.t0, self.t_final), fixed_trip=opts.unroll,
            norms=opts.norms)
        args = (u0vec, pflat, p, kern, times, jumps, adj, event_set)
        if isinstance(self.sensealg, BacksolveAdjoint):
            lam0, q, rstats, worst = self._backward_backsolve(
                *args, snaps, u_final)
        elif self.checkpointed:
            lam0, q, rstats, worst = self._backward_checkpointed(
                *args, snaps)
        elif isinstance(self.sensealg, InterpolatingAdjoint):
            lam0, q, rstats, worst = self._backward_interpolating(
                *args, jump_unroll)
        else:
            lam0, q, rstats, worst = self._backward_lambda(*args,
                                                           jump_unroll)
        if q_extra is not None:
            q = q + q_extra.to(q.dtype)

        fwd_rc = self.stats.retcode
        retcode = max(0 if fwd_rc == RETCODE_TERMINATED else fwd_rc, worst)
        self.record.stats = rstats._replace(retcode=retcode)
        if retcode != 0:
            if opts.verbose:
                print(f"adjoint: non-success retcode {retcode} in the forward "
                      "or reverse solve (1=MaxIters, 2=DtMin, 4=event record "
                      "overflow, 6=Backsolve u-reconstruction drift); "
                      "gradients are NaN")
            lam0 = torch.full_like(lam0, float("nan"))
            q = torch.full_like(q, float("nan"))
            if d_saveat is not None:
                d_saveat = torch.full_like(d_saveat, float("nan"))
        return (*match_cotangents(lam0, q, (u0vec, pflat)), d_saveat)

    def _saveat_grad(self, kern, p, ys_save, lam_jumps, sv):
        """dL/dtᵢ = Δᵢ·f(u(tᵢ), p, tᵢ) (JAX :906-930), 0 for save times past
        a terminal stop: those rows hold u(t_final) whatever their time."""
        kind = type(self.t0)
        tdir = kind(1.0) if self.t1 >= self.t0 else kind(-1.0)
        tf = self.t_final
        tol = match_tol(kind, self.t1 - self.t0, tf)
        out = []
        for i, t_i in enumerate(self.saveat):
            if kind(kind(t_i - tf) * tdir) <= tol:
                fv = kern.fvec(ys_save[i], p, t_i)
                out.append(torch.sum(lam_jumps[i] * fv.to(lam_jumps.dtype)))
            else:
                out.append(lam_jumps.new_zeros(()))
        return torch.stack(out).to(dtype=sv.dtype, device=sv.device)

    def _merge_dense_nodes(self, kern, p, times, jumps, snaps, d_dys, d_dfs):
        """The dense-output cotangents as λ jumps (JAX :962-1050): node k is
        an output at tₖ, with the jump Δyₖ + f_uᵀΔfₖ and f_pᵀΔfₖ into
        dL/dp, merged with the save rows by a stable sort on time (the port's
        dense output has no padding rows). Returns (times, jumps, snaps,
        the summed f_pᵀΔfₖ)."""
        if self.checkpointed:
            raise NotImplementedError(
                "gradients through sol(t) (dense output) are not supported "
                "with checkpointing=True; use the dense (non-checkpointed) "
                "variant or ForwardDiffSensitivity")
        if self.mass is not None:
            raise NotImplementedError(
                "gradients through sol(t) are not supported for DAE "
                "(singular-mass) adjoints; use ForwardDiffSensitivity")
        if self.opts.callback is not None:
            raise NotImplementedError(
                "gradients through sol(t) combined with callbacks are not "
                "supported by the continuous adjoints (jump/event "
                "composition order at coincident times); use "
                "ForwardDiffSensitivity or DirectAdjoint")
        if float(self.t1) < float(self.t0):
            raise NotImplementedError(
                "gradients through sol(t) need a forward-time solve "
                "(t1 >= t0)")
        dense = self.dense
        n_nodes, n = dense.ys.shape
        d_nys = d_dys if d_dys is not None else dense.ys.new_zeros(n_nodes, n)
        q_extra = None
        njumps = d_nys
        if d_dfs is not None:
            # a zero slope cotangent adds nothing: only the nodes that a
            # query touched call the field's pullback (one read to find them)
            touched = (d_dfs != 0).any(dim=1).tolist()
            njumps = d_nys.clone()
            for k in (k for k, hit in enumerate(touched) if hit):
                _, ubar, pbar = kern.f_and_vjp(dense.ys[k], p, dense.ts[k],
                                               d_dfs[k])
                njumps[k] += ubar.to(njumps.dtype)
                if pbar is not None:
                    qk = _flat(pbar, ubar)
                    q_extra = qk if q_extra is None else q_extra + qk
        all_t = np.concatenate([dense.ts, times]).astype(times.dtype)
        order = np.argsort(all_t, kind="stable")
        idx = torch.from_numpy(order).to(jumps.device)
        all_j = torch.cat([njumps.to(jumps.dtype), jumps])[idx]
        all_s = torch.cat([dense.ys.to(snaps.dtype), snaps])[idx]
        return all_t[order], all_j, all_s, q_extra

    def _event_kwargs(self, kern, p, event_set, n, npf, **where):
        """reverse_joined_solve's event arguments for this solve's record."""
        if event_set is None:
            return {}
        return event_kwargs(self.events, event_set, _make_event_apply(
            kern, p, event_set, self.events, n, npf, **where))

    @staticmethod
    def _joined(adj, n, npf):
        """reverse_joined_solve's arguments for a joined state [λ; q; …],
        whose q rows [n, n + npf) hold p's per-rank partial sums on a
        sharded state."""
        return dict(adj, norms=adj["norms"].with_partial_rows(n, n + npf))

    def _backward_backsolve(self, u0vec, pflat, p, kern, times, jumps, adj,
                            event_set, snaps, u_final):
        """(λ(t0), q(t0), reverse Stats, worst retcode) of BacksolveAdjoint."""
        sensealg = self.sensealg
        n, npf = u0vec.numel(), pflat.numel()

        def aug_rhs(z, t):
            lam, y = z[:n], z[n + npf:]
            fval, ubar, pbar = kern.f_and_vjp(y, p, t, lam)
            return torch.cat([-ubar, -_flat(pbar, ubar), fval])

        def rel_drift(u_rec, u_true):
            norm = adj["norms"].vector_norm
            return norm(u_rec - u_true) / (1.0 + norm(u_true))

        z0 = torch.cat([u0vec.new_zeros(n + npf), u_final])
        snap_values = snap_start = on_snap = None
        drifts = []
        guard = sensealg.recon_guard
        if sensealg.checkpointing:
            # snap the u block back to the stored forward value at each save
            # time (and at each dense node when those cotangents joined)
            snap_values = snaps
            snap_start = n + npf
            if guard is not None:
                on_snap = lambda u_rec, u_true: drifts.append(
                    rel_drift(u_rec, u_true))
        wts = _err_weights(u0vec, n, npf, n)
        z, _, rstats, _ = reverse_joined_solve(
            self.bwd_stepper, aug_rhs, times, jumps, z0, n,
            snap_values=snap_values, snap_start=snap_start, on_snap=on_snap,
            err_weights=wts, **self._joined(adj, n, npf),
            **self._event_kwargs(kern, p, event_set, n, npf, q_slice=n,
                                 u_snap_start=n + npf))
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

    def _pinned_on(self, event_set) -> bool:
        """Whether the reverse rides the forward's grid (JAX `_pinned_on`):
        only with an explicit-RK reverse stepper and no events; auto
        (pinned_reverse=None) pins InterpolatingAdjoint alone."""
        want = getattr(self.sensealg, "pinned_reverse", None)
        if want is False or self.opts.unroll:
            # unrolled: the adaptive reverse with the scan's budget, as JAX
            return False
        eligible = (isinstance(self.bwd_stepper, ExplicitRK)
                    and event_set is None)
        if want is True and not eligible:
            raise NotImplementedError(
                "pinned_reverse=True needs an explicit-RK reverse stepper "
                "and no events/DAE mass structure; leave it None (auto) or "
                "set False")
        if want is None:
            return eligible and type(self.sensealg) is InterpolatingAdjoint
        return eligible

    def _backward_interpolating(self, u0vec, pflat, p, kern, times, jumps,
                                adj, event_set, jump_unroll):
        """(λ(t0), q(t0), reverse Stats, worst retcode) of the dense
        InterpolatingAdjoint: the joined z = [λ; q] runs backwards over the
        forward's dense output with aug_rhs = −[ūᵀ, p̄ᵀ] from one
        `f_and_vjp` per stage, q with error weight 0 (pure quadrature, no
        feedback into λ). Pinned to the forward's grid when `_pinned_on`;
        under auto pinning with pinned_fallback, a pinned pass that trips
        its error guard is followed by the adaptive reverse (a host branch
        where JAX uses lax.cond), while pinned_reverse=True keeps the
        guard's NaN."""
        dense, n, npf = self.dense, u0vec.numel(), pflat.numel()
        aug_rhs = _joined_rhs(kern, p, n, lambda t: dense_eval(dense, t))
        z0 = u0vec.new_zeros(n + npf)
        wts = _err_weights(u0vec, n, npf)
        adj = self._joined(adj, n, npf)
        if self.mass is not None:
            # the adjoint DAE Mᵀλ' = −Jᵀλ, q' = −f_pᵀλ with the augmented
            # mass blockdiag(Mᵀ, I) (JAX :1125-1175); stiffly accurate
            # stages hold the algebraic adjoint constraint pointwise
            du0_map, lamjs, qjs = _dae_project_jumps(self.mass, kern, p,
                                                     dense, times, jumps)
            m_aug = np.eye(n + npf)
            m_aug[:n, :n] = host_matrix(self.mass).T
            z, _, rstats, _ = reverse_joined_solve(
                self._dae_stepper(m_aug, u0vec), aug_rhs, times,
                torch.cat([lamjs, qjs.to(lamjs.dtype)], dim=1), z0, n + npf,
                err_weights=wts, dt0=self.opts.dt0, **adj,
                **self._dae_event_kwargs(kern, p, event_set, n, npf,
                                         q_slice=n))
            return du0_map(z[:n]), z[n:], rstats, rstats.retcode
        if self._pinned_on(event_set):
            z, _, rstats = reverse_pinned_solve(
                self.bwd_stepper,
                lambda i: _joined_rhs(kern, p, n, _interval_y(dense, i)),
                dense, times, jumps, z0, n, rtol=adj["rtol"],
                atol=adj["atol"], err_weights=wts, jump_unroll=jump_unroll,
                norms=adj["norms"])
            self.record.reverse = "pinned"
            if (rstats.retcode != 0 and self.sensealg.pinned_reverse is None
                    and self.sensealg.pinned_fallback):
                z, _, rstats, _ = reverse_joined_solve(
                    self.bwd_stepper, aug_rhs, times, jumps, z0, n,
                    err_weights=wts, **adj)
                self.record.reverse = "pinned, then adaptive"
        else:
            z, _, rstats, _ = reverse_joined_solve(
                self.bwd_stepper, aug_rhs, times, jumps, z0, n,
                err_weights=wts, **adj,
                **self._event_kwargs(kern, p, event_set, n, npf, q_slice=n))
        return z[:n], z[n:], rstats, rstats.retcode

    def _backward_checkpointed(self, u0vec, pflat, p, kern, times, jumps,
                               adj, event_set, snaps):
        """(λ(t0), q(t0), summed reverse Stats, worst retcode) of
        InterpolatingAdjoint(checkpointing=True), which
        GaussAdjoint/GaussKronrodAdjoint(checkpointing=True) share (JAX
        :1252-1398): for each inter-save interval from the top down, add
        its jump, solve the interval forward again from the stored save
        value with dense output (re-firing its events), then run the
        adaptive joined reverse over that local interpolant, applying the
        recorded events at their times (and one at the interval's top
        first). The local forward gets opts.max_steps under a fixed grid,
        else max(max_steps // 8, 64) steps; the worst retcode of every local
        solve poisons the gradient."""
        opts, n, npf = self.opts, u0vec.numel(), pflat.numel()
        kind = type(self.t0)
        ckpt = snaps
        seg_max_steps = (opts.max_steps if opts.fixed_dt is not None
                         else max(opts.max_steps // 8, 64))
        wts = _err_weights(u0vec, n, npf)
        joined = self._joined(adj, n, npf)
        tf = self.t_final
        tdir = kind(1.0) if self.t1 >= self.t0 else kind(-1.0)
        span = self.t1 - self.t0
        tol_tf = match_tol(kind, span, tf)
        fvec = lambda uv, t: kern.fvec(uv, p, t)
        ev_kw = self._event_kwargs(kern, p, event_set, n, npf, q_slice=n)
        ev_t = ev_kw.get("event_times", np.zeros(0, dtype=kind))
        ke = ev_t.shape[0] - 1

        def match_events(t, zz, ke):
            """Every recorded event at time t, last recorded first."""
            tol = match_tol(kind, span, t)
            fired = False
            for _ in range(ev_kw.get("event_unroll", 0)):
                if ke >= 0 and abs(kind(ev_t[ke] - t)) <= tol:
                    zz, _ = ev_kw["event_apply"](ke, t, zz, None)
                    ke -= 1
                    fired = True
            return zz, ke, fired

        z = u0vec.new_zeros(n + npf)
        worst = n_acc = n_rej = n_fev = resolves = 0
        for i in range(times.shape[0] - 1, 0, -1):
            z = z.clone()
            z[:n] += jumps[i]
            t_hi, t_lo = times[i], times[i - 1]
            # intervals at or above t_final hold u(t_final): no dynamics
            if kind(kind(t_lo - tf) * tdir) >= -tol_tf:
                continue
            if kind(kind(t_hi - tf) * tdir) > 0:
                t_hi = tf
            # an event recorded at this save time, or the terminal one at
            # t_final
            z, ke, _ = match_events(t_hi, z, ke)
            local = integrate(self.solver, fvec, t_lo, t_hi, ckpt[i - 1],
                              rtol=opts.rtol, atol=opts.atol,
                              max_steps=seg_max_steps, store_dense=True,
                              fixed_dt=opts.fixed_dt, event_set=event_set,
                              norms=opts.norms)
            aug_rhs = _joined_rhs(
                kern, p, n, lambda t, d=local.dense: dense_eval(d, t))
            stop_kw = {}
            if event_set is not None:
                def stop_tr(t, zz, kec):
                    return match_events(t, zz, kec)

                stop_kw = dict(tstops=ev_t, stop_transform=stop_tr,
                               hook_carry=ke)
            rev = integrate(self.bwd_stepper, aug_rhs, t_hi, t_lo, z,
                            rtol=adj["rtol"], atol=adj["atol"],
                            max_steps=adj["max_steps"], store_dense=False,
                            err_weights=wts, norms=joined["norms"],
                            **stop_kw)
            if event_set is not None:
                ke = rev.hook_carry
            # the local re-solve of the interval that ends at a terminal
            # stop reports Terminated: that is success
            fwd_rc = local.stats.retcode
            worst = max(worst, 0 if fwd_rc == RETCODE_TERMINATED else fwd_rc,
                        rev.stats.retcode)
            n_acc += rev.stats.n_accepted
            n_rej += rev.stats.n_rejected
            n_fev += rev.stats.n_fevals
            resolves += int(t_hi != t_lo)
            z = rev.u_final
        z = z.clone()
        z[:n] += jumps[0]
        self.record.reverse, self.record.resolves = "checkpointed", resolves
        rstats = Stats(n_accepted=n_acc, n_rejected=n_rej, n_fevals=n_fev,
                       retcode=worst)
        return z[:n], z[n:], rstats, worst

    def _backward_lambda(self, u0vec, pflat, p, kern, times, jumps, adj,
                         event_set, jump_unroll):
        """(λ(t0), dL/dp, reverse Stats, worst retcode) of GaussAdjoint,
        GaussKronrodAdjoint and QuadratureAdjoint: λ alone runs backwards
        over the forward's dense output (no error weights: every row is
        controlled). The Gauss hooks integrate λᵀ∂f/∂p on each accepted
        step, and with pinned_reverse=True the reverse walks the forward's
        grid (no fallback: auto never pins these rules); Quadrature keeps
        λ's dense output and integrates afterwards. An event's (∂A/∂p)ᵀλ⁺
        goes into the hook's carry (Quadrature: into the sum that the
        quadrature adds to)."""
        dense, n, npf = self.dense, u0vec.numel(), pflat.numel()
        if self.mass is not None:
            return self._backward_dae_lambda(u0vec, pflat, p, kern, times,
                                             jumps, adj, event_set)
        quadrature = isinstance(self.sensealg, QuadratureAdjoint)
        pinned = not quadrature and self._pinned_on(event_set)
        aug_rhs = _lam_rhs(kern, p, lambda t: dense_eval(dense, t))
        qdtype = torch.promote_types(u0vec.dtype, torch.float32)
        q0 = torch.zeros(npf, dtype=qdtype, device=u0vec.device)
        hook, finish = None, None
        if self.has_p and not quadrature:
            hook, q0, finish = make_gauss_quad_hook(
                kern, p, dense, self.sensealg, self.t0, self.t1, qdtype,
                pinned=pinned, norms=adj["norms"])
        lam0 = u0vec.new_zeros(n)
        if pinned:
            lam, q, rstats = reverse_pinned_solve(
                self.bwd_stepper,
                lambda i: _lam_rhs(kern, p, _interval_y(dense, i)), dense,
                times, jumps, lam0, n, rtol=adj["rtol"], atol=adj["atol"],
                hook=hook, hook_carry=q0, jump_unroll=jump_unroll,
                norms=adj["norms"])
            self.record.reverse = "pinned"
        else:
            lam, q, rstats, lam_dense = reverse_joined_solve(
                self.bwd_stepper, aug_rhs, times, jumps, lam0, n,
                hook=hook, hook_carry=q0, collect_dense=quadrature, **adj,
                **self._event_kwargs(kern, p, event_set, n, npf,
                                     q_in_hc=True))
        if quadrature:
            q = adaptive_gk_dp(kern, p, dense, lam_dense, self.sensealg, q,
                               norms=adj["norms"])
        elif finish is not None:
            q = finish(q)
        return lam, q, rstats, rstats.retcode

    def _dae_stepper(self, mass, like):
        """The DAE reverse stepper with the reverse mass `mass` (host)."""
        return _dae_reverse_stepper(self.bwd_solver, self.bwd_stepper) \
            .with_mass_matrix(torch.as_tensor(mass, dtype=like.dtype,
                                              device=like.device))

    def _dae_event_kwargs(self, kern, p, event_set, n, npf, **where):
        """reverse_joined_solve's event arguments with the DAE jump."""
        if event_set is None:
            return {}
        return event_kwargs(self.events, event_set, _make_dae_event_apply(
            kern, p, event_set, self.events, n, npf, self.mass, **where))

    def _backward_dae_lambda(self, u0vec, pflat, p, kern, times, jumps, adj,
                             event_set):
        """(dL/du0, dL/dp, reverse Stats, worst retcode) of GaussAdjoint,
        GaussKronrodAdjoint and QuadratureAdjoint on a semi-explicit
        index-1 DAE (JAX :1489-1530, :1594-1625): λ alone backwards with
        mass Mᵀ, the projected jumps, the algebraic λ rows re-solved at
        every quadrature node (`_dae_lam_fix`), the save-time q-corrections
        −f_pᵀŵ summed directly, dL/du0 = Mᵀλ(t0)."""
        dense, n, npf = self.dense, u0vec.numel(), pflat.numel()
        quadrature = isinstance(self.sensealg, QuadratureAdjoint)
        du0_map, lamjs, qjs = _dae_project_jumps(self.mass, kern, p, dense,
                                                 times, jumps)
        lam_fix = _dae_lam_fix(self.mass, kern, p)
        qdtype = torch.promote_types(u0vec.dtype, torch.float32)
        q0 = torch.zeros(npf, dtype=qdtype, device=u0vec.device)
        hook, finish = None, None
        if self.has_p and not quadrature:
            hook, q0, finish = make_gauss_quad_hook(
                kern, p, dense, self.sensealg, self.t0, self.t1, qdtype,
                lam_fix=lam_fix)
        lam, q, rstats, lam_dense = reverse_joined_solve(
            self._dae_stepper(host_matrix(self.mass).T, u0vec),
            _lam_rhs(kern, p, lambda t: dense_eval(dense, t)), times, lamjs,
            u0vec.new_zeros(n), n, hook=hook, hook_carry=q0,
            collect_dense=quadrature, dt0=self.opts.dt0, **adj,
            **self._dae_event_kwargs(kern, p, event_set, n, npf,
                                     q_in_hc=True))
        if quadrature:
            q = adaptive_gk_dp(kern, p, dense, lam_dense, self.sensealg, q,
                               lam_fix=lam_fix)
        elif finish is not None:
            q = finish(q)
        q = q + qjs.sum(0).to(q.dtype)
        return du0_map(lam), q, rstats, rstats.retcode

    def _backward_forwarddiff(self, u0vec, pflat, p, kern, lam, d_uf,
                              d_dys=None, d_dfs=None, d_dts=None):
        """(dL/du0, dL/dp) of ForwardDiffSensitivity: the tangents of the
        forward's discrete program, contracted with the cotangents. Each
        chunk of chunk_size seed directions replays the recorded steps on
        the tangent system [u; S] (`augmented_fvec`): an explicit RK step is
        the same linear combination of its stages for u and for each
        tangent, so this is exactly the jvp of the replayed program, without
        tracing the stepper's arithmetic. With events, time has a tangent
        too, as in JAX's jvp through its loop: each row's σ, the derivative
        of the current time, set by an event (`_replay_events`) and spent
        by the next step clipped to a stop, whose length stop - t moves by
        -σ (the step's derivative in dt, one jvp through the stepper).
        Dense-node cotangents contract with the tangents of the node states
        and slopes, and, where a continuous event moves them (d_dts), of
        the node times: the rows' σ at each node. The nodes mirror the
        forward's rows, an event's pre- and post-affect rows included. A
        complex state contracts the tangents with the conjugated cotangents
        and conjugates the sum (torch's cotangents are the conjugates of
        JAX's, which contract without conjugation)."""
        n, npf, dtype = u0vec.numel(), pflat.numel(), u0vec.dtype
        conj = lambda c: None if c is None else c.conj()
        lam, d_uf = conj(lam), conj(d_uf)
        d_dys, d_dfs = conj(d_dys), conj(d_dfs)
        saveat, t0 = self.saveat, self.t0
        kind = type(t0)
        tdir = kind(1.0) if self.t1 >= t0 else kind(-1.0)
        span = self.t1 - t0
        use_dense = (d_dys is not None or d_dfs is not None
                     or d_dts is not None)
        event_set = self._event_set(p)
        ev_at = dict(self.event_log or [])
        stops = saveat if self.opts.tstops is None else np.sort(
            np.concatenate([saveat, np.asarray(self.opts.tstops, dtype=kind)]))
        fvec = lambda uv, t: kern.fvec(uv, p, t)
        save_hook = save_hook_factory(saveat, tdir, span)
        # an explicit RK step is linear in its stages, so stepping [u; S]
        # is its jvp; any other stepper's jvp is taken through its step
        explicit = isinstance(self.solver, ExplicitRK)
        log = self.step_log
        seeds = torch.eye(n + npf, dtype=dtype, device=u0vec.device)
        parts = []
        for block in torch.split(seeds, self.sensealg.chunk_size or n + npf):
            k = block.shape[0]
            # the parameter directions in p's dtype (real p, complex state)
            seeds_p = block[:, n:].real.to(pflat.dtype)
            aug = augmented_fvec(kern, p, n, seeds_p)
            z = torch.cat([u0vec, block[:, :n].reshape(-1)])
            fz = aug(z, t0).to(dtype)
            carry = save_carry0(saveat, t0, tdir, z, span)
            nodes = [(z, fz, None)] if use_dense else None
            sigma = None  # per-row tangent of the current time, or None
            # a multistep stepper's history and its tangents
            hist = _bdf_history(z, n, k, None) if log.stateful else None
            for i, (t, dt, st) in enumerate(log.steps):
                t_b = kind(t + dt)
                delta = None
                if (sigma is not None and dt == kind(
                        next_stop(t, self.t1, stops, tdir)[0] - t)):
                    # a clipped step's length stop - t moves by -σ
                    delta = -sigma
                if explicit:
                    z1, f1, _ = self.solver.step(aug, t, dt, z, fz,
                                                 need_err=False)
                elif st is not None:
                    z1, f1, hist = _tangent_bdf_step(
                        self.solver, kern, p, t, dt, z, fz, st, hist,
                        seeds_p, n, k, sigma, delta)
                else:
                    z1, f1 = _tangent_step(self.solver, kern, p, t, dt, z,
                                           fz, seeds_p, n, k)
                z1, f1 = z1.to(dtype), f1.to(dtype)
                if sigma is not None and st is None:
                    # the step's start moves by σ (its stage times with it)
                    z1, f1 = _shift_step(self.solver, fvec, t, dt, z, fz, z1,
                                         f1, sigma, delta, n, k)
                se = ev_at.get(i)
                if se is not None:
                    z_pre, z1, sigma = self._replay_events(
                        kern, p, event_set, se, t, dt, z, fz, z1, f1, sigma,
                        delta, seeds_p, n, k)
                    if use_dense:  # the pre-affect row at the event time
                        f_pre = f1
                        if se.theta is not None:
                            f_pre = _slope_time_tangent(
                                fvec, z_pre, aug(z_pre, se.t_e).to(dtype),
                                se.t_e, sigma, n, k)
                        nodes.append((z_pre, f_pre, sigma))
                    f1 = aug(z1, se.t_e).to(dtype)
                    if sigma is not None:
                        f1 = _slope_time_tangent(fvec, z1, f1, se.t_e, sigma,
                                                 n, k)
                    t_b = se.t_e
                elif delta is not None:
                    sigma = None  # landed on the stop: σ + δ = 0
                if i in log.resets:
                    # the history restarts at the event, every slot at its
                    # time and its time tangent
                    hist = _bdf_history(z1, n, k, sigma)
                carry = save_hook((t, t_b, z, fz, z1, f1), carry)
                z, fz = z1, f1
                if use_dense:
                    nodes.append((z, fz, sigma))
            tangents = saved_rows(carry, z)[:, n:].reshape(-1, k, n)
            part = torch.einsum("ti,tki->k", lam, tangents)
            if d_uf is not None:
                part = part + z[n:].reshape(k, n) @ d_uf.reshape(-1)
            if use_dense:
                for j, (zj, fj, sj) in enumerate(nodes):
                    if d_dys is not None:
                        part = part + zj[n:].reshape(k, n) @ d_dys[j]
                    if d_dfs is not None:
                        part = part + fj[n:].reshape(k, n) @ d_dfs[j]
                    if d_dts is not None and sj is not None:
                        part = part + (sj * d_dts[j]).to(part.dtype)
            parts.append(part)
        contracted = torch.conj_physical(torch.cat(parts))
        return contracted[:n], contracted[n:]

    def _replay_events(self, kern, p, event_set, se, t_a, dt, z_a, fz_a, z_b,
                       fz_b, sigma, delta, seeds_p, n, k):
        """The tangents through the events of one replayed step, as JAX's
        jvp through `process_step_events` gives them: z = [u; S] with k
        tangent rows, seeds_p their parameter directions, sigma / delta the
        rows' tangents of the step's start and length (None: zero).
        A continuous event at θ: dθ = -ġ_fixed / (∂g/∂θ) (the Newton
        polish's derivative), the event time's tangent σ + θδ + dθ·dt, the
        pre-event state's the interpolant's at fixed θ plus ∂y/∂θ·dθ. A
        discrete one at the step end: t_b's tangent σ + δ. Each affect then
        maps (u, p, t) by its jvp. Forward mode runs through the
        interpolant, the condition and the affect only. Returns (z before
        and after the events, the rows' time tangent)."""
        kind = type(t_a)
        tdt = kind_torch_dtype(kind)
        dev = z_a.device
        _, unravel_p = ravel_pytree(p)
        as_t = lambda v: torch.tensor(v, dtype=tdt, device=dev)
        zero_k = torch.zeros(k, dtype=tdt, device=dev)
        sig = zero_k if sigma is None else sigma.to(tdt)
        dlt = zero_k if delta is None else delta.to(tdt)
        if se.theta is not None:
            ua, fa = z_a[:n], fz_a[:n]
            ub, fb = z_b[:n], fz_b[:n]
            rows = lambda zz: zz[n:].reshape(k, n)
            Sa, Fa, Sb, Fb = rows(z_a), rows(fz_a), rows(z_b), rows(fz_b)
            th, ta, h = as_t(se.theta), as_t(t_a), as_t(dt)
            i = se.cause

            def g_and_y(th_, ta_, h_, ua_, fa_, ub_, fb_, pp_):
                tt = ta_ + th_ * h_
                y = hermite_at(tt, ta_, ta_ + h_, ua_, fa_, ub_, fb_)
                return event_set.cond_j(y, pp_, tt, i), y

            prim = (th, ta, h, ua, fa, ub, fb, p)
            _, (g_th, y_th) = torch.func.jvp(
                lambda th_: g_and_y(th_, *prim[1:]), (th,),
                (torch.ones_like(th),))
            u_tan, t_tan = [], []
            for r in range(k):
                tan = (sig[r], dlt[r], Sa[r], Fa[r], Sb[r], Fb[r],
                       None if p is None else unravel_p(seeds_p[r]))
                if p is None:
                    _, (dg, dy) = torch.func.jvp(
                        lambda *a: g_and_y(th, *a, None), prim[1:7], tan[:6])
                else:
                    _, (dg, dy) = torch.func.jvp(
                        lambda *a: g_and_y(th, *a), prim[1:], tan)
                safe = g_th.abs() > 1e-30
                dth = torch.where(safe, -dg / torch.where(
                    safe, g_th, torch.ones_like(g_th)), torch.zeros_like(dg))
                t_tan.append(sig[r] + th * dlt[r] + dth * h)
                u_tan.append(dy + y_th * dth)
            u = hermite_at(as_t(se.t_e), ta, ta + h, ua, fa, ub, fb).to(
                z_a.dtype)
            U = torch.stack(u_tan).to(z_a.dtype)
            T = torch.stack(t_tan)
        else:
            u, U = z_b[:n], z_b[n:].reshape(k, n)
            T = sig + dlt
        # a discrete event at a step end without time tangents keeps none
        T_out = (None if se.theta is None and sigma is None
                 and delta is None else T)
        z_pre = torch.cat([u, U.reshape(-1)])
        tt = as_t(se.t_e)
        for j in se.fired:
            rows_out = []
            for r in range(k):
                if p is None:
                    _, d_u = torch.func.jvp(
                        lambda uu, t_: event_set.affect_p(uu, None, t_, j),
                        (u, tt), (U[r], T[r]))
                else:
                    _, d_u = torch.func.jvp(
                        lambda uu, pp, t_: event_set.affect_p(uu, pp, t_, j),
                        (u, p, tt), (U[r], unravel_p(seeds_p[r]), T[r]))
                rows_out.append(d_u)
            u = event_set.affect_p(u, p, se.t_e, j)
            U = torch.stack(rows_out)
        return z_pre, torch.cat([u, U.reshape(-1)]), T_out


def _shift_step(stepper, fvec, t, dt, z, fz, z1, f1, sigma, delta, n, k):
    """z1, f1 of a replayed step whose start moves by sigma and whose length
    moves by delta (per tangent row, None: zero): the step's derivatives in
    its start (`t_off`) and its length (`ddt`), one jvp of the stepper's
    u-part each (forward mode through the field, whose stage times carry
    them), times sigma and delta, added to each row's state and slope
    tangents. The first stage's slope is the caller's: its own time
    tangent is already in fz's rows."""
    u, f = z[:n], fz[:n]
    ref = sigma if sigma is not None else delta
    zero = torch.zeros((), dtype=ref.dtype, device=z.device)
    dz = torch.zeros(k * n, dtype=z1.dtype, device=z.device)
    dfz = torch.zeros(k * n, dtype=f1.dtype, device=z.device)
    for name, tan in (("t_off", sigma), ("ddt", delta)):
        if tan is None:
            continue
        _, (du, df) = torch.func.jvp(
            lambda d: stepper.step(fvec, t, dt, u, f, need_err=False,
                                   **{name: d})[:2],
            (zero,), (torch.ones_like(zero),))
        dz = dz + (tan[:, None] * du).reshape(-1).to(z1.dtype)
        dfz = dfz + (tan[:, None] * df).reshape(-1).to(f1.dtype)
    pad = torch.zeros(n, dtype=z1.dtype, device=z.device)
    return (z1 + torch.cat([pad, dz]),
            f1 + torch.cat([pad.to(f1.dtype), dfz]))


def _tangent_step(stepper, kern, p, t, dt, z, fz, seeds_p, n, k):
    """z1, f1 of one replayed step of a stepper that is not explicit RK
    (an implicit, Rosenbrock or extrapolation stepper) over z = [u; S]:
    the step on u, and each tangent row's jvp through the step (its
    Jacobian, LU and Newton iterations included, as JAX's jvp through its
    loop), with the row's state, slope and parameter directions."""
    _, unravel_p = ravel_pytree(p)
    u, f = z[:n], fz[:n]
    S, F = z[n:].reshape(k, n), fz[n:].reshape(k, n)

    def run(uu, ff, pp):
        u1, f1, _ = stepper.step(lambda uv, tt: kern.fvec(uv, pp, tt), t, dt,
                                 uu, ff, need_err=False)
        return u1, f1

    def row(s, fr, e):
        if p is None:
            return torch.func.jvp(lambda a, b: run(a, b, None), (u, f),
                                  (s, fr))[1]
        return torch.func.jvp(run, (u, f, p), (s, fr, unravel_p(e)))[1]

    u1, f1 = run(u, f, p)
    dU, dF = torch.func.vmap(row)(S, F, seeds_p) if k else (S, F)
    return (torch.cat([u1, dU.reshape(-1).to(u1.dtype)]),
            torch.cat([f1, dF.reshape(-1).to(f1.dtype)]))


def _bdf_history(z, n, k, sigma):
    """A multistep replay's history restarted at z = [u; S] (the start, or
    an event): (u_hist, each row's S_hist of shape (k, HCAP, n), each row's
    slot time tangents (k, HCAP), None where the restart time has none)."""
    u, S = z[:n], z[n:].reshape(k, n)
    return (u[None, :].repeat(HCAP, 1), S[:, None, :].repeat(1, HCAP, 1),
            None if sigma is None else sigma[:, None].repeat(1, HCAP))


def _tangent_bdf_step(stepper, kern, p, t, dt, z, fz, st, hist, seeds_p, n,
                      k, sigma, delta):
    """z1, f1 and the shifted history of one replayed FBDF step over
    z = [u; S]: the BDF solve at the forward's logged order and history
    times `st`, and each row's jvp through it (Jacobian, LU, Newton
    iterations), with the row's state, slope, history and parameter
    directions and, where time has tangents, its start's σ, its length's δ
    and its history slots', as JAX's jvp through its loop carries the
    history. The order choice is not replayed."""
    _, unravel_p = ravel_pytree(p)
    u, f = z[:n], fz[:n]
    S, F = z[n:].reshape(k, n), fz[n:].reshape(k, n)
    u_hist, S_hist, hsig = hist
    timed = sigma is not None or delta is not None or hsig is not None
    tdt = kind_torch_dtype(type(t))
    zero_k = torch.zeros(k, dtype=tdt, device=z.device)
    sig = zero_k if sigma is None else sigma.to(tdt)
    dlt = zero_k if delta is None else delta.to(tdt)
    hs = (zero_k[:, None].repeat(1, HCAP) if hsig is None
          else hsig.to(tdt))

    def run(uu, ff, uh, pp, t_off=None, ddt=None, h_off=None):
        v, f1, _, _ = stepper.solve(
            lambda uv, tt: kern.fvec(uv, pp, tt), t, dt, uu, ff,
            st._replace(u_hist=uh, t_off=h_off), ddt=ddt, t_off=t_off)
        return v, f1

    def row(s, fr, sh, e, sg, dl, hh):
        prim = (u, f, u_hist, p)
        tan = (s, fr, sh, None if p is None else unravel_p(e))
        if timed:
            prim = prim + (zero_k[0], zero_k[0], zero_k[:1].repeat(HCAP))
            tan = tan + (sg, dl, hh)
        if p is None:
            return torch.func.jvp(
                lambda a, b, c, *o: run(a, b, c, None, *o),
                prim[:3] + prim[4:], tan[:3] + tan[4:])[1]
        return torch.func.jvp(run, prim, tan)[1]

    v, f1 = run(u, f, u_hist, p)
    dV, dF = torch.func.vmap(row)(S, F, S_hist, seeds_p, sig, dlt, hs)
    if timed:  # the new slot's time tangent is x0's: σ + δ
        hsig = torch.cat([(sig + dlt)[:, None], hs[:, :-1]], dim=1)
    hist = (torch.cat([v[None, :], u_hist[:-1]]),
            torch.cat([dV[:, None, :].to(S_hist.dtype), S_hist[:, :-1]],
                      dim=1),
            hsig)
    return (torch.cat([v, dV.reshape(-1).to(v.dtype)]),
            torch.cat([f1, dF.reshape(-1).to(f1.dtype)]), hist)


def _slope_time_tangent(fvec, z, fz, t, sigma, n, k):
    """fz = [f; F] of the tangent field at host time t, with each row's
    ∂f/∂t·σᵣ added to F: a slope taken at a time that has a tangent (an
    event time), by one jvp of the field in t."""
    tt = torch.tensor(t, dtype=sigma.dtype, device=z.device)
    _, dfdt = torch.func.jvp(lambda s: fvec(z[:n], s), (tt,),
                             (torch.ones_like(tt),))
    add = (sigma[:, None] * dfdt).reshape(-1).to(fz.dtype)
    return fz + torch.cat([fz.new_zeros(n), add])


def _err_weights(u0vec, n, npf, n_u=0):
    """Error weights of an augmented reverse state [λ; q; (u)]: 1 on λ and
    u, 0 on the quadrature q; real for a complex state too."""
    real = u0vec.real
    return torch.cat([real.new_ones(n), real.new_zeros(npf),
                      real.new_ones(n_u)])


def event_kwargs(events, event_set, event_apply):
    """reverse_joined_solve's event arguments (JAX `_event_kwargs`): the
    recorded times, their count and the jump transform."""
    count = min(events.count, event_set.max_events)
    return dict(
        event_times=events.ts.numpy()[:count], event_count=count,
        event_unroll=max(3, event_set.n_cont + event_set.n_disc),
        event_apply=event_apply)


def _make_event_apply(kern, p, event_set, events, n, npf, q_slice=None,
                      u_snap_start=None, q_in_hc=False, run_cost=None):
    """The reverse jump of recorded event i (JAX `_make_event_apply`):

        λ⁻ = (∂A/∂u)ᵀλ⁺ − ∇g·((∂A/∂u·f⁻ − f⁺)·λ⁺ + r⁻ − r⁺)/ġ,
        ġ = ∇g·f⁻ + ∂g/∂t,   dq += (∂A/∂p)ᵀλ⁺

    with f⁺ = 0 at a terminal event (the trajectory stops at τ). r is the
    running cost of the direct API (`run_cost(uvec, t)`, else 0): the
    integrand of ∫ r dt jumps from r(u⁻) to r(u⁺) across the affect (to 0
    at a terminal event), a moving-boundary term in τ's derivative. Discrete
    callbacks skip the event-time correction (their time is the grid's).
    (∂A/∂u·f⁻)·λ⁺ is taken as f⁻·((∂A/∂u)ᵀλ⁺), so only the affect's and the
    condition's pullbacks run, and the field is called for f⁻ and f⁺ alone.
    q_slice: q's offset in z (Interpolating, Backsolve); u_snap_start:
    Backsolve's u block, snapped to the recorded pre-event state; q_in_hc:
    q is the hook's carry (Gauss: q, GaussKronrod: (q, error),
    Quadrature: the sum its quadrature adds to).
    apply(i, t, z, hc) -> (z, hc)."""
    ev_upre = events.u_pre
    ev_idx = events.idx.tolist()
    n_cont = event_set.n_cont
    tdt = kind_torch_dtype(time_dtype(ev_upre.dtype))

    def apply(i, t, z, hc):
        u_pre = ev_upre[i]
        j = ev_idx[i]
        lam = z[:n]
        if p is None:
            u_post, pull = torch.func.vjp(
                lambda uu: event_set.affect_p(uu, None, t, j), u_pre)
            (ubar,), pbar = pull(lam.to(u_post.dtype)), None
        else:
            u_post, pull = torch.func.vjp(
                lambda uu, pp: event_set.affect_p(uu, pp, t, j), u_pre, p)
            ubar, pbar = pull(lam.to(u_post.dtype))
        lam_new = ubar.to(z.dtype)
        if j < n_cont:
            f_m = kern.fvec(u_pre, p, t)
            terminal = (event_set.terminals is not None
                        and event_set.terminals[j])
            tt = torch.tensor(t, dtype=tdt, device=z.device)
            gu, gt = torch.func.grad(
                lambda uu, t_: event_set.cond_j(uu, p, t_, j),
                argnums=(0, 1))(u_pre, tt)
            gdot = gu @ f_m.to(gu.dtype) + gt.to(gu.dtype)
            term = f_m.to(lam.dtype) @ lam_new
            if not terminal:
                term = term - kern.fvec(u_post, p, t).to(lam.dtype) @ lam
            if run_cost is not None:
                r_jump = torch.as_tensor(run_cost(u_pre, t))
                if not terminal:
                    r_jump = r_jump - torch.as_tensor(run_cost(u_post, t))
                term = term + r_jump.to(term.dtype)
            safe = gdot.abs() > 1e-300
            corr = torch.where(safe, term / torch.where(
                safe, gdot, torch.ones_like(gdot)), torch.zeros_like(term))
            lam_new = lam_new - gu.to(z.dtype) * corr
        z = z.clone()
        z[:n] = lam_new
        pbar_flat = None if pbar is None else ravel_pytree(pbar)[0]
        if q_slice is not None and npf > 0 and pbar_flat is not None:
            z[q_slice:q_slice + npf] += pbar_flat.to(z.dtype)
        if u_snap_start is not None:
            z[u_snap_start:] = u_pre
        if q_in_hc and pbar_flat is not None:
            if isinstance(hc, tuple):
                hc = (hc[0] + pbar_flat.to(hc[0].dtype),) + hc[1:]
            else:
                hc = hc + pbar_flat.to(hc.dtype)
        return z, hc

    return apply


def host_matrix(M) -> np.ndarray:
    """A mass matrix (tensor, array or nested list) as a float64 host
    array: its row classification and determinant test run on the host,
    once per solve, never in the step loop."""
    if isinstance(M, torch.Tensor):
        M = M.detach().cpu()
        if M.is_complex():
            M = M.real
        return M.to(torch.float64).numpy()
    return np.asarray(M, dtype=float)


def _semi_explicit_split(M_fwd):
    """Classify a singular constant mass matrix as semi-explicit index-1
    (JAX `_semi_explicit_split`): the algebraic variables are the zero rows
    of M; the differential block M[d, d] must be nonsingular and M[d, a]
    zero. Returns (a_idx, d_idx) as numpy index arrays."""
    Mnp = host_matrix(M_fwd)
    row_zero = np.all(Mnp == 0.0, axis=1)
    a_idx = np.where(row_zero)[0]
    d_idx = np.where(~row_zero)[0]
    if a_idx.size and np.any(Mnp[np.ix_(d_idx, a_idx)] != 0.0):
        raise NotImplementedError(
            "mass matrix couples differential rows to algebraic variables "
            "(M[d,a] != 0): not semi-explicit index-1 after row "
            "classification — rewrite the system in semi-explicit form")
    Mdd = Mnp[np.ix_(d_idx, d_idx)]
    if d_idx.size and abs(float(np.linalg.det(Mdd))) < 1e-300:
        raise ValueError(
            "the differential block of the mass matrix must be nonsingular "
            "(reference adjoint_common.jl:131-133)")
    return a_idx, d_idx


class _DAEBlocks(NamedTuple):
    """A semi-explicit index-1 mass matrix split for the adjoint: index
    tensors of the algebraic and differential rows, M_ddᵀ and Mᵀ on the
    state's device and dtype."""

    a: torch.Tensor
    d: torch.Tensor
    MddT: torch.Tensor
    MT: torch.Tensor


def _dae_blocks(M_fwd, like: torch.Tensor) -> _DAEBlocks:
    Mnp = host_matrix(M_fwd)
    a_idx, d_idx = _semi_explicit_split(Mnp)
    on = lambda x: torch.as_tensor(x, dtype=like.dtype, device=like.device)
    idx = lambda x: torch.as_tensor(x, dtype=torch.long, device=like.device)
    return _DAEBlocks(idx(a_idx), idx(d_idx),
                      on(Mnp[np.ix_(d_idx, d_idx)].T.copy()),
                      on(Mnp.T.copy()))


def _dae_jac(kern, p, y, t):
    """∂f/∂u at (y, t) by forward mode (`solvers.rosenbrock.jacobian`), as
    JAX's `jax.jacfwd` of the field."""
    return jacobian(lambda uu, tt: kern.fvec(uu, p, tt), y, t).to(y.dtype)


def _dae_route(kern, p, blk, y, t, v):
    """A raw cotangent v at (y, t) routed through the constraint
    0 = f_a(u_d, u_a): ŵ = J_aaᵀ \\ v_a, λ_d = M_ddᵀ \\ (v_d − (Jᵀŵ)_d),
    λ_a = 0; returns (λ, f_pᵀŵ flat)."""
    J = _dae_jac(kern, p, y, t)
    Jaa = J[blk.a][:, blk.a]
    w = torch.linalg.solve(Jaa.T, v[blk.a])
    cot = torch.zeros_like(v)
    cot[blk.a] = w
    _, ubar, pbar = kern.f_and_vjp(y, p, t, cot)
    lam_d = torch.linalg.solve(blk.MddT, (v - ubar.to(v.dtype))[blk.d])
    lam = torch.zeros_like(v)
    lam[blk.d] = lam_d
    return lam, _flat(pbar, ubar)


def _dae_project_jumps(M_fwd, kern, p, dense, times, jumps):
    """The discrete loss cotangents projected onto the differential adjoint
    of a semi-explicit index-1 DAE with a general differential mass block
    (JAX `_dae_project_jumps`; the reference's ReverseLossCallback
    projection, adjoint_common.jl:790-817):

        ŵ = J_aaᵀ \\ v_a,  λ-jump_d = M_ddᵀ \\ (v_d − (Jᵀŵ)_d),  λ-jump_a = 0,
        q-jump = −f_pᵀŵ

    at u(tₖ) from the forward's dense output. JAX vmaps the rows; here they
    are a loop. Returns (du0_map λ ↦ Mᵀλ, λ-jumps (m, n), q-jumps
    (m, npf))."""
    blk = _dae_blocks(M_fwd, jumps)
    lamjs, qjs = [], []
    for tk, v in zip(times, jumps):
        lam, fpw = _dae_route(kern, p, blk, dense_eval(dense, tk), tk, v)
        lamjs.append(lam)
        qjs.append(-fpw)
    # dL/du0 = Mᵀλ(t0): the algebraic columns of M are zero, so the
    # algebraic rows of the result vanish
    du0_map = lambda lam: blk.MT @ lam
    return du0_map, torch.stack(lamjs), torch.stack(qjs)


def _dae_lam_fix(M_fwd, kern, p, gu_fn=None):
    """The algebraic rows of an interpolated DAE adjoint state re-solved
    from its differential rows (JAX `_dae_lam_fix`):

        J_aaᵀ λ_a = −(Jᵀλ_d)_a − (∂g/∂u)_a

    at each quadrature node, since a Hermite read of λ_a carries O(h)
    error straight into ∫λᵀ∂f/∂p. gu_fn(yvec, t) -> ∂g/∂u adds a
    continuous cost. Returns fix(yvec, t, λ) -> λ, or None when M has no
    algebraic rows."""
    a_idx, _ = _semi_explicit_split(M_fwd)
    if a_idx.size == 0:
        return None
    a_cache = {}

    def fix(yj, tj, lam):
        a = a_cache.setdefault(lam.device, torch.as_tensor(
            a_idx, dtype=torch.long, device=lam.device))
        lam_d = lam.clone()
        lam_d[a] = 0.0
        rhs = kern.vjp_u(yj, p, tj, lam_d)[a]
        if gu_fn is not None:
            rhs = rhs + gu_fn(yj, tj)[a]
        Jaa = _dae_jac(kern, p, yj, tj)[a][:, a]
        lam_d[a] = torch.linalg.solve(Jaa.T, -rhs.to(lam.dtype))
        return lam_d

    return fix


def _dae_reverse_stepper(bwd_solver, bwd_stepper):
    """The reverse stepper of a DAE adjoint (JAX `_dae_reverse_stepper`):
    an explicit bwd_solver, else the forward's stepper when it is an
    ESDIRK (stiffly accurate stages enforce the algebraic adjoint
    constraint pointwise), else SDIRK4."""
    from ..solvers.sdirk import ESDIRK, SDIRK4

    if bwd_solver is not None:
        return bwd_solver
    return bwd_stepper if isinstance(bwd_stepper, ESDIRK) else SDIRK4()


def _make_dae_event_apply(kern, p, event_set, events, n, npf, M_fwd,
                          q_slice=None, q_in_hc=False, run_cost=None):
    """The reverse event jump composed with the semi-explicit index-1
    projection (JAX `_make_dae_event_apply`). The adjoint state maps to its
    raw cotangent ν⁺ = (M_ddᵀλ⁺_d on the differential rows, 0 on the
    algebraic ones), pulls back through the affect, v = (∂A/∂u)ᵀν⁺ (with
    the implicit-τ correction of a continuous condition, taken with the
    DAE-consistent u̇: M_dd u̇_d = f_d, J_aa u̇_a = −J_ad u̇_d − ∂f_a/∂t),
    and is routed through the constraint as a save-time jump is:

        ŵ = J_aaᵀ \\ v_a,  λ⁻_d = M_ddᵀ \\ (v_d − (Jᵀŵ)_d),  λ⁻_a = 0,
        dq += (∂A/∂p)ᵀν⁺ − f_pᵀŵ

    with J at the pre-event state. (∂A/∂u·u̇⁻)·ν⁺ is taken as
    u̇⁻·((∂A/∂u)ᵀν⁺), so no forward mode runs through the affect.
    apply(i, t, z, hc) -> (z, hc), as `_make_event_apply`."""
    ev_upre = events.u_pre
    ev_idx = events.idx.tolist()
    n_cont = event_set.n_cont
    tdt = kind_torch_dtype(time_dtype(ev_upre.dtype))
    blk = _dae_blocks(M_fwd, ev_upre)
    Mdd = blk.MddT.T

    def udot(u, t):
        fval = kern.fvec(u, p, t).to(u.dtype)
        J = _dae_jac(kern, p, u, t)
        tt = torch.tensor(t, dtype=tdt, device=u.device)
        _, ft = torch.func.jvp(lambda s: kern.fvec(u, p, s), (tt,),
                               (torch.ones_like(tt),))
        ud_d = torch.linalg.solve(Mdd, fval[blk.d])
        ud_a = torch.linalg.solve(
            J[blk.a][:, blk.a],
            -(J[blk.a][:, blk.d] @ ud_d) - ft.to(u.dtype)[blk.a])
        out = torch.zeros_like(u)
        out[blk.d] = ud_d
        out[blk.a] = ud_a
        return out

    def apply(i, t, z, hc):
        u_pre = ev_upre[i]
        j = ev_idx[i]
        lam = z[:n]
        nu = torch.zeros_like(lam)
        nu[blk.d] = blk.MddT @ lam[blk.d]
        if p is None:
            u_post, pull = torch.func.vjp(
                lambda uu: event_set.affect_p(uu, None, t, j), u_pre)
            (ubar,), pbar_flat = pull(nu.to(u_post.dtype)), None
        else:
            u_post, pull = torch.func.vjp(
                lambda uu, pp: event_set.affect_p(uu, pp, t, j), u_pre, p)
            ubar, pbar = pull(nu.to(u_post.dtype))
            pbar_flat = ravel_pytree(pbar)[0]
        v = ubar.to(z.dtype)
        if j < n_cont:
            ud_m = udot(u_pre, t)
            ud_p = udot(u_post, t)
            tt = torch.tensor(t, dtype=tdt, device=z.device)
            gu, gt = torch.func.grad(
                lambda uu, t_: event_set.cond_j(uu, p, t_, j),
                argnums=(0, 1))(u_pre, tt)
            gdot = gu @ ud_m.to(gu.dtype) + gt.to(gu.dtype)
            term = ud_m.to(z.dtype) @ v - ud_p.to(z.dtype) @ nu
            if run_cost is not None:
                g_pp = torch.as_tensor(run_cost(u_post, t))
                if (event_set.terminals is not None
                        and event_set.terminals[j]):
                    g_pp = torch.zeros_like(g_pp)
                term = term + (torch.as_tensor(run_cost(u_pre, t))
                               - g_pp).to(term.dtype)
            safe = gdot.abs() > 1e-300
            corr = torch.where(safe, term / torch.where(
                safe, gdot, torch.ones_like(gdot)), torch.zeros_like(term))
            v = v - gu.to(z.dtype) * corr
        lam_new, fpw = _dae_route(kern, p, blk, u_pre, t, v)
        dq = -fpw if pbar_flat is None else pbar_flat.to(fpw.dtype) - fpw
        z = z.clone()
        z[:n] = lam_new
        if q_slice is not None and npf > 0:
            z[q_slice:q_slice + npf] += dq.to(z.dtype)
        if q_in_hc and npf > 0:
            if isinstance(hc, tuple):
                hc = (hc[0] + dq.to(hc[0].dtype),) + hc[1:]
            else:
                hc = hc + dq.to(hc.dtype)
        return z, hc

    return apply


def _joined_rhs(kern, p, n: int, y_of):
    """The reverse field over z = [λ; q]: −[ūᵀ, p̄ᵀ] from one `f_and_vjp`
    at u = y_of(t). Its `.jac` is the adjoint Jacobian [[−Jᵀ, 0],
    [−J_pᵀ, 0]] (q never feeds back; JAX continuous.py:1110-1123), which
    an implicit reverse stepper takes instead of forward mode through the
    pullback."""
    def rhs(z, t):
        _, ubar, pbar = kern.f_and_vjp(y_of(t), p, t, z[:n])
        return torch.cat([-ubar, -_flat(pbar, ubar)])

    def jac(z, t):
        y = y_of(t)
        ju = kern.jac_u(y, p, t)
        if p is None:
            jp = ju.new_zeros(n, 0)
        else:
            pflat, unravel_p = ravel_pytree(p)
            jp = torch.func.jacrev(
                lambda pf: kern.fvec(y, unravel_p(pf), t))(pflat)
        npf = jp.shape[1]
        left = torch.cat([-ju.T, -jp.T.to(ju.dtype)], dim=0)
        return torch.cat([left, left.new_zeros(n + npf, npf)], dim=1)

    rhs.jac = jac
    return rhs


def _lam_rhs(kern, p, y_of):
    """The reverse field over λ alone: −ūᵀ at u = y_of(t), with the
    adjoint Jacobian −(∂f/∂u)ᵀ as its `.jac` (JAX :1486, :1587; a user's
    prob.jac through `kern.jac_u`)."""
    def rhs(lam, t):
        return -kern.vjp_u(y_of(t), p, t, lam)

    rhs.jac = lambda lam, t: -kern.jac_u(y_of(t), p, t).T
    return rhs


def _interval_y(dense, i: int):
    """u(t) on the forward's interval i from its directly indexed Hermite
    rows, no interval search: the pinned reverse's interpolant (JAX
    `_make_interval_rhs_joined` / `_lam`, :777-803, and the pinned mode of
    `make_gauss_quad_hook`)."""
    rows = (dense.ts[i], dense.ts[i + 1], dense.ys[i], dense.fs[i],
            dense.ys[i + 1], dense.fs[i + 1])
    return lambda t: hermite_eval(t, *rows)


def make_gauss_quad_hook(kern, p, dense, sensealg, t0, t1, qdtype,
                         pinned: bool = False, extra_p=None, lam_fix=None,
                         norms: Norms = LOCAL_NORMS):
    """Per-accepted-step hook of a λ-only reverse solve that accumulates
    dL/dp = ∫ λᵀ∂f/∂p dt in its carry (JAX `make_gauss_quad_hook`). λ at a
    node comes from the step's own Hermite interpolant, u from the
    forward's dense output, or, pinned, from the rows of the forward
    interval `i` that the step walks (the record's seventh entry).
    qdtype: promote(state dtype, float32), the running sum's dtype (a
    bfloat16 sum would lose the mantissa). extra_p(yvec, t) -> (npf,): a
    continuous cost's ∂g/∂p, added to the integrand (the direct API).
    lam_fix(yvec, t, λ) -> λ: a DAE's algebraic λ rows re-solved at each
    node (`_dae_lam_fix`). norms: the reductions that the error estimates
    take; on a sharded state the integrand is this rank's partial sum, and
    `Norms.partial_norm` sums it over the ranks before the norm, so that
    every rank refines the same steps.

    GaussAdjoint: n_nodes Gauss–Legendre nodes per step; the carry is q.
    GaussKronrodAdjoint: a GK(7,15) pair per step, and a step whose
    embedded error exceeds max(abstol·|Δt|/T, reltol·‖estimate‖) is split
    in half, recursively down to max_depth (each check one host read); the
    carry is (q, Σ error).
    Returns (hook, carry0, finish): finish(carry) -> q, and for
    GaussKronrodAdjoint prints JAX's warning when the summed error exceeds
    max(abstol, reltol·‖q‖). The nodes are a loop: the kernel ops have no
    vmap rule."""
    kind = type(t0)
    device = dense.ys.device
    npf = ravel_pytree(p)[0].numel()

    def node_fn(rec):
        ta, tb, lam_a, fa, lam_b, fb, *iv = rec
        y_of = (_interval_y(dense, iv[0]) if pinned
                else lambda tj: dense_eval(dense, tj))

        def node(tj):
            lam_j = hermite_eval(tj, ta, tb, lam_a, fa, lam_b, fb)
            yj = y_of(tj)
            if lam_fix is not None:
                lam_j = lam_fix(yj, tj, lam_j)
            out = ravel_pytree(kern.vjp_p(yj, p, tj, lam_j))[0].to(qdtype)
            if extra_p is not None:
                out = out + extra_p(yj, tj).to(qdtype)
            return out

        return ta, tb, node

    if isinstance(sensealg, GaussKronrodAdjoint):
        xk, wk, wg = gauss_kronrod_01(7)
        w_est = torch.as_tensor(wk, dtype=qdtype, device=device)
        w_err = torch.as_tensor(wk - wg, dtype=qdtype, device=device)
        span = kind(abs(kind(t1 - t0)))
        abstol, reltol = kind(sensealg.abstol), kind(sensealg.reltol)

        def panel(node, pa, pb):
            width = kind(pb - pa)  # negative: the reverse walks backwards
            vals = torch.stack([node(kind(pa + kind(width * kind(xj))))
                                for xj in xk])
            # q += ∫ (−λᵀ∂f/∂p) dt in the forward orientation
            est = (w_est @ vals) * float(-width)
            err = norms.partial_norm(w_err @ vals) * float(abs(width))
            return est, err

        def refine(node, pa, pb, depth):
            est, err = panel(node, pa, pb)
            if depth <= 0:
                return est, err
            err_v, est_norm = torch.stack(
                [err, norms.partial_norm(est)]).tolist()
            tol = max(kind(kind(abstol * abs(kind(pb - pa))) / span),
                      kind(reltol * kind(est_norm)))
            if not kind(err_v) > tol:
                return est, err
            pm = kind(kind(0.5) * kind(pa + pb))
            e_l, r_l = refine(node, pa, pm, depth - 1)
            e_r, r_r = refine(node, pm, pb, depth - 1)
            return e_l + e_r, r_l + r_r

        def gk_hook(rec, carry):
            qflat, errsum = carry
            ta, tb, node = node_fn(rec)
            est, err = refine(node, ta, tb, sensealg.max_depth)
            return qflat + est, errsum + err

        def finish(carry):
            qflat, errsum = carry
            err_v, q_norm = torch.stack(
                [errsum, norms.partial_norm(qflat)]).tolist()
            tol = max(abstol, kind(reltol * kind(q_norm)))
            if kind(err_v) > tol:
                print("GaussKronrodAdjoint: accumulated quadrature error "
                      f"estimate {err_v} exceeds tolerance {tol}; tighten "
                      "adj_rtol/adj_atol or raise max_depth")
            return qflat

        # the error sum is real, for a complex state's sum too
        err0 = torch.zeros((), dtype=qdtype.to_real(), device=device)
        return gk_hook, (torch.zeros(npf, dtype=qdtype, device=device),
                         err0), finish

    xg, wg = gl_01(sensealg.n_nodes)

    def gl_hook(rec, qflat):
        ta, tb, node = node_fn(rec)
        width = kind(tb - ta)  # negative: the reverse walks backwards
        total = None
        for xj, wj in zip(xg, wg):
            term = node(kind(ta + kind(width * kind(xj)))) * float(kind(wj))
            total = term if total is None else total + term
        # q += ∫_{ta}^{tb} (−λᵀ∂f/∂p) dt
        return qflat - total * float(width)

    return gl_hook, torch.zeros(npf, dtype=qdtype, device=device), (
        lambda q: q)


def adaptive_gk_dp(kern, p, dense, lam_dense, sensealg, q_init,
                   extra_p=None, lam_fix=None, norms: Norms = LOCAL_NORMS):
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
    sum's). extra_p(yvec, t) -> (npf,): a continuous cost's ∂g/∂p, added
    to the integrand. lam_fix: a DAE's algebraic λ rows re-solved at each
    node (`_dae_lam_fix`). norms: as for `make_gauss_quad_hook` (q and the
    panels' estimates are per-rank partial sums on a sharded state)."""
    if p is None:
        return q_init
    qdtype = q_init.dtype
    kind = type(lam_dense.ts[0])
    xk, wk, wg = gauss_kronrod_01(7)
    w_est = torch.as_tensor(wk, dtype=qdtype, device=q_init.device)
    w_err = torch.as_tensor(wk - wg, dtype=qdtype, device=q_init.device)

    def integrand(tj):
        lam_j = dense_eval(lam_dense, tj)
        yj = dense_eval(dense, tj)
        if lam_fix is not None:
            lam_j = lam_fix(yj, tj, lam_j)
        out = ravel_pytree(kern.vjp_p(yj, p, tj, lam_j))[0].to(qdtype)
        if extra_p is not None:
            out = out + extra_p(yj, tj).to(qdtype)
        return out

    def gk_panel(ta, tb):
        width = kind(tb - ta)  # negative: the reverse orientation
        vals = torch.stack([integrand(kind(ta + kind(width * kind(xj))))
                            for xj in xk])
        # the forward-orientation integral over the panel
        est = (w_est @ vals) * float(-width)
        err = norms.partial_norm(w_err @ vals) * float(abs(width))
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
                  sensealg.reltol * norms.partial_norm(q).item())
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
    """(u0vec, pflat, save times) -> (saveat rows, u_final, and with dense
    output the nodes' states and slopes, so that sol(t) is
    differentiable, and where events move them (`rule.node_times`) the
    node times' zero-valued offsets); backward = reverse solve."""

    @staticmethod
    def forward(ctx, u0vec, pflat, sv, rule):
        fwd = rule.forward(u0vec, pflat)
        ctx.rule = rule
        ctx.set_materialize_grads(False)
        dense = fwd.dense
        nodes = () if dense is None else (dense.ys, dense.fs)
        ctx.save_for_backward(u0vec, pflat, sv, fwd.ys_save, fwd.u_final,
                              *nodes)
        if dense is None:
            return fwd.ys_save, fwd.u_final, None, None, None
        # the rule keeps the node times only: the nodes are outputs now,
        # and a rule that held them would close a cycle through the graph
        rule.dense = dense._replace(ys=None, fs=None)
        dts = None
        if rule.node_times:
            dts = dense.ys.new_zeros(len(dense.ts), dtype=kind_torch_dtype(
                type(dense.ts[0])))
        return fwd.ys_save, fwd.u_final, dense.ys, dense.fs, dts

    @staticmethod
    def backward(ctx, d_ys, d_uf, d_dys, d_dfs, d_dts):
        if all(d is None for d in (d_ys, d_uf, d_dys, d_dfs, d_dts)):
            return None, None, None, None
        saved = ctx.saved_tensors
        rule = ctx.rule
        if len(saved) > 5:
            rule.dense = rule.dense._replace(ys=saved[5], fs=saved[6])
        du0, dp, d_sv = rule.backward(*saved[:5], d_ys, d_uf, d_dys, d_dfs,
                                      ctx.needs_input_grad[2], d_dts=d_dts)
        return du0, dp, d_sv, None


def make_ode_solve_fn(f, solver, sensealg, opts: SolveOptions, t0, t1, *,
                      user_jac=None, user_vjp=None, user_paramjac=None,
                      bwd_solver=None):
    """Build `fn(u0, p, saveat) -> (ys, AuxOut)` whose gradient follows
    `sensealg`. saveat: save times, host values or a tensor (which then
    gets its gradient). user_*: the problem's jac / vjp / paramjac hooks
    (`ops.vjp.make_vjp_kernels`)."""
    if not isinstance(sensealg, _RULES):
        raise NotImplementedError(
            f"no ODE adjoint rule for {sensealg!r}; the port has "
            "BacksolveAdjoint, InterpolatingAdjoint, GaussAdjoint, "
            "GaussKronrodAdjoint, QuadratureAdjoint, ForwardDiffSensitivity, "
            "ForwardSensitivity and DirectAdjoint")
    hooks = dict(user_jac=user_jac, user_vjp=user_vjp,
                 user_paramjac=user_paramjac)
    reverse_solve = not isinstance(sensealg, ForwardDiffSensitivity)

    def solve_fn(u0, p, saveat):
        u0vec, unravel_u = ravel_pytree(u0)
        pflat, unravel_p = ravel_pytree(p)
        if p is None:
            pflat = u0vec.new_zeros(0)
        kind = time_dtype(u0vec.dtype)
        if isinstance(saveat, torch.Tensor):
            sv = saveat
            saveat = saveat.detach().cpu().numpy()
        else:
            sv = torch.from_numpy(np.asarray(saveat, dtype=kind))
        record = AdjointRecord() if reverse_solve else None
        rule = _ContinuousRule(f, solver, sensealg, opts, kind(t0), kind(t1),
                               np.asarray(saveat, dtype=kind), u0, unravel_p,
                               p is not None, bwd_solver, record, hooks)
        ys_save, u_final, dys, dfs, dts = _ContinuousSolve.apply(
            u0vec, pflat, sv, rule)
        dense = rule.dense
        if dense is not None:
            dense = dense._replace(ys=dys, fs=dfs, ts_off=(
                dense.ts_off if dts is None else list(dts.unbind())))
        aux = AuxOut(dense=dense, t_final=rule.t_final, u_final=u_final,
                     stats=rule.stats, adjoint=record, events=rule.events)
        return unravel_u(ys_save), aux

    return solve_fn
