"""FBDF: fixed-leading-coefficient variable-order BDF, orders 1-5
(PyTorch port).

Counterpart of `scimlsensitivity_jl_tpu/solvers/fbdf.py`: `FBDFState`,
`FBDF` (:46-254), with `with_mass_matrix`. A multistep method: one
Newton solve per step whatever the order, over a history of past
solutions that the integrator threads through its loop
(`solvers/integrate.py`'s stateful-stepper path: `init_state`, the state
advancing on accepted steps only, `controller_order` for the PI
exponents, `reset_state` after an event or a jump).

  nodes  x₀ = t+dt, xⱼ = t_hist[j-1]  (j = 1..k, most recent first)
  BDF:   Σⱼ wⱼ M u(xⱼ) = f(u₀, x₀),  wⱼ = dLⱼ/dt at x₀ (Lagrange
         differentiation weights over the k+1 nodes)
  Newton on g(v) = M(w₀ v + Σⱼ₌₁ wⱼ uⱼ) − f(v),  W = w₀M − J per step
  predictor: Lagrange extrapolation of the k+1 most recent values
  error:  est_k = (v − pred)/(k+1)
  order:  after k+1 accepted steps at order k, compare the step factors
          implied by est_{k−1}, est_k and est_{k+1} and move one order
          toward the best.

The port keeps the history's times, the counts and the order on the host
(numpy scalars of the time dtype and ints), and the history's states on
the device: the Lagrange weights are host arithmetic, and the order
decision reads the three error norms in one host read per step. JAX
computes both on the device (its products may round in another order).

`step` is the BDF solve (`solve`), which every derivative goes through,
and the order choice (`choose_order`), host work that is not
differentiated (JAX's comparisons give it a zero derivative).
ForwardDiffSensitivity replays the solve alone at the forward's logged
orders. Where the step's start or length carries a derivative (`t_off`,
`ddt`, as `ExplicitRK.step` takes them) or the history's times do
(`FBDFState.t_off`, set by `reset_state` at an event time that carries
one), x₀ = t + dt carries t_off + ddt, J and f are taken at that tensor
time, and the weights and the predictor's coefficients keep their host
values while carrying the derivative of the same formulas over the tensor
times, as JAX's traced weights do.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .explicit import scaled, stage_time
from .integrate import kind_torch_dtype
from .rosenbrock import jacobian, lu_solve
from .sdirk import algebraic_rows

__all__ = ["FBDF", "FBDFState"]

K_MAX = 5          # maximum BDF order (6 is not zero-stable enough)
HCAP = K_MAX + 2   # history slots: the order-raise test needs k+2 values


class FBDFState(NamedTuple):
    t_hist: np.ndarray      # (HCAP,) host times, most recent first
    u_hist: torch.Tensor    # (HCAP, n) solutions at t_hist
    n_hist: int             # valid history entries (>= 1)
    k: int                  # current order (1..K_MAX)
    steps_at_k: int         # accepted steps since the last order change
    rtol: float
    atol: float
    # (HCAP,) zero-valued tensor carrying the derivatives of t_hist's
    # slots, shifted with them; None where no step carried one
    t_off: Optional[torch.Tensor] = None


def _rounding(x0):
    """The rounding of the weights' arithmetic: the time dtype's on host
    scalars, none on tensors (whose ops round in their own dtype)."""
    return (lambda v: v) if isinstance(x0, torch.Tensor) else type(x0)


def _diff_weights(xs, valid, x0):
    """Lagrange differentiation weights wⱼ = dLⱼ/dt at x0 over the node set
    {x0} ∪ {xs[j] : valid[j]}, in the time dtype (host scalars, or 0-d
    tensors from tensor times); invalid slots get 0."""
    kind = _rounding(x0)
    one = kind(1.0)
    w0 = kind(0.0)
    for j in range(len(xs)):
        if valid[j]:
            w0 = kind(w0 + kind(one / kind(x0 - xs[j])))
    w = []
    for j in range(len(xs)):
        if not valid[j]:
            w.append(kind(0.0))
            continue
        num, den = one, one
        for m in range(len(xs)):
            if valid[m] and m != j:
                num = kind(num * kind(x0 - xs[m]))
                den = kind(den * kind(xs[j] - xs[m]))
        w.append(kind(num / kind(den * kind(xs[j] - x0))))
    return w0, w


def _lagrange_coef(xs, valid, x0):
    """Coefficients of the polynomial through the valid (xs, ·) at x0."""
    kind = _rounding(x0)
    coef = []
    for j in range(len(xs)):
        if not valid[j]:
            coef.append(kind(0.0))
            continue
        num, den = kind(1.0), kind(1.0)
        for m in range(len(xs)):
            if valid[m] and m != j:
                num = kind(num * kind(x0 - xs[m]))
                den = kind(den * kind(xs[j] - xs[m]))
        coef.append(kind(num / den))
    return coef


def _carrying(host, fn, xs, x0):
    """fn's host values (weights or coefficients), each carrying the
    derivative of fn over the tensor times xs, x0 (zero-valued offsets
    beside the host times): value + (e − e), the host value exactly."""
    if xs is None:
        return host
    expr = fn(xs, x0)
    if isinstance(host, tuple):  # (w0, w)
        return tuple(_carrying(h, lambda *_: e, xs, x0)
                     for h, e in zip(host, expr))
    if isinstance(host, list):
        return [h if not isinstance(e, torch.Tensor)
                else (e - e.detach()) + float(h) for h, e in zip(host, expr)]
    return (expr - expr.detach()) + float(host)


def _combine(coef, hist):
    """Σⱼ coefⱼ hist[j] on the device, the nonzero terms only."""
    out = None
    for c, row in zip(coef, hist):
        if c != 0.0:
            term = (c if isinstance(c, torch.Tensor) else float(c)) * row
            out = term if out is None else out + term
    return torch.zeros_like(hist[0]) if out is None else out


class FBDF:
    """Variable-order BDF(1-5) with modified Newton. mass_matrix: optional
    constant M for M·u' = f (index-1 semi-explicit DAEs; algebraic rows
    leave the error estimate)."""

    stateful = True
    order = 2          # static fallback (the initial step heuristic only)
    fsal = False
    factor_max = 2.5   # BDF stability wants bounded step growth
    n_stages = 10      # static estimate of f evaluations per attempt

    def __init__(self, newton_iters: int = 6, newton_tol: float = 1e-12,
                 mass_matrix=None, max_order: int = K_MAX):
        if not (1 <= max_order <= K_MAX):
            raise ValueError(f"max_order must be in 1..{K_MAX}")
        self.newton_iters = newton_iters
        self.newton_tol = newton_tol
        self.mass_matrix = mass_matrix
        self.max_order = max_order
        self.name = "FBDF"

    def with_mass_matrix(self, M):
        return FBDF(self.newton_iters, self.newton_tol, mass_matrix=M,
                    max_order=self.max_order)

    def __repr__(self):
        return f"FBDF(max_order={self.max_order})"

    def init_state(self, fvec, t0, u0, f0, rtol, atol):
        kind = type(t0)
        return FBDFState(t_hist=np.full(HCAP, t0, dtype=kind),
                         u_hist=u0[None, :].repeat(HCAP, 1), n_hist=1, k=1,
                         steps_at_k=0, rtol=kind(rtol), atol=kind(atol))

    def controller_order(self, state: FBDFState) -> int:
        return state.k

    def reset_state(self, state: FBDFState, t, u, t_off=None):
        """Restart from order 1 at (t, u): the history is invalid across a
        state discontinuity (a λ jump, an event's affect). t_off: the
        restart time's zero-valued offset, which every slot takes."""
        return state._replace(t_hist=np.full(HCAP, t, dtype=type(t)),
                              u_hist=u[None, :].repeat(HCAP, 1), n_hist=1,
                              k=1, steps_at_k=0,
                              t_off=(None if t_off is None
                                     else t_off.expand(HCAP)))

    def step(self, fvec, t, dt, u, f0, state: FBDFState, ddt=None,
             t_off=None):
        """One attempt: the BDF solve, the order choice, the shifted
        history. Returns (v, f1, err, the state after acceptance)."""
        kind = type(t)
        v, f1, err, est_k = self.solve(fvec, t, dt, u, f0, state, ddt, t_off)
        x0 = kind(t + dt)
        k_new, dk = self.choose_order(state, x0, u, v, est_k)
        # the new slot's offset, x0's: t_off + ddt
        offs = [o for o in (t_off, ddt) if o is not None]
        x0_off = sum(offs[1:], offs[0]) if offs else None
        slot_off = state.t_off
        if slot_off is not None or x0_off is not None:
            if slot_off is None:
                slot_off = torch.zeros(HCAP, dtype=kind_torch_dtype(kind),
                                       device=u.device)
            head = (torch.zeros_like(slot_off[:1]) if x0_off is None
                    else x0_off.reshape(1).to(slot_off.dtype))
            slot_off = torch.cat([head, slot_off[:-1]])
        # shift the history, most recent first
        new_state = state._replace(
            t_hist=np.concatenate([[x0], state.t_hist[:-1]]).astype(kind),
            u_hist=torch.cat([v[None, :], state.u_hist[:-1]]),
            n_hist=min(state.n_hist + 1, HCAP), k=k_new,
            steps_at_k=0 if dk != 0 else state.steps_at_k + 1,
            t_off=slot_off)
        return v, f1, err, new_state

    def _predict(self, state, x0, m, xs_t=None, x0_t=None):
        """The polynomial through the m most recent values at x0 (its
        coefficients carrying the derivatives of the tensor times)."""
        pv = [j < m for j in range(HCAP)]
        host = _lagrange_coef(state.t_hist, pv, x0)
        coef = _carrying(host, lambda xs, x: _lagrange_coef(xs, pv, x),
                         xs_t, x0_t)
        return _combine(coef, state.u_hist)

    def solve(self, fvec, t, dt, u, f0, state: FBDFState, ddt=None,
              t_off=None):
        """The BDF solve of one step at the state's order, the part every
        derivative goes through: (v, f1, err, est_k), est_k the error
        estimate before a failed Newton makes it +inf."""
        kind = type(t)
        n = u.shape[0]
        M = self.mass_matrix
        x0 = kind(t + dt)
        x0_t = stage_time(t, x0, 1.0, ddt, t_off)
        xs_t = None
        if isinstance(x0_t, torch.Tensor) or state.t_off is not None:
            # the history's times and x0 as tensors with their offsets
            tdt = kind_torch_dtype(kind)
            xs_t = torch.as_tensor(state.t_hist, dtype=tdt, device=u.device)
            if state.t_off is not None:
                xs_t = state.t_off + xs_t
            if not isinstance(x0_t, torch.Tensor):
                x0_t = torch.tensor(x0, dtype=tdt, device=u.device)
            xs_t = list(xs_t.unbind())
        J = jacobian(fvec, u, x0_t)
        eyeM = (torch.eye(n, dtype=u.dtype, device=u.device) if M is None
                else torch.as_tensor(M, dtype=u.dtype, device=u.device))
        k_eff = min(state.k, state.n_hist)
        valid = [j < k_eff for j in range(HCAP)]

        w0, w = _carrying(_diff_weights(state.t_hist, valid, x0),
                          lambda xs, x: _diff_weights(xs, valid, x),
                          xs_t, x0_t)
        rhs_hist = _combine(w, state.u_hist)  # Σ_{j>=1} wⱼ uⱼ
        w0 = w0 if isinstance(w0, torch.Tensor) else float(w0)

        # predictor through k+1 values where there are, else k; forward
        # Euler at the very first step
        pred = (self._predict(state, x0, min(k_eff + 1, state.n_hist), xs_t,
                              x0_t) if state.n_hist > 1
                else u + scaled(dt, 1.0, ddt) * f0)

        lu = torch.linalg.lu_factor(w0 * eyeM - J)

        def resid(v):
            Mv = w0 * v + rhs_hist
            return (Mv if M is None else eyeM @ Mv) - fvec(v, x0_t)

        # the predictor starts Newton in its basin: one damping fallback
        alphas = torch.tensor([1.0, 0.5], dtype=u.real.dtype,
                              device=u.device)
        norm = torch.linalg.vector_norm
        v = pred
        for _ in range(self.newton_iters):
            delta = lu_solve(lu, resid(v))
            cand = v[None, :] - alphas[:, None] * delta[None, :]
            gn = torch.stack([norm(resid(c)) for c in cand])
            gn = torch.where(torch.isnan(gn), torch.inf, gn)
            v = cand[torch.argmin(gn)]
        rfin = norm(resid(v))
        bad = ~(rfin <= 1e-6 * (1.0 + norm(v))) | ~torch.isfinite(v).all()

        est_k = (v - pred) / (float(k_eff) + 1.0)
        if M is not None:
            est_k = torch.where(algebraic_rows(eyeM), torch.zeros_like(est_k),
                                est_k)
        err = torch.where(bad, torch.full_like(est_k, torch.inf), est_k)

        f1 = fvec(v, x0_t)
        if M is not None:
            # the BDF formula itself is the consistent slope on a DAE
            f1 = (w0 * v + rhs_hist).to(f1.dtype)
        return v, f1, err, est_k

    def choose_order(self, state: FBDFState, x0, u, v, est_k):
        """The order after an accepted step, and its change dk: after k+1
        accepted steps at order k, the step factors implied by est_{k−1},
        est_k and est_{k+1} move the order one toward the best. Host work
        with one read of the three norms; not differentiated."""
        k_eff = min(state.k, state.n_hist)
        kf = float(k_eff)
        sc = state.atol + state.rtol * torch.maximum(u.abs(), v.abs())

        def enorm(e):
            return torch.sqrt(torch.mean((e / sc).abs() ** 2))

        # est at k-1: the predictor through one fewer value; at k+1, one more
        E_dn = enorm((v - self._predict(state, x0, min(k_eff, state.n_hist)))
                     / kf)
        E_up = enorm((v - self._predict(state, x0,
                                        min(k_eff + 2, state.n_hist)))
                     / (kf + 2.0))
        E_dn, E_k, E_up = torch.stack([E_dn, enorm(est_k), E_up]).tolist()
        tiny = 1e-30
        fac_dn = (E_dn + tiny) ** (-1.0 / kf) if k_eff > 1 else -np.inf
        fac_k = (E_k + tiny) ** (-1.0 / (kf + 1.0))
        can_up = state.k < self.max_order and state.n_hist >= k_eff + 2
        fac_up = (E_up + tiny) ** (-1.0 / (kf + 2.0)) if can_up else -np.inf
        cooldown = state.steps_at_k >= state.k + 1
        best = int(np.argmax([fac_dn, fac_k, fac_up]))
        dk = best - 1 if cooldown else 0
        return min(max(state.k + dk, 1), self.max_order), dk
