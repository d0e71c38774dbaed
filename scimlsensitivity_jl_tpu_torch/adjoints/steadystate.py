"""SteadyStateAdjoint, the implicit-function-theorem adjoint (PyTorch port).

Counterpart of `scimlsensitivity_jl_tpu/adjoints/steadystate.py`:
`NonlinearSolution`, `solve_nonlinear` (:52-158) and
`solve_unconstrained_optimization` (:162-177). For u* with f(u*, p) = 0
and a loss L(u*):

    solve (∂f/∂u)ᵀ λ = ∂L/∂u,   dL/dp = −λᵀ ∂f/∂p,   dL/du0 = 0

The JAX `custom_vjp` becomes a `torch.autograd.Function` whose forward is
`ops.nonlinear.newton_solve` and whose backward takes one of JAX's
branches: the dense (∂f/∂u)ᵀ solve (`linsolve="direct"`, or n <=
`dense_cutoff` by default), or the matrix-free one, whose operator is one
`torch.func.vjp` of f solved by `ops.nonlinear.gmres`; its residual is
checked against `check_reltol`, and a failed solve falls back to the
dense one for n <= `dense_fallback_cutoff` or poisons the gradient with
NaN above it (`verbose` prints which), never a silently wrong gradient.
`solve_unconstrained_optimization` applies the same rule to ∇_u φ = 0
through `torch.func.grad`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from ..ops.nonlinear import gmres, newton_solve
from ..ops.vjp import jacfwd
from ..problems import NonlinearProblem, SteadyStateProblem
from ..sensealg import SteadyStateAdjoint
from ..utils.pytree import ravel_pytree

__all__ = ["NonlinearSolution", "solve_nonlinear",
           "solve_unconstrained_optimization"]


@dataclass
class NonlinearSolution:
    """u: the root (like u0); resid: the residual norm (a 0-d tensor);
    retcode: 0 converged, 1 not; iters: Newton iterations."""

    u: Any
    resid: torch.Tensor
    retcode: int
    iters: int
    prob: Any = None


class _Root(torch.autograd.Function):
    """(u0vec, pflat) -> u*; backward = the IFT adjoint."""

    @staticmethod
    def forward(ctx, u0vec, pflat, rule):
        u = rule.newton(u0vec, pflat)
        ctx.rule = rule
        ctx.save_for_backward(u, pflat)
        return u

    @staticmethod
    def backward(ctx, d_u):
        u, pflat = ctx.saved_tensors
        dp = ctx.rule.adjoint(u, pflat, d_u)
        return torch.zeros_like(u), dp, None


class _IFTRule:
    """The Newton forward and the adjoint backward of one solve."""

    def __init__(self, f, unravel_u, unravel_p, has_p, sensealg, tol,
                 max_iters, verbose):
        self.f, self.unravel_u, self.unravel_p = f, unravel_u, unravel_p
        self.has_p, self.sensealg = has_p, sensealg
        self.tol, self.max_iters, self.verbose = tol, max_iters, verbose
        self.result = None

    def fv(self, uv, pflat):
        p = self.unravel_p(pflat) if self.has_p else None
        return ravel_pytree(self.f(self.unravel_u(uv), p))[0].to(uv.dtype)

    def newton(self, u0vec, pflat):
        self.result = newton_solve(
            lambda uv: self.fv(uv, pflat), u0vec, tol=self.tol,
            max_iters=self.max_iters,
            dense_cutoff=self.sensealg.dense_cutoff)
        return self.result.u

    def adjoint(self, uvec, pflat, d_u):
        sa, n = self.sensealg, uvec.shape[0]
        gbar = d_u.reshape(-1).to(uvec.dtype)
        fu = lambda uv: self.fv(uv, pflat)
        use_dense = sa.linsolve == "direct" or (sa.linsolve is None
                                                and n <= sa.dense_cutoff)

        def dense_solve():
            return torch.linalg.solve(jacfwd(fu, uvec).T, gbar)

        if use_dense:
            lam = dense_solve()
        else:
            # (∂f/∂u)ᵀ·v through one vjp of f, matrix-free
            _, pullback = torch.func.vjp(fu, uvec)
            mtv = lambda v: pullback(v)[0]
            restart = min(30, n)
            lam = gmres(mtv, gbar, tol=sa.linsolve_reltol, restart=restart,
                        maxiter=min(100, max(10, -(-n // restart))))
            norm = torch.linalg.vector_norm
            resid = norm(mtv(lam) - gbar)
            ok = bool(resid <= sa.check_reltol * torch.clamp(norm(gbar),
                                                             min=1e-30))
            fallback = n <= sa.dense_fallback_cutoff
            if not ok and self.verbose:
                print("[scimlsensitivity] SteadyStateAdjoint: GMRES did not "
                      f"converge (resid={float(resid)}); "
                      + ("falling back to dense solve" if fallback
                         else "NaN-poisoning the gradient"))
            if not ok:
                lam = (dense_solve() if fallback
                       else torch.full_like(lam, float("nan")))
        if not self.has_p:
            return pflat.new_zeros(0)
        # dL/dp = −λᵀ ∂f/∂p
        _, pull_p = torch.func.vjp(lambda pf: self.fv(uvec, pf), pflat)
        return -pull_p(lam)[0]


def solve_nonlinear(
    prob,
    *,
    sensealg: SteadyStateAdjoint = SteadyStateAdjoint(),
    tol: float = 1e-10,
    max_iters: int = 50,
    verbose: bool = False,
) -> NonlinearSolution:
    """Solve f(u, p) = 0 by damped Newton; gradients with respect to p by
    the IFT adjoint (u0 gets 0: the root does not depend on the guess)."""
    if isinstance(prob, SteadyStateProblem):
        nlprob = prob.to_nonlinear()
    elif isinstance(prob, NonlinearProblem):
        nlprob = prob
    else:
        raise TypeError("expected NonlinearProblem/SteadyStateProblem, got "
                        f"{type(prob)}")
    u0vec, unravel_u = ravel_pytree(nlprob.u0)
    has_p = nlprob.p is not None
    if has_p:
        pflat, unravel_p = ravel_pytree(nlprob.p)
    else:
        pflat, unravel_p = u0vec.new_zeros(0), None
    rule = _IFTRule(nlprob.f, unravel_u, unravel_p, has_p, sensealg, tol,
                    max_iters, verbose)
    ustar = _Root.apply(u0vec, pflat, rule)
    res = rule.result
    return NonlinearSolution(u=unravel_u(ustar), resid=res.resid_norm,
                             retcode=0 if res.converged else 1,
                             iters=res.iters, prob=prob)


def solve_unconstrained_optimization(
    objective: Callable,
    u0,
    p,
    *,
    sensealg: SteadyStateAdjoint = SteadyStateAdjoint(),
    tol: float = 1e-10,
    max_iters: int = 100,
    verbose: bool = False,
) -> NonlinearSolution:
    """Differentiate argmin_u φ(u, p) by treating ∇_u φ = 0 as a steady
    state (UnconstrainedOptimizationAdjoint). objective(u, p) -> scalar."""
    grad_f = torch.func.grad(objective, argnums=0)
    prob = NonlinearProblem(lambda u, p_: grad_f(u, p_), u0, p)
    return solve_nonlinear(prob, sensealg=sensealg, tol=tol,
                           max_iters=max_iters, verbose=verbose)
