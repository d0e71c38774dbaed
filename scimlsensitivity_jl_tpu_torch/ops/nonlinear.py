"""Newton solver for nonlinear problems f(u, p) = 0 (PyTorch port).

Counterpart of `scimlsensitivity_jl_tpu/ops/nonlinear.py`: `NewtonResult`
and `newton_solve` (:27-80), damped Newton with JAX's batched line search
(the first of the smallest residual norms over `line_search_steps` step
lengths 1, 1/2, 1/4, ...), dense `torch.func.jacfwd` and
`torch.linalg.solve` for n <= `dense_cutoff`, and above it matrix-free
Newton-Krylov: J·v through `torch.func.jvp`, solved by `gmres`.

`gmres` is restarted GMRES with the arithmetic of
`jax.scipy.sparse.linalg.gmres` (its default 'batched' method): x0 = 0,
stop when ‖b − A x‖ <= max(tol·‖b‖, atol) between restarts (maxiter
restarts, default 10·n), each restart an Arnoldi process of `restart`
steps with one classical Gram-Schmidt pass (JAX's `max_iterations=2`
loop runs one), stopped early at a breakdown, then the least-squares
problem Hᵀy = βe₁ by its normal equations and a Cholesky solve. Its
iterates may differ from JAX's at roundoff: the projections and norms
are summed in torch's order, the Cholesky factor is LAPACK's (or
cuSOLVER's) rather than XLA's, and the breakdown test is a host read.

The Newton loop is an eager Python loop with one host read per iteration
(the convergence test and the line search's pick), where JAX runs a
`lax.while_loop`; the line search's candidates are evaluated in a loop,
where JAX vmaps them.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .vjp import jacfwd

__all__ = ["NewtonResult", "newton_solve", "gmres"]


class NewtonResult(NamedTuple):
    u: torch.Tensor
    resid_norm: torch.Tensor
    iters: int
    converged: bool


def _safe_normalize(x, thresh=None):
    """(x/‖x‖, ‖x‖), or (0, 0) where ‖x‖ <= thresh (default eps)."""
    norm = torch.linalg.vector_norm(x)
    if thresh is None:
        thresh = torch.finfo(x.dtype).eps
    use = norm > thresh
    safe = torch.where(use, norm, torch.ones_like(norm))
    return (torch.where(use, x / safe, torch.zeros_like(x)),
            torch.where(use, norm, torch.zeros_like(norm)))


def _gmres_restart(A, b, x0, unit_residual, residual_norm, restart):
    """One restart of batched GMRES: the Arnoldi process over
    K(A, r0, restart), then the projected solution."""
    n = b.shape[0]
    eps = torch.finfo(b.dtype).eps
    V = b.new_zeros(n, restart + 1)
    V[:, 0] = unit_residual
    H = torch.eye(restart, restart + 1, dtype=b.dtype, device=b.device)
    for k in range(restart):
        v = A(V[:, k])
        _, v_norm_0 = _safe_normalize(v)
        h = V.conj().T @ v  # one classical Gram-Schmidt pass
        v = v - V @ h
        unit_v, v_norm_1 = _safe_normalize(v, thresh=eps * v_norm_0)
        V[:, k + 1] = unit_v
        h = h.clone()
        h[k + 1] = v_norm_1
        H[k, :] = h
        if bool(v_norm_1 == 0):
            break
    beta = b.new_zeros(restart + 1)
    beta[0] = residual_norm
    a = H.T
    a2 = a.conj().T @ a
    b2 = a.conj().T @ beta
    chol, info = torch.linalg.cholesky_ex(a2)
    y = torch.cholesky_solve(b2[:, None], chol)[:, 0]
    y = torch.where(info > 0, torch.full_like(y, float("nan")), y)
    x = x0 + V[:, :-1] @ y
    unit_residual, residual_norm = _safe_normalize(b - A(x))
    return x, unit_residual, residual_norm


def gmres(A: Callable, b: torch.Tensor, *, tol: float = 1e-5,
          atol: float = 0.0, restart: int = 20, maxiter=None) -> torch.Tensor:
    """Solve A(x) = b by restarted GMRES from x0 = 0 (the semantics of
    `jax.scipy.sparse.linalg.gmres`, see the module docstring). One host
    read per restart and one per Arnoldi step."""
    n = b.shape[0]
    if maxiter is None:
        maxiter = 10 * n
    restart = min(restart, n)
    b_norm = torch.linalg.vector_norm(b)
    atol_eff = torch.maximum(tol * b_norm, torch.as_tensor(
        atol, dtype=b_norm.dtype, device=b.device))
    x = torch.zeros_like(b)
    unit_residual, residual_norm = _safe_normalize(b - A(x))
    k = 0
    while k < maxiter and bool(residual_norm > atol_eff):
        x, unit_residual, residual_norm = _gmres_restart(
            A, b, x, unit_residual, residual_norm, restart)
        k += 1
    return x


def newton_solve(
    fvec: Callable,  # (uvec) -> residual vec
    u0: torch.Tensor,
    *,
    tol: float = 1e-10,
    max_iters: int = 50,
    dense_cutoff: int = 50,
    line_search_steps: int = 4,
    gmres_restart: int = 20,
) -> NewtonResult:
    """Damped Newton on fvec(u) = 0 from u0; converged when the residual
    norm is <= tol·(1 + ‖u‖). A non-finite residual stops the loop at the
    last finite iterate and, as in JAX (`done | bad`), counts as done."""
    n = u0.shape[0]
    use_dense = n <= dense_cutoff
    norm = torch.linalg.vector_norm

    def step_dir(u, r):
        if use_dense:
            return torch.linalg.solve(jacfwd(fvec, u), r)

        def mv(v):
            return torch.func.jvp(fvec, (u,), (v,))[1]

        return gmres(mv, r, tol=1e-10, restart=min(gmres_restart, n),
                     maxiter=5)

    alphas = 0.5 ** torch.arange(line_search_steps, dtype=u0.dtype,
                                 device=u0.device)
    u = u0
    r_norm = norm(fvec(u0))
    done = bool(r_norm <= tol * (1.0 + norm(u0)))
    it = 0
    while not done and it < max_iters:
        d = step_dir(u, fvec(u))
        cand = u[None, :] - alphas[:, None] * d[None, :]
        r_cand = torch.stack([norm(fvec(c)) for c in cand])
        best = int(torch.argmin(r_cand))
        u_new, r_new = cand[best], r_cand[best]
        conv, finite = (bool(v) for v in torch.stack([
            r_new <= tol * (1.0 + norm(u_new)),
            torch.isfinite(r_new)]).tolist())
        if not finite:
            u_new = u
        u, r_norm, it = u_new, r_new, it + 1
        done = conv or not finite
    return NewtonResult(u=u, resid_norm=r_norm, iters=it, converged=done)
