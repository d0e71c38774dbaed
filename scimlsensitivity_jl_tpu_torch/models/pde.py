"""Method-of-lines PDE model family (PyTorch port).

Counterpart of `scimlsensitivity_jl_tpu/models/pde.py`: `heat1d_field`,
`heat1d_problem`, `brusselator_2d_field` and `brusselator_2d_problem` (the
reference's pde_constrained.md 1-D heat equation and brusselator.md 2-D
Brusselator). The fields are shift/stencil expressions over the whole
grid. The Brusselator's (n, n, 2) state rides `ravel_pytree` through the
solvers as a flat vector, as in JAX. The problems are made on the card
unless the caller passes `device="cpu"`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..problems import ODEProblem

__all__ = [
    "heat1d_field",
    "heat1d_problem",
    "brusselator_2d_field",
    "brusselator_2d_problem",
]


def _d2dx(u, dx: float):
    """2nd-order central second derivative, zero at the boundary rows (the
    reference's d2dx, pde_constrained.md)."""
    interior = (u[2:] - 2.0 * u[1:-1] + u[:-2]) / (dx * dx)
    z = u.new_zeros((1,))
    return torch.cat([z, interior, z])


def heat1d_field(dx: float):
    """u̇ = 2 a₀ u + a₁ ∂²u/∂x² with p = [a₀, a₁] (the reference's
    PDE-constrained optimization target, pde_constrained.md:45-50)."""

    def field(u, p, t):
        return 2.0 * p[0] * u + p[1] * _d2dx(u, dx)

    return field


def heat1d_problem(nx: int = 200, Lx: float = 10.0, T: float = 0.5, p=None,
                   dtype=torch.float64, *, device="cuda"):
    """(ODEProblem, x): u0 = exp(−(x − 3)²) on nx points of [0, Lx],
    p = [1, 1] unless given."""
    x = torch.linspace(0.0, Lx, nx, dtype=dtype, device=device)
    dx = float(x[1] - x[0])
    u0 = torch.exp(-((x - 3.0) ** 2))
    if p is None:
        p = torch.tensor([1.0, 1.0], dtype=dtype, device=device)
    return ODEProblem(heat1d_field(dx), u0, (0.0, T), p), x


def brusselator_2d_field(n: int, alpha: float = 10.0):
    """2-D Brusselator on an n×n periodic grid (brusselator.md):

        u̇ = B + u²v − (A+1)u + α∇²u + f(x,y,t)
        v̇ = Au − u²v + α∇²v

    state (n, n, 2); p = [A, B]. The forcing f matches the reference: 5 on
    the disc (x−0.3)² + (y−0.6)² ≤ 0.01, switched on at t ≥ 1.1."""
    dx = 1.0 / n
    inv_dx2 = 1.0 / (dx * dx)
    xs = np.linspace(0.0, 1.0, n, endpoint=False)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    disc_np = (X - 0.3) ** 2 + (Y - 0.6) ** 2 <= 0.01
    discs = {}  # the disc on each device that asked for it

    def lap(w):
        return (torch.roll(w, 1, 0) + torch.roll(w, -1, 0)
                + torch.roll(w, 1, 1) + torch.roll(w, -1, 1) - 4.0 * w) * inv_dx2

    def field(state, p, t):
        u, v = state[..., 0], state[..., 1]
        A, B = p[0], p[1]
        du = B + u * u * v - (A + 1.0) * u + alpha * lap(u)
        if float(t) >= 1.1:
            if state.device not in discs:
                discs[state.device] = torch.as_tensor(disc_np,
                                                      device=state.device)
            du = du + torch.where(discs[state.device], 5.0, 0.0).to(du.dtype)
        dv = A * u - u * u * v + alpha * lap(v)
        return torch.stack([du, dv], dim=-1)

    return field


def brusselator_2d_problem(n: int = 32, T: float = 2.0, p=None,
                           alpha: float = 10.0, dtype=torch.float64, *,
                           device="cuda"):
    """The Brusselator from u0 = 22(y(1−y))^1.5, v0 = 27(x(1−x))^1.5,
    p = [3.4, 1] unless given."""
    xs = torch.arange(n, dtype=dtype, device=device) / n
    X, Y = torch.meshgrid(xs, xs, indexing="ij")
    u0 = 22.0 * (Y * (1.0 - Y)) ** 1.5
    v0 = 27.0 * (X * (1.0 - X)) ** 1.5
    state0 = torch.stack([u0, v0], dim=-1)
    if p is None:
        p = torch.tensor([3.4, 1.0], dtype=dtype, device=device)
    return ODEProblem(brusselator_2d_field(n, alpha), state0, (0.0, T), p)
