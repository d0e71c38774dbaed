"""Classic benchmark problems (PyTorch port).

Counterpart of `scimlsensitivity_jl_tpu/models/classic.py`: the
Lotka–Volterra, Robertson and Lorenz fields and their `*_problem` builders,
with the JAX package's initial states, parameters and spans. The problems
are made on the card unless the caller passes `device="cpu"`. Robertson is
stiff: solve it with `FBDF`, `Rosenbrock23`, the SDIRK family or `Seulex`
(`solvers/`).
"""

from __future__ import annotations

import torch

from ..problems import ODEProblem

__all__ = [
    "lotka_volterra",
    "lotka_volterra_problem",
    "robertson",
    "robertson_problem",
    "lorenz",
    "lorenz_problem",
]


def lotka_volterra(u, p, t):
    x, y = u[0], u[1]
    a, b, c, d = p[0], p[1], p[2], p[3]
    return torch.stack([a * x - b * x * y, -c * y + d * x * y])


def lotka_volterra_problem(tspan=(0.0, 10.0), dtype=torch.float64, *,
                           device="cuda"):
    """u0 = [1, 1], p = [1.5, 1, 3, 1]."""
    return ODEProblem(
        lotka_volterra,
        torch.tensor([1.0, 1.0], dtype=dtype, device=device),
        tspan,
        torch.tensor([1.5, 1.0, 3.0, 1.0], dtype=dtype, device=device),
    )


def robertson(u, p, t):
    y1, y2, y3 = u[0], u[1], u[2]
    k1, k2, k3 = p[0], p[1], p[2]
    return torch.stack([
        -k1 * y1 + k3 * y2 * y3,
        k1 * y1 - k2 * y2 ** 2 - k3 * y2 * y3,
        k2 * y2 ** 2,
    ])


def robertson_problem(tspan=(0.0, 1e4), dtype=torch.float64, *,
                      device="cuda"):
    """u0 = [1, 0, 0], p = [0.04, 3e7, 1e4]."""
    return ODEProblem(
        robertson,
        torch.tensor([1.0, 0.0, 0.0], dtype=dtype, device=device),
        tspan,
        torch.tensor([0.04, 3e7, 1e4], dtype=dtype, device=device),
    )


def lorenz(u, p, t):
    x, y, z = u[0], u[1], u[2]
    sigma, rho, beta = p[0], p[1], p[2]
    return torch.stack([sigma * (y - x), x * (rho - z) - y, x * y - beta * z])


def lorenz_problem(tspan=(0.0, 10.0), rho=28.0, dtype=torch.float64, *,
                   device="cuda"):
    """u0 = [1, 0, 0], p = [10, rho, 8/3]."""
    return ODEProblem(
        lorenz,
        torch.tensor([1.0, 0.0, 0.0], dtype=dtype, device=device),
        tspan,
        torch.tensor([10.0, rho, 8.0 / 3.0], dtype=dtype, device=device),
    )
