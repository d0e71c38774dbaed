"""Neural-ODE model family (PyTorch port).

Counterpart of `scimlsensitivity_jl_tpu/models/neural_ode.py`: `mlp_init`,
`mlp_apply`, `neural_ode_field`, `spiral_data`, `spiral_neural_ode`,
`mnist_node_init`, `mnist_node_apply` and `neural_sde` (:107-139).

Parameters are plain dicts {'W0','b0','W1','b1',...}, as in the JAX
package, so `solve`'s autograd rules take them unchanged. `jax.random` keys
become explicit `torch.Generator`s; the two give different numbers from one
seed, so parity tests hand both packages the same numpy weights instead.
Parameters are made on the card unless the caller passes `device="cpu"`.

The fields use `mlp_apply`, as the JAX ones do. The fused kernel field is
the caller's choice, as in JAX:
`lambda u, p, t: ops.mlp.fused_mlp2(p, u ** 3)` for the spiral.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from ..problems import ODEProblem, SDEProblem

__all__ = [
    "mlp_init",
    "mlp_apply",
    "neural_ode_field",
    "spiral_neural_ode",
    "spiral_data",
    "mnist_node_init",
    "mnist_node_apply",
    "neural_sde",
]

SPIRAL_A = ((-0.1, 2.0), (-2.0, -0.1))


def mlp_init(generator: torch.Generator, sizes: Sequence[int],
             dtype=torch.float32, scale=None, *, device="cuda"):
    """Glorot-initialised MLP parameters {'W0','b0','W1','b1',...}: W_i is
    a standard normal draw times sqrt(2 / (fan_in + fan_out)) (or `scale`),
    b_i is zero. Draws come from `generator` on its own device."""
    params = {}
    for i, (m, n) in enumerate(zip(sizes[:-1], sizes[1:])):
        s = scale if scale is not None else math.sqrt(2.0 / (m + n))
        w = torch.randn((m, n), generator=generator, dtype=torch.float32,
                        device=generator.device)
        params[f"W{i}"] = (w.to(device=device, dtype=dtype)
                           * torch.tensor(s, dtype=dtype, device=device))
        params[f"b{i}"] = torch.zeros((n,), dtype=dtype, device=device)
    return params


def mlp_apply(params, x, activation=torch.tanh):
    """The MLP on x of shape (..., fan_in); no activation after the last
    layer."""
    n_layers = len(params) // 2
    h = x
    for i in range(n_layers):
        h = h @ params[f"W{i}"] + params[f"b{i}"]
        if i < n_layers - 1:
            h = activation(h)
    return h


def neural_ode_field(activation=torch.tanh):
    """f(u, p, t) = MLP_p(u), on single states and batched (..., d)."""

    def f(u, p, t):
        return mlp_apply(p, u, activation)

    return f


def spiral_data(dtype=torch.float32, nt: int = 30, T: float = 1.5, *,
                device="cuda"):
    """The spiral ODE of the reference benchmark,
    du/dt = [[-0.1, 2], [-2, -0.1]]·u³ with u0 = [2, 0], and its nt save
    times on [0, T]. Returns (ODEProblem, ts)."""
    ts = torch.linspace(0.0, T, nt, dtype=dtype, device=device)
    A = torch.tensor(SPIRAL_A, dtype=dtype, device=device)
    u0 = torch.tensor([2.0, 0.0], dtype=dtype, device=device)

    def f(u, p, t):
        return (u ** 3) @ A.T

    return ODEProblem(f, u0, (0.0, float(T)), None), ts


def spiral_neural_ode(generator: torch.Generator = None, hidden: int = 50,
                      dtype=torch.float32, *, device="cuda"):
    """2→hidden→2 tanh MLP on u³ (the standard spiral parameterisation) and
    a problem factory. Returns (params, make_prob) with
    make_prob(params, u0=None, T=1.5) -> ODEProblem."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    params = mlp_init(generator, (2, hidden, 2), dtype, device=device)

    def f(u, p, t):
        return mlp_apply(p, u ** 3)

    def make_prob(p, u0=None, T=1.5):
        if u0 is None:
            u0 = torch.tensor([2.0, 0.0], dtype=dtype, device=device)
        return ODEProblem(f, u0, (0.0, float(T)), p)

    return params, make_prob


def neural_sde(generator: torch.Generator = None, d: int = 2,
               hidden: int = 32, dtype=torch.float32, sigma_scale=0.1, *,
               device="cuda"):
    """Neural SDE: drift MLP_f(u) (d → hidden → d, tanh) and diagonal
    diffusion sigma_scale·softplus(MLP_g(u)). Returns (params, make_prob)
    with params {"drift": ..., "diffusion": ...} and make_prob(params,
    u0=None, T=1.0) -> SDEProblem (diagonal noise). The fused kernel field
    is the caller's choice, as for the ODE models: `fused_mlp2(p["drift"],
    u)` in an SDEProblem of its own."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    params = {
        "drift": mlp_init(generator, (d, hidden, d), dtype, device=device),
        "diffusion": mlp_init(generator, (d, hidden, d), dtype,
                              device=device),
    }

    def f(u, p, t):
        return mlp_apply(p["drift"], u)

    def g(u, p, t):
        return sigma_scale * torch.nn.functional.softplus(
            mlp_apply(p["diffusion"], u))

    def make_prob(p, u0=None, T=1.0):
        if u0 is None:
            u0 = torch.ones((d,), dtype=dtype, device=device)
        return SDEProblem(f, g, u0, (0.0, float(T)), p, noise="diagonal")

    return params, make_prob


# -- MNIST neural-ODE classifier -----------------------------------------------


def mnist_node_init(generator: torch.Generator, hidden: int = 64,
                    feature: int = 64, dtype=torch.float32, *, device="cuda"):
    """784 → feature encoder, ODE block (feature→hidden→feature), 10-way
    head."""
    return {
        "encode": mlp_init(generator, (784, feature), dtype, device=device),
        "field": mlp_init(generator, (feature, hidden, feature), dtype,
                          device=device),
        "head": mlp_init(generator, (feature, 10), dtype, device=device),
    }


def mnist_node_apply(params, x, solve_fn):
    """x: (batch, 784). solve_fn(prob) -> ODESolution (the caller chooses the
    solver and sensealg). Returns (batch, 10) logits."""
    h = torch.tanh(mlp_apply(params["encode"], x))

    def f(u, p, t):
        return mlp_apply(p, torch.tanh(u))

    sol = solve_fn(ODEProblem(f, h, (0.0, 1.0), params["field"]))
    return mlp_apply(params["head"], sol.ys[-1])
