"""Synthetic-digits neural-ODE classification (PyTorch port).

Counterpart of `scimlsensitivity_jl_tpu/models/digits.py`:
`synthetic_digits`, `digits_node_init`, `digits_node_apply` and
`make_digits_train_step`.

The set is generated in the repository: 10 smooth 8×8 prototypes, each
sample a prototype rolled by a random shift in {-1, 0, 1}² plus Gaussian
pixel noise. The model: a 64 → feature linear encoder, the continuous-depth
block u̇ = MLP(tanh u) on [0, 1] (Tsit5, rtol 1e-3,
BacksolveAdjoint(checkpointing=True)), a linear 10-way head. The field is
the plain `mlp_apply`, as in JAX: no kernel.

`jax.random` keys become `torch.Generator`s (different numbers from one
seed, so parity tests hand both packages JAX's arrays through numpy);
tensors are made on the card unless the caller passes `device="cpu"`. JAX
vmaps the batch of solves; here the batch goes through
`parallel.ensemble.solve_ensemble`'s loop, one solve per image.
"""

from __future__ import annotations

import torch

from ..problems import ODEProblem, remake
from ..sensealg import BacksolveAdjoint
from .neural_ode import mlp_apply, mlp_init

__all__ = ["synthetic_digits", "digits_node_init", "digits_node_apply",
           "make_digits_train_step"]


def synthetic_digits(generator: torch.Generator, n: int = 1200,
                     noise: float = 0.35, dtype=torch.float32, *,
                     device="cuda"):
    """(x (n, 64), y (n,)): 10-class shifted-prototype images, drawn from
    `generator` on its own device."""
    gd = generator.device
    raw = torch.randn((10, 8, 8), generator=generator, dtype=dtype, device=gd)
    # smooth the prototypes (3x3 box blur, wrapped) so shifts are meaningful
    proto = raw
    for ax in (1, 2):
        proto = (torch.roll(proto, 1, ax) + proto
                 + torch.roll(proto, -1, ax)) / 3.0
    proto = proto / torch.std(proto, dim=(1, 2), keepdim=True, correction=0)
    y = torch.randint(0, 10, (n,), generator=generator, device=gd)
    dx = torch.randint(-1, 2, (n, 2), generator=generator, device=gd)
    # img[(r - dx0) mod 8, (c - dx1) mod 8]: both rolls at once
    ar = torch.arange(8, device=gd)
    rows = (ar[None, :] - dx[:, :1]) % 8
    cols = (ar[None, :] - dx[:, 1:]) % 8
    x = proto[y[:, None, None], rows[:, :, None], cols[:, None, :]]
    x = x.reshape(n, 64)
    x = x + noise * torch.randn(x.shape, generator=generator, dtype=dtype,
                                device=gd)
    return x.to(device), y.to(device)


def digits_node_init(generator: torch.Generator, feature: int = 32,
                     hidden: int = 64, dtype=torch.float32, *, device="cuda"):
    """{"encode": 64→feature, "field": feature→hidden→feature, "head":
    feature→10}, Glorot-initialised by `mlp_init`."""
    return {
        "encode": mlp_init(generator, (64, feature), dtype, device=device),
        "field": mlp_init(generator, (feature, hidden, feature), dtype,
                          device=device),
        "head": mlp_init(generator, (feature, 10), dtype, device=device),
    }


def _field(u, p, t):
    return mlp_apply(p, torch.tanh(u))


def digits_node_apply(params, x, *, solver=None, sensealg=None, rtol=1e-3,
                      atol=1e-6, max_steps=128, unroll=False):
    """Logits: (10,) for one 64-pixel image x, (B, 10) for a batch (B, 64),
    whose solves run one per image through `solve_ensemble`."""
    from ..parallel.ensemble import EnsembleProblem, solve_ensemble
    from ..solvers.explicit import Tsit5

    if solver is None:
        solver = Tsit5()
    if sensealg is None:
        sensealg = BacksolveAdjoint(checkpointing=True)
    h0 = mlp_apply(params["encode"], x)
    single = h0.dim() == 1
    h0 = h0[None] if single else h0
    ens = EnsembleProblem(
        ODEProblem(_field, h0[0], (0.0, 1.0), params["field"]),
        prob_func=lambda prob, i: remake(prob, u0=h0[i]),
        output_func=lambda sol, i: sol.ys[-1])
    hT = solve_ensemble(ens, solver, trajectories=h0.shape[0],
                        saveat=[0.0, 1.0], rtol=rtol, atol=atol,
                        max_steps=max_steps, sensealg=sensealg,
                        unroll=unroll)
    logits = mlp_apply(params["head"], hT)
    return logits[0] if single else logits


def make_digits_train_step(optimizer: torch.optim.Optimizer, **apply_kw):
    """(step, loss_fn): loss_fn(params, xb, yb) is the softmax
    cross-entropy over the batch; step(params, xb, yb) takes one step of
    `optimizer` (built over the tensors of params, which it updates in
    place) and returns the loss before it."""

    def loss_fn(params, xb, yb):
        logits = digits_node_apply(params, xb, **apply_kw)
        logz = torch.log_softmax(logits, dim=-1)
        return -torch.mean(logz[torch.arange(xb.shape[0]), yb])

    def step(params, xb, yb):
        optimizer.zero_grad()
        loss = loss_fn(params, xb, yb)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step, loss_fn
