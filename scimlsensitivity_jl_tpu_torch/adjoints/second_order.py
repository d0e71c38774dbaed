"""Second-order sensitivities (PyTorch port).

Counterpart of `scimlsensitivity_jl_tpu/adjoints/second_order.py`:
`second_order_sensitivities` (:173), `second_order_sensitivity_product`
(:197) and the `ForwardDiffOverAdjoint` unwrapping (`_unwrap_fdoa` :51).

Mode: reverse over reverse. The JAX package composes forward over
reverse, `jax.jacfwd` over the gradient program. `torch.func.jacfwd` runs
its function under `vmap`, and the port's adaptive loop reads each step's
error norm on the host (`.item()`), which `vmap` cannot batch; so the port
takes the gradient once with `create_graph=True` and differentiates it
again with `torch.autograd.grad`, one pass per Hessian row (one for H·v).
Step sizes and accept decisions are host numbers, so they are constants
of the derivative, as JAX's `stop_gradient` on dt makes them.

  * DirectAdjoint (the default): autograd through the eager step loop,
    twice: the exact second derivative of the discrete program.
  * GaussAdjoint or InterpolatingAdjoint, bare or wrapped in
    `ForwardDiffOverAdjoint`: the continuous rule's backward is itself a
    program of tensor operations and `torch.func` pullbacks, so its
    gradient is differentiated again; where it reads the forward's saved
    states, the second pass runs the rule once more (the dense-output
    cotangents of `sol(t)`). JAX differentiates its own explicit
    Gauss-hook program instead (:80-150); both approximate the same
    Hessian to the solver tolerances.
  * GaussKronrodAdjoint and QuadratureAdjoint are refused as in JAX
    (:61): their quadrature controls would not steer the Hessian.

A field whose pullback is a kernel (`fused_rd1d`, `fused_mlp2`, the RK4
block) has no second derivative: the second pass raises
`ops.vjp.DoubleBackwardUnsupported`, as JAX's custom_vjp kernels refuse
jvp. It never returns a Hessian with the kernel's terms missing.
"""

from __future__ import annotations

import torch

from ..problems import remake
from ..parallel import sharded
from ..sensealg import (DirectAdjoint, ForwardDiffOverAdjoint, GaussAdjoint,
                        GaussKronrodAdjoint, QuadratureAdjoint)
from ..solve import solve
from ..utils.pytree import ravel_pytree

__all__ = ["second_order_sensitivities", "second_order_sensitivity_product"]


def _unwrap_fdoa(sensealg):
    """ForwardDiffOverAdjoint(adjalg) -> the continuous adjoint it wraps
    (GaussAdjoint by default)."""
    if isinstance(sensealg, ForwardDiffOverAdjoint):
        return sensealg.adjalg or GaussAdjoint()
    return sensealg


def _gradient(loss, prob, solver, sensealg, solve_kwargs):
    """(x, dL/dp at x with its graph): x the flat parameters, a fresh leaf."""
    sharded.refuse_sharded(prob, "second-order sensitivities")
    sensealg = _unwrap_fdoa(sensealg) or DirectAdjoint()
    if isinstance(sensealg, (GaussKronrodAdjoint, QuadratureAdjoint)):
        raise NotImplementedError(
            f"{type(sensealg).__name__}: its quadrature controls (abstol, "
            "reltol, max_depth) do not steer a Hessian; use GaussAdjoint or "
            "InterpolatingAdjoint (the same gradients), or DirectAdjoint "
            "for the discrete path")
    pflat, unravel_p = ravel_pytree(prob.p)
    x = pflat.detach().clone().requires_grad_(True)
    sol = solve(remake(prob, p=unravel_p(x)), solver, sensealg=sensealg,
                **solve_kwargs)
    (grad,) = torch.autograd.grad(loss(sol), x, create_graph=True)
    return x, grad


def second_order_sensitivities(loss, prob, solver=None, *, sensealg=None,
                               **solve_kwargs):
    """Hessian of `loss(sol)` with respect to prob.p, flattened: (npf,
    npf). loss: ODESolution -> scalar tensor. sensealg: DirectAdjoint (the
    default), GaussAdjoint, InterpolatingAdjoint or ForwardDiffOverAdjoint
    of one of the two; solve_kwargs go to `solve`."""
    x, grad = _gradient(loss, prob, solver, sensealg, solve_kwargs)
    rows = [torch.autograd.grad(grad[i], x, retain_graph=True)[0]
            for i in range(grad.numel())]
    return torch.stack(rows).detach()


def second_order_sensitivity_product(loss, prob, v, solver=None, *,
                                     sensealg=None, **solve_kwargs):
    """H·v with respect to prob.p without forming H: one more reverse pass
    of the gradient against v (flat, or shaped like p). The pass gives
    (∂g/∂p)ᵀv, g the gradient, which is H·v for the symmetric Hessian;
    a continuous rule's H is symmetric to the solver tolerance."""
    x, grad = _gradient(loss, prob, solver, sensealg, solve_kwargs)
    if not isinstance(v, (torch.Tensor, dict)):
        v = torch.as_tensor(v)
    vflat = ravel_pytree(v)[0].to(dtype=x.dtype, device=x.device)
    (hv,) = torch.autograd.grad(grad, x, grad_outputs=vflat)
    return hv.detach()
