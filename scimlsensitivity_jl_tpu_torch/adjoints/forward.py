"""Continuous forward sensitivity (PyTorch port).

Counterpart of `scimlsensitivity_jl_tpu/adjoints/forward.py`:
`_augmented_fvec`, `make_forward_sensitivity_solve_fn`,
`ODEForwardSensitivityProblem` and `extract_local_sensitivities`.

The augmented ODE over z = [u; S] has Ṡₖ = J·Sₖ + ∂f/∂pₖ: each column is
one `torch.func.jvp` of f in the direction (Sₖ, eₖ), vmapped over the
columns, so J is never materialized. The adaptive controller's error norm
runs over all of z, as in JAX, so both packages take the same steps.

Two surfaces:
  * `ODEForwardSensitivityProblem` / `extract_local_sensitivities`, the
    direct API, with p-directions only;
  * the ForwardSensitivity sensealg, a `torch.autograd.Function` whose
    backward contracts the saved sensitivities with the cotangents. Its
    tangent block carries n u0-directions too, so du0 is exact.

A field whose kernel has no forward-mode rule (`ops.rd1d.fused_rd1d`,
`ops.mlp.fused_mlp2`) raises `ops.vjp.ForwardModeUnsupported` here, as the
JAX package's `custom_vjp` kernels refuse `jax.jvp`.

Deliberate divergence (ROADMAP §3): the sensealg's backward contracts the
cotangent of `sol.u_final` with the final sensitivities; the JAX rule drops
that cotangent, so its gradient of a loss on u_final is silently zero.
"""

from __future__ import annotations

import torch

from ..ops.vjp import make_vjp_kernels
from ..parallel import sharded
from ..problems import ODEProblem
from ..solvers.integrate import time_dtype
from ..utils.pytree import ravel_pytree
from .common import augmented_fvec, forward_saveat_solve, match_cotangents
from .continuous import AuxOut, SolveOptions

__all__ = [
    "make_forward_sensitivity_solve_fn",
    "ODEForwardSensitivityProblem",
    "extract_local_sensitivities",
]


class _ForwardSensSolve(torch.autograd.Function):
    """(u0vec, pflat) -> (saveat rows of u, u_final); backward = the saved
    sensitivities contracted with the cotangents."""

    @staticmethod
    def forward(ctx, u0vec, pflat, run):
        ys, u_final, S_save, S_final = run(u0vec, pflat)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(u0vec, pflat, S_save, S_final)
        return ys, u_final

    @staticmethod
    def backward(ctx, d_ys, d_uf):
        u0vec, pflat, S_save, S_final = ctx.saved_tensors
        n = u0vec.numel()
        # dL/d(direction k) = Σ_t Δ_t · S_t[k] + Δ_final · S_final[k]
        contracted = S_final.new_zeros(S_final.shape[0])
        if d_ys is not None:
            contracted = contracted + torch.einsum("ti,tki->k", d_ys, S_save)
        if d_uf is not None:
            contracted = contracted + S_final @ d_uf
        du0, dp = match_cotangents(contracted[:n], contracted[n:],
                                   (u0vec, pflat))
        return du0, dp, None


def make_forward_sensitivity_solve_fn(f, solver, sensealg, opts: SolveOptions,
                                      t0, t1):
    """ForwardSensitivity as a solve rule: the forward pass solves [u; S]
    with S spanning u0- and p-directions; the backward contracts S with the
    cotangents (the discrete dL/dθ = Σᵢ Δᵢᵀ S(tᵢ))."""

    def solve_fn(u0, p, saveat):
        u0vec, unravel_u = ravel_pytree(u0)
        pflat, unravel_p = ravel_pytree(p)
        if p is None:
            pflat = u0vec.new_zeros(0)
        n, npf = u0vec.numel(), pflat.numel()
        kind = time_dtype(u0vec.dtype)
        out = {}

        def run(u0v, pf):
            p_ = unravel_p(pf) if p is not None else None
            kern = make_vjp_kernels(f, u0, p_)
            aug = augmented_fvec(kern, p_, n, torch.cat([
                u0v.new_zeros(n, npf),
                torch.eye(npf, dtype=u0v.dtype, device=u0v.device)]))
            S0 = torch.cat([torch.eye(n, dtype=u0v.dtype, device=u0v.device),
                            u0v.new_zeros(npf, n)])
            fwd = forward_saveat_solve(
                solver, aug, torch.cat([u0v, S0.reshape(-1)]),
                kind(t0), kind(t1), saveat, rtol=opts.rtol, atol=opts.atol,
                dt0=opts.dt0, max_steps=opts.max_steps, tstops=opts.tstops,
                store_dense=opts.dense, dtmax=opts.dtmax)
            dense = fwd.dense
            if dense is not None:  # sol(t) returns u(t), not [u; S]
                dense = dense._replace(ys=dense.ys[:, :n], fs=dense.fs[:, :n])
            out["aux"] = AuxOut(dense=dense, t_final=fwd.t_final,
                                u_final=None, stats=fwd.stats)
            nt = fwd.ys_save.shape[0]
            return (fwd.ys_save[:, :n], fwd.u_final[:n],
                    fwd.ys_save[:, n:].reshape(nt, n + npf, n),
                    fwd.u_final[n:].reshape(n + npf, n))

        ys, u_final = _ForwardSensSolve.apply(u0vec, pflat, run)
        return unravel_u(ys), out["aux"]._replace(u_final=u_final)

    return solve_fn


def ODEForwardSensitivityProblem(f, u0, tspan, p, sensealg=None) -> ODEProblem:
    """The augmented problem over [u; S] with p-directions only (the
    reference's src/forward_sensitivity.jl:420-597). Solve it with `solve`
    and unpack with `extract_local_sensitivities`."""
    if sharded.is_sharded(u0):
        raise sharded.refuse("ODEForwardSensitivityProblem")
    u0vec, unravel_u = ravel_pytree(u0)
    pflat, unravel_p = ravel_pytree(p)
    n, npf = u0vec.numel(), pflat.numel()
    kern = make_vjp_kernels(f, u0, p)
    aug = augmented_fvec(kern, p, n, torch.eye(npf, dtype=u0vec.dtype,
                                               device=u0vec.device))

    def f_aug(z, p_, t):
        # p_ rides along for API parity; the closure's kern reads p, so a
        # problem for other parameters is built anew
        return aug(z, t)

    z0 = torch.cat([u0vec, u0vec.new_zeros(npf * n)])
    prob = ODEProblem(f_aug, z0, tspan, p)
    object.__setattr__(prob, "_fwd_sens_meta", (n, npf, unravel_u, unravel_p))
    return prob


def extract_local_sensitivities(sol, i=None):
    """Split an ODEForwardSensitivityProblem solution into (u, S) (the
    reference's src/forward_sensitivity.jl:730-852).

    Without `i`: (u (nt, n), S (nt, npf, n)). With an integer `i`: that
    time index only."""
    meta = getattr(sol.prob, "_fwd_sens_meta", None)
    if meta is not None:
        n, npf = meta[0], meta[1]
    else:
        npf = ravel_pytree(sol.prob.p)[0].numel()
        n = sol.ys.shape[-1] // (npf + 1)
    ys = sol.ys
    u = ys[:, :n]
    S = ys[:, n:].reshape(ys.shape[0], npf, n)
    if i is not None:
        return u[i], S[i]
    return u, S
