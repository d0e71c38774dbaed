"""Least-squares shadowing, forward and adjoint (PyTorch port).

Counterpart of `scimlsensitivity_jl_tpu/adjoints/shadowing/lss.py`:
`_build_lss`, `_schur_solve`, `_Bt_w`, `_B_x`, `_dgdu_nodes`,
`_dgdp_nodes`, `_fp_blocks`, `ForwardLSSProblem`, `AdjointLSSProblem`,
`shadow_forward` and `shadow_adjoint` (Wang, Hu & Blonigan 2014).

On the nodes u_j at ts (the solved trajectory) and the midpoints, B is
block-bidiagonal with blocks ∓I/dtᵢ − J(u_midᵢ)/2, E holds the columns
dudtᵢ (TimeDilation only), and the Schur system
S = B·diag(wB⁻¹)·Bᵀ [+ E·diag(wE⁻¹)·Eᵀ] is block-tridiagonal with n×n
blocks (the node weights are scalars). It is never assembled dense: a
block-Thomas elimination, a forward and a backward sweep with one n×n
`torch.linalg.solve` per block and every right-hand side together, solves
it in O(Nt·n²) memory.

The midpoint Jacobians and the ∂f/∂p blocks are one `torch.func.vmap` of
`jacfwd` each. A kernel field, which has no forward mode, raises
`ForwardModeUnsupported` by name before anything launches
(`ops.vjp.probe_forward_mode`, before jacfwd builds its n×n basis), as
the JAX package's `custom_vjp` kernels refuse `jax.jacfwd`.
A user Jacobian (`prob.jac`) is called once per midpoint. Callbacks
(dgdu, dgdp) are called once per node with t as a host scalar, where JAX
vmaps them; g is vmapped. As in JAX, g and the callbacks see the flat
state.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

from ...ops.vjp import make_vjp_kernels, probe_forward_mode
from ...parallel import sharded
from ...sensealg import (AdjointLSS, Cos2Windowing, CosWindowing, ForwardLSS,
                         TimeDilation)
from ...utils.pytree import ravel_pytree, tree_leaves

__all__ = ["ForwardLSSProblem", "AdjointLSSProblem", "shadow_forward",
           "shadow_adjoint"]


@dataclass
class _LSSData:
    sensealg: Any
    ts: torch.Tensor          # (Nt,) on the state's device and dtype
    ts_host: np.ndarray       # (Nt,) the same times on the host
    us: torch.Tensor          # (Nt, n) node states (flat)
    umid: torch.Tensor        # (Ndt, n)
    dudt: torch.Tensor        # (Ndt, n)
    dt: torch.Tensor          # (Ndt,)
    Bl: torch.Tensor          # (Ndt, n, n) block (i, i) of B
    Br: torch.Tensor          # (Ndt, n, n) block (i, i+1) of B
    Sd: torch.Tensor          # (Ndt, n, n) Schur diagonal blocks
    Su: torch.Tensor          # (Ndt-1, n, n) Schur super-diagonal blocks
    wBinv: torch.Tensor       # (Nt,) scalar node weights
    wEinv: Optional[torch.Tensor]  # (Ndt,)
    p: Any
    kern: Any
    g: Optional[Callable]
    dgdu: Optional[Callable]
    dgdp: Optional[Callable]
    n: int
    npf: int
    unravel_p: Callable


def _tmid(data: _LSSData) -> torch.Tensor:
    return 0.5 * (data.ts[1:] + data.ts[:-1])


def _build_lss(sol, sensealg, dgdu, dgdp, g):
    if g is None:
        g = getattr(sensealg, "g", None)
    regularizer = sensealg.LSSregularizer
    if isinstance(regularizer, TimeDilation) and g is None:
        raise ValueError("TimeDilation LSS requires the objective g")
    prob = sol.prob
    p = prob.p
    if p is None:
        raise ValueError("parameter sensitivities need parameters")
    u0vec = ravel_pytree(prob.u0)[0]
    pflat, unravel_p = ravel_pytree(p)
    n = u0vec.shape[0]
    npf = pflat.shape[0]
    kern = make_vjp_kernels(prob.f, prob.u0, p, user_jac=prob.jac)

    us = torch.cat([leaf.reshape(leaf.shape[0], -1)
                    for leaf in tree_leaves(sol.ys)], dim=1)  # (Nt, n)
    ts_host = np.asarray(torch.as_tensor(sol.ts).detach().cpu().numpy())
    ts = torch.as_tensor(ts_host, dtype=us.dtype, device=us.device)
    Nt = ts.shape[0]
    dt = ts[1:] - ts[:-1]
    umid = 0.5 * (us[1:] + us[:-1])
    dudt = (us[1:] - us[:-1]) / dt[:, None]
    dT = ts[-1] - ts[0]

    # Jacobians at the midpoints, one batched sweep; a kernel field refuses
    # first, before any launch and before jacfwd's n×n basis exists
    tmid = 0.5 * (ts[1:] + ts[:-1])
    probe_forward_mode(lambda u: kern.fvec(u, p, float(tmid[0])), umid[0])
    if prob.jac is not None:
        J = torch.stack([kern.jac_u(umid[i], p, float(tmid[i]))
                         for i in range(Nt - 1)])
    else:
        J = torch.func.vmap(torch.func.jacfwd(
            lambda u, t: kern.fvec(u, p, t)))(umid, tmid)

    eye = torch.eye(n, dtype=us.dtype, device=us.device)
    Bl = -eye[None] / dt[:, None, None] - J / 2.0  # block (i, i)
    Br = eye[None] / dt[:, None, None] - J / 2.0   # block (i, i+1)

    # node weights wB⁻¹: 2ΔT / (dt-sum at the node), a scalar per node,
    # which keeps S block-tridiagonal with dense n×n blocks
    denom = torch.cat([dt[:1], dt[1:] + dt[:-1], dt[-1:]])
    wBinv = 2.0 * dT / denom  # (Nt,)

    # S = B diag(wB⁻¹⊗I) Bᵀ (+ E diag(wE⁻¹) Eᵀ), blockwise:
    #   S[i,i]   = w_i Bl_i Bl_iᵀ + w_{i+1} Br_i Br_iᵀ (+ wE_i d_i d_iᵀ)
    #   S[i,i+1] = w_{i+1} Br_i Bl_{i+1}ᵀ
    BlT = Bl.transpose(1, 2)
    BrT = Br.transpose(1, 2)
    Sd = (wBinv[:-1, None, None] * (Bl @ BlT)
          + wBinv[1:, None, None] * (Br @ BrT))
    Su = wBinv[1:-1, None, None] * (Br[:-1] @ BlT[1:])

    if isinstance(regularizer, TimeDilation):
        wEinv = dT / (regularizer.alpha ** 2 * dt)
        Sd = Sd + wEinv[:, None, None] * torch.einsum("ij,ik->ijk", dudt,
                                                      dudt)
    else:
        wEinv = None

    return _LSSData(
        sensealg=sensealg, ts=ts, ts_host=ts_host, us=us, umid=umid,
        dudt=dudt, dt=dt, Bl=Bl, Br=Br, Sd=Sd, Su=Su, wBinv=wBinv,
        wEinv=wEinv, p=p, kern=kern, g=g, dgdu=dgdu, dgdp=dgdp, n=n,
        npf=npf, unravel_p=unravel_p,
    )


def _schur_solve(data: _LSSData, rhs: torch.Tensor) -> torch.Tensor:
    """Solve S x = rhs for the block-tridiagonal SPD Schur matrix by
    block-Thomas elimination (SPD, so stable without pivoting): JAX's two
    `lax.scan`s as two sweeps. rhs: (Ndt, n, k), all k columns together."""
    Sd, Su = data.Sd, data.Su
    Ndt, n, _ = Sd.shape
    k = rhs.shape[-1]
    G = y = None  # G_{i-1}, y_{i-1}
    Gs, ys = [], []
    for i in range(Ndt):
        if i == 0:  # S[0, -1] = 0
            C, rhs_i = Sd[0], rhs[0]
        else:
            Sl = Su[i - 1].T  # S[i, i-1]
            C = Sd[i] - Sl @ G
            rhs_i = rhs[i] - Sl @ y
        Su_i = Su[i] if i < Ndt - 1 else Sd.new_zeros((n, n))
        aug = torch.linalg.solve(C, torch.cat([Su_i, rhs_i], dim=1))
        G, y = aug[:, :n], aug[:, n:]
        Gs.append(G)
        ys.append(y)
    xs = [None] * Ndt
    x = Sd.new_zeros((n, k))
    for i in range(Ndt - 1, -1, -1):
        x = ys[i] - Gs[i] @ x
        xs[i] = x
    return torch.stack(xs)  # (Ndt, n, k)


def _Bt_w(data: _LSSData, w: torch.Tensor) -> torch.Tensor:
    """Bᵀ w blockwise: node j gets Bl_jᵀ w_j + Br_{j-1}ᵀ w_{j-1}.
    w: (Ndt, n, k) -> (Nt, n, k)."""
    left = torch.einsum("iab,iak->ibk", data.Bl, w)
    right = torch.einsum("iab,iak->ibk", data.Br, w)
    z = left.new_zeros((1,) + tuple(left.shape[1:]))
    return torch.cat([left, z]) + torch.cat([z, right])


def _B_x(data: _LSSData, x_nodes: torch.Tensor) -> torch.Tensor:
    """B x blockwise: row i = Bl_i x_i + Br_i x_{i+1}. (Nt, n) -> (Ndt, n)."""
    return (torch.einsum("iab,ib->ia", data.Bl, x_nodes[:-1])
            + torch.einsum("iab,ib->ia", data.Br, x_nodes[1:]))


def _rows(data: _LSSData, fn, us, ts_host):
    """fn(u, p, t, i) flattened at each row i, t a host scalar; u is the
    flat state, as JAX passes it."""
    return torch.stack([
        ravel_pytree(fn(us[i], data.p, float(ts_host[i]), i))[0].to(us.dtype)
        for i in range(us.shape[0])])


def _dgdu_nodes(data: _LSSData) -> torch.Tensor:
    """∂g/∂u at every node, (Nt, n)."""
    if data.dgdu is not None:
        return _rows(data, data.dgdu, data.us, data.ts_host)
    if data.g is None:
        raise ValueError("need g or dgdu_continuous")
    g, p = data.g, data.p
    return torch.func.vmap(torch.func.grad(lambda u, t: g(u, p, t)))(
        data.us, data.ts)


def _dgdp_nodes(data: _LSSData, us, ts, ts_host) -> torch.Tensor:
    """∂g/∂p at the given rows, (m, npf); zeros without dgdp and g."""
    if data.dgdp is not None:
        return _rows(data, data.dgdp, us, ts_host)
    if data.g is not None:
        g, unravel_p = data.g, data.unravel_p
        pflat = ravel_pytree(data.p)[0]

        def gp(u, t):
            return torch.func.grad(lambda pf: g(u, unravel_p(pf), t))(pflat)

        return torch.func.vmap(gp)(us, ts)
    return us.new_zeros((us.shape[0], data.npf))


def _fp_blocks(data: _LSSData, us, ts) -> torch.Tensor:
    """∂f/∂p at the given states, (m, n, npf), one batched sweep (a kernel
    field was refused in `_build_lss`)."""
    kern, unravel_p = data.kern, data.unravel_p
    pflat = ravel_pytree(data.p)[0]
    if us.shape[0] == 0:
        return us.new_zeros((0, data.n, data.npf))
    jac = torch.func.jacfwd(lambda pf, u, t: kern.fvec(u, unravel_p(pf), t))
    return torch.func.vmap(jac, in_dims=(None, 0, 0))(pflat, us, ts)


def _lift_continuous(dgdu_discrete, dgdu_continuous):
    if dgdu_discrete is not None:
        return dgdu_discrete
    if dgdu_continuous is not None:
        return lambda u, p, tt, i: dgdu_continuous(u, p, tt)
    return None


class ForwardLSSProblem:
    """ForwardLSSProblem(sol, ForwardLSS(...); dgdu_*, dgdp_*, g): the
    forward LSS problem on a solved trajectory (JAX lss.py:202-224). The
    callbacks take (u, p, t, i) (discrete) or (u, p, t) (continuous)."""

    def __init__(self, sol, sensealg: ForwardLSS, t=None, dgdu_discrete=None,
                 dgdp_discrete=None, dgdu_continuous=None,
                 dgdp_continuous=None, g=None):
        sharded.refuse_sharded(sol.prob, "ForwardLSSProblem")
        self.data = _build_lss(
            sol, sensealg, _lift_continuous(dgdu_discrete, dgdu_continuous),
            _lift_continuous(dgdp_discrete, dgdp_continuous), g)
        self.sensealg = sensealg


class AdjointLSSProblem:
    """AdjointLSSProblem(sol, AdjointLSS(...); ...): the adjoint LSS
    problem, with the TimeDilation regularizer only (JAX lss.py:227-253)."""

    def __init__(self, sol, sensealg: AdjointLSS, t=None, dgdu_discrete=None,
                 dgdp_discrete=None, dgdu_continuous=None,
                 dgdp_continuous=None, g=None):
        sharded.refuse_sharded(sol.prob, "AdjointLSSProblem")
        if not isinstance(sensealg.LSSregularizer, TimeDilation):
            raise NotImplementedError(
                "AdjointLSS supports the TimeDilation regularizer "
                "(as in the reference, lss.jl:676)"
            )
        self.data = _build_lss(
            sol, sensealg, _lift_continuous(dgdu_discrete, dgdu_continuous),
            _lift_continuous(dgdp_discrete, dgdp_continuous), g)
        self.sensealg = sensealg


def _skip_window(data: _LSSData, reg: TimeDilation):
    """(n0, n1): the nodes of the TimeDilation window, found on the host."""
    ts_np = data.ts_host
    Nt = ts_np.shape[0]
    n0 = int(np.searchsorted(ts_np, ts_np[0] + reg.t0skip, side="left"))
    n1 = int(np.searchsorted(ts_np, ts_np[-1] - reg.t1skip, side="left"))
    return n0, min(n1, Nt - 1)


def _g_rows(data: _LSSData, us, ts) -> torch.Tensor:
    g, p = data.g, data.p
    if us.shape[0] == 0:
        return us.new_zeros((0,))
    return torch.func.vmap(lambda u, t: g(u, p, t))(us, ts)


def shadow_forward(prob: ForwardLSSProblem) -> torch.Tensor:
    """d⟨g⟩/dp via forward LSS (JAX lss.py:256-305), every parameter
    batched: (npf,)."""
    data = prob.data
    reg = data.sensealg.LSSregularizer
    ts = data.ts
    tmid = _tmid(data)

    b = _fp_blocks(data, data.umid, tmid)                 # (Ndt, n, npf)
    w = _schur_solve(data, b)                             # (Ndt, n, npf)
    v = data.wBinv[:, None, None] * _Bt_w(data, w)        # (Nt, n, npf)

    gu = _dgdu_nodes(data)                                # (Nt, n)
    gp = _dgdp_nodes(data, data.us, ts, data.ts_host)     # (Nt, npf)
    vdot = torch.einsum("ji,jik->jk", gu, v) + gp         # (Nt, npf)

    if isinstance(reg, (CosWindowing, Cos2Windowing)):
        dT = ts[-1] - ts[0]
        win = 1.0 - torch.cos((ts - ts[0]) * (2.0 * np.pi / dT))
        if isinstance(reg, Cos2Windowing):
            win = win ** 2
        win = win / torch.sum(win)
        return torch.einsum("j,jk->k", win, vdot)

    # TimeDilation with its skip window; (Eᵀw)_i = dudt_i · w_i
    eta = data.wEinv[:, None] * torch.einsum("ij,ijk->ik", data.dudt, w)
    n0, n1 = _skip_window(data, reg)
    n_mid = n1 - n0

    res = torch.mean(vdot[n0:n1 + 1], dim=0)
    gmid = _g_rows(data, data.umid[n0:n1], tmid[n0:n1])
    eta_w = eta[n0:n1]
    res = res - torch.einsum("jk,j->k", eta_w, gmid) / n_mid
    res = res + torch.sum(eta_w, dim=0) * torch.sum(gmid) / n_mid ** 2
    return res


def shadow_adjoint(prob: AdjointLSSProblem) -> torch.Tensor:
    """d⟨g⟩/dp via adjoint LSS (JAX lss.py:308-356): (npf,)."""
    data = prob.data
    reg = data.sensealg.LSSregularizer
    ts = data.ts
    Nt = ts.shape[0]
    Ndt = Nt - 1
    tmid = _tmid(data)

    gu = _dgdu_nodes(data)                                # (Nt, n)
    wB_corr = data.wBinv[:, None] * gu / Nt               # (Nt, n)

    gmid = _g_rows(data, data.umid, tmid)
    h = -(gmid - torch.mean(gmid)) / Ndt
    h = data.wEinv * h                                    # (Ndt,)

    # E h blockwise (row i = dudt_i·h_i) + B wB_corr blockwise
    b_adj = data.dudt * h[:, None] + _B_x(data, wB_corr)  # (Ndt, n)
    wa = _schur_solve(data, b_adj[:, :, None])[..., 0]    # (Ndt, n)

    n0, n1 = _skip_window(data, reg)
    gp = _dgdp_nodes(data, data.umid[n0:n1], tmid[n0:n1],
                     0.5 * (data.ts_host[1:] + data.ts_host[:-1])[n0:n1])
    res = (torch.mean(gp, dim=0) if gp.shape[0]
           else ts.new_zeros(data.npf))
    fp = _fp_blocks(data, data.umid[n0:n1], tmid[n0:n1])  # (m, n, npf)
    return res + torch.einsum("jik,ji->k", fp, wa[n0:n1])
