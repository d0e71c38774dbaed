"""NILSAS, non-intrusive least-squares adjoint shadowing (PyTorch port).

Counterpart of `scimlsensitivity_jl_tpu/adjoints/shadowing/nilsas.py`:
`NILSASProblem`, `nilsas_shadow_adjoint` and its `nilsas_min` (Ni &
Talnikar, JCP 2019).

Walking the segments backward, each one solves M homogeneous adjoints W
(Ẇ = −JᵀW) and one inhomogeneous adjoint v* (forced by ∂g/∂u), with QR
renormalisation at the interfaces and the running quadratures

  C = ∫wᵢ·wⱼ, dwv = ∫w·v*, dwf = ∫w·f, dvf = ∫v*·f,
  dJs = ∫∂g/∂p, dvfs/dwfs = ∫−λᵀ∂f/∂p,

which ride in the integrated state with error weight 0. The terminal
condition aligns the last homogeneous adjoint with f(u_T) and makes the
other M−1 random orthogonal, drawn through the key protocol of
`ops/brownian.py` (`key=None` is `NumpyKey(sensealg.rng_seed)`, a host
draw, the same on the card and the CPU; the tests' `JaxKey` draws JAX's). `nilsas_min` solves the small KKT system for the
per-segment coefficients a; the gradient is Σ(dvfs + dJs + dwfs·a)/T.

The primal y(t) is the dense output of one forward solve (`ops/interp.
dense_eval`) at fwd_rtol / fwd_atol. Each evaluation of the right-hand
side takes M+1 pullbacks through one `torch.func.vjp` of the field: on a
plain field one `torch.func.vmap` of its pullback; on a kernel field,
whose Functions have no vmap rule, M+1 calls of the pullback (one K3 and
M+1 K4 launches per evaluation on the fused MLP field). The kernel field
is told apart by `ops.vjp.probe_forward_mode`, which launches nothing.

`segment_parallel=True` solves per segment the full backward transfer
basis (v*₀ and n identity-seeded adjoints Φ) with the bilinear quadrature
carriers G = ∫ΦΦᵀ, h = ∫Φv*₀, pf = ∫Φf, GP = ∫−Φᵀ∂f/∂p, independently
(through `parallel/ensemble.map_segments`, over `mesh`'s devices when
given); the interface recursion then runs on the segment-end values. The
result is NaN when any solve's retcode is not 0.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

from ...ops.brownian import NumpyKey
from ...ops.interp import dense_eval
from ...parallel import sharded
from ...ops.vjp import (ForwardModeUnsupported, make_vjp_kernels,
                        probe_forward_mode)
from ...sensealg import NILSAS
from ...solvers.integrate import integrate, time_dtype
from ...utils.pytree import ravel_pytree
from ..common import forward_saveat_solve
from .nilss import _sum_stats

__all__ = ["NILSASProblem", "nilsas_shadow_adjoint"]


@dataclass
class NILSASProblem:
    """NILSASProblem(prob, NILSAS(nseg, nstep, M); g, dgdu_continuous,
    dgdp_continuous) (JAX nilsas.py:42-57)."""

    prob: Any
    sensealg: NILSAS
    g: Optional[Callable] = None
    dgdu_continuous: Optional[Callable] = None
    dgdp_continuous: Optional[Callable] = None

    def __post_init__(self):
        sharded.refuse_sharded(self.prob, "NILSASProblem")
        if self.g is None:
            self.g = getattr(self.sensealg, "g", None)
        if self.g is None and self.dgdu_continuous is None:
            raise ValueError("NILSAS needs the objective g (or dgdu_continuous)")


def nilsas_shadow_adjoint(nprob: NILSASProblem, solver=None, *, rtol=1e-8,
                          atol=1e-10, fwd_rtol=1e-11, fwd_atol=1e-13,
                          max_steps=16384, max_steps_per_segment=4096,
                          segment_parallel: bool = False, mesh=None,
                          key=None, record=None):
    """d⟨g⟩/dp over tspan for every parameter: (npf,).

    segment_parallel=True: the transfer-operator design (the segments'
    backward transfer solves independent, over `mesh`'s devices when
    given; nseg must then divide by the mesh size). key: the terminal
    draw's key (default NumpyKey(sensealg.rng_seed)). record: an
    `adjoints.continuous.AdjointRecord` to fill with the segment solves'
    summed Stats (`.stats`) and the primal solve's (`.primal`)."""
    from ...solvers.explicit import Tsit5

    solver = solver or Tsit5()
    prob = nprob.prob
    sensealg = nprob.sensealg
    g = nprob.g
    p = prob.p
    t0, t1 = float(prob.tspan[0]), float(prob.tspan[1])
    nseg, M = sensealg.nseg, sensealg.M
    T_seg = (t1 - t0) / nseg

    u0vec, unravel_u = ravel_pytree(prob.u0)
    pflat, unravel_p = ravel_pytree(p)
    dtype, device = u0vec.dtype, u0vec.device
    kind = time_dtype(dtype)
    n = u0vec.shape[0]
    npf = pflat.shape[0]
    kern = make_vjp_kernels(prob.f, prob.u0, p)
    try:
        probe_forward_mode(lambda uv: kern.fvec(uv, p, kind(t1)), u0vec)
        batched = True
    except ForwardModeUnsupported:
        batched = False  # a kernel field: its pullback is called per row

    # the dense forward trajectory over the whole span
    fwd = forward_saveat_solve(
        solver, lambda uv, t: kern.fvec(uv, p, t), u0vec, t0, t1,
        np.asarray([t0, t1], dtype=kind), rtol=fwd_rtol, atol=fwd_atol,
        max_steps=max_steps, store_dense=True)
    dense = fwd.dense
    stats = [fwd.stats]

    dgdu_c, dgdp_c = nprob.dgdu_continuous, nprob.dgdp_continuous
    # g's own gradient, where a callback does not give it
    g_pulled = g is not None and (dgdu_c is None or dgdp_c is None)

    def field(t):
        return lambda u_, pf: kern.fvec(u_, unravel_p(pf), t)

    def pullbacks(y, t, lams):
        """(f(y), the rows λᵀ∂f/∂u and λᵀ∂f/∂p of the rows of lams, ∂g/∂u,
        ∂g/∂p), flat. ∂g comes from the callbacks where given, else from
        one `torch.func.grad` of g (zeros where g does not read p)."""
        gu = gp = None
        fval, pull = torch.func.vjp(field(t), y, pflat)
        if batched:
            ubars, pbars = torch.func.vmap(pull)(lams)
        else:
            rows = [pull(lam) for lam in lams]
            ubars = torch.stack([r[0] for r in rows])
            pbars = torch.stack([r[1] for r in rows])
        if g_pulled:
            gu, gp = torch.func.grad(
                lambda uu, pf: g(unravel_u(uu), unravel_p(pf), t),
                argnums=(0, 1))(y, pflat)
        if dgdu_c is not None:
            gu = ravel_pytree(dgdu_c(unravel_u(y), p, t))[0].to(dtype)
        if dgdp_c is not None:
            gp = ravel_pytree(dgdp_c(unravel_u(y), p, t))[0].to(dtype)
        elif g is None:
            gp = y.new_zeros(npf)
        return fval, ubars, pbars, gu, gp

    # state layout: [v*(n); W(M·n); gv(npf); gW(M·npf); C(M²); dwv(M);
    #                dwf(M); dvf(1); dJs(npf)]
    oW = n
    ogv = oW + M * n
    ogW = ogv + npf
    oC = ogW + M * npf
    odwv = oC + M * M
    odwf = odwv + M
    odvf = odwf + M
    odJs = odvf + 1
    ntot = odJs + npf

    def aug_rhs(z, t):
        y = dense_eval(dense, t)
        vstar = z[:n]
        W = z[oW:ogv].reshape(M, n)
        lams = torch.cat([vstar[None], W])  # (M+1, n)
        fval, ubars, pbars, gu, gp = pullbacks(y, t, lams)
        # quadrature derivatives (signs as in the reference backward RHS)
        return torch.cat([
            -ubars[0] - gu, -ubars[1:].reshape(-1), -pbars[0],
            -pbars[1:].reshape(-1), -(W @ W.T).reshape(-1), -(W @ vstar),
            -(W @ fval), -torch.dot(vstar, fval)[None], -gp])

    # error control on the adjoint states only
    wts = u0vec.new_zeros(ntot)
    wts[:ogv] = 1.0

    # the terminal condition (terminate_conditions, nilsas.jl:150-185)
    y_T = dense_eval(dense, kind(t1))
    f_T = kern.fvec(y_T, p, kind(t1))
    f_unit = f_T / torch.linalg.norm(f_T)
    key = NumpyKey(sensealg.rng_seed) if key is None else key
    if M > 1:
        Wr = key.normal((n, M - 1), dtype, device)
        Wr = Wr - f_unit[:, None] * (f_unit @ Wr)[None, :]
        Q0, _ = torch.linalg.qr(Wr)
        W_init = torch.cat([Q0[:, :M - 1], f_unit[:, None]], dim=1)  # (n, M)
    else:
        W_init = f_unit[:, None]
    vstar_init = u0vec.new_zeros(n)

    def pack(vstar, W_cols):
        z = u0vec.new_zeros(ntot)
        z[:n] = vstar
        z[oW:ogv] = W_cols.T.reshape(-1)  # rows = adjoints
        return z

    Rs = u0vec.new_zeros((nseg, M, M))
    bs = u0vec.new_zeros((nseg, M))
    C_seg = u0vec.new_zeros((nseg, M, M))
    dwv_seg = u0vec.new_zeros((nseg, M))
    dwf_seg = u0vec.new_zeros((nseg, M))
    dvf_seg = u0vec.new_zeros((nseg,))
    dJs_seg = u0vec.new_zeros((nseg, npf))
    dvfs_seg = u0vec.new_zeros((nseg, npf))
    dwfs_seg = u0vec.new_zeros((nseg, M, npf))
    seg_stats = []

    if segment_parallel:
        from ...parallel.ensemble import map_segments

        # state: [v*₀(n); Φ(n²); gv₀(npf); GP(n·npf); G(n²); h(n); pf(n);
        #         vf(1); dJs(npf)]; Φ rows seeded with the identity, so any
        #         terminal adjoint value reconstructs by linearity
        pW = n
        pgv = pW + n * n
        pGP = pgv + npf
        pG = pGP + n * npf
        ph = pG + n * n
        ppf = ph + n
        pvf = ppf + n
        pdJ = pvf + 1
        ptot = pdJ + npf

        def aug_rhs_T(zz, t):
            y = dense_eval(dense, t)
            vstar = zz[:n]
            Phi = zz[pW:pgv].reshape(n, n)
            lams = torch.cat([vstar[None], Phi])  # (n+1, n)
            fval, ubars, pbars, gu, gp = pullbacks(y, t, lams)
            return torch.cat([
                -ubars[0] - gu, (-ubars[1:]).reshape(-1), -pbars[0],
                (-pbars[1:]).reshape(-1), (-(Phi @ Phi.T)).reshape(-1),
                -(Phi @ vstar), -(Phi @ fval), -torch.dot(vstar, fval)[None],
                -gp])

        wtsT = u0vec.new_zeros(ptot)
        wtsT[:pgv] = 1.0
        z0T = u0vec.new_zeros(ptot)
        z0T[pW:pgv] = torch.eye(n, dtype=dtype, device=device).reshape(-1)

        def seg_transfer(iseg, dev):
            # the segment ends as JAX's t0 + T_seg·(arange(nseg) + 1)
            t_hi = kind(kind(t0) + kind(kind(T_seg)
                                        * kind(kind(iseg) + kind(1.0))))
            if dev != device:
                raise NotImplementedError(
                    "NILSAS segment_parallel reads the primal's dense "
                    "output on the state's device; give a mesh of that "
                    "device")
            res = integrate(solver, aug_rhs_T, t_hi, kind(t_hi - kind(T_seg)),
                            z0T, rtol=rtol, atol=atol,
                            max_steps=max_steps_per_segment,
                            store_dense=False, err_weights=wtsT)
            return res.u_final, res.stats

        outs = map_segments(seg_transfer, nseg, mesh, device)
        seg_stats = [o[1] for o in outs]

        # the right-to-left interface recursion on segment-END transfer
        # values (renormalize!, nilsas.jl:349-377)
        W_rows = W_init.T   # (M, n)
        v_row = vstar_init  # (n,)
        for iseg in range(nseg - 1, -1, -1):
            ze = outs[iseg][0]
            Phi_e = ze[pW:pgv].reshape(n, n)
            G = ze[pG:ph].reshape(n, n)
            GP = ze[pGP:pG].reshape(n, npf)
            C_seg[iseg] = W_rows @ G @ W_rows.T
            dwv_seg[iseg] = W_rows @ (ze[ph:ppf] + G @ v_row)
            dwf_seg[iseg] = W_rows @ ze[ppf:pvf]
            dvf_seg[iseg] = ze[pvf] + v_row @ ze[ppf:pvf]
            dvfs_seg[iseg] = ze[pgv:pGP] + v_row @ GP
            dwfs_seg[iseg] = W_rows @ GP
            dJs_seg[iseg] = ze[pdJ:]
            W_end = W_rows @ Phi_e
            v_end = ze[:n] + v_row @ Phi_e
            Q, R = torch.linalg.qr(W_end.T)
            b = Q.T @ v_end
            Rs[iseg] = R
            bs[iseg] = b
            W_rows = Q.T
            v_row = v_end - Q @ b
    else:
        z = pack(vstar_init, W_init)
        for iseg in range(nseg - 1, -1, -1):
            t_a = t0 + (iseg + 1) * T_seg
            t_b = t0 + iseg * T_seg
            res = integrate(solver, aug_rhs, kind(t_a), kind(t_b), z,
                            rtol=rtol, atol=atol,
                            max_steps=max_steps_per_segment,
                            store_dense=False, err_weights=wts)
            seg_stats.append(res.stats)
            ze = res.u_final
            vstar = ze[:n]
            W = ze[oW:ogv].reshape(M, n).T  # (n, M) columns = adjoints
            Q, R = torch.linalg.qr(W)
            b = Q.T @ vstar
            Rs[iseg] = R
            bs[iseg] = b
            C_seg[iseg] = ze[oC:odwv].reshape(M, M)
            dwv_seg[iseg] = ze[odwv:odwf]
            dwf_seg[iseg] = ze[odwf:odvf]
            dvf_seg[iseg] = ze[odvf]
            dJs_seg[iseg] = ze[odJs:]
            dvfs_seg[iseg] = ze[ogv:ogW]
            dwfs_seg[iseg] = ze[ogW:oC].reshape(M, npf)
            z = pack(vstar - Q @ b, Q)
    worst = max(s.retcode for s in stats + seg_stats)
    if record is not None:
        record.stats = _sum_stats(seg_stats)
        record.primal = fwd.stats
        record.reverse = ("NILSAS segment_parallel" if segment_parallel
                          else "NILSAS")

    a = _nilsas_min(C_seg, dwv_seg, dwf_seg, dvf_seg, Rs, bs, nseg, M)

    # the gradient (shadow_adjoint, nilsas.jl:489-505)
    res_grad = torch.sum(dvfs_seg, dim=0) + torch.sum(dJs_seg, dim=0)
    res_grad = res_grad + torch.einsum("smk,sm->k", dwfs_seg, a)
    res_grad = res_grad / (nseg * T_seg)
    if worst != 0:
        res_grad = torch.full_like(res_grad, float("nan"))
    return res_grad


def _nilsas_min(C_seg, dwv_seg, dwf_seg, dvf_seg, Rs, bs, K, M):
    """a (K, M) from the KKT system over the segments (nilsas_min,
    nilsas.jl:422-476; JAX nilsas.py:328-353)."""
    dtype, device = C_seg.dtype, C_seg.device
    Cinv_big = torch.block_diag(*torch.linalg.inv(C_seg).unbind())
    Bm = C_seg.new_zeros((M * K - M + 1, M * K))
    eye = torch.eye(M, dtype=dtype, device=device)
    for i in range(K - 1):
        Bm[i * M:(i + 1) * M, i * M:(i + 1) * M] = eye
        Bm[i * M:(i + 1) * M, (i + 1) * M:(i + 2) * M] = -Rs[i + 1]
    for i in range(K):
        Bm[-1, i * M:(i + 1) * M] = dwf_seg[i]
    d = dwv_seg.reshape(-1)
    b_vec = torch.cat([bs[1:].reshape(-1), -torch.sum(dvf_seg)[None]])
    lam = torch.linalg.solve(-(Bm @ Cinv_big @ Bm.T),
                             Bm @ Cinv_big @ d + b_vec)
    return (-Cinv_big @ (Bm.T @ lam + d)).reshape(K, M)
