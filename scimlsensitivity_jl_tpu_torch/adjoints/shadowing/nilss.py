"""NILSS, non-intrusive least-squares shadowing (PyTorch port).

Counterpart of `scimlsensitivity_jl_tpu/adjoints/shadowing/nilss.py`:
`NILSSProblem` and `nilss_shadow_forward` (Ni & Wang, JCP 2017).

The trajectory is split into `nseg` segments of `nstep` saved points.
Each segment solves the tangent system over z = [u; S]
(`common.augmented_fvec`, one jvp per row, vmapped over the rows): `nus`
homogeneous tangents W (Ẇ = J·W) and one
parameter-seeded tangent v* per parameter (v̇* = J·v* + ∂f/∂pᵢ). At each
interface the tangents are projected ⊥ f and renormalised by QR; a small
least-squares problem over the per-segment coefficients a recovers the
bounded shadowing direction v = v* + W·a, and

  d⟨g⟩/dp = Σ_seg [ ∫ (∂g/∂u)·v dt + ξ_end·(⟨g⟩ − g_end)/dtsave ] / T.

`segment_parallel=True` runs the tangent stage as independent segment
transfer solves (the full homogeneous basis Φ, n rows, plus the npf
parameter-seeded rows from zero) after one primal solve for the segment
starts; the interface recursion then runs on the segment-end transfer
values. The segment solves go through `parallel/ensemble.map_segments`,
one after another on one device, or in contiguous shards over the devices
of `mesh=` (`parallel/ensemble.make_mesh`).

The initial tangents W0 are drawn through the key protocol of
`ops/brownian.py`: `key=None` is `NumpyKey(sensealg.rng_seed)`, which draws
on the host, so the card and the CPU start from the same tangents; a key
that draws with `jax.random` (the tests' `JaxKey`) draws JAX's W0. A kernel field, which has no forward mode, raises
`ForwardModeUnsupported` before anything launches. The result is NaN when
any solve's retcode is not 0.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

from ...ops.brownian import NumpyKey
from ...ops.vjp import make_vjp_kernels, probe_forward_mode
from ...parallel import sharded
from ...sensealg import NILSS
from ...solvers.integrate import Stats, time_dtype
from ...utils.pytree import ravel_pytree, tree_to
from ..common import augmented_fvec, forward_saveat_solve

__all__ = ["NILSSProblem", "nilss_shadow_forward"]


@dataclass
class NILSSProblem:
    """NILSSProblem(prob, NILSS(nseg, nstep); g, dgdu_continuous) (JAX
    nilss.py:51-74)."""

    prob: Any
    sensealg: NILSS
    g: Optional[Callable] = None
    dgdu_continuous: Optional[Callable] = None

    def __post_init__(self):
        sharded.refuse_sharded(self.prob, "NILSSProblem")
        if self.g is None:
            self.g = getattr(self.sensealg, "g", None)
        if self.g is None:
            # the time-dilation terms (⟨g⟩ and the segment-end ξ·(⟨g⟩ − g))
            # evaluate g itself (the reference's check_for_g)
            raise ValueError(
                "NILSS needs the objective g itself (dgdu_continuous alone "
                "is insufficient: the time-dilation terms evaluate g)"
            )


def _project(vecs, dudt):
    """Remove the f-direction at every saved point: vecs (nstep, k, n),
    dudt (nstep, n)."""
    denom = torch.einsum("ti,ti->t", dudt, dudt)
    coef = torch.einsum("tki,ti->tk", vecs, dudt) / denom[:, None]
    return vecs - coef[:, :, None] * dudt[:, None, :]


def _proj_rows(vecs, de):
    return vecs - ((vecs @ de) / (de @ de))[:, None] * de[None]


def _sum_stats(stats):
    """One Stats for several solves: counts summed, the worst retcode."""
    return Stats(n_accepted=sum(s.n_accepted for s in stats),
                 n_rejected=sum(s.n_rejected for s in stats),
                 n_fevals=sum(s.n_fevals for s in stats),
                 retcode=max(s.retcode for s in stats))


def nilss_shadow_forward(nprob: NILSSProblem, solver=None, *, rtol=1e-8,
                         atol=1e-10, max_steps_per_segment=2048,
                         segment_parallel: bool = False, mesh=None,
                         key=None, record=None):
    """d⟨g⟩/dp over tspan for every parameter: (npf,).

    segment_parallel=True: the transfer-operator design (segments solved
    independently, over `mesh`'s devices when given; nseg must then divide
    by the mesh size). key: the W0 draw's key (default
    NumpyKey(sensealg.rng_seed)). record: an `adjoints.continuous.
    AdjointRecord` to fill with the segment solves' summed Stats."""
    from ...solvers.explicit import Tsit5

    solver = solver or Tsit5()
    prob = nprob.prob
    sensealg = nprob.sensealg
    g = nprob.g
    p = prob.p
    t0, t1 = float(prob.tspan[0]), float(prob.tspan[1])
    nseg, nstep = sensealg.nseg, sensealg.nstep

    u0vec = ravel_pytree(prob.u0)[0]
    pflat = ravel_pytree(p)[0]
    dtype, device = u0vec.dtype, u0vec.device
    kind = time_dtype(dtype)
    n = u0vec.shape[0]
    npf = pflat.shape[0]
    nus = sensealg.nus if sensealg.nus is not None else n - 1
    kern = make_vjp_kernels(prob.f, prob.u0, p)
    # a kernel field has no forward mode: refuse before any launch
    probe_forward_mode(lambda uv: kern.fvec(uv, p, kind(t0)), u0vec)

    T_seg = (t1 - t0) / nseg
    dtsave = T_seg / (nstep - 1)

    def seeds(k_hom):
        return torch.cat([u0vec.new_zeros((k_hom, npf)),
                          torch.eye(npf, dtype=dtype, device=device)])

    # initial tangents: W random normalised rows, v* = 0 (nilss.jl:201-210)
    key = NumpyKey(sensealg.rng_seed) if key is None else key
    W0 = key.normal((nus, n), dtype, device)
    W0 = W0 / torch.linalg.norm(W0, dim=1, keepdim=True)
    V0 = u0vec.new_zeros((npf, n))

    # trapezoid weights over a segment (nilss.jl:215-218)
    wq = u0vec.new_ones(nstep)
    wq[0] = wq[-1] = 0.5

    def dudt_rows(u, ts):
        return torch.func.vmap(lambda uu, tt: kern.fvec(uu, p, tt))(
            u, torch.as_tensor(ts, dtype=dtype, device=device))

    stats = []
    if segment_parallel:
        from ...parallel.ensemble import map_segments

        # pass 1: the primal boundary sweep (one solve, nseg + 1 saves)
        bounds = np.linspace(kind(t0), kind(t1), nseg + 1).astype(kind)
        prim = forward_saveat_solve(
            solver, lambda uv, t: kern.fvec(uv, p, t), u0vec, t0, t1, bounds,
            rtol=rtol, atol=atol, max_steps=max_steps_per_segment * nseg,
            store_dense=False)
        stats.append(prim.stats)
        u_starts = prim.ys_save[:-1]

        # pass 2: the segment transfer solves, independent. Φ rows: row k
        # is the tangent from e_k, so W(t) = W_init·Φ(t); V*₀ rows are
        # parameter-seeded from zero
        def seg_transfer(s, dev):
            p_d = tree_to(p, dev)
            aug = augmented_fvec(kern, p_d, n, seeds(n).to(dev))
            z0 = torch.cat([u_starts[s].to(dev),
                            torch.eye(n, dtype=dtype, device=dev).reshape(-1),
                            u0vec.new_zeros(npf * n, device=dev)])
            t_a = kind(t0) + kind(T_seg) * kind(s)
            saveat = (t_a + np.linspace(0.0, T_seg, nstep)).astype(kind)
            fwd = forward_saveat_solve(
                solver, aug, z0, t_a, kind(t_a + kind(T_seg)), saveat,
                rtol=rtol, atol=atol, max_steps=max_steps_per_segment,
                store_dense=False)
            zs = fwd.ys_save
            S = zs[:, n:].reshape(nstep, n + npf, n)
            return (zs[:, :n], S[:, :n], S[:, n:], saveat), fwd.stats

        outs = map_segments(seg_transfer, nseg, mesh, device)
        u_all = torch.stack([o[0][0] for o in outs])
        Phi_all = torch.stack([o[0][1] for o in outs])
        Vst_all = torch.stack([o[0][2] for o in outs])
        seg_ts = [o[0][3] for o in outs]
        stats += [o[1] for o in outs]
        dudt_all = torch.stack([dudt_rows(u_all[s], seg_ts[s])
                                for s in range(nseg)])

        # the interface recursion on the segment-END transfer values
        # (renormalize!, nilss.jl:442-466)
        W_inits, V_inits, Rs, bs = [], [], [], []
        W_init, V_init = W0, V0
        for s in range(nseg):
            W_inits.append(W_init)
            V_inits.append(V_init)
            if s < nseg - 1:
                W_end = W_init @ Phi_all[s, -1]
                V_end = V_init @ Phi_all[s, -1] + Vst_all[s, -1]
                de = dudt_all[s, -1]
                W_perp_end = _proj_rows(W_end, de)
                V_perp_end = _proj_rows(V_end, de)
                Q, R = torch.linalg.qr(W_perp_end.T)
                bseg = Q.T @ V_perp_end.T
                Rs.append(R)
                bs.append(bseg)
                W_init = Q.T
                V_init = (V_perp_end.T - Q @ bseg).T
        W_all = torch.einsum("sjk,stkm->stjm", torch.stack(W_inits), Phi_all)
        V_all = torch.einsum("sjk,stkm->stjm", torch.stack(V_inits),
                             Phi_all) + Vst_all
        Wp_all = torch.stack([_project(W_all[s], dudt_all[s])
                              for s in range(nseg)])
        Vp_all = torch.stack([_project(V_all[s], dudt_all[s])
                              for s in range(nseg)])
        ts_all = np.stack(seg_ts)
    else:
        # the sequential segment sweep (reference forward_sense)
        aug = augmented_fvec(kern, p, n, seeds(nus))
        us, Ws, Vs, Wp_s, Vp_s, duds, Rs, bs, seg_ts = ([] for _ in range(9))
        u_seg, W_seg, V_seg = u0vec, W0, V0
        for iseg in range(nseg):
            t_a = t0 + iseg * T_seg
            t_b = t0 + (iseg + 1) * T_seg
            saveat = np.linspace(kind(t_a), kind(t_b), nstep).astype(kind)
            z0 = torch.cat([u_seg, W_seg.reshape(-1), V_seg.reshape(-1)])
            fwd = forward_saveat_solve(
                solver, aug, z0, t_a, t_b, saveat, rtol=rtol, atol=atol,
                max_steps=max_steps_per_segment, store_dense=False)
            stats.append(fwd.stats)
            zs = fwd.ys_save
            u = zs[:, :n]
            S = zs[:, n:].reshape(nstep, nus + npf, n)
            W, V = S[:, :nus], S[:, nus:]
            dudt = dudt_rows(u, saveat)
            W_perp = _project(W, dudt)
            V_perp = _project(V, dudt)
            us.append(u), Ws.append(W), Vs.append(V)
            Wp_s.append(W_perp), Vp_s.append(V_perp), duds.append(dudt)
            seg_ts.append(saveat)
            if iseg < nseg - 1:
                # QR of the projected homogeneous end-tangents (renormalize!)
                Q, R = torch.linalg.qr(W_perp[-1].T)
                bseg = Q.T @ V_perp[-1].T
                Rs.append(R)
                bs.append(bseg)
                u_seg = u[-1]
                W_seg = Q.T
                V_seg = (V_perp[-1].T - Q @ bseg).T
        u_all, W_all, V_all = torch.stack(us), torch.stack(Ws), torch.stack(Vs)
        Wp_all, Vp_all = torch.stack(Wp_s), torch.stack(Vp_s)
        dudt_all = torch.stack(duds)
        ts_all = np.stack(seg_ts)
    worst = max(s.retcode for s in stats)
    if record is not None:
        record.stats = _sum_stats(stats)
        record.reverse = ("NILSS segment_parallel" if segment_parallel
                          else "NILSS")

    # least squares for a (compute_Cinv!/d!/B!/a!)
    C = torch.einsum("stin,stjn,t->sij", Wp_all, Wp_all, wq)
    d = torch.einsum("stin,stkn,t->sik", Wp_all, Vp_all, wq)
    a = _least_squares(C, d, Rs, bs, nseg, nus, npf)

    # the gradient (shadow_forward, nilss.jl:591-637)
    v = V_all + torch.einsum("sik,stin->stkn", a, W_all)
    rows_u = u_all.reshape(nseg * nstep, n)
    rows_t = ts_all.reshape(-1)
    ts_dev = torch.as_tensor(rows_t, dtype=dtype, device=device)
    # g and dgdu_continuous see the flat state, as in JAX; dgdu_continuous
    # gets t as a host scalar, once per row
    gs = torch.func.vmap(lambda uu, tt: g(uu, p, tt))(rows_u, ts_dev)
    gs = gs.reshape(nseg, nstep)
    if nprob.dgdu_continuous is not None:
        dg = torch.stack([
            ravel_pytree(nprob.dgdu_continuous(rows_u[i], p,
                                               kind(rows_t[i])))[0]
            for i in range(rows_u.shape[0])])
    else:
        dg = torch.func.vmap(torch.func.grad(lambda uu, tt: g(uu, p, tt)))(
            rows_u, ts_dev)
    dg = dg.reshape(nseg, nstep, n).to(dtype)

    Ttot = (nstep - 1) * nseg
    gavg = torch.einsum("st,t->", gs, wq) / Ttot
    res = torch.einsum("stkn,stn,t->k", v, dg, wq) / Ttot
    # the segment-end time-dilation term ξ (compute_xi, nilss.jl:549-563)
    xi_end = torch.einsum("skn,sn->sk", v[:, -1], dudt_all[:, -1]) / (
        torch.einsum("sn,sn->s", dudt_all[:, -1], dudt_all[:, -1])[:, None])
    res = res + torch.sum(xi_end * (gavg - gs[:, -1])[:, None],
                          dim=0) / (dtsave * Ttot)
    if worst != 0:
        res = torch.full_like(res, float("nan"))
    return res


def _least_squares(C, d, Rs, bs, nseg, nus, npf):
    """a (nseg, nus, npf) from the KKT system over the segments
    (compute_Cinv!/d!/B!/a!, nilss.jl:467-525)."""
    dtype, device = C.dtype, C.device
    Cinv = torch.linalg.inv(C)
    Nv = nseg * nus
    Cinv_big = torch.block_diag(*Cinv.unbind())
    d_big = d.reshape(Nv, npf)
    if nseg > 1:
        Bm = C.new_zeros(((nseg - 1) * nus, Nv))
        eye = torch.eye(nus, dtype=dtype, device=device)
        for s in range(nseg - 1):
            Bm[s * nus:(s + 1) * nus, s * nus:(s + 1) * nus] = -Rs[s]
            Bm[s * nus:(s + 1) * nus, (s + 1) * nus:(s + 2) * nus] = eye
        b_big = torch.cat(bs, dim=0)
        lbd = torch.linalg.solve(-(Bm @ Cinv_big @ Bm.T),
                                 Bm @ Cinv_big @ d_big + b_big)
        a = -Cinv_big @ (Bm.T @ lbd + d_big)
    else:
        a = -Cinv_big @ d_big
    return a.reshape(nseg, nus, npf)
