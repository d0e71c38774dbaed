"""ESDIRK solvers with modified-Newton stages (PyTorch port).

Counterpart of `scimlsensitivity_jl_tpu/solvers/sdirk.py`: `ESDIRKTableau`,
`ESDIRK` and the `TRBDF2`, `Kvaerno3` and `SDIRK4` tableaus (:31-231),
with `with_mass_matrix`. Each implicit stage solves

    M·kᵢ = f(t + cᵢh,  u + h·Σ_{j<i} aᵢⱼkⱼ + h·γ·kᵢ)

by damped modified Newton with the step-frozen W = M − h·γ·J, factored
once per step (`torch.linalg.lu_factor`) and reused across stages and
iterations; J from the field's `.jac` hook or `torch.func.jacfwd`. Newton
runs JAX's fixed iteration count, each iteration taking the best of the
step lengths 1, 1/2, 1/4 by residual norm (a NaN norm counts as +inf),
chosen on the device; a stage whose final residual exceeds
1e-6·(1 + ‖k‖), or that is not finite, makes the step's error +inf, so
the controller rejects it. The embedded error is filtered through W⁻¹
(Hosea-Shampine), with a mass matrix's algebraic rows excluded before
and after the filter. Nothing in a step reads the device. Where the
step's start or length carries a derivative (`t_off`, `ddt`, as
`ExplicitRK.step` takes them), h·γ, every h·aᵢⱼ, h·bᵢ and the error's
h·eᵢ are `explicit.scaled` tensors, J is taken at t_off + t and each stage
time goes through `explicit.stage_time`: the values are unchanged, and
autograd runs through every Newton iteration, as JAX differentiates its
fixed-count loop.

ESDIRK: first stage explicit (k₁ = f₀, FSAL), diagonal γ elsewhere;
stiffly accurate (b = last row), so f1 = k_last. SDIRK4 is all implicit.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from .explicit import scaled, stage_time
from .rosenbrock import jacobian, lu_solve

__all__ = ["ESDIRKTableau", "ESDIRK", "TRBDF2", "Kvaerno3", "SDIRK4",
           "TRBDF2_TAB", "KVAERNO3_TAB", "SDIRK4_TAB"]


class ESDIRKTableau(NamedTuple):
    a: Tuple[Tuple[float, ...], ...]  # full rows with the diagonal
    b_err: Tuple[float, ...]  # b - b_hat
    c: Tuple[float, ...]
    gamma: float
    order: int
    first_explicit: bool = True  # ESDIRK: k1 = f0; SDIRK: stage 1 implicit


_SQRT2 = math.sqrt(2.0)
_G_TR = 2.0 - _SQRT2  # TRBDF2 gamma (c2)
_D_TR = _G_TR / 2.0
_W_TR = _SQRT2 / 4.0

TRBDF2_TAB = ESDIRKTableau(
    a=(
        (_D_TR, _D_TR),
        (_W_TR, _W_TR, _D_TR),
    ),
    # b = (w, w, d) stiffly accurate; bhat = ((1-w)/3, (3w+1)/3, d/3)
    b_err=(
        _W_TR - (1.0 - _W_TR) / 3.0,
        _W_TR - (3.0 * _W_TR + 1.0) / 3.0,
        _D_TR - _D_TR / 3.0,
    ),
    c=(0.0, _G_TR, 1.0),
    gamma=_D_TR,
    order=2,
)

# Kvaerno (2004) ESDIRK 3(2): gamma = 0.4358665215084590
_G_K3 = 0.4358665215084590
_A31_K3 = 0.490563388419108
_A32_K3 = 0.073570090080892
_B1_K3 = 0.308809969973036
_B2_K3 = 1.490563388254106
_B3_K3 = -1.235239879727145

KVAERNO3_TAB = ESDIRKTableau(
    a=(
        (_G_K3, _G_K3),
        (_A31_K3, _A32_K3, _G_K3),
        (_B1_K3, _B2_K3, _B3_K3, _G_K3),
    ),
    # b = row 4 (stiffly accurate); bhat = row 3 extended with 0
    b_err=(
        _B1_K3 - _A31_K3,
        _B2_K3 - _A32_K3,
        _B3_K3 - _G_K3,
        _G_K3,
    ),
    c=(0.0, 2.0 * _G_K3, 1.0, 1.0),
    gamma=_G_K3,
    order=3,
)

# Hairer-Wanner SDIRK4 (Solving ODEs II, Table 6.5): 5 stages, L-stable,
# order 4 with an embedded order-3 estimate, gamma = 1/4, all stages
# implicit, stiffly accurate
_B_S4 = (25 / 24, -49 / 48, 125 / 16, -85 / 12, 1 / 4)
_BH_S4 = (59 / 48, -17 / 96, 225 / 32, -85 / 12, 0.0)

SDIRK4_TAB = ESDIRKTableau(
    a=(
        (1 / 4,),
        (1 / 2, 1 / 4),
        (17 / 50, -1 / 25, 1 / 4),
        (371 / 1360, -137 / 2720, 15 / 544, 1 / 4),
        _B_S4,
    ),
    b_err=tuple(b - bh for b, bh in zip(_B_S4, _BH_S4)),
    c=(1 / 4, 3 / 4, 11 / 20, 1 / 2, 1.0),
    gamma=1 / 4,
    order=4,
    first_explicit=False,
)


def algebraic_rows(eyeM):
    """The rows of a mass matrix that are all zero (algebraic)."""
    return eyeM.abs().sum(dim=1) == 0


class ESDIRK:
    """mass_matrix: optional constant M for M·u' = f (index-1
    semi-explicit DAEs); the first stage must then be implicit."""

    def __init__(self, tableau: ESDIRKTableau, name: str,
                 newton_iters: int = 8, newton_tol: float = 1e-12,
                 mass_matrix=None):
        self.tableau = tableau
        self.order = tableau.order
        self.fsal = True
        self.n_stages = len(tableau.c)
        self.name = name
        self.newton_iters = newton_iters
        self.newton_tol = newton_tol
        self.mass_matrix = mass_matrix

    def with_mass_matrix(self, M):
        if self.tableau.first_explicit:
            raise NotImplementedError(
                f"{self.name} has an explicit first stage: singular mass "
                "matrices need an all-implicit SDIRK (use SDIRK4)")
        return ESDIRK(self.tableau, self.name, self.newton_iters,
                      self.newton_tol, mass_matrix=M)

    def __repr__(self):
        return f"{self.name}()"

    def step(self, fvec, t, dt, u, f0, need_err: bool = True, ddt=None,
             t_off=None):
        tab = self.tableau
        kind = type(t)
        n = u.shape[0]
        M = self.mass_matrix
        J = jacobian(fvec, u, stage_time(t, t, 0.0, None, t_off))
        eyeM = (torch.eye(n, dtype=u.dtype, device=u.device) if M is None
                else torch.as_tensor(M, dtype=u.dtype, device=u.device))
        hg = scaled(dt, tab.gamma, ddt)
        lu = torch.linalg.lu_factor(eyeM - hg * J)

        ks = [f0] if tab.first_explicit else []
        c_off = 1 if tab.first_explicit else 0
        bad = torch.zeros((), dtype=torch.bool, device=u.device)
        alphas = torch.tensor([1.0, 0.5, 0.25], dtype=u.real.dtype,
                              device=u.device)
        norm = torch.linalg.vector_norm
        for i, row in enumerate(tab.a):
            ci = tab.c[i + c_off]
            ti = stage_time(t, kind(t + kind(scaled(dt, ci))), ci, ddt, t_off)
            base = u
            for aij, k in zip(row[:-1], ks):
                base = base + scaled(dt, aij, ddt) * k

            def resid(k, base=base, ti=ti):
                Mk = k if M is None else eyeM @ k
                return Mk - fvec(base + hg * k, ti)

            # damped modified Newton, warm-started from the last stage
            k = ks[-1] if ks else f0
            for _ in range(self.newton_iters):
                delta = lu_solve(lu, resid(k))
                cand = k[None, :] - alphas[:, None] * delta[None, :]
                gn = torch.stack([norm(resid(c)) for c in cand])
                gn = torch.where(torch.isnan(gn), torch.inf, gn)
                k = cand[torch.argmin(gn)]
            rfin = norm(resid(k))
            bad = (bad | ~(rfin <= 1e-6 * (1.0 + norm(k)))
                   | ~torch.isfinite(k).all())
            ks.append(k)

        # stiffly accurate: u1 = u + h·Σ b k
        u1 = u
        for bi, k in zip(tab.a[-1], ks):
            u1 = u1 + scaled(dt, bi, ddt) * k
        f1 = ks[-1]  # b == last row and c_last == 1: k_last = f(t+dt, u1)
        if not need_err:
            return u1, f1, None

        err = torch.zeros_like(u)
        for ei, k in zip(tab.b_err, ks):
            err = err + scaled(dt, ei, ddt) * k
        alg = None if M is None else algebraic_rows(eyeM)
        if alg is not None:
            # an algebraic row's raw estimate is O(1/h) noise: out before
            # the W⁻¹ filter smears it into the differential rows
            err = torch.where(alg, torch.zeros_like(err), err)
        err = lu_solve(lu, err)
        if alg is not None:
            err = torch.where(alg, torch.zeros_like(err), err)
        # a stage whose Newton did not converge rejects the step
        return u1, f1, torch.where(bad, torch.full_like(err, torch.inf), err)


def TRBDF2(**kw):
    return ESDIRK(TRBDF2_TAB, "TRBDF2", **kw)


def Kvaerno3(**kw):
    return ESDIRK(KVAERNO3_TAB, "Kvaerno3", **kw)


def SDIRK4(**kw):
    return ESDIRK(SDIRK4_TAB, "SDIRK4", **kw)
