"""SDE schemes (PyTorch port).

Counterpart of `scimlsensitivity_jl_tpu/solvers/sde.py`: `EulerMaruyama`
(:57), `EulerHeun` (:71), `Milstein` (:88), `RKMilCommute` (:139),
`RKMilGeneral` (:146), `SRA1` (:188), `StrongTaylor15` (:232) with its
aliases `SRIW1` and `SOSRI`, the drift transforms
`ito_to_stratonovich_drift` / `stratonovich_to_ito_drift` (:340-380),
`ImplicitEM` (:383) and the adaptive `AdaptiveMilstein` (:416) and
`AdaptiveEM` (:451) on a VirtualBrownianTree.

Fixed-grid steppers work on flat states:

    step(fvec, gvec, t, dt, u, dw[, dz | levy_a]) -> u1

with gvec(u, t) of shape (n,) for diagonal or scalar noise and (n, m)
for general noise with dw of shape (m,). t and dt are host scalars, or
0-d tensors inside a step split at a continuous event. The adaptive ones
take the ODE stepper interface of `solvers/integrate.py`.

The derivative terms are forward mode (`torch.func.jvp`, `jacfwd`), as
JAX's are `jax.jvp` / `jax.jacfwd`. `forward_mode` names the fields a
scheme differentiates that way ("f", "g"): `adjoints/sde.py` probes those
before the first step, so a kernel field there (which has a pullback
only) is refused before anything launches.
"""

from __future__ import annotations

import torch

from ..ops.vjp import jacfwd

__all__ = [
    "EulerMaruyama",
    "EulerHeun",
    "Milstein",
    "RKMilCommute",
    "RKMilGeneral",
    "SRA1",
    "StrongTaylor15",
    "SRIW1",
    "SOSRI",
    "ImplicitEM",
    "AdaptiveEM",
    "AdaptiveMilstein",
    "ito_to_stratonovich_drift",
    "stratonovich_to_ito_drift",
]


def _plus(t, dt):
    """t + dt in t's host type (or as tensors)."""
    if isinstance(t, torch.Tensor) or isinstance(dt, torch.Tensor):
        return t + dt
    return type(t)(t + dt)


def _gg_jvp(gvec, u, t, v):
    """(∂g/∂u)·v by one jvp."""
    return torch.func.jvp(lambda uu: gvec(uu, t), (u,), (v,))[1]


def _diffusion_term(g_val, dw):
    """g·dW for diagonal (n,) or general (n, m) diffusion."""
    if g_val.ndim == 1:
        return g_val * dw
    return g_val @ dw


class EulerMaruyama:
    """Strong order 0.5 Itô scheme: u1 = u + f·dt + g·ΔW."""

    name = "EulerMaruyama"
    interpretation = "ito"
    order = 1
    forward_mode = ()

    def __repr__(self):
        return "EulerMaruyama()"

    def step(self, fvec, gvec, t, dt, u, dw):
        return u + dt * fvec(u, t) + _diffusion_term(gvec(u, t), dw)


class EulerHeun:
    """Stratonovich Heun scheme: predictor-corrector in the diffusion."""

    name = "EulerHeun"
    interpretation = "stratonovich"
    order = 1
    forward_mode = ()

    def __repr__(self):
        return "EulerHeun()"

    def step(self, fvec, gvec, t, dt, u, dw):
        g0 = gvec(u, t)
        drift = dt * fvec(u, t)  # JAX evaluates it twice; XLA merges them
        ubar = u + drift + _diffusion_term(g0, dw)
        g1 = gvec(ubar, _plus(t, dt))
        return u + drift + 0.5 * _diffusion_term(g0 + g1, dw)


def _commutative_correction(gvec, u, t, g0, dw, dt, levy_a=None):
    """Σ_{j,k} (∂g/∂u · g_{:,j})_k · I_(j,k) with I = ½(ΔWΔWᵀ − dt·I)
    (+ the Lévy area): m vmapped jvps of g, one per noise column."""
    D = torch.func.vmap(lambda col: _gg_jvp(gvec, u, t, col))(g0.T)
    eye = torch.eye(dw.shape[0], dtype=dw.dtype, device=dw.device)
    I2 = 0.5 * (dw[:, None] * dw[None, :] - dt * eye)
    if levy_a is not None:
        I2 = I2 + levy_a
    return torch.einsum("jnk,jk->n", D, I2)


class Milstein:
    """Strong order 1.0 Itô Milstein. Diagonal noise: u1 = EM +
    ½·g·(∂g/∂u)·g·(ΔW² − dt) by one jvp. Matrix noise needs
    commutativity and the opt-in `Milstein(commutative=True)` (or
    `RKMilCommute()`); RKMilGeneral takes the non-commutative case."""

    name = "Milstein"
    interpretation = "ito"
    order = 1
    forward_mode = ("g",)

    def __init__(self, commutative: bool = False):
        self.commutative = bool(commutative)

    def __repr__(self):
        return f"Milstein(commutative={self.commutative})"

    def step(self, fvec, gvec, t, dt, u, dw):
        g0 = gvec(u, t)
        if g0.ndim == 1:
            dg = _gg_jvp(gvec, u, t, g0)
            return (u + dt * fvec(u, t) + g0 * dw
                    + 0.5 * dg * (dw ** 2 - dt))
        if not self.commutative:
            raise NotImplementedError(
                "Milstein on matrix (n, m) noise assumes commutative noise "
                "(L^j g_k = L^k g_j); opt in with Milstein(commutative=True)"
                " / RKMilCommute(), or use RKMilGeneral() for the "
                "non-commutative case (Lévy-area Milstein)")
        corr = _commutative_correction(gvec, u, t, g0, dw, dt)
        return u + dt * fvec(u, t) + g0 @ dw + corr


def RKMilCommute():
    """Milstein for commutative matrix noise (StochasticDiffEq's name)."""
    return Milstein(commutative=True)


class RKMilGeneral:
    """Strong order 1.0 Itô Milstein for general (non-commutative) (n, m)
    noise: u1 = EM + Σ_{j,k} L^j g_{:,k}·I_(j,k), I_(j,k) = ½(ΔW_jΔW_k −
    dt δ_jk) + A_jk with the truncated-series Lévy area A
    (`ops.brownian.grid_levy_area`, `levy_terms` terms). Diagonal noise
    is plain Milstein."""

    name = "RKMilGeneral"
    interpretation = "ito"
    order = 1
    needs_levy = True
    forward_mode = ("g",)

    def __init__(self, levy_terms: int = 10):
        self.levy_terms = int(levy_terms)

    def __repr__(self):
        return f"RKMilGeneral(levy_terms={self.levy_terms})"

    def step(self, fvec, gvec, t, dt, u, dw, levy_a=None):
        g0 = gvec(u, t)
        if g0.ndim == 1:
            dg = _gg_jvp(gvec, u, t, g0)
            return (u + dt * fvec(u, t) + g0 * dw
                    + 0.5 * dg * (dw ** 2 - dt))
        corr = _commutative_correction(gvec, u, t, g0, dw, dt, levy_a)
        return u + dt * fvec(u, t) + g0 @ dw + corr


class SRA1:
    """Rößler SRA1 for additive noise (strong 1.5, weak 2.0), with the
    iterated integral ΔZ (`ops.brownian.grid_iterated`); χ = ΔZ/h:
        H2 = u + ¾h f(u,t) + (3/2)·g(t+h)·χ
        u1 = u + h[f(u,t)/3 + 2f(H2, t+¾h)/3] + g(t+h)·(ΔW − χ) + g(t)·χ
    """

    name = "SRA1"
    interpretation = "ito"
    order = 2
    needs_dz = True
    forward_mode = ()

    def __repr__(self):
        return "SRA1()"

    def step(self, fvec, gvec, t, dt, u, dw, dz):
        chi = dz / dt
        f1 = fvec(u, t)
        g_end = gvec(u, _plus(t, dt))
        g_start = gvec(u, t)
        H2 = u + 0.75 * dt * f1 + 1.5 * _diffusion_term(g_end, chi)
        f2 = fvec(H2, _plus(t, 0.75 * dt))
        return (u + dt * (f1 / 3.0 + 2.0 * f2 / 3.0)
                + _diffusion_term(g_end, dw - chi)
                + _diffusion_term(g_start, chi))


class StrongTaylor15:
    """Strong order 1.5 Itô–Taylor scheme for scalar/diagonal noise, every
    operator by forward mode (Kloeden & Platen §10.4); JAX's docstring
    gives the expansion term by term."""

    name = "StrongTaylor15"
    interpretation = "ito"
    order = 2
    needs_dz = True
    forward_mode = ("f", "g")

    def __repr__(self):
        return "StrongTaylor15()"

    def step(self, fvec, gvec, t, dt, u, dw, dz):
        n = u.shape[0]
        h = dt
        g0 = gvec(u, t)
        if g0.ndim != 1:
            raise NotImplementedError(
                "StrongTaylor15 covers scalar/diagonal noise; use "
                "EulerMaruyama/EulerHeun for general matrix noise")
        f0 = fvec(u, t)
        Jg = jacfwd(lambda uu: gvec(uu, t), u)
        Jf = jacfwd(lambda uu: fvec(uu, t), u)
        tt = torch.as_tensor(t, dtype=u.dtype, device=u.device)
        one = torch.ones_like(tt)
        f_t = torch.func.jvp(lambda s: fvec(u, s), (tt,), (one,))[1]
        g_t = torch.func.jvp(lambda s: gvec(u, s), (tt,), (one,))[1]
        w2 = g0 ** 2
        eye = torch.eye(n, dtype=u.dtype, device=u.device)

        def weighted_lap(fn):
            def second_dir(e):
                return torch.func.jvp(
                    lambda uu: torch.func.jvp(fn, (uu,), (e,))[1],
                    (u,), (e,))[1]

            hs = torch.func.vmap(second_dir)(eye)
            return torch.einsum("l,lk->k", w2, hs)

        L0f = f_t + Jf @ f0 + 0.5 * weighted_lap(lambda uu: fvec(uu, t))
        L0g = g_t + Jg @ f0 + 0.5 * weighted_lap(lambda uu: gvec(uu, t))
        mil = (0.5 * ((Jg * g0[None, :]) @ dw) * dw
               - 0.5 * torch.diagonal(Jg) * g0 * h)
        lf = (Jf * g0[None, :]) @ dz

        def m_fn(uu):
            gg = gvec(uu, t)
            return gg * torch.diagonal(
                torch.func.jacfwd(lambda x: gvec(x, t))(uu))

        dm_diag = torch.diagonal(torch.func.jacfwd(m_fn)(u))
        triple = 0.5 * g0 * dm_diag * (dw ** 2 / 3.0 - h) * dw
        return (u + f0 * h + g0 * dw + mil + lf + 0.5 * L0f * h * h
                + L0g * (dw * h - dz) + triple)


def SRIW1():
    """The strong-1.5 diagonal-noise slot (StochasticDiffEq's SRIW1),
    provided by StrongTaylor15."""
    return StrongTaylor15()


def SOSRI():
    """The stability-optimized SRI slot: StrongTaylor15, as SRIW1."""
    return StrongTaylor15()


def _drift_correction(gvec, u, t):
    """½ Σ_j (∂g_j/∂u)·g_j over the noise columns (diagonal: ½ (∂g/∂u)·g)."""
    g0 = gvec(u, t)
    if g0.ndim == 1:
        return 0.5 * _gg_jvp(gvec, u, t, g0)

    def col(j, v):
        return torch.func.jvp(lambda uu: gvec(uu, t)[:, j], (u,), (v,))[1]

    cols = [col(j, g0[:, j]) for j in range(g0.shape[1])]
    return 0.5 * torch.sum(torch.stack(cols), dim=0)


def ito_to_stratonovich_drift(fvec, gvec):
    """f̃ = f − ½ (∂g/∂u)·g: an Itô problem on a Stratonovich scheme."""

    def f_corr(u, t):
        return fvec(u, t) - _drift_correction(gvec, u, t)

    return f_corr


def stratonovich_to_ito_drift(fvec, gvec):
    """f̃ = f + ½ (∂g/∂u)·g: a Stratonovich problem on an Itô scheme."""

    def f_corr(u, t):
        return fvec(u, t) + _drift_correction(gvec, u, t)

    return f_corr


class ImplicitEM:
    """Drift-implicit Euler–Maruyama: u1 = u + dt·f(u1) + g(u)·ΔW by
    `newton_iters` Newton sweeps with the step-frozen I − dt·J (J by
    forward mode, factored once per step with torch.linalg)."""

    name = "ImplicitEM"
    interpretation = "ito"
    order = 1
    forward_mode = ("f",)

    def __init__(self, newton_iters: int = 6):
        self.newton_iters = newton_iters

    def __repr__(self):
        return "ImplicitEM()"

    def step(self, fvec, gvec, t, dt, u, dw):
        n = u.shape[0]
        t1 = _plus(t, dt)
        rhs_expl = u + _diffusion_term(gvec(u, t), dw)
        J = jacfwd(lambda uu: fvec(uu, t1), u)
        A = torch.eye(n, dtype=u.dtype, device=u.device) - dt * J
        lu, piv = torch.linalg.lu_factor(A)
        u1 = u + dt * fvec(u, t) + _diffusion_term(gvec(u, t), dw)
        for _ in range(self.newton_iters):
            r = u1 - dt * fvec(u1, t1) - rhs_expl
            u1 = u1 - torch.linalg.lu_solve(lu, piv, r[:, None])[:, 0]
        return u1


class AdaptiveMilstein:
    """Adaptive Milstein on a VirtualBrownianTree (diagonal noise): the
    Milstein step, its error the Milstein–EM difference ½ g g'(ΔW² − h).
    Every (re)step reads W from the same tree."""

    name = "AdaptiveMilstein"
    interpretation = "ito"
    order = 1
    n_stages = 2

    def __init__(self, gvec, vbt):
        self.gvec = gvec
        self.vbt = vbt

    def step(self, fvec, t, dt, u, f0, need_err: bool = True):
        g = self.gvec
        dW = self.vbt(_plus(t, dt)) - self.vbt(t)
        g0 = g(u, t)
        if g0.ndim != 1:
            raise NotImplementedError(
                "AdaptiveMilstein covers diagonal noise; use AdaptiveEM for "
                "general matrix noise")
        corr = 0.5 * _gg_jvp(g, u, t, g0) * (dW ** 2 - dt)
        u1 = u + dt * f0 + g0 * dW + corr
        f1 = fvec(u1, _plus(t, dt))
        return u1, f1, corr


class AdaptiveEM:
    """Adaptive Euler–Maruyama on a VirtualBrownianTree: step doubling
    with consistent increments (the full step and both half steps read the
    same tree); the propagated state is the two-half-step solution, the
    error its difference from the full step."""

    name = "AdaptiveEM"
    interpretation = "ito"
    order = 1
    n_stages = 3

    def __init__(self, gvec, vbt):
        self.gvec = gvec
        self.vbt = vbt

    def step(self, fvec, t, dt, u, f0, need_err: bool = True):
        g = self.gvec
        kind = type(t)
        t_half = kind(t + kind(kind(0.5) * dt))
        t_end = kind(t + dt)
        w0 = self.vbt(t)
        wm = self.vbt(t_half)
        w1 = self.vbt(t_end)
        dW, dW1, dW2 = w1 - w0, wm - w0, w1 - wm
        u_full = u + dt * f0 + _diffusion_term(g(u, t), dW)
        uh = u + kind(kind(0.5) * dt) * f0 + _diffusion_term(g(u, t), dW1)
        u_two = uh + kind(kind(0.5) * dt) * fvec(uh, t_half) + \
            _diffusion_term(g(uh, t_half), dW2)
        err = u_two - u_full
        f1 = fvec(u_two, t_end)
        return u_two, f1, err
