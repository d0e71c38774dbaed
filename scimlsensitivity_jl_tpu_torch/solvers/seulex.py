"""Linearly implicit Euler extrapolation, a SEULEX-class stiff solver
(PyTorch port).

Counterpart of `scimlsensitivity_jl_tpu/solvers/seulex.py`: `Seulex` and
`Rodas4Like` (:38-103), with `with_mass_matrix`. Per step of size H with
K levels and substep sequence n_j = 1, 2, ..., K:

    W_j = M − h_j J,  h_j = H / n_j,  J = ∂f/∂u frozen at (u, t)
    linearly implicit Euler:  W_j Δ = h_j f(u_k, t_k);  u_{k+1} = u_k + Δ
    T_j  = the result after n_j substeps
    T[j,l] = T[j,l-1] + (T[j,l-1] − T[j-1,l-1]) / (n_j/n_{j-l} − 1)
    u1 = T[K-1,K-1]  (order K),  err = T[K-1,K-1] − T[K-1,K-2].

One `torch.linalg.lu_factor` per level; J from the field's `.jac` hook or
`torch.func.jacfwd`. With a singular diagonal M (index-1 semi-explicit
DAE), the slope returned is W_fine⁻¹ f, the consistent algebraic slope,
and algebraic rows leave the error estimate. A non-finite u1 makes the
error +inf. Where the step's start or length carries a derivative
(`t_off`, `ddt`, as `ExplicitRK.step` takes them), each substep length
h_j carries ddt/n_j, J is taken at t_off + t and each substep time goes
through `explicit.stage_time`; the values are unchanged. Hairer, Wanner,
Solving ODEs II, §IV.9.
"""

from __future__ import annotations

import torch

from .explicit import stage_time
from .rosenbrock import jacobian, lu_solve
from .sdirk import algebraic_rows

__all__ = ["Seulex", "Rodas4Like"]


class Seulex:
    """levels: number of extrapolation levels K (order = K)."""

    def __init__(self, levels: int = 4, mass_matrix=None):
        if levels < 2:
            raise ValueError("Seulex needs at least 2 levels")
        self.levels = levels
        self.seq = tuple(range(1, levels + 1))  # 1, 2, 3, ...
        self.order = levels
        self.fsal = False
        self.n_stages = sum(self.seq)
        self.mass_matrix = mass_matrix
        self.name = f"Seulex(levels={levels})"

    def with_mass_matrix(self, M):
        return Seulex(self.levels, mass_matrix=M)

    def __repr__(self):
        return self.name

    def step(self, fvec, t, dt, u, f0, need_err: bool = True, ddt=None,
             t_off=None):
        kind = type(t)
        K = self.levels
        n = u.shape[0]
        M = self.mass_matrix
        J = jacobian(fvec, u, stage_time(t, t, 0.0, None, t_off))
        eyeM = (torch.eye(n, dtype=u.dtype, device=u.device) if M is None
                else torch.as_tensor(M, dtype=u.dtype, device=u.device))

        lus, T = [], []
        for nsub in self.seq:
            h = kind(dt / kind(nsub))
            hj = float(h) if ddt is None else ddt / float(nsub) + float(h)
            lu = torch.linalg.lu_factor(eyeM - hj * J)
            lus.append(lu)
            z = u
            for m in range(nsub):
                tm = stage_time(t, kind(t + kind(kind(m) * h)), m / nsub,
                                ddt, t_off)
                z = z + lu_solve(lu, hj * fvec(z, tm))
            T.append(z)

        # Aitken-Neville with the linear ratios n_j / n_{j-l}
        for l in range(1, K):
            for j in range(K - 1, l - 1, -1):
                r = self.seq[j] / self.seq[j - l]
                T[j] = T[j] + (T[j] - T[j - 1]) / (r - 1.0)
        u1 = T[K - 1]
        err = T[K - 1] - T[K - 2]

        t_b = stage_time(t, kind(t + dt), 1.0, ddt, t_off)
        if M is None:
            f1 = fvec(u1, t_b)
        else:
            # W⁻¹f at the finest level: the consistent algebraic slope
            f1 = lu_solve(lus[-1], fvec(u1, t_b))
            err = torch.where(algebraic_rows(eyeM), torch.zeros_like(err),
                              err)
        bad = ~torch.isfinite(u1).all()
        err = torch.where(bad, torch.full_like(err, torch.inf), err)
        return u1, f1, err if need_err else None


def Rodas4Like(**kw):
    """Order-4 stiff extrapolation, the slot Rodas4 fills in the
    reference's stiff test matrix."""
    return Seulex(levels=4, **kw)
