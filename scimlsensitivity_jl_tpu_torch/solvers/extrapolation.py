"""Gragg-Bulirsch-Stoer extrapolation (PyTorch port).

Counterpart of `scimlsensitivity_jl_tpu/solvers/extrapolation.py`: `GBS`
and `Vern9Like` (:25-68). Arbitrary even order from the modified
midpoint rule and Aitken-Neville polynomial extrapolation: per step, with
K levels and substep sequence n_j = 2, 4, 6, ...,

    T_j = Gragg's midpoint result with n_j substeps (with the smoothing
          step, which makes the error expansion even in h)
    T[j,l] = T[j,l-1] + (T[j,l-1] − T[j-1,l-1]) / ((n_j/n_{j-l})² − 1)
    u1 = T[K-1,K-1]  (order 2K),  err = T[K-1,K-1] − T[K-1,K-2].

The stepper is explicit: it calls the field only, so a kernel field
(`ops.rd1d`, `ops.mlp`) launches its kernels in every substep. Where the
step's start or length carries a derivative (`t_off`, `ddt`, as
`ExplicitRK.step` takes them), h = H/n_j and 2h carry ddt/n_j and 2·ddt/n_j,
and each substep time and the end time go through `explicit.stage_time`;
the values are unchanged. Hairer, Norsett, Wanner, Solving ODEs I, §II.9.
"""

from __future__ import annotations

from .explicit import stage_time

__all__ = ["GBS", "Vern9Like"]


class GBS:
    """levels: number of extrapolation levels K (order = 2K)."""

    def __init__(self, levels: int = 4):
        if levels < 2:
            raise ValueError("GBS needs at least 2 levels")
        self.levels = levels
        self.seq = tuple(2 * (j + 1) for j in range(levels))  # 2, 4, 6, ...
        self.order = 2 * levels
        self.fsal = False
        self.n_stages = sum(self.seq) + levels + 1
        self.name = f"GBS(levels={levels})"

    def __repr__(self):
        return self.name

    def _midpoint(self, fvec, t, dt, u, f0, nsub: int, ddt=None,
                  t_off=None):
        kind = type(t)
        h = kind(dt / kind(nsub))
        h1, h2 = float(h), float(kind(kind(2.0) * h))
        if ddt is not None:
            h1, h2 = ddt / float(nsub) + h1, ddt * (2.0 / nsub) + h2
        z_prev = u
        z = u + h1 * f0
        for m in range(1, nsub):
            tm = stage_time(t, kind(t + kind(kind(m) * h)), m / nsub, ddt,
                            t_off)
            z_next = z_prev + h2 * fvec(z, tm)
            z_prev, z = z, z_next
        # Gragg smoothing: S = (z_n + z_{n-1} + h f(z_n)) / 2
        t_b = stage_time(t, kind(t + dt), 1.0, ddt, t_off)
        return 0.5 * (z + z_prev + h1 * fvec(z, t_b))

    def step(self, fvec, t, dt, u, f0, need_err: bool = True, ddt=None,
             t_off=None):
        K = self.levels
        T = [self._midpoint(fvec, t, dt, u, f0, n, ddt, t_off)
             for n in self.seq]
        # Aitken-Neville with the ratios (n_j / n_{j-l})²
        for l in range(1, K):
            for j in range(K - 1, l - 1, -1):
                r = (self.seq[j] / self.seq[j - l]) ** 2
                T[j] = T[j] + (T[j] - T[j - 1]) / (r - 1.0)
        u1 = T[K - 1]
        err = T[K - 1] - T[K - 2] if need_err else None
        f1 = fvec(u1, stage_time(t, type(t)(t + dt), 1.0, ddt, t_off))
        return u1, f1, err


def Vern9Like():
    """Order-10 GBS, the high-accuracy explicit slot that Vern9 fills in
    the reference's test matrix."""
    return GBS(levels=5)
