"""Gauss–Kronrod and Gauss–Legendre rules on [0, 1] (PyTorch port).

Counterpart of `scimlsensitivity_jl_tpu/ops/quadrature.py`: `_legval`,
`_gk_pair_np`, `gauss_kronrod_01` and `gl_01`. The Kronrod extension is
constructed numerically in float64 on the host, not transcribed:

  1. the Stieltjes polynomial E_{n+1}, whose roots are the Kronrod-only
     nodes, is expanded in the Legendre basis; its coefficients solve
     ∫ E_{n+1}(x) P_n(x) x^k dx = 0 for k = 0..n;
  2. the 2n+1 Kronrod weights come from moment matching on P_0..P_{2n};
  3. the embedded n-point Gauss weights sit at the Gauss nodes with zeros
     at the Kronrod-only nodes, so `wk - wg` contracted with the same
     samples is the embedded error estimate.

The rules are host data: the port keeps times on the host, so nodes and
weights are numpy arrays in the time dtype (a numpy scalar type), where
the JAX package returns device arrays.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

__all__ = ["gauss_kronrod_01", "gl_01"]


def _legval(c, x):
    return np.polynomial.legendre.legval(x, c)


@lru_cache(maxsize=None)
def _gk_pair_np(n: int):
    """(nodes, Kronrod weights, embedded Gauss weights) on [-1, 1], float64;
    nodes ascending, the n Gauss nodes interleaved among them."""
    # the construction integrands have degree at most 3n+1
    xq, wq = np.polynomial.legendre.leggauss(4 * n + 8)

    def inner(cA, cB, k):
        # ∫_{-1}^{1} A(x) B(x) x^k dx with A, B in Legendre coefficients
        return np.sum(wq * _legval(cA, xq) * _legval(cB, xq) * xq ** k)

    Pn = np.zeros(n + 1)
    Pn[n] = 1.0

    # E_{n+1} = P_{n+1} + Σ_{j=0..n} c_j P_j; n+1 orthogonality conditions
    A = np.empty((n + 1, n + 1))
    b = np.empty(n + 1)
    for k in range(n + 1):
        for j in range(n + 1):
            ej = np.zeros(n + 1)
            ej[j] = 1.0
            A[k, j] = inner(ej, Pn, k)
        top = np.zeros(n + 2)
        top[n + 1] = 1.0
        b[k] = -inner(top, Pn, k)
    c = np.linalg.solve(A, b)
    E = np.concatenate([c, [1.0]])

    kron_nodes = np.polynomial.legendre.Legendre(E).roots().real
    gauss_nodes = np.polynomial.legendre.leggauss(n)[0]
    nodes = np.sort(np.concatenate([gauss_nodes, kron_nodes]))

    # Kronrod weights: exact on P_0..P_{2n} (∫ P_j = 2 δ_{j0})
    m = 2 * n + 1
    V = np.empty((m, m))
    for j in range(m):
        ej = np.zeros(j + 1)
        ej[j] = 1.0
        V[j] = _legval(ej, nodes)
    rhs = np.zeros(m)
    rhs[0] = 2.0
    wk = np.linalg.solve(V, rhs)

    gx, gw = np.polynomial.legendre.leggauss(n)
    wg = np.zeros(m)
    for xi, wi in zip(gx, gw):
        wg[int(np.argmin(np.abs(nodes - xi)))] = wi
    return nodes, wk, wg


def gauss_kronrod_01(n: int, dtype=np.float64):
    """GK(n, 2n+1) on [0, 1]: (x, w_kronrod, w_gauss_embedded), numpy arrays
    of `dtype`. `w_kronrod @ f(x)` is the high-order estimate and
    `(w_kronrod - w_gauss) @ f(x)` the embedded error, from one set of
    samples."""
    nodes, wk, wg = _gk_pair_np(n)
    return (np.asarray(0.5 * (nodes + 1.0), dtype),
            np.asarray(0.5 * wk, dtype), np.asarray(0.5 * wg, dtype))


def gl_01(order: int, dtype=np.float64):
    """Gauss–Legendre nodes and weights on [0, 1], numpy arrays of `dtype`."""
    x, w = np.polynomial.legendre.leggauss(order)
    return np.asarray(0.5 * (x + 1.0), dtype), np.asarray(0.5 * w, dtype)
