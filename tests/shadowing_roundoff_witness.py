"""How far roundoff moves NILSAS under solve's shadowing rule, on the CPU.

Under a gradient of `solve`, NILSAS reads the loss's cotangent rows as a
piecewise-constant field of the nearest save time (JAX solve.py:737-765),
so its adjoint field integrates a forcing that jumps midway between save
times, and the adaptive steps crowd onto every jump. This script moves u0
by one ulp and prints the relative change of the gradient:

  * Lorenz on (30, 31.5), NILSAS(nseg 3, nstep 26, M 2), the loss
    Σᵢ wᵢ·zᵢ over 16 save rows (the case of tests/test_torch_shadowing.py::
    test_grad_over_solve_nilss_nilsas), in the JAX package (compiled at
    XLA level 0) and in the port, both on JAX's draws; and, for scale, the
    change when every row takes its neighbour's weight;
  * the fused-MLP field's plain version at B = 8, 8→16→8 in float64 under
    NILSAS(nseg 2, nstep 5, M 2) through solve, the setting whose card
    gradient parted from the CPU's by 1.8e-7 relative.

It also prints the accepted steps of the plain Lorenz solve at rtol 1e-8
in the port, in JAX and in JAX at XLA level 0, with 11 save rows on
(30, 31) and 1001 on (30, 40): a step clipped onto a save time has a
roundoff-sized error estimate, so the next step's size turns on the last
bits.

Run: JAX_PLATFORMS=cpu python tests/shadowing_roundoff_witness.py
"""

import os
import sys

import jax

jax.config.update("jax_enable_x64", True)
jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import scimlsensitivity_jl_tpu as J  # noqa: E402
import scimlsensitivity_jl_tpu_torch as P  # noqa: E402
from test_torch_shadowing import (NIL_SOLVE, SEED, SHORT, TS,  # noqa: E402
                                  TS_LSS, TS_SHORT, U0, W_SHORT, lorenz_jax,
                                  lorenz_port)
from torch_parity import JaxKey, jax_o0  # noqa: E402


def ulp_moved(u0, sign):
    u0 = np.array(u0, dtype=np.float64)
    if sign:
        u0[0] = np.nextafter(u0[0], sign * np.inf)
    return u0


def jax_grad(u0, w):
    def run(p):
        return jax.grad(lambda q: jnp.sum(jnp.asarray(w) * J.solve(
            J.ODEProblem(lorenz_jax, jnp.asarray(u0), SHORT, q), J.Tsit5(),
            saveat=jnp.asarray(TS_SHORT), sensealg=J.NILSAS(nseg=3, nstep=26,
                                                            M=2),
            **NIL_SOLVE).ys[:, 2]))(p)

    return float(jax_o0(run, jnp.array([28.0]))[0])


def port_grad(u0, w):
    p = torch.tensor([28.0], dtype=torch.float64, requires_grad=True)
    sol = P.solve(P.ODEProblem(lorenz_port, torch.tensor(u0), SHORT, p),
                  P.Tsit5(), saveat=TS_SHORT,
                  sensealg=P.NILSAS(nseg=3, nstep=26, M=2),
                  key=JaxKey(jax.random.PRNGKey(SEED)), **NIL_SOLVE)
    (g,) = torch.autograd.grad(torch.sum(torch.tensor(w) * sol.ys[:, 2]), p)
    return float(g[0])


def mlp_grad(moved=None):
    gen = torch.Generator().manual_seed(5)
    params = P.mlp_init(gen, (8, 16, 8), torch.float64, device="cpu")
    params = {k: v.requires_grad_() for k, v in params.items()}
    u0 = 0.3 * torch.randn((8, 8), generator=gen, dtype=torch.float64)
    if moved is not None:
        (i, j), sign = moved
        u0[i, j] = torch.nextafter(u0[i, j], torch.tensor(sign * np.inf,
                                                          dtype=u0.dtype))
    sol = P.solve(P.ODEProblem(lambda u, q, t: P.mlp_apply(q, u), u0,
                               (0.0, 0.5), params), P.Tsit5(),
                  saveat=torch.linspace(0.0, 0.5, 11), rtol=1e-8, atol=1e-10,
                  adj_rtol=1e-8, adj_atol=1e-10,
                  sensealg=P.NILSAS(nseg=2, nstep=5, M=2))
    loss = torch.sum(torch.mean(sol.ys ** 2, dim=(1, 2)))
    grads = torch.autograd.grad(loss, list(params.values()))
    return torch.cat([g.reshape(-1) for g in grads])


def steps(ts):
    """Accepted steps of the plain solve on (ts[0], ts[-1]): port, JAX,
    JAX at XLA level 0, and the largest |Δys| of the port against JAX at
    level 0."""
    span = (float(ts[0]), float(ts[-1]))
    kw = dict(rtol=1e-8, atol=1e-10, max_steps=16384)

    def run(p):
        sol = J.solve(J.ODEProblem(lorenz_jax, jnp.asarray(U0), span, p),
                      J.Tsit5(), saveat=jnp.asarray(ts), **kw)
        return sol.ys, sol.stats.n_accepted

    eager = run(jnp.array([28.0]))
    ys0, n0 = jax_o0(run, jnp.array([28.0]))
    sol = P.solve(P.ODEProblem(lorenz_port, torch.tensor(U0), span,
                               torch.tensor([28.0], dtype=torch.float64)),
                  P.Tsit5(), saveat=ts, **kw)
    gap = float(np.abs(sol.ys.numpy() - np.asarray(ys0)).max())
    return sol.stats.n_accepted, int(eager[1]), int(n0), gap


def main():
    torch.set_num_threads(2)
    for ts in (TS_LSS, TS):
        port, jx, jx0, gap = steps(ts)
        print(f"Lorenz on ({ts[0]}, {ts[-1]}), {ts.shape[0]} save rows, rtol "
              f"1e-8: accepted steps port {port}, JAX {jx}, JAX at XLA level "
              f"0 {jx0}; max|ys port - ys JAX level 0| {gap:.3e}")
    for name, fn in (("JAX", jax_grad), ("port", port_grad)):
        base = fn(U0, W_SHORT)
        for sign in (1, -1):
            moved = fn(ulp_moved(U0, sign), W_SHORT)
            print(f"Lorenz NILSAS under solve, {name}: u0[0] moved one ulp "
                  f"({'+' if sign > 0 else '-'}): relative change "
                  f"{abs(moved - base) / abs(base):.3e} ({base!r} -> "
                  f"{moved!r})")
        if name == "port":
            shifted = port_grad(U0, np.roll(W_SHORT, 1))
            print(f"Lorenz NILSAS under solve, port: every row with its "
                  f"neighbour's weight: relative change "
                  f"{abs(shifted - base) / abs(base):.3e}")
    a = mlp_grad()
    for moved in (((0, 0), 1), ((3, 5), -1)):
        b = mlp_grad(moved)
        print(f"MLP field (B 8, 8→16→8) NILSAS under solve, port: "
              f"u0{list(moved[0])} moved one ulp "
              f"({'+' if moved[1] > 0 else '-'}): relative change "
              f"{float(torch.linalg.norm(a - b) / torch.linalg.norm(a)):.3e}")


if __name__ == "__main__":
    main()
