"""Parity of the port's neural-ODE slice with the JAX package, on the CPU:
the spiral neural ODE through `solve` with the fused MLP field (fixed grid
under DirectAdjoint, adaptive under BacksolveAdjoint, and adaptive under the
default dispatch, which picks GaussAdjoint), the batched field on the
fixed-grid discrete path, a bfloat16 fixed-grid forward, and the models'
`mlp_apply` and `mnist_node_apply`. Weights, data and states come from a
numpy seed; float64 unless bfloat16 is named.

The JAX field is `mlp2_reference`, the same math as the port's
`fused_mlp2` (whose CPU side is the plain version of K3 and K4). The spiral
runs on [0, 0.5] with 10 save times at the benchmark's spacing (1.5/29 ≈
0.05), not on [0, 1.5] with 30: op-by-op JAX takes ~25 s for the full span,
and chip_smoke.py runs the full one on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import jax_o0, to_numpy, to_port

import scimlsensitivity_jl_tpu as J
import scimlsensitivity_jl_tpu_torch as P
from scimlsensitivity_jl_tpu.models import neural_ode as jnode
from scimlsensitivity_jl_tpu.ops.pallas_mlp import fused_mlp2 as jax_fused
from scimlsensitivity_jl_tpu.ops.pallas_mlp import mlp2_reference
from scimlsensitivity_jl_tpu_torch.ops.mlp import fused_mlp2
from scimlsensitivity_jl_tpu_torch.utils.pytree import from_numpy_tree

KEYS = ("W0", "b0", "W1", "b1")
T1, NT = 0.5, 10
TS = np.linspace(0.0, T1, NT)
ADAPTIVE = dict(rtol=1e-3, atol=1e-6, max_steps=256)


def _mlp_params(sizes, seed):
    """Glorot weights and small nonzero biases (so db0, db1 are tested)."""
    g = np.random.default_rng(seed)
    out = {}
    for i, (m, n) in enumerate(zip(sizes[:-1], sizes[1:])):
        out[f"W{i}"] = g.standard_normal((m, n)) * np.sqrt(2.0 / (m + n))
        out[f"b{i}"] = 0.1 * g.standard_normal(n)
    return out


def _jax_spiral_field(u, p, t):
    return mlp2_reference(u ** 3, p["W0"], p["b0"], p["W1"], p["b1"])


def _port_spiral_field(u, p, t):
    return fused_mlp2(p, u ** 3)


def _spiral_grads(solve_kw, jax_kw=None, op_rounding=False):
    """d/dp of Σ(ys − data)² for the spiral, JAX then the port, and the
    port's solution."""
    params = _mlp_params((2, 50, 2), seed=3)
    data = 0.5 * np.random.default_rng(4).standard_normal((NT, 2))
    u0 = np.array([2.0, 0.0])

    def loss_jax(p):
        sol = J.solve(J.ODEProblem(_jax_spiral_field, jnp.asarray(u0),
                                   (0.0, T1), p), J.Tsit5(),
                      saveat=jnp.asarray(TS), **(jax_kw or solve_kw))
        return jnp.sum((sol.ys - jnp.asarray(data)) ** 2)

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    if op_rounding:
        g_jax = jax_o0(jax.grad(loss_jax), jp)
    else:
        g_jax = jax.grad(loss_jax)(jp)

    pp = {k: v.requires_grad_() for k, v in to_port(params).items()}
    sol = P.solve(P.ODEProblem(_port_spiral_field, to_port(u0), (0.0, T1), pp),
                  P.Tsit5(), saveat=TS, **solve_kw)
    torch.sum((sol.ys - to_port(data)) ** 2).backward()
    return g_jax, {k: pp[k].grad for k in KEYS}, sol


def _assert_grads(g_port, g_jax, rtol):
    for k in KEYS:
        ref = np.asarray(g_jax[k])
        np.testing.assert_allclose(to_numpy(g_port[k]), ref, rtol=rtol,
                                   atol=rtol * float(np.abs(ref).max()),
                                   err_msg=k)


def test_spiral_fixed_grid_direct_matches_jax():
    """S1: Tsit5 on the save times' grid (dt = 0.5/9), unroll=True, which
    dispatches to DirectAdjoint in both packages; gradient rtol 1e-8."""
    g_jax, g_port, sol = _spiral_grads(dict(dt=T1 / (NT - 1), adaptive=False,
                                            unroll=True))
    assert isinstance(sol.sensealg, P.DirectAdjoint)
    _assert_grads(g_port, g_jax, 1e-8)


@pytest.mark.parametrize("sensealg", ["BacksolveAdjoint", None],
                         ids=["backsolve", "default_gauss"])
def test_spiral_adaptive_matches_jax(sensealg):
    """S2 (BacksolveAdjoint, __graft_entry__.py:entry) and S3 (sensealg=None,
    which picks GaussAdjoint at n + p = 254 in both packages): rtol 1e-3,
    atol 1e-6. JAX runs as one program compiled at XLA optimization level
    0 (`torch_parity.jax_o0`, rounding op by op), as the adaptive parity
    test of tests/test_torch_solve.py does, so both take the same steps;
    rtol 1e-9 on the gradient (the Gauss sums run in another order)."""
    kw = dict(ADAPTIVE)
    jax_kw = dict(ADAPTIVE)
    if sensealg is not None:
        kw["sensealg"] = getattr(P, sensealg)()
        jax_kw["sensealg"] = getattr(J, sensealg)()
    g_jax, g_port, sol = _spiral_grads(kw, jax_kw, op_rounding=True)
    want = P.BacksolveAdjoint if sensealg else P.GaussAdjoint
    assert type(sol.sensealg) is want
    assert sol.retcode == 0 and sol.adjoint.stats.retcode == 0
    assert sol.adjoint.stats.n_accepted > 0
    _assert_grads(g_port, g_jax, 1e-9)


def test_batched_field_discrete_path_matches_jax():
    """S4 cut to B = 4, 8→32→8, 4 fixed steps on [0, 1], saveat [0, 1],
    sensealg=None: p = 552 > 128 keeps the default off Backsolve, so the
    fixed grid takes the discrete path; gradient rtol 1e-10."""
    params = _mlp_params((8, 32, 8), seed=5)
    u0 = 0.1 * np.random.default_rng(6).standard_normal((4, 8))

    def loss_jax(p):
        sol = J.solve(J.ODEProblem(lambda u, q, t: mlp2_reference(
            u, q["W0"], q["b0"], q["W1"], q["b1"]), jnp.asarray(u0),
            (0.0, 1.0), p), J.Tsit5(), saveat=jnp.asarray([0.0, 1.0]),
            dt=0.25, adaptive=False)
        return jnp.sum(sol.ys[-1] ** 2)

    g_jax = jax.grad(loss_jax)({k: jnp.asarray(v) for k, v in params.items()})
    pp = {k: v.requires_grad_() for k, v in to_port(params).items()}
    sol = P.solve(P.ODEProblem(lambda u, q, t: fused_mlp2(q, u), to_port(u0),
                               (0.0, 1.0), pp), P.Tsit5(), saveat=[0.0, 1.0],
                  dt=0.25, adaptive=False)
    assert isinstance(sol.sensealg, P.GaussAdjoint)  # the default's pick
    assert sol.ys.shape == (2, 4, 8)
    torch.sum(sol.ys[-1] ** 2).backward()
    _assert_grads({k: pp[k].grad for k in KEYS}, g_jax, 1e-10)


def test_bf16_fixed_grid_forward_matches_jax():
    """The batched field in bfloat16 (states and weights) over 4 fixed
    steps: the state dtype is kept, dt and the grid times round in it as
    in JAX, and the JAX fused kernel (interpret mode) and the port's plain
    K3 agree to 8 bfloat16 units in the last place of max|y|
    (8·2⁻⁸·max|y|): the two sum each product in another order, which flips
    single roundings of h and of the stage states."""
    params = _mlp_params((8, 32, 8), seed=7)
    u0 = 0.1 * np.random.default_rng(8).standard_normal((4, 8))
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in params.items()}
    u0j = jnp.asarray(u0, jnp.bfloat16)
    sol_j = J.solve(J.ODEProblem(lambda u, q, t: jax_fused(q, u), u0j,
                                 (0.0, 1.0), jp), J.Tsit5(),
                    saveat=jnp.asarray([0.0, 1.0]), dt=0.25, adaptive=False)
    pp = from_numpy_tree({k: np.asarray(v) for k, v in jp.items()}, "cpu",
                         torch.bfloat16)
    sol = P.solve(P.ODEProblem(lambda u, q, t: fused_mlp2(q, u),
                               from_numpy_tree(np.asarray(u0j), "cpu",
                                               torch.bfloat16),
                               (0.0, 1.0), pp), P.Tsit5(),
                  saveat=[0.0, 1.0], dt=0.25, adaptive=False)
    assert sol.ys.dtype == torch.bfloat16 and sol_j.ys.dtype == jnp.bfloat16
    ref = np.asarray(sol_j.ys[-1], np.float64)
    got = sol.ys[-1].double().numpy()
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(got, ref, rtol=0, atol=8 * 2.0 ** -8 * scale)
    assert not np.array_equal(got, np.asarray(u0j, np.float64))


def test_bf16_adaptive_forward_matches_jax():
    """The spiral in bfloat16, adaptive (rtol 1e-2, atol 1e-3): time and the
    controller stay in float32 and the stages run promoted to float32 in
    both packages (the field then meets float32 states and bfloat16
    weights), while u1 and f1 return to bfloat16 each step. The same
    accepted steps, and states within 4 bfloat16 units in the last place of
    max|y| (4·2⁻⁸·max|y|): the sums of K3's plain version and of JAX's
    interpret-mode kernel round apart by one unit at times."""
    params = _mlp_params((2, 50, 2), seed=3)
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in params.items()}
    u0 = jnp.asarray([2.0, 0.0], jnp.bfloat16)
    kw = dict(rtol=1e-2, atol=1e-3)
    sol_j = J.solve(J.ODEProblem(lambda u, q, t: jax_fused(q, u ** 3), u0,
                                 (0.0, T1), jp), J.Tsit5(),
                    saveat=jnp.asarray(TS), **kw)
    pp = from_numpy_tree({k: np.asarray(v) for k, v in jp.items()}, "cpu",
                         torch.bfloat16)
    sol = P.solve(P.ODEProblem(_port_spiral_field,
                               from_numpy_tree(np.asarray(u0), "cpu",
                                               torch.bfloat16),
                               (0.0, T1), pp), P.Tsit5(), saveat=TS, **kw)
    assert sol.ys.dtype == torch.bfloat16
    assert sol.stats.n_accepted == int(sol_j.stats.n_accepted)
    ref = np.asarray(sol_j.ys, np.float64)
    np.testing.assert_allclose(sol.ys.double().numpy(), ref, rtol=0,
                               atol=4 * 2.0 ** -8 * float(np.abs(ref).max()))


def test_mlp_apply_and_mnist_node_apply_match_jax():
    """mlp_apply on a 3-layer MLP, and the MNIST classifier (encoder, ODE
    block solved on a fixed grid, head) at a small width: logits atol
    1e-12."""
    g = np.random.default_rng(9)
    p3 = _mlp_params((5, 7, 6, 3), seed=10)
    x = g.standard_normal((4, 5))
    np.testing.assert_allclose(
        to_numpy(P.mlp_apply(to_port(p3), to_port(x))),
        np.asarray(jnode.mlp_apply({k: jnp.asarray(v) for k, v in p3.items()},
                                   jnp.asarray(x))), rtol=0, atol=1e-12)

    params = {"encode": _mlp_params((784, 6), 11),
              "field": _mlp_params((6, 8, 6), 12),
              "head": _mlp_params((6, 10), 13)}
    xs = g.standard_normal((3, 784)) * 0.05
    kw = dict(saveat=[0.0, 1.0], dt=0.25, adaptive=False)
    logits_j = jnode.mnist_node_apply(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(xs),
        lambda prob: J.solve(prob, J.Tsit5(), **kw))
    logits = P.mnist_node_apply(
        {k: to_port(v) for k, v in params.items()}, to_port(xs),
        lambda prob: P.solve(prob, P.Tsit5(), **kw))
    assert logits.shape == (3, 10)
    np.testing.assert_allclose(to_numpy(logits), np.asarray(logits_j),
                               rtol=0, atol=1e-12)


def test_models_make_parameters_where_asked():
    """mlp_init draws from the caller's generator; spiral_data's problem
    solves to the spiral's known shape."""
    gen = torch.Generator().manual_seed(0)
    p = P.mlp_init(gen, (2, 50, 2), torch.float64, device="cpu")
    assert p["W0"].shape == (2, 50) and p["b1"].shape == (2,)
    assert p["W0"].device.type == "cpu" and float(p["b0"].abs().max()) == 0.0
    params, make_prob = P.spiral_neural_ode(gen, dtype=torch.float64,
                                            device="cpu")
    assert make_prob(params).u0.tolist() == [2.0, 0.0]
    prob, ts = P.spiral_data(torch.float64, device="cpu")
    sol = P.solve(prob, P.Tsit5(), saveat=ts, rtol=1e-8, atol=1e-10)
    assert sol.ys.shape == (30, 2) and sol.retcode == 0
    # the spiral decays towards the origin
    assert float(sol.ys[-1].norm()) < float(sol.ys[0].norm())
