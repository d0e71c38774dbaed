"""Parity of the port's reaction-diffusion field (ops/rd1d.py) with the JAX
package's Pallas field (ops/pallas_pde.py), at n = 256 in float64 on the
CPU, where the port runs the kernels' plain versions. The CUDA kernels
themselves are held against those plain versions in test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_close, rng, to_numpy, to_port

from scimlsensitivity_jl_tpu.ops import pallas_pde as jpde
from scimlsensitivity_jl_tpu_torch.ops import rd1d

N = 256
INV_DX2 = float(N * N)
P = np.array([0.7, 2.3])


def _inputs(seed=0, n=N):
    g = rng(seed)
    return g.uniform(0.0, 1.0, n), g.standard_normal(n)


def _jax_fwd(u, p):
    return jpde.fused_rd1d(jnp.asarray(u), p[0], p[1], INV_DX2)


@pytest.mark.parametrize("port_fn", ["fused_rd1d", "rd1d_reference"])
def test_forward_matches_jax(port_fn):
    u, _ = _inputs()
    f_pallas = _jax_fwd(u, jnp.asarray(P))
    f_ref = jpde.rd1d_reference(jnp.asarray(u), P[0], P[1], INV_DX2)
    f_port = getattr(rd1d, port_fn)(to_port(u), to_port(P), INV_DX2)
    assert_close(f_port, f_pallas, atol=1e-12)
    assert_close(f_port, f_ref, atol=1e-12)


def _jax_pullback(u, lam):
    _, pull = jax.vjp(lambda a, b, c: jpde.fused_rd1d(a, b, c, INV_DX2),
                      jnp.asarray(u), jnp.asarray(P[0]), jnp.asarray(P[1]))
    du, dD, dk = pull(jnp.asarray(lam))
    return np.asarray(du), np.array([float(dD), float(dk)])


def _port_pullback_autograd(u, p, lam):
    u = u.clone().requires_grad_()
    p = p.clone().requires_grad_()
    f = rd1d.fused_rd1d(u, p, INV_DX2)
    return torch.autograd.grad(f, (u, p), lam)


@pytest.mark.parametrize("route", ["autograd_function", "vjp_reference"])
def test_pullback_matches_jax(route):
    """ū, D̄, k̄ at the tolerance of tests/test_pallas_pde.py."""
    u, lam = _inputs(1)
    du_j, dp_j = _jax_pullback(u, lam)
    if route == "autograd_function":
        du, dp = _port_pullback_autograd(to_port(u), to_port(P), to_port(lam))
    else:
        du, dp = rd1d.rd1d_vjp_reference(to_port(u), to_port(P), INV_DX2,
                                         to_port(lam))
    assert_close(du, du_j, rtol=1e-9, atol=1e-9)
    assert_close(dp, dp_j, rtol=1e-9, atol=1e-9)


def test_edge_cells_copy_the_boundary():
    """The ghost cell copies the boundary: L(u)_0 = u_1 − u_0 and
    L(u)_{n−1} = u_{n−2} − u_{n−1}, in the field and in the pullback."""
    u, lam = _inputs(2)
    D, k = P
    f = to_numpy(rd1d.fused_rd1d(to_port(u), to_port(P), INV_DX2))
    assert f[0] == pytest.approx(D * INV_DX2 * (u[1] - u[0])
                                 + k * u[0] * (1 - u[0]), rel=1e-13)
    assert f[-1] == pytest.approx(D * INV_DX2 * (u[-2] - u[-1])
                                  + k * u[-1] * (1 - u[-1]), rel=1e-13)
    du, _ = rd1d.rd1d_vjp_reference(to_port(u), to_port(P), INV_DX2,
                                    to_port(lam))
    du = to_numpy(du)
    assert du[0] == pytest.approx(D * INV_DX2 * (lam[1] - lam[0])
                                  + k * (1 - 2 * u[0]) * lam[0], rel=1e-13)
    assert du[-1] == pytest.approx(D * INV_DX2 * (lam[-2] - lam[-1])
                                   + k * (1 - 2 * u[-1]) * lam[-1], rel=1e-13)
    du_j, _ = _jax_pullback(u, lam)
    assert_close(du[[0, -1]], du_j[[0, -1]], rtol=1e-12)


def test_gradcheck_fused_rd1d():
    u, _ = _inputs(3, n=16)
    uu = to_port(u).requires_grad_()
    pp = to_port(P).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda a, b: rd1d.fused_rd1d(a, b, 256.0), (uu, pp))


def test_func_vjp_over_the_field():
    """torch.func.vjp, which ops/vjp.py uses, accepts the Function (it is in
    the setup_context form) and gives JAX's pullback."""
    u, lam = _inputs(4)
    field = rd1d.make_rd1d_field(N, 1.0 / N)
    fval, pull = torch.func.vjp(lambda a, b: field(a, b, 0.0), to_port(u),
                                to_port(P))
    du, dp = pull(to_port(lam))
    du_j, dp_j = _jax_pullback(u, lam)
    assert_close(fval, _jax_fwd(u, jnp.asarray(P)), atol=1e-12)
    assert_close(du, du_j, rtol=1e-9, atol=1e-9)
    assert_close(dp, dp_j, rtol=1e-9, atol=1e-9)


def test_cpu_tensors_take_the_plain_version():
    """On the CPU the operators run the plain versions and launch nothing;
    the CUDA wrappers refuse a CPU tensor instead of falling back."""
    u, lam = _inputs(5)
    before = (rd1d.rd1d_fwd_cuda.launches, rd1d.rd1d_vjp_cuda.launches)
    f = rd1d.rd1d_fwd(to_port(u), to_port(P), INV_DX2)
    assert torch.equal(f, rd1d.rd1d_reference(to_port(u), to_port(P), INV_DX2))
    rd1d.rd1d_vjp(to_port(u), to_port(P), INV_DX2, to_port(lam))
    assert (rd1d.rd1d_fwd_cuda.launches, rd1d.rd1d_vjp_cuda.launches) == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        rd1d.rd1d_fwd_cuda(to_port(u), to_port(P), INV_DX2)
