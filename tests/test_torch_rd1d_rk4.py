"""Parity of the port's RK4 block (ops/rd1d.py: `make_rd1d_rk4_block`, the
plain versions of K5 and K6, `_chunk_geometry`) with the JAX package's
Pallas megakernel (ops/pallas_pde.py), in float64 on the CPU. JAX runs its
kernels under the Pallas interpreter (`force_kernel_interpret=True`, as
tests/test_pallas_pde.py does); the port runs the plain versions over the
whole grid. The CUDA kernels are held against those plain versions in
test_torch_cuda.py."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import assert_close, rng, to_numpy, to_port

from scimlsensitivity_jl_tpu.ops import pallas_pde as jpde
from scimlsensitivity_jl_tpu_torch.ops import rd1d

# the megakernel test's problem (tests/test_pallas_pde.py:67-73)
N = 1024
D, K, H_STEP = 1e-4, 1.5, 1e-5
INV_DX2 = float(N * N)
P = np.array([D, K])


def _u0(n=N):
    i = np.arange(n)
    return np.exp(-(((i / n) - 0.5) ** 2) * 100.0) + 0.01 * np.sin(i * 0.1)


def _port_grads(fn, u0):
    """(value, ū, [D̄, k̄]) of Σ fn(u, p)² by the port's autograd."""
    u = to_port(u0).requires_grad_()
    p = to_port(P).requires_grad_()
    y = fn(u, p)
    gu, gp = torch.autograd.grad(torch.sum(y ** 2), (u, p))
    return y.detach(), gu, gp


def _jax_scan_grads(u0, n_steps):
    def loss(u, DD, kk):
        y = jpde.rd1d_rk4_scan_reference(u, DD, kk, INV_DX2, H_STEP, n_steps)
        return jnp.sum(y ** 2)

    gu, gD, gk = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(u0), D, K)
    return np.asarray(gu), np.array([float(gD), float(gk)])


def _assert_grads(gu, gp, gu_ref, gp_ref):
    """ū within 1e-11, D̄ and k̄ within 1e-10 relative (test_pallas_pde.py)."""
    assert float(np.max(np.abs(to_numpy(gu) - gu_ref))) < 1e-11
    for got, want in zip(to_numpy(gp), gp_ref):
        assert abs(got - want) < 1e-10 * max(1.0, abs(want))


@pytest.mark.parametrize("S", [2, 4])
def test_scan_reference_matches_jax(S):
    u0 = _u0()
    y_j = jpde.rd1d_rk4_scan_reference(jnp.asarray(u0), D, K, INV_DX2,
                                       H_STEP, S)
    y_p = rd1d.rd1d_rk4_scan_reference(to_port(u0), to_port(P), INV_DX2,
                                       H_STEP, S)
    assert_close(y_p, y_j, atol=1e-12)


@pytest.mark.parametrize("chunk,bwd_chunk,S",
                         [(256, 256, 4), (512, 256, 2), (1024, 1024, 4)])
def test_block_matches_jax_kernels(chunk, bwd_chunk, S):
    """The port's block (plain K5 forward, plain K6 pullback through
    autograd) against JAX's interpret-mode kernels and against jax.grad of
    the scan, at the geometries of tests/test_pallas_pde.py: G > 1 with
    equal and unequal tiles, and one tile."""
    u0 = _u0()
    blk_j = jpde.make_rd1d_rk4_block(N, S, chunk=chunk, bwd_chunk=bwd_chunk,
                                     force_kernel_interpret=True)
    y_j = blk_j(jnp.asarray(u0), D, K, INV_DX2, H_STEP)
    gk_j = jax.grad(lambda u, DD, kk: jnp.sum(
        blk_j(u, DD, kk, INV_DX2, H_STEP) ** 2), argnums=(0, 1, 2))(
        jnp.asarray(u0), D, K)

    blk = rd1d.make_rd1d_rk4_block(N, S, chunk=chunk, bwd_chunk=bwd_chunk)
    before = (rd1d.rd1d_rk4_fwd_cuda.launches, rd1d.rd1d_rk4_vjp_cuda.launches)
    y, gu, gp = _port_grads(lambda u, p: blk(u, p, INV_DX2, H_STEP), u0)
    # CPU tensors take the plain versions: nothing launches
    assert (rd1d.rd1d_rk4_fwd_cuda.launches,
            rd1d.rd1d_rk4_vjp_cuda.launches) == before

    assert float(np.max(np.abs(to_numpy(y) - np.asarray(y_j)))) < 1e-12
    _assert_grads(gu, gp, np.asarray(gk_j[0]),
                  np.array([float(gk_j[1]), float(gk_j[2])]))
    _assert_grads(gu, gp, *_jax_scan_grads(u0, S))


def test_vjp_reference_matches_port_autograd():
    """K6's plain version, derived by hand, against the port's own autograd
    through the scan reference: checks the derivation without JAX. A
    random state and cotangent, 3 steps, 1e-12 relative to max|·|."""
    g = rng(7)
    n, S = 256, 3
    u = to_port(g.uniform(0.0, 1.0, n))
    lam = to_port(g.standard_normal(n))
    p = to_port(np.array([0.7, 2.3]))
    inv_dx2, h = float(n * n), 1e-6
    du, dp = rd1d.rd1d_rk4_block_vjp_reference(u, p, inv_dx2, h, S, lam)
    uu, pp = u.clone().requires_grad_(), p.clone().requires_grad_()
    y = rd1d.rd1d_rk4_scan_reference(uu, pp, inv_dx2, h, S)
    du_a, dp_a = torch.autograd.grad(y, (uu, pp), lam)
    for got, want in ((du, du_a), (dp, dp_a)):
        err = float((got - want).abs().max() / want.abs().max())
        assert err <= 1e-12, err


def test_chained_blocks_match_jax_scan():
    """Four blocks of S = 4 (16 steps, chunk 256, bwd_chunk 512), chained
    as a user chains them, against jax.grad of a 16-step scan."""
    u0 = _u0()
    blk = rd1d.make_rd1d_rk4_block(N, 4, chunk=256, bwd_chunk=512)

    def chain(u, p):
        for _ in range(4):
            u = blk(u, p, INV_DX2, H_STEP)
        return u

    y, gu, gp = _port_grads(chain, u0)
    y_j = jpde.rd1d_rk4_scan_reference(jnp.asarray(u0), D, K, INV_DX2,
                                       H_STEP, 16)
    assert float(np.max(np.abs(to_numpy(y) - np.asarray(y_j)))) < 1e-12
    _assert_grads(gu, gp, *_jax_scan_grads(u0, 16))


@pytest.mark.parametrize("n,S,chunk", [
    (1024, 4, 256), (1024, 2, 512), (1024, 4, 1024), (1024, 4, 4096),
    (1048576, 16, 4096), (1048576, 16, 1024), (4096, 16, 68),
    (1000, 4, 256),   # n not divisible by the chunk
    (1024, 16, 64),   # chunk narrower than the halo 4(S+1) = 68
])
def test_chunk_geometry_matches_jax(n, S, chunk):
    try:
        want = jpde._chunk_geometry(n, S, chunk)
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e))):
            rd1d._chunk_geometry(n, S, chunk)
        with pytest.raises(ValueError):
            rd1d.make_rd1d_rk4_block(n, S, chunk=chunk, bwd_chunk=chunk)
        return
    assert rd1d._chunk_geometry(n, S, chunk) == tuple(int(x) for x in want)


def test_cuda_wrappers_refuse_cpu_tensors():
    u, p = to_port(_u0()), to_port(P)
    with pytest.raises(ValueError, match="CUDA tensor"):
        rd1d.rd1d_rk4_fwd_cuda(u, p, INV_DX2, H_STEP, 4, 256)
    with pytest.raises(ValueError, match="CUDA tensor"):
        rd1d.rd1d_rk4_vjp_cuda(u, p, INV_DX2, H_STEP, 4, 256, u)
