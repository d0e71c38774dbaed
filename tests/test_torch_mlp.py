"""Parity of the port's fused MLP field (`ops/mlp.py`, kernels K3 and K4)
with the JAX package's `fused_mlp2`, on the CPU: the port's plain versions
(the CPU side of its `torch.library` operators) against the Pallas kernels
run in interpret mode, as tests/test_pallas_mlp.py runs them. Float64 unless
bfloat16 is named."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import to_numpy, to_port

from scimlsensitivity_jl_tpu.ops.pallas_mlp import fused_mlp2 as jax_fused
from scimlsensitivity_jl_tpu_torch.ops import mlp
from scimlsensitivity_jl_tpu_torch.utils.pytree import from_numpy_tree

SHAPES = [(8, 4, 16, 4), (None, 4, 16, 4), (1, 2, 50, 2), (None, 2, 50, 2)]
SHAPE_IDS = ["8x4-16-4", "row4-16-4", "1x2-50-2", "row2-50-2"]


def _inputs(B, din, hid, dout, seed=0):
    """Weights, biases, input and output cotangent from a numpy seed; B None
    is a 1-D input row."""
    g = np.random.default_rng(seed)
    params = {"W0": g.standard_normal((din, hid)) / np.sqrt(din),
              "b0": 0.1 * g.standard_normal(hid),
              "W1": g.standard_normal((hid, dout)) / np.sqrt(hid),
              "b1": 0.1 * g.standard_normal(dout)}
    lead = () if B is None else (B,)
    return params, g.standard_normal(lead + (din,)), g.standard_normal(lead + (dout,))


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_plain_k3_k4_match_jax_fused_mlp2(shape):
    """y and all five cotangents of the plain versions against JAX's fused
    kernels and jax.vjp, atol 1e-12 (float64; only summation order
    differs)."""
    params, x, gy = _inputs(*shape)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    y_j, pull = jax.vjp(jax_fused, jp, jnp.asarray(x))
    dp_j, dx_j = pull(jnp.asarray(gy))

    pp = {k: v.requires_grad_() for k, v in to_port(params).items()}
    xx = to_port(x).requires_grad_()
    y = mlp.fused_mlp2(pp, xx)
    assert y.shape == y_j.shape
    np.testing.assert_allclose(to_numpy(y), np.asarray(y_j), rtol=0, atol=1e-12)
    y.backward(to_port(gy))
    np.testing.assert_allclose(to_numpy(xx.grad), np.asarray(dx_j), rtol=0,
                               atol=1e-12)
    for k in params:
        np.testing.assert_allclose(to_numpy(pp[k].grad), np.asarray(dp_j[k]),
                                   rtol=0, atol=1e-12, err_msg=k)


def test_bf16_forward_matches_jax():
    """bfloat16 forward against JAX's fused kernel at 5e-2, the tolerance of
    tests/test_pallas_mlp.py:25; weights cross over as JAX bfloat16 arrays
    through `from_numpy_tree`, and the output keeps x's dtype."""
    params, x, _ = _inputs(8, 4, 16, 4, seed=1)
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in params.items()}
    xj = jnp.asarray(x, jnp.bfloat16)
    y_j = jax_fused(jp, xj)
    pp = from_numpy_tree({k: np.asarray(v) for k, v in jp.items()}, "cpu",
                         torch.bfloat16)
    y = mlp.fused_mlp2(pp, from_numpy_tree(np.asarray(xj), "cpu", torch.bfloat16))
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(y_j, np.float64), rtol=5e-2, atol=5e-2)


def test_plain_versions_keep_the_kernel_dtype_rules():
    """bfloat16: h is stored rounded and the second product reads it, and
    dz is rounded before dW0 and dx; the plain version equals a hand-made
    float32 computation that rounds at those places."""
    params, x, gy = _inputs(5, 3, 7, 2, seed=2)
    bf = lambda a: torch.as_tensor(a, dtype=torch.float32).to(torch.bfloat16)
    w0, b0, w1, b1 = (bf(params[k]) for k in ("W0", "b0", "W1", "b1"))
    xb, gb = bf(x), bf(gy)
    y, h = mlp.mlp2_fwd_reference(xb, w0, b0, w1, b1)
    f = lambda t: t.float()
    h_ref = torch.tanh(f(xb) @ f(w0) + f(b0)).to(torch.bfloat16)
    assert torch.equal(h, h_ref)
    assert torch.equal(y, (f(h_ref) @ f(w1) + f(b1)).to(torch.bfloat16))
    dx, dw0, db0, _dw1, _db1 = mlp.mlp2_vjp_reference(xb, w0, w1, h, gb)
    dz = (f(gb) @ f(w1).T) * (1.0 - f(h) * f(h))
    assert torch.equal(db0, dz.sum(0).to(torch.bfloat16))
    dzc = f(dz.to(torch.bfloat16))
    assert torch.equal(dw0, (f(xb).T @ dzc).to(torch.bfloat16))
    assert torch.equal(dx, (dzc @ f(w0).T).to(torch.bfloat16))


def test_cpu_tensors_take_the_plain_version():
    """A CPU call goes through the plain versions and never touches the CUDA
    wrappers or their launch counters; the wrappers refuse CPU tensors."""
    params, x, _ = _inputs(3, 2, 5, 2)
    before = (mlp.mlp2_fwd_cuda.launches, mlp.mlp2_vjp_cuda.launches)
    pp = {k: v.requires_grad_() for k, v in to_port(params).items()}
    mlp.fused_mlp2(pp, to_port(x)).sum().backward()
    assert (mlp.mlp2_fwd_cuda.launches, mlp.mlp2_vjp_cuda.launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        mlp.mlp2_fwd_cuda(to_port(x), *(to_port(params)[k] for k in
                                        ("W0", "b0", "W1", "b1")))
