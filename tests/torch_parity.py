"""Shared helpers for the parity tests of the PyTorch port against the JAX
package (tests/test_torch_*.py).

Both packages get the same inputs, made from a numpy seed: JAX as
jnp arrays, the port through `from_numpy_tree` as float64 CPU tensors.
conftest.py has already put JAX on the CPU in float64, so the JAX side runs
as the package's own tests run it (Pallas kernels in interpret mode).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import torch

from scimlsensitivity_jl_tpu_torch.utils.pytree import from_numpy_tree

# tier-1 runs several pytest workers on one host: one thread each
torch.set_num_threads(1)

DTYPE = torch.float64


def rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)


def to_port(tree):
    """numpy inputs -> the port's float64 CPU tensors."""
    return from_numpy_tree(tree, "cpu", DTYPE)


def to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def rd1d_u0(n: int) -> np.ndarray:
    """The flagship initial state: a Gaussian bump on [0, 1)."""
    return np.exp(-(((np.arange(n) / n) - 0.5) ** 2) * 100.0)


def lotka_volterra_jax(u, p, t):
    x, y = u[0], u[1]
    a, b, c, d = p[0], p[1], p[2], p[3]
    return jnp.stack([a * x - b * x * y, -c * y + d * x * y])


def lotka_volterra_port(u, p, t):
    x, y = u[0], u[1]
    a, b, c, d = p[0], p[1], p[2], p[3]
    return torch.stack([a * x - b * x * y, -c * y + d * x * y])


def assert_close(port, ref, *, rtol=0.0, atol=0.0, msg=""):
    np.testing.assert_allclose(to_numpy(port), to_numpy(ref), rtol=rtol,
                               atol=atol, err_msg=msg)
