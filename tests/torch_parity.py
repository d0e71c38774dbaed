"""Shared helpers for the parity tests of the PyTorch port against the JAX
package (tests/test_torch_*.py).

Both packages get the same inputs, made from a numpy seed: JAX as
jnp arrays, the port through `from_numpy_tree` as float64 CPU tensors.
conftest.py has already put JAX on the CPU in float64, so the JAX side runs
as the package's own tests run it (Pallas kernels in interpret mode).
"""

from __future__ import annotations

import jax
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


def jax_o0(fn, *args):
    """fn(*args) compiled as one XLA program at backend optimization level
    0. Its float rounding is then op by op (no contracted multiply-adds),
    as under `jax.disable_jit()`, so adaptive solves take the port's steps,
    while one compile costs far less than running the loops op by op."""
    compiled = jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    return compiled(*args)


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


_TORCH_TO_JNP = {torch.float64: jnp.float64, torch.float32: jnp.float32,
                 torch.bfloat16: jnp.bfloat16}
_fold_in = jax.jit(jax.random.fold_in)
_split = jax.jit(jax.random.split)
_normal = jax.jit(jax.random.normal, static_argnums=(1, 2))


class JaxKey:
    """The port's key protocol (`ops.brownian`: fold_in, split, normal)
    over `jax.random`: handed to the port's solve in place of its own key,
    it draws exactly the numbers the JAX package draws from the same
    jax.random key, so both packages integrate one path. Children and
    draws are memoised on the key that made them, so the reverse passes'
    regenerated draws cost a lookup."""

    __slots__ = ("key", "_children", "_draws")

    def __init__(self, key):
        self.key = key
        self._children = {}
        self._draws = {}

    def fold_in(self, data):
        data = int(data)
        child = self._children.get(data)
        if child is None:
            child = self._children[data] = JaxKey(_fold_in(self.key, data))
        return child

    def split(self):
        pair = self._children.get("split")
        if pair is None:
            keys = _split(self.key)
            pair = self._children["split"] = (JaxKey(keys[0]),
                                              JaxKey(keys[1]))
        return pair

    def normal(self, shape, dtype, device):
        memo = (tuple(shape), dtype)
        z = self._draws.get(memo)
        if z is None:
            z = self._draws[memo] = torch.from_numpy(np.array(
                _normal(self.key, tuple(shape), _TORCH_TO_JNP[dtype]),
                dtype=np.float64)).to(dtype)
        return z.to(device)
