"""Flatten / unflatten states and parameters (PyTorch port).

Counterpart of `scimlsensitivity_jl_tpu/utils/pytree.py` (which re-exports
`jax.flatten_util.ravel_pytree`). The port takes a tensor or a (nested)
dict / list / tuple of tensors. Dict keys are visited in sorted order, as
JAX does, so a flat parameter vector lines up entry for entry with the
JAX package's.

`from_numpy_tree` carries weights across: it turns the JAX package's
parameters, handed over as numpy arrays or Python numbers, into the port's
tensors on an explicit device and dtype. A JAX bfloat16 array becomes a
numpy array of the `ml_dtypes` bfloat16 type, which torch does not take; it
goes through float32, which holds every bfloat16 value exactly.
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

import numpy as np
import torch

__all__ = ["ravel_pytree", "tree_leaves", "tree_size", "from_numpy_tree"]


def tree_leaves(tree) -> list:
    """Tensors of `tree` in flattening order (dict keys sorted)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for key in sorted(tree) for x in tree_leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [x for item in tree for x in tree_leaves(item)]
    return [tree]


def tree_size(tree) -> int:
    """Total number of scalar entries in the tree."""
    return sum(int(x.numel()) for x in tree_leaves(tree))


def _unflatten(tree, flat: torch.Tensor, offset: int) -> Tuple[Any, int]:
    if tree is None:
        return None, offset
    if isinstance(tree, dict):
        out = {}
        for key in sorted(tree):
            out[key], offset = _unflatten(tree[key], flat, offset)
        return {key: out[key] for key in tree}, offset
    if isinstance(tree, (list, tuple)):
        items = []
        for item in tree:
            value, offset = _unflatten(item, flat, offset)
            items.append(value)
        return type(tree)(items), offset
    size = int(tree.numel())
    lead = flat.shape[:-1]
    piece = flat[..., offset:offset + size].reshape(tuple(lead) + tuple(tree.shape))
    return piece, offset + size


def ravel_pytree(tree) -> Tuple[torch.Tensor, Callable]:
    """(flat vector, unravel). `unravel` accepts leading batch dimensions:
    a (nt, n) matrix of flat rows comes back as a tree of (nt, ...) leaves.

    A lone tensor ravels to a view; a tree ravels by concatenation, so
    autograd carries flat cotangents back to its leaves. `None` ravels to
    an empty float64 vector."""
    leaves = tree_leaves(tree)
    if not leaves:
        flat = torch.zeros(0, dtype=torch.float64)
    elif len(leaves) == 1 and isinstance(tree, torch.Tensor):
        flat = tree.reshape(-1)
    else:
        flat = torch.cat([x.reshape(-1) for x in leaves])

    def unravel(vec: torch.Tensor):
        return _unflatten(tree, vec, 0)[0]

    return flat, unravel


_COMPLEX_OF = {torch.float32: torch.complex64,
               torch.float64: torch.complex128}


def from_numpy_tree(tree, device, dtype: torch.dtype):
    """numpy arrays / Python numbers (and dicts, lists, tuples of them) ->
    tensors on `device` in `dtype`. Tensors pass through converted. A
    complex input stays complex, in the complex dtype whose parts are
    `dtype`."""
    def convert(x):
        if isinstance(x, torch.Tensor):
            return x.to(device=device, dtype=_like(x.is_complex()))
        a = np.asarray(x)
        if a.dtype.kind == "V":  # ml_dtypes' bfloat16 and kin
            a = a.astype(np.float32)
        return torch.as_tensor(a, dtype=_like(a.dtype.kind == "c")).to(device)

    def _like(is_complex):
        return _COMPLEX_OF.get(dtype, dtype) if is_complex else dtype

    if isinstance(tree, dict):
        return {key: from_numpy_tree(tree[key], device, dtype) for key in tree}
    if isinstance(tree, (list, tuple)) and not _is_number_sequence(tree):
        return type(tree)(from_numpy_tree(x, device, dtype) for x in tree)
    return convert(tree)


def tree_to(tree, device):
    """Every tensor of a tree (dicts, lists, tuples) on `device`, as
    differentiable copies; anything else (numbers, arrays, named tuples
    such as Stats) as it is."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {key: tree_to(v, device) for key, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(tree_to(v, device) for v in tree)
    return tree


def _is_number_sequence(seq) -> bool:
    """A flat list of numbers (e.g. `p=[D, k]`) is one vector, not a tree."""
    return len(seq) > 0 and all(
        isinstance(x, (int, float, complex, np.number))
        and not isinstance(x, bool) for x in seq)
