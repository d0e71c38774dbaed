"""Counter-based, replayable Brownian noise (PyTorch port).

Counterpart of `scimlsensitivity_jl_tpu/ops/brownian.py`: `NoiseGrid`
(:36), `grid_increment` (:52), `grid_iterated` (:58), `grid_levy_area`
(:73), `grid_path` (:95) and `VirtualBrownianTree` (:105-163). As in the
JAX package, no path is stored: every draw is a pure function of a key
and the counters folded into it (step index, tag), so a forward pass, its
reverse and a second call regenerate the same bits.

A key has three methods, the protocol every draw here goes through:

    key.fold_in(data) -> key     a child key tagged with an integer
    key.split() -> (key, key)    two independent children
    key.normal(shape, dtype, device) -> tensor of standard normals

`PRNGKey` is the port's own: its state is a 64-bit integer, each fold or
split hashes it (splitmix64), and a draw seeds a `torch.Generator` on the
draw's device with it, so nothing touches the global RNG and nothing is
read back. Its bits differ from `jax.random`'s, and the CPU's from the
card's (their generators differ). `NumpyKey` hashes the same chain but
draws with numpy on the host, so a card run and a CPU run see the same
path. A test can hand any object with the three methods (one that draws
with `jax.random`, say) to replay the JAX package's noise exactly.

The draws keep the JAX package's dtype chain (JAX with x64, as its tests
run it): ΔW, ζ and the bridge draw in float64 and are then cast, the Lévy
areas' X/Y and the tree's nodes draw in the state dtype.

Draws land on the device of the state they drive. The one public entry
point that makes tensors of its own, `VirtualBrownianTree.create`, puts
them on the card unless the caller names another device, as the model
factories do.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

__all__ = [
    "PRNGKey",
    "NumpyKey",
    "as_key",
    "grid_increment",
    "grid_iterated",
    "grid_levy_area",
    "grid_path",
    "NoiseGrid",
    "VirtualBrownianTree",
    "DRAW_DTYPE",
]

# the dtype of the draws JAX makes in its default float (float64 with x64)
DRAW_DTYPE = torch.float64

_MASK = (1 << 64) - 1
_FOLD = 0x9E3779B97F4A7C15
_LEFT = 0xD1B54A32D192ED03
_RIGHT = 0x8CB92BA72F3D8DD7


# one generator per device, seeded again for every draw
_GENERATORS = {}


def _mix(x: int) -> int:
    """splitmix64's finalizer: a bijection of 64-bit integers."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK
    return x ^ (x >> 31)


class PRNGKey:
    """The port's counter-based key: `PRNGKey(seed)`, the counterpart of
    `jax.random.PRNGKey(seed)`. Draws run on the device they are asked
    for, from a generator seeded with the key's state."""

    __slots__ = ("state",)

    def __init__(self, seed: int = 0, *, _state=None):
        self.state = _mix(int(seed) & _MASK) if _state is None else _state

    def _child(self, state):
        return type(self)(_state=state)

    def fold_in(self, data) -> "PRNGKey":
        return self._child(_mix(self.state ^ _mix((int(data) + _FOLD)
                                                  & _MASK)))

    def split(self) -> Tuple["PRNGKey", "PRNGKey"]:
        return (self._child(_mix(self.state ^ _LEFT)),
                self._child(_mix(self.state ^ _RIGHT)))

    def normal(self, shape, dtype, device) -> torch.Tensor:
        device = torch.device(device)
        gen = _GENERATORS.get(device)
        if gen is None:
            gen = _GENERATORS[device] = torch.Generator(device=device)
        gen.manual_seed(self.state & ((1 << 63) - 1))
        return torch.randn(tuple(shape), generator=gen, dtype=dtype,
                           device=device)

    def __repr__(self):
        return f"{type(self).__name__}(state=0x{self.state:016x})"


class NumpyKey(PRNGKey):
    """`PRNGKey`'s chain with numpy's generator on the host: the same
    numbers on every device (the draws are copied over), so a card run
    can be held against a CPU run."""

    __slots__ = ()

    def normal(self, shape, dtype, device) -> torch.Tensor:
        z = np.random.default_rng(self.state).standard_normal(tuple(shape))
        return torch.from_numpy(np.asarray(z)).to(device=device, dtype=dtype)


def as_key(key):
    """None -> PRNGKey(0) (JAX's default PRNGKey(0)); an int -> its
    PRNGKey; a key object passes through."""
    if key is None:
        return PRNGKey(0)
    if isinstance(key, (int, np.integer)):
        return PRNGKey(int(key))
    return key


class NoiseGrid(NamedTuple):
    """An observed Brownian path at the grid nodes (the DiffEqNoiseProcess
    NoiseGrid analogue). ts: (N+1,) node times, equal to the solve's grid
    t0 + i·dt (checked); W: (N+1,) + noise shape. The solvers consume its
    increments ΔW_i = W[i+1] − W[i], forward and reverse alike."""

    ts: object
    W: object


def grid_increment(key, i, shape, dt, device) -> torch.Tensor:
    """ΔW_i ~ N(0, |dt|) for step i of a fixed grid, pure in (key, i); in
    DRAW_DTYPE (the caller casts). dt is a host scalar of the state's
    dtype, whose square root rounds in that dtype as JAX's does."""
    z = key.fold_in(i).normal(shape, DRAW_DTYPE, device)
    return z * float(np.sqrt(np.abs(dt)))


def grid_iterated(key, i, shape, dt, dw) -> torch.Tensor:
    """ΔZ_i = ∫ₜ^{t+h} (W(s) − W(t)) ds given ΔW_i = dw: (h/2)(ΔW +
    √(h/3)·ζ), ζ ~ N(0, I) from (key, i) tagged 0x5A1; in DRAW_DTYPE."""
    zeta = key.fold_in(i).fold_in(0x5A1).normal(shape, DRAW_DTYPE, dw.device)
    kind = type(dt)
    h = kind(abs(dt))
    scale = float(np.sqrt(kind(h / kind(3.0))))
    return float(kind(0.5) * dt) * (dw.to(DRAW_DTYPE) + scale * zeta)


def grid_levy_area(key, i, m, dt, dw, terms: int = 10) -> torch.Tensor:
    """The antisymmetric Lévy area A_jk for step i given ΔW_i = dw (m,),
    by the truncated Kloeden–Platen series (h/2π) Σ_r (1/r)(X_r b_rᵀ −
    b_r X_rᵀ), b_r = Y_r + √(2/h)ΔW; X, Y from (key, i) tagged 0x1E4, then
    0 and 1, in dw's dtype. A dw of shape (..., m) gives (..., m, m), its
    leading axes independent paths drawn in one call."""
    k = key.fold_in(i).fold_in(0x1E4)
    kind = type(dt)
    h = kind(abs(dt))
    lead = tuple(dw.shape[:-1])
    X = k.fold_in(0).normal(lead + (terms, m), dw.dtype, dw.device)
    Y = k.fold_in(1).normal(lead + (terms, m), dw.dtype, dw.device)
    b = Y + float(np.sqrt(kind(kind(2.0) / h))) * dw[..., None, :]
    r = torch.arange(1, terms + 1, dtype=dw.dtype, device=dw.device)
    outer = (X[..., :, :, None] * b[..., :, None, :]
             - b[..., :, :, None] * X[..., :, None, :])
    return float(kind(h / kind(2.0 * math.pi))) * torch.sum(
        outer / r[:, None, None], dim=-3)


def grid_path(key, n_steps: int, shape, dt, device) -> torch.Tensor:
    """W at the n_steps + 1 grid nodes (W(t0) = 0), the cumulative sum of
    the increments, in DRAW_DTYPE (the caller casts)."""
    incs = torch.stack([grid_increment(key, i, shape, dt, device)
                        for i in range(n_steps)])
    w = torch.cumsum(incs, dim=0)
    return torch.cat([w.new_zeros((1,) + tuple(shape)), w])


class VirtualBrownianTree:
    """W(t) on [t0, t1] by fixed-depth bisection with Brownian-bridge
    draws (Li et al. 2020): the same t gives the same W, so forward and
    reverse passes read one path and none is stored. Each query walks
    `depth` nodes, one draw each. A tree memoises its queries' results (a
    solve makes its own tree, so the reverse reads the forward's W without
    drawing again) and keeps only the nodes on the last query's path, so
    the next query draws just where its walk leaves that path and the tree
    holds at most `depth` nodes.
    Times are host scalars of the tree's time type, as JAX keeps them in
    the tree's dtype."""

    def __init__(self, key, t0, t1, w_end, shape, depth, kind, device):
        self.key, self.t0, self.t1 = key, t0, t1
        self.w_end, self.shape, self.depth = w_end, tuple(shape), depth
        self.kind, self.device = kind, device
        self._memo = {}
        # the last query's walk: per level, (the node's place, its midpoint
        # W, its child keys)
        self._path = []

    @classmethod
    def create(cls, key, t0, t1, shape=(), depth: int = 30,
               dtype=torch.float64, device="cuda"):
        from ..solvers.integrate import state_kind

        key = as_key(key)
        kind = state_kind(dtype)
        t0, t1 = kind(t0), kind(t1)
        k_end, key = key.split()
        w_end = k_end.normal(shape, dtype, device) * float(
            np.sqrt(kind(t1 - t0)))
        return cls(key, t0, t1, w_end, shape, depth, kind, device)

    def __call__(self, t) -> torch.Tensor:
        kind = self.kind
        t = kind(float(t))
        hit = self._memo.get(t)
        if hit is not None:
            return hit
        key, ta, tb = self.key, self.t0, self.t1
        wa = self.w_end.new_zeros(self.shape)
        wb = self.w_end
        half = kind(0.5)
        last, walk = self._path, []
        place = 1  # the node's place in the tree: a leading 1, then its turns
        for level in range(self.depth):
            tm = kind(half * kind(ta + tb))
            if level < len(last) and last[level][0] == place:
                node = last[level]
            else:
                std = float(half * np.sqrt(max(kind(tb - ta), kind(0.0))))
                z = key.fold_in(0).normal(self.shape, wa.dtype, wa.device)
                # JAX's roundings: mean = ½(wa + wb), then mean + std·z
                node = (place, torch.add(wa, wb).mul_(half).add_(z * std),
                        ) + key.split()
            walk.append(node)
            _, wm, key_l, key_r = node
            if t < tm:
                key, tb, wb, place = key_l, tm, wm, 2 * place
            else:
                key, ta, wa, place = key_r, tm, wm, 2 * place + 1
        self._path = walk
        # a leaf narrower than the time type's spacing (float32 at depth
        # 28) has tb − ta = 0 and reads W(ta); JAX's 1e-300 floor is 0 in
        # float32 and reads NaN there
        h = max(kind(tb - ta), np.finfo(kind).tiny)
        theta = float(min(max(kind(kind(t - ta) / h), kind(0.0)), kind(1.0)))
        out = wa + theta * (wb - wa)
        self._memo[t] = out
        return out
