"""Solution object (PyTorch port).

Counterpart of `scimlsensitivity_jl_tpu/solution.py:ODESolution` and
`RETCODE_NAMES`, with the same retcodes and one more: 6 names
BacksolveAdjoint's reconstruction drift, which the JAX package reports as
3, the code of a DDE lag violation (a deliberate divergence, ROADMAP §3).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from .ops.interp import DenseOutput, dense_eval
from .solvers.integrate import Stats

__all__ = ["ODESolution", "RETCODE_NAMES"]

RETCODE_NAMES = {0: "Success", 1: "MaxIters", 2: "DtLessThanMin",
                 3: "DDELagViolation", 4: "EventRecordOverflow",
                 5: "Terminated", 6: "BacksolveReconstructionDrift"}


@dataclass
class ODESolution:
    """Result of `solve`.

    ts: (nt,) save times, a CPU tensor in the time dtype: the port keeps
        times on the host, so building the solution copies nothing to the
        device and waits for nothing.
    ys: like the state, with a leading time axis (nt, ...).
    stats / retcode: the forward solve's counters and return code (ints).
    dense: DenseOutput over flat states, or None.
    adjoint: for continuous sensealgs, an AdjointRecord that the backward
        pass fills in with the reverse solve's Stats (the JAX package has
        no such record: under `jit` the reverse counts stay on the device).
    """

    ts: torch.Tensor
    ys: Any
    stats: Stats
    retcode: int
    prob: Any = None
    solver: Any = None
    sensealg: Any = None
    dense: Optional[DenseOutput] = None
    unravel_u: Optional[Callable] = None
    u_final: Optional[torch.Tensor] = None  # flat state at t1
    t_final: Any = None
    adjoint: Any = None

    @property
    def success(self):
        """True for Success and Terminated."""
        return self.retcode in (0, 5)

    @property
    def t(self):
        return self.ts

    @property
    def u(self):
        return self.ys

    def __call__(self, t):
        """Dense evaluation u(t) at a scalar time or a 1-D list of times."""
        if self.dense is None:
            raise ValueError(
                "solve was called without dense=True; no continuous output stored"
            )
        if isinstance(t, torch.Tensor):
            t = t.tolist()
        if isinstance(t, (list, tuple)):
            return self.unravel_u(torch.stack([dense_eval(self.dense, ti)
                                               for ti in t]))
        return self.unravel_u(dense_eval(self.dense, t))

    def __len__(self):
        return int(self.ts.shape[0])
