"""Profiling helpers (PyTorch port).

Counterpart of `scimlsensitivity_jl_tpu/utils/profile.py`: `trace` (on
`torch.profiler` where JAX uses `jax.profiler`), `timed` and
`solve_stats`.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time

import torch

__all__ = ["trace", "timed", "solve_stats", "Trace"]


class Trace:
    """What `trace` yields: the profiler (`prof`, read after the block),
    the directory of its Chrome trace (`logdir`/trace.json) and the block's
    host wall time in ms (`wall_ms`)."""

    def __init__(self, logdir: str, prof):
        self.logdir, self.prof, self.wall_ms = logdir, prof, None

    def device_ms(self) -> float:
        """The device's kernel time in the block: the sum of every device
        event's own time, in ms (0 on a CPU trace)."""
        return sum(e.self_device_time_total
                   for e in self.prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3

    def idle_share(self) -> float:
        """The share of the block's wall time the device had no kernel."""
        return 1.0 - self.device_ms() / self.wall_ms


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(logdir: str = None):
    """Trace the enclosed block with torch.profiler: the card's kernels
    when there is a card, else the host's operators. Yields a `Trace`;
    the Chrome trace (Perfetto, chrome://tracing) goes to
    `logdir`/trace.json (default: sml_trace in the temporary directory).

        with trace() as tr:
            loss = step(params, xb, yb)
        print(tr.idle_share())
    """
    logdir = logdir or os.path.join(tempfile.gettempdir(), "sml_trace")
    os.makedirs(logdir, exist_ok=True)
    activity = (torch.profiler.ProfilerActivity.CUDA
                if torch.cuda.is_available()
                else torch.profiler.ProfilerActivity.CPU)
    _sync()
    with torch.profiler.profile(activities=[activity]) as prof:
        tr = Trace(logdir, prof)
        t0 = time.perf_counter()
        try:
            yield tr
        finally:
            _sync()
            tr.wall_ms = (time.perf_counter() - t0) * 1e3
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@contextlib.contextmanager
def timed(label: str = "block"):
    """Wall-time the enclosed block; with the card in use, it is
    synchronised at both ends, so the time holds its work. Yields a dict
    whose "seconds" is set at the end, and prints it."""
    _sync()
    t0 = time.perf_counter()
    out = {"label": label, "seconds": None}
    try:
        yield out
    finally:
        _sync()
        out["seconds"] = time.perf_counter() - t0
        print(f"[{label}] {out['seconds'] * 1e3:.3f} ms", flush=True)


def solve_stats(sol):
    """A readable summary of a solution's work counters."""
    s = sol.stats
    return {
        "retcode": int(sol.retcode),
        "n_accepted": int(s.n_accepted),
        "n_rejected": int(s.n_rejected),
        "n_fevals": int(s.n_fevals),
        "solver": sol.solver,
        "sensealg": repr(sol.sensealg),
    }
