"""Profiling and timing (the JAX package's ``utils/profiling.py`` on
``torch.profiler``).

* ``trace(logdir)``: a context manager that profiles the enclosed block, the
  host's ops and, where a card is present, its kernels (CPU and CUDA
  activities), and writes a Chrome trace (``trace.json``) into ``logdir``.
  The port's hand-written kernels are launched through ``ctypes`` and so do
  not appear as torch ops: their device kernels appear under their CUDA
  names (``asm_const`` launches e.g. ``asm_stage*`` kernels).
* ``annotate(name)``: a named region in the trace (``record_function``).
* ``timeit``: best-of-``trials`` steady-state time of a call, each window
  fenced by a CUDA synchronize where a card is present.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, Dict

import torch

__all__ = ["trace", "annotate", "timeit", "TRACE_FILE"]

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed block; on exit write ``logdir/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


def annotate(name: str):
    """A named region of the trace."""
    return torch.profiler.record_function(name)


def _fence() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def timeit(
    fn: Callable[..., Any],
    *args: Any,
    iters: int = 20,
    warmup: int = 2,
    trials: int = 3,
) -> Dict[str, float]:
    """Best-of-``trials`` steady-state time of ``fn(*args)``: ``warmup``
    calls first, then ``trials`` windows of ``iters`` calls, each window
    fenced by a CUDA synchronize. Returns ``sec_per_call`` and
    ``calls_per_sec``."""
    for _ in range(max(warmup, 1)):
        fn(*args)
    _fence()
    best = float("inf")
    for _ in range(trials):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        _fence()
        best = min(best, (time.perf_counter() - t0) / iters)
    return {"sec_per_call": best, "calls_per_sec": 1.0 / best}
