"""Timing and profiling helpers.

Port of ``clfacedetection_tpu/utils/timing.py``: the reference's
``gettimeofday`` stopwatch (``ElapseTime``, clod.h:23-36) for host
phases; ``time_torch``, the counterpart of ``time_jax``: steady-state
milliseconds per call from CUDA events around back-to-back calls after a
warm-up; and ``profile_trace``, a ``torch.profiler`` session that writes
a Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Tuple

__all__ = ["ElapseTime", "time_torch", "profile_trace"]


class ElapseTime:
    """Stopwatch in milliseconds (API of the reference's ElapseTime)."""

    def __init__(self) -> None:
        self._s = 0.0

    def start(self) -> None:
        self._s = time.perf_counter()

    def get(self) -> float:
        return (time.perf_counter() - self._s) * 1e3


def time_torch(fn: Callable, *args, iters: int = 10, warmup: int = 2,
               device: str = "cuda") -> Tuple[float, object]:
    """Steady-state milliseconds per call of ``fn(*args)`` and its last
    output.  On the card: CUDA events on the current stream around
    ``iters`` back-to-back calls, after ``warmup`` calls and a sync (the
    device's pace; a call that reads back to the host includes it).  With
    ``device="cpu"``: the host clock around the same calls."""
    import torch
    out = None
    for _ in range(max(warmup, 1)):
        out = fn(*args)
    if device == "cpu":
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args)
        return (time.perf_counter() - t0) * 1e3 / iters, out
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        out = fn(*args)
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters, out


@contextlib.contextmanager
def profile_trace(log_dir: str, cuda: bool = True):
    """A ``torch.profiler`` session around the block (CPU activity, and
    the card's when ``cuda``); on exit its Chrome trace is written to
    ``<log_dir>/trace.json``.  Yields the profiler (``key_averages()``)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
