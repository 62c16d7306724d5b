"""Open loop: live cameras served frame by frame.

``K = ceil(rate / 30)`` cameras each send ``rate / K`` frames a second,
one frame in each period of ``K / rate`` seconds, at a phase of the period
drawn from the seed, with a jitter of up to ``jitter_ms``.  So every seed
offers the same number of frames, and a window averages over many
arrangements of the cameras.  The arrivals of all cameras are merged by
due time and take the pool's frames in turn.  One server (this thread)
serves them in that order, one at a time, through
``CascadeClassifier.detect_multi_scale_full``, starting each no earlier
than its due time.  A frame's latency runs from its due time to the return
of its boxes, so a frame that waits behind another counts the wait.  With
``seconds`` the frames due in the window are served, and every one of them
is waited for."""

from __future__ import annotations

import contextlib
import math
import time

import numpy as np

from portbench.harness.cell import Served, load_module

_camera = load_module("traffic", "camera")


def setup(cfg, mix, paths, device):
    return _camera.setup(cfg, mix, paths, device)


def schedule(mix, seed, seconds=None, count=None) -> np.ndarray:
    """Due times (s from the start), sorted: the window's, or the first
    ``count``."""
    rate = float(mix["rate"])
    k = max(1, math.ceil(rate / 30.0))
    period = k / rate
    horizon = seconds if seconds is not None else count / rate
    n = int(horizon / period) + 2
    rng = np.random.default_rng([int(seed), 2])
    phase = rng.uniform(0, period, (n, k))
    jit = rng.uniform(-1, 1, (n, k)) * float(mix["jitter_ms"]) * 1e-3
    due = np.sort((np.arange(n)[:, None] * period + phase + jit).reshape(-1))
    due = due[due >= 0]
    return due[due < seconds] if seconds is not None else due[:count]


def run(state, frames, seed, seconds=None, count=None, span=None):
    span = span or (lambda name: contextlib.nullcontext())
    due = schedule(state["mix"], seed, seconds, count)
    start = time.perf_counter()
    served = []
    for i, d in enumerate(due):
        t0 = start + float(d)
        wait = t0 - time.perf_counter()
        if wait > 0:
            with span("live.idle"):
                time.sleep(wait)
        k = i % len(frames)
        with span("live.detect"):
            out = _camera.detect(state, frames[k])
        served.append(Served(k, out, t0, time.perf_counter()))
    return served
