"""A bounded device trace: ``torch.profiler`` over a fixed slice of
traffic, kept only as a summary.

The summary holds each device operation's count and seconds by name
(kernels, and copies and sets apart), the seconds in which any ran
(``busy_s``) within the slice's host span (``window_s``), and the idle
gaps between them, each put down to the harness's innermost host span
(``portbench.*``, recorded with ``record_function``) around its middle.
No Chrome trace is written.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import numpy as np

__all__ = ["span", "traced", "summarize", "breakdown", "COPY_PREFIXES"]

COPY_PREFIXES = ("Memcpy", "Memset")


def span(name: str):
    """A host span of the harness, seen by the profiler."""
    from torch.profiler import record_function
    return record_function(f"portbench.{name}")


def _warm_profiler(tries: int = 5) -> None:
    """Short traces of one small kernel until one holds its device record:
    the first traces of a process can come back without them."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    x = torch.ones(1024, device="cuda")
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            (x + 1).sum()
            torch.cuda.synchronize()
        if any(e.device_type == DeviceType.CUDA for e in prof.events()):
            return


def _union(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def summarize(events) -> Dict[str, object]:
    """The summary of a profiler's events (times in seconds)."""
    from torch.autograd import DeviceType
    dev, spans = [], []
    win = None
    for e in events:
        a, b = e.time_range.start * 1e-6, e.time_range.end * 1e-6
        if e.device_type == DeviceType.CUDA:
            # a host span's range is mirrored on the device's timeline
            if not e.name.startswith("portbench."):
                dev.append((e.name, a, b))
        elif e.name == "portbench.slice":
            win = (a, b)
        elif e.name.startswith("portbench."):
            spans.append((e.name[len("portbench."):], a, b))
    if win is None:
        raise RuntimeError("the profiler recorded no slice span")
    kernels: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    copies: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    for name, a, b in dev:
        d = copies if name.startswith(COPY_PREFIXES) else kernels
        d[name][0] += 1
        d[name][1] += b - a
    busy = _union([(max(a, win[0]), min(b, win[1])) for _, a, b in dev
                   if b > win[0] and a < win[1]])
    edges = np.asarray([win[0]] + [t for iv in busy for t in iv] + [win[1]])
    a, b = edges[0::2], edges[1::2]
    keep = b > a
    a, b = a[keep], b[keep]
    mid = 0.5 * (a + b)
    who = np.full(len(mid), -1)
    size = np.full(len(mid), np.inf)
    for k, (_, s0, s1) in enumerate(spans):
        hit = (mid >= s0) & (mid <= s1) & (s1 - s0 < size)
        who[hit], size[hit] = k, s1 - s0
    idle: Dict[str, float] = defaultdict(float)
    for k, d in zip(who.tolist(), (b - a).tolist()):
        idle[spans[k][0] if k >= 0 else "harness"] += d
    return dict(window_s=win[1] - win[0],
                busy_s=sum(b - a for a, b in busy),
                kernels={k: list(v) for k, v in kernels.items()},
                copies={k: list(v) for k, v in copies.items()},
                idle=dict(idle))


def traced(fn: Callable):
    """``fn()`` under the profiler, inside the slice span; its result and
    the summary."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    _warm_profiler()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with span("slice"):
            out = fn()
        torch.cuda.synchronize()
    return out, summarize(prof.events())


def breakdown(summary: dict) -> dict:
    """The ten device operations that took most time and the ten host
    spans with the most idle device time, [name, seconds] each."""
    ops = [[k, v[1]] for k, v in summary["kernels"].items()]
    ops += [[k, v[1]] for k, v in summary["copies"].items()]
    ops.sort(key=lambda r: -r[1])
    idle = sorted(([k, v] for k, v in summary["idle"].items()),
                  key=lambda r: -r[1])
    return {"device_ops": [[k[:160], v] for k, v in ops[:10]],
            "idle_gaps": idle[:10]}
