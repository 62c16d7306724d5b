"""The port's counters and spans: the one store of what the program counts
and where its host time goes.

Counters (``count``) are always on: a plain add to one process-wide dict
under a lock, so that the enqueue thread and a stream's drain thread may
bump one name.  ``counters()`` is a snapshot; nothing resets them, so a
reader takes the difference of two snapshots.  A name with ``_s`` in it
is a sum of seconds.

Spans (``span``) are on exactly while a ``torch.profiler`` records: off,
``span`` reads one flag and returns one shared null context.  On, a span
adds its seconds, its self seconds (its seconds less its child spans' on
the same thread) and its seconds within each enclosing span's name on
that thread to per-name totals for every thread (``spans()``), and
enters a record function ``clfd.<name>``, which puts it on the
profiler's clock beside the kernels where the thread is the one that
started the profiler.  It is a plain function record (PyTorch's
``_RecordFunctionFast``), not a ``record_function``: the profiler copies
a ``record_function``'s range onto the card's timeline as a device event
of the same name, which a reader of the card's events would take for
work on the card.  So in a run traced over a slice, ``spans()`` holds
that slice's totals.

Names are ``<layer>.<step>``; README's "Tracing" section lists them.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Optional

import torch.autograd.profiler as _profiler
from torch._C._profiler import _RecordFunctionFast

__all__ = ["count", "counters", "span", "spans"]

_lock = threading.Lock()
_counts: Dict[str, float] = {}
# name -> [count, seconds, self seconds, {enclosing span name: seconds}]
_totals: Dict[str, list] = {}
_local = threading.local()
_OFF = contextlib.nullcontext()


def count(name: str, n=1) -> None:
    """Add ``n`` to counter ``name``."""
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


def counters() -> Dict[str, float]:
    """A snapshot of every counter; with the kernel library loaded, also
    its shared-memory set-ups (``kernels.smem_setups``)."""
    with _lock:
        out = dict(_counts)
    from . import kernels
    if kernels._lib is not None:
        out["kernels.smem_setups"] = kernels.smem_setups()
    return out


def spans() -> Dict[str, dict]:
    """Each span's totals since the process started, over every thread:
    ``count``, ``seconds``, ``self_seconds`` and ``within`` (its seconds
    inside each span name that enclosed it on its thread: a wait's
    seconds within ``stream.drain``, not the re-run's)."""
    with _lock:
        return {k: dict(count=v[0], seconds=v[1], self_seconds=v[2],
                        within=dict(v[3]))
                for k, v in _totals.items()}


class _Span:
    __slots__ = ("name", "rf", "t0", "child")

    def __init__(self, name: str, args):
        self.name = name
        self.rf = _RecordFunctionFast(f"clfd.{name}") if args is None \
            else _RecordFunctionFast(f"clfd.{name}", [], {"args": str(args)})

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.rf.__enter__()
        stack.append(self)
        self.child = 0.0
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        d = time.perf_counter() - self.t0
        stack = _local.stack
        stack.pop()
        if stack:
            stack[-1].child += d
        self.rf.__exit__(*exc)
        with _lock:
            t = _totals.get(self.name)
            if t is None:
                t = _totals[self.name] = [0, 0.0, 0.0, {}]
            t[0] += 1
            t[1] += d
            t[2] += d - self.child
            for outer in {s.name for s in stack}:
                t[3][outer] = t[3].get(outer, 0.0) + d
        return False


def span(name: str, args: Optional[object] = None):
    """A context around one step of the program, named ``<layer>.<step>``;
    ``args`` (e.g. a batch's index) goes to the profiler's record."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, args)
