"""Captured programs: the port's counterpart of ``jax.jit``.

The JAX package compiles each detection path into one program
(``PyramidDetector._jit_pipeline``, ``BatchedPyramidDetector._build_step``,
scale-cascade mode's ``_jit_scales``) and recompiles when a survivor cap
grows.  Here a program is the eager function of one uint8 input, run as it
is on the CPU and, on the card, captured once as a CUDA graph and
replayed:

* the input is copied into a static buffer (through two pinned staging
  buffers, each reused only once its copy to the card is done);
* the graph is replayed;
* the outputs the host reads (``readback``, e.g. ``packed``) are copied on
  the same stream into a pinned host slot, and the slot's event recorded.

``run`` returns a :class:`Handle` at once; ``read`` waits on the handle's
event and returns numpy.  A later replay overwrites the static outputs but
not a slot that is still unread: a slot is reused only once its handle was
read or dropped (two slots are made up front, more if a caller holds
more handles).

Capture: one eager run on the program stream first, at the same shapes,
which makes every lazy cache outside the graph's pool (the kernel library,
the cascade tables uploaded at first use, the kernels' buffers and the
plain versions' tables alike, the compaction's scratch, which is kept per
stream), then the capture on that stream, with Python's cyclic garbage
collector off (a dead detector's graph destroyed by a collection during
a capture would make the capture fail).  A capture that fails
raises; nothing falls back to the eager path.  The capture is
``thread_local``: a stream's drain thread may wait on events while the
enqueue thread captures.

The kernel wrappers count the launches that run on the card: the
warm-up's, not the capture's (which runs nothing).  A replay launches
the graph's kernels without a wrapper call, so the programs count their
replays (the counter ``program.replays`` of ``trace``); what a replay
ran on the card is for a profiler to read.  The programs also count
their captures, the seconds of each capture's warm-up, capture and
instantiation, the waits for a staging buffer and the slots made beyond
the first two; and their spans time the load, the replay, the read and
its wait, and the capture.
"""

from __future__ import annotations

import gc
import time
import weakref
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from .. import kernels, trace
from ..trace import span

__all__ = ["Handle", "Program", "indexed", "program_stream"]

# pinned staging buffers, and pinned readback slots made up front
_DEPTH = 2

_STREAMS: Dict[tuple, "torch.cuda.Stream"] = {}


def indexed(device) -> torch.device:
    """``device`` with its index (``cuda`` is the current card)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def program_stream(device, slot: int = 0) -> "torch.cuda.Stream":
    """The stream every program of a device captures and replays on:
    replays of different programs stay ordered, and the compaction's
    scratch, kept per stream, is made once.  ``slot`` is a mesh position
    (``runtime/mesh.py``): k positions on one card replay on k streams,
    so that they overlap as k cards would; a one-device caller keeps slot
    0."""
    device = indexed(device)
    s = _STREAMS.get((device, slot))
    if s is None:
        # high priority: a pool of its own, so that no stream a caller
        # takes from the default pool is this one
        with torch.cuda.device(device):
            s = torch.cuda.Stream(device, priority=-1)
        _STREAMS[(device, slot)] = s
    return s


def _info(out: dict) -> dict:
    """The function's non-tensor outputs (e.g. static widths)."""
    return {k: v for k, v in out.items()
            if not isinstance(v, (torch.Tensor, list, dict))}


class Handle:
    """One run of a program: what ``Program.read`` needs, the input it ran
    on (for a re-run) and ``info``, the function's non-tensor outputs."""

    def __init__(self, program: "Program", frames, info, slot=None,
                 outputs=None):
        self.program = program
        self.frames = frames
        self.info = info
        self.slot = slot          # the pinned slot (graph)
        self.outputs = outputs    # the run's outputs (eager)
        self.host: Optional[Dict[str, np.ndarray]] = None


class _Slot:
    def __init__(self, static: Dict[str, torch.Tensor]):
        self.host = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                     for k, v in static.items()}
        self.event = torch.cuda.Event()
        self.owner = None         # weakref to the handle that holds it

    def free(self) -> bool:
        return self.owner is None or self.owner() is None


class Program:
    """``fn`` (one uint8 tensor of ``shape`` -> a dict of outputs) as a
    program on ``device``: a CUDA graph when ``graph`` (which needs a CUDA
    device), else the eager function.  ``readback`` names the outputs the
    host reads; ``key`` is the caller's (e.g. the batch size and cap);
    ``slot`` the mesh position whose stream it runs on."""

    def __init__(self, fn: Callable[[torch.Tensor], dict],
                 shape: Sequence[int], device, graph: bool,
                 readback: Sequence[str] = ("packed",), key=None,
                 slot: int = 0):
        self.fn = fn
        self.shape = tuple(int(s) for s in shape)
        self.device = torch.device(device)
        self.names = tuple(readback)
        self.key = key
        self.graphed = bool(graph)
        self.graph = None
        self.outputs = None
        self.info: dict = {}
        self.capture_s = self.instantiate_s = None
        if not self.graphed:
            return
        if self.device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, not "
                             f"{self.device}")
        self.stream = program_stream(self.device, slot)
        self.input = torch.zeros(self.shape, dtype=torch.uint8,
                                 device=self.device)
        self._stage = [torch.empty(self.shape, dtype=torch.uint8,
                                   pin_memory=True) for _ in range(_DEPTH)]
        self._stage_ev = [None] * _DEPTH
        self._next = 0
        with span("program.capture"):
            self._capture()
        self._slots = [_Slot(self.static) for _ in range(_DEPTH)]

    # --------------------------------------------------------- capture
    def _capture(self) -> None:
        s = self.stream
        kernels.lib()   # built or loaded before the warm-up's clock starts
        tw = time.perf_counter()
        s.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(s):
            self.fn(self.input)                 # warm-up: the lazy caches
        s.synchronize()
        warmup_s = time.perf_counter() - tw
        # keep_graph: the capture and the instantiation timed apart
        g = torch.cuda.CUDAGraph(keep_graph=True)
        # no automatic collection during the capture: a dead cycle (a
        # detector and its program) collected then would destroy its graph,
        # which a capture does not permit, and the capture would fail
        collecting = gc.isenabled()
        gc.disable()
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(g, stream=s,
                                  capture_error_mode="thread_local"):
                out = self.fn(self.input)
        finally:
            if collecting:
                gc.enable()
        t1 = time.perf_counter()
        g.instantiate()
        self.instantiate_s = time.perf_counter() - t1
        self.capture_s = t1 - t0
        trace.count("program.captures")
        trace.count("program.warmup_s", warmup_s)
        trace.count("program.capture_s", self.capture_s)
        trace.count("program.instantiate_s", self.instantiate_s)
        self.graph = g
        self.outputs = out
        self.info = _info(out)
        self.static = {}
        for k in self.names:
            t = out[k]
            if not isinstance(t, torch.Tensor) or not t.is_contiguous():
                raise ValueError(f"readback output {k!r} must be a "
                                 f"contiguous tensor")
            self.static[k] = t

    # ------------------------------------------------------------- run
    def run(self, frames) -> Handle:
        """Run on ``frames`` (a uint8 tensor of the program's shape, on
        the host or the device, or a numpy array); returns at once."""
        if not self.graphed:
            x = frames if isinstance(frames, torch.Tensor) \
                else torch.as_tensor(np.asarray(frames))
            out = self.fn(x.to(self.device))
            return Handle(self, frames, _info(out), outputs=out)
        if self.graph is None:
            raise RuntimeError("the program was released")
        s = self.stream
        with torch.cuda.stream(s):
            with span("program.load"):
                self._load(frames)
            with span("program.replay"):
                self.graph.replay()
                slot = next((sl for sl in self._slots if sl.free()), None)
                if slot is None:
                    slot = _Slot(self.static)
                    self._slots.append(slot)
                    trace.count("program.slots_grown")
                for k, t in self.static.items():
                    slot.host[k].copy_(t, non_blocking=True)
                slot.event.record(s)
        trace.count("program.replays")
        h = Handle(self, frames, self.info, slot=slot)
        slot.owner = weakref.ref(h)
        return h

    def _load(self, frames) -> None:
        """Copy ``frames`` into the static input on the program stream."""
        t = frames if isinstance(frames, torch.Tensor) \
            else torch.as_tensor(np.asarray(frames))
        if tuple(t.shape) != self.shape or t.dtype != torch.uint8:
            raise ValueError(f"the program takes uint8 {self.shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device.type == "cuda":
            self.stream.wait_stream(torch.cuda.current_stream(t.device))
            self.input.copy_(t, non_blocking=True)
            t.record_stream(self.stream)
            return
        i = self._next
        self._next = (i + 1) % len(self._stage)
        ev = self._stage_ev[i]
        if ev is None:
            self._stage_ev[i] = torch.cuda.Event()
        elif not ev.query():                    # its last copy is not done
            trace.count("program.stage_waits")
            with span("program.stage_wait"):
                ev.synchronize()
        self._stage[i].copy_(t)
        self.input.copy_(self._stage[i], non_blocking=True)
        self._stage_ev[i].record(self.stream)

    def read(self, handle: Handle) -> Dict[str, np.ndarray]:
        """The ``readback`` outputs of a run, as numpy (waits for them)."""
        if handle.host is not None:
            return handle.host
        with span("program.read"):
            if handle.slot is None:
                host = {k: handle.outputs[k].cpu().numpy()
                        for k in self.names}
            else:
                slot = handle.slot
                if slot.owner is None or slot.owner() is not handle:
                    raise RuntimeError("the handle's slot was reused")
                with span("program.wait"):
                    slot.event.synchronize()
                host = {k: t.numpy().copy() for k, t in slot.host.items()}
                slot.owner = None
                handle.slot = None
        handle.host = host
        return host

    def release(self) -> None:
        """Let go of the graph and its memory pool once every replay on
        the stream is done; unread handles keep their slots."""
        if self.graph is not None:
            self.stream.synchronize()
            self.graph.reset()
            self.graph = None
            self.outputs = self.static = self.input = None
