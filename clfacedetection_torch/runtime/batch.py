"""Batched and streamed detection, on one device or sharded over a mesh.

Port of ``clfacedetection_tpu/runtime/batch.py``:
``BatchedPyramidDetector`` and ``MultiCascadeBatchedDetector``.  A batch
is one run of a program (``runtime/program.py``: on the card a CUDA graph
of the whole pipeline, on the CPU the eager function); the kernels take a
leading batch dimension.  A batch's handle carries the program it ran
on, and the program's key the batch size and cap(s) it was made for
(JAX's ``(program, cap)`` snapshot, ``batch.py:96-103``), so that a batch
is judged against the cap it ran with: a later batch may grow the cap
while this one is in flight.  Each detector keeps one program at a time.

With ``mesh`` (``runtime/mesh.py``) the batch is sharded over the mesh's
positions, as JAX's ``shard_map`` over the batch axis: each position
holds the detector at its device and a program for ``B / k`` frames at
the shared cap, replayed on the position's own stream, and a batch's
handle is a :class:`MeshHandle` over the positions' handles, read in
order into one ``[B, ...]`` packed array.  A shard that overflows grows
the cap of every position, as JAX's one program does.  No collective is
needed: frames shard in, packed readbacks come back per shard.

``detect_stream`` keeps ``depth`` batches in flight.  With ``threaded``
(the default) ONE worker thread drains them in order: it waits for a
batch's pinned readback and groups its candidates, while this thread
uploads and replays later batches.  The worker never launches work on the
card: a batch that overflowed its cap, or that accepted more windows than
the packed readback holds, comes back flagged, and the enqueue thread runs
it again through ``detect``, which captures the program at the grown cap.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import trace
from ..detect.detector import DetectionResult, grouped, served
from ..detect.pyramid import PyramidDetector, finish
from ..models.spec import CascadeSpec
from ..trace import span
from .mesh import Mesh
from .program import Handle, Program, indexed

__all__ = ["BatchedPyramidDetector", "MeshHandle",
           "MultiCascadeBatchedDetector"]


class MeshHandle:
    """One batch's run over a mesh: each position's ``Handle``, in
    position order (their frames are the batch's consecutive slices).
    ``key`` and ``info`` are the positions' program key and outputs."""

    def __init__(self, handles: List[Handle]):
        self.handles = handles
        self.key = handles[0].program.key
        self.info = handles[0].info


def _key(h) -> tuple:
    return h.key if isinstance(h, MeshHandle) else h.program.key


def _read(h, name: str) -> np.ndarray:
    """Output ``name`` of a run, [B, ...]: a mesh's positions in order."""
    hs = h.handles if isinstance(h, MeshHandle) else [h]
    return np.concatenate([x.program.read(x)[name] for x in hs])


def _home_knobs(mesh: Optional[Mesh], knobs: dict) -> dict:
    """The knobs of the home detector: on a mesh, on its first position's
    device."""
    if mesh is None:
        return knobs
    dev = knobs.get("device")
    if dev is not None and indexed(dev) != mesh.devices[0]:
        raise ValueError(f"device {dev} is not the mesh's first device "
                         f"{mesh.devices[0]}")
    return dict(knobs, device=mesh.devices[0])


def _check_mesh(mesh: Optional[Mesh], axis_name: str, batch: int) -> None:
    """The batch against the mesh (JAX ``batch.py:53-55``)."""
    if mesh is None:
        return
    if axis_name not in mesh.shape:
        raise ValueError(f"mesh has no axis {axis_name!r}: "
                         f"{dict(mesh.shape)}")
    if batch % mesh.size != 0:
        raise ValueError(f"batch {batch} not divisible by mesh "
                         f"size {mesh.size}")


def _shards(frames: torch.Tensor, k: int) -> List[torch.Tensor]:
    """The batch's k consecutive slices, one a mesh position."""
    B = frames.shape[0]
    if B % k:
        raise ValueError(f"batch {B} not divisible by mesh size {k}")
    b = B // k
    return [frames[i * b:(i + 1) * b] for i in range(k)]


def _empty_results(n: int) -> List[DetectionResult]:
    empty = np.zeros((0, 4), np.int32)
    return [DetectionResult(empty, np.zeros(0, np.int32), empty, False)
            for _ in range(n)]


def _runs_again(packed: np.ndarray, cap: int, n_visit: int) -> bool:
    """Whether a batch's packed readback [B, 2 + 2*acap] must run again:
    a frame overflowed a cap that can still grow, or accepted more windows
    than the packed array holds."""
    acap = (packed.shape[1] - 2) // 2
    return bool(((packed[:, 0] > cap).any() and cap < n_visit)
                or (packed[:, 1] > acap).any())


def _finish(res, min_neighbors: int) -> List[DetectionResult]:
    """``finish`` of each frame's (candidates, overflow), in one
    ``host.group`` span."""
    with span("host.group"):
        return grouped([finish(c, o, min_neighbors) for c, o in res])


def _stream(det, batches, min_neighbors: int, depth: int, threaded: bool):
    """The pipelined loop of both detectors.  ``det._enqueue(frames)`` runs
    a batch and returns its handle; ``det._drain(frames, handle,
    min_neighbors)`` gives the batch's results, or None when the batch
    must run again through ``det.detect`` on this thread."""
    def drain(j, frames, ran):
        with span("stream.drain", j):
            return det._drain(frames, ran, min_neighbors)

    def take(frames, res):
        if res is not None:
            return res
        trace.count("stream.reruns")
        with span("stream.rerun"):
            return det.detect(frames, min_neighbors)

    def enqueue(frames):
        with span("stream.enqueue"):
            return det._enqueue(frames)

    q = deque()
    if not threaded:
        def wait(j, frames, ran):
            with span("stream.wait"):
                return drain(j, frames, ran)
    else:
        ex = ThreadPoolExecutor(1)   # ONE worker: the drains stay ordered

        def wait(j, frames, fut):
            with span("stream.wait"):
                return fut.result()
    try:
        for j, frames in enumerate(batches):
            ran = enqueue(frames)
            q.append((j, frames, ex.submit(drain, j, frames, ran)
                      if threaded else ran))
            if len(q) >= depth:
                j0, frames, ran = q.popleft()
                yield take(frames, wait(j0, frames, ran))
        while q:
            j0, frames, ran = q.popleft()
            yield take(frames, wait(j0, frames, ran))
    finally:
        if threaded:
            ex.shutdown(wait=True)


class BatchedPyramidDetector:
    """Fixed-batch pyramid detector, on one device or sharded over
    ``mesh`` (a 1-D :class:`Mesh`; the batch must be a multiple of its
    size, and the detector's home device is its first position's);
    ``knobs`` go to :class:`PyramidDetector` (``device``, ``front_stages``,
    ``cap``, ``strategy``...).  A batch is one run of the detector's
    program for its size at the current cap (``PyramidDetector.program``),
    or of each position's program for its shard."""

    def __init__(self, spec: CascadeSpec, image_shape: Tuple[int, int],
                 batch: int, mesh: Optional[Mesh] = None,
                 axis_name: str = "data", **knobs):
        self.batch = int(batch)
        self.mesh = mesh
        self.axis_name = axis_name
        self.det = PyramidDetector(spec, image_shape,
                                   **_home_knobs(mesh, knobs))
        self._dets = [self.det]
        if self.det.n_levels == 0:
            return
        _check_mesh(mesh, axis_name, self.batch)
        if mesh is not None:
            # each position's detector: the home one's at its device, its
            # program on the position's stream
            self._dets = [self.det._on(d, i)
                          for i, d in enumerate(mesh.devices)]

    def put(self, frames) -> torch.Tensor:
        """Move a [B, H, W] uint8 batch to the detector's device."""
        return self.det.put(frames)

    def run_device(self, frames):
        """Run the program(s) on a batch at the current cap (no host
        synchronisation); returns its ``Handle``, or on a mesh its
        :class:`MeshHandle`."""
        det = self.det
        frames = det.frames(frames)
        if self.mesh is None:
            return det.program(frames.shape[0], det.cap).run(frames)
        cap = det.cap
        return MeshHandle([d.program(f.shape[0], cap).run(f) for d, f in
                           zip(self._dets, _shards(frames, len(self._dets)))])

    def detect(self, frames, min_neighbors: int = 3) -> List[DetectionResult]:
        """Full batched detection, with survivor-cap regrowth."""
        det = self.det
        if det.n_levels == 0:
            return _empty_results(len(frames))
        frames = det.frames(frames)
        if self.mesh is None:
            res = det.run_regrow(frames)
        else:
            while True:
                h = self.run_device(frames)
                cap = _key(h)[1]
                packed = _read(h, "packed")
                # the full arrays, for a frame that accepted more windows
                # than the packed array holds: the batch again, eagerly,
                # on the home device
                res = det.unpack(packed, cap,
                                 lambda: det._detect_device(det.put(frames),
                                                            cap))
                if not any(o for _, o in res) or det.cap >= det.n_visit:
                    break
                trace.count("cap.regrowths")
                det.cap = min(det.cap * 4, det.n_visit)
            served(len(frames), [packed], [det.walk_cap(cap)])
        return _finish(res, min_neighbors)

    def detect_stream(self, batches, min_neighbors: int = 3,
                      depth: int = 2, threaded: bool = True):
        """Pipelined detection over an iterable of [B, H, W] batches;
        yields one ``List[DetectionResult]`` per batch, in order.  The cap
        travels with its batch (see the module's docstring); a batch that
        overflowed it runs again through :meth:`detect`."""
        if self.det.n_levels == 0:
            for frames in batches:
                yield self.detect(frames, min_neighbors)
            return
        yield from _stream(self, batches, min_neighbors, depth, threaded)

    _enqueue = run_device

    def _drain(self, frames, h, min_neighbors):
        cap = _key(h)[1]
        packed = _read(h, "packed")
        if _runs_again(packed, cap, self.det.n_visit):
            return None
        res = self.det.unpack(packed, cap, None)
        served(len(packed), [packed], [self.det.walk_cap(cap)])
        return _finish(res, min_neighbors)


class MultiCascadeBatchedDetector:
    """Several cascades over one frame batch in ONE program.

    BASELINE config 5 (batched video with profileface + upperbody +
    fullbody): the reference would run ``cvHaarDetectObjects`` once per
    cascade per frame (main.cpp:72-97); here one CUDA graph holds all K
    cascades' pipelines over the shared [B, H, W] upload and stacks their
    packed outputs into one [B, K, Wmax] array, so that a batch costs ONE
    copy to the host.  Each cascade keeps its own :class:`PyramidDetector`
    (window sizes differ, so canvases, scan lattices and survivor caps are
    per cascade); when one overflows, only its cap grows, and the program
    is captured again.  A cascade with no pyramid level at this frame size
    gives empty results.  With ``mesh`` each position runs the fused
    program over its ``B / k`` frames, as in
    :class:`BatchedPyramidDetector`."""

    def __init__(self, specs: List[CascadeSpec],
                 image_shape: Tuple[int, int], batch: int,
                 mesh: Optional[Mesh] = None, axis_name: str = "data",
                 **knobs):
        if not specs:
            raise ValueError("need at least one cascade")
        self.batch = int(batch)
        self.mesh = mesh
        self.axis_name = axis_name
        _check_mesh(mesh, axis_name, self.batch)
        knobs = _home_knobs(mesh, knobs)
        # the subs hold each cascade's state (plan, cap); their own
        # programs are never made: the fused programs below are the only
        # ones
        self.subs = [PyramidDetector(spec, image_shape, **knobs)
                     for spec in specs]
        self.names = [getattr(s, "name", None) or f"cascade{i}"
                      for i, s in enumerate(specs)]
        self._active = [k for k, s in enumerate(self.subs)
                        if s.n_levels > 0]
        self._devices = mesh.devices if mesh is not None \
            else (self.subs[0].device,)
        # one fused program a position
        self._programs: List[Optional[Program]] = [None] * len(self._devices)

    @property
    def _program(self) -> Optional[Program]:
        return self._programs[0]

    def _caps(self) -> tuple:
        return tuple(self.subs[k].cap for k in self._active)

    def _fused(self, caps: tuple, position: int = 0):
        dets = [self.subs[k]._on(self._devices[position], position)
                for k in self._active]

        def step(frames):
            outs = [det._detect_device(frames, cap)
                    for det, cap in zip(dets, caps)]
            # every cascade of the port has a packed output: stack them
            # into one [B, K, Wmax] array (JAX batch.py:288-296); the
            # widths are static and travel with the program
            ws = tuple(int(o["packed"].shape[1]) for o in outs)
            w = max(ws)
            packed_all = torch.stack([
                torch.nn.functional.pad(o["packed"], (0, w - wk))
                for o, wk in zip(outs, ws)], dim=1)
            return {"outs": outs, "packed_all": packed_all, "widths": ws}
        return step

    def program(self, B: int, caps: tuple, position: int = 0) -> Program:
        """The fused program of mesh position ``position`` (0 without a
        mesh) for ``B`` frames at the cascades' ``caps``.  One is kept a
        position: another batch size or caps release the old one once its
        replays are done."""
        p = self._programs[position]
        if p is not None and p.key == (B, caps):
            return p
        self._programs[position] = None
        if p is not None:
            p.release()
        det = self.subs[self._active[0]]
        dev = self._devices[position]
        self._programs[position] = Program(
            self._fused(caps, position), (B, det.H, det.W), dev,
            graph=dev.type == "cuda",
            readback=("packed_all",), key=(B, caps), slot=position)
        return self._programs[position]

    def put(self, frames) -> torch.Tensor:
        return self.subs[0].put(frames)

    def run_device(self, frames):
        """Run the fused program on a batch at the current caps; returns
        its ``Handle``, or on a mesh a :class:`MeshHandle` over each
        position's run on its shard."""
        frames = self.subs[0].frames(frames)
        caps = self._caps()
        if self.mesh is None:
            return self.program(frames.shape[0], caps).run(frames)
        return MeshHandle([
            self.program(f.shape[0], caps, i).run(f) for i, f in
            enumerate(_shards(frames, len(self._devices)))])

    @staticmethod
    def _read(h) -> List[np.ndarray]:
        """Each active cascade's packed readback from the ONE stacked
        copy (a position), cut to its width from the program's static
        shapes, never from detector state (a regrowth may have replaced
        the program since this batch was enqueued)."""
        p_all = _read(h, "packed_all")
        return [p_all[:, j, :w] for j, w in enumerate(h.info["widths"])]

    def detect(self, frames, min_neighbors: int = 3,
               ) -> List[List[DetectionResult]]:
        """Detect with every cascade; returns results[k][b] indexed by
        cascade then frame.  Only the cascades that overflowed grow their
        cap; the fused program is then captured again and the batch run
        again."""
        n = len(frames)
        if not self._active:
            return [_empty_results(n) for _ in self.subs]
        frames = self.subs[0].frames(frames)
        while True:
            h = self.run_device(frames)
            packed = self._read(h)
            grew = False
            for j, k in enumerate(self._active):
                det = self.subs[k]
                if (packed[j][:, 0] > det.cap).any() \
                        and det.cap < det.n_visit:
                    trace.count("cap.regrowths")
                    det.cap = min(det.cap * 4, det.n_visit)
                    grew = True
            if not grew:
                break
        return self._finish_all(frames, packed, min_neighbors, _key(h)[1])

    def _finish_all(self, frames, packed, min_neighbors, caps):
        results = [_empty_results(len(frames)) for _ in self.subs]
        for j, k in enumerate(self._active):
            det, cap = self.subs[k], caps[j]
            # the full arrays, for a frame that accepted more windows than
            # the packed array holds: this cascade's batch again, eagerly
            def full(d=det, c=cap):
                return d._detect_device(d.put(frames), c)

            results[k] = _finish(det.unpack(packed[j], cap, full),
                                 min_neighbors)
        served(len(frames), packed, [self.subs[k].walk_cap(caps[j])
                                     for j, k in enumerate(self._active)])
        return results

    def detect_stream(self, batches, min_neighbors: int = 3,
                      depth: int = 2, threaded: bool = True):
        """Pipelined multi-cascade detection over [B, H, W] batches; yields
        one ``results[k][b]`` per batch, in order.  The caps in effect at
        enqueue travel with the batch, as in
        :meth:`BatchedPyramidDetector.detect_stream`."""
        if not self._active:
            for frames in batches:
                yield [_empty_results(len(frames)) for _ in self.subs]
            return
        yield from _stream(self, batches, min_neighbors, depth, threaded)

    _enqueue = run_device

    def _drain(self, frames, h, min_neighbors):
        caps = _key(h)[1]
        packed = self._read(h)
        for j, k in enumerate(self._active):
            if _runs_again(packed[j], caps[j], self.subs[k].n_visit):
                return None
        return self._finish_all(frames, packed, min_neighbors, caps)
