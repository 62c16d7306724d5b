"""Batched and streamed detection on one device.

Port of ``BatchedPyramidDetector`` (``clfacedetection_tpu/runtime/
batch.py``) without a mesh: the kernels take a leading batch dimension,
so a batch is one pass of the pipeline and batch 1 is the single-frame
path.  ``detect_stream`` keeps ``depth`` batches in flight and drains
them, in order, on ONE worker thread, so the readback and the host-side
grouping overlap the device work of later batches.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..detect.detector import DetectionResult
from ..detect.pyramid import PyramidDetector, finish
from ..models.spec import CascadeSpec

__all__ = ["BatchedPyramidDetector"]


class BatchedPyramidDetector:
    """Fixed-batch pyramid detector on one device; ``knobs`` go to
    :class:`PyramidDetector` (``device``, ``front_stages``, ``cap``,
    ``strategy``...).  A batch is one pass of the pipeline whichever tail
    the cascade takes."""

    def __init__(self, spec: CascadeSpec, image_shape: Tuple[int, int],
                 batch: int, **knobs):
        self.batch = int(batch)
        self.det = PyramidDetector(spec, image_shape, **knobs)

    def put(self, frames) -> torch.Tensor:
        """Move a [B, H, W] uint8 batch to the detector's device."""
        return self.det.put(frames)

    def run_device(self, frames: torch.Tensor, cap: Optional[int] = None):
        """The device pipeline for a batch already on the device (no host
        synchronisation; for timing)."""
        return self.det._detect_device(frames, self.det.cap if cap is None
                                       else cap)

    def detect(self, frames, min_neighbors: int = 3) -> List[DetectionResult]:
        """Full batched detection, with survivor-cap regrowth."""
        det = self.det
        if det.n_levels == 0:
            empty = np.zeros((0, 4), np.int32)
            return [DetectionResult(empty, np.zeros(0, np.int32), empty,
                                    False) for _ in range(len(frames))]
        dev_frames = self.put(frames)
        res = det.readback(self.run_device(dev_frames, det.cap), det.cap)
        while any(o for _, o in res) and det.cap < det.n_visit:
            det.cap = min(det.cap * 4, det.n_visit)
            res = det.readback(self.run_device(dev_frames, det.cap), det.cap)
        return [finish(c, o, min_neighbors) for c, o in res]

    def detect_stream(self, batches, min_neighbors: int = 3,
                      depth: int = 2):
        """Pipelined detection over an iterable of [B, H, W] batches;
        yields one ``List[DetectionResult]`` per batch, in order.

        The cap is read ONCE per batch at enqueue and travels with it: a
        later batch may overflow and grow ``det.cap`` while this one is in
        flight, and this batch's result must be judged against the cap it
        ran with, or a truncated result would pass as complete.  A batch
        that overflowed is re-run through :meth:`detect`."""
        if self.det.n_levels == 0:
            for frames in batches:
                yield self.detect(frames, min_neighbors)
            return
        q = deque()
        ex = ThreadPoolExecutor(1)   # ONE worker: drains stay ordered and
        try:                         # cap regrowth is serialised
            for frames in batches:
                cap = self.det.cap
                dev = self.run_device(self.put(frames), cap)
                q.append(ex.submit(self._drain, frames, dev, cap,
                                   min_neighbors))
                if len(q) >= depth:
                    yield q.popleft().result()
            while q:
                yield q.popleft().result()
        finally:
            ex.shutdown(wait=True)

    def _drain(self, frames, dev, cap, min_neighbors):
        res = self.det.readback(dev, cap)
        if any(o for _, o in res) and cap < self.det.n_visit:
            return self.detect(frames, min_neighbors)
        return [finish(c, o, min_neighbors) for c, o in res]
