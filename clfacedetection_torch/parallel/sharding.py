"""Explicit sharded detection over a mesh's positions.

Port of ``clfacedetection_tpu/parallel/sharding.py``, the explicit-API
twin of the batch mesh (``runtime/batch.py``): each position runs the
detector's three phases (front, compaction, tail) on its shard of the
frame batch, on its own device and stream, and the one collective, JAX's
``all_gather`` of the fixed-size outputs, is a copy of each shard's
outputs onto the home device (position 0), ordered by CUDA events
(``runtime.mesh.Fork``).  The gathered outputs keep the port's packed
layout (``packed`` [B, 2 + 2*acap], with ``surv_idx`` and ``ok`` for a
frame that accepted more windows than ``packed`` holds), which
``gather_detections`` turns into grouped boxes through the detector's
``unpack``.  No regrowth: an overflowing frame is flagged, as in JAX.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from ..detect.detector import DetectionResult
from ..detect.pyramid import finish
from ..runtime.mesh import Fork, Mesh

__all__ = ["detect_sharded", "gather_detections"]


def detect_sharded(det, frames, mesh: Mesh,
                   axis_name: str = "data") -> Dict[str, torch.Tensor]:
    """Run a ``PyramidDetector`` over a [B, H, W] uint8 frame batch
    sharded on ``mesh`` (B divisible by its size) at the detector's cap.
    Returns the gathered outputs, [B, ...] each, on the mesh's first
    device."""
    if axis_name not in mesh.shape:
        raise ValueError(f"mesh has no axis {axis_name!r}: "
                         f"{dict(mesh.shape)}")
    frames = det.frames(frames)
    k = mesh.size
    B = frames.shape[0]
    if B % k:
        raise ValueError(f"batch {B} not divisible by mesh size {k}")
    b, cap = B // k, det.cap
    fork = Fork(mesh.devices)
    parts: List[Dict[str, torch.Tensor]] = []
    for i, d in enumerate(mesh.devices):
        with fork.at(i):
            pdet = det._on(d, i)
            f = pdet._front_device(pdet.put(frames[i * b:(i + 1) * b]))
            surv_idx, n_surv = pdet._compact_device(f["front"], cap)
            ii = f["planes"]
            out = pdet._tail_device(ii.sum, ii.tilted, f["vnf"], surv_idx,
                                    n_surv, cap)
            parts.append({n: fork.home(t, i) for n, t in out.items()})
    fork.join()
    return {n: torch.cat([p[n] for p in parts]) for n in parts[0]}


def gather_detections(out: Dict[str, torch.Tensor], det,
                      min_neighbors: int = 3) -> List[DetectionResult]:
    """Grouped boxes per frame from ``detect_sharded``'s gathered outputs
    (the same post-processing as ``PyramidDetector.detect``): one copy of
    the packed array to the host."""
    packed = out["packed"].cpu().numpy()
    cap = out["surv_idx"].shape[1]
    return [finish(c, o, min_neighbors)
            for c, o in det.unpack(packed, cap, lambda: out)]
