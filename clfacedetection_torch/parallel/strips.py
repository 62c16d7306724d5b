"""Intra-frame row-strip sharding: one frame's scan rows across a mesh.

Port of ``clfacedetection_tpu/parallel/strips.py``.  The reference's CPU
baseline parallelises a single frame with TBB strips (``cv::parallel_for``
over window-row ranges of each scale, tempcv.cpp:1305-1311,1323-1327);
here the packed canvas's scan rows are split into ``k`` strips, one a mesh
position.  Each position runs the dense front (``haar_front``) on its
strip's rows of the zero-extended integral planes and compacts its
survivors into a ``cap / k`` slice of the tail's slots; the slices and the
strips' vnf rows come to the home device (position 0), where the
detector's own tail (``PyramidDetector._tail_device``) runs once.

Strips are full-width row bands taken in order and the compaction keeps
raster order within a strip, so the survivors stay in the canvas's raster
order and the candidates equal the single-device detector's box for box.
The strip height follows JAX's rule (``strips.py:85-86`` without a Pallas
front), so that the per-strip budgets, and the regrown cap, equal JAX's
on the same input; the port's front kernel takes any grid, so the rows
need no tile rounding.  On a mesh whose positions are one card the strip
program is one ``Program`` (a CUDA graph with the strips forked onto the
positions' streams); across cards it runs eagerly.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..detect.pyramid import PyramidDetector, finish
from ..ops.compact_kernel import compact, compact_plain
from ..ops.haar_front import front_plain, haar_front
from ..runtime.mesh import Fork, Mesh
from ..runtime.program import Program

__all__ = ["StripShardedPyramidDetector"]

# the strip height's quantum: JAX's when its front is not Pallas
# (strips.py:85-86)
_ROW_QUANTUM = 8


class StripShardedPyramidDetector:
    """Shard one ``PyramidDetector``'s front over canvas row strips.

    ``det.cap`` must be divisible by the mesh size: each strip compacts
    into a ``cap / k`` slice of the tail's slots, so the concatenated
    slices feed the detector's tail unchanged.  A strip whose survivors
    overflow its slice grows the cap 4x (rounded to a multiple of ``k``)
    and the frame runs again, as JAX regrows (``strips.py:188-196``); a
    strip can overflow before the whole frame would."""

    def __init__(self, det: PyramidDetector, mesh: Mesh,
                 axis_name: str = "strips"):
        if det.n_levels == 0:
            raise ValueError("detector has no pyramid levels")
        self.det = det
        self.mesh = mesh
        self.axis = axis_name
        if axis_name not in mesh.shape:
            raise ValueError(f"mesh has no axis {axis_name!r}: "
                             f"{dict(mesh.shape)}")
        self.k = int(mesh.shape[axis_name])
        if det.cap % self.k:
            raise ValueError(
                f"det.cap={det.cap} not divisible by mesh size {self.k}")
        self.Hv, self.Wv = det.hv, det.wv
        q = _ROW_QUANTUM
        self.Hs = -(-(-(-self.Hv // self.k)) // q) * q
        visit = det._visit.cpu().numpy()
        vs = np.zeros((self.k, self.Hs, self.Wv), bool)
        for s in range(self.k):
            a = s * self.Hs
            if a < self.Hv:
                b = min(self.Hv, a + self.Hs)
                vs[s, :b - a] = visit[a:b]
        # each strip's visit mask on its position's device
        self._visit_strips = [torch.from_numpy(vs[s]).to(d)
                              for s, d in enumerate(mesh.devices)]
        home = mesh.devices[0]
        self.graphed = (home.type == "cuda" and det.dtype == torch.float32
                        and all(d == home for d in mesh.devices))
        self._program: Optional[Program] = None

    # ------------------------------------------------------------------
    def _strips_device(self, frames: torch.Tensor, cap: int
                       ) -> Dict[str, torch.Tensor]:
        """One frame [1, H, W] uint8 through the strips: prep on the home
        device, each strip's front and compaction on its position, the
        gather, the detector's tail on the home device.  Adds ``n_strip``
        int32 [k], each strip's true survivor count."""
        det, k, Hs, Hv, Wv = self.det, self.k, self.Hs, self.Hv, self.Wv
        plain = det._plain(False)
        front_fn = front_plain if plain else haar_front
        compact_fn = compact_plain if plain else compact
        cap_s = cap // k
        n_flat, n_strip = Hv * Wv, Hs * Wv
        fork = Fork(self.mesh.devices)
        ii = det._prep_planes(frames.to(fork.home_device))
        planes = [p for p in ii if p is not None]
        extra = k * Hs - Hv          # strip overhang past the canvas
        if extra > 0:
            planes = [torch.nn.functional.pad(p, (0, 0, 0, extra))
                      for p in planes]
        rows = Hs + (planes[0].shape[1] - k * Hs)   # a strip and the pad
        idx, counts, vnfs = [], [], []
        for s, d in enumerate(self.mesh.devices):
            with fork.at(s):
                y0 = s * Hs
                # a row slice of a [1, R, Wp] plane is contiguous
                sp = [p[:, y0:y0 + rows].to(d) for p in planes]
                tilted = sp[3] if len(sp) > 3 else None
                front, vnf = front_fn(sp[0], sp[1], sp[2],
                                      self._visit_strips[s], det.table,
                                      det.front_k, det.dtype, tilted)
                sidx, n_s = compact_fn(front.reshape(1, -1), cap_s)
                # strip-local flat index -> canvas index (a strip is a
                # full-width row band: + y0 * Wv); the strip's padding
                # index (Hs * Wv) -> the canvas's (Hv * Wv)
                gidx = torch.where(sidx < n_strip, sidx + Wv * y0, n_flat)
                idx.append(fork.home(gidx, s))
                counts.append(fork.home(n_s, s))
                vnfs.append(fork.home(vnf, s))
        fork.join()
        surv_idx = torch.cat(idx, dim=1)
        vnf = torch.cat(vnfs, dim=1)[:, :Hv].contiguous()
        n_s = torch.cat(counts)
        out = det._tail_device(ii.sum, ii.tilted, vnf, surv_idx,
                               n_s.sum(dtype=torch.int32).reshape(1), cap)
        out["n_strip"] = n_s
        return out

    def program(self, cap: int):
        """The strip pipeline at ``cap`` as a ``Program`` on the home
        device (one kept, keyed by the cap): a CUDA graph when every
        position is one card, else the eager function."""
        p = self._program
        if p is not None and p.key == cap:
            return p
        self._program = None
        if p is not None:
            p.release()
        det = self.det
        self._program = Program(
            functools.partial(self._strips_device, cap=cap),
            (1, det.H, det.W), self.mesh.devices[0], graph=self.graphed,
            readback=("packed", "n_strip"), key=cap)
        return self._program

    # ------------------------------------------------------------------
    def candidates(self, gray) -> Tuple[np.ndarray, bool]:
        """Raw candidates (x, y, w, h), box-for-box equal to the wrapped
        detector's single-device ``candidates`` (same raster order), and
        whether a strip overflowed its slice."""
        det, k = self.det, self.k
        frames = det.frames(gray)
        if frames.shape[0] != 1:
            raise ValueError("candidates takes one frame")

        def run():
            prog = self.program(det.cap)
            return prog.read(prog.run(frames))

        out = run()
        while bool(np.any(out["n_strip"] > det.cap // k)) \
                and det.cap < k * det.n_visit:
            det.cap = -(-min(det.cap * 4, k * det.n_visit) // k) * k
            out = run()
        cap = det.cap
        overflow = bool(np.any(out["n_strip"] > cap // k))
        # a frame that accepted more windows than the packed array holds:
        # the strips again, eagerly, for the full arrays
        (cand, _), = det.unpack(out["packed"], cap,
                                lambda: self._strips_device(frames, cap))
        return cand, overflow

    def detect(self, gray, min_neighbors: int = 3):
        """Grouped detection (the same post-processing as the
        detector)."""
        cand, overflow = self.candidates(gray)
        return finish(cand, overflow, min_neighbors)
