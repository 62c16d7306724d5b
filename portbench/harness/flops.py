"""The yardstick's arithmetic: the operations and bytes a frame needs,
and the card's peaks.

A frozen copy of the program's op model (``utils/flops.py``): a Haar rect
costs ``RECT_OPS`` operations (two slices, a subtraction, a multiply and
an add), a node's decision ``NODE_OPS`` (compare, select, add to the stage
sum), a window's variance factor ``VAR_OPS`` (three rect sums and eight
operations to combine them); the pyramid's prep 14 operations a pixel
(the resize about 8, the integrals about 6), scale-cascade mode's 6 (the
integrals alone).  The floor is what a scalar evaluator with early exit
does on the frame (tempcv.cpp:919-948): the prep, the variance factor of
every visited window, and each stage's operations for every window that
enters it.  The entering counts are the reference's own, on the same
frames.  Bytes are the integral planes read once and the candidates
written once (16 bytes each).

Peaks: NVIDIA's H100 SXM5 80GB data sheet at 700 W, float32 outside the
tensor cores with an FMA counted as two operations, and HBM3.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

__all__ = ["RECT_OPS", "NODE_OPS", "VAR_OPS", "PEAK_F32_OPS", "PEAK_BYTES",
           "stage_ops", "floor"]

RECT_OPS = 5
NODE_OPS = 3
VAR_OPS = 3 * RECT_OPS + 8
PREP_OPS = {"scale_image": 14.0, "scale_cascade": 6.0}
PEAK_F32_OPS = 66.9e12
PEAK_BYTES = 3.35e12


def stage_ops(c) -> np.ndarray:
    """Operations of each stage of a ``reference.cascade.Cascade`` at one
    window."""
    return np.array([RECT_OPS * c.stage_rects(s) + NODE_OPS * c.stage_nodes(s)
                     for s in range(c.n_stages)], np.float64)


def floor(cascades: List, dets: List, mode: str) -> Dict[str, float]:
    """One frame's floor over its cascades (their ``Detection``s):
    ``ops`` (prep included), ``cascade_ops`` (variance factors and
    stages) and ``bytes``."""
    ops = cascade = nbytes = 0.0
    for c, d in zip(cascades, dets):
        ent = np.asarray(d.entering[:c.n_stages], np.float64)
        work = VAR_OPS * float(d.entering[0]) + float((ent * stage_ops(c))
                                                      .sum())
        cascade += work
        ops += work + PREP_OPS[mode] * d.level_pixels
        nbytes += d.plane_bytes + 16.0 * len(d.candidates)
    return dict(ops=ops, cascade_ops=cascade, bytes=nbytes)
