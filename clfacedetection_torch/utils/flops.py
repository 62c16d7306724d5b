"""Arithmetic accounting for the scale-image pipeline (roofline shares).

Port of ``clfacedetection_tpu/utils/flops.py``: count the arithmetic the
algorithm needs (useful operations) and the arithmetic the port's
schedule executes, to divide by a measured device time and the card's
peak.  The op model is the JAX package's, so the useful counts are
algorithmic and equal to its counts for the same cascade, frame shape
and knobs:

- one Haar rect value costs ``RECT_OPS`` operations (2 slices + sub + mul
  + add);
- one node decision on top of its rects costs ``NODE_OPS`` (compare +
  select + stage-sum add);
- the variance factor costs 3 rect sums + 8 combine operations per
  position (``VAR_OPS``: the window's sum and the two squared-sum planes).

"Useful" counts the visited lattice positions (``det.n_visit``) and the
per-window work of a scalar early-exit evaluator.  "Executed" counts what
the port's kernels run:

- ``grid_positions``: the canvas ``Hv x Wv`` rounded up to the front
  kernel's block tile, ``BLOCK_Y x BLOCK_X`` = 64 x 128 positions
  (``csrc/haar_front.cu`` launches ``ceil(Wv / 128) x ceil(Hv / 64)``
  blocks, and each of a block's 8 warps runs the dense variance pass over
  its 32 x 32 part, positions outside the canvas included);
  ``executed_vpu_ops = prep + front_ops_per_position * grid_positions``,
  an upper bound, since the kernel walks a stage over live positions
  only;
- ``executed_mxu_flops_ub``: the ``strategy="direct"`` tail's stencil
  product (``ops/stencil.py``), ``2 * M * K * N`` a frame with ``M =
  det.cap`` slots, ``K = (h0 + 1) * (w0 + 1)`` patch entries (times 2 for
  a cascade with tilted nodes, whose tilted patches take a second
  product) and ``N = n_clf * T`` node columns; 0 for the kernel tails
  (tail2, the v1 tail), which run no matrix product.

Peaks are the NVIDIA H100 SXM5 80GB data sheet's dense figures at 700 W.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..ops.haar_front import BLOCK_X, BLOCK_Y

__all__ = ["pipeline_flops", "scalar_floor_flops", "PEAK_FLOPS_BF16",
           "PEAK_FLOPS_F32_HIGHEST", "PEAK_BYTES", "RECT_OPS", "NODE_OPS",
           "VAR_OPS"]

# bf16 on the tensor cores, dense
PEAK_FLOPS_BF16 = 989.4e12
# float32 on the CUDA cores, an FMA counted as two (the name is the JAX
# package's, where it was the matrix unit's full-precision float32 rate;
# here it is the rate of the kernels' own float32 arithmetic)
PEAK_FLOPS_F32_HIGHEST = 66.9e12
# HBM3 bytes a second
PEAK_BYTES = 3.35e12

RECT_OPS = 5     # 2 slices + sub + mul + add
NODE_OPS = 3     # cmp + select + stage-sum add
VAR_OPS = 3 * RECT_OPS + 8


def _node_rects(det) -> np.ndarray:
    """Nonzero-weight rect count per (classifier, tree node), zeros for
    padding: the table keeps only the rects of nonzero weight of a
    classifier's valid nodes (``ops/cascade_table.py``)."""
    return det.table.n_rects.astype(np.int64)


def _clf_ops(rects: np.ndarray) -> np.ndarray:
    """Operations of each classifier: its nodes' rects and decisions."""
    return (RECT_OPS * rects + NODE_OPS * (rects > 0)).sum(axis=1)


def pipeline_flops(det, n_surv: int) -> Dict[str, float]:
    """Per-frame operation counts for a built ``PyramidDetector``.

    ``n_surv`` is the measured front-survivor count of the frame (the
    tail's useful work depends on the data).  Returns a dict of scalars;
    every count is operations a frame (a multiply-accumulate of the
    direct strategy's product is two)."""
    spec = det.compiled.spec
    rects = _node_rects(det)                # [n_clf, T]
    clf_ops = _clf_ops(rects)               # [n_clf]

    def stage_clfs(s0, s1):
        out = []
        for s in range(s0, s1):
            c0 = int(spec.stage_clf_ofs[s])
            out.extend(range(c0, c0 + int(spec.stage_clf_cnt[s])))
        return out

    front_clfs = stage_clfs(0, det.front_k)
    tail_clfs = stage_clfs(det.front_k, det.n_stages)
    front_ops_pp = float(clf_ops[front_clfs].sum()) + VAR_OPS
    tail_nodes = int((rects[tail_clfs] > 0).sum())
    tail_useful_pp = float(clf_ops[tail_clfs].sum())

    hv, wv = det.plan.canvas_h + 1, det.plan.canvas_w + 1
    grid_pos = (-(-hv // BLOCK_Y) * BLOCK_Y) * (-(-wv // BLOCK_X) * BLOCK_X)
    canvas_px = det.plan.canvas_h * det.plan.canvas_w

    # prep: resize (~8 ops/px fixed-point bilinear) + integral cumsums
    # (~6 ops/px over sum + sqsum planes)
    prep = 14.0 * canvas_px

    n_surv = max(int(n_surv), 0)
    tail_exec = 0.0
    if det.strategy == "direct":
        planes = 2 if det.table.has_tilted else 1
        k = (det.h0 + 1) * (det.w0 + 1) * planes
        tail_exec = 2.0 * det.cap * k * det.table.n_clf * det.table.T

    useful = prep + front_ops_pp * det.n_visit + tail_useful_pp * n_surv
    executed_vpu = prep + front_ops_pp * grid_pos
    return dict(
        useful_flops=useful,
        executed_vpu_ops=executed_vpu,
        executed_mxu_flops_ub=tail_exec,
        front_ops_per_position=front_ops_pp,
        tail_nodes=tail_nodes,
        grid_positions=float(grid_pos),
        visit_positions=float(det.n_visit),
    )


def scalar_floor_flops(det, entering: np.ndarray) -> Dict[str, float]:
    """The schedule-independent floor of the useful work: the arithmetic a
    scalar per-stage early-exit evaluator (the reference's CPU evaluator,
    tempcv.cpp:919-948) does on this scene.

    ``entering`` is ``PyramidDetector.stage_entering_counts(gray)``: the
    windows entering each stage, then the final accepts.  Unlike
    ``pipeline_flops``'s ``useful_flops``, whose dense-front term grows
    with the front/tail handoff depth, it depends only on the cascade and
    the scene."""
    spec = det.compiled.spec
    rects = _node_rects(det)
    clf_ops = _clf_ops(rects)
    n_stages = int(det.n_stages)
    if len(entering) != n_stages + 1:
        raise ValueError(f"entering holds {len(entering)} counts, not "
                         f"n_stages + 1 = {n_stages + 1}")
    stage_ops = np.zeros(n_stages)
    stage_nodes = np.zeros(n_stages)
    for s in range(n_stages):
        c0 = int(spec.stage_clf_ofs[s])
        cnt = int(spec.stage_clf_cnt[s])
        stage_ops[s] = float(clf_ops[c0:c0 + cnt].sum())
        stage_nodes[s] = float((rects[c0:c0 + cnt] > 0).sum())
    prep = 14.0 * det.plan.canvas_h * det.plan.canvas_w
    ent = np.asarray(entering[:n_stages], np.float64)
    node_evals = float((ent * stage_nodes).sum())
    flops = prep + VAR_OPS * float(det.n_visit) + float(
        (ent * stage_ops).sum())
    return dict(
        scalar_floor_flops=flops,
        scalar_node_evals=node_evals,
        entering_per_stage=entering,
    )
