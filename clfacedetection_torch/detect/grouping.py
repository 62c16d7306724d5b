"""Rectangle grouping (OpenCV ``groupRectangles``), numpy on the host.

Port of ``clfacedetection_tpu/detect/grouping.py`` (AgroupRectangles +
ASimilarRects, tempcv.cpp:129-243, with ``cv::partition`` union-find,
and the ROC overload ``group_rectangles_levels``).
``group_rectangles`` runs the C++ twin (``native/grouping.cpp``, a
ctypes call that releases the GIL) when the native library loads and
``CLFD_NO_NATIVE`` is not ``1``; the numpy code below is its
specification and fallback.  Its pairwise similarity test is one
vectorised numpy pass; the union-find then visits the similar pairs in
the same (i, j) row-major order as the nested loop it replaces, so
labels come out identical.  ``variant="clod"`` keeps the reference's own
C port's containment bugs (clod.cpp:333-339) for parity studies.  The
ROC overload stays numpy, as the JAX package's does.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from ..native import group_rectangles_native, native_available

__all__ = ["group_rectangles", "group_rectangles_levels",
           "partition_similar"]


def partition_similar(boxes: np.ndarray, eps: float) -> Tuple[np.ndarray, int]:
    """cv::partition with ASimilarRects; labels 0..n_classes-1 in
    first-appearance order of each class root."""
    boxes = np.asarray(boxes, np.int64).reshape(-1, 4)
    n = len(boxes)
    x, y, w, h = (boxes[:, k] for k in range(4))
    parent = list(range(n))
    rank = [0] * n

    def find(i: int) -> int:
        root = i
        while parent[root] != root:
            root = parent[root]
        while parent[i] != root:
            parent[i], i = root, parent[i]
        return root

    rows = 512                      # bounds the [rows, n] temporaries
    for i0 in range(0, n, rows):
        r = slice(i0, min(i0 + rows, n))
        delta = eps * (np.minimum(w[r, None], w[None, :])
                       + np.minimum(h[r, None], h[None, :])) * 0.5
        sim = ((np.abs(x[r, None] - x[None, :]) <= delta)
               & (np.abs(y[r, None] - y[None, :]) <= delta)
               & (np.abs(x[r, None] + w[r, None] - x[None, :] - w[None, :])
                  <= delta)
               & (np.abs(y[r, None] + h[r, None] - y[None, :] - h[None, :])
                  <= delta))
        for i, j in zip(*np.nonzero(sim)):
            i, j = i0 + int(i), int(j)
            if i == j:
                continue
            ri, rj = find(i), find(j)
            if ri != rj:
                if rank[ri] < rank[rj]:
                    ri, rj = rj, ri
                parent[rj] = ri
                if rank[ri] == rank[rj]:
                    rank[ri] += 1

    labels = np.empty(n, np.int32)
    root_to_label = {}
    for i in range(n):
        r = find(i)
        if r not in root_to_label:
            root_to_label[r] = len(root_to_label)
        labels[i] = root_to_label[r]
    return labels, len(root_to_label)


def group_rectangles(boxes: np.ndarray, group_threshold: int,
                     eps: float = 0.2,
                     variant: str = "opencv") -> Tuple[np.ndarray, np.ndarray]:
    """Group candidate boxes; returns (boxes [m,4] int32, neighbors [m]).

    AgroupRectangles semantics (tempcv.cpp:145-243): partition into
    similarity classes, average each class with float ``1.f/n`` scaling
    and truncation, drop classes with ``<= group_threshold`` members, drop
    small classes contained in a bigger one when
    ``n2 > max(3, n1) or n1 < 3``.  ``variant="clod"`` takes the
    reference port's containment test instead.
    """
    boxes = np.asarray(boxes, np.int64).reshape(-1, 4)
    if group_threshold <= 0 or len(boxes) == 0:
        return boxes.astype(np.int32), np.ones(len(boxes), np.int32)
    if os.environ.get("CLFD_NO_NATIVE") != "1" and native_available():
        return group_rectangles_native(boxes, group_threshold, eps, variant)

    labels, ncls = partition_similar(boxes, eps)
    sums = np.zeros((ncls, 4), np.int64)
    np.add.at(sums, labels, boxes)
    counts = np.bincount(labels, minlength=ncls).astype(np.int32)
    s = (np.float32(1.0) / counts.astype(np.float32))[:, None]
    rrects = (sums.astype(np.float32) * s).astype(np.int64)

    keep = []
    out_n = []
    for i in range(ncls):
        r1 = rrects[i]
        n1 = int(counts[i])
        if n1 <= group_threshold:
            continue
        contained = False
        for j in range(ncls):
            n2 = int(counts[j])
            if j == i or n2 <= group_threshold:
                continue
            r2 = rrects[j]
            if variant == "clod":
                # the reference port's bugs (clod.cpp:333-339): the clamp
                # maxes with INT_MAX (so dx/dy are huge) and the right edge
                # uses width+width
                dx = max(int(r2[2] * eps), np.iinfo(np.int32).max)
                dy = max(int(r2[3] * eps), np.iinfo(np.int32).max)
                inside = (r1[0] >= r2[0] - dx and r1[1] >= r2[1] - dy
                          and r1[2] + r1[2] <= r2[0] + r2[2] + dx
                          and r1[3] + r1[3] <= r2[1] + r2[3] + dy)
            else:
                dx = int(r2[2] * eps)
                dy = int(r2[3] * eps)
                inside = (r1[0] >= r2[0] - dx and r1[1] >= r2[1] - dy
                          and r1[0] + r1[2] <= r2[0] + r2[2] + dx
                          and r1[1] + r1[3] <= r2[1] + r2[3] + dy)
            if inside and (n2 > max(3, n1) or n1 < 3):
                contained = True
                break
        if not contained:
            keep.append(r1)
            out_n.append(n1)

    if not keep:
        return np.zeros((0, 4), np.int32), np.zeros((0,), np.int32)
    return np.stack(keep).astype(np.int32), np.asarray(out_n, np.int32)


def group_rectangles_levels(boxes: np.ndarray, reject_levels: np.ndarray,
                            level_weights: np.ndarray, group_threshold: int,
                            eps: float = 0.2):
    """The ROC overload of the grouping (tempcv.cpp:162-186, 213-216,
    240-243; JAX ``grouping.py:150-218``): each class reports its largest
    member reject level (ties broken by the larger level weight); the
    keep test holds the class's reject level against ``group_threshold``,
    while containment still uses member counts.

    Returns (boxes [m, 4] int32, reject_levels [m] int32, level_weights
    [m] float64)."""
    boxes = np.asarray(boxes, np.int64).reshape(-1, 4)
    reject_levels = np.asarray(reject_levels, np.int64)
    level_weights = np.asarray(level_weights, np.float64)
    if group_threshold <= 0 or len(boxes) == 0:
        return (boxes.astype(np.int32), reject_levels.astype(np.int32),
                level_weights)

    labels, ncls = partition_similar(boxes, eps)
    sums = np.zeros((ncls, 4), np.int64)
    np.add.at(sums, labels, boxes)
    counts = np.bincount(labels, minlength=ncls).astype(np.int32)
    cls_level = np.zeros(ncls, np.int64)
    cls_weight = np.full(ncls, np.finfo(np.float64).tiny)
    # the level fill runs only when both inputs hold values
    # (tempcv.cpp:176); else every class keeps level 0 and the keep test
    # below drops it
    if len(reject_levels) and len(level_weights):
        for i, cls in enumerate(labels):
            if reject_levels[i] > cls_level[cls]:
                cls_level[cls] = reject_levels[i]
                cls_weight[cls] = level_weights[i]
            elif reject_levels[i] == cls_level[cls] \
                    and level_weights[i] > cls_weight[cls]:
                cls_weight[cls] = level_weights[i]
    s = (np.float32(1.0) / counts.astype(np.float32))[:, None]
    rrects = (sums.astype(np.float32) * s).astype(np.int64)

    out_b, out_l, out_w = [], [], []
    for i in range(ncls):
        r1 = rrects[i]
        n1 = int(cls_level[i])
        if n1 <= group_threshold:
            continue
        contained = False
        for j in range(ncls):
            n2 = int(counts[j])
            if j == i or n2 <= group_threshold:
                continue
            r2 = rrects[j]
            dx = int(r2[2] * eps)
            dy = int(r2[3] * eps)
            if (r1[0] >= r2[0] - dx and r1[1] >= r2[1] - dy
                    and r1[0] + r1[2] <= r2[0] + r2[2] + dx
                    and r1[1] + r1[3] <= r2[1] + r2[3] + dy
                    and (n2 > max(3, n1) or n1 < 3)):
                contained = True
                break
        if not contained:
            out_b.append(r1)
            out_l.append(n1)
            out_w.append(float(cls_weight[i]))
    if not out_b:
        return (np.zeros((0, 4), np.int32), np.zeros(0, np.int32),
                np.zeros(0, np.float64))
    return (np.stack(out_b).astype(np.int32),
            np.asarray(out_l, np.int32), np.asarray(out_w, np.float64))
