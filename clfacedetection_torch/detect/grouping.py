"""Rectangle grouping (OpenCV ``groupRectangles``), numpy on the host.

Port of ``clfacedetection_tpu/detect/grouping.py`` (AgroupRectangles +
ASimilarRects, tempcv.cpp:129-243, with ``cv::partition`` union-find).
The pairwise similarity test is one vectorised numpy pass; the union-find
then visits the similar pairs in the same (i, j) row-major order as the
nested loop it replaces, so labels come out identical.  The native C++
twin of the JAX package is not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["group_rectangles", "partition_similar"]


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
                     eps: float = 0.2) -> Tuple[np.ndarray, np.ndarray]:
    """Group candidate boxes; returns (boxes [m,4] int32, neighbors [m]).

    AgroupRectangles semantics (tempcv.cpp:145-243): partition into
    similarity classes, average each class with float ``1.f/n`` scaling
    and truncation, drop classes with ``<= group_threshold`` members, drop
    small classes contained in a bigger one when
    ``n2 > max(3, n1) or n1 < 3``.
    """
    boxes = np.asarray(boxes, np.int64).reshape(-1, 4)
    if group_threshold <= 0 or len(boxes) == 0:
        return boxes.astype(np.int32), np.ones(len(boxes), np.int32)

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
