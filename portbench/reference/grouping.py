"""OpenCV's ``groupRectangles`` (AgroupRectangles and ASimilarRects,
tempcv.cpp:129-243), in numpy.

Candidates are partitioned into classes of similar rectangles
(``cv::partition``): two are similar where each of their four edges lies
within ``eps * (min(w1, w2) + min(h1, h2)) / 2`` of the other's, and a
class is a connected set of that relation.  Each class is averaged with a
float32 ``1 / n`` and truncated; a class with ``n <= threshold`` members
is dropped, and so is one lying inside another kept class (edges widened
by ``eps`` of the other's size) where ``n2 > max(3, n1)`` or ``n1 < 3``.
Returns the boxes and each one's member count (its neighbours)."""

from __future__ import annotations

import numpy as np
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components

__all__ = ["group_rectangles"]

_ROWS = 512


def _classes(boxes: np.ndarray, eps: float) -> np.ndarray:
    n = len(boxes)
    x, y, w, h = (boxes[:, k] for k in range(4))
    src, dst = [], []
    for a in range(0, n, _ROWS):
        r = slice(a, min(a + _ROWS, n))
        delta = eps * (np.minimum(w[r, None], w[None, :])
                       + np.minimum(h[r, None], h[None, :])) * 0.5
        sim = ((np.abs(x[r, None] - x[None, :]) <= delta)
               & (np.abs(y[r, None] - y[None, :]) <= delta)
               & (np.abs(x[r, None] + w[r, None] - x[None, :] - w[None, :])
                  <= delta)
               & (np.abs(y[r, None] + h[r, None] - y[None, :] - h[None, :])
                  <= delta))
        i, j = np.nonzero(sim)
        src.append(i + a)
        dst.append(j)
    i, j = np.concatenate(src), np.concatenate(dst)
    graph = coo_matrix((np.ones(len(i), np.int8), (i, j)), shape=(n, n))
    return connected_components(graph, directed=False)[1]


def group_rectangles(boxes, threshold: int, eps: float = 0.2):
    boxes = np.asarray(boxes, np.int64).reshape(-1, 4)
    if threshold <= 0 or len(boxes) == 0:
        return boxes, np.ones(len(boxes), np.int64)
    labels = _classes(boxes, eps)
    k = int(labels.max()) + 1
    sums = np.zeros((k, 4), np.int64)
    np.add.at(sums, labels, boxes)
    counts = np.bincount(labels, minlength=k)
    scale = (np.float32(1.0) / counts.astype(np.float32))[:, None]
    r = (sums.astype(np.float32) * scale).astype(np.int64)
    big = np.nonzero(counts > threshold)[0]
    r, n = r[big], counts[big]
    dx, dy = (r[:, 2] * eps).astype(np.int64), (r[:, 3] * eps).astype(np.int64)
    keep = np.ones(len(r), bool)
    for a in range(0, len(r), _ROWS):
        q = slice(a, min(a + _ROWS, len(r)))
        inside = ((r[q, None, 0] >= r[None, :, 0] - dx)
                  & (r[q, None, 1] >= r[None, :, 1] - dy)
                  & (r[q, None, 0] + r[q, None, 2]
                     <= r[None, :, 0] + r[None, :, 2] + dx)
                  & (r[q, None, 1] + r[q, None, 3]
                     <= r[None, :, 1] + r[None, :, 3] + dy)
                  & ((n[None, :] > np.maximum(3, n[q])[:, None])
                     | (n[q, None] < 3)))
        inside[np.arange(q.stop - a), np.arange(a, q.stop)] = False
        keep[q] = ~inside.any(axis=1)
    return r[keep], n[keep].astype(np.int64)
