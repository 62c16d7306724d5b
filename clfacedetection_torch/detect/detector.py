"""Host-side cascade tables shared by the detectors (numpy).

Port of the host part of ``clfacedetection_tpu/detect/detector.py``
(lines 67-175): the stage-tree paths, the classifier-major padded tables
and the result record.  The scale-cascade detector itself is not ported
yet (ROADMAP Queue 1).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

from ..models.compile import CompiledCascade

__all__ = ["DetectionResult"]


def _stage_paths(c: CompiledCascade) -> List[List[int]]:
    """Root-to-leaf stage chains of the stage tree (tempcv.cpp:834-861).
    Plain cascades are the single chain [0..n_stages-1]."""
    n = c.spec.n_stages
    if not c.is_tree:
        return [list(range(n))]
    children: List[List[int]] = [[] for _ in range(n)]
    roots: List[int] = []
    for s in range(n):
        p = int(c.stage_parent[s])
        if p == -1:
            roots.append(s)
        else:
            children[p].append(s)
    paths: List[List[int]] = []

    def walk(s: int, prefix: List[int]) -> None:
        prefix = prefix + [s]
        if int(c.stage_child[s]) == -1:
            paths.append(prefix)
        else:
            for ch in children[s]:
                walk(ch, prefix)

    for r in roots:
        walk(r, [])
    return paths


@dataclasses.dataclass(frozen=True)
class _ClfTables:
    """Classifier-major padded tables; T = max nodes per classifier."""

    T: int
    n_clf: int
    corner_y: np.ndarray   # int32 [S, n_clf, T, 3, 4]
    corner_x: np.ndarray   # int32 [S, n_clf, T, 3, 4]
    weight: np.ndarray     # float32 [S, n_clf, T, 3]
    use_tilted: np.ndarray  # bool [n_clf, T]
    threshold: np.ndarray  # float32 [n_clf, T]
    left: np.ndarray       # int32 [n_clf, T]
    right: np.ndarray      # int32 [n_clf, T]
    alpha: np.ndarray      # float32 [n_clf, T + 1]
    clf_stage: np.ndarray  # int32 [n_clf]
    clf_valid_nodes: np.ndarray  # int32 [n_clf]


def _build_clf_tables(c: CompiledCascade,
                      scales: Sequence[float]) -> _ClfTables:
    spec = c.spec
    n_clf = spec.n_classifiers
    T = int(spec.clf_node_cnt.max()) if n_clf else 1
    S = len(scales)
    cy = np.zeros((S, n_clf, T, 3, 4), np.int32)
    cx = np.zeros((S, n_clf, T, 3, 4), np.int32)
    w = np.zeros((S, n_clf, T, 3), np.float32)
    tlt = np.zeros((n_clf, T), bool)
    thr = np.zeros((n_clf, T), np.float32)
    left = np.zeros((n_clf, T), np.int32)
    right = np.zeros((n_clf, T), np.int32)
    alpha = np.zeros((n_clf, T + 1), np.float32)
    clf_stage = np.zeros((n_clf,), np.int32)
    nodesel = []
    for cidx in range(n_clf):
        n0 = int(spec.clf_node_ofs[cidx])
        cnt = int(spec.clf_node_cnt[cidx])
        a0 = int(spec.clf_alpha_ofs[cidx])
        for t in range(cnt):
            node = n0 + t
            thr[cidx, t] = c.node_threshold[node]
            left[cidx, t] = c.left[node]
            right[cidx, t] = c.right[node]
            tlt[cidx, t] = c.use_tilted[node]
        alpha[cidx, :cnt + 1] = spec.alphas[a0:a0 + cnt + 1]
        nodesel.append([n0 + t if t < cnt else -1 for t in range(T)])
    for stage in range(spec.n_stages):
        c0 = int(spec.stage_clf_ofs[stage])
        clf_stage[c0:c0 + int(spec.stage_clf_cnt[stage])] = stage
    sel = np.asarray(nodesel, np.int64).reshape(n_clf, T)
    valid = sel >= 0
    selc = np.clip(sel, 0, None)
    for k, s in enumerate(scales):
        sc = c.at_scale(s)
        cy[k] = np.where(valid[..., None, None], sc.corner_y[selc], 0)
        cx[k] = np.where(valid[..., None, None], sc.corner_x[selc], 0)
        w[k] = np.where(valid[..., None], sc.weight[selc], 0.0)
    return _ClfTables(
        T=T, n_clf=n_clf, corner_y=cy, corner_x=cx, weight=w,
        use_tilted=tlt, threshold=thr, left=left, right=right, alpha=alpha,
        clf_stage=clf_stage,
        clf_valid_nodes=spec.clf_node_cnt.astype(np.int32))


@dataclasses.dataclass
class DetectionResult:
    """Detections plus diagnostics."""

    boxes: np.ndarray          # int32 [n, 4] grouped (raw if min_neighbors=0)
    neighbors: np.ndarray      # int32 [n]
    candidates: np.ndarray     # int32 [m, 4] raw pre-grouping candidates
    survivor_overflow: bool    # True if the survivor cap overflowed
