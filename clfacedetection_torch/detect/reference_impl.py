"""NumPy golden detector (the parity oracle), in the port.

Port of ``clfacedetection_tpu/detect/reference_impl.py``, copied whole: a
deliberately slow, window-at-a-time numpy implementation of OpenCV 2.4's
``cvHaarDetectObjects`` semantics (``tempcv.cpp``), written independently
of the device path so the two can be held box for box.

Covered semantics, with reference citations:

* variance normalization  (cvRunHaarClassifierCascadeSum, tempcv.cpp:822-832)
* stump voting in double  (tempcv.cpp:905-948): stage_sum += alpha[sum >= t]
* CART tree node walking  (icvEvalHidHaarClassifier, tempcv.cpp:771-792)
* stage-tree traversal    (tempcv.cpp:834-861)
* stage-threshold bias    (tempcv.cpp:262,419)
* boundary rejects        (tempcv.cpp:816-819: x + realW >= W+1 -> -1)
* scale-cascade scan      (ScaleCascade_Invoker, tempcv.cpp:1139-1170):
  x = cvRound(ix*ystep); ``ixstep = result != 0 ? 1 : 2`` -- skip the
  next column after a *stage-0* reject (stump cascades return ``-i`` = 0
  for stage 0) or any reject in stage-tree cascades (return 0)
* scale-image scan        (ScaleImage_Invoker, tempcv.cpp:1013-1106):
  resized level, ystep = factor > 2 ? 1 : 2, strip bounds that stop one
  row/col short (y2 = rows-1-h0; ssz.width = cols-1-w0)
* scale enumeration       (tempcv.cpp:1268-1296 / 1345-1376)
* grouping                (AgroupRectangles, tempcv.cpp:145-243)
* Canny pruning and find-biggest-object (tempcv.cpp:1339-1454)

The JAX package takes its integral images from ``cv2.integral``; the card
has no ``cv2``, so here they are exact integer sums: the int32 ``sum``
plane, the float64 squared sum (an int64 prefix sum, exact in float64
below 2^53) and the tilted RSAT plane (``ops.integral.tilted_integral``
on the CPU), all equal to ``cv2.integral3``'s.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..models.compile import (
    CompiledCascade, ScaledCascade, compile_cascade, cv_round,
    scale_factors, scan_grid, truncate_cascade)
from ..models.spec import CascadeSpec
from ..ops.canny import canny_np
from ..ops.integral import tilted_integral
from ..ops.resize import resize_bilinear_u8_np
from .grouping import group_rectangles, group_rectangles_levels

__all__ = ["detect_multi_scale_reference", "RefWindowEvaluator",
           "probe_window", "integrals"]


class RefWindowEvaluator:
    """Evaluate the full cascade on single windows (slow; oracle only)."""

    def __init__(self, compiled: CompiledCascade, scaled: ScaledCascade,
                 sum_img: np.ndarray, sqsum_img: np.ndarray,
                 tilted_img: Optional[np.ndarray]):
        self.c = compiled
        self.s = scaled
        self.sum = sum_img
        self.sqsum = sqsum_img
        self.tilted = tilted_img
        self.H = sum_img.shape[0] - 1
        self.W = sum_img.shape[1] - 1

    def _rect_sum(self, node: int, k: int, x: int, y: int) -> float:
        img = self.tilted if self.s.use_tilted[node] else self.sum
        cy = self.s.corner_y[node, k] + y
        cx = self.s.corner_x[node, k] + x
        return float(img[cy[0], cx[0]]) - float(img[cy[1], cx[1]]) \
            - float(img[cy[2], cx[2]]) + float(img[cy[3], cx[3]])

    def _node_value(self, node: int, x: int, y: int) -> float:
        """Each rect term rounds to f32 before the double accumulation:
        tempcv.cpp:782 multiplies an int calc_sum expression by a float
        weight, so C++ usual arithmetic conversions narrow the rect sum
        to f32 and round the product to f32 (observable when rect sums
        exceed 2^24 — large windows at big scales).  The C oracle
        (native/haar_oracle.cpp eval_classifier) mirrors this
        identically; docs/PARITY.md 'oracle precision contract'."""
        w = self.s.weight[node]
        v = float(np.float32(self._rect_sum(node, 0, x, y))
                  * np.float32(w[0]))
        v += float(np.float32(self._rect_sum(node, 1, x, y))
                   * np.float32(w[1]))
        if w[2] != 0.0:
            v += float(np.float32(self._rect_sum(node, 2, x, y))
                       * np.float32(w[2]))
        return v

    def _eval_classifier(self, clf: int, vnf: float, x: int, y: int) -> float:
        """CART walk (icvEvalHidHaarClassifier, tempcv.cpp:771-792)."""
        spec = self.c.spec
        n0 = int(spec.clf_node_ofs[clf])
        a0 = int(spec.clf_alpha_ofs[clf])
        idx = 0
        while True:
            node = n0 + idx
            t = float(self.c.node_threshold[node]) * vnf
            v = self._node_value(node, x, y)
            idx = int(self.c.left[node]) if v < t else int(self.c.right[node])
            if idx <= 0:
                return float(spec.alphas[a0 - idx])

    def _stage_sum(self, stage: int, vnf: float, x: int, y: int) -> float:
        spec = self.c.spec
        c0 = int(spec.stage_clf_ofs[stage])
        total = 0.0
        for j in range(int(spec.stage_clf_cnt[stage])):
            total += self._eval_classifier(c0 + j, vnf, x, y)
        return total

    def run(self, x: int, y: int) -> int:
        return self.run_sum(x, y)[0]

    def trace(self, x: int, y: int):
        """Per-stage breadcrumb trace of one window — the reusable form
        of the reference's hardcoded debug probes (window (114,182) in
        clod.cpp:673-675 / legacy.cpp:71-73; (14,0) in
        tempcv.cpp:933-940): returns a dict with the window's vnf and,
        per evaluated stage, (stage, stage_sum, threshold, passed), plus
        the run_sum exit code.  Sequential cascades stop at the first
        failing stage exactly like the evaluator; stage trees record
        the DFS visit order."""
        code, _ = self.run_sum(x, y)
        if code == -1:
            return dict(code=-1, vnf=None, stages=[])
        cy = self.s.equ_corner_y + y
        cx = self.s.equ_corner_x + x
        win_sum = float(self.sum[cy[0], cx[0]]) \
            - float(self.sum[cy[1], cx[1]]) \
            - float(self.sum[cy[2], cx[2]]) \
            + float(self.sum[cy[3], cx[3]])
        win_sq = float(self.sqsum[cy[0], cx[0]]) \
            - float(self.sqsum[cy[1], cx[1]]) \
            - float(self.sqsum[cy[2], cx[2]]) \
            + float(self.sqsum[cy[3], cx[3]])
        mean = win_sum * self.s.inv_area
        vnf = win_sq * self.s.inv_area - mean * mean
        vnf = np.sqrt(vnf) if vnf >= 0.0 else 1.0
        stages = []
        if self.c.is_tree:
            ptr = 0
            while ptr is not None:
                ss = self._stage_sum(ptr, vnf, x, y)
                thr = float(self.c.stage_threshold[ptr])
                stages.append((ptr, ss, thr, ss >= thr))
                if ss >= thr:
                    child = int(self.c.stage_child[ptr])
                    if child == -1:
                        break
                    ptr = child
                else:
                    while ptr is not None \
                            and int(self.c.stage_next[ptr]) == -1:
                        p = int(self.c.stage_parent[ptr])
                        ptr = p if p != -1 else None
                    ptr = int(self.c.stage_next[ptr]) \
                        if ptr is not None else None
        else:
            for i in range(self.c.spec.n_stages):
                ss = self._stage_sum(i, vnf, x, y)
                thr = float(self.c.stage_threshold[i])
                stages.append((i, ss, thr, ss >= thr))
                if ss < thr:
                    break
        return dict(code=code, vnf=float(vnf), stages=stages)

    def run_sum(self, x: int, y: int):
        """cvRunHaarClassifierCascadeSum: (code, stage_sum).  Codes: 1 pass,
        -i fail at stage i (stump/CART cascades), 0 fail (stage-tree
        cascades), -1 out of bounds.  ``stage_sum`` is the sum of the stage
        where evaluation stopped (the ROC gypWeight, tempcv.cpp:1083)."""
        if x < 0 or y < 0 or x + self.s.win_w >= self.W + 1 \
                or y + self.s.win_h >= self.H + 1:
            return -1, 0.0
        # Variance normalization over the equalization rect.
        cy = self.s.equ_corner_y + y
        cx = self.s.equ_corner_x + x
        win_sum = float(self.sum[cy[0], cx[0]]) - float(self.sum[cy[1], cx[1]]) \
            - float(self.sum[cy[2], cx[2]]) + float(self.sum[cy[3], cx[3]])
        win_sq = float(self.sqsum[cy[0], cx[0]]) - float(self.sqsum[cy[1], cx[1]]) \
            - float(self.sqsum[cy[2], cx[2]]) + float(self.sqsum[cy[3], cx[3]])
        mean = win_sum * self.s.inv_area
        vnf = win_sq * self.s.inv_area - mean * mean
        vnf = np.sqrt(vnf) if vnf >= 0.0 else 1.0

        if self.c.is_tree:
            # DFS over the stage tree (tempcv.cpp:834-861).
            ptr = 0
            ss = 0.0
            while ptr is not None:
                ss = self._stage_sum(ptr, vnf, x, y)
                if ss >= float(self.c.stage_threshold[ptr]):
                    child = int(self.c.stage_child[ptr])
                    if child == -1:
                        return 1, ss
                    ptr = child
                else:
                    while ptr is not None and int(self.c.stage_next[ptr]) == -1:
                        p = int(self.c.stage_parent[ptr])
                        ptr = p if p != -1 else None
                    if ptr is None:
                        return 0, ss
                    ptr = int(self.c.stage_next[ptr])
            return 1, ss
        else:
            ss = 0.0
            for i in range(self.c.spec.n_stages):
                ss = self._stage_sum(i, vnf, x, y)
                if ss < float(self.c.stage_threshold[i]):
                    return -i, ss
            return 1, ss


def probe_window(gray: np.ndarray, spec: CascadeSpec, x: int, y: int,
                 scale: float = 1.0):
    """One-call divergence-debugging probe (scale-cascade geometry):
    evaluate the cascade on the single window rooted at original-image
    position (x, y) with the features scaled by ``scale``, returning the
    per-stage trace (see :meth:`RefWindowEvaluator.trace`).  The
    reusable form of the reference's hardcoded window probes
    (clod.cpp:673-675, tempcv.cpp:812-815,933-940)."""
    c = compile_cascade(spec)
    s, sq, t = integrals(gray, c.has_tilted)
    ev = RefWindowEvaluator(c, c.at_scale(float(scale)), s, sq, t)
    return ev.trace(int(x), int(y))


def _integral(a: np.ndarray) -> np.ndarray:
    """(H, W) -> (H+1, W+1) int64 prefix sum with a zero first row and
    column."""
    out = np.zeros((a.shape[0] + 1, a.shape[1] + 1), np.int64)
    out[1:, 1:] = a.astype(np.int64).cumsum(0).cumsum(1)
    return out


def integrals(gray: np.ndarray, need_tilted: bool):
    """(sum int32, sqsum float64, tilted int32 or None) of uint8 gray, as
    ``cv2.integral3(gray, sdepth=CV_32S, sqdepth=CV_64F)`` gives them."""
    p = np.asarray(gray, np.uint8)
    s = _integral(p).astype(np.int32)
    sq = _integral(p.astype(np.int64) ** 2).astype(np.float64)
    t = (tilted_integral(torch.from_numpy(np.ascontiguousarray(p))).numpy()
         if need_tilted else None)
    return s, sq, t


def detect_multi_scale_reference(
        gray: np.ndarray,
        spec: CascadeSpec,
        scale_factor: float = 1.1,
        min_neighbors: int = 3,
        min_size: Tuple[int, int] = (0, 0),
        max_size: Optional[Tuple[int, int]] = None,
        mode: str = "scale_cascade",
        max_stages: Optional[int] = None,
        output_reject_levels: bool = False,
        do_canny_pruning: bool = False,
        find_biggest_object: bool = False,
        rough_search: bool = False,
) -> np.ndarray:
    """Full-pipeline golden detector. Returns int32 boxes [n, 4] (x,y,w,h),
    or (boxes, reject_levels, level_weights) with
    ``output_reject_levels=True`` (scale_image mode only — the ROC path of
    HaarDetectObjects_ScaleImage_Invoker, tempcv.cpp:1084-1095: every
    window surviving to within 4 stages of the end is reported with its
    exit stage and that stage's sum).

    ``max_stages`` truncates the cascade (keeps candidate sets non-empty on
    synthetic test images; parity tests compare truncated-cascade candidate
    sets between oracle and TPU path).
    """
    if gray.ndim != 2 or gray.dtype != np.uint8:
        raise ValueError(f"expected uint8 (H, W) gray, got {gray.dtype} "
                         f"{gray.shape}")
    # output_reject_levels in scale_cascade mode is legal but degenerate:
    # the ScaleCascade invoker never fills the level vectors (only the
    # ScaleImage invoker does, tempcv.cpp:1084-1095 vs 1155-1158), so the
    # final levels-overload grouping sees empty levels, every class keeps
    # level 0, and min_neighbors > 0 filters everything
    # (tempcv.cpp:1466-1469 + the AgroupRectangles guard at 176).
    if find_biggest_object:
        # FBO clears SCALE_IMAGE and CANNY (tempcv.cpp:1227,1253)
        mode = "scale_cascade"
        do_canny_pruning = False
        return _find_biggest_object(gray, spec, scale_factor, min_neighbors,
                                    min_size, max_stages, rough_search)
    compiled = compile_cascade(spec)
    if max_stages is not None:
        compiled = truncate_cascade(compiled, max_stages)
    H, W = gray.shape
    candidates: List[Tuple[int, int, int, int]] = []
    rej_levels: List[int] = []
    rej_weights: List[float] = []
    n_stages = compiled.spec.n_stages

    factors = scale_factors(spec.window_w, spec.window_h, W, H,
                            scale_factor, min_size, max_size, mode=mode)
    if mode == "scale_cascade":
        s_img, sq_img, t_img = integrals(gray, compiled.has_tilted)
        canny_sum = None
        if do_canny_pruning:
            # cvCanny(img, 0, 50, 3) + integral (tempcv.cpp:1339-1343)
            canny_sum = _integral(canny_np(gray, 0, 50)).astype(np.int32)
        for f in factors:
            scaled = compiled.at_scale(f)
            ev = RefWindowEvaluator(compiled, scaled, s_img, sq_img, t_img)
            ystep, xs, ys = scan_grid(W, H, scaled.win_w, scaled.win_h, f)
            if do_canny_pruning:
                # pruning rect = (0.15, 0.15, 0.7, 0.7) of the window
                # (tempcv.cpp:1386-1391); pq aliases the *sum* integral
                ex = int(cv_round(scaled.win_w * 0.15))
                ey = int(cv_round(scaled.win_h * 0.15))
                ew = int(cv_round(scaled.win_w * 0.7))
                eh = int(cv_round(scaled.win_h * 0.7))
            for y in ys:
                ix = 0
                while ix < len(xs):
                    x = int(xs[ix])
                    if do_canny_pruning:
                        cy0, cx0 = int(y) + ey, x + ex
                        cs = int(canny_sum[cy0, cx0]
                                 - canny_sum[cy0, cx0 + ew]
                                 - canny_sum[cy0 + eh, cx0]
                                 + canny_sum[cy0 + eh, cx0 + ew])
                        cq = int(s_img[cy0, cx0]
                                 - s_img[cy0, cx0 + ew]
                                 - s_img[cy0 + eh, cx0]
                                 + s_img[cy0 + eh, cx0 + ew])
                        if cs < 100 or cq < 20:
                            ix += 2
                            continue
                    res = ev.run(x, int(y))
                    if res > 0:
                        candidates.append((x, int(y),
                                           scaled.win_w, scaled.win_h))
                    ix += 1 if res != 0 else 2
    elif mode == "scale_image":
        w0, h0 = spec.window_w, spec.window_h
        scaled = compiled.at_scale(1.0)
        # scale-image normalization rect is the fixed (1,1,w0-2,h0-2)
        # border rect (icv_object_win_border, tempcv.cpp:261,1276-1278) —
        # identical to at_scale(1.0)'s equalization rect.
        for f in factors:
            win_w = int(cv_round(w0 * f))
            win_h = int(cv_round(h0 * f))
            sz_w = int(cv_round(W / f))
            sz_h = int(cv_round(H / f))
            # pinned 2.4-era fixed-point resize (see ops/resize.py; shared
            # bit-exactly with the TPU pyramid path)
            lvl = resize_bilinear_u8_np(gray, (sz_h, sz_w))
            s_img, sq_img, t_img = integrals(lvl, compiled.has_tilted)
            ev = RefWindowEvaluator(compiled, scaled, s_img, sq_img, t_img)
            ystep = 1 if f > 2 else 2
            # strip bounds: y < rows-1-h0, x < cols-1-w0 (tempcv.cpp:1015-1020)
            y2 = sz_h - h0
            x2 = sz_w - w0
            for y in range(0, max(y2, 0), ystep):
                for x in range(0, max(x2, 0), ystep):
                    result, gyp = ev.run_sum(x, y)
                    if output_reject_levels:
                        if result == 1:
                            result = -n_stages
                        if n_stages + result < 4:
                            candidates.append((int(cv_round(x * f)),
                                               int(cv_round(y * f)),
                                               win_w, win_h))
                            rej_levels.append(-result)
                            rej_weights.append(gyp)
                    elif result > 0:
                        candidates.append((int(cv_round(x * f)),
                                           int(cv_round(y * f)),
                                           win_w, win_h))
    else:
        raise ValueError(f"unknown mode {mode!r}")

    boxes = np.array(candidates, np.int32).reshape(-1, 4)
    if output_reject_levels:
        levels = np.asarray(rej_levels, np.int32)
        weights = np.asarray(rej_weights, np.float64)
        if min_neighbors != 0:
            return group_rectangles_levels(boxes, levels, weights,
                                           min_neighbors, eps=0.2)
        return boxes, levels, weights
    if min_neighbors != 0:
        boxes, _ = group_rectangles(boxes, max(min_neighbors, 1), eps=0.2)
    return boxes


def _find_biggest_object(gray, spec, scale_factor, min_neighbors,
                         min_size, max_stages, rough_search):
    """CV_HAAR_FIND_BIGGEST_OBJECT search (tempcv.cpp:1349-1454,1477-1489):
    scales descend from the largest; after the first scale with candidates
    the scan narrows to an eps-expanded ROI around the biggest grouped box
    and min_size rises to 0.4 (0.6 with DO_ROUGH_SEARCH) of it; the result
    is the single largest grouped rectangle."""
    GROUP_EPS = 0.2
    compiled = compile_cascade(spec)
    if max_stages is not None:
        compiled = truncate_cascade(compiled, max_stages)
    H, W = gray.shape
    s_img, sq_img, t_img = integrals(gray, compiled.has_tilted)

    # factor enumeration then reversal (tempcv.cpp:1345-1360)
    n_factors = 0
    f = 1.0
    while f * spec.window_w < W - 10 and f * spec.window_h < H - 10:
        n_factors += 1
        f *= scale_factor
    inv = 1.0 / scale_factor
    factor = f * inv
    min_w, min_h = min_size
    scan_roi = None  # (x, y, w, h)
    candidates: List[Tuple[int, int, int, int]] = []

    for _ in range(n_factors):
        ystep = max(2.0, factor)
        win_w = int(cv_round(spec.window_w * factor))
        win_h = int(cv_round(spec.window_h * factor))
        if win_w < min_w or win_h < min_h:
            break  # descending scales: nothing smaller qualifies
        scaled = compiled.at_scale(factor)
        ev = RefWindowEvaluator(compiled, scaled, s_img, sq_img, t_img)
        start_x = start_y = 0
        end_x = int(cv_round((W - win_w) / ystep))
        end_y = int(cv_round((H - win_h) / ystep))
        if scan_roi is not None:
            rx, ry, rw, rh = scan_roi
            start_y = int(cv_round(ry / ystep))
            end_y = int(cv_round((ry + rh - win_h) / ystep))
            start_x = int(cv_round(rx / ystep))
            end_x = int(cv_round((rx + rw - win_w) / ystep))
        for iy in range(start_y, end_y):
            y = int(cv_round(iy * ystep))
            ix = start_x
            while ix < end_x:
                x = int(cv_round(ix * ystep))
                res = ev.run(x, y)
                if res > 0:
                    candidates.append((x, y, win_w, win_h))
                ix += 1 if res != 0 else 2
        if candidates and scan_roi is None:
            grouped, _ = group_rectangles(
                np.asarray(candidates, np.int64),
                max(min_neighbors, 1), GROUP_EPS)
            if len(grouped):
                areas = grouped[:, 2] * grouped[:, 3]
                mx = grouped[int(np.argmax(areas))]
                candidates.append(tuple(int(v) for v in mx))
                dx = int(cv_round(mx[2] * GROUP_EPS))
                dy = int(cv_round(mx[3] * GROUP_EPS))
                rx = max(int(mx[0]) - dx, 0)
                ry = max(int(mx[1]) - dy, 0)
                rw = min(int(mx[2]) + dx * 2, W - 1 - rx)
                rh = min(int(mx[3]) + dy * 2, H - 1 - ry)
                scan_roi = (rx, ry, rw, rh)
                min_scale = 0.6 if rough_search else 0.4
                min_w = int(cv_round(mx[2] * min_scale))
                min_h = int(cv_round(mx[3] * min_scale))
        factor *= inv

    boxes = np.asarray(candidates, np.int64).reshape(-1, 4)
    boxes, neigh = group_rectangles(boxes, max(min_neighbors, 1), GROUP_EPS)
    if not len(boxes):
        return np.zeros((0, 4), np.int32)
    areas = boxes[:, 2] * boxes[:, 3]
    return boxes[int(np.argmax(areas))][None, :].astype(np.int32)
