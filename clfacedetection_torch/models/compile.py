"""Cascade compiler: CascadeSpec -> flat numpy tables (host side).

Port of ``clfacedetection_tpu/models/compile.py`` (the counterpart of the
reference's ``icvCreateHidHaarClassifierCascade`` and
``cvSetImagesForHaarClassifierCascade``, tempcv.cpp:307-768).  The tables
are plain numpy; the detector packs them into one device buffer.

``cv_round`` is OpenCV's round-half-to-even (``np.rint``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from .spec import MAX_RECTS, CascadeSpec

__all__ = [
    "STAGE_THRESHOLD_BIAS", "cv_round", "ScaledCascade", "CompiledCascade",
    "compile_cascade", "truncate_cascade", "scale_factors", "scan_grid",
]

# icv_stage_threshold_bias (tempcv.cpp:262), subtracted from every stage
# threshold when the hidden cascade is built (tempcv.cpp:419).
STAGE_THRESHOLD_BIAS = np.float32(0.0001)


def cv_round(x) -> np.ndarray:
    """OpenCV cvRound: round half to even."""
    return np.rint(x).astype(np.int64)


@dataclasses.dataclass(frozen=True)
class ScaledCascade:
    """Per-scale feature tables.  Every rect has 4 integral-image corners
    ``(y, x)`` with signs ``+ - - +``; upright corners are
    ``(y,x) (y,x+w) (y+h,x) (y+h,x+w)``, tilted ones follow
    tempcv.cpp:743-750.  Absent rects have weight 0 and corners (0, 0)."""

    scale: float
    win_w: int
    win_h: int
    inv_area: float            # 1 / (equ_w * equ_h)
    equ_corner_y: np.ndarray   # int32 [4] window-normalization corners
    equ_corner_x: np.ndarray   # int32 [4]
    corner_y: np.ndarray       # int32 [n_nodes, MAX_RECTS, 4]
    corner_x: np.ndarray       # int32 [n_nodes, MAX_RECTS, 4]
    weight: np.ndarray         # float32 [n_nodes, MAX_RECTS]
    use_tilted: np.ndarray     # bool [n_nodes]


@dataclasses.dataclass(frozen=True)
class CompiledCascade:
    """Scale-independent compiled form (the 'hidden cascade')."""

    spec: CascadeSpec
    rect_x: np.ndarray
    rect_y: np.ndarray
    rect_w: np.ndarray
    rect_h: np.ndarray
    rect_weight: np.ndarray
    n_rects: np.ndarray          # int32 [n_nodes] 2 or 3
    use_tilted: np.ndarray       # bool [n_nodes]
    node_threshold: np.ndarray   # float32 [n_nodes]
    left: np.ndarray             # int32 [n_nodes]
    right: np.ndarray            # int32 [n_nodes]
    stage_threshold: np.ndarray  # float32 [n_stages] (bias applied)
    stage_parent: np.ndarray
    stage_next: np.ndarray
    stage_child: np.ndarray

    @property
    def is_stump_based(self) -> bool:
        return bool(np.all(self.spec.clf_node_cnt == 1))

    @property
    def is_tree(self) -> bool:
        return bool(np.any(self.stage_next != -1))

    @property
    def has_tilted(self) -> bool:
        return bool(np.any(self.use_tilted))

    def at_scale(self, scale: float) -> ScaledCascade:
        """Scale every feature to ``scale`` (tempcv.cpp:549-768)."""
        spec = self.spec
        s = float(scale)
        win_w = int(cv_round(spec.window_w * s))
        win_h = int(cv_round(spec.window_h * s))

        equ_xy = int(cv_round(s))
        equ_w = int(cv_round((spec.window_w - 2) * s))
        equ_h = int(cv_round((spec.window_h - 2) * s))
        inv_area = 1.0 / (equ_w * equ_h)
        equ_corner_y = np.array(
            [equ_xy, equ_xy, equ_xy + equ_h, equ_xy + equ_h], np.int32)
        equ_corner_x = np.array(
            [equ_xy, equ_xy + equ_w, equ_xy, equ_xy + equ_w], np.int32)

        tx = cv_round(self.rect_x * s)
        ty = cv_round(self.rect_y * s)
        tw = cv_round(self.rect_w * s)
        th = cv_round(self.rect_h * s)

        present = self.rect_weight != 0.0
        # correction_ratio = inv_area * (tilted ? 0.5 : 1)  (tempcv.cpp:733)
        corr = np.where(self.use_tilted, 0.5 * inv_area, inv_area)
        w = (self.rect_weight.astype(np.float64) * corr[:, None]).astype(
            np.float32)
        # rect 0's weight makes the feature zero-mean over the scaled areas
        # (tempcv.cpp:752-760): w0 = -sum(w_k*area_k)/area_0
        area = (tw * th).astype(np.float64)
        sum0 = np.sum(
            np.where(present[:, 1:], w[:, 1:].astype(np.float64)
                     * area[:, 1:], 0.0), axis=1)
        w0 = (-sum0 / area[:, 0]).astype(np.float32)
        w = np.concatenate([w0[:, None], w[:, 1:]], axis=1)
        w = np.where(present, w, np.float32(0.0))

        n = spec.n_nodes
        cy = np.zeros((n, MAX_RECTS, 4), np.int64)
        cx = np.zeros((n, MAX_RECTS, 4), np.int64)
        up = ~self.use_tilted[:, None]
        cy[..., 0] = ty
        cx[..., 0] = tx
        cy[..., 1] = np.where(up, ty, ty + th)
        cx[..., 1] = np.where(up, tx + tw, tx - th)
        cy[..., 2] = np.where(up, ty + th, ty + tw)
        cx[..., 2] = np.where(up, tx, tx + tw)
        cy[..., 3] = np.where(up, ty + th, ty + tw + th)
        cx[..., 3] = np.where(up, tx + tw, tx + tw - th)
        cy = np.where(present[..., None], cy, 0).astype(np.int32)
        cx = np.where(present[..., None], cx, 0).astype(np.int32)

        return ScaledCascade(
            scale=s, win_w=win_w, win_h=win_h, inv_area=inv_area,
            equ_corner_y=equ_corner_y, equ_corner_x=equ_corner_x,
            corner_y=cy, corner_x=cx, weight=w, use_tilted=self.use_tilted)


def compile_cascade(spec: CascadeSpec) -> CompiledCascade:
    """Scale-independent compile (icvCreateHidHaarClassifierCascade)."""
    w = spec.rect_weight.astype(np.float32).copy()
    rx = spec.rect_x.astype(np.int32).copy()
    ry = spec.rect_y.astype(np.int32).copy()
    rw = spec.rect_w.astype(np.int32).copy()
    rh = spec.rect_h.astype(np.int32).copy()
    # drop a third rect that is empty or ~zero weight (tempcv.cpp:453-458)
    drop2 = (np.abs(w[:, 2]) < np.finfo(np.float64).eps) | (rw[:, 2] == 0) \
        | (rh[:, 2] == 0)
    for arr in (w, rx, ry, rw, rh):
        arr[:, 2] = np.where(drop2, 0, arr[:, 2])
    n_rects = np.where(w[:, 2] != 0, 3, 2).astype(np.int32)

    return CompiledCascade(
        spec=spec,
        rect_x=rx, rect_y=ry, rect_w=rw, rect_h=rh, rect_weight=w,
        n_rects=n_rects,
        use_tilted=spec.tilted.astype(bool),
        node_threshold=spec.node_threshold.astype(np.float32),
        left=spec.left.astype(np.int32), right=spec.right.astype(np.int32),
        stage_threshold=(spec.stage_threshold.astype(np.float32)
                         - STAGE_THRESHOLD_BIAS),
        stage_parent=spec.stage_parent.astype(np.int32),
        stage_next=spec.stage_next.astype(np.int32),
        stage_child=spec.stage_child.astype(np.int32),
    )


def truncate_cascade(c: CompiledCascade, n_stages: int) -> CompiledCascade:
    """Keep only the first ``n_stages`` stages."""
    spec = c.spec
    n = min(n_stages, spec.n_stages)
    spec2 = dataclasses.replace(
        spec,
        stage_clf_ofs=spec.stage_clf_ofs[:n],
        stage_clf_cnt=spec.stage_clf_cnt[:n],
        stage_threshold=spec.stage_threshold[:n],
        stage_parent=spec.stage_parent[:n],
        stage_next=np.where(spec.stage_next[:n] >= n, -1,
                            spec.stage_next[:n]),
        stage_child=np.where(spec.stage_child[:n] >= n, -1,
                             spec.stage_child[:n]),
    )
    return dataclasses.replace(
        c, spec=spec2,
        stage_threshold=c.stage_threshold[:n],
        stage_parent=c.stage_parent[:n],
        stage_next=np.where(c.stage_next[:n] >= n, -1, c.stage_next[:n]),
        stage_child=np.where(c.stage_child[:n] >= n, -1, c.stage_child[:n]),
    )


def scale_factors(window_w: int, window_h: int, img_w: int, img_h: int,
                  scale_factor: float,
                  min_size: Tuple[int, int] = (0, 0),
                  max_size: Optional[Tuple[int, int]] = None,
                  mode: str = "scale_cascade") -> List[float]:
    """Pyramid scale factors exactly like the reference.

    ``mode="scale_cascade"`` (tempcv.cpp:1345-1360): count factors while
    ``f*w0 < W-10 and f*h0 < H-10``; scales below ``min_size`` are skipped
    inside the loop (tempcv.cpp:1377-1382) and ``max_size`` is not
    consulted.  ``mode="scale_image"`` (tempcv.cpp:1268-1296): grow while
    the downscaled image still fits a base window; stop above
    ``max_size``, skip below ``min_size``."""
    out: List[float] = []
    f = 1.0
    if mode == "scale_cascade":
        while f * window_w < img_w - 10 and f * window_h < img_h - 10:
            win_w = int(cv_round(window_w * f))
            win_h = int(cv_round(window_h * f))
            if win_w >= min_size[0] and win_h >= min_size[1]:
                out.append(f)
            f *= scale_factor
        return out
    if mode != "scale_image":
        raise ValueError(f"unknown mode {mode!r}")
    if max_size is None or max_size[0] == 0 or max_size[1] == 0:
        max_size = (img_w, img_h)
    while True:
        win_w = int(cv_round(window_w * f))
        win_h = int(cv_round(window_h * f))
        sz_w = int(cv_round(img_w / f))
        sz_h = int(cv_round(img_h / f))
        if sz_w - window_w + 1 <= 0 or sz_h - window_h + 1 <= 0:
            break
        if win_w > max_size[0] or win_h > max_size[1]:
            break
        if win_w >= min_size[0] and win_h >= min_size[1]:
            out.append(f)
        f *= scale_factor
    return out


def scan_grid(img_w: int, img_h: int, win_w: int, win_h: int,
              factor: float) -> Tuple[float, np.ndarray, np.ndarray]:
    """Scale-cascade scan positions (tempcv.cpp:1362-1376, 1139-1146):
    ``(ystep, xs, ys)``, where the reference scans ``ix in [0, endX)`` at
    ``x = cvRound(ix*ystep)`` (and so for y), ``ystep = max(2, factor)``
    and ``endX = cvRound((W - winW)/ystep)``."""
    ystep = max(2.0, float(factor))
    end_x = int(cv_round((img_w - win_w) / ystep))
    end_y = int(cv_round((img_h - win_h) / ystep))
    ix = np.arange(max(end_x, 0), dtype=np.float64)
    iy = np.arange(max(end_y, 0), dtype=np.float64)
    return ystep, cv_round(ix * ystep).astype(np.int32), \
        cv_round(iy * ystep).astype(np.int32)
