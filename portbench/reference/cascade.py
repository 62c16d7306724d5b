"""A Haar cascade read from its ``.npz`` file, compiled as OpenCV 2.4 does.

The file holds the flattened cascade: nodes with up to three weighted
rects, classifiers (CART trees of nodes, a stump being a tree of one
node) with their leaf values, and stages with their thresholds.  A node
link ``> 0`` is another node of the classifier, a link ``<= 0`` the leaf
value ``alphas[alpha_ofs - link]``.

``Cascade`` applies what ``icvCreateHidHaarClassifierCascade`` does
(tempcv.cpp:307-536): a third rect of zero size or weight is dropped, and
the stage threshold loses its bias of 1e-4 in float32.  ``at_scale``
scales the features as ``cvSetImagesForHaarClassifierCascade`` does
(tempcv.cpp:549-768): rounded rects, the variance rect (1, 1, w - 2,
h - 2), weights divided by its area (tilted rects by twice it) and the
first rect's weight set so that each feature has zero mean.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["Cascade", "Scaled", "cv_round"]

STAGE_THRESHOLD_BIAS = np.float32(0.0001)


def cv_round(x) -> np.ndarray:
    """cvRound: half to even."""
    return np.rint(x).astype(np.int64)


@dataclasses.dataclass(frozen=True)
class Scaled:
    """The features at one scale: four integral corners a rect, signed
    + - - +, as (y, x) offsets from a window's top-left corner."""

    scale: float
    win_w: int
    win_h: int
    inv_area: float
    equ_y: np.ndarray      # int64 [4]
    equ_x: np.ndarray      # int64 [4]
    corner_y: np.ndarray   # int64 [n_nodes, 3, 4]
    corner_x: np.ndarray   # int64 [n_nodes, 3, 4]
    weight: np.ndarray     # float32 [n_nodes, 3], 0 where a rect is absent


class Cascade:
    """One cascade file, compiled (scale-independent tables)."""

    def __init__(self, path: str):
        with np.load(path, allow_pickle=False) as z:
            a = {k: z[k] for k in z.files}
        self.name = str(a["__meta_name"])
        self.window_w, self.window_h = (int(v) for v in a["__meta_window"])
        w = a["rect_weight"].astype(np.float32).copy()
        rx, ry, rw, rh = (a[k].astype(np.int64).copy()
                          for k in ("rect_x", "rect_y", "rect_w", "rect_h"))
        drop = (np.abs(w[:, 2]) < np.finfo(np.float64).eps) \
            | (rw[:, 2] == 0) | (rh[:, 2] == 0)
        for arr in (w, rx, ry, rw, rh):
            arr[:, 2] = np.where(drop, 0, arr[:, 2])
        self.rect_weight, self.rect_x, self.rect_y = w, rx, ry
        self.rect_w, self.rect_h = rw, rh
        self.tilted = a["tilted"].astype(bool)
        self.node_threshold = a["node_threshold"].astype(np.float32)
        self.left = a["left"].astype(np.int64)
        self.right = a["right"].astype(np.int64)
        self.clf_node_ofs = a["clf_node_ofs"].astype(np.int64)
        self.clf_node_cnt = a["clf_node_cnt"].astype(np.int64)
        self.clf_alpha_ofs = a["clf_alpha_ofs"].astype(np.int64)
        self.alphas = a["alphas"].astype(np.float32)
        self.stage_clf_ofs = a["stage_clf_ofs"].astype(np.int64)
        self.stage_clf_cnt = a["stage_clf_cnt"].astype(np.int64)
        self.stage_threshold = (a["stage_threshold"].astype(np.float32)
                                - STAGE_THRESHOLD_BIAS)
        self.is_tree = bool(np.any(a["stage_next"] != -1))
        self.n_stages = int(self.stage_clf_cnt.shape[0])
        self.has_tilted = bool(self.tilted.any())

    def stage_classifiers(self, s: int) -> np.ndarray:
        c0 = int(self.stage_clf_ofs[s])
        return np.arange(c0, c0 + int(self.stage_clf_cnt[s]))

    def stage_rects(self, s: int) -> int:
        """Rects of nonzero weight in stage ``s``'s nodes."""
        n = 0
        for c in self.stage_classifiers(s):
            n0, cnt = int(self.clf_node_ofs[c]), int(self.clf_node_cnt[c])
            n += int((self.rect_weight[n0:n0 + cnt] != 0).sum())
        return n

    def stage_nodes(self, s: int) -> int:
        return int(self.clf_node_cnt[self.stage_classifiers(s)].sum())

    def at_scale(self, scale: float) -> Scaled:
        s = float(scale)
        win_w = int(cv_round(self.window_w * s))
        win_h = int(cv_round(self.window_h * s))
        e0 = int(cv_round(s))
        ew = int(cv_round((self.window_w - 2) * s))
        eh = int(cv_round((self.window_h - 2) * s))
        inv_area = 1.0 / (ew * eh)
        equ_y = np.array([e0, e0, e0 + eh, e0 + eh], np.int64)
        equ_x = np.array([e0, e0 + ew, e0, e0 + ew], np.int64)
        tx, ty = cv_round(self.rect_x * s), cv_round(self.rect_y * s)
        tw, th = cv_round(self.rect_w * s), cv_round(self.rect_h * s)
        present = self.rect_weight != 0.0
        corr = np.where(self.tilted, 0.5 * inv_area, inv_area)
        w = (self.rect_weight.astype(np.float64) * corr[:, None]) \
            .astype(np.float32)
        area = (tw * th).astype(np.float64)
        rest = np.where(present[:, 1:],
                        w[:, 1:].astype(np.float64) * area[:, 1:], 0.0)
        w[:, 0] = (-rest.sum(axis=1) / area[:, 0]).astype(np.float32)
        w = np.where(present, w, np.float32(0.0))
        up = ~self.tilted[:, None]
        cy = np.stack([ty, np.where(up, ty, ty + th),
                       np.where(up, ty + th, ty + tw),
                       np.where(up, ty + th, ty + tw + th)], axis=-1)
        cx = np.stack([tx, np.where(up, tx + tw, tx - th),
                       np.where(up, tx, tx + tw),
                       np.where(up, tx + tw, tx + tw - th)], axis=-1)
        cy = np.where(present[..., None], cy, 0)
        cx = np.where(present[..., None], cx, 0)
        return Scaled(s, win_w, win_h, inv_area, equ_y, equ_x, cy, cx, w)


def scale_factors(c: Cascade, img_w: int, img_h: int, scale_factor: float,
                  min_size, mode: str) -> list:
    """The pyramid's factors (tempcv.cpp:1268-1296 for scale-image,
    1345-1382 for scale-cascade); no maximum size."""
    out = []
    f = 1.0
    w0, h0 = c.window_w, c.window_h
    while True:
        win_w, win_h = int(cv_round(w0 * f)), int(cv_round(h0 * f))
        if mode == "scale_cascade":
            if not (f * w0 < img_w - 10 and f * h0 < img_h - 10):
                return out
        else:
            if (int(cv_round(img_w / f)) - w0 + 1 <= 0
                    or int(cv_round(img_h / f)) - h0 + 1 <= 0
                    or win_w > img_w or win_h > img_h):
                return out
        if win_w >= min_size[0] and win_h >= min_size[1]:
            out.append(f)
        f *= scale_factor
