"""Cascade model data structure (numpy, host side).

Port of ``clfacedetection_tpu/models/spec.py``: a ``CascadeSpec`` is the
flattened structure-of-arrays form of an OpenCV Haar cascade (stages ->
classifiers -> nodes with up to 3 weighted rects).  A node link ``> 0``
points at another node of the same classifier, a link ``<= 0`` is a leaf
that indexes the classifier's alphas as ``alpha[-link]``.

``.npz`` artifacts (``save``/``load``) carry the same field names and
dtypes as the JAX package's, so each package reads the other's files;
``models/haar_xml.py`` parses OpenCV's XML cascades into this form.
"""

from __future__ import annotations

import dataclasses
import io
from typing import BinaryIO, Union

import numpy as np

__all__ = ["MAX_RECTS", "ARRAY_FIELDS", "CascadeSpec"]

MAX_RECTS = 3

ARRAY_FIELDS = (
    "rect_x", "rect_y", "rect_w", "rect_h", "rect_weight", "tilted",
    "node_threshold", "left", "right",
    "clf_node_ofs", "clf_node_cnt", "clf_alpha_ofs", "alphas",
    "stage_clf_ofs", "stage_clf_cnt", "stage_threshold",
    "stage_parent", "stage_next", "stage_child",
)


@dataclasses.dataclass
class CascadeSpec:
    """Flattened (SoA) Haar cascade."""

    name: str
    window_w: int
    window_h: int

    rect_x: np.ndarray          # int16 [n_nodes, 3]
    rect_y: np.ndarray          # int16 [n_nodes, 3]
    rect_w: np.ndarray          # int16 [n_nodes, 3]  (0 => rect absent)
    rect_h: np.ndarray          # int16 [n_nodes, 3]
    rect_weight: np.ndarray     # float32 [n_nodes, 3] (0.0 => rect absent)
    tilted: np.ndarray          # bool [n_nodes]
    node_threshold: np.ndarray  # float32 [n_nodes]
    left: np.ndarray            # int32 [n_nodes]
    right: np.ndarray           # int32 [n_nodes]

    clf_node_ofs: np.ndarray    # int32 [n_clf]
    clf_node_cnt: np.ndarray    # int32 [n_clf]
    clf_alpha_ofs: np.ndarray   # int32 [n_clf]
    alphas: np.ndarray          # float32 [sum(clf_node_cnt + 1)]

    stage_clf_ofs: np.ndarray    # int32 [n_stages]
    stage_clf_cnt: np.ndarray    # int32 [n_stages]
    stage_threshold: np.ndarray  # float32 [n_stages] (raw, unbiased)
    stage_parent: np.ndarray     # int32 [n_stages] (-1 = none)
    stage_next: np.ndarray       # int32 [n_stages] (-1 = none)
    stage_child: np.ndarray      # int32 [n_stages] (-1 = none)

    @property
    def n_stages(self) -> int:
        return int(self.stage_clf_cnt.shape[0])

    @property
    def n_classifiers(self) -> int:
        return int(self.clf_node_cnt.shape[0])

    @property
    def n_nodes(self) -> int:
        return int(self.node_threshold.shape[0])

    @property
    def is_stump_based(self) -> bool:
        return bool(np.all(self.clf_node_cnt == 1))

    @property
    def has_tilted(self) -> bool:
        return bool(np.any(self.tilted))

    @property
    def is_tree(self) -> bool:
        return bool(np.any(self.stage_next != -1))

    @property
    def n_tilted_nodes(self) -> int:
        return int(np.count_nonzero(self.tilted))

    @property
    def max_stage_classifiers(self) -> int:
        return int(self.stage_clf_cnt.max())

    def stage_nodes(self, stage: int) -> np.ndarray:
        """Node indices belonging to ``stage`` (all its classifiers' nodes)."""
        c0 = int(self.stage_clf_ofs[stage])
        c1 = c0 + int(self.stage_clf_cnt[stage])
        out = []
        for c in range(c0, c1):
            n0 = int(self.clf_node_ofs[c])
            out.extend(range(n0, n0 + int(self.clf_node_cnt[c])))
        return np.asarray(out, dtype=np.int32)

    def validate(self) -> None:
        """Structural invariants (icvCreateHidHaarClassifierCascade's input
        checks, tempcv.cpp:340-390): every rect inside the base window,
        every link addressing a later node or a valid alpha."""
        n_nodes, n_clf, n_stages = self.n_nodes, self.n_classifiers, self.n_stages
        assert self.rect_x.shape == (n_nodes, MAX_RECTS)
        assert self.rect_weight.shape == (n_nodes, MAX_RECTS)
        assert self.clf_node_ofs.shape == (n_clf,)
        assert self.stage_clf_ofs.shape == (n_stages,)
        present = self.rect_weight != 0
        x, y = self.rect_x, self.rect_y
        w, h = self.rect_w, self.rect_h
        t = self.tilted[:, None]
        ww, wh = self.window_w, self.window_h
        ok_common = (w >= 0) & (h >= 0) & (y >= 0) & (x + w <= ww)
        ok_upright = (x >= 0) & (y + h <= wh)
        ok_tilted = (x - h >= 0) & (y + w + h <= wh)
        ok = ok_common & np.where(t, ok_tilted, ok_upright)
        if not bool(np.all(ok[present])):
            bad = np.argwhere(~ok & present)
            raise ValueError(f"{self.name}: rect(s) outside base window: {bad[:5]}")
        for c in range(n_clf):
            cnt = int(self.clf_node_cnt[c])
            n0 = int(self.clf_node_ofs[c])
            for k in range(cnt):
                for link in (int(self.left[n0 + k]), int(self.right[n0 + k])):
                    if link > 0:
                        if not (k < link < cnt):
                            raise ValueError(
                                f"{self.name}: clf {c} node {k} bad link {link}")
                    else:
                        if not (0 <= -link <= cnt):
                            raise ValueError(
                                f"{self.name}: clf {c} node {k} bad leaf {link}")

    def save(self, path_or_file: Union[str, BinaryIO]) -> None:
        """Write a compressed ``.npz`` artifact."""
        arrays = {f: getattr(self, f) for f in ARRAY_FIELDS}
        arrays["__meta_name"] = np.array(self.name)
        arrays["__meta_window"] = np.array([self.window_w, self.window_h],
                                           dtype=np.int32)
        np.savez_compressed(path_or_file, **arrays)

    @classmethod
    def load(cls, path_or_file: Union[str, BinaryIO]) -> "CascadeSpec":
        """Read a ``.npz`` artifact (this package's ``save`` or the JAX
        package's)."""
        with np.load(path_or_file, allow_pickle=False) as z:
            kwargs = {f: z[f] for f in ARRAY_FIELDS}
            name = str(z["__meta_name"])
            ww, wh = (int(v) for v in z["__meta_window"])
        return cls(name=name, window_w=ww, window_h=wh, **kwargs)

    def clone(self) -> "CascadeSpec":
        """Deep copy (icvCloneHaarClassifier, tempcv.cpp:2198)."""
        kwargs = {f: getattr(self, f).copy() for f in ARRAY_FIELDS}
        return CascadeSpec(name=self.name, window_w=self.window_w,
                           window_h=self.window_h, **kwargs)

    def to_bytes(self) -> bytes:
        buf = io.BytesIO()
        self.save(buf)
        return buf.getvalue()

    @classmethod
    def from_bytes(cls, data: bytes) -> "CascadeSpec":
        return cls.load(io.BytesIO(data))
