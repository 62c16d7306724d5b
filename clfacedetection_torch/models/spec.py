"""Cascade model data structure (numpy, host side).

Port of ``clfacedetection_tpu/models/spec.py``: a ``CascadeSpec`` is the
flattened structure-of-arrays form of an OpenCV Haar cascade (stages ->
classifiers -> nodes with up to 3 weighted rects).  A node link ``> 0``
points at another node of the same classifier, a link ``<= 0`` is a leaf
that indexes the classifier's alphas as ``alpha[-link]``.

The port reads the ``.npz`` artifacts that the JAX package ships; XML
parsing is not part of this package yet.
"""

from __future__ import annotations

import dataclasses
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

    @classmethod
    def load(cls, path_or_file: Union[str, BinaryIO]) -> "CascadeSpec":
        """Read a ``.npz`` artifact written by the JAX package's
        ``CascadeSpec.save``."""
        with np.load(path_or_file, allow_pickle=False) as z:
            kwargs = {f: z[f] for f in ARRAY_FIELDS}
            name = str(z["__meta_name"])
            ww, wh = (int(v) for v in z["__meta_window"])
        return cls(name=name, window_w=ww, window_h=wh, **kwargs)
