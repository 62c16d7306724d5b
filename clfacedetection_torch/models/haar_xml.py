"""OpenCV Haar-cascade XML parsers -> :class:`CascadeSpec`.

A copy of ``clfacedetection_tpu/models/haar_xml.py`` (numpy only), kept in
this package so that it never imports the JAX package. A parse here equals
the JAX package's parse of the same bytes, array for array and dtype for
dtype.

Two on-disk dialects are supported:

* **Old format** (``type_id="opencv-haar-classifier"``) — the 2002-2012
  format used by all 19 models bundled with the reference
  (``haarcascade_*.xml``): ``<stages> -> <trees> -> nodes`` with
  ``<feature><rects>``, ``<tilted>``, ``<threshold>``,
  ``<left_val|left_node>``, ``<right_val|right_node>``,
  ``<stage_threshold>``, ``<parent>``, ``<next>``.  Parsing semantics
  replicate ``icvReadHaarClassifier`` (reference ``tempcv.cpp:1749-2089``):
  alphas are assembled in leaf-appearance order (left leaf before right
  leaf, nodes in order; ``count + 1`` alphas per classifier), node links
  ``<= 0`` encode leaves as ``alpha[-link]``, stage ``parent`` defaults to
  ``i - 1``, ``next`` to ``-1``, and ``child`` is the first stage whose
  parent is the current stage (``tempcv.cpp:2056-2082``).

* **New format** (``type_id="opencv-cascade-classifier"``) — the format
  OpenCV >= 2.4 ships in ``cv2.data.haarcascades``; stages hold
  ``<weakClassifiers>`` with ``<internalNodes>`` (left, right, featureIdx,
  threshold) and ``<leafValues>``, features live in a shared ``<features>``
  table.  We re-encode into the same :class:`CascadeSpec` link convention.

This is a from-scratch parser (pure Python / ElementTree); it shares no code
with OpenCV's CvFileStorage machinery.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import List, Optional

import numpy as np

from .spec import MAX_RECTS, CascadeSpec

__all__ = ["parse_haar_xml", "parse_haar_xml_bytes"]


def parse_haar_xml(path: str, name: Optional[str] = None) -> CascadeSpec:
    """Parse an OpenCV Haar cascade XML file (old or new format)."""
    with open(path, "rb") as f:
        data = f.read()
    return parse_haar_xml_bytes(data, name or _name_from_path(path))


def parse_haar_xml_bytes(data: bytes, name: str = "cascade") -> CascadeSpec:
    return _parse_root(ET.fromstring(_strip_comments(data)), name)


def _strip_comments(data: bytes) -> bytes:
    """Remove XML comments byte-wise.

    Several bundled models (the mcs_* family) carry headers like
    ``<!-----------`` whose interior ``--`` runs violate strict XML; OpenCV's
    CvFileStorage reader tolerates them, so we strip comments before handing
    the document to ElementTree.
    """
    out = []
    pos = 0
    while True:
        start = data.find(b"<!--", pos)
        if start == -1:
            out.append(data[pos:])
            break
        out.append(data[pos:start])
        end = data.find(b"-->", start + 4)
        if end == -1:
            break  # unterminated comment: drop the remainder
        pos = end + 3
    return b"".join(out)


def _name_from_path(path: str) -> str:
    base = path.rsplit("/", 1)[-1]
    return base[:-4] if base.endswith(".xml") else base


def _parse_root(root: ET.Element, name: str) -> CascadeSpec:
    if root.tag != "opencv_storage":
        raise ValueError(f"not an OpenCV storage XML (root <{root.tag}>)")
    for child in root:
        type_id = child.get("type_id", "")
        if type_id == "opencv-haar-classifier":
            return _parse_old_format(child, name)
        if type_id == "opencv-cascade-classifier":
            return _parse_new_format(child, name)
    raise ValueError("no Haar cascade node found in XML")


# --------------------------------------------------------------------------
# shared builder
# --------------------------------------------------------------------------

class _Builder:
    """Accumulates flattened node/classifier/stage rows."""

    def __init__(self) -> None:
        self.rect_x: List[List[int]] = []
        self.rect_y: List[List[int]] = []
        self.rect_w: List[List[int]] = []
        self.rect_h: List[List[int]] = []
        self.rect_weight: List[List[float]] = []
        self.tilted: List[bool] = []
        self.node_threshold: List[float] = []
        self.left: List[int] = []
        self.right: List[int] = []
        self.clf_node_ofs: List[int] = []
        self.clf_node_cnt: List[int] = []
        self.clf_alpha_ofs: List[int] = []
        self.alphas: List[float] = []
        self.stage_clf_ofs: List[int] = []
        self.stage_clf_cnt: List[int] = []
        self.stage_threshold: List[float] = []
        self.stage_parent: List[int] = []
        self.stage_next: List[int] = []

    def add_node(self, rects, tilted: bool, threshold: float,
                 left: int, right: int) -> None:
        xs, ys, ws, hs, wts = [], [], [], [], []
        for (x, y, w, h, wt) in rects:
            xs.append(x); ys.append(y); ws.append(w); hs.append(h); wts.append(wt)
        while len(xs) < MAX_RECTS:
            xs.append(0); ys.append(0); ws.append(0); hs.append(0); wts.append(0.0)
        self.rect_x.append(xs); self.rect_y.append(ys)
        self.rect_w.append(ws); self.rect_h.append(hs)
        self.rect_weight.append(wts)
        self.tilted.append(tilted)
        self.node_threshold.append(threshold)
        self.left.append(left)
        self.right.append(right)

    def finish(self, name: str, window_w: int, window_h: int) -> CascadeSpec:
        n_stages = len(self.stage_clf_cnt)
        parent = np.asarray(self.stage_parent, dtype=np.int32)
        nxt = np.asarray(self.stage_next, dtype=np.int32)
        # child = first stage whose parent is this stage (tempcv.cpp:2078-2082)
        child = np.full(n_stages, -1, dtype=np.int32)
        for i in range(n_stages):
            p = int(parent[i])
            if p != -1 and child[p] == -1:
                child[p] = i
        spec = CascadeSpec(
            name=name, window_w=window_w, window_h=window_h,
            rect_x=np.asarray(self.rect_x, dtype=np.int16),
            rect_y=np.asarray(self.rect_y, dtype=np.int16),
            rect_w=np.asarray(self.rect_w, dtype=np.int16),
            rect_h=np.asarray(self.rect_h, dtype=np.int16),
            rect_weight=np.asarray(self.rect_weight, dtype=np.float32),
            tilted=np.asarray(self.tilted, dtype=bool),
            node_threshold=np.asarray(self.node_threshold, dtype=np.float32),
            left=np.asarray(self.left, dtype=np.int32),
            right=np.asarray(self.right, dtype=np.int32),
            clf_node_ofs=np.asarray(self.clf_node_ofs, dtype=np.int32),
            clf_node_cnt=np.asarray(self.clf_node_cnt, dtype=np.int32),
            clf_alpha_ofs=np.asarray(self.clf_alpha_ofs, dtype=np.int32),
            alphas=np.asarray(self.alphas, dtype=np.float32),
            stage_clf_ofs=np.asarray(self.stage_clf_ofs, dtype=np.int32),
            stage_clf_cnt=np.asarray(self.stage_clf_cnt, dtype=np.int32),
            stage_threshold=np.asarray(self.stage_threshold, dtype=np.float32),
            stage_parent=parent,
            stage_next=nxt,
            stage_child=child,
        )
        spec.validate()
        return spec


# --------------------------------------------------------------------------
# old format
# --------------------------------------------------------------------------

def _text(el: Optional[ET.Element]) -> str:
    if el is None or el.text is None:
        raise ValueError("malformed cascade XML: missing element text")
    return el.text.strip()


def _parse_rect_line(line: str):
    parts = line.split()
    if len(parts) != 5:
        raise ValueError(f"rect must have 5 entries, got {line!r}")
    x, y, w, h = (int(p) for p in parts[:4])
    return (x, y, w, h, float(parts[4]))


def _parse_old_format(casc: ET.Element, name: str) -> CascadeSpec:
    size = _text(casc.find("size")).split()
    window_w, window_h = int(size[0]), int(size[1])
    stages_el = casc.find("stages")
    if stages_el is None:
        raise ValueError("old-format cascade without <stages>")

    b = _Builder()
    for i, stage_el in enumerate(stages_el):
        trees_el = stage_el.find("trees")
        if trees_el is None:
            raise ValueError(f"stage {i} without <trees>")
        b.stage_clf_ofs.append(len(b.clf_node_cnt))
        n_trees = 0
        for tree_el in trees_el:
            n_trees += 1
            node_els = list(tree_el)
            count = len(node_els)
            b.clf_node_ofs.append(len(b.node_threshold))
            b.clf_node_cnt.append(count)
            b.clf_alpha_ofs.append(len(b.alphas))
            alphas = [0.0] * (count + 1)
            last_idx = 0
            for k, node_el in enumerate(node_els):
                feature_el = node_el.find("feature")
                rects_el = feature_el.find("rects")
                rects = [_parse_rect_line(_text(r)) for r in rects_el]
                if not 2 <= len(rects) <= MAX_RECTS:
                    raise ValueError(f"node with {len(rects)} rects")
                tilted = int(_text(feature_el.find("tilted"))) != 0
                threshold = float(_text(node_el.find("threshold")))

                # left: node index or new leaf (tempcv.cpp:1985-2010)
                left_node = node_el.find("left_node")
                if left_node is not None:
                    left = int(_text(left_node))
                    if not (k < left < count):
                        raise ValueError(f"bad left_node {left} at node {k}")
                else:
                    if last_idx >= count + 1:
                        raise ValueError("too many leaves")
                    left = -last_idx
                    alphas[last_idx] = float(_text(node_el.find("left_val")))
                    last_idx += 1
                right_node = node_el.find("right_node")
                if right_node is not None:
                    right = int(_text(right_node))
                    if not (k < right < count):
                        raise ValueError(f"bad right_node {right} at node {k}")
                else:
                    if last_idx >= count + 1:
                        raise ValueError("too many leaves")
                    right = -last_idx
                    alphas[last_idx] = float(_text(node_el.find("right_val")))
                    last_idx += 1
                b.add_node(rects, tilted, threshold, left, right)
            if last_idx != count + 1:
                raise ValueError(
                    f"classifier has {last_idx} leaves, expected {count + 1}")
            b.alphas.extend(alphas)
        b.stage_clf_cnt.append(n_trees)
        b.stage_threshold.append(float(_text(stage_el.find("stage_threshold"))))
        parent_el = stage_el.find("parent")
        next_el = stage_el.find("next")
        b.stage_parent.append(int(_text(parent_el)) if parent_el is not None else i - 1)
        b.stage_next.append(int(_text(next_el)) if next_el is not None else -1)

    return b.finish(name, window_w, window_h)


# --------------------------------------------------------------------------
# new format (opencv-cascade-classifier)
# --------------------------------------------------------------------------

def _parse_new_format(casc: ET.Element, name: str) -> CascadeSpec:
    feature_type = _text(casc.find("featureType"))
    if feature_type != "HAAR":
        raise ValueError(f"only HAAR cascades supported, got {feature_type}")
    window_w = int(_text(casc.find("width")))
    window_h = int(_text(casc.find("height")))

    # shared feature table
    features = []
    for feat_el in casc.find("features"):
        rects = [_parse_rect_line(_text(r)) for r in feat_el.find("rects")]
        tilted_el = feat_el.find("tilted")
        tilted = tilted_el is not None and int(_text(tilted_el)) != 0
        features.append((rects, tilted))

    b = _Builder()
    for i, stage_el in enumerate(casc.find("stages")):
        b.stage_clf_ofs.append(len(b.clf_node_cnt))
        weak_els = list(stage_el.find("weakClassifiers"))
        for weak_el in weak_els:
            internal = _text(weak_el.find("internalNodes")).split()
            leaves = [float(v) for v in _text(weak_el.find("leafValues")).split()]
            if len(internal) % 4 != 0:
                raise ValueError("internalNodes length not a multiple of 4")
            count = len(internal) // 4
            b.clf_node_ofs.append(len(b.node_threshold))
            b.clf_node_cnt.append(count)
            b.clf_alpha_ofs.append(len(b.alphas))
            for k in range(count):
                l_raw = int(internal[4 * k + 0])
                r_raw = int(internal[4 * k + 1])
                feat_idx = int(internal[4 * k + 2])
                threshold = float(internal[4 * k + 3])
                # new format: negative link encodes leaf index -(v) - 1;
                # re-encode as alpha[-link] with our (old-format) convention.
                left = l_raw if l_raw > 0 else -(-l_raw - 1)
                right = r_raw if r_raw > 0 else -(-r_raw - 1)
                rects, tilted = features[feat_idx]
                b.add_node(rects, tilted, threshold, left, right)
            # our convention stores count+1 alphas per classifier; new-format
            # trees have exactly count+1 leaves for full binary CARTs, but
            # stumps also have 2 = count+1. Pad defensively.
            alphas = list(leaves) + [0.0] * max(0, (count + 1) - len(leaves))
            b.alphas.extend(alphas[:count + 1])
        b.stage_clf_cnt.append(len(weak_els))
        b.stage_threshold.append(float(_text(stage_el.find("stageThreshold"))))
        b.stage_parent.append(i - 1)
        b.stage_next.append(-1)

    return b.finish(name, window_w, window_h)
