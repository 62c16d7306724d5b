"""Legacy haartraining text-format cascade I/O.

A copy of ``clfacedetection_tpu/models/cart_text.py`` (numpy only), kept in
this package so that it never imports the JAX package. It builds through
this package's own ``_Builder``.

The oldest OpenCV cascade format: a directory of per-stage
``<n>/AdaBoostCARTHaarClassifier.txt`` files, loaded by
``cvLoadHaarClassifierCascade(directory, window_size)`` via
``icvLoadCascadeCART`` (reference tempcv.cpp:1520-1699).  The window size
is supplied by the caller, not stored in the files.

Per-stage token stream (whitespace-separated, tempcv.cpp:1536-1625):

    n_classifiers
    { n_nodes
      { n_rects { x y w h band weight } x n_rects   ("band" is ignored)
        "tilted" | anything-else
        node_threshold left right }
      x n_nodes
      alpha x (n_nodes + 1) }
    x n_classifiers
    stage_threshold [parent next]     (defaults: parent = i-1, next = -1)

A writer is provided so the format round-trips (the reference never
writes it; haartraining did).
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import numpy as np

from .haar_xml import _Builder
from .spec import MAX_RECTS, CascadeSpec

__all__ = ["parse_cart_text", "load_cascade_directory", "cart_text_stages"]


def parse_cart_text(stage_texts: Sequence[str],
                    window_size: Tuple[int, int],
                    name: str = "cascade") -> CascadeSpec:
    """Parse per-stage token streams (icvLoadCascadeCART semantics)."""
    b = _Builder()
    for i, text in enumerate(stage_texts):
        toks = text.split()
        pos = 0

        def take(n=1):
            nonlocal pos
            out = toks[pos:pos + n]
            if len(out) != n:
                raise ValueError(f"stage {i}: truncated token stream")
            pos += n
            return out

        n_clf = int(take()[0])
        if n_clf <= 0:
            raise ValueError(f"stage {i}: classifier count {n_clf}")
        b.stage_clf_ofs.append(len(b.clf_node_cnt))
        for _j in range(n_clf):
            count = int(take()[0])
            b.clf_node_ofs.append(len(b.node_threshold))
            b.clf_node_cnt.append(count)
            b.clf_alpha_ofs.append(len(b.alphas))
            for _l in range(count):
                rects = int(take()[0])
                if not 2 <= rects <= MAX_RECTS:
                    raise ValueError(f"stage {i}: {rects} rects")
                rlist = []
                for _k in range(rects):
                    x, y, w, h, _band, wt = take(6)
                    rlist.append((int(x), int(y), int(w), int(h),
                                  float(wt)))
                tilted = take()[0].startswith("tilted")
                thr, left, right = take(3)
                b.add_node(rlist, tilted, float(thr), int(left), int(right))
            b.alphas.extend(float(v) for v in take(count + 1))
        b.stage_threshold.append(float(take()[0]))
        # optional tree links (tempcv.cpp:1612-1617)
        if pos + 2 <= len(toks):
            b.stage_parent.append(int(take()[0]))
            b.stage_next.append(int(take()[0]))
        else:
            b.stage_parent.append(i - 1)
            b.stage_next.append(-1)
        b.stage_clf_cnt.append(n_clf)

    return b.finish(name, window_size[0], window_size[1])


def load_cascade_directory(directory: str,
                           window_size: Tuple[int, int]) -> CascadeSpec:
    """cvLoadHaarClassifierCascade's directory mode (tempcv.cpp:1639-1661):
    read consecutive ``<n>/AdaBoostCARTHaarClassifier.txt`` stage files."""
    stages: List[str] = []
    n = 0
    while True:
        path = os.path.join(directory, str(n),
                            "AdaBoostCARTHaarClassifier.txt")
        if not os.path.isfile(path):
            break
        with open(path) as f:
            stages.append(f.read())
        n += 1
    if n == 0:
        raise FileNotFoundError(
            f"no <n>/AdaBoostCARTHaarClassifier.txt stages under "
            f"{directory!r}")
    return parse_cart_text(
        stages, window_size, name=os.path.basename(directory.rstrip("/")))


def cart_text_stages(spec: CascadeSpec) -> List[str]:
    """Serialize a cascade to per-stage text blobs (round-trips through
    :func:`parse_cart_text`)."""
    out: List[str] = []
    for s in range(spec.n_stages):
        toks: List[str] = [str(int(spec.stage_clf_cnt[s]))]
        c0 = int(spec.stage_clf_ofs[s])
        for c in range(c0, c0 + int(spec.stage_clf_cnt[s])):
            cnt = int(spec.clf_node_cnt[c])
            toks.append(str(cnt))
            n0 = int(spec.clf_node_ofs[c])
            a0 = int(spec.clf_alpha_ofs[c])
            for k in range(cnt):
                node = n0 + k
                nr = 3 if spec.rect_weight[node, 2] != 0 else 2
                toks.append(str(nr))
                for r in range(nr):
                    toks.extend([
                        str(int(spec.rect_x[node, r])),
                        str(int(spec.rect_y[node, r])),
                        str(int(spec.rect_w[node, r])),
                        str(int(spec.rect_h[node, r])),
                        "0",
                        repr(float(np.float32(spec.rect_weight[node, r])))])
                toks.append("tilted" if spec.tilted[node] else "upright")
                toks.extend([
                    repr(float(np.float32(spec.node_threshold[node]))),
                    str(int(spec.left[node])), str(int(spec.right[node]))])
            toks.extend(repr(float(np.float32(a)))
                        for a in spec.alphas[a0:a0 + cnt + 1])
        toks.append(repr(float(np.float32(spec.stage_threshold[s]))))
        toks.extend([str(int(spec.stage_parent[s])),
                     str(int(spec.stage_next[s]))])
        out.append(" ".join(toks))
    return out
