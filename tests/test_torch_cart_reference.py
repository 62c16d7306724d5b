"""The port's CART path (the front's tree view and the walk tail's plain
twin) against the benchmark's plain reference (``portbench/reference/``),
on the CPU at small frames of the benchmark's own ``photo_scene``.

Cascades: seeded random ones built with ``models/spec.py`` and saved as
``.npz`` (trees of 2 and of 3 nodes, one upright and one with tilted
rects, 3-4 stages), and the benchmark's frozen ``frontalface_alt2``.
In float64 the candidates and the windows entering each stage (of the
first frame) equal the reference's; in float32 (the walk's plain twin, which the card matches
bit for bit) ``cand_gap`` and ``box_gap`` stay under the limits of the
cell ``alt2-1080p-stream-photo``; a batch of 2 through ``detect_stream``
gives each frame the candidates of the single-frame call.  Nothing here
imports JAX."""

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from clfacedetection_torch import (BatchedPyramidDetector,  # noqa: E402
                                   PyramidDetector, load_cascade)
from clfacedetection_torch.models.spec import CascadeSpec  # noqa: E402
from portbench.harness import frames  # noqa: E402
from portbench.harness.cell import gaps, load  # noqa: E402
from portbench.reference.cascade import Cascade  # noqa: E402
from portbench.reference.detect import detect  # noqa: E402

torch.set_num_threads(1)

SHAPE = (96, 128)
CFG = dict(mode="scale_image", scale_factor=1.1, min_neighbors=3,
           min_size=(20, 20))
LIMITS = load("workloads", "alt2-1080p-stream-photo")["limits"]
ALT2 = os.path.join(ROOT, "portbench", "data", "cascades",
                    "haarcascade_frontalface_alt2.npz")
# the random cascades: (seed, nodes a tree, tilted rects, stages)
RANDOM = {"cart2": (3, 2, False, 4), "cart3_tilted": (5, 3, True, 3)}


def _tree_spec(seed: int, depth: int, tilted: bool, n_stages: int,
               w0: int = 20, h0: int = 20) -> CascadeSpec:
    """A random cascade of CART trees of ``depth`` nodes: node k branches
    to node k + 1 on a side drawn from the seed and to a leaf on the
    other; the last node to two leaves.  Rects: a box and a half-size
    box inside it, weighted to zero mean; with ``tilted`` about a third
    of the nodes' rects tilted.  Stage thresholds let about half the
    windows through a stage."""
    rng = np.random.default_rng(seed)
    rx, ry, rw, rh, wt, tl, thr, left, right = ([] for _ in range(9))
    clf_ofs, clf_cnt, alpha_ofs, alphas = [], [], [], []
    st_ofs, st_cnt, st_thr = [], [], []
    for _ in range(n_stages):
        ncl = int(rng.integers(3, 7))
        st_ofs.append(len(clf_ofs))
        st_cnt.append(ncl)
        leaf_mean = 0.0
        for _ in range(ncl):
            clf_ofs.append(len(thr))
            clf_cnt.append(depth)
            alpha_ofs.append(len(alphas))
            for k in range(depth):
                t = tilted and rng.random() < 0.35
                if t:
                    w, h = int(rng.integers(2, 6)), int(rng.integers(2, 5))
                    x = int(rng.integers(h, w0 - w + 1))
                    y = int(rng.integers(0, h0 - w - h + 1))
                else:
                    w, h = int(rng.integers(4, w0 - 1)), \
                        int(rng.integers(4, h0 - 1))
                    x = int(rng.integers(0, w0 - w + 1))
                    y = int(rng.integers(0, h0 - h + 1))
                w1, h1 = max(1, w // 2), max(1, h // 2)
                x1 = x + int(rng.integers(0, w - w1 + 1))
                y1 = y + int(rng.integers(0, h - h1 + 1))
                rx.append([x, x1, 0])
                ry.append([y, y1, 0])
                rw.append([w, w1, 0])
                rh.append([h, h1, 0])
                wt.append([-1.0 / (w * h), 2.0 / (w1 * h1), 0.0])
                tl.append(t)
                thr.append(float(rng.normal(0.0, 0.01)))
                if k + 1 < depth:
                    a, b = k + 1, -k
                    if rng.random() < 0.5:
                        a, b = b, a
                else:
                    a, b = -k, -(k + 1)
                left.append(a)
                right.append(b)
            leaf = rng.uniform(-1.0, 1.0, depth + 1)
            alphas.extend(leaf.tolist())
            leaf_mean += float(np.median(leaf))
        st_thr.append(leaf_mean)
    spec = CascadeSpec(
        name=f"cart{depth}_{seed}", window_w=w0, window_h=h0,
        rect_x=np.array(rx, np.int16), rect_y=np.array(ry, np.int16),
        rect_w=np.array(rw, np.int16), rect_h=np.array(rh, np.int16),
        rect_weight=np.array(wt, np.float32), tilted=np.array(tl, bool),
        node_threshold=np.array(thr, np.float32),
        left=np.array(left, np.int32), right=np.array(right, np.int32),
        clf_node_ofs=np.array(clf_ofs, np.int32),
        clf_node_cnt=np.array(clf_cnt, np.int32),
        clf_alpha_ofs=np.array(alpha_ofs, np.int32),
        alphas=np.array(alphas, np.float32),
        stage_clf_ofs=np.array(st_ofs, np.int32),
        stage_clf_cnt=np.array(st_cnt, np.int32),
        stage_threshold=np.array(st_thr, np.float32),
        stage_parent=np.full(n_stages, -1, np.int32),
        stage_next=np.full(n_stages, -1, np.int32),
        stage_child=np.full(n_stages, -1, np.int32))
    spec.validate()
    return spec


@pytest.fixture(scope="module", params=["alt2", *RANDOM])
def case(request, tmp_path_factory):
    """(the cascade's file, the front's stages, two frames, the
    reference's float64 detections of them).  alt2 runs at the default
    front of 4 stages; the random cascades at 2, so that the walk takes
    half their stages."""
    if request.param == "alt2":
        path, front = ALT2, 4
    else:
        path = str(tmp_path_factory.mktemp("cart") / f"{request.param}.npz")
        _tree_spec(*RANDOM[request.param]).save(path)
        front = 2
    gray = np.stack([frames.photo_scene(SHAPE, (30, 44), s) for s in (1, 2)])
    refs = detect(Cascade(path), torch.from_numpy(gray), CFG, "float64")
    return path, front, gray, refs


def _det(path, front, dtype):
    return PyramidDetector(load_cascade(path), SHAPE, CFG["scale_factor"],
                           CFG["min_size"], front_stages=front, dtype=dtype,
                           device="cpu")


def _rows(a):
    return sorted(map(tuple, np.asarray(a).reshape(-1, 4).tolist()))


def test_float64_equals_the_reference(case):
    path, front, gray, refs = case
    det = _det(path, front, torch.float64)
    assert det.walk_tail
    for g, ref in zip(gray, refs):
        cand, overflow = det.candidates(g)
        assert not overflow
        assert _rows(cand) == _rows(ref.candidates)
    # one frame's counts: the plain front's 20 dense stages of alt2 take
    # seconds a frame on the CPU
    assert np.array_equal(det.stage_entering_counts(gray[0]),
                          refs[0].entering)
    # the walk has work: windows enter its stages and some are accepted
    assert refs[0].entering[front] > 0 and len(refs[0].candidates) > 0


def test_float32_within_the_cell_limits(case):
    path, front, gray, refs = case
    det = _det(path, front, torch.float32)
    for g, ref in zip(gray, refs):
        r = det.detect(g, CFG["min_neighbors"])
        got = gaps((r.candidates, r.boxes, r.neighbors), ref)
        for k, limit in LIMITS.items():
            assert got[k] <= limit, (k, got[k])


def test_stream_batch_equals_single_frames(case):
    path, front, gray, _ = case
    det = BatchedPyramidDetector(load_cascade(path), SHAPE, 2,
                                 scale_factor=CFG["scale_factor"],
                                 min_size=CFG["min_size"],
                                 front_stages=front, device="cpu")
    out = list(det.detect_stream(iter([gray, gray[::-1].copy()]),
                                 CFG["min_neighbors"], depth=2,
                                 threaded=True))
    single = _det(path, front, torch.float32)
    want = [_rows(single.candidates(g)[0]) for g in gray]
    assert [_rows(r.candidates) for r in out[0]] == want
    assert [_rows(r.candidates) for r in out[1]] == want[::-1]
