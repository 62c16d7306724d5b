"""The port's ``strategy="direct"`` (node values from one stencil matrix
product, ``ops/stencil.py``, then ``tail_rows``) against the JAX
package's ``strategy="direct"`` on the CPU (its XLA tail).

Its stencils are EQUAL to JAX's.  Candidates: float64 box for box with
JAX float64; float32 within the docs/PARITY.md bounds (candidate Jaccard
>= 0.995, grouped boxes 1:1 at IoU >= 0.9).  Its node values (one f64
product, another summation order than the rect order) against the v1
tail's exact int32-corner values within 1e-9 of each node's largest
magnitude, tilted planes included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clfacedetection_tpu.detect.pyramid import PyramidDetector as JDet
from clfacedetection_tpu.models import load_cascade as j_load_cascade
from clfacedetection_tpu.utils import synth_face, synth_scene

import clfacedetection_torch as ct
from clfacedetection_torch import trace
from clfacedetection_torch.detect import pyramid as tpyramid
from clfacedetection_torch.ops import haar_tail, stencil

# The suite runs in several worker processes at once; one torch thread
# each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

SHAPE = (120, 160)


def _set(c):
    return set(map(tuple, np.asarray(c)))


def _iou(a, b):
    iw = max(0, min(a[0] + a[2], b[0] + b[2]) - max(a[0], b[0]))
    ih = max(0, min(a[1] + a[3], b[1] + b[3]) - max(a[1], b[1]))
    inter = iw * ih
    return inter / float(a[2] * a[3] + b[2] * b[3] - inter)


@pytest.mark.parametrize("name,max_stages", [
    ("haarcascade_frontalface_alt", None),
    ("haarcascade_eye_tree_eyeglasses", None),       # tilted, T=3
    ("haarcascade_frontalface_alt_tree", 16),        # truncated tree
])
def test_stencils_equal_jax(name, max_stages):
    jd = JDet(j_load_cascade(name), SHAPE, max_stages=max_stages)
    td = ct.PyramidDetector(ct.load_cascade(name), SHAPE,
                            max_stages=max_stages, strategy="direct",
                            device="cpu")
    nn = td.table.n_clf * td.table.T
    s, t = (None if m is None else m.numpy() for m in td._stencils)
    np.testing.assert_array_equal(s, jd._sten_sum[:, :nn])
    if jd._sten_tilt is None:
        assert t is None
    else:
        np.testing.assert_array_equal(t, jd._sten_tilt[:, :nn])


def test_direct_values_near_exact_values():
    """float64 stencil values against the v1 tail's values from int32
    corners (exact in float64 here) on a tilted T=3 cascade, pad slots
    included."""
    name = "haarcascade_eye_tree_eyeglasses"
    td = ct.PyramidDetector(ct.load_cascade(name), SHAPE, max_stages=8,
                            strategy="direct", dtype=torch.float64,
                            device="cpu")
    frame = synth_scene(SHAPE, faces=((60, 80, 40.0),), seed=9)
    ii = td._prep_planes(torch.from_numpy(frame)[None])
    n = td.hv * td.wv
    idx = np.random.default_rng(2).choice(n, (1, 200)).astype(np.int32)
    idx[0, ::9] = n
    surv = torch.from_numpy(idx)
    got = stencil.stencil_values(ii.sum, ii.tilted, surv, td.hv, td.wv,
                                 td.h0 + 1, td.w0 + 1, *td._stencils)
    want = haar_tail.tail_values_plain(ii.sum, ii.tilted, surv, td.hv,
                                       td.wv, td.table, torch.float64)
    valid = (surv < n)[0]
    g, w = got[0][valid].numpy(), want[0][valid].numpy()
    scale = np.abs(w).max(axis=0) + 1.0
    assert (np.abs(g - w) <= 1e-9 * scale).all()


@pytest.mark.parametrize("name,max_stages,dtype", [
    ("haarcascade_frontalface_alt2", None, "float64"),     # CART
    ("haarcascade_frontalface_alt_tree", 20, "float32"),   # stage tree
])
def test_direct_with_jax(name, max_stages, dtype):
    face = synth_face(SHAPE)
    td = ct.PyramidDetector(ct.load_cascade(name), SHAPE,
                            max_stages=max_stages, front_stages=2,
                            strategy="direct", dtype=getattr(torch, dtype),
                            device="cpu")
    jd = JDet(j_load_cascade(name), SHAPE, max_stages=max_stages,
              front_stages=2, strategy="direct", dtype=getattr(jnp, dtype))
    assert not td.use_tail2 and td.front_k == jd.front_k
    launches = trace.counters().get("launches.tail_rows", 0)
    tres, jres = td.detect(face, min_neighbors=1), \
        jd.detect(face, min_neighbors=1)
    # CPU: plain twins
    assert trace.counters().get("launches.tail_rows", 0) == launches
    ts, js = _set(tres.candidates), _set(jres.candidates)
    assert len(js) > 0 and not tres.survivor_overflow
    if dtype == "float64":
        assert ts == js
        np.testing.assert_array_equal(tres.boxes, jres.boxes)
    else:
        assert len(ts & js) / len(ts | js) >= 0.995
        assert len(tres.boxes) == len(jres.boxes)
        for a in tres.boxes:
            assert max(_iou(a, b) for b in jres.boxes) >= 0.9


def test_direct_chunking_keeps_every_bit(monkeypatch):
    """The product chunked over slots gives the chunk-free rows, and the
    direct candidates equal the v1 tail's on this scene."""
    name = "haarcascade_frontalface_alt2"
    face = synth_face(SHAPE)
    spec = ct.load_cascade(name)
    det = ct.PyramidDetector(spec, SHAPE, max_stages=8, strategy="direct",
                             device="cpu")
    frames = det.put(face)
    want = det._detect_device(frames, det.cap)
    monkeypatch.setattr(tpyramid, "_DIRECT_CHUNK_ELEMS",
                        37 * det.table.n_clf * det.table.T)
    got = det._detect_device(frames, det.cap)
    for k in ("packed", "surv_idx", "ok"):
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy())
    blk = ct.PyramidDetector(spec, SHAPE, max_stages=8, strategy="block",
                             device="cpu")
    bc, _ = blk.candidates(face)
    dc, _ = det.candidates(face)
    assert len(bc) > 0
    assert _set(dc) == _set(bc)
