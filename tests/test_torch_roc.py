"""The port's ROC output (reject levels and level weights,
tempcv.cpp:1084-1095) against the JAX package, on the CPU.

``PyramidDetector(output_levels=True).candidates_with_levels`` against
JAX's, for a stump cascade (tail2's path), a CART cascade and a stage
tree (the v1 tail's path): the (box, level) sets equal, and the weights
equal in float64; in float32 the (box, level) sets meet the
docs/PARITY.md candidate Jaccard >= 0.995 and the weights lie within
1e-4 of JAX's (the JAX tail sums votes of matrix-product node values in
``jnp.sum`` order; measured at most 4.6e-5 apart).
``CascadeClassifier.detect_multi_scale3`` against JAX's, grouped and
not; ``group_rectangles_levels`` itself is held equal in
``test_torch_host.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clfacedetection_tpu import api as japi
from clfacedetection_tpu.detect.pyramid import PyramidDetector as JDet
from clfacedetection_tpu.models import load_cascade as j_load_cascade
from clfacedetection_tpu.utils import synth_face

import clfacedetection_torch as ct
from clfacedetection_torch.detect import pyramid as tpyramid

# The suite runs in several worker processes at once; one torch thread
# each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

SHAPE = (120, 160)


@pytest.fixture(scope="module")
def face():
    return synth_face(SHAPE)


def _roc(boxes, levels, weights):
    return {tuple(b) + (int(lv),): float(w)
            for b, lv, w in zip(np.asarray(boxes).tolist(), levels, weights)}


@pytest.mark.parametrize("name,max_stages,dtype", [
    ("haarcascade_frontalface_alt", None, "float32"),      # stumps, tail2
    ("haarcascade_frontalface_alt2", None, "float64"),     # CART
    ("haarcascade_frontalface_alt_tree", 12, "float64"),   # stage tree
])
def test_candidates_with_levels_with_jax(face, name, max_stages, dtype):
    td = ct.PyramidDetector(ct.load_cascade(name), SHAPE,
                            max_stages=max_stages, output_levels=True,
                            dtype=getattr(torch, dtype), device="cpu")
    jd = JDet(j_load_cascade(name), SHAPE, max_stages=max_stages,
              output_levels=True, dtype=getattr(jnp, dtype))
    assert td.front_k == jd.front_k
    assert td.is_tree or td.front_k == min(4, td.n_stages - 4)
    tb, tl, tw, tov = td.candidates_with_levels(face)
    jb, jl, jw, jov = jd.candidates_with_levels(face)
    assert tb.dtype == np.int32 and tl.dtype == np.int32
    assert tw.dtype == np.float64
    assert not tov and not jov and len(jb) > 0
    t, j = _roc(tb, tl, tw), _roc(jb, jl, jw)
    if td.is_tree:
        assert set(tl) == {td.n_stages}
    else:
        assert (tl >= td.n_stages - 3).all() and (tl < td.n_stages).any()
    if dtype == "float64":
        assert t.keys() == j.keys()
        for k in t:
            assert t[k] == j[k], k
    else:
        both = t.keys() & j.keys()
        assert len(both) / len(t.keys() | j.keys()) >= 0.995
        assert all(abs(t[k] - j[k]) <= 1e-4 for k in both)
    # the ROC detector's plain candidates are the accepted windows
    cand, _ = td.candidates(face)
    acc = {k[:4] for k in t if k[4] == td.n_stages}
    assert set(map(tuple, cand.tolist())) == acc


def test_roc_overflow_takes_second_readback(face, monkeypatch):
    """More ROC windows than the packed readback holds: the full arrays
    give the same output; a detector without ``output_levels`` refuses."""
    spec = ct.load_cascade("haarcascade_frontalface_alt2")
    det = ct.PyramidDetector(spec, SHAPE, output_levels=True, device="cpu")
    want = det.candidates_with_levels(face)
    assert len(want[0]) > 4
    monkeypatch.setattr(tpyramid, "ACCEPT_CAP", 4)
    dev = det._detect_device(det.put(face), det.cap)
    assert dev["packed_roc"].shape == (1, 2 + 4 * 4)
    got = det.candidates_with_levels(face)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="output_levels"):
        ct.PyramidDetector(spec, SHAPE, device="cpu") \
            .candidates_with_levels(face)


@pytest.mark.parametrize("name,knobs", [
    ("haarcascade_frontalface_alt", {}),                  # stumps, tail2
    ("haarcascade_frontalface_alt2", {}),                 # CART
    ("haarcascade_frontalface_alt_tree", {"max_stages": 12}),  # stage tree
])
def test_detect_multi_scale3_with_jax(face, name, knobs):
    """Ungrouped and grouped (min_neighbors 2) from one classifier of each
    package, so that both calls share each package's detector."""
    tclf = ct.CascadeClassifier(name, device="cpu")
    jclf = japi.CascadeClassifier(name)
    for min_neighbors in (0, 2):
        tb, tl, tw = tclf.detect_multi_scale3(
            face, min_neighbors=min_neighbors, min_size=(20, 20), **knobs)
        jb, jl, jw = jclf.detect_multi_scale3(
            face, min_neighbors=min_neighbors, min_size=(20, 20), **knobs)
        assert len(jb) > 0
        np.testing.assert_array_equal(tb, jb)
        np.testing.assert_array_equal(tl, jl)
        np.testing.assert_allclose(tw, jw, rtol=0, atol=1e-4)
