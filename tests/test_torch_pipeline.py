"""The port's detection pipeline end to end against the JAX package and
the numpy oracle, on the CPU (the kernels' plain twins).

Tolerances: float64 candidates box-for-box with JAX float64 and with
``reference_impl``; float32 candidates held to the docs/PARITY.md f32
bounds (candidate-set Jaccard >= 0.995, grouped boxes matched 1:1 at
IoU >= 0.9) against JAX float32 — on these scenes they are equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clfacedetection_tpu import api as japi
from clfacedetection_tpu.detect import detect_multi_scale_reference
from clfacedetection_tpu.detect.pyramid import PyramidDetector as JDet
from clfacedetection_tpu.models import load_cascade as j_load_cascade
from clfacedetection_tpu.utils import synth_face, synth_scene

import clfacedetection_torch as ct
from clfacedetection_torch.ops import compact_kernel, haar_front, haar_tail2

# The suite runs in several worker processes at once; one torch thread
# each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

SHAPE = (120, 160)
LAUNCHES = (haar_front.haar_front, compact_kernel.compact,
            haar_tail2.haar_tail2)


@pytest.fixture(scope="module")
def face():
    return synth_face(SHAPE)


@pytest.fixture(scope="module")
def frames():
    return np.stack([synth_face(SHAPE),
                     synth_scene(SHAPE, faces=((50, 70, 45.0),), seed=2),
                     synth_face(SHAPE, center=(70, 60), size=50.0, seed=8)])


def _set(c):
    return set(map(tuple, np.asarray(c)))


def _iou(a, b):
    iw = max(0, min(a[0] + a[2], b[0] + b[2]) - max(a[0], b[0]))
    ih = max(0, min(a[1] + a[3], b[1] + b[3]) - max(a[1], b[1]))
    inter = iw * ih
    return inter / float(a[2] * a[3] + b[2] * b[3] - inter)


def _launch_counts():
    return [f.launches for f in LAUNCHES]


def test_f64_box_for_box_with_jax_and_oracle(face):
    name = "haarcascade_frontalface_alt"
    before = _launch_counts()
    td = ct.PyramidDetector(ct.load_cascade(name), SHAPE, max_stages=5,
                            min_size=(30, 30), dtype=torch.float64,
                            device="cpu")
    tc, tov = td.candidates(face)
    assert _launch_counts() == before        # the CPU runs no kernel
    jd = JDet(j_load_cascade(name), SHAPE, max_stages=5, min_size=(30, 30),
              dtype=jnp.float64)
    jc, jov = jd.candidates(face)
    gold = detect_multi_scale_reference(face, j_load_cascade(name),
                                        min_neighbors=0, max_stages=5,
                                        min_size=(30, 30),
                                        mode="scale_image")
    assert not tov and not jov and len(tc) > 0
    assert _set(tc) == _set(jc) == _set(gold)


@pytest.mark.parametrize("name,max_stages,front", [
    ("haarcascade_frontalface_alt", None, 4),
    ("haarcascade_frontalface_default", 12, 6),
])
def test_f32_candidates_with_jax(face, name, max_stages, front):
    td = ct.PyramidDetector(ct.load_cascade(name), SHAPE,
                            max_stages=max_stages, front_stages=front,
                            device="cpu")
    jd = JDet(j_load_cascade(name), SHAPE, max_stages=max_stages,
              front_stages=front, dtype=jnp.float32)
    tres, jres = td.detect(face), jd.detect(face)
    ts, js = _set(tres.candidates), _set(jres.candidates)
    assert len(js) > 0
    assert len(ts & js) / len(ts | js) >= 0.995
    assert len(tres.boxes) == len(jres.boxes)
    for a in tres.boxes:
        assert max(_iou(a, b) for b in jres.boxes) >= 0.9
    assert ts == js          # equal on this scene


def test_cap_regrowth(face):
    spec = ct.load_cascade("haarcascade_frontalface_alt")
    ref = ct.PyramidDetector(spec, SHAPE, max_stages=8, device="cpu")
    small = ct.PyramidDetector(spec, SHAPE, max_stages=8, cap=16,
                               device="cpu")
    rc, rov = ref.candidates(face)
    frames = small.put(face)
    _, ovf = small.readback(small._detect_device(frames, 16), 16)[0]
    assert ovf                                  # the overflow is visible
    sc, sov = small.candidates(face)
    assert not rov and not sov and small.cap > 16
    np.testing.assert_array_equal(sc, rc)


def test_accept_overflow_takes_second_readback(face, monkeypatch):
    from clfacedetection_torch.detect import pyramid
    spec = ct.load_cascade("haarcascade_frontalface_alt")
    det = ct.PyramidDetector(spec, SHAPE, max_stages=8, device="cpu")
    want, _ = det.candidates(face)
    assert len(want) > 4
    monkeypatch.setattr(pyramid, "ACCEPT_CAP", 4)
    dev = det._detect_device(det.put(face), det.cap)
    assert dev["packed"].shape == (1, 2 + 2 * 4)
    got, ovf = det.readback(dev, det.cap)[0]
    assert not ovf
    np.testing.assert_array_equal(got, want)


def test_batched_equals_single_frames(frames):
    spec = ct.load_cascade("haarcascade_frontalface_alt")
    single = ct.PyramidDetector(spec, SHAPE, max_stages=10, device="cpu")
    want = [single.detect(f) for f in frames]
    bd = ct.BatchedPyramidDetector(spec, SHAPE, batch=2, max_stages=10,
                                   cap=16, device="cpu")
    got = bd.detect(frames[:2])                 # regrows from cap 16
    assert bd.det.cap > 16
    bd2 = ct.BatchedPyramidDetector(spec, SHAPE, batch=2, max_stages=10,
                                    cap=16, device="cpu")
    batches = [frames[[0, 1]], frames[[2, 0]], frames[[1, 2]]]
    stream = [r for out in bd2.detect_stream(batches) for r in out]
    order = [0, 1, 2, 0, 1, 2]
    for r, w in zip(got + stream, [0, 1] + order):
        np.testing.assert_array_equal(r.candidates, want[w].candidates)
        np.testing.assert_array_equal(r.boxes, want[w].boxes)
        np.testing.assert_array_equal(r.neighbors, want[w].neighbors)
        assert not r.survivor_overflow
    assert len(stream) == 6


def test_cascade_classifier_and_detect_objects(face):
    bgr = np.repeat(face[..., None], 3, axis=2)
    tb = ct.CascadeClassifier("haarcascade_frontalface_alt",
                              device="cpu").detect_multi_scale(
        bgr, min_neighbors=2, min_size=(20, 20))
    jb = japi.CascadeClassifier("haarcascade_frontalface_alt") \
        .detect_multi_scale(bgr, min_neighbors=2, min_size=(20, 20))
    assert len(jb) > 0
    np.testing.assert_array_equal(tb, jb)
    tb2, tn2 = ct.CascadeClassifier("haarcascade_frontalface_alt",
                                    device="cpu").detect_multi_scale2(
        face, min_neighbors=2, min_size=(20, 20))
    jb2, jn2 = japi.CascadeClassifier("haarcascade_frontalface_alt") \
        .detect_multi_scale2(face, min_neighbors=2, min_size=(20, 20))
    np.testing.assert_array_equal(tb2, jb2)
    np.testing.assert_array_equal(tn2, jn2)
    tr = ct.detect_objects(face, "haarcascade_frontalface_alt",
                           min_window_size=(20, 20), device="cpu")
    jr = japi.detect_objects(face, "haarcascade_frontalface_alt",
                             min_window_size=(20, 20))
    assert [tuple(vars(r).values()) for r in tr] == \
        [tuple(vars(r).values()) for r in jr]


@pytest.mark.parametrize("name", ["haarcascade_frontalface_alt2",
                                  "haarcascade_mcs_nose",
                                  "haarcascade_frontalface_alt_tree"])
def test_unported_cascades_raise(name):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ct.PyramidDetector(ct.load_cascade(name), SHAPE, device="cpu")


def test_float64_refused_on_cuda_device():
    with pytest.raises(NotImplementedError):
        ct.PyramidDetector(ct.load_cascade("haarcascade_frontalface_alt"),
                           SHAPE, dtype=torch.float64, device="cuda")
