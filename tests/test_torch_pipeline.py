"""The port's detection pipeline end to end against the JAX package and
the numpy oracle, on the CPU (the kernels' plain twins).

Tolerances: float64 candidates box-for-box with JAX float64 and with
``reference_impl``; float32 candidates held to the docs/PARITY.md f32
bounds (candidate-set Jaccard >= 0.995, grouped boxes matched 1:1 at
IoU >= 0.9) against JAX float32 — on these scenes they are equal.  The
v1 tail's cascades (CART trees, tilted features, stage trees) are held to
the same bounds as tail2's.
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
from clfacedetection_torch import trace
from clfacedetection_torch.detect import pyramid as tpyramid
from clfacedetection_torch.ops import (compact_kernel, haar_front, haar_tail,
                                       haar_tail2)

# The suite runs in several worker processes at once; one torch thread
# each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

SHAPE = (120, 160)
LAUNCHES = (haar_front.haar_front, compact_kernel.compact,
            haar_tail2.haar_tail2, haar_tail.haar_tail)
ZOO = ["haarcascade_eye", "haarcascade_eye_tree_eyeglasses",
       "haarcascade_frontalface_alt", "haarcascade_frontalface_alt2",
       "haarcascade_frontalface_alt_tree", "haarcascade_frontalface_default",
       "haarcascade_fullbody", "haarcascade_lefteye_2splits",
       "haarcascade_lowerbody", "haarcascade_mcs_eyepair_big",
       "haarcascade_mcs_eyepair_small", "haarcascade_mcs_lefteye",
       "haarcascade_mcs_mouth", "haarcascade_mcs_nose",
       "haarcascade_mcs_righteye", "haarcascade_mcs_upperbody",
       "haarcascade_profileface", "haarcascade_righteye_2splits",
       "haarcascade_upperbody"]


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
    counts = trace.counters()
    return [counts.get(f"launches.{f.__name__}", 0) for f in LAUNCHES]


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


@pytest.mark.parametrize("name,max_stages,front", [
    ("haarcascade_frontalface_alt2", None, 4),          # CART
    ("haarcascade_mcs_nose", None, 4),                  # tilted
    ("haarcascade_frontalface_alt_tree", 20, 4),        # stage tree
])
def test_v1_tail_candidates_with_jax(face, name, max_stages, front):
    td = ct.PyramidDetector(ct.load_cascade(name), SHAPE,
                            max_stages=max_stages, front_stages=front,
                            device="cpu")
    assert not td.use_tail2
    jd = JDet(j_load_cascade(name), SHAPE, max_stages=max_stages,
              front_stages=front, dtype=jnp.float32)
    tres, jres = td.detect(face, min_neighbors=1), \
        jd.detect(face, min_neighbors=1)
    ts, js = _set(tres.candidates), _set(jres.candidates)
    assert len(js) > 0
    assert len(ts & js) / len(ts | js) >= 0.995
    assert len(tres.boxes) == len(jres.boxes)
    for a in tres.boxes:
        assert max(_iou(a, b) for b in jres.boxes) >= 0.9


def test_v1_tail_f64_box_for_box_with_jax_and_oracle(face):
    name = "haarcascade_eye_tree_eyeglasses"           # CART, T=3, tilted
    td = ct.PyramidDetector(ct.load_cascade(name), SHAPE, max_stages=6,
                            front_stages=2, dtype=torch.float64,
                            device="cpu")
    tc, tov = td.candidates(face)
    jd = JDet(j_load_cascade(name), SHAPE, max_stages=6, front_stages=2,
              dtype=jnp.float64)
    jc, jov = jd.candidates(face)
    gold = detect_multi_scale_reference(face, j_load_cascade(name),
                                        min_neighbors=0, max_stages=6,
                                        mode="scale_image")
    assert not tov and not jov and len(tc) > 0
    assert _set(tc) == _set(jc) == _set(gold)


def test_block_strategy_equals_per_stage(face):
    spec = ct.load_cascade("haarcascade_frontalface_alt")
    per = ct.PyramidDetector(spec, SHAPE, max_stages=10, device="cpu")
    blk = ct.PyramidDetector(spec, SHAPE, max_stages=10, strategy="block",
                             device="cpu")
    assert per.use_tail2 and not blk.use_tail2
    pc, _ = per.candidates(face)
    bc, _ = blk.candidates(face)
    assert len(pc) > 0
    np.testing.assert_array_equal(bc, pc)
    tr = ct.detect_objects(face, spec, min_window_size=(20, 20),
                           flags=ct.api.CLOD_BLOCK_IMPLEMENTATION,
                           device="cpu")
    jr = japi.detect_objects(face, j_load_cascade(
        "haarcascade_frontalface_alt"), min_window_size=(20, 20),
        flags=japi.CLOD_BLOCK_IMPLEMENTATION)
    assert [tuple(vars(r).values()) for r in tr] == \
        [tuple(vars(r).values()) for r in jr]
    # the direct strategy runs, and detect_objects with neither strategy
    # bit takes it (front 2), as JAX's does
    drc = ct.PyramidDetector(spec, SHAPE, max_stages=10, strategy="direct",
                             device="cpu")
    assert not drc.use_tail2
    dc, _ = drc.candidates(face)
    np.testing.assert_array_equal(dc, pc)
    tr0 = ct.detect_objects(face, spec, min_window_size=(20, 20), flags=0,
                            device="cpu")
    jr0 = japi.detect_objects(face, j_load_cascade(
        "haarcascade_frontalface_alt"), min_window_size=(20, 20), flags=0)
    assert len(jr0) > 0
    assert [tuple(vars(r).values()) for r in tr0] == \
        [tuple(vars(r).values()) for r in jr0]


@pytest.mark.parametrize("name", ZOO)
def test_every_zoo_cascade_detects(name):
    """All 19 cascades build and run through the entry points (tiny frame,
    three stages), with the tail the JAX package would take."""
    frame = synth_face((60, 80))
    spec = ct.load_cascade(name)
    det = ct.PyramidDetector(spec, (60, 80), max_stages=3, front_stages=1,
                             device="cpu")
    c = det.compiled
    assert det.use_tail2 == (det.table.T == 1 and not c.is_tree
                             and not c.has_tilted and spec.window_w < 32)
    res = det.detect(frame, min_neighbors=0)
    assert res.candidates.ndim == 2 and res.candidates.shape[1] == 4
    cls = ct.CascadeClassifier(spec, device="cpu")
    np.testing.assert_array_equal(
        cls.detect_multi_scale(frame, min_neighbors=0, max_stages=3,
                               front_stages=1), res.boxes)


def test_entry_points_need_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = ct.load_cascade("haarcascade_frontalface_alt")
    face = synth_face(SHAPE)
    for build in (lambda: ct.PyramidDetector(spec, SHAPE),
                  lambda: ct.BatchedPyramidDetector(spec, SHAPE, batch=2),
                  lambda: ct.CascadeClassifier(spec).detect_multi_scale(face),
                  lambda: ct.detect_objects(face, spec)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            build()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tpyramid.default_device()


def test_float64_refused_on_cuda_device(face, monkeypatch):
    """float64 is no longer refused on a CUDA device: the detector takes
    the plain versions of the front and the tails in float64 wherever it
    runs (those kernels are float32), and float32 takes the kernels'
    wrappers.  Shown with those wrappers replaced by one that fails, which
    float64 never calls.  The compactions take the compaction's wrapper
    in float64 too (the kernel has no float type; on the CPU it runs its
    plain version)."""
    spec = ct.load_cascade("haarcascade_frontalface_alt2")
    f64 = ct.PyramidDetector(spec, SHAPE, max_stages=6, dtype=torch.float64,
                             device="cpu")
    want, _ = f64.candidates(face)

    def refuse(*args, **kwargs):
        raise AssertionError("a kernel wrapper was called")

    calls = []

    def compact(flags, cap):
        calls.append(cap)
        return tpyramid.compact_plain(flags, cap)

    for fn in ("haar_front", "haar_tail", "haar_tail2", "tail_rows"):
        monkeypatch.setattr(tpyramid, fn, refuse)
    monkeypatch.setattr(tpyramid, "compact", compact)
    got, _ = f64.candidates(face)
    assert len(want) > 0
    np.testing.assert_array_equal(got, want)
    assert len(calls) == 2          # the survivors', then the accepts'
    f32 = ct.PyramidDetector(spec, SHAPE, max_stages=6, device="cpu")
    with pytest.raises(AssertionError, match="wrapper"):
        f32.candidates(face)


def test_canny_flag_ignored_in_scale_image_mode(face):
    """CV_HAAR_DO_CANNY_PRUNING acts only in scale-cascade mode, so the
    scale-image detector gives JAX's boxes with the flag set.
    CV_HAAR_FIND_BIGGEST_OBJECT, which raised here before scale-cascade
    mode was ported, now runs: on the CPU the golden path, as JAX's does
    off the TPU."""
    flags = ct.api.CV_HAAR_DO_CANNY_PRUNING
    name = "haarcascade_frontalface_alt"
    tb = ct.CascadeClassifier(name, device="cpu").detect_multi_scale(
        face, min_neighbors=2, min_size=(20, 20), flags=flags)
    jb = japi.CascadeClassifier(name).detect_multi_scale(
        face, min_neighbors=2, min_size=(20, 20), flags=flags)
    assert len(jb) > 0
    np.testing.assert_array_equal(tb, jb)
    crop = face[20:100, 30:130]
    kw = dict(flags=ct.api.CV_HAAR_FIND_BIGGEST_OBJECT, min_neighbors=1,
              min_size=(36, 36), scale_factor=1.3)
    tb = ct.CascadeClassifier(name, device="cpu").detect_multi_scale(
        crop, **kw)
    jb = japi.CascadeClassifier(name).detect_multi_scale(crop, **kw)
    assert len(jb) == 1
    np.testing.assert_array_equal(tb, jb)
