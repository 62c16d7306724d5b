"""The port's scale-cascade mode against the JAX package, on the CPU.

``ScaleCascadeDetector`` in float64 gives JAX's candidates box for box
and in the same order (scales ascending, raster order within a scale) for
stumps (frontalface_default), tilted features (mcs_nose) and, under
``-m slow``, CART trees (frontalface_alt2) and a stage tree
(frontalface_alt_tree); in float32 it stays within the docs/PARITY.md
bounds (candidate Jaccard >= 0.995, grouped boxes 1:1 at IoU >= 0.9) of
them.  The front's depth does not move a box, overflow shows and
regrowth heals it, every compaction goes through the kernel's wrapper,
and the API routes ``mode``, ``CV_HAAR_SCALE_IMAGE``,
``CV_HAAR_DO_CANNY_PRUNING`` and ``detect_multi_scale3`` as the JAX
package does.  The golden path and find-biggest-object are held in
``test_torch_golden.py``, Canny pruning in ``test_torch_canny.py``.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clfacedetection_tpu.detect import ScaleCascadeDetector as JDet
from clfacedetection_tpu.detect.grouping import \
    group_rectangles as j_group_rectangles
from clfacedetection_tpu.models import load_cascade as j_load_cascade

import clfacedetection_torch as ct
from clfacedetection_torch.detect import detector as tdetector
from clfacedetection_torch.ops import compact_kernel
from clfacedetection_torch.ops.haar_front import variance_factor
from clfacedetection_torch.utils import synth_face

# one torch thread per test worker process
torch.set_num_threads(1)

SHAPE = (120, 160)
DEFAULT = "haarcascade_frontalface_default"


@functools.lru_cache(maxsize=None)
def _image() -> np.ndarray:
    """The JAX package's detector-parity frame (tests/test_detector_parity
    .py): noise under a bright blob."""
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, SHAPE, np.uint8)
    yy, xx = np.mgrid[0:SHAPE[0], 0:SHAPE[1]]
    blob = 120 * np.exp(-((yy - 60) ** 2 + (xx - 80) ** 2) / 800.0)
    return np.clip(img * 0.5 + blob, 0, 255).astype(np.uint8)


@functools.lru_cache(maxsize=None)
def _jax_candidates(name: str, max_stages: int):
    det = JDet(j_load_cascade(name), SHAPE, max_stages=max_stages,
               dtype=jnp.float64)
    return det.candidates(_image())


def _port(name, max_stages, dtype=torch.float64, **kw):
    return ct.ScaleCascadeDetector(ct.load_cascade(name), SHAPE,
                                   max_stages=max_stages, dtype=dtype,
                                   device="cpu", **kw)


def _iou(a, b):
    iw = max(0, min(a[0] + a[2], b[0] + b[2]) - max(a[0], b[0]))
    ih = max(0, min(a[1] + a[3], b[1] + b[3]) - max(a[1], b[1]))
    inter = iw * ih
    return inter / float(a[2] * a[3] + b[2] * b[3] - inter)


@pytest.mark.parametrize("name,max_stages", [
    (DEFAULT, 4),                                   # stumps, 24x24
    ("haarcascade_mcs_nose", 4),                    # tilted features
    pytest.param("haarcascade_frontalface_alt2", 4,
                 marks=pytest.mark.slow),           # CART trees
    pytest.param("haarcascade_frontalface_alt_tree", 6,
                 marks=pytest.mark.slow),           # stage tree
])
def test_f64_candidates_box_for_box_with_jax(name, max_stages):
    before = compact_kernel.compact.launches
    tc, tov = _port(name, max_stages).candidates(_image())
    assert compact_kernel.compact.launches == before   # no kernel on CPU
    jc, jov = _jax_candidates(name, max_stages)
    assert not tov and not jov and len(tc) > 0
    np.testing.assert_array_equal(tc, jc)      # same boxes, same order


def test_f32_within_parity_of_jax():
    """float32 against JAX's exact (float64) candidates and their
    grouping: the docs/PARITY.md bounds of the fast mode."""
    det = _port(DEFAULT, 4, torch.float32)
    tc, _ = det.candidates(_image())
    jc, _ = _jax_candidates(DEFAULT, 4)
    ts, js = set(map(tuple, tc)), set(map(tuple, np.asarray(jc)))
    assert len(js) > 0
    assert len(ts & js) / len(ts | js) >= 0.995
    tb = det.detect(_image(), min_neighbors=3).boxes
    jb, _ = j_group_rectangles(np.asarray(jc), 3, eps=0.2)
    assert len(tb) == len(jb) > 0
    for a in tb:
        assert max(_iou(a, b) for b in jb) >= 0.9


def test_front_stages_agree():
    """The dense front and the gathered tail compute the same stages, so
    the split point does not move a box."""
    want, _ = _port(DEFAULT, 5, front_stages=3).candidates(_image())
    for front in (1, 5):
        got, ov = _port(DEFAULT, 5, front_stages=front).candidates(_image())
        assert not ov
        np.testing.assert_array_equal(got, want)
    blk, _ = _port(DEFAULT, 5, strategy="block").candidates(_image())
    np.testing.assert_array_equal(blk, want)


def test_overflow_is_seen_and_regrowth_heals_it():
    ref = _port(DEFAULT, 4)
    want, _ = ref.candidates(_image())
    small = _port(DEFAULT, 4, cap=16)
    planes = small._prep(small.put(_image()))
    packed, _ = small._detect_device(planes, 16)
    assert (packed[:, 0] > 16).any()            # the overflow is visible
    got, ov = small.candidates(_image())
    assert not ov and small.cap > 16
    np.testing.assert_array_equal(got, want)
    # a tail group whose survivors overflow its cap says so: 1,024 copies
    # of one detected window fill the first group's 512 slots twice
    det = _port(DEFAULT, 12, front_stages=1)
    cand, _ = det.candidates(_image())
    k = int(np.flatnonzero(det.win_w == cand[0, 2])[0])
    g = det._scale[k]
    planes = det._prep(det.put(_image()))
    y, x = int(cand[0, 1]), int(cand[0, 0])
    ey, ex = g.equ

    def rect(p):
        P = planes[p]
        return (P[y + ey[0], x + ex[0]] - P[y + ey[1], x + ex[1]]
                - P[y + ey[2], x + ex[2]] + P[y + ey[3], x + ex[3]])

    vnf = variance_factor(rect("sum"), rect("sq_hi"), rect("sq_lo"),
                          g.inv_area, torch.float64)
    base = torch.full((1024,), y * (det.W + 1) + x, dtype=torch.int32)
    svnf = vnf.expand(1024).contiguous()
    assert len(det._stage_groups()) >= 2
    accept, trunc = det._tail_accept(planes, g, base, svnf,
                                     torch.ones(1024, dtype=torch.bool),
                                     1024)
    assert bool(trunc) and int(accept.sum()) == 512


def test_compactions_go_through_the_kernel_wrapper(monkeypatch):
    calls = []

    def counting(flags, cap):
        calls.append(tuple(flags.shape))
        return compact_kernel.compact_plain(flags, cap)

    monkeypatch.setattr(tdetector, "compact", counting)
    det = _port(DEFAULT, 8, cap=4096)
    cap = det.cap
    got, _ = det.candidates(_image())
    # one run (no regrowth): per scale the front's and one between the two
    # tail groups, then one for every scale's accepts at once
    assert det.cap == cap and len(det._stage_groups()) == 2
    assert len(calls) == 2 * det.n_scales + 1
    assert calls[-1][0] == det.n_scales
    monkeypatch.undo()
    np.testing.assert_array_equal(got, _port(DEFAULT, 8).candidates(
        _image())[0])


def test_api_routes_modes_and_flags():
    img = _image()
    spec = ct.load_cascade(DEFAULT)
    sc = ct.CascadeClassifier(spec, device="cpu", mode="scale_cascade")
    want, _ = _port(DEFAULT, 4, torch.float32).candidates(img)
    res = sc.detect_multi_scale_full(img, min_neighbors=0, max_stages=4)
    np.testing.assert_array_equal(res.candidates, want)
    assert isinstance(next(iter(sc._detectors.values())),
                      ct.ScaleCascadeDetector)
    # CV_HAAR_SCALE_IMAGE takes the scale-image detector on any classifier
    si = ct.CascadeClassifier(spec, device="cpu")
    flag = ct.api.CV_HAAR_SCALE_IMAGE
    np.testing.assert_array_equal(
        sc.detect_multi_scale(img, min_neighbors=0, flags=flag,
                              max_stages=4),
        si.detect_multi_scale(img, min_neighbors=0, max_stages=4))
    # Canny pruning is dropped in scale-image mode
    canny = ct.api.CV_HAAR_DO_CANNY_PRUNING
    np.testing.assert_array_equal(
        si.detect_multi_scale(img, min_neighbors=0, flags=canny,
                              max_stages=4),
        si.detect_multi_scale(img, min_neighbors=0, max_stages=4))
    with pytest.raises(ValueError, match="mode"):
        ct.CascadeClassifier(spec, device="cpu", mode="pyramid")


def test_detect_multi_scale3_scale_cascade_has_empty_levels():
    """The reference's scale-cascade invoker fills no levels, so the
    levels grouping keeps nothing for min_neighbors > 0 (JAX
    api.py:156-189)."""
    img = _image()
    sc = ct.CascadeClassifier(DEFAULT, device="cpu", mode="scale_cascade")
    boxes, levels, weights = sc.detect_multi_scale3(img, min_neighbors=0,
                                                    max_stages=4)
    want, _ = _port(DEFAULT, 4, torch.float32).candidates(img)
    np.testing.assert_array_equal(boxes, want)
    assert len(levels) == 0 and len(weights) == 0
    boxes, levels, weights = sc.detect_multi_scale3(img, min_neighbors=2,
                                                    max_stages=4)
    assert len(boxes) == len(levels) == len(weights) == 0


def test_scale_cascade_needs_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = ct.load_cascade(DEFAULT)
    face = synth_face((64, 80))
    big = ct.api.CV_HAAR_FIND_BIGGEST_OBJECT
    for build in (
            lambda: ct.ScaleCascadeDetector(spec, (64, 80)),
            lambda: ct.CascadeClassifier(spec, mode="scale_cascade")
            .detect_multi_scale(face),
            lambda: ct.CascadeClassifier(spec).detect_multi_scale(
                face, flags=big)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            build()
