"""The port's numpy golden path and find-biggest-object against the JAX
package, on the CPU.

The golden path (``detect/reference_impl.py``, copied whole, with exact
numpy integrals in place of ``cv2``) gives JAX's golden boxes in both
modes, its integrals equal ``cv2.integral3``'s, and its window probe
equals JAX's.  ``ScaleCascadeDetector.find_biggest_object`` (the search
that runs on the card, here on the CPU) gives the box of JAX's and of the
golden path, with and without ``CV_HAAR_DO_ROUGH_SEARCH``; the API runs the
golden path for ``CV_HAAR_FIND_BIGGEST_OBJECT`` on the CPU and for
``detect_objects(use_gpu=False)``, as JAX's does off the TPU.
"""

import numpy as np
import pytest
import torch

from clfacedetection_tpu import api as japi
from clfacedetection_tpu.detect import ScaleCascadeDetector as JDet
from clfacedetection_tpu.detect import detect_multi_scale_reference as jgold
from clfacedetection_tpu.detect.reference_impl import \
    probe_window as j_probe_window
from clfacedetection_tpu.models import load_cascade as j_load_cascade

import clfacedetection_torch as ct
from clfacedetection_torch.detect import reference_impl as tref
from clfacedetection_torch.utils import photo_scene, synth_face

# one torch thread per test worker process
torch.set_num_threads(1)

DEFAULT = "haarcascade_frontalface_default"


@pytest.mark.parametrize("mode", ["scale_cascade", "scale_image"])
def test_golden_path_equals_jax(mode):
    img = synth_face((64, 80), size=30.0)
    got = tref.detect_multi_scale_reference(
        img, ct.load_cascade(DEFAULT), min_neighbors=0, max_stages=4,
        mode=mode)
    want = jgold(img, j_load_cascade(DEFAULT), min_neighbors=0,
                 max_stages=4, mode=mode)
    assert len(want) > 0
    np.testing.assert_array_equal(got, want)


def test_golden_integrals_and_probe_equal_jax():
    cv2 = pytest.importorskip("cv2")
    img = np.random.default_rng(4).integers(0, 256, (37, 53), np.uint8)
    s, sq, t = tref.integrals(img, True)
    cs, csq, ct_ = cv2.integral3(img, sdepth=cv2.CV_32S,
                                 sqdepth=cv2.CV_64F)
    for a, b in ((s, cs), (sq, csq), (t, ct_)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert tref.integrals(img, False)[2] is None
    face = synth_face((64, 80), size=30.0)
    for name in (DEFAULT, "haarcascade_mcs_nose"):
        got = tref.probe_window(face, ct.load_cascade(name), 10, 8, 1.1)
        want = j_probe_window(face, j_load_cascade(name), 10, 8, 1.1)
        assert got == want and len(got["stages"]) > 0


@pytest.fixture(scope="module")
def fbo_scene():
    return photo_scene((180, 240), face_sizes=(50, 80))


@pytest.fixture(scope="module")
def jax_fbo(fbo_scene):
    """JAX's device-side search on the CPU, built once for both cases."""
    return JDet(j_load_cascade(DEFAULT), fbo_scene.shape, max_stages=6)


@pytest.mark.parametrize("rough", [False, True])
def test_find_biggest_on_device_with_jax_and_golden(fbo_scene, jax_fbo,
                                                    rough):
    """The device-side search (descending scales, the ROI shrink, the
    raised minimum size) against JAX's and the golden path."""
    spec = ct.load_cascade(DEFAULT)
    det = ct.ScaleCascadeDetector(spec, fbo_scene.shape, max_stages=6,
                                  device="cpu")
    kw = dict(min_neighbors=1, min_size=(40, 40), rough_search=rough)
    got = det.find_biggest_object(fbo_scene, **kw)
    want = jax_fbo.find_biggest_object(fbo_scene, **kw)
    gold = tref.detect_multi_scale_reference(
        fbo_scene, spec, find_biggest_object=True, max_stages=6, **kw)
    assert got.shape == (1, 4)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, gold)


def test_detect_objects_golden_switch():
    """``use_gpu=False`` runs the golden path in scale-cascade mode, as
    JAX's ``use_tpu=False``; weights are 0."""
    img = synth_face((96, 128), size=40.0)
    kw = dict(min_window_size=(36, 36), min_neighbors=1, scale_factor=1.3)
    got = ct.detect_objects(img, DEFAULT, use_gpu=False, **kw)
    want = japi.detect_objects(img, DEFAULT, use_tpu=False, **kw)
    assert len(want) > 0
    assert [(r.x, r.y, r.width, r.height, r.weight) for r in got] == \
        [(r.x, r.y, r.width, r.height, r.weight) for r in want]
