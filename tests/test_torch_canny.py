"""The port's Canny and Canny pruning against the JAX package, on the CPU.

``canny`` (torch) and ``canny_np`` are held bit-equal to the JAX
package's ``canny`` and ``canny_np`` and to ``cv2.Canny(img, 0, 50)``;
the scale-cascade detector with ``do_canny_pruning`` box for box (float64)
with JAX's on a frame where the pruning removes candidates, and the
port's golden path with pruning equal to JAX's golden path.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clfacedetection_tpu.detect import ScaleCascadeDetector as JDet
from clfacedetection_tpu.detect import detect_multi_scale_reference as jgold
from clfacedetection_tpu.models import load_cascade as j_load_cascade
from clfacedetection_tpu.ops.canny import canny as j_canny
from clfacedetection_tpu.ops.canny import canny_np as j_canny_np

import clfacedetection_torch as ct
from clfacedetection_torch.detect import detect_multi_scale_reference
from clfacedetection_torch.ops import canny as tcanny
from clfacedetection_torch.utils import synth_face

# one torch thread per test worker process
torch.set_num_threads(1)

CASCADE = "haarcascade_frontalface_default"


def _smooth(img: np.ndarray, passes: int = 3) -> np.ndarray:
    """A 3x3 box blur ``passes`` times (edge rows and columns kept)."""
    a = img.astype(np.int32)
    for _ in range(passes):
        p = np.pad(a, 1, mode="edge")
        a = sum(p[i:i + a.shape[0], j:j + a.shape[1]]
                for i in range(3) for j in range(3)) // 9
    return a.astype(np.uint8)


def _image(seed: int, smooth: bool, shape=(64, 80)) -> np.ndarray:
    img = np.random.default_rng(seed).integers(0, 256, shape, np.uint8)
    return _smooth(img) if smooth else img


@pytest.mark.parametrize("seed,smooth", [(0, False), (1, True), (2, False),
                                         (3, True)])
def test_canny_bit_equal_to_jax_and_cv2(seed, smooth):
    cv2 = pytest.importorskip("cv2")
    img = _image(seed, smooth)
    want = cv2.Canny(img, 0, 50, apertureSize=3)
    got = tcanny.canny(torch.from_numpy(img), 0, 50)
    assert got.dtype == torch.uint8 and got.shape == img.shape
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tcanny.canny_np(img, 0, 50), want)
    np.testing.assert_array_equal(
        np.asarray(j_canny(jnp.asarray(img), 0, 50)), want)
    assert (want > 0).any()


@pytest.mark.parametrize("low,high", [(30, 90), (50, 150), (12.5, 40.7)])
def test_canny_thresholds_equal_to_jax(low, high):
    img = _image(5, True, (48, 72))
    want = j_canny_np(img, low, high)
    np.testing.assert_array_equal(tcanny.canny_np(img, low, high), want)
    np.testing.assert_array_equal(
        tcanny.canny(torch.from_numpy(img), low, high).numpy(), want)


def test_hysteresis_runs_past_one_block_of_steps():
    """A weak edge that one strong pixel reaches only after many more
    dilation steps than ``GROW_STEPS``: the blocked loop converges to the
    same fixpoint as the numpy loop that checks after every step."""
    img = np.full((40, 96), 100, np.uint8)
    img[20:, :] = 110           # a faint step edge along row 20
    img[20:, 88:] = 200         # strong only at its right end
    want = j_canny_np(img, 0, 50)
    got = tcanny.canny(torch.from_numpy(img), 0, 50).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tcanny.canny_np(img, 0, 50), want)
    # the flood ran the length of the faint edge, beyond one block
    assert (got[19:21, :88 - 2 * tcanny.GROW_STEPS] > 0).any()


@pytest.fixture(scope="module")
def smooth_face():
    # a smooth background has few edges, so the pruning is active
    return synth_face((120, 160), noise=1.0)


def test_canny_pruning_with_jax(smooth_face):
    spec = ct.load_cascade(CASCADE)
    pruned = ct.ScaleCascadeDetector(spec, smooth_face.shape, max_stages=4,
                                     dtype=torch.float64,
                                     do_canny_pruning=True, device="cpu")
    plain = ct.ScaleCascadeDetector(spec, smooth_face.shape, max_stages=4,
                                    dtype=torch.float64, device="cpu")
    tc, tov = pruned.candidates(smooth_face)
    full, _ = plain.candidates(smooth_face)
    jd = JDet(j_load_cascade(CASCADE), smooth_face.shape, max_stages=4,
              dtype=jnp.float64, do_canny_pruning=True)
    jc, jov = jd.candidates(smooth_face)
    assert not tov and not jov
    assert 0 < len(tc) < len(full), "the pruning must remove candidates"
    np.testing.assert_array_equal(tc, jc)
    # the classifier's flag switches the same pruning on
    flags = ct.api.CV_HAAR_DO_CANNY_PRUNING
    res = ct.CascadeClassifier(spec, device="cpu", dtype=torch.float64,
                               mode="scale_cascade").detect_multi_scale_full(
        smooth_face, min_neighbors=0, flags=flags, max_stages=4)
    np.testing.assert_array_equal(res.candidates, tc)


def test_golden_canny_pruning_equals_jax():
    img = synth_face((64, 80), size=30.0, noise=1.0)
    spec = ct.load_cascade(CASCADE)
    got = detect_multi_scale_reference(img, spec, min_neighbors=0,
                                       max_stages=3, do_canny_pruning=True)
    full = detect_multi_scale_reference(img, spec, min_neighbors=0,
                                        max_stages=3)
    want = jgold(img, j_load_cascade(CASCADE), min_neighbors=0,
                 max_stages=3, do_canny_pruning=True)
    assert 0 < len(got) < len(full)
    np.testing.assert_array_equal(got, want)
