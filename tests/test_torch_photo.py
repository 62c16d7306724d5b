"""The port's bundled photograph and ``photo_scene`` against the JAX
package's (``clfacedetection_tpu/utils/testimage.py``), and the front's
survivors on it.

Tolerances: pixels BYTE-EQUAL (the port reads the decoded JPEG from a
data file and resizes with a numpy copy of Pillow's bilinear resampler);
survivor counts EQUAL (the float32 front is bit-equal to JAX's).
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clfacedetection_tpu.detect.pyramid import PyramidDetector as JDet
from clfacedetection_tpu.models import load_cascade as j_load_cascade
from clfacedetection_tpu.utils import testimage as jimg

from clfacedetection_torch.detect.pyramid import PyramidDetector as TDet
from clfacedetection_torch.models import load_cascade as t_load_cascade
from clfacedetection_torch.ops.haar_front import haar_front
from clfacedetection_torch.tools import export_photo
from clfacedetection_torch.utils import testimage as timg

# The suite runs in several worker processes at once; one torch thread
# each keeps them from oversubscribing the cores.
torch.set_num_threads(1)


def test_photo_gray_equals_jax():
    got = timg.photo_gray()
    assert got.shape == (600, 512) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, jimg.photo_gray())


@pytest.mark.parametrize("shape,face_sizes", [
    ((1080, 1920), (70, 110, 180)),
    ((480, 640), (70, 110, 180)),
    ((480, 640), (60, 100)),
])
def test_photo_scene_byte_equal_to_jax(shape, face_sizes):
    got = timg.photo_scene(shape, face_sizes)
    assert got.shape == shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, jimg.photo_scene(shape, face_sizes))
    # the cache hands out copies
    got[:] = 0
    np.testing.assert_array_equal(timg.photo_scene(shape, face_sizes),
                                  jimg.photo_scene(shape, face_sizes))


def test_committed_pixels_equal_a_fresh_decode():
    pil = pytest.importorskip("PIL.Image")
    with np.load(export_photo.NPZ) as f:
        rgb = f["rgb"]
    np.testing.assert_array_equal(rgb, np.asarray(pil.open(export_photo.JPEG)))


@pytest.mark.parametrize("shape", [(2251, 1921), (1101, 1290), (37, 45),
                                   (600, 1), (1, 512), (300, 200)])
def test_resize_equals_pillow(shape):
    pil = pytest.importorskip("PIL.Image")
    gray = timg.photo_gray()
    want = np.asarray(pil.fromarray(gray).resize((shape[1], shape[0]),
                                                 pil.BILINEAR))
    np.testing.assert_array_equal(timg._resize_u8(gray, shape), want)


def test_photo_scene_needs_no_pil(monkeypatch):
    """With PIL made unimportable and the cache empty, the photo still
    loads and resizes."""
    want = jimg.photo_scene((120, 160))
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    monkeypatch.setattr(timg, "_photo_cache", {})
    with pytest.raises(ImportError):
        import PIL.Image  # noqa: F401
    got = timg.photo_scene((120, 160))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("front_k", [1, 4, 10])
def test_front_survivors_on_photo_scene_equal_jax(front_k):
    shape = (240, 320)
    frame = timg.photo_scene(shape)
    name = "haarcascade_frontalface_alt"
    jd = JDet(j_load_cascade(name), shape, front_stages=front_k,
              min_size=(40, 40), use_pallas_front=False)
    td = TDet(t_load_cascade(name), shape, front_stages=front_k,
              min_size=(40, 40), device="cpu")
    want = int(np.asarray(jax.jit(jd._front_device)(jnp.asarray(frame))
                          ["front"]).sum())
    ii = td._prep_planes(torch.from_numpy(frame)[None])
    front, _ = haar_front(ii.sum, ii.sq_hi, ii.sq_lo, td._visit, td.table,
                          td.front_k)
    assert want > 0
    assert int(front.sum()) == want
