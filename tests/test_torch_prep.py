"""Prep ops of the port against the JAX package: gray conversion, the
fixed-point resize, the integral planes and the padded canvas planes
must be BIT-EQUAL (all integer arithmetic)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clfacedetection_tpu.detect.pyramid import PyramidDetector as JDet
from clfacedetection_tpu.models import load_cascade as j_load_cascade
from clfacedetection_tpu.ops import integral as jintegral
from clfacedetection_tpu.ops import resize as jresize
from clfacedetection_tpu.utils import synth_scene

from clfacedetection_torch.detect.pyramid import PyramidDetector as TDet
from clfacedetection_torch.models import load_cascade as t_load_cascade
from clfacedetection_torch.ops import integral as tintegral
from clfacedetection_torch.ops import resize as tresize

# The suite runs in several worker processes at once; one torch thread
# each keeps them from oversubscribing the cores.
torch.set_num_threads(1)


def test_gray_bit_equal(rng):
    bgr = rng.integers(0, 256, (2, 37, 53, 3), dtype=np.uint8)
    np.testing.assert_array_equal(
        tintegral.bgr_to_gray(torch.from_numpy(bgr)).numpy(),
        np.asarray(jintegral.bgr_to_gray(jnp.asarray(bgr), mode="cv")))
    bgra = rng.integers(0, 256, (31, 40, 4), dtype=np.uint8)
    np.testing.assert_array_equal(
        tintegral.bgra_to_gray(torch.from_numpy(bgra)).numpy(),
        np.asarray(jintegral.bgra_to_gray(jnp.asarray(bgra), mode="cv")))


@pytest.mark.parametrize("src,dst", [((97, 131), (88, 119)),
                                     ((480, 640), (436, 582)),
                                     ((60, 80), (17, 23)),
                                     ((33, 40), (33, 57))])
def test_resize_bit_equal(rng, src, dst):
    img = rng.integers(0, 256, (2,) + src, dtype=np.uint8)
    for a, b in zip(tresize.resize_coeffs(src[1], dst[1]),
                    jresize.resize_coeffs(src[1], dst[1])):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        tresize.resize_bilinear_u8(torch.from_numpy(img), dst).numpy(),
        np.asarray(jresize.resize_bilinear_u8(jnp.asarray(img), dst)))


@pytest.mark.parametrize("shape", [(1, 1), (57, 91), (480, 640)])
def test_integrals_bit_equal(rng, shape):
    img = rng.integers(0, 256, (2,) + shape, dtype=np.uint8)
    j = jintegral.integral_images(jnp.asarray(img))
    t = tintegral.integral_images(torch.from_numpy(img))
    for name in ("sum", "sq_hi", "sq_lo"):
        tv = getattr(t, name)
        assert tv.dtype == torch.int32
        np.testing.assert_array_equal(tv.numpy(),
                                      np.asarray(getattr(j, name)))


def test_canvas_planes_bit_equal():
    name = "haarcascade_frontalface_alt"
    frame = synth_scene((240, 320), faces=((120, 160, 60.0),), seed=4)
    jd = JDet(j_load_cascade(name), frame.shape, use_pallas_front=False)
    td = TDet(t_load_cascade(name), frame.shape, device="cpu")
    jplanes, jhi, jlo = jax.jit(jd._prep_planes)(jnp.asarray(frame))
    ts, thi, tlo, tt = td._prep_planes(torch.from_numpy(frame)[None])
    assert tt is None                   # no tilted feature in this cascade
    np.testing.assert_array_equal(ts[0].numpy(), np.asarray(jplanes["sum"]))
    np.testing.assert_array_equal(thi[0].numpy(), np.asarray(jhi))
    np.testing.assert_array_equal(tlo[0].numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(
        td._visit.numpy(), jd.plan.visit_mask(jd.w0, jd.h0))


@pytest.mark.parametrize("shape", [(57, 91), (120, 37)])
def test_tilted_integral_bit_equal(rng, shape):
    """The port's sheared-cumsum RSAT against JAX's row recurrence, one
    frame and a batch of three."""
    img = rng.integers(0, 256, (3,) + shape, dtype=np.uint8)
    want = np.asarray(jintegral.tilted_integral(jnp.asarray(img)))
    got = tintegral.tilted_integral(torch.from_numpy(img))
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tintegral.tilted_integral(torch.from_numpy(img[1])).numpy(), want[1])
    ii = tintegral.integral_images(torch.from_numpy(img), 5, with_tilted=True)
    np.testing.assert_array_equal(ii.tilted[:, :-5, :-5].numpy(), want)
    assert not ii.tilted[:, -5:].any() and not ii.tilted[:, :, -5:].any()


def _every_bgr_triple():
    """Every (b, g, r) byte triple once, as a (4096, 4096, 3) image."""
    b, g, r = np.meshgrid(np.arange(256), np.arange(256), np.arange(256),
                          indexing="ij")
    return np.stack([b, g, r], -1).astype(np.uint8).reshape(4096, 4096, 3)


@pytest.mark.parametrize("fn,mode", [("bgr_to_gray", "clif"),
                                     ("bgr_to_gray_per_row", "clif"),
                                     ("bgr_to_gray_per_row", "cv"),
                                     ("bgra_to_gray", "clif")])
def test_gray_modes_bit_equal(fn, mode):
    """The clif modes over every BGR triple (XLA:CPU rounds each product
    and sum of ``bgr_to_gray``'s clif mode, and contracts the per-row
    variant's loop body into two fmas: the port follows each), the cv
    mode of the per-row variant, and a batch of frames."""
    img = _every_bgr_triple()
    if fn == "bgra_to_gray":
        img = np.concatenate([img, img[..., :1]], axis=-1)
    want = np.asarray(getattr(jintegral, fn)(jnp.asarray(img), mode=mode))
    got = getattr(tintegral, fn)(torch.from_numpy(img), mode=mode)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    batch = img[:64].reshape(2, 32, img.shape[1], img.shape[2])
    np.testing.assert_array_equal(
        getattr(tintegral, fn)(torch.from_numpy(batch), mode=mode).numpy(),
        np.asarray(getattr(jintegral, fn)(jnp.asarray(batch), mode=mode)))


def test_invert_and_gray_mode_checks(rng):
    img = rng.integers(0, 256, (2, 17, 23, 3), dtype=np.uint8)
    got = tintegral.invert(torch.from_numpy(img))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jintegral.invert(jnp.asarray(img))))
    for fn in (tintegral.bgr_to_gray, tintegral.bgr_to_gray_per_row):
        with pytest.raises(ValueError, match="mode"):
            fn(torch.from_numpy(img), mode="nope")
        with pytest.raises(ValueError):
            fn(torch.from_numpy(img[..., :2]))
