"""The benchmark's frozen copies equal the originals they were taken
from: the cascade files, the photograph, the scene generator and the op
model with its peaks."""

import os

import numpy as np
import pytest

from portbench.harness import flops, frames

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CASCADES = sorted(os.listdir(os.path.join(ROOT, "portbench", "data",
                                          "cascades")))


@pytest.mark.parametrize("name", CASCADES)
def test_cascade_copy_equal(name):
    ours = os.path.join(ROOT, "portbench", "data", "cascades", name)
    theirs = os.path.join(ROOT, "clfacedetection_tpu", "models", "artifacts",
                          name)
    with np.load(ours) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_photo_copy_equal():
    with np.load(os.path.join(ROOT, "portbench", "data",
                              "grace_hopper_rgb.npz")) as a, \
            np.load(os.path.join(ROOT, "clfacedetection_torch", "data",
                                 "grace_hopper_rgb.npz")) as b:
        assert np.array_equal(a["rgb"], b["rgb"])


@pytest.mark.parametrize("shape,sizes,seed", [
    ((120, 160), (40, 60), 3), ((480, 640), (70, 110, 180), 7),
    ((1080, 1920), (70, 110, 180), 7)])
def test_scene_generator_equal(shape, sizes, seed):
    from clfacedetection_torch.utils import testimage
    assert np.array_equal(frames.photo_gray(), testimage.photo_gray())
    assert np.array_equal(frames.photo_scene(shape, sizes, seed),
                          testimage.photo_scene(shape, sizes, seed))


def test_op_model_equal():
    from clfacedetection_torch.utils import flops as theirs
    assert (flops.RECT_OPS, flops.NODE_OPS, flops.VAR_OPS) == \
        (theirs.RECT_OPS, theirs.NODE_OPS, theirs.VAR_OPS)
    assert flops.PEAK_F32_OPS == theirs.PEAK_FLOPS_F32_HIGHEST
    assert flops.PEAK_BYTES == theirs.PEAK_BYTES


def test_pool_seeded():
    """A seed gives the same frames each time, another seed others."""
    sizes = [30, 35, 40]
    a = frames.pool((120, 160), 8, [1, 2], sizes, 5)
    b = frames.pool((120, 160), 8, [1, 2], sizes, 2 ** 31 + 9)
    assert a.shape == b.shape == (8, 120, 160) and a.dtype == np.uint8
    assert not np.array_equal(a, b)
    assert np.array_equal(a, frames.pool((120, 160), 8, [1, 2], sizes, 5))
