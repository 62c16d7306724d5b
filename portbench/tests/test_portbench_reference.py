"""The reference against the program's plain path and its golden path at
small sizes on the CPU: the pyramid's images, the candidates, the windows
entering each stage, the floor's operations and the grouping."""

import os

import numpy as np
import pytest
import torch

from portbench.harness import flops, frames
from portbench.reference.cascade import Cascade
from portbench.reference.detect import detect
from portbench.reference.grouping import group_rectangles
from portbench.reference.imaging import integrals, resize_u8

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ["frontalface_alt", "frontalface_default", "profileface",
         "upperbody", "fullbody"]


def _path(name):
    return os.path.join(ROOT, "data", "cascades", f"haarcascade_{name}.npz")


@pytest.fixture(scope="module")
def gray():
    torch.set_num_threads(2)
    return frames.photo_scene((120, 160), (40, 60), 3)


def _cfg(mode, mn=3):
    return dict(mode=mode, scale_factor=1.1, min_neighbors=mn,
                min_size=(20, 20))


def test_imaging_equal(gray):
    from clfacedetection_torch.detect.reference_impl import integrals as ig
    from clfacedetection_torch.ops.integral import tilted_integral
    from clfacedetection_torch.ops.resize import resize_bilinear_u8_np
    t = torch.from_numpy(gray)[None]
    for hw in [(100, 133), (57, 81), (120, 160), (33, 47), (130, 170)]:
        assert np.array_equal(resize_u8(t, hw)[0].numpy(),
                              resize_bilinear_u8_np(gray, hw))
    s, sq, tl = integrals(t, True)
    s2, sq2, tl2 = ig(gray, True)
    assert np.array_equal(s[0].numpy(), s2)
    assert np.array_equal(sq[0].numpy(), sq2)
    assert np.array_equal(tl[0].numpy(), tl2)
    assert np.array_equal(tl[0].numpy(), tilted_integral(t[0]).numpy())


def test_grouping_equal(monkeypatch):
    monkeypatch.setenv("CLFD_NO_NATIVE", "1")
    from clfacedetection_torch.detect.grouping import group_rectangles as gp
    rng = np.random.default_rng(0)
    for _ in range(100):
        base = rng.integers(0, 200, (5, 2))
        b = []
        for _ in range(int(rng.integers(0, 60))):
            c, s = base[rng.integers(0, 5)], int(rng.integers(20, 60))
            b.append([c[0] + rng.integers(-5, 6), c[1] + rng.integers(-5, 6),
                      s, s])
        b = np.asarray(b, np.int64).reshape(-1, 4)
        for th in (1, 3):
            a1, n1 = group_rectangles(b, th)
            a2, n2 = gp(b, th)
            assert sorted(map(tuple, np.c_[a1, n1].tolist())) == \
                sorted(map(tuple, np.c_[a2, n2].tolist()))


def _floor_check(c, d, det):
    """The floor's cascade operations equal the program's scalar floor
    without its prep (the program counts prep over its packed canvas)."""
    from clfacedetection_torch.utils.flops import scalar_floor_flops
    theirs = scalar_floor_flops(det, d.entering)
    prep = 14.0 * det.plan.canvas_h * det.plan.canvas_w
    ours = flops.floor([c], [d], "scale_image")
    assert ours["cascade_ops"] == pytest.approx(
        theirs["scalar_floor_flops"] - prep, rel=1e-12)


@pytest.mark.parametrize("name", NAMES)
def test_scale_image_equal_plain(gray, name):
    from clfacedetection_torch import PyramidDetector, load_cascade
    c = Cascade(_path(name))
    d = detect(c, torch.from_numpy(gray)[None], _cfg("scale_image"))[0]
    det = PyramidDetector(load_cascade(_path(name)), gray.shape, 1.1,
                          (20, 20), dtype=torch.float64, device="cpu")
    cand, _ = det.candidates(gray)
    assert sorted(map(tuple, cand.tolist())) == \
        sorted(map(tuple, d.candidates.tolist()))
    assert np.array_equal(det.stage_entering_counts(gray), d.entering)
    _floor_check(c, d, det)


@pytest.mark.parametrize("name", ["frontalface_default", "upperbody"])
def test_scale_cascade_equal_plain(gray, name):
    from clfacedetection_torch import ScaleCascadeDetector, load_cascade
    c = Cascade(_path(name))
    d = detect(c, torch.from_numpy(gray)[None], _cfg("scale_cascade"))[0]
    det = ScaleCascadeDetector(load_cascade(_path(name)), gray.shape, 1.1,
                               (20, 20), dtype=torch.float64, device="cpu")
    cand, _ = det.candidates(gray)
    assert sorted(map(tuple, cand.tolist())) == \
        sorted(map(tuple, d.candidates.tolist()))


@pytest.mark.parametrize("name,mode,mn", [
    ("frontalface_alt", "scale_image", 3),
    ("frontalface_default", "scale_cascade", 0)])
def test_golden_equal(name, mode, mn):
    from clfacedetection_torch import load_cascade
    from clfacedetection_torch.detect.reference_impl import \
        detect_multi_scale_reference
    g = frames.photo_scene((72, 96), (30,), 5)
    d = detect(Cascade(_path(name)), torch.from_numpy(g)[None],
               _cfg(mode, mn))[0]
    ref = detect_multi_scale_reference(g, load_cascade(_path(name)), 1.1, mn,
                                       (20, 20), mode=mode)
    assert sorted(map(tuple, d.boxes.tolist())) == \
        sorted(map(tuple, np.asarray(ref).tolist()))


def test_reference_imports_nothing_of_the_program():
    import ast
    for f in os.listdir(os.path.join(ROOT, "reference")):
        if not f.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(ROOT, "reference", f)).read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for n in names:
                assert n.split(".")[0] not in (
                    "clfacedetection_torch", "clfacedetection_tpu", "jax",
                    "jaxlib", "flax"), (f, n)
