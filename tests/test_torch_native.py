"""The port's native library against the JAX package's numpy specifications.

``clfacedetection_torch/native`` builds its own copies of
``grouping.cpp`` and ``haar_oracle.cpp``.  Its grouping (both variants)
and partition are held equal to the JAX package's numpy grouping, run
under ``CLFD_NO_NATIVE=1`` so that no test here calls the JAX package's
own native build; its ``COracle`` is held to the JAX package's numpy
window oracle (``RefWindowEvaluator``) on stump, CART, stage-tree and
tilted cascades, and then drives full-depth parity of the port's float64
CPU path.  Two processes building the library into one fresh directory
at once both load a working copy.
"""

import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from clfacedetection_tpu.detect import grouping as jgrouping
from clfacedetection_tpu.detect.reference_impl import (RefWindowEvaluator,
                                                       _integrals)
from clfacedetection_tpu.models import load_cascade as j_load_cascade
from clfacedetection_tpu.models.compile import (compile_cascade,
                                                truncate_cascade)

import clfacedetection_torch as ct
from clfacedetection_torch import native
from clfacedetection_torch.detect import grouping as tgrouping
from clfacedetection_torch.utils import synth_face, synth_scene

torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _random_boxes(rng, n):
    # clustered boxes: a few centres with jitter, plus outliers
    centers = rng.integers(0, 400, (max(n // 8, 1), 4))
    centers[:, 2:] = rng.integers(20, 120, (len(centers), 2))
    picks = centers[rng.integers(0, len(centers), n)]
    jitter = rng.integers(-6, 7, (n, 4))
    return np.maximum(picks + jitter, 1)


def test_the_library_builds_into_the_package():
    assert native.native_available(), native.native_error()
    path = native.build()
    assert os.path.dirname(path) == os.path.join(
        _REPO, "clfacedetection_torch", "build")
    assert os.path.basename(path).startswith("libclfd_native_")


@pytest.mark.parametrize("variant", ["opencv", "clod"])
@pytest.mark.parametrize("thr", [1, 2, 3])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_native_grouping_equals_jax_spec(seed, thr, variant, monkeypatch):
    boxes = _random_boxes(np.random.default_rng(seed), 120)
    nb, nn = native.group_rectangles_native(boxes, thr, 0.2, variant)
    monkeypatch.setenv("CLFD_NO_NATIVE", "1")
    jb, jn = jgrouping.group_rectangles(boxes, thr, 0.2, variant)
    np.testing.assert_array_equal(nb, jb)
    np.testing.assert_array_equal(nn, jn)
    assert nb.dtype == jb.dtype and nn.dtype == jn.dtype
    # the port's numpy route (the specification) equals its native route
    pb, pn = tgrouping.group_rectangles(boxes, thr, 0.2, variant)
    np.testing.assert_array_equal(pb, nb)
    np.testing.assert_array_equal(pn, nn)
    monkeypatch.delenv("CLFD_NO_NATIVE")
    gb, gn = tgrouping.group_rectangles(boxes, thr, 0.2, variant)
    np.testing.assert_array_equal(gb, nb)
    np.testing.assert_array_equal(gn, nn)


def test_group_rectangles_takes_the_native_route(monkeypatch):
    calls = []
    real = tgrouping.group_rectangles_native
    monkeypatch.setattr(tgrouping, "group_rectangles_native",
                        lambda *a: calls.append(a) or real(*a))
    boxes = _random_boxes(np.random.default_rng(5), 40)
    tgrouping.group_rectangles(boxes, 2)
    assert len(calls) == 1 and calls[0][3] == "opencv"
    monkeypatch.setenv("CLFD_NO_NATIVE", "1")
    tgrouping.group_rectangles(boxes, 2, variant="clod")
    assert len(calls) == 1


@pytest.mark.parametrize("seed", [9, 10])
def test_native_partition_equals_jax_spec(seed):
    boxes = _random_boxes(np.random.default_rng(seed), 80)
    nl, nc = native.partition_native(boxes, 0.2)
    jl, jc = jgrouping.partition_similar(boxes, 0.2)
    tl, tc = tgrouping.partition_similar(boxes, 0.2)
    assert nc == jc == tc
    np.testing.assert_array_equal(nl, jl)
    np.testing.assert_array_equal(tl, jl)


def test_native_empty_and_zero_threshold(monkeypatch):
    nb, nn = native.group_rectangles_native(np.zeros((0, 4)), 3)
    assert nb.shape == (0, 4) and len(nn) == 0
    boxes = np.array([[1, 2, 3, 4], [50, 60, 7, 8]])
    monkeypatch.setenv("CLFD_NO_NATIVE", "1")
    for thr in (0, -1):
        nb, nn = native.group_rectangles_native(boxes, thr)
        jb, jn = jgrouping.group_rectangles(boxes, thr)
        np.testing.assert_array_equal(nb, jb)
        np.testing.assert_array_equal(nn, jn)
        np.testing.assert_array_equal(nb, boxes)


def _cross_check(name, shape, size, seed, scales, step=3, max_stages=None):
    """The port's ``COracle`` and the JAX package's numpy oracle over a
    scan grid at each scale: codes equal, stage sums to double rounding
    (as tests/test_c_oracle.py); bounds-reject probes included."""
    spec = j_load_cascade(name)
    compiled = compile_cascade(spec)
    if max_stages is not None:
        compiled = truncate_cascade(compiled, max_stages)
        spec = compiled.spec
    img = synth_face(shape, size=size, seed=seed)
    s_img, sq_img, t_img = _integrals(np.asarray(img, np.uint8),
                                      compiled.has_tilted)
    co = native.COracle(spec)
    H, W = img.shape
    codes_seen = set()
    for f in scales:
        scaled = compiled.at_scale(f)
        ev = RefWindowEvaluator(compiled, scaled, s_img, sq_img, t_img)
        present = scaled.weight != 0.0
        ext_x_hi = max(int(scaled.corner_x[present].max()),
                       int(scaled.equ_corner_x.max()))
        ext_x_lo = min(int(scaled.corner_x[present].min()), 0)
        ext_y_hi = max(int(scaled.corner_y[present].max()),
                       int(scaled.equ_corner_y.max()))
        x_hi = min(W - scaled.win_w, W - ext_x_hi)
        y_hi = min(H - scaled.win_h, H - ext_y_hi)
        ys, xs = np.meshgrid(
            np.arange(0, y_hi + 1, step),
            np.arange(max(0, -ext_x_lo), x_hi + 1, step), indexing="ij")
        xs = np.concatenate([xs.ravel(), [-3, W - scaled.win_w + 1, 0]])
        ys = np.concatenate([ys.ravel(), [0, 0, H - scaled.win_h + 1]])
        ref = [ev.run_sum(int(x), int(y)) for x, y in zip(xs, ys)]
        ref_codes = np.array([r[0] for r in ref], np.int32)
        ref_sums = np.array([r[1] for r in ref], np.float64)
        co.set_images(s_img, sq_img, t_img, f)
        got_codes, got_sums = co.run(xs, ys)
        np.testing.assert_array_equal(got_codes, ref_codes,
                                      err_msg=f"scale {f}")
        np.testing.assert_allclose(got_sums, ref_sums, rtol=1e-12,
                                   atol=1e-9, err_msg=f"scale {f}")
        codes_seen.update(np.unique(ref_codes).tolist())
    return codes_seen


@pytest.mark.parametrize("name,kw", [
    ("haarcascade_frontalface_alt", dict(size=48.0, seed=3,
                                         scales=[1.0, 1.5])),
    ("haarcascade_frontalface_alt2", dict(size=48.0, seed=4,
                                          scales=[1.0, 1.7])),
    ("haarcascade_frontalface_alt_tree", dict(size=48.0, seed=5,
                                              scales=[1.0, 1.5])),
    ("haarcascade_mcs_nose", dict(size=56.0, seed=6, scales=[1.0, 1.4])),
], ids=["stump", "cart", "stage_tree", "tilted"])
def test_c_oracle_equals_jax_numpy_oracle(name, kw):
    codes = _cross_check(name, (72, 96), **kw)
    assert -1 in codes
    if "tree" in name:
        assert codes <= {-1, 0, 1}


def test_c_oracle_accepting_windows():
    """A cascade cut to 5 stages, so that windows pass: the agreement
    covers code 1 and deep stage sums too."""
    codes = _cross_check("haarcascade_frontalface_alt", (72, 96), size=48.0,
                         seed=7, scales=[1.0, 1.3], step=2, max_stages=5)
    assert 1 in codes


def _boxes_set(b):
    return set(map(tuple, np.asarray(b, np.int64).reshape(-1, 4).tolist()))


@pytest.mark.parametrize("name", ["haarcascade_frontalface_alt",
                                  "haarcascade_frontalface_alt2"])
def test_full_depth_float64_equals_c_oracle(name):
    """Full depth, no truncation: the port's float64 scale-image path on
    the CPU equals the port's C oracle box for box at 120x160."""
    spec = ct.load_cascade(name)
    gray = synth_scene((120, 160), faces=((60, 80, 70.0),), seed=9)
    det = ct.PyramidDetector(spec, gray.shape, dtype=torch.float64,
                             device="cpu")
    got, ovf = det.candidates(gray)
    assert not ovf
    ref = native.oracle_candidates(gray, spec, "scale_image")[0]
    assert len(ref) > 0
    assert _boxes_set(got) == set(ref)


def test_full_depth_scale_cascade_float64_equals_c_oracle():
    spec = ct.load_cascade("haarcascade_frontalface_default")
    gray = synth_scene((96, 128), faces=((48, 64, 56.0),), seed=9)
    det = ct.ScaleCascadeDetector(spec, gray.shape, dtype=torch.float64,
                                  device="cpu")
    got, ovf = det.candidates(gray)
    assert not ovf
    ref = native.oracle_candidates(gray, spec, "scale_cascade")[0]
    assert len(ref) > 0
    assert _boxes_set(got) == set(ref)


_BUILDER = textwrap.dedent("""
    import ctypes, importlib.util, sys, time
    import numpy as np
    spec = importlib.util.spec_from_file_location("clfd_native", sys.argv[1])
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    while time.time() < float(sys.argv[3]):
        time.sleep(0.005)
    lib = mod._bind(ctypes.CDLL(mod.build(sys.argv[2])))
    boxes = np.ascontiguousarray(
        [[10, 10, 50, 50], [11, 10, 50, 51], [200, 200, 30, 30]], np.int64)
    labels = np.empty(3, np.int32)
    n = lib.clfd_partition(mod._ptr(boxes, ctypes.c_int64), 3, 0.2,
                           mod._ptr(labels, ctypes.c_int32))
    print(n, labels.tolist())
""")


def test_two_processes_build_one_fresh_directory(tmp_path):
    """Both builders block on the directory's lock; the second finds the
    first's finished library; each loads a working copy, and no temporary
    file is left behind."""
    src = os.path.join(_REPO, "clfacedetection_torch", "native",
                       "__init__.py")
    build_dir = str(tmp_path / "build")
    start = f"{time.time() + 2.0}"
    procs = [subprocess.Popen([sys.executable, "-c", _BUILDER, src,
                               build_dir, start], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.split("\n")[0] == "2 [0, 0, 1]"
    libs = [f for f in os.listdir(build_dir) if f.endswith(".so")]
    assert len(libs) == 1
    assert sorted(os.listdir(build_dir)) == sorted(libs + ["native.lock"])


def test_timing_helpers_on_the_cpu(tmp_path):
    from clfacedetection_torch.utils import (ElapseTime, profile_trace,
                                             time_torch)
    t = ElapseTime()
    t.start()
    calls = []
    ms, out = time_torch(lambda x: calls.append(x) or x + 1, 41, iters=3,
                         warmup=2, device="cpu")
    assert out == 42 and len(calls) == 5 and ms >= 0.0
    assert t.get() >= 0.0
    with profile_trace(str(tmp_path / "trace"), cuda=False) as prof:
        torch.ones(64).sum()
    assert len(prof.key_averages()) > 0
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
