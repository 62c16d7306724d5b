"""The port's numpy host layer against the JAX package's.

Cascade loading, compiled tables, the packed pyramid plan and grouping
must be EQUAL (they are numpy in both packages), and the port must import
and run with JAX absent.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from clfacedetection_tpu.detect import detector as jdetector
from clfacedetection_tpu.detect.grouping import \
    group_rectangles as j_group_rectangles
from clfacedetection_tpu.detect.grouping import \
    group_rectangles_levels as j_group_rectangles_levels
from clfacedetection_tpu.detect.pyramid import PyramidPlan as JPlan
from clfacedetection_tpu.models import compile as jcompile
from clfacedetection_tpu.models import load_cascade as j_load_cascade
from clfacedetection_tpu.models.spec import _ARRAY_FIELDS
from clfacedetection_tpu.utils import synth_face as j_synth_face
from clfacedetection_tpu.utils import synth_scene as j_synth_scene

from clfacedetection_torch.detect import detector as tdetector
from clfacedetection_torch.detect.grouping import \
    group_rectangles as t_group_rectangles
from clfacedetection_torch.detect.grouping import \
    group_rectangles_levels as t_group_rectangles_levels
from clfacedetection_torch.detect.pyramid import PyramidPlan as TPlan
from clfacedetection_torch.models import ARRAY_FIELDS, spec_from_arrays
from clfacedetection_torch.models import compile as tcompile
from clfacedetection_torch.models import load_cascade as t_load_cascade
from clfacedetection_torch.utils import synth_face as t_synth_face
from clfacedetection_torch.utils import synth_scene as t_synth_scene

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SLICE = ["haarcascade_eye", "haarcascade_frontalface_alt",
         "haarcascade_frontalface_default", "haarcascade_profileface"]


def _same_arrays(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k


@pytest.mark.parametrize("name", SLICE)
def test_load_cascade_and_spec_from_arrays(name):
    assert tuple(ARRAY_FIELDS) == tuple(_ARRAY_FIELDS)
    js = j_load_cascade(name)
    ts = t_load_cascade(name)
    conv = spec_from_arrays({f: getattr(js, f) for f in _ARRAY_FIELDS},
                            js.name, js.window_w, js.window_h)
    for spec in (ts, conv):
        assert (spec.name, spec.window_w, spec.window_h) == \
            (js.name, js.window_w, js.window_h)
        _same_arrays({f: getattr(spec, f) for f in ARRAY_FIELDS},
                     {f: getattr(js, f) for f in _ARRAY_FIELDS})
    assert (ts.n_stages, ts.n_classifiers, ts.is_stump_based,
            ts.has_tilted, ts.is_tree) == \
        (js.n_stages, js.n_classifiers, js.is_stump_based, js.has_tilted,
         js.is_tree)


@pytest.mark.parametrize("name", SLICE)
def test_compiled_tables_equal(name):
    jc = jcompile.compile_cascade(j_load_cascade(name))
    tc = tcompile.compile_cascade(t_load_cascade(name))
    jt = jdetector._build_clf_tables(jc, [1.0, 1.5])
    tt = tdetector._build_clf_tables(tc, [1.0, 1.5])
    fields = ("T", "n_clf", "corner_y", "corner_x", "weight", "use_tilted",
              "threshold", "left", "right", "alpha", "clf_stage",
              "clf_valid_nodes")
    _same_arrays({f: getattr(tt, f) for f in fields},
                 {f: getattr(jt, f) for f in fields})
    np.testing.assert_array_equal(tc.stage_threshold, jc.stage_threshold)
    assert tdetector._stage_paths(tc) == jdetector._stage_paths(jc)
    jtr, ttr = (jcompile.truncate_cascade(jc, 5),
                tcompile.truncate_cascade(tc, 5))
    np.testing.assert_array_equal(ttr.stage_threshold, jtr.stage_threshold)
    assert ttr.spec.n_stages == jtr.spec.n_stages == 5


def _level_row(lv):
    return (lv.factor, lv.h, lv.w, lv.oy, lv.ox, lv.ystep, lv.win_w,
            lv.win_h)


@pytest.mark.parametrize("shape", [(480, 640), (1080, 1920)])
@pytest.mark.parametrize("name", SLICE)
def test_pyramid_plan_equal(name, shape):
    js, ts = j_load_cascade(name), t_load_cascade(name)
    for sf, min_size in ((1.1, (40, 40)), (1.2, (0, 0))):
        jf = jcompile.scale_factors(js.window_w, js.window_h, shape[1],
                                    shape[0], sf, min_size, None,
                                    mode="scale_image")
        assert tcompile.scale_factors(ts.window_w, ts.window_h, shape[1],
                                      shape[0], sf, min_size, None) == jf
        jp = JPlan.build(js, shape, sf, min_size, None)
        tp = TPlan.build(ts, shape, sf, min_size, None)
        assert [_level_row(lv) for lv in tp.levels] == \
            [_level_row(lv) for lv in jp.levels]
        assert (tp.canvas_h, tp.canvas_w) == (jp.canvas_h, jp.canvas_w)
        jv = jp.visit_mask(js.window_w, js.window_h)
        np.testing.assert_array_equal(
            tp.visit_mask(ts.window_w, ts.window_h), jv)
        cy, cx = np.nonzero(jv)
        pick = np.random.default_rng(7).choice(len(cy), 2000)
        np.testing.assert_array_equal(tp.boxes_for(cy[pick], cx[pick]),
                                      jp.boxes_for(cy[pick], cx[pick]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_group_rectangles_equal(seed):
    rng = np.random.default_rng(seed)
    centres = rng.integers(0, 600, (12, 2))
    boxes = []
    for cx, cy in centres:
        size = int(rng.integers(20, 120))
        for _ in range(int(rng.integers(1, 30))):
            j = rng.integers(-4, 5, 3)
            boxes.append((cx + j[0], cy + j[1], size + j[2], size + j[2]))
    boxes = np.asarray(boxes, np.int32)
    for thr in (0, 1, 3, 5):
        jb, jn = j_group_rectangles(boxes, thr, eps=0.2)
        tb, tn = t_group_rectangles(boxes, thr, eps=0.2)
        np.testing.assert_array_equal(tb, jb)
        np.testing.assert_array_equal(tn, jn)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_group_rectangles_levels_equal(seed):
    """The ROC grouping: random clusters with levels that tie within a
    class (the larger weight wins), empty levels, thresholds 0-5."""
    rng = np.random.default_rng(seed)
    boxes = []
    for cx, cy in rng.integers(0, 600, (10, 2)):
        size = int(rng.integers(20, 120))
        for _ in range(int(rng.integers(1, 25))):
            j = rng.integers(-4, 5, 3)
            boxes.append((cx + j[0], cy + j[1], size + j[2], size + j[2]))
    boxes = np.asarray(boxes, np.int32)
    levels = rng.integers(16, 23, len(boxes)).astype(np.int32)
    weights = np.round(rng.normal(0.0, 2.0, len(boxes)), 1)
    for lv, wt in ((levels, weights), (np.zeros(0, np.int32),
                                       np.zeros(0, np.float64))):
        for thr in (0, 1, 3, 5, 18):
            want = j_group_rectangles_levels(boxes, lv, wt, thr, eps=0.2)
            got = t_group_rectangles_levels(boxes, lv, wt, thr, eps=0.2)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kind", ["face", "scene"])
def test_synth_images_equal(kind):
    if kind == "face":
        args = dict(shape=(97, 131), center=(40, 70), size=33.0, seed=4)
        j, t = j_synth_face(**args), t_synth_face(**args)
    else:
        args = dict(shape=(150, 210), seed=6,
                    faces=((70, 100, 50.0), (30, 40, 20.0)))
        j, t = j_synth_scene(**args), t_synth_scene(**args)
    assert t.dtype == j.dtype == np.uint8
    np.testing.assert_array_equal(t, j)


def test_port_runs_without_jax():
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        import clfacedetection_torch as ct
        from clfacedetection_torch.utils import synth_face
        assert not any(m == "jax" or m.startswith(("jax.",
                       "clfacedetection_tpu")) for m in sys.modules
                       if sys.modules[m] is not None)
        img = synth_face((120, 160))
        det = ct.PyramidDetector(ct.load_cascade(
            "haarcascade_frontalface_alt"), img.shape, max_stages=3,
            device="cpu")
        res = det.detect(img, min_neighbors=2)
        assert len(res.candidates) > 0 and len(res.boxes) > 0
        print("ok", len(res.candidates))
    """)
    env = dict(os.environ, PYTHONPATH=_REPO, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=_REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
