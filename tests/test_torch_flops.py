"""The port's arithmetic accounting (``utils/flops.py``) and its work
profile (``PyramidDetector.stage_entering_counts``) against the JAX
package's, on the CPU.

Exact equality: the entering counts, ``pipeline_flops``'s useful fields
(algorithmic: the same cascade, frame and knobs give the same counts) and
all of ``scalar_floor_flops``.  The executed fields describe the port's
own schedule (the front kernel's 64x128 block tiles; the direct
strategy's stencil product) and are held to a hand count.  Then the
port's counterparts of ``tests/test_scalar_floor.py``: monotone counts,
the last count equal to a full-depth detector's candidates, ``ent[k]``
equal to the survivors of a ``front_stages=k`` detector, a floor that
does not depend on the handoff depth, and stage trees refused.
"""

import numpy as np
import pytest
import torch

from clfacedetection_tpu.detect.pyramid import PyramidDetector as JDet
from clfacedetection_tpu.models import load_cascade as j_load_cascade
from clfacedetection_tpu.utils import flops as jflops
from clfacedetection_tpu.utils import synth_scene

import clfacedetection_torch as ct
from clfacedetection_torch.utils import flops as tflops

# The suite runs in several worker processes at once; one torch thread
# each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

SHAPE = (96, 128)
NAME = "haarcascade_frontalface_default"
STAGES = 8
USEFUL = ("useful_flops", "front_ops_per_position", "tail_nodes",
          "visit_positions")


@pytest.fixture(scope="module")
def scene():
    return synth_scene(SHAPE, faces=((48, 40, 30.0),), seed=1, texture=40.0)


@pytest.fixture(scope="module")
def spec():
    return ct.load_cascade(NAME)


def _det(spec, **kw):
    return ct.PyramidDetector(spec, SHAPE, max_stages=STAGES, device="cpu",
                              **kw)


@pytest.fixture(scope="module")
def ent(spec, scene):
    return _det(spec).stage_entering_counts(scene)


@pytest.fixture(scope="module")
def jax_ent(scene):
    jd = JDet(j_load_cascade(NAME), SHAPE, max_stages=STAGES)
    return jd.stage_entering_counts(scene)


def test_entering_counts_equal_jax(ent, jax_ent):
    assert ent.dtype == np.int64
    np.testing.assert_array_equal(ent, jax_ent)


def test_entering_counts_shape_and_monotone(spec, ent):
    det = _det(spec)
    assert len(ent) == det.n_stages + 1
    assert ent[0] == det.n_visit
    assert all(ent[i] >= ent[i + 1] for i in range(len(ent) - 1))


def test_entering_final_equals_full_depth_candidates(spec, scene, ent):
    cand, _ = _det(spec, front_stages=STAGES).candidates(scene)
    assert len(cand) == ent[-1]


@pytest.mark.parametrize("k", [2, 5])
def test_entering_matches_front_survivors_at_handoff(spec, scene, ent, k):
    """A ``front_stages=k`` detector's packed readback: its ``n_surv``
    (the front and compaction count) is the windows entering stage k."""
    det = _det(spec, front_stages=k, cap=int(ent[0]))
    out = det._detect_device(det.put(scene), det.cap)
    assert int(out["packed"][0, 0]) == ent[k], (k, list(ent))


@pytest.mark.parametrize("front", [2, 8])
def test_flops_equal_jax(spec, scene, ent, jax_ent, front):
    """``pipeline_flops``'s useful fields and ``scalar_floor_flops``
    equal JAX's; the floor is the same at both handoff depths."""
    det = _det(spec, front_stages=front)
    jd = JDet(j_load_cascade(NAME), SHAPE, max_stages=STAGES,
              front_stages=front)
    got = tflops.pipeline_flops(det, ent[front])
    want = jflops.pipeline_flops(jd, jax_ent[front])
    assert {k: got[k] for k in USEFUL} == {k: want[k] for k in USEFUL}
    floor = tflops.scalar_floor_flops(det, ent)
    jfloor = jflops.scalar_floor_flops(jd, jax_ent)
    assert floor["scalar_floor_flops"] == jfloor["scalar_floor_flops"]
    assert floor["scalar_node_evals"] == jfloor["scalar_node_evals"]
    np.testing.assert_array_equal(floor["entering_per_stage"],
                                  jfloor["entering_per_stage"])
    # the floor does not depend on the handoff depth
    other = _det(spec, front_stages=10 - front)
    again = tflops.scalar_floor_flops(other, ent)
    assert again["scalar_floor_flops"] == floor["scalar_floor_flops"]
    assert again["scalar_node_evals"] == floor["scalar_node_evals"]
    with pytest.raises(ValueError):
        tflops.scalar_floor_flops(det, ent[:-1])


@pytest.mark.parametrize("strategy", [None, "direct"])
def test_executed_fields_hand_count(spec, strategy):
    """The front's grid: the canvas rounded up to 64 rows and 128
    columns, the kernel's block tile; the direct tail's product
    ``2 * cap * (h0+1)(w0+1) * n_clf*T``, none for the kernel tails."""
    det = _det(spec, strategy=strategy)
    fl = tflops.pipeline_flops(det, 100)
    rows = -(-(det.plan.canvas_h + 1) // 64) * 64
    cols = -(-(det.plan.canvas_w + 1) // 128) * 128
    assert fl["grid_positions"] == rows * cols
    prep = 14.0 * det.plan.canvas_h * det.plan.canvas_w
    assert fl["executed_vpu_ops"] == \
        prep + fl["front_ops_per_position"] * rows * cols
    mm = 2.0 * det.cap * 25 * 25 * det.table.n_clf * det.table.T
    assert fl["executed_mxu_flops_ub"] == (mm if strategy else 0.0)


def test_peaks_are_the_h100s():
    """The module holds the H100 SXM5 data sheet's dense peaks and no
    TPU figure."""
    assert tflops.PEAK_FLOPS_BF16 == 989.4e12
    assert tflops.PEAK_FLOPS_F32_HIGHEST == 66.9e12
    assert tflops.PEAK_BYTES == 3.35e12
    for v in (tflops.PEAK_FLOPS_BF16, tflops.PEAK_FLOPS_F32_HIGHEST):
        assert v not in (197e12, 197e12 / 6.0)
    assert (tflops.RECT_OPS, tflops.NODE_OPS, tflops.VAR_OPS) == \
        (jflops.RECT_OPS, jflops.NODE_OPS, jflops.VAR_OPS)


def test_stage_tree_cascades_rejected():
    det = ct.PyramidDetector(ct.load_cascade(
        "haarcascade_frontalface_alt_tree"), SHAPE, device="cpu")
    with pytest.raises(ValueError):
        det.stage_entering_counts(np.zeros(SHAPE, np.uint8))
