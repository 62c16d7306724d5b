"""The port's programs (``runtime/program.py``) on the CPU, where a
program is the eager function itself (a CUDA graph needs the card:
``chip_smoke.py``'s ``programs`` phase holds the graphs against the eager
path there).

* A program's packed readback equals ``_detect_device``'s, for every
  float32 strategy and the ROC output.
* The detector's one program, keyed by batch size and cap, is replaced
  when the cap grows or the batch size changes; a batch's handle keeps
  the program it ran on.
* Scale-cascade mode's split pack (the device part, then the readback)
  gives the candidates of the whole-frame program, of the eager host path
  and of the JAX package, in float32 and float64.
* Canny's bounded hysteresis says whether it reached the fixpoint, and the
  scale-cascade program regrows its step count until it does.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clfacedetection_tpu.detect import ScaleCascadeDetector as JScale
from clfacedetection_tpu.models import load_cascade as j_load_cascade
from clfacedetection_tpu.utils import synth_face

import clfacedetection_torch as ct
from clfacedetection_torch import trace
from clfacedetection_torch.detect.detector import ACCEPT_CAP
from clfacedetection_torch.ops.canny import canny, canny_np
from clfacedetection_torch.runtime import Program

# one torch thread per test worker process
torch.set_num_threads(1)

SHAPE = (96, 128)
DEFAULT = "haarcascade_frontalface_default"


@functools.lru_cache(maxsize=None)
def _face() -> np.ndarray:
    return synth_face(SHAPE, size=34.0, seed=4)


@pytest.mark.parametrize("name,knobs", [
    ("haarcascade_frontalface_alt", {}),                       # tail2
    ("haarcascade_frontalface_alt2", {}),                      # v1 tail
    ("haarcascade_frontalface_alt", {"strategy": "block"}),
    ("haarcascade_frontalface_alt", {"strategy": "direct"}),
    ("haarcascade_frontalface_alt2", {"output_levels": True}),  # ROC
])
def test_cpu_program_is_the_eager_function(name, knobs):
    det = ct.PyramidDetector(ct.load_cascade(name), SHAPE, max_stages=8,
                             device="cpu", **knobs)
    frames = np.stack([_face(), _face()[:, ::-1].copy()])
    prog = det.program(2, det.cap)
    assert isinstance(prog, Program) and not prog.graphed
    assert prog.names == (("packed", "packed_roc") if det.output_levels
                          else ("packed",))
    before = trace.counters().get("program.replays", 0)
    h = prog.run(frames)
    got = prog.read(h)
    assert prog.read(h) is got                  # read once, kept
    want = det._detect_device(det.put(frames), det.cap)
    for k in prog.names:
        np.testing.assert_array_equal(got[k], want[k].numpy())
    # no graph on the CPU
    assert trace.counters().get("program.replays", 0) == before
    assert int(got["packed"][:, 1].sum()) > 0
    # the entry point reads the same packed array
    cand, _ = det.readback(h, det.cap)[0]
    assert len(cand) == int(got["packed"][0, 1])


def test_step_snapshot_replaced_on_regrowth():
    """The detector keeps one program, keyed by its batch size and cap: a
    grown cap or another batch size replaces (and releases) it; a batch's
    handle keeps the program, so its cap, it ran on."""
    spec = ct.load_cascade("haarcascade_frontalface_alt")
    bd = ct.BatchedPyramidDetector(spec, SHAPE, 2, max_stages=8, cap=16,
                                   device="cpu")
    frames = np.stack([_face(), _face()])
    assert bd.det._program is None
    h = bd.run_device(frames)
    first = h.program
    assert first.key == (2, 16) and bd.det._program is first
    res = bd.detect(frames, min_neighbors=0)
    prog = bd.det._program
    assert bd.det.cap > 16 and prog.key == (2, bd.det.cap)
    assert prog is not first and h.program.key == (2, 16)
    # another batch size replaces the one program
    bd.det.candidates(frames[0])
    assert bd.det._program.key == (1, bd.det.cap)
    ref = ct.BatchedPyramidDetector(spec, SHAPE, 2, max_stages=8,
                                    device="cpu").detect(frames, 0)
    for r, w in zip(res, ref):
        np.testing.assert_array_equal(r.candidates, w.candidates)


@functools.lru_cache(maxsize=None)
def _jax_scale(dtype_name: str):
    jd = JScale(j_load_cascade(DEFAULT), SHAPE, max_stages=5,
                dtype=getattr(jnp, dtype_name))
    return jd.candidates(_face())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_scale_cascade_split_pack(dtype):
    det = ct.ScaleCascadeDetector(ct.load_cascade(DEFAULT), SHAPE,
                                  max_stages=5, dtype=dtype, device="cpu")
    cand, ov = det.candidates(_face())
    assert not ov and len(cand) > 0
    assert det._program.key == (det.cap, det._canny_steps)
    # the device part of the pack, then its readback
    frame = det.put(_face())
    dev = det._frame_device(frame, det.cap, det._canny_steps)
    cap = det.cap
    packed, full = det._pack([det._per_scale(det._prep(frame), k, cap)
                              for k in range(det.n_scales)],
                             cap, min(cap, ACCEPT_CAP))
    np.testing.assert_array_equal(dev["packed"].numpy(), packed)
    for a, b in zip((dev["sy"], dev["sx"], dev["ok"]), full):
        assert torch.equal(a, b)
    got = det.program().read(det.program().run(_face()))["packed"]
    np.testing.assert_array_equal(got, packed)
    # and the JAX package's candidates, in scan order
    jc, jov = _jax_scale("float32" if dtype == torch.float32 else "float64")
    assert not jov
    np.testing.assert_array_equal(cand, np.asarray(jc))


def test_canny_bounded_steps_and_regrowth():
    img = _face()
    want = canny_np(img, 0, 50)
    short, done = canny(torch.from_numpy(img), 0, 50, steps=1)
    assert int(done[0]) == 0 and not np.array_equal(short.numpy(), want)
    full, done = canny(torch.from_numpy(img), 0, 50, steps=256)
    assert int(done[0]) == 1
    np.testing.assert_array_equal(full.numpy(), want)
    spec = ct.load_cascade(DEFAULT)
    det = ct.ScaleCascadeDetector(spec, SHAPE, max_stages=5, device="cpu",
                                  do_canny_pruning=True)
    det._canny_steps = 1
    cand, _ = det.candidates(img)
    assert det._canny_steps > 1 and det._program.names == ("packed",
                                                           "canny_done")
    packed = det._scales_device(det._prep(det.put(img)), det.cap)[
        "packed"].numpy()
    ref = ct.ScaleCascadeDetector(spec, SHAPE, max_stages=5, device="cpu",
                                  do_canny_pruning=True, cap=det.cap)
    np.testing.assert_array_equal(cand, ref.candidates(img)[0])
    assert int(packed[:, 1].sum()) == len(cand) > 0
