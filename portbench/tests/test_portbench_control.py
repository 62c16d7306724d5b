"""The comparison that decides ``correct`` fails where it should: the
bfloat16 control put in the program's place, and a run with the timed
path broken underneath (half of a batch left out, an answer altered where
it is produced, a stale answer) come out not correct; the program's own
run comes out correct.  On the CPU at a small size; the control at the
cells' own size on a card."""

import time

import numpy as np
import pytest
import torch

from portbench.control import readings
from portbench.harness.bench import run
from portbench.harness.cell import Cell

SMALL = {"config": {"frame": [120, 160], "min_size": [20, 20]},
         "traffic": {"pool": 8, "sizes": [30, 35, 40], "batch": 4,
                     "trace_frames": 4, "rate": 20}}
CELLS = ["alt-1080p-stream-photo", "default-vga-demo-camera",
         "multi5-1080p-stream-photo", "alt-1080p-live-photo"]


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _over(cell, worst):
    limits = Cell(cell, torch.device("cpu")).limits
    return [k for k in limits if worst[k] > limits[k]]


@pytest.mark.parametrize("cell", ["alt-1080p-stream-photo",
                                  "default-vga-demo-camera"])
def test_control_fails_program_passes(cell):
    rows = readings(cell, [3], [3], 0.2, device="cpu", overrides=SMALL)
    got = {kind: r for kind, _, r in rows}
    assert got["program"]["judged"] > 0 and not _over(cell, got["program"])
    assert _over(cell, got["control"])


def _shift(results):
    return [(c + np.array([2, 0, 0, 0]), o) for c, o in results]


def _faulty(monkeypatch, fault):
    """Break the program's timed path where it produces its answer."""
    from clfacedetection_torch.detect import detector, pyramid
    from clfacedetection_torch.runtime import batch
    unpack = pyramid.PyramidDetector.unpack
    cands = detector.ScaleCascadeDetector.candidates
    finish = batch.finish
    last = {}
    if fault == "half_batch":
        def f(self, *a, **k):
            out = unpack(self, *a, **k)
            h = len(out) // 2
            return out[:h] + [(np.zeros((0, 4), np.int32), o)
                              for _, o in out[h:]]
        monkeypatch.setattr(pyramid.PyramidDetector, "unpack", f)
    elif fault == "altered":
        monkeypatch.setattr(pyramid.PyramidDetector, "unpack",
                            lambda self, *a, **k: _shift(
                                unpack(self, *a, **k)))
        monkeypatch.setattr(detector.ScaleCascadeDetector, "candidates",
                            lambda self, g: _shift([cands(self, g)])[0])
    elif fault == "stale":
        # each frame's answer is the one before it
        def stale(fn):
            def f(*a, **k):
                out = fn(*a, **k)
                prev, last[fn] = last.get(fn, out), out
                return prev
            return f
        monkeypatch.setattr(batch, "finish", stale(finish))
        monkeypatch.setattr(detector.ScaleCascadeDetector, "candidates",
                            stale(cands))


@pytest.mark.parametrize("cell,fault", [
    ("alt-1080p-stream-photo", None),
    ("alt-1080p-stream-photo", "half_batch"),
    ("alt-1080p-stream-photo", "altered"),
    ("alt-1080p-stream-photo", "stale"),
    ("default-vga-demo-camera", None),
    ("default-vga-demo-camera", "altered"),
    ("default-vga-demo-camera", "stale"),
    ("multi5-1080p-stream-photo", "half_batch"),
    ("alt-1080p-live-photo", None),
    ("alt-1080p-live-photo", "altered")])
def test_fault_not_correct(monkeypatch, cell, fault):
    if fault:
        _faulty(monkeypatch, fault)
    r = run(cell, 2 ** 31 + 17, 0.3, False, time.perf_counter(),
            device="cpu", overrides=SMALL)
    assert r["correct"] is (fault is None), r["checks"]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_on_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    rows = readings(cell, [7], [7], 2.0)
    got = {kind: r for kind, _, r in rows}
    assert not _over(cell, got["program"]) and _over(cell, got["control"])
