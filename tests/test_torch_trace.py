"""The port's counters and spans (``clfacedetection_torch/trace.py``), on
the CPU at small frames.

Off (no profiler recording), ``span`` never enters a record function
and no span total moves, while the counters count; under
``torch.profiler`` the stream's spans count its batches and the entry's
its calls, on both threads, each within the spans that enclosed it, and
the profiler's events hold the enqueue thread's; ``frames``,
``candidates`` and ``boxes`` equal the results served, ``survivors``
and ``accepted`` the packed readbacks' columns, with each frame counted
once through a cap regrowth, and ``served.walk_*`` those of the
cascades whose tail is the walk alone; the classifier's detector cache
counts one build and then hits; one counter bumped from many threads
loses no add.
"""

import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import clfacedetection_torch as ct
from clfacedetection_torch import trace
from clfacedetection_torch.utils import synth_face

# one torch thread per test worker process
torch.set_num_threads(1)

SHAPE = (120, 160)
CASCADE = "haarcascade_frontalface_alt"
KNOBS = dict(max_stages=6, front_stages=5, scale_factor=1.3, min_size=(30, 30))


def _batches(n=2):
    return [np.stack([synth_face(SHAPE, size=36.0 + 6 * i, seed=10 * i + j)
                      for j in range(2)]) for i in range(n)]


def _stream():
    # a cap of every window: no batch runs again
    det = ct.BatchedPyramidDetector(ct.load_cascade(CASCADE), SHAPE, 2,
                                    device="cpu", cap=4096, **KNOBS)
    return det, list(det.detect_stream(iter(_batches()), 3, depth=2,
                                       threaded=True))


def _since(before):
    now = trace.counters()
    return {k: v - before.get(k, 0) for k, v in now.items()}


def _spans_since(before):
    def less(v, w):
        if isinstance(v, dict):
            return {k: x - (w or {}).get(k, 0) for k, x in v.items()}
        return v - (w or 0)
    return {k: {f: less(x, before.get(k, {}).get(f)) for f, x in v.items()}
            for k, v in trace.spans().items()}


def _served(out, field):
    return sum(len(getattr(r, field)) for batch in out for r in batch)


def test_off_spans_record_nothing(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a record function made with tracing off")

    monkeypatch.setattr(trace, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(trace._profiler, "record_function", refuse)
    assert trace.span("a") is trace.span("b", 1)    # one shared null context
    spans, counts = trace.spans(), trace.counters()
    _, out = _stream()
    assert trace.spans() == spans
    assert _since(counts)["frames"] == sum(len(r) for r in out) == 4


def test_stream_spans_under_the_profiler():
    spans, counts = trace.spans(), trace.counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        det, out = _stream()
    got = _spans_since(spans)
    moved = _since(counts)
    assert moved["frames"] == 4 and not moved.get("stream.reruns")
    assert moved["candidates"] == _served(out, "candidates") > 0
    assert moved["boxes"] == _served(out, "boxes")
    for name in ("stream.enqueue", "stream.drain", "stream.wait",
                 "host.unpack", "host.group", "program.read"):
        assert got[name]["count"] == 2, name
    for v in got.values():
        assert 0 <= v["self_seconds"] <= v["seconds"] + 1e-9
    # the drain's children ran on the drain thread, inside its span
    assert got["stream.drain"]["self_seconds"] < got["stream.drain"]["seconds"]
    for name in ("host.unpack", "host.group", "program.read"):
        assert got[name]["within"]["stream.drain"] == pytest.approx(
            got[name]["seconds"]), name
        assert not got[name]["within"].get("stream.enqueue"), name
    names = {e.name for e in prof.events()}
    assert "clfd.stream.enqueue" in names


@pytest.mark.parametrize("cap", [None, 64])
def test_counters_are_the_packed_readbacks(cap):
    knobs = {} if cap is None else dict(cap=cap)
    det = ct.BatchedPyramidDetector(ct.load_cascade(CASCADE), SHAPE, 2,
                                    device="cpu", **dict(KNOBS, **knobs))
    counts = trace.counters()
    frames = _batches(1)[0]
    det.detect(frames)
    moved = _since(counts)
    packed = det.det._detect_device(det.det.put(frames),
                                    det.det.cap)["packed"].numpy()
    assert moved["frames"] == 2
    assert moved["survivors"] == packed[:, 0].sum() > 0
    assert moved["accepted"] == packed[:, 1].sum() > 0
    assert moved.get("cap.regrowths", 0) >= (cap is not None)
    assert not any(moved.get(k) for k in moved
                   if k.startswith("launches.") or k == "program.replays")


WALK = ("served.walk_survivors", "served.walk_accepted", "served.walk_slots")


def _packed(det, frames):
    """A detector's packed readback of ``frames`` at its cap now."""
    return det._detect_device(det.put(frames), det.cap)["packed"].numpy()


@pytest.mark.parametrize("path", ["detect", "stream"])
@pytest.mark.parametrize("cascade,walk", [
    ("haarcascade_frontalface_alt2", True),     # CART: the walk tail
    ("haarcascade_frontalface_alt", False)])    # stumps: tail2
def test_walk_counters_are_the_walk_cascades_readbacks(cascade, walk, path):
    det = ct.BatchedPyramidDetector(ct.load_cascade(cascade), SHAPE, 2,
                                    device="cpu", cap=4096, **KNOBS)
    assert det.det.walk_tail == walk and det.det.use_tail2 != walk
    batches = _batches()
    counts = trace.counters()
    if path == "detect":
        for b in batches:
            det.detect(b)
    else:
        list(det.detect_stream(iter(batches), 3, depth=2, threaded=True))
    moved = _since(counts)
    packed = np.concatenate([_packed(det.det, b) for b in batches])
    assert moved["survivors"] == packed[:, 0].sum() > 0
    if not walk:
        assert not any(moved.get(k) for k in WALK)
        return
    assert moved["served.walk_survivors"] == packed[:, 0].sum()
    assert moved["served.walk_accepted"] == packed[:, 1].sum() > 0
    assert moved["served.walk_slots"] == len(packed) * det.det.cap


def test_multi_cascade_counts_only_the_walk_cascades():
    specs = [ct.load_cascade(n) for n in ("haarcascade_frontalface_alt",
                                          "haarcascade_frontalface_alt2")]
    det = ct.MultiCascadeBatchedDetector(specs, SHAPE, 2, device="cpu",
                                         cap=4096, **KNOBS)
    assert [s.walk_tail for s in det.subs] == [False, True]
    frames = _batches(1)[0]
    counts = trace.counters()
    det.detect(frames)
    moved = _since(counts)
    tail2, walk = (_packed(s, frames) for s in det.subs)
    assert moved["survivors"] == tail2[:, 0].sum() + walk[:, 0].sum()
    assert moved["served.walk_survivors"] == walk[:, 0].sum() > 0
    assert moved["served.walk_accepted"] == walk[:, 1].sum()
    assert moved["served.walk_slots"] == 2 * det.subs[1].cap


@pytest.mark.parametrize("mode", ["scale_image", "scale_cascade"])
def test_classifier_builds_once_then_hits(mode):
    clf = ct.CascadeClassifier(CASCADE, device="cpu", mode=mode)
    frame = _batches(1)[0][0]
    spans, counts = trace.spans(), trace.counters()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            clf.detect_multi_scale_full(frame, min_size=(40, 40),
                                        max_stages=3)
    moved, got = _since(counts), _spans_since(spans)
    assert moved["detector.built"] == 1 and moved["detector.cache_hits"] == 1
    assert moved["detector.build_s"] > 0 and moved["frames"] == 2
    assert got["entry.detect"]["count"] == 2
    assert got["entry.build"]["count"] == 1
    assert got["host.group"]["count"] == 2
    assert got["host.unpack"]["count"] >= 2     # and once a cap regrowth


def test_counter_adds_from_many_threads_are_kept():
    n, k = 16, 2000
    before = trace.counters().get("test.adds", 0)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [trace.count("test.adds") for _ in range(k)])
            for _ in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert trace.counters()["test.adds"] - before == n * k


def test_launch_count_adds_its_amounts(monkeypatch):
    """``kernels.count(wrapper, more)`` adds one launch of the wrapper and
    each of ``more``'s amounts to its counter (tail2 adds the slots it
    launched, ``tail2.slots``); under a CUDA graph capture, nothing."""
    from clfacedetection_torch import kernels

    def haar_tail2():
        """A stand-in named as the wrapper."""

    capturing = [False]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing[0])
    before = trace.counters()
    kernels.count(haar_tail2, {"tail2.slots": 8 * 1024})
    kernels.count(haar_tail2, {"tail2.slots": 16})
    kernels.count(haar_tail2)
    capturing[0] = True
    kernels.count(haar_tail2, {"tail2.slots": 1})
    after = trace.counters()
    assert after["launches.haar_tail2"] - before.get(
        "launches.haar_tail2", 0) == 3
    assert after["tail2.slots"] - before.get("tail2.slots", 0) == 8 * 1024 + 16
