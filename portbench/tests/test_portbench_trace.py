"""The trace summary on a synthetic slice, and the readers of the
program's spans and counters on a fake context.

``summarize`` gives the slice's window, busy time, kernels, copies and
idle gaps by the harness's spans at hand-computed values, whatever
``clfd.*`` spans of the program's lie among them.  Each reader gives its
value from the program's spans or counters, and None where the program
has none, or has no ``trace`` module at all (an older checkout)."""

import sys
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from portbench.harness.cell import load_module
from portbench.harness.trace import breakdown, summarize

CPU, CUDA = DeviceType.CPU, DeviceType.CUDA


def _ev(name, a, b, dev=CPU, thread=1):
    """A profiler event from a to b (microseconds)."""
    return SimpleNamespace(name=name, device_type=dev, thread=thread,
                           time_range=SimpleNamespace(start=a, end=b))


# the slice 0-100 microseconds; kernels 10-20 and 15-30, a copy 50-60, a
# set 90-95; idle 0-10, 30-50, 60-90, 95-100
EVENTS = [
    _ev("portbench.slice", 0, 100),
    _ev("portbench.slice", 0, 100, CUDA),           # a mirror: not work
    _ev("portbench.live.detect", 3, 96),
    _ev("clfd.entry.detect", 4, 96),
    _ev("clfd.program.load", 4, 9),
    _ev("clfd.program.wait", 32, 48),
    _ev("clfd.host.group", 62, 88),
    _ev("clfd.host.group", 55, 95, thread=2),       # another thread's
    _ev("k1", 10, 20, CUDA), _ev("k2", 15, 30, CUDA),
    _ev("Memcpy HtoD", 50, 60, CUDA), _ev("Memset", 90, 95, CUDA),
]


def test_summary_among_program_spans():
    s = summarize(EVENTS)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx(35e-6)
    assert s["kernels"] == {"k1": [1, pytest.approx(10e-6)],
                            "k2": [1, pytest.approx(15e-6)]}
    assert set(s["copies"]) == {"Memcpy HtoD", "Memset"}
    # the harness's spans: the last gap's middle (97.5) lies outside
    # live.detect
    assert s["idle"] == {"live.detect": pytest.approx(60e-6),
                         "harness": pytest.approx(5e-6)}
    b = breakdown(s)
    assert b["idle_gaps"][0] == ["live.detect", pytest.approx(60e-6)]


def _span(count, seconds, self_seconds, **within):
    return dict(count=count, seconds=seconds, self_seconds=self_seconds,
                within=within)


# waits inside the entry, the drain and a re-run on the enqueue thread
SPANS = {"entry.detect": _span(4, 0.040, 0.004),
         "program.wait": _span(6, 0.030, 0.030, **{
             "entry.detect": 0.020, "program.read": 0.030,
             "stream.drain": 0.006, "stream.rerun": 0.004}),
         "program.replay": _span(4, 0.004, 0.004, **{"entry.detect": 0.004}),
         "program.load": _span(4, 0.008, 0.008, **{"entry.detect": 0.008}),
         "host.group": _span(2, 0.006, 0.006),
         "stream.drain": _span(2, 0.030, 0.004)}
COUNTERS = {"frames": 10, "survivors": 5000, "accepted": 50,
            "candidates": 40, "boxes": 10, "program.slots_grown": 1,
            "program.warmup_s": 1.0, "program.capture_s": 0.5,
            "program.instantiate_s": 0.25, "program.captures": 2,
            "detector.build_s": 0.125, "kernels.library_s": 3.0}
CTX = dict(slice_frames=4, trace=dict(window_s=0.1))


@pytest.fixture
def program(monkeypatch):
    from clfacedetection_torch import trace
    state = dict(spans=SPANS, counters=COUNTERS)
    monkeypatch.setattr(trace, "spans", lambda: dict(state["spans"]))
    monkeypatch.setattr(trace, "counters", lambda: dict(state["counters"]))
    return state


def _read(name, ctx=CTX):
    return load_module("metrics", name).read(ctx)


def test_readers_on_a_fake_context(program):
    assert _read("group_ms.frames") == pytest.approx(1.5)
    # the drain's own waits come off it, not the re-run's
    d = _read("drain_busy_pct.frames")
    assert d["value"] == pytest.approx(24.0)
    assert d["program.slots_grown"] == 1 and d["program.stage_waits"] == 0
    for cell in ("live", "demo"):
        h = _read(f"host_ms.{cell}")
        # the entry's 40 ms less its 20 ms of waits and 4 of launch
        assert h["value"] == pytest.approx(4.0)
        assert h["program.replay_ms"] == pytest.approx(1.0)
        assert h["program.load_ms"] == pytest.approx(2.0)
        assert h["entry.detect.self_ms"] == pytest.approx(1.0)
    s = _read("survivors_per_frame.frames")
    assert s["value"] == 500 and s["tail_yield_pct"] == pytest.approx(1.0)
    assert s["candidates_per_frame"] == 4 and s["boxes_per_frame"] == 1
    p = _read("program_setup_s")
    assert p["value"] == pytest.approx(1.75)
    assert p["kernels.library_s"] == 3.0 and p["cap.regrowths"] == 0


NEW = ("group_ms.frames", "drain_busy_pct.frames", "host_ms.live",
       "host_ms.demo", "survivors_per_frame.frames", "program_setup_s")


@pytest.mark.parametrize("name", NEW)
def test_readers_without_spans_or_module(program, monkeypatch, name):
    import clfacedetection_torch
    program.update(spans={}, counters={})
    assert _read(name) is None
    # a checkout of the program from before its trace module
    monkeypatch.delattr(clfacedetection_torch, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "clfacedetection_torch.trace", None)
    program.update(spans=SPANS, counters=COUNTERS)
    assert _read(name) is None
