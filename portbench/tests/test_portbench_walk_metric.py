"""``walk_survivors_per_frame.frames`` on a fake context: the walk's
survivors a frame, its slot use and yield from the program's counters,
``walk_kernel``'s ms a frame from a traced slice's kernels; None where
the program has no walk counters (a checkout from before them) or no
counters at all."""

import pytest

from portbench.harness.cell import load_module

NAME = "walk_survivors_per_frame.frames"
COUNTERS = {"frames": 16, "survivors": 6000, "accepted": 60,
            "served.walk_survivors": 4000, "served.walk_accepted": 40,
            "served.walk_slots": 16000}
KERNELS = {"void (anonymous namespace)::walk_kernel<false, true>"
           "((anonymous namespace)::Walk)": [4, 0.006],
           "void (anonymous namespace)::walk_kernel<true, true>"
           "((anonymous namespace)::Walk)": [4, 0.002],
           "(anonymous namespace)::tail2_kernel((anonymous namespace)"
           "::Tail2)": [4, 0.001],
           "void at::native::walk_kernel_unrelated<int>(int)": [1, 1.0]}


@pytest.fixture
def counters(monkeypatch):
    from clfacedetection_torch import trace
    state = dict(COUNTERS)
    monkeypatch.setattr(trace, "counters", lambda: dict(state))
    return state


def _read(ctx):
    return load_module("metrics", NAME).read(ctx)


def test_quotients(counters):
    r = _read(dict(trace=None, slice_frames=None))
    assert r["value"] == 250 and r["frames"] == 16
    assert r["walk_slot_use_pct"] == pytest.approx(25.0)
    assert r["walk_yield_pct"] == pytest.approx(1.0)
    assert "walk_ms" not in r
    # traced: both instantiations of walk_kernel, nothing else, a frame
    r = _read(dict(trace=dict(kernels=KERNELS), slice_frames=4))
    assert r["walk_ms"] == pytest.approx(2.0)


def test_none_without_the_counters(counters, monkeypatch):
    for k in ("served.walk_survivors", "served.walk_accepted",
              "served.walk_slots"):
        del counters[k]
    assert _read(dict(trace=None, slice_frames=None)) is None
    counters.clear()
    assert _read(dict(trace=None, slice_frames=None)) is None
