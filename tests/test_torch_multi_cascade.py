"""The port's ``MultiCascadeBatchedDetector`` on the CPU, against the JAX
package's and against the port's own per-cascade
``BatchedPyramidDetector``.

Three cascade sets: frontalface_default + profileface (stumps, tail2),
profileface + upperbody + fullbody (BASELINE config 5 at a small size:
tail2, then the v1 tail with tilted features) and frontalface_alt +
frontalface_alt2 (tail2 and the v1 tail in one program).  float32 on both
sides; each cascade's candidates equal JAX's set for set, and its grouped
boxes and neighbour counts are equal.  Also: a cascade with no pyramid
level gives empty results beside the others; only the cascade that
overflows grows its cap, in ``detect`` and in the middle of a stream; the
stream equals ``detect`` in order, threaded and unthreaded.
"""

import functools

import numpy as np
import pytest
import torch

from clfacedetection_tpu.models import load_cascade as j_load_cascade
from clfacedetection_tpu.runtime import MultiCascadeBatchedDetector as JMulti
from clfacedetection_tpu.utils import synth_face, synth_scene

import clfacedetection_torch as ct

# one torch thread per test worker process
torch.set_num_threads(1)

SHAPE = (96, 128)
# a coarse pyramid and a cap that never overflows keep the JAX compiles few
KNOBS = dict(max_stages=4, scale_factor=1.3)
SETS = {
    "stumps": ("haarcascade_frontalface_default", "haarcascade_profileface"),
    "config5": ("haarcascade_profileface", "haarcascade_upperbody",
                "haarcascade_fullbody"),
    "tail2_v1": ("haarcascade_frontalface_alt",
                 "haarcascade_frontalface_alt2"),
}
PAIR = SETS["stumps"]


@functools.lru_cache(maxsize=None)
def _frames() -> np.ndarray:
    return np.stack([synth_face(SHAPE, size=30.0, seed=i) for i in range(2)])


@functools.lru_cache(maxsize=None)
def _jax(set_name: str):
    specs = [j_load_cascade(n) for n in SETS[set_name]]
    return JMulti(specs, SHAPE, 2, cap=4096, **KNOBS).detect(
        _frames(), min_neighbors=2)


def _multi(names, shape=SHAPE, **kw):
    return ct.MultiCascadeBatchedDetector(
        [ct.load_cascade(n) for n in names], shape, 2, device="cpu",
        **dict(KNOBS, **kw))


def _same(a, b):
    return (np.array_equal(a.candidates, b.candidates)
            and np.array_equal(a.boxes, b.boxes)
            and np.array_equal(a.neighbors, b.neighbors)
            and a.survivor_overflow == b.survivor_overflow)


def _assert_same(got, want, names):
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w)
        for b in range(len(g)):
            assert _same(g[b], w[b]), f"{names[k]} frame {b}"


@pytest.mark.parametrize("set_name", sorted(SETS))
def test_multi_matches_jax(set_name):
    names = SETS[set_name]
    got = _multi(names).detect(_frames(), min_neighbors=2)
    want = _jax(set_name)
    assert len(got) == len(names)
    for k, name in enumerate(names):
        assert sum(len(r.candidates) for r in want[k]) > 0, name
        for g, w in zip(got[k], want[k]):
            assert set(map(tuple, g.candidates)) == \
                set(map(tuple, np.asarray(w.candidates))), name
            np.testing.assert_array_equal(g.boxes, np.asarray(w.boxes))
            np.testing.assert_array_equal(g.neighbors,
                                          np.asarray(w.neighbors))


@pytest.mark.parametrize("set_name", sorted(SETS))
def test_multi_matches_per_cascade(set_name):
    """The fused program equals each cascade's own batched detector."""
    names = SETS[set_name]
    got = _multi(names).detect(_frames(), min_neighbors=2)
    for k, name in enumerate(names):
        single = ct.BatchedPyramidDetector(ct.load_cascade(name), SHAPE, 2,
                                           device="cpu", **KNOBS)
        _assert_same([got[k]], [single.detect(_frames(), min_neighbors=2)],
                     [name])


def test_multi_empty_cascade_slot():
    """fullbody's 28-pixel-tall window exceeds a 26-row frame, so it has
    no pyramid level: its results are empty, the other cascade's are its
    own detector's; with no cascade left, every result is empty."""
    shape = (26, 128)
    frames = _frames()[:, 35:61, :]
    names = ("haarcascade_frontalface_default", "haarcascade_fullbody")
    multi = _multi(names, shape, scale_factor=1.1)
    assert multi._active == [0]
    got = multi.detect(frames, min_neighbors=0)
    assert all(len(r.candidates) == 0 for r in got[1])
    single = ct.BatchedPyramidDetector(ct.load_cascade(names[0]), shape, 2,
                                       device="cpu",
                                       **dict(KNOBS, scale_factor=1.1))
    want = single.detect(frames, min_neighbors=0)
    assert sum(len(r.candidates) for r in want) > 0
    _assert_same([got[0]], [want], names[:1])
    none = _multi(names[1:], shape)
    for res in (none.detect(frames),
                next(none.detect_stream(iter([frames])))):
        assert len(res) == 1 and all(len(r.candidates) == 0 for r in res[0])


def test_multi_cap_regrowth_in_detect():
    """Only the cascade that overflows grows its cap; the program is
    captured again at the new caps and lands on the uncapped answer."""
    tiny = _multi(PAIR, cap=16)
    tiny.subs[1].cap = 4096
    got = tiny.detect(_frames(), min_neighbors=0)
    assert tiny.subs[0].cap > 16 and tiny.subs[1].cap == 4096
    assert tiny._program.key == (2, tiny._caps())
    _assert_same(got, _multi(PAIR).detect(_frames(), min_neighbors=0), PAIR)


def _regrowth_batches():
    flat = np.stack([np.full(SHAPE, 128, np.uint8)] * 2)
    busy = np.stack([synth_scene(SHAPE, faces=((48, 40, 30.0),), seed=s,
                                 texture=60.0) for s in (1, 2)])
    return [flat, busy, _frames()]


@pytest.mark.parametrize("threaded", [True, False])
def test_multi_cap_regrowth_mid_stream(threaded):
    tiny = _multi(PAIR, cap=32)
    got = list(tiny.detect_stream(iter(_regrowth_batches()),
                                  min_neighbors=0, depth=2,
                                  threaded=threaded))
    assert all(tiny.subs[k].cap > 32 for k in tiny._active)
    big = _multi(PAIR)
    for res, frames in zip(got, _regrowth_batches()):
        assert not any(r.survivor_overflow for rk in res for r in rk)
        _assert_same(res, big.detect(frames, min_neighbors=0), PAIR)


@pytest.mark.parametrize("threaded", [True, False])
def test_multi_stream_matches_detect(threaded):
    batches = [np.stack([synth_face(SHAPE, size=28.0 + 4 * i, seed=7 * i + j)
                         for j in range(2)]) for i in range(4)]
    multi = _multi(PAIR)
    got = list(multi.detect_stream(iter(batches), min_neighbors=1, depth=3,
                                   threaded=threaded))
    ref = _multi(PAIR)
    assert len(got) == len(batches)
    for res, frames in zip(got, batches):
        _assert_same(res, ref.detect(frames, min_neighbors=1), PAIR)
