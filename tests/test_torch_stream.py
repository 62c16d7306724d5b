"""The port's ``BatchedPyramidDetector.detect_stream`` against the JAX
package's stream, on the CPU (the counterparts of ``tests/test_stream.py``).

Results come back in input order and equal the JAX stream's, frame for
frame (candidates, boxes, neighbour counts, overflow flags), threaded and
unthreaded; a batch that overflows the survivor cap in the middle of a
stream runs again at the grown cap (the cap travels with its batch); a
batch that accepts more windows than the packed readback holds runs again
through ``detect``, whose readback takes the full arrays.  float32 on
both sides; on these scenes the candidates are equal.
"""

import functools

import numpy as np
import pytest
import torch

from clfacedetection_tpu.models import load_cascade as j_load_cascade
from clfacedetection_tpu.runtime import BatchedPyramidDetector as JBatched
from clfacedetection_tpu.utils import synth_face, synth_scene

import clfacedetection_torch as ct
from clfacedetection_torch.detect import pyramid as tpyramid

# one torch thread per test worker process
torch.set_num_threads(1)

SHAPE = (96, 128)
CASCADE = "haarcascade_frontalface_default"
KNOBS = dict(max_stages=4, front_stages=2)


def _in_order():
    return [np.stack([synth_face(SHAPE, size=30.0 + 4 * i, seed=10 * i + j)
                      for j in range(2)]) for i in range(4)]


def _regrowth():
    """A flat batch that fits a tiny cap, a textured one that overflows
    it, then a batch enqueued after the growth."""
    flat = np.stack([np.full(SHAPE, 128, np.uint8)] * 2)
    busy = np.stack([synth_scene(SHAPE, faces=((48, 40, 30.0),), seed=s,
                                 texture=60.0) for s in (1, 2)])
    return [flat, busy, _in_order()[0]]


@functools.lru_cache(maxsize=None)
def _jax_stream(which: str, min_neighbors: int):
    """The JAX package's stream over the same batches, at a cap that never
    overflows; one detector (one compile) serves both scenarios."""
    det = _jax_det()
    batches = _in_order() if which == "in_order" else _regrowth()
    return list(det.detect_stream(iter(batches), min_neighbors=min_neighbors,
                                  depth=2, threaded=False))


@functools.lru_cache(maxsize=None)
def _jax_det():
    return JBatched(j_load_cascade(CASCADE), SHAPE, 2, cap=4096, **KNOBS)


def _port(**kw):
    return ct.BatchedPyramidDetector(ct.load_cascade(CASCADE), SHAPE, 2,
                                     device="cpu", **dict(KNOBS, **kw))


def _same(a, b):
    return (np.array_equal(a.candidates, b.candidates)
            and np.array_equal(a.boxes, b.boxes)
            and np.array_equal(a.neighbors, b.neighbors)
            and a.survivor_overflow == b.survivor_overflow)


def _assert_same(got, want):
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w)
        for b in range(len(g)):
            assert _same(g[b], w[b]), f"batch {k} frame {b}"


@pytest.mark.parametrize("threaded", [True, False])
def test_stream_matches_jax_in_order(threaded):
    det = _port()
    got = list(det.detect_stream(iter(_in_order()), min_neighbors=1,
                                 depth=3, threaded=threaded))
    want = _jax_stream("in_order", 1)
    assert sum(len(r.candidates) for res in want for r in res) > 0
    _assert_same(got, want)
    # and the unpipelined path, batch by batch
    ref = _port()
    _assert_same(got, [ref.detect(f, min_neighbors=1) for f in _in_order()])


@pytest.mark.parametrize("threaded", [True, False])
def test_stream_cap_regrowth_mid_stream(threaded):
    """Batch 0 fits the tiny cap; batch 1 overflows it at enqueue and runs
    again at the grown cap; batch 2 runs at the grown cap.  All three
    equal the JAX stream's at a cap that never overflowed."""
    det = _port(cap=32)
    got = list(det.detect_stream(iter(_regrowth()), min_neighbors=0,
                                 depth=2, threaded=threaded))
    assert det.det.cap > 32, "the scene never overflowed the tiny cap"
    assert det.det._program.key == (2, det.det.cap)
    assert not any(r.survivor_overflow for res in got for r in res)
    _assert_same(got, _jax_stream("regrowth", 0))


@pytest.mark.parametrize("threaded", [True, False])
def test_accept_overflow_runs_the_batch_again(threaded, monkeypatch):
    """More accepted windows than the packed readback holds: the drain
    flags the batch, the enqueue thread runs it again through ``detect``
    and its readback takes the full arrays from an eager run; the results
    equal the JAX stream's."""
    monkeypatch.setattr(tpyramid, "ACCEPT_CAP", 4)
    det = _port()
    again = []
    detect = det.detect

    def spy(frames, min_neighbors=3):
        again.append(len(frames))
        return detect(frames, min_neighbors)

    monkeypatch.setattr(det, "detect", spy)
    got = list(det.detect_stream(iter(_in_order()), min_neighbors=1,
                                 depth=2, threaded=threaded))
    want = _jax_stream("in_order", 1)
    n_over = sum(any(len(r.candidates) > 4 for r in res) for res in want)
    assert n_over > 0 and len(again) == n_over
    _assert_same(got, want)
