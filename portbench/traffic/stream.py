"""Closed loop with one client: offline video in batches through the
program's ``detect_stream``.

The pool's frames go in consecutive batches of ``batch``, cycled; the
client hands the stream a host batch whenever the stream asks for one (it
keeps ``depth`` in flight), until the window ends, and takes each batch's
results as the stream yields them.  A frame's time runs from its batch's
hand-over to the return of the batch's grouped results.  One cascade runs
through ``BatchedPyramidDetector``, several through
``MultiCascadeBatchedDetector`` (one program for all of them)."""

from __future__ import annotations

import contextlib
import time

import torch

from clfacedetection_torch import (BatchedPyramidDetector,
                                   MultiCascadeBatchedDetector, load_cascade)
from portbench.harness.cell import Served


def setup(cfg, mix, paths, device):
    specs = [load_cascade(p) for p in paths]
    knobs = dict(scale_factor=cfg["scale_factor"],
                 min_size=tuple(cfg["min_size"]),
                 dtype=getattr(torch, cfg["dtype"]), device=device)
    shape, batch = tuple(cfg["frame"]), int(mix["batch"])
    if len(specs) == 1:
        det = BatchedPyramidDetector(specs[0], shape, batch, **knobs)
    else:
        det = MultiCascadeBatchedDetector(specs, shape, batch, **knobs)
    return dict(det=det, multi=len(specs) > 1, batch=batch, cfg=cfg, mix=mix)


def run(state, frames, seed, seconds=None, count=None, span=None):
    span = span or (lambda name: contextlib.nullcontext())
    det, B = state["det"], state["batch"]
    nb = len(frames) // B
    sent = []
    end = None if seconds is None else time.perf_counter() + seconds
    limit = None if count is None else -(-count // B)

    def batches():
        j = 0
        while True:
            with span("stream.feed"):
                if (end is not None and time.perf_counter() >= end) or \
                        (limit is not None and j >= limit):
                    return
                k = j % nb
                sent.append((k, time.perf_counter()))
                batch = frames[k * B:(k + 1) * B]
            yield batch
            j += 1

    served = []
    it = det.detect_stream(batches(), state["cfg"]["min_neighbors"],
                           depth=int(state["mix"]["depth"]),
                           threaded=bool(state["mix"]["threaded"]))
    j = 0
    while True:
        with span("stream.result"):
            res = next(it, None)
        if res is None:
            break
        t1 = time.perf_counter()
        k, t0 = sent[j]
        j += 1
        for b in range(B):
            rs = [r[b] for r in res] if state["multi"] else [res[b]]
            served.append(Served(k * B + b, [(r.candidates, r.boxes,
                                              r.neighbors) for r in rs],
                                 t0, t1))
    return served
