"""Closed loop with one camera: each frame goes in when the previous
one's boxes have come back, through ``CascadeClassifier.
detect_multi_scale_full`` (``detect_multi_scale`` with the candidates and
neighbour counts beside the boxes).  The pool's frames are cycled; a
frame's time runs from its submission to its return."""

from __future__ import annotations

import contextlib
import time

import torch

from clfacedetection_torch import CascadeClassifier, load_cascade
from portbench.harness.cell import Served


def setup(cfg, mix, paths, device):
    (path,) = paths
    clf = CascadeClassifier(load_cascade(path),
                            dtype=getattr(torch, cfg["dtype"]),
                            device=device, mode=cfg["mode"])
    return dict(clf=clf, cfg=cfg, mix=mix)


def detect(state, frame):
    cfg = state["cfg"]
    r = state["clf"].detect_multi_scale_full(
        frame, scale_factor=cfg["scale_factor"],
        min_neighbors=cfg["min_neighbors"], flags=cfg["flags"],
        min_size=tuple(cfg["min_size"]))
    return [(r.candidates, r.boxes, r.neighbors)]


def run(state, frames, seed, seconds=None, count=None, span=None):
    span = span or (lambda name: contextlib.nullcontext())
    end = None if seconds is None else time.perf_counter() + seconds
    served = []
    i = 0
    while (end is None or time.perf_counter() < end) and \
            (count is None or i < count):
        k = i % len(frames)
        t0 = time.perf_counter()
        with span("camera.detect"):
            out = detect(state, frames[k])
        served.append(Served(k, out, t0, time.perf_counter()))
        i += 1
    return served
