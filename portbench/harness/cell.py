"""One cell of the benchmark: its files found by name, its frames, its
traffic through the program, and the judgement of what came back.

A cell (``workloads/<cell>.json``) names a configuration
(``configs/<config>.json``: the cascade files, the frame shape and the
detection parameters) and a traffic mix (``traffic/<mix>.json``: its
generator, ``traffic/<generator>.py``, and the generator's parameters).
The generator builds the program's entry for the configuration, runs
frames through it and returns one ``Served`` record a frame.  The reference
(``reference/detect.py``) then runs on the judged pool frames, and every
served result of those frames is compared with it (``judge``).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import sys
from typing import Dict, List, Optional

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKOUT = os.path.dirname(ROOT)
FORBIDDEN = ("jax", "jaxlib", "flax", "clfacedetection_tpu")
# the host's CPU threads of a process on the card: one process, one thread
# of PyTorch's own (a pool of 8 drifted the demo's frames by up to 10%)
HOST_THREADS = 1

__all__ = ["ROOT", "CHECKOUT", "Served", "Cell", "load", "load_module",
           "forbidden_modules", "gaps"]


def load(kind: str, name: str) -> dict:
    """``portbench/<kind>/<name>.json``."""
    with open(os.path.join(ROOT, kind, f"{name}.json")) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``portbench/<kind>/<name>.py`` as a module (a name may hold dots)."""
    path = os.path.join(ROOT, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``clfacedetection_torch`` is not
    ``clfacedetection_tpu``)."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None
                                       else modules)}
    return sorted(names & set(FORBIDDEN))


@dataclasses.dataclass
class Served:
    """One frame's trip through the program: the pool frame it was, its
    results (one ``(candidates, boxes, neighbors)`` a cascade), when it
    was submitted or due (``t0``) and when its results came back
    (``t1``), both on ``time.perf_counter``."""

    idx: int
    out: list
    t0: float
    t1: float


def _iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    ax2, ay2 = a[:, 0] + a[:, 2], a[:, 1] + a[:, 3]
    bx2, by2 = b[:, 0] + b[:, 2], b[:, 1] + b[:, 3]
    iw = np.clip(np.minimum(ax2[:, None], bx2[None]) -
                 np.maximum(a[:, None, 0], b[None, :, 0]), 0, None)
    ih = np.clip(np.minimum(ay2[:, None], by2[None]) -
                 np.maximum(a[:, None, 1], b[None, :, 1]), 0, None)
    inter = iw * ih
    union = (a[:, 2] * a[:, 3])[:, None] + (b[:, 2] * b[:, 3])[None] - inter
    return inter / np.maximum(union, 1)


def gaps(out, ref) -> Dict[str, float]:
    """How far one result lies from the reference's.  ``cand_gap``: the
    candidates in one set only, over those in either.  ``box_gap``: the
    grouped boxes matched one to one at IoU >= 0.9 (the best pairs
    first); the neighbours of every unmatched box and the difference of
    neighbours of every matched pair, over all neighbours of both."""
    cand, boxes, neigh = out
    a = {tuple(r) for r in np.asarray(cand, np.int64).reshape(-1, 4).tolist()}
    b = {tuple(r) for r in ref.candidates.tolist()}
    cand_gap = len(a ^ b) / max(len(a | b), 1)
    p = np.asarray(boxes, np.int64).reshape(-1, 4)
    pn = np.asarray(neigh, np.int64).reshape(-1)
    r, rn = ref.boxes.reshape(-1, 4), ref.neighbors
    total = int(pn.sum() + rn.sum())
    off = 0
    used_p = np.zeros(len(p), bool)
    used_r = np.zeros(len(r), bool)
    if len(p) and len(r):
        iou = _iou(p, r)
        for k in np.argsort(-iou, axis=None, kind="stable"):
            i, j = divmod(int(k), len(r))
            if iou[i, j] < 0.9:
                break
            if used_p[i] or used_r[j]:
                continue
            used_p[i] = used_r[j] = True
            off += abs(int(pn[i]) - int(rn[j]))
    off += int(pn[~used_p].sum() + rn[~used_r].sum())
    return {"cand_gap": cand_gap, "box_gap": off / max(total, 1)}


class Cell:
    """A cell's configuration, traffic mix and generator, on ``device`` (a
    ``torch.device``).  ``overrides`` replace keys of the configuration
    (``"config"``) and of the mix (``"traffic"``): the tests run a cell
    at a small size on the CPU."""

    def __init__(self, workload: str, device, overrides: Optional[dict] = None):
        overrides = overrides or {}
        self.name = workload
        self.spec = load("workloads", workload)
        self.cfg = dict(load("configs", self.spec["config"]),
                        **overrides.get("config", {}))
        self.mix = dict(load("traffic", self.spec["traffic"]),
                        **overrides.get("traffic", {}))
        self.limits = dict(self.spec["limits"])
        self.device = device
        self.generator = load_module("traffic", self.mix["generator"])
        self.paths = [os.path.join(ROOT, "data", "cascades", f)
                      for f in self.cfg["cascades"]]
        self.state = None

    def setup(self) -> None:
        """Build the program's entry (the generator's ``setup``); on the card
        with ``HOST_THREADS`` CPU threads of PyTorch's."""
        if self.device.type == "cuda":
            import torch
            torch.set_num_threads(HOST_THREADS)
        self.state = self.generator.setup(self.cfg, self.mix, self.paths,
                                       self.device)

    def frames(self, seed: int) -> np.ndarray:
        from .frames import pool
        m = self.mix
        return pool(tuple(self.cfg["frame"]), int(m["pool"]), m["faces"],
                    m["sizes"], seed)

    def judged(self, seed: int) -> np.ndarray:
        """The pool frames judged: the cell's ``judge`` of them, drawn from
        the seed evenly over the positions in a batch."""
        n, k = int(self.mix["pool"]), int(self.spec["judge"])
        if k >= n:
            return np.arange(n)
        step = int(self.mix.get("batch", 1))
        rng = np.random.default_rng([int(seed), 1])
        per = [rng.permutation(np.arange(j, n, step)) for j in range(step)]
        pick = [p[i] for i in range(math.ceil(k / step)) for p in per
                if i < len(p)]
        return np.sort(np.asarray(pick[:k]))

    def run(self, frames, seed: int, seconds: Optional[float] = None,
            count: Optional[int] = None, span=None) -> List[Served]:
        return self.generator.run(self.state, frames, seed=seed,
                               seconds=seconds, count=count, span=span)

    def release(self) -> None:
        """Drop the program's objects and their device memory."""
        import gc
        import torch
        self.state = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    def reference(self, frames: np.ndarray, sample: np.ndarray,
                  precision: str = "float64") -> Dict[int, list]:
        """The reference's detections of pool frames ``sample``: for each,
        one ``Detection`` a cascade."""
        import torch
        from ..reference.cascade import Cascade
        from ..reference.detect import detect
        out: Dict[int, list] = {int(i): [] for i in sample}
        t = torch.from_numpy(frames[sample]).to(self.device)
        for path in self.paths:
            for i, d in zip(sample, detect(Cascade(path), t, self.cfg,
                                           precision)):
                out[int(i)].append(d)
        return out

    def judge(self, served: List[Served], refs: Dict[int, list]):
        """The worst of each gap the cell limits over every served result
        of a judged frame, and the number of results over a limit."""
        worst = {k: 0.0 for k in self.limits}
        failed = judged = 0
        cache: Dict[tuple, Dict[str, float]] = {}
        for s in served:
            if s.idx not in refs:
                continue
            judged += 1
            bad = False
            for k, (out, ref) in enumerate(zip(s.out, refs[s.idx])):
                key = (s.idx, k, _digest(out))
                g = cache.get(key)
                if g is None:
                    g = cache[key] = gaps(out, ref)
                for name in worst:
                    worst[name] = max(worst[name], g[name])
                    bad |= g[name] > self.limits[name]
            failed += bad
        return worst, failed, judged


def _digest(out) -> int:
    return hash(tuple(np.asarray(a).tobytes() for a in out))
