"""OpenCV 2.4's ``cvHaarDetectObjects`` in both scan modes, in plain
PyTorch, vectorised over windows.

It is the benchmark's plain reference: it imports nothing of the program
under test and works everything out again from the frames and the cascade
file (the pyramid, the integrals, every window's cascade walk, the
windows entering each stage, and the grouping, ``grouping.py``).

Arithmetic, as in tempcv.cpp:771-948 (``precision="float64"``): a rect's
sum is an exact integer, rounded to float32 and multiplied by its float32
weight in float32; a node's value adds its rects' products in double; the
node's threshold is its float32 threshold times the window's variance
factor in double; the stage sum adds the classifiers' leaf values in
double, in classifier order, and a window passes a stage where that sum
is not below the stage's (biased) threshold.  The variance factor is
``sqrt(sq * inv_area - mean**2)`` in double, 1 where that is negative.

``precision="bfloat16"`` is the control: the same walk with every one of
those numbers (rect sums, products, node values, thresholds, variance
factors, leaf values, stage sums) held in bfloat16.

Scale-image mode (tempcv.cpp:989-1113, 1257-1328): each factor's level is
the frame resized to ``round(W / f) x round(H / f)``, scanned with the
base window at every ``ystep`` (1 where f > 2, else 2) position of
``[0, h - h0) x [0, w - w0)``; a candidate is ``(round(x f), round(y f),
round(w0 f), round(h0 f))``.  Scale-cascade mode (tempcv.cpp:1139-1170,
1330-1456): the frame stays, the features scale; ``ystep = max(2, f)``,
positions ``round(i * ystep)``; along a row, a window rejected by stage 0
makes the scan skip the next position.  Stage-tree cascades are not
handled (no configuration of the benchmark has one).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from .cascade import Cascade, Scaled, cv_round, scale_factors
from .grouping import group_rectangles
from .imaging import integrals, resize_u8

__all__ = ["Detection", "detect", "PRECISIONS"]

PRECISIONS = {"float64": (torch.float64, torch.float32),
              "bfloat16": (torch.bfloat16, torch.bfloat16)}
# gathered elements a chunk of windows may hold at once
_CHUNK = 1 << 26


@dataclasses.dataclass
class Detection:
    """One frame's result: raw candidates (x, y, w, h), grouped boxes and
    their neighbour counts, and the windows entering each stage (then the
    accepted ones; the first count is the windows visited);
    ``level_pixels``: the pyramid's pixels (scale-image) or the frame's
    (scale-cascade); ``plane_bytes``: its integral planes' bytes (sum 4,
    squared sum 8, tilted 4 an entry)."""

    candidates: np.ndarray
    boxes: np.ndarray
    neighbors: np.ndarray
    entering: np.ndarray
    level_pixels: int
    plane_bytes: int


class _Planes:
    """A batch's integral planes, flattened into one tensor so that a
    window's corner is one gather: the sum, then the tilted sum, each
    (B, H + 1, W + 1); the squared sum apart."""

    def __init__(self, gray: torch.Tensor, tilted: bool, acc):
        s, sq, t = integrals(gray, tilted)
        self.B, hp, wp = s.shape
        self.stride = wp
        self.n = self.B * hp * wp
        parts = [s.reshape(-1)] + ([t.reshape(-1)] if tilted else [])
        self.flat = torch.cat(parts)
        self.sq = sq.reshape(-1)
        self.acc = acc
        self.bytes = self.n * (4 + 8 + (4 if tilted else 0)) // self.B


class _Walker:
    """The cascade's walk over flat window bases of one ``_Planes`` at one
    ``Scaled``."""

    def __init__(self, c: Cascade, sc: Scaled, planes: _Planes,
                 precision: str):
        self.c, self.sc, self.p = c, sc, planes
        self.acc, self.prod = PRECISIONS[precision]
        dev = planes.flat.device
        off = sc.corner_y * planes.stride + sc.corner_x
        off = off + np.where(c.tilted, planes.n, 0)[:, None, None]
        self.off = torch.from_numpy(off.reshape(len(off), 12)).to(dev)
        self.sign = torch.tensor([1, -1, -1, 1] * 3, device=dev)
        self.weight = torch.from_numpy(sc.weight).to(dev, self.prod)
        self.present = torch.from_numpy(sc.weight != 0).to(dev)
        self.thr = torch.from_numpy(c.node_threshold).to(dev, self.acc)
        self.left = torch.from_numpy(c.left).to(dev)
        self.right = torch.from_numpy(c.right).to(dev)
        self.alphas = torch.from_numpy(c.alphas).to(dev, self.acc)
        self.stage_thr = torch.from_numpy(c.stage_threshold).to(dev, self.acc)
        self.n0 = torch.from_numpy(c.clf_node_ofs).to(dev)
        self.a0 = torch.from_numpy(c.clf_alpha_ofs).to(dev)
        self.equ = torch.from_numpy(sc.equ_y * planes.stride + sc.equ_x) \
            .to(dev)
        self.dev = dev

    def vnf(self, base: torch.Tensor) -> torch.Tensor:
        idx = base[:, None] + self.equ
        sgn = self.sign[:4]
        ws = (self.p.flat[idx] * sgn).sum(1)
        wq = (self.p.sq[idx] * sgn).sum(1)
        acc = self.acc
        inv = torch.tensor(self.sc.inv_area, dtype=acc, device=self.dev)
        mean = ws.to(acc) * inv
        v = wq.to(acc) * inv - mean * mean
        return torch.where(v >= 0, v.clamp(min=0).sqrt(),
                           torch.ones_like(v))

    def _node_values(self, base, node):
        """[n, C] values of nodes ``node`` at windows ``base``."""
        idx = base[:, None, None] + self.off[node]          # [n, C, 12]
        s = (self.p.flat[idx] * self.sign).view(*idx.shape[:2], 3, 4).sum(-1)
        prod = s.to(self.prod) * self.weight[node]
        prod = torch.where(self.present[node], prod, torch.zeros_like(prod))
        p = prod.to(self.acc)
        return (p[..., 0] + p[..., 1]) + p[..., 2]

    def stage_pass(self, base, vnf, s: int) -> torch.Tensor:
        """Whether each window passes stage ``s``."""
        c = self.c
        clf = torch.from_numpy(c.stage_classifiers(s)).to(self.dev)
        n0, a0 = self.n0[clf], self.a0[clf]
        depth = int(c.clf_node_cnt[c.stage_classifiers(s)].max())
        out = torch.empty(len(base), dtype=torch.bool, device=self.dev)
        rows = max(1, _CHUNK // (12 * len(clf)))
        for a in range(0, len(base), rows):
            b, v = base[a:a + rows], vnf[a:a + rows, None]
            at = torch.zeros((len(b), len(clf)), dtype=torch.long,
                             device=self.dev)
            leaf = torch.full_like(at, 1)
            for _ in range(depth):
                node = n0 + at
                val = self._node_values(b, node)
                go = torch.where(val < self.thr[node] * v, self.left[node],
                                 self.right[node])
                live = leaf > 0
                leaf = torch.where(live, go, leaf)
                at = torch.where(live & (go > 0), go, at)
            votes = self.alphas[a0 - leaf]
            total = votes[:, 0]
            for j in range(1, votes.shape[1]):
                total = total + votes[:, j]
            out[a:a + rows] = total >= self.stage_thr[s]
        return out

    def walk(self, base: torch.Tensor, first: Optional[torch.Tensor] = None):
        """(accepted mask over ``base``, windows entering each stage [S + 1]
        per batch row); ``first`` is stage 0's outcome where the caller has
        it."""
        S = self.c.n_stages
        B = self.p.B
        per = self.p.n // B
        counts = torch.zeros((S + 1, B), dtype=torch.long, device=self.dev)
        ok = torch.zeros(len(base), dtype=torch.bool, device=self.dev)
        live = torch.arange(len(base), device=self.dev)
        vnf = self.vnf(base)
        for s in range(S):
            if len(live) == 0:
                break
            counts[s] = torch.bincount(base[live] // per, minlength=B)
            passed = first[live] if (s == 0 and first is not None) else \
                self.stage_pass(base[live], vnf[live], s)
            live = live[passed]
        ok[live] = True
        counts[S] = torch.bincount(base[live] // per, minlength=B)
        return ok, counts, vnf


def _scale_image(c: Cascade, gray, cfg, precision):
    B, H, W = gray.shape
    w0, h0 = c.window_w, c.window_h
    cands: List[list] = [[] for _ in range(B)]
    entering = torch.zeros((c.n_stages + 1, B), dtype=torch.long)
    pixels = plane_bytes = 0
    sc = c.at_scale(1.0)
    for f in scale_factors(c, W, H, cfg["scale_factor"], cfg["min_size"],
                           "scale_image"):
        lh, lw = int(cv_round(H / f)), int(cv_round(W / f))
        lvl = gray if (lh, lw) == (H, W) else resize_u8(gray, (lh, lw))
        planes = _Planes(lvl, c.has_tilted, PRECISIONS[precision][0])
        pixels += lh * lw
        plane_bytes += planes.bytes
        step = 1 if f > 2 else 2
        ys = torch.arange(0, max(lh - h0, 0), step, device=gray.device)
        xs = torch.arange(0, max(lw - w0, 0), step, device=gray.device)
        if len(ys) == 0 or len(xs) == 0:
            continue
        bb = torch.arange(B, device=gray.device)
        base = (bb[:, None, None] * (planes.n // B)
                + ys[None, :, None] * planes.stride + xs[None, None, :])
        base = base.reshape(-1)
        ok, counts, _ = _Walker(c, sc, planes, precision).walk(base)
        entering += counts.cpu()
        hit = base[ok]
        b = (hit // (planes.n // B)).cpu().numpy()
        r = (hit % (planes.n // B)).cpu().numpy()
        y, x = r // planes.stride, r % planes.stride
        win = (int(cv_round(w0 * f)), int(cv_round(h0 * f)))
        for i in range(B):
            m = b == i
            if m.any():
                cands[i].append(np.stack(
                    [cv_round(x[m] * f), cv_round(y[m] * f),
                     np.full(m.sum(), win[0]), np.full(m.sum(), win[1])], 1))
    return cands, entering, pixels, plane_bytes


def _scale_cascade(c: Cascade, gray, cfg, precision):
    B, H, W = gray.shape
    dev = gray.device
    planes = _Planes(gray, c.has_tilted, PRECISIONS[precision][0])
    per = planes.n // B
    cands: List[list] = [[] for _ in range(B)]
    entering = torch.zeros((c.n_stages + 1, B), dtype=torch.long)
    for f in scale_factors(c, W, H, cfg["scale_factor"], cfg["min_size"],
                           "scale_cascade"):
        sc = c.at_scale(f)
        ystep = max(2.0, f)
        nx = int(cv_round((W - sc.win_w) / ystep))
        ny = int(cv_round((H - sc.win_h) / ystep))
        if nx <= 0 or ny <= 0:
            continue
        xs = torch.from_numpy(cv_round(np.arange(nx) * ystep)).to(dev)
        ys = torch.from_numpy(cv_round(np.arange(ny) * ystep)).to(dev)
        inside = ((xs[None, None, :] + sc.win_w < W + 1)
                  & (ys[None, :, None] + sc.win_h < H + 1)) \
            .expand(B, ny, nx)
        base = (torch.arange(B, device=dev)[:, None, None] * per
                + ys[None, :, None] * planes.stride + xs[None, None, :])
        walker = _Walker(c, sc, planes, precision)
        # stage 0 everywhere inside, then the skip rule along each row
        flat = base.reshape(-1)
        ins = inside.reshape(-1)
        pass0 = torch.zeros_like(ins)
        idx = ins.nonzero().squeeze(1)
        pass0[idx] = walker.stage_pass(flat[idx], walker.vnf(flat[idx]), 0)
        fail0 = (ins & ~pass0).view(B, ny, nx)
        seen = torch.ones((B, ny, nx), dtype=torch.bool, device=dev)
        for i in range(nx - 1):
            seen[..., i + 1] = ~(seen[..., i] & fail0[..., i])
        run = (seen & inside).reshape(-1)
        sel = run.nonzero().squeeze(1)
        ok, counts, _ = walker.walk(flat[sel], first=pass0[sel])
        entering += counts.cpu()
        hit = flat[sel][ok]
        b = (hit // per).cpu().numpy()
        r = (hit % per).cpu().numpy()
        y, x = r // planes.stride, r % planes.stride
        for i in range(B):
            m = b == i
            if m.any():
                cands[i].append(np.stack(
                    [x[m], y[m], np.full(m.sum(), sc.win_w),
                     np.full(m.sum(), sc.win_h)], 1))
    return cands, entering, H * W, planes.bytes


def detect(c: Cascade, frames: torch.Tensor, cfg: dict,
           precision: str = "float64") -> List[Detection]:
    """Every frame of uint8 ``frames`` (B, H, W) through the cascade under
    ``cfg`` (``mode``, ``scale_factor``, ``min_neighbors``, ``min_size``).
    Stage-tree cascades raise ``NotImplementedError``."""
    if c.is_tree:
        raise NotImplementedError("stage-tree cascades")
    if cfg["mode"] == "scale_image":
        cands, ent, px, pb = _scale_image(c, frames, cfg, precision)
    elif cfg["mode"] == "scale_cascade":
        cands, ent, px, pb = _scale_cascade(c, frames, cfg, precision)
    else:
        raise ValueError(f"unknown mode {cfg['mode']!r}")
    out = []
    for i, parts in enumerate(cands):
        cand = (np.concatenate(parts).astype(np.int64) if parts
                else np.zeros((0, 4), np.int64))
        mn = int(cfg["min_neighbors"])
        if mn != 0:
            boxes, neigh = group_rectangles(cand, mn, 0.2)
        else:
            boxes, neigh = cand, np.ones(len(cand), np.int64)
        out.append(Detection(cand, np.asarray(boxes, np.int64),
                             np.asarray(neigh, np.int64),
                             ent[:, i].numpy(), px, pb))
    return out
