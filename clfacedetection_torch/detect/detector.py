"""Scale-cascade detector (torch), and the host tables every detector
shares.

Port of ``clfacedetection_tpu/detect/detector.py``: the stage-tree paths,
the classifier-major padded tables, the result record, and
``ScaleCascadeDetector``, OpenCV's scale-cascade mode (fixed frame,
features rescaled per scale; ``cvHaarDetectObjectsForROC``'s
ScaleCascade invoker, tempcv.cpp:1330-1456, 1139-1170), the mode the
reference demo runs.  Per frame, on the detector's device:

    integrals (and Canny's) -> for every scale, a Python loop:
        variance and front-stage maps over the scan lattice (views)
     -> survivor compaction (kernel)
     -> tail stages in groups over shrinking compacted sets (corner
        gathers, votes, stage sums; a compaction between groups)
     -> the skip-by-2 visit set (a cumulative max along the rows)
    -> accept compaction of every scale at once (kernel)
    -> ONE packed readback: [n_surv, n_acc, y[acap], x[acap]] a scale

The JAX package runs this mode in XLA with no Pallas kernel (its windows
exceed its patch kernels at every scale, ``detector.py:203-206``), so here
it is plain PyTorch except the compactions, which have the contract of
``ops.compact_kernel.compact`` and run its kernel on the card.  Each
scale's corner offsets are host integers, so a dense map is a strided
view of a plane: every ``ystep``-th position where the lattice is regular
(``factor <= 2``), else every position up to the last lattice point, which
the lattice then selects.  A stage's views are stacked into one tensor,
so a stage costs a few launches, not a few per rect.  Every stage sum is
one fixed tree of additions (``_fold``), the same on the card and the
CPU and in the front and the tail; the JAX package sums the front in
classifier order and the tail with ``jnp.sum``, so float32 is held to
the docs/PARITY.md bounds and float64 box for box.  Nothing reads the
host from the frame to the packed array, so in float32 on the card
``candidates`` runs the whole of it, prep and Canny included, as one
captured CUDA graph per cap (``runtime/program.py``; JAX's
``_jit_scales``).  find-biggest-object stays eager: it reads every
scale back.  ``shard_scales`` runs scale ``i`` on the ``i % k``-th of k
devices (or streams of one card) and merges in scale order.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.compile import (CompiledCascade, compile_cascade, cv_round,
                              scale_factors, scan_grid, truncate_cascade)
from ..models.spec import CascadeSpec
from ..ops.canny import canny
from ..ops.compact_kernel import compact
from ..ops.haar_front import variance_factor
from ..ops.integral import integral_2d, integral_images
from ..ops.tail_rows import _cart_votes
from .grouping import group_rectangles

__all__ = ["DetectionResult", "ScaleCascadeDetector", "default_device"]

# accepted windows read back per scale in one array (the JAX package's
# scale-cascade pack, detector.py:795)
ACCEPT_CAP = 2048
STRATEGIES = (None, "per_stage", "block", "direct")
# int32 elements of one gather off the card, and the share of the card's
# memory one takes on it
_CPU_GATHER_ELEMS = 1 << 24
_CARD_GATHER_SHARE = 128
# Canny's hysteresis steps in the frame's program at first; 4x while a
# frame's edges do not reach the fixpoint
_CANNY_STEPS = 64


def default_device() -> torch.device:
    """The card.  The entry points run on CUDA unless given
    ``device="cpu"``; without a card they raise rather than run the plain
    versions unasked."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device=\"cpu\" to run the plain PyTorch "
            "versions of the kernels on the CPU")
    return torch.device("cuda")


def _stage_paths(c: CompiledCascade) -> List[List[int]]:
    """Root-to-leaf stage chains of the stage tree (tempcv.cpp:834-861).
    Plain cascades are the single chain [0..n_stages-1]."""
    n = c.spec.n_stages
    if not c.is_tree:
        return [list(range(n))]
    children: List[List[int]] = [[] for _ in range(n)]
    roots: List[int] = []
    for s in range(n):
        p = int(c.stage_parent[s])
        if p == -1:
            roots.append(s)
        else:
            children[p].append(s)
    paths: List[List[int]] = []

    def walk(s: int, prefix: List[int]) -> None:
        prefix = prefix + [s]
        if int(c.stage_child[s]) == -1:
            paths.append(prefix)
        else:
            for ch in children[s]:
                walk(ch, prefix)

    for r in roots:
        walk(r, [])
    return paths


@dataclasses.dataclass(frozen=True)
class _ClfTables:
    """Classifier-major padded tables; T = max nodes per classifier."""

    T: int
    n_clf: int
    corner_y: np.ndarray   # int32 [S, n_clf, T, 3, 4]
    corner_x: np.ndarray   # int32 [S, n_clf, T, 3, 4]
    weight: np.ndarray     # float32 [S, n_clf, T, 3]
    use_tilted: np.ndarray  # bool [n_clf, T]
    threshold: np.ndarray  # float32 [n_clf, T]
    left: np.ndarray       # int32 [n_clf, T]
    right: np.ndarray      # int32 [n_clf, T]
    alpha: np.ndarray      # float32 [n_clf, T + 1]
    clf_stage: np.ndarray  # int32 [n_clf]
    clf_valid_nodes: np.ndarray  # int32 [n_clf]


def _build_clf_tables(c: CompiledCascade,
                      scales: Sequence[float]) -> _ClfTables:
    spec = c.spec
    n_clf = spec.n_classifiers
    T = int(spec.clf_node_cnt.max()) if n_clf else 1
    S = len(scales)
    cy = np.zeros((S, n_clf, T, 3, 4), np.int32)
    cx = np.zeros((S, n_clf, T, 3, 4), np.int32)
    w = np.zeros((S, n_clf, T, 3), np.float32)
    tlt = np.zeros((n_clf, T), bool)
    thr = np.zeros((n_clf, T), np.float32)
    left = np.zeros((n_clf, T), np.int32)
    right = np.zeros((n_clf, T), np.int32)
    alpha = np.zeros((n_clf, T + 1), np.float32)
    clf_stage = np.zeros((n_clf,), np.int32)
    nodesel = []
    for cidx in range(n_clf):
        n0 = int(spec.clf_node_ofs[cidx])
        cnt = int(spec.clf_node_cnt[cidx])
        a0 = int(spec.clf_alpha_ofs[cidx])
        for t in range(cnt):
            node = n0 + t
            thr[cidx, t] = c.node_threshold[node]
            left[cidx, t] = c.left[node]
            right[cidx, t] = c.right[node]
            tlt[cidx, t] = c.use_tilted[node]
        alpha[cidx, :cnt + 1] = spec.alphas[a0:a0 + cnt + 1]
        nodesel.append([n0 + t if t < cnt else -1 for t in range(T)])
    for stage in range(spec.n_stages):
        c0 = int(spec.stage_clf_ofs[stage])
        clf_stage[c0:c0 + int(spec.stage_clf_cnt[stage])] = stage
    sel = np.asarray(nodesel, np.int64).reshape(n_clf, T)
    valid = sel >= 0
    selc = np.clip(sel, 0, None)
    for k, s in enumerate(scales):
        sc = c.at_scale(s)
        cy[k] = np.where(valid[..., None, None], sc.corner_y[selc], 0)
        cx[k] = np.where(valid[..., None, None], sc.corner_x[selc], 0)
        w[k] = np.where(valid[..., None], sc.weight[selc], 0.0)
    return _ClfTables(
        T=T, n_clf=n_clf, corner_y=cy, corner_x=cx, weight=w,
        use_tilted=tlt, threshold=thr, left=left, right=right, alpha=alpha,
        clf_stage=clf_stage,
        clf_valid_nodes=spec.clf_node_cnt.astype(np.int32))


@dataclasses.dataclass
class DetectionResult:
    """Detections plus diagnostics."""

    boxes: np.ndarray          # int32 [n, 4] grouped (raw if min_neighbors=0)
    neighbors: np.ndarray      # int32 [n]
    candidates: np.ndarray     # int32 [m, 4] raw pre-grouping candidates
    survivor_overflow: bool    # True if a survivor cap overflowed


@dataclasses.dataclass
class _Scale:
    """One scale's scan lattice and tables.  The dense maps are taken at
    every ``step``-th position of a ``gy`` x ``gx`` grid from the origin;
    where the lattice is regular that grid is the lattice, else the
    lattice's rows ``ys`` and columns ``xs`` are selected from it."""

    win_w: int
    win_h: int
    ny: int                 # lattice rows and columns; 0 scans nothing
    nx: int
    step: int
    gy: int
    gx: int
    regular: bool
    inv_area: float
    equ: Tuple[List[int], List[int]]      # variance rect corners (y, x)
    canny: Tuple[List[int], List[int]]    # pruning rect corners (y, x)
    ys: Optional[torch.Tensor] = None     # int32 [ny] lattice rows
    xs: Optional[torch.Tensor] = None     # int32 [nx] lattice columns
    ys_l: Optional[torch.Tensor] = None   # the same as int64
    xs_l: Optional[torch.Tensor] = None
    inb: Optional[torch.Tensor] = None    # bool [ny, nx] window in frame
    offs: Optional[torch.Tensor] = None   # int32 [n_clf*T*12] corners
    weight: Optional[torch.Tensor] = None  # [n_clf*T*3] rect weights


def _pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def _fold(v: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum along ``dim``, whose length is a power of two, by halving:
    element i adds element i + half.  Every stage sum, in the dense front
    and in the tail alike, is this tree over the stage's votes padded
    with zeros to a power of two, so the card and the CPU agree bit for
    bit (``torch.sum``'s order differs between them) and the front's
    depth moves no window.  Adding a zero is exact, so a longer padding
    gives the same sums."""
    while v.shape[dim] > 1:
        h = v.shape[dim] // 2
        v = v.narrow(dim, 0, h) + v.narrow(dim, h, h)
    return v.squeeze(dim)


class ScaleCascadeDetector:
    """Scale-cascade detector for one (cascade, frame shape) pair.

    Parameters mirror ``cvHaarDetectObjects`` (tempcv.hpp:141-145):
    ``scale_factor`` spaces the scales, ``min_size`` drops the small ones
    (``max_size`` is not consulted in this mode, tempcv.cpp:1345-1382) and
    ``min_neighbors`` drives grouping.  ``front_stages`` (3 by default)
    stages are dense maps over every scale's lattice; the rest run on the
    compacted survivors in groups of about 256 classifiers, each group on
    the survivors of the one before (one all-stages group for
    ``strategy="block"``/``"direct"``, and always for stage trees).
    ``cap`` is the survivor slot count of a scale; it grows 4x while a
    scale overflows it (``candidates``).  The tail gathers ``clf_chunk``
    classifiers' corners at a time (a dense stage stacks its corner views
    by the same budget); by default as many as keep one int32 temporary
    under 1/128 of the card's memory (16M elements off the card).
    ``do_canny_pruning`` skips windows with few Canny edges
    (tempcv.cpp:1386-1405).  ``device``: the card by default (an error
    without one), or ``"cpu"``; float32 or float64 on either."""

    def __init__(self, spec: CascadeSpec, image_shape: Tuple[int, int],
                 scale_factor: float = 1.1,
                 min_size: Tuple[int, int] = (0, 0),
                 max_size: Optional[Tuple[int, int]] = None,
                 front_stages: int = 3,
                 cap: Optional[int] = None,
                 dtype: torch.dtype = torch.float32,
                 clf_chunk: Optional[int] = None,
                 max_stages: Optional[int] = None,
                 do_canny_pruning: bool = False,
                 strategy: Optional[str] = None,
                 device=None):
        if strategy not in STRATEGIES:
            raise ValueError(f"unknown strategy {strategy!r}")
        if dtype not in (torch.float32, torch.float64):
            raise ValueError(f"dtype must be float32 or float64, got {dtype}")
        self.strategy = strategy
        self.spec = spec
        self.H, self.W = int(image_shape[0]), int(image_shape[1])
        self.device = torch.device(device) if device is not None \
            else default_device()
        self.dtype = dtype
        c = compile_cascade(spec)
        if max_stages is not None:
            c = truncate_cascade(c, max_stages)
        self.compiled = c
        self.scales = scale_factors(
            spec.window_w, spec.window_h, self.W, self.H, scale_factor,
            min_size, max_size, mode="scale_cascade")
        self.n_scales = len(self.scales)
        self.is_tree = c.is_tree
        self.do_canny_pruning = bool(do_canny_pruning)
        self.paths = _stage_paths(c)
        self.n_stages = c.spec.n_stages
        self.front_k = max(1, min(int(front_stages), self.n_stages))
        self._fbo_acap: Optional[int] = None
        self._program = None
        self._canny_steps = _CANNY_STEPS
        # shard_scales: scale i runs on _scale_devices[i % k], with this
        # detector's tables on that device (_on)
        self._scale_devices: Optional[Tuple[torch.device, ...]] = None
        self._twins: Dict[torch.device, "ScaleCascadeDetector"] = {}
        if self.n_scales == 0:
            return

        grids = [scan_grid(self.W, self.H, int(cv_round(spec.window_w * f)),
                           int(cv_round(spec.window_h * f)), f)
                 for f in self.scales]
        self.max_x = max(max(len(g[1]) for g in grids), 1)
        self.max_y = max(max(len(g[2]) for g in grids), 1)
        self.tables = t = _build_clf_tables(c, self.scales)
        self.clf_chunk = clf_chunk
        lattice = self.max_x * self.max_y
        if cap is None:
            # most windows die in the front; start small and regrow
            cap = int(2 ** np.ceil(np.log2(
                min(max(lattice // 16, 256), 8192))))
        self.cap = min(int(cap), lattice)
        sc = [c.at_scale(f) for f in self.scales]
        self.win_w = np.array([s.win_w for s in sc], np.int32)
        self.win_h = np.array([s.win_h for s in sc], np.int32)

        dev, dt = self.device, dtype
        if dev.type == "cuda":
            self._gather_elems = torch.cuda.get_device_properties(
                dev).total_memory // (_CARD_GATHER_SHARE * 4)
        else:
            self._gather_elems = _CPU_GATHER_ELEMS
        # the classifiers' walk tables for _cart_votes
        self._clf = (torch.from_numpy(t.threshold).to(dev, dt),
                     torch.from_numpy(t.alpha).to(dev, dt),
                     torch.from_numpy(t.left).to(dev).long(),
                     torch.from_numpy(t.right).to(dev).long())
        self._stage_thr = torch.from_numpy(c.stage_threshold).to(dev, dt)
        # _stage_sums' gather index per (first classifier, stage range)
        self._stage_index: Dict[tuple, torch.Tensor] = {}
        pm = np.zeros((len(self.paths), self.n_stages), bool)
        for i, p in enumerate(self.paths):
            pm[i, p] = True
        self._off_path = torch.from_numpy(~pm).to(dev)
        self._tilt12 = (torch.from_numpy(np.repeat(
            t.use_tilted.reshape(-1), 12)).to(dev)
            if c.has_tilted else None)
        self._scale = [self._scale_tables(k, grids[k], sc[k])
                       for k in range(self.n_scales)]

    # ---------------------------------------------------------- devices
    def shard_scales(self, devices) -> "ScaleCascadeDetector":
        """Split the scales across ``devices`` round-robin (JAX
        ``detector.py:329-353``): scale ``i`` runs on ``devices[i % k]``
        with the tables made again on that device; the integral planes
        go to each position once a frame, each position packs its own
        scales, and the host merges them in scale order, so the results
        equal the single-device path's.  A device may repeat: on one card
        the frame's program forks the positions onto streams of their
        own.  find-biggest-object stays on the detector's device."""
        # imported here: the runtime package imports the detect package
        from ..runtime.mesh import Mesh
        devs = list(devices)
        if not devs:
            raise ValueError("need at least one device")
        devs = Mesh(devs, ("scales",)).devices
        if devs[0].type != self.device.type:
            raise ValueError(f"scale devices {[str(d) for d in devs]} are "
                             f"not of the detector's type {self.device}")
        self._scale_devices = devs
        # a program made before the split runs every scale here: drop it
        if self._program is not None:
            self._program.release()
            self._program = None
        if self.n_scales:
            for d in devs:
                self._on(d)
        return self

    def _on(self, device) -> "ScaleCascadeDetector":
        """This detector with its tables on ``device`` (made once a
        device; itself on its own)."""
        from ..runtime.program import indexed
        device = indexed(device)
        if device == indexed(self.device):
            return self
        twin = self._twins.get(device)
        if twin is None:
            def mv(t):
                return t.to(device) if isinstance(t, torch.Tensor) else t

            twin = copy.copy(self)
            twin.device = device
            twin._program, twin._twins = None, {}
            twin._clf = tuple(mv(t) for t in self._clf)
            twin._stage_thr = mv(self._stage_thr)
            twin._stage_index = {}
            twin._off_path = mv(self._off_path)
            twin._tilt12 = mv(self._tilt12)
            twin._scale = [dataclasses.replace(g, **{
                f.name: mv(getattr(g, f.name))
                for f in dataclasses.fields(g)}) for g in self._scale]
            self._twins[device] = twin
        return twin

    def _merge(self, a: np.ndarray) -> np.ndarray:
        """Rows of a sharded frame's outputs (each position's scales in
        turn) in scale order; unsharded, ``a`` itself."""
        if self._scale_devices is None:
            return a
        k = len(self._scale_devices)
        order = np.concatenate([np.arange(j, self.n_scales, k)
                                for j in range(k)])
        out = np.empty_like(a)
        out[order] = a
        return out

    def _scale_tables(self, k: int, grid, sc) -> _Scale:
        ystep, xs, ys = grid
        t, dev = self.tables, self.device
        win_w, win_h = int(self.win_w[k]), int(self.win_h[k])
        ex, ey = int(cv_round(win_w * 0.15)), int(cv_round(win_h * 0.15))
        ew, eh = int(cv_round(win_w * 0.7)), int(cv_round(win_h * 0.7))
        canny = ([ey, ey, ey + eh, ey + eh], [ex, ex + ew, ex, ex + ew])
        equ = (sc.equ_corner_y.tolist(), sc.equ_corner_x.tolist())
        ny, nx = len(ys), len(xs)
        if ny == 0 or nx == 0:
            return _Scale(win_w, win_h, 0, 0, 1, 0, 0, True, sc.inv_area,
                          equ, canny)
        step = int(ystep)
        regular = step == ystep and np.array_equal(
            ys, step * np.arange(ny)) and np.array_equal(
            xs, step * np.arange(nx))
        if not regular:
            step = 1
        gy = ny if regular else int(ys[-1]) + 1
        gx = nx if regular else int(xs[-1]) + 1
        reach_y = max(int(t.corner_y[k].max(initial=0)), max(equ[0]),
                      max(canny[0]))
        reach_x = max(int(t.corner_x[k].max(initial=0)), max(equ[1]),
                      max(canny[1]))
        if int(ys[-1]) + reach_y > self.H or int(xs[-1]) + reach_x > self.W:
            raise ValueError(f"scale {self.scales[k]}: a window reaches "
                             f"past the frame")
        inb = ((ys[:, None] + win_h <= self.H)
               & (xs[None, :] + win_w <= self.W))
        offs = t.corner_y[k].astype(np.int64) * (self.W + 1) \
            + t.corner_x[k]
        return _Scale(
            win_w, win_h, ny, nx, step, gy, gx, regular, sc.inv_area, equ,
            canny, ys=torch.from_numpy(ys).to(dev),
            xs=torch.from_numpy(xs).to(dev),
            ys_l=torch.from_numpy(ys).to(dev).long(),
            xs_l=torch.from_numpy(xs).to(dev).long(),
            inb=torch.from_numpy(inb).to(dev),
            offs=torch.from_numpy(offs.reshape(-1).astype(np.int32)).to(dev),
            weight=torch.from_numpy(t.weight[k].reshape(-1)).to(
                dev, self.dtype))

    # ------------------------------------------------------ dense maps
    @staticmethod
    def _view(g: _Scale, p: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
        """Plane ``p`` at every dense-map position shifted by (dy, dx)."""
        st = g.step
        return p[dy:dy + st * (g.gy - 1) + 1:st,
                 dx:dx + st * (g.gx - 1) + 1:st]

    def _rect_map(self, g: _Scale, p: torch.Tensor, cy, cx) -> torch.Tensor:
        """A rect's sum at every dense-map position from its four corners
        (signs + - - +), in int32."""
        v = self._view
        return (v(g, p, int(cy[0]), int(cx[0])) - v(g, p, int(cy[1]),
                                                    int(cx[1]))
                - v(g, p, int(cy[2]), int(cx[2]))
                + v(g, p, int(cy[3]), int(cx[3])))

    def _lattice(self, g: _Scale, m: torch.Tensor) -> torch.Tensor:
        """A dense map at the lattice positions [ny, nx]."""
        if g.regular:
            return m
        return m.index_select(0, g.ys_l).index_select(1, g.xs_l)

    def _stage_votes(self, planes, g: _Scale, k: int, c0: int, c1: int,
                     vnf: torch.Tensor) -> torch.Tensor:
        """Votes [P, gy, gx] of classifiers ``c0..c1-1`` at every dense-map
        position, then zeros up to the power of two P.  Every corner of
        every rect of a chunk of classifiers is a view of its plane; the
        views are stacked (one copy), differenced in int32, weighed and
        summed in rect order
        (tempcv.cpp:905-918; a rect of weight 0 adds an exact zero), and
        walked (``_cart_votes``: ``node < thr * vnf`` with the product
        rounded first).  A chunk's stack stays under the gather budget."""
        t = self.tables
        T = t.T
        per = T * 12
        ck = max(1, self._gather_elems // max(1, per * g.gy * g.gx))
        votes = torch.empty((_pow2(c1 - c0), g.gy, g.gx), dtype=self.dtype,
                            device=self.device)
        votes[c1 - c0:] = 0
        for a in range(c0, c1, ck):
            b = min(a + ck, c1)
            cy = t.corner_y[k, a:b].reshape(-1).tolist()
            cx = t.corner_x[k, a:b].reshape(-1).tolist()
            tl = np.repeat(t.use_tilted[a:b].reshape(-1), 12).tolist()
            s = torch.stack([self._view(g, planes["tilted" if tl[i] else
                                                  "sum"], cy[i], cx[i])
                             for i in range(len(cy))])
            rs = s[0::4] - s[1::4] - s[2::4] + s[3::4]
            prod = rs * g.weight[a * T * 3:b * T * 3, None, None]
            nv = (prod[0::3] + prod[1::3] + prod[2::3]).view(
                b - a, T, g.gy, g.gx).permute(2, 3, 0, 1)
            votes[a - c0:b - c0] = _cart_votes(
                nv, vnf, *(x[a:b] for x in self._clf)).permute(2, 0, 1)
        return votes

    def _front(self, planes, g: _Scale, k: int, vnf: torch.Tensor):
        """Pass maps of stages ``0..front_k-1``."""
        spec = self.compiled.spec
        passes = []
        for st in range(self.front_k):
            c0 = int(spec.stage_clf_ofs[st])
            c1 = c0 + int(spec.stage_clf_cnt[st])
            ssum = _fold(self._stage_votes(planes, g, k, c0, c1, vnf), 0)
            passes.append(ssum >= self._stage_thr[st])
        return passes

    # ------------------------------------------------------------ scale
    def _empty(self, cap: int):
        dev = self.device
        z = torch.zeros(cap, dtype=torch.int32, device=dev)
        return (z, z, torch.zeros(cap, dtype=torch.bool, device=dev),
                torch.zeros(1, dtype=torch.int32, device=dev))

    def _per_scale(self, planes, k: int, cap: int, roi=None):
        """One scale: (sy, sx, ok, n_surv), the slots' rows and columns
        int32 [cap], which slots are detections, and the survivor count
        int32 [1] (above ``cap`` when the scale or a tail group overflowed).
        ``roi`` = (start_y, end_y, start_x, end_x) lattice-index bounds,
        [start, end), narrows the scan: the find-biggest-object search's
        scan ROI (tempcv.cpp:1408-1415).  No host reads."""
        g = self._scale[k]
        if g.ny == 0:
            return self._empty(cap)
        dev = self.device
        ey, ex = g.equ
        vnf = variance_factor(self._rect_map(g, planes["sum"], ey, ex),
                              self._rect_map(g, planes["sq_hi"], ey, ex),
                              self._rect_map(g, planes["sq_lo"], ey, ex),
                              g.inv_area, self.dtype)
        passes = self._front(planes, g, k, vnf)
        if self.is_tree:
            possible = torch.zeros_like(passes[0])
            for pth in self.paths:
                acc = torch.ones_like(passes[0])
                for st in pth:
                    if st < self.front_k:
                        acc = acc & passes[st]
                possible = possible | acc
        else:
            possible = passes[0]
            for p in passes[1:]:
                possible = possible & p
        inb = g.inb
        if roi is not None:
            sy0, sy1, sx0, sx1 = (int(v) for v in roi)
            iy = torch.arange(g.ny, device=dev)[:, None]
            ix = torch.arange(g.nx, device=dev)[None, :]
            inb = inb & (iy >= sy0) & (iy < sy1) & (ix >= sx0) & (ix < sx1)
        canny_ok = None
        if self.do_canny_pruning:
            # skip-by-2 and no evaluation where the edge density is low
            # (tempcv.cpp:1396-1405: s < 100 or sq < 20); the reference's
            # squared-sum pointer aliases the plain sum integral
            cy, cx = g.canny
            cs = self._rect_map(g, planes["canny"], cy, cx)
            cq = self._rect_map(g, planes["sum"], cy, cx)
            canny_ok = self._lattice(g, (cs >= 100) & (cq >= 20))
        front = self._lattice(g, possible) & inb
        if canny_ok is not None:
            front = front & canny_ok
        n_lat = g.ny * g.nx
        surv, n_surv = compact(front.reshape(1, n_lat).contiguous(), cap)
        surv = surv[0]
        valid = surv < n_lat
        idx = torch.where(valid, surv, 0).long()
        sy = g.ys[torch.div(idx, g.nx, rounding_mode="floor")]
        sx = g.xs[idx % g.nx]
        svnf = self._lattice(g, vnf).reshape(-1)[idx]
        accept, trunc = self._tail_accept(planes, g, sy * (self.W + 1) + sx,
                                          svnf, valid, cap)
        accept = accept & valid
        # a truncated tail group dropped windows: an over-cap count makes
        # the host regrow the cap (and every group cap with it)
        n_surv = torch.where(trunc, n_surv.clamp(min=cap + 1), n_surv)

        # the visit set: the scanner skips the next column after a
        # result of 0 (tempcv.cpp:1163), a stage-0 reject of a sequential
        # cascade (-i with i = 0) or any reject of a stage tree
        if self.is_tree:
            acc = torch.zeros(n_lat + 1, dtype=torch.bool, device=dev)
            acc.scatter_(0, surv.long(), accept)
            acc = acc[:n_lat].reshape(g.ny, g.nx)
            f = inb & ~(acc if canny_ok is None else canny_ok & acc)
        else:
            fail0 = self._lattice(g, ~passes[0])
            f = inb & (fail0 if canny_ok is None else ~canny_ok | fail0)
        # skip[i+1] = f[i] & ~skip[i] has the closed form: skip[i] iff the
        # run of f ending at i-1 has odd length; the run starts after the
        # last 0, a running maximum along the row
        col = torch.arange(g.nx, dtype=torch.int32, device=dev).expand(
            g.ny, g.nx)
        last0 = torch.cummax(torch.where(f, -1, col), dim=1).values
        odd = f & (((col - last0) & 1) == 1)
        visited = torch.ones_like(f)
        visited[:, 1:] = ~odd[:, :-1]
        ok = accept & visited.reshape(-1)[idx] & valid
        return sy, sx, ok, n_surv

    # ------------------------------------------------------------- tail
    def _votes_range(self, planes, g: _Scale, base: torch.Tensor,
                     svnf: torch.Tensor, c0: int, c1: int) -> torch.Tensor:
        """Votes [n, c1-c0] of classifiers ``c0..c1-1`` for the windows
        whose top-left corners sit at flat plane indices ``base`` [n]:
        corner gathers a chunk of classifiers at a time, int32 rect
        differences, rect-ordered node sums, CART walks
        (detector.py:537-612)."""
        T = self.tables.T
        per = T * 12
        n = base.shape[0]
        if self.clf_chunk is not None:
            ck = max(1, min(self.clf_chunk, c1 - c0))
        else:
            ck = max(1, self._gather_elems // max(1, n * per))
        sum_flat = planes["sum"].reshape(-1)
        out = []
        for a in range(c0, c1, ck):
            b = min(a + ck, c1)
            idx = (base[:, None] + g.offs[None, a * per:b * per]).reshape(-1)
            v = sum_flat.index_select(0, idx).view(n, -1)
            if self._tilt12 is not None:
                vt = planes["tilted"].reshape(-1).index_select(0, idx)
                v = torch.where(self._tilt12[None, a * per:b * per],
                                vt.view(n, -1), v)
            rs = (v[:, 0::4] - v[:, 1::4] - v[:, 2::4]
                  + v[:, 3::4]).to(self.dtype)
            prod = rs * g.weight[a * T * 3:b * T * 3]
            nv = (prod[:, 0::3] + prod[:, 1::3] + prod[:, 2::3]).view(
                n, b - a, T)
            out.append(_cart_votes(nv, svnf,
                                   *(x[a:b] for x in self._clf)))
        return torch.cat(out, dim=1) if len(out) > 1 else out[0]

    def _stage_groups(self, node_budget: int = 256):
        """Tail stages ``front_k..n_stages-1`` in contiguous groups of
        about ``node_budget`` classifiers (one group for the non-staged
        strategies)."""
        spec = self.compiled.spec
        if self.strategy in ("block", "direct"):
            node_budget = 1 << 30
        groups = []
        s = self.front_k
        while s < self.n_stages:
            e, nodes = s, 0
            while e < self.n_stages and (
                    nodes == 0
                    or nodes + int(spec.stage_clf_cnt[e]) <= node_budget):
                nodes += int(spec.stage_clf_cnt[e])
                e += 1
            groups.append((s, e))
            s = e
        return groups

    def _stage_sums(self, votes: torch.Tensor, c0: int, s0: int,
                    s1: int) -> torch.Tensor:
        """Sums [n, s1-s0] of stages ``s0..s1-1`` from the votes [n, m] of
        classifiers ``c0..``: each stage's votes gathered into a row
        padded with zeros to one power of two, then ``_fold``."""
        key = (c0, s0, s1)
        idx = self._stage_index.get(key)
        spec = self.compiled.spec
        m = votes.shape[1]
        if idx is None:
            cnt = spec.stage_clf_cnt[s0:s1].astype(np.int64)
            P = _pow2(int(cnt.max()))
            j = np.arange(P)[None]
            ix = np.where(j < cnt[:, None],
                          spec.stage_clf_ofs[s0:s1, None] - c0 + j, m)
            idx = torch.from_numpy(ix.reshape(-1)).to(self.device)
            self._stage_index[key] = idx
        n = votes.shape[0]
        padded = torch.cat([votes, votes.new_zeros(n, 1)], dim=1)
        return _fold(padded.index_select(1, idx).view(n, s1 - s0, -1), 2)

    def _tail_accept(self, planes, g: _Scale, base: torch.Tensor,
                     svnf: torch.Tensor, valid: torch.Tensor, cap: int):
        """(accept bool [cap], truncated bool []) of the survivor slots.

        Sequential cascades run the stage groups over progressively
        compacted survivor sets with the JAX package's shrinking cap
        schedule (detector.py:634-712); ``truncated`` says a group's
        survivors overflowed its cap, and the caller regrows.  Stage trees
        take every stage's sum and accept on any path that passes all its
        stages."""
        spec = self.compiled.spec
        dev = self.device
        no_trunc = torch.zeros((), dtype=torch.bool, device=dev)
        if self.is_tree:
            n_used = int((spec.stage_clf_ofs + spec.stage_clf_cnt).max())
            votes = self._votes_range(planes, g, base, svnf, 0, n_used)
            passes = self._stage_sums(votes, 0, 0, self.n_stages) \
                >= self._stage_thr
            per_path = (passes[:, None, :] | self._off_path[None]).all(-1)
            return per_path.any(-1), no_trunc
        groups = self._stage_groups()
        if not groups:
            return torch.ones(cap, dtype=torch.bool, device=dev), no_trunc
        orig = torch.arange(cap, dtype=torch.int32, device=dev)
        # padding slots never take a later group's capacity
        alive = valid
        cur_n = cap
        trunc = no_trunc
        for gi, (s0, s1) in enumerate(groups):
            c0 = int(spec.stage_clf_ofs[s0])
            c1 = int(spec.stage_clf_ofs[s1 - 1] + spec.stage_clf_cnt[s1 - 1])
            votes = self._votes_range(planes, g, base, svnf, c0, c1)
            passes = self._stage_sums(votes, c0, s0, s1) \
                >= self._stage_thr[s0:s1]
            ok = alive & passes.all(dim=1)
            if gi == len(groups) - 1:
                accept = torch.zeros(cap + 1, dtype=torch.bool, device=dev)
                accept.scatter_(0, torch.where(ok, orig, cap).long(), True)
                return accept[:cap], trunc
            ncap = min(max(cap >> (gi + 1), cap // 8, 512), cur_n)
            aidx, n_pass = compact(ok.reshape(1, -1).contiguous(), ncap)
            trunc = trunc | (n_pass[0] > ncap)
            live = aidx[0] < cur_n
            sel = torch.where(live, aidx[0], 0).long()
            base = torch.where(live, base[sel], 0)
            svnf = torch.where(live, svnf[sel], 1.0)
            orig = torch.where(live, orig[sel], cap)
            alive = live
            cur_n = ncap

    # ------------------------------------------------------------- host
    def frame(self, gray) -> torch.Tensor:
        """uint8 [H, W] -> a tensor where it lies (numpy: on the host),
        checked against the frame shape."""
        t = gray if isinstance(gray, torch.Tensor) else \
            torch.as_tensor(np.asarray(gray, np.uint8))
        if t.dtype != torch.uint8 or tuple(t.shape) != (self.H, self.W):
            raise ValueError(f"expected a uint8 frame of shape "
                             f"{(self.H, self.W)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        return t.contiguous()

    def put(self, gray) -> torch.Tensor:
        """uint8 [H, W] -> a tensor on the detector's device."""
        return self.frame(gray).to(self.device)

    def _prep(self, gray: torch.Tensor, canny_steps: Optional[int] = None):
        """The frame's integral planes, each int32 [H+1, W+1]: ``sum``,
        ``sq_hi``/``sq_lo``, ``tilted`` (tilted cascades) and ``canny``
        (the integral of ``canny(gray, 0, 50)``, with Canny pruning).
        ``canny_steps`` bounds Canny's hysteresis for a graph and adds
        ``canny_done``, its fixpoint flag (``ops.canny.canny``)."""
        ii = integral_images(gray, with_tilted=self.compiled.has_tilted)
        planes = dict(sum=ii.sum, sq_hi=ii.sq_hi, sq_lo=ii.sq_lo,
                      tilted=ii.tilted)
        if self.do_canny_pruning:
            if canny_steps is None:
                edges = canny(gray, 0, 50)
            else:
                edges, planes["canny_done"] = canny(gray, 0, 50, canny_steps)
            planes["canny"] = integral_2d(edges.to(torch.int32))
        return planes

    def _pack_device(self, outs, cap: int, acap: int) -> Dict[str,
                                                               torch.Tensor]:
        """Every scale's accepted windows in one int32 array ``packed``
        [S, 2 + 2*acap] (n_surv, n_acc, rows, columns) through one
        compaction launch; and the scales' full ``sy``, ``sx``, ``ok``,
        for when a scale accepted more than ``acap``.  No host read."""
        sy, sx, ok = (torch.stack([o[i] for o in outs]) for i in range(3))
        n_surv = torch.cat([o[3] for o in outs])
        acc, n_acc = compact(ok, acap)
        sel = torch.where(acc < cap, acc, 0).long()
        packed = torch.cat([n_surv[:, None], n_acc[:, None],
                            sy.gather(1, sel), sx.gather(1, sel)], dim=1)
        return dict(packed=packed, sy=sy, sx=sx, ok=ok)

    def _pack(self, outs, cap: int, acap: int):
        """``_pack_device``, its packed array copied to the host:
        (packed, (sy, sx, ok))."""
        d = self._pack_device(outs, cap, acap)
        return d["packed"].cpu().numpy(), (d["sy"], d["sx"], d["ok"])

    def _scales_device(self, planes, cap: int) -> Dict[str, torch.Tensor]:
        """Every scale and the pack.  With ``shard_scales`` each position
        takes its scales on its device and stream and packs them, and the
        packed rows come to this detector's device position by position
        (``_merge`` puts them in scale order)."""
        acap = min(cap, ACCEPT_CAP)
        devs = self._scale_devices
        if devs is None:
            return self._pack_device([self._per_scale(planes, k, cap)
                                      for k in range(self.n_scales)],
                                     cap, acap)
        from ..runtime.mesh import Fork
        fork = Fork(devs, home=self.device)
        parts = []
        for j, d in enumerate(devs[:self.n_scales]):
            with fork.at(j):
                det = self._on(d)
                pl = {n: v.to(d) if isinstance(v, torch.Tensor) else v
                      for n, v in planes.items()}
                out = det._pack_device(
                    [det._per_scale(pl, k, cap)
                     for k in range(j, self.n_scales, len(devs))], cap, acap)
                parts.append({n: fork.home(t, j) for n, t in out.items()})
        fork.join()
        return {n: torch.cat([p[n] for p in parts]) for n in parts[0]}

    def _frame_device(self, gray: torch.Tensor, cap: int,
                      canny_steps: int) -> Dict[str, torch.Tensor]:
        """The whole frame on the device, from the uint8 frame to the
        packed array, with no host read: prep (Canny's hysteresis bounded
        to ``canny_steps``), every scale, the pack.  The function the
        program captures (JAX's ``_jit_scales``)."""
        planes = self._prep(gray, canny_steps)
        out = self._scales_device(planes, cap)
        if self.do_canny_pruning:
            out["canny_done"] = planes["canny_done"]
        return out

    def program(self):
        """The frame's program at the current cap and Canny step count:
        a CUDA graph in float32 on the card, else the eager function.
        One is kept, at the latest key; a new key releases the old one
        once its replays are done."""
        # imported here: the runtime package imports the detect package
        from ..runtime.program import Program
        key = (self.cap, self._canny_steps)
        p = self._program
        if p is not None and p.key == key:
            return p
        self._program = None
        if p is not None:
            p.release()
        names = ("packed", "canny_done") if self.do_canny_pruning \
            else ("packed",)
        self._program = Program(
            functools.partial(self._frame_device, cap=self.cap,
                              canny_steps=self._canny_steps),
            (self.H, self.W), self.device, readback=names, key=key,
            graph=(self.device.type == "cuda"
                   and self.dtype == torch.float32))
        return self._program

    def candidates(self, gray) -> Tuple[np.ndarray, bool]:
        """Raw candidates (x, y, w, h) in the scan order (scales ascending,
        rows then columns) and whether a survivor cap overflowed.  ONE
        packed readback after the last scale, from the program; the cap
        grows 4x and the frame runs again while a scale overflows it, up
        to the lattice size (and Canny's step count 4x while its
        hysteresis did not reach the fixpoint).  A scale that accepted
        more windows than the packed array holds runs the frame again
        eagerly for the full arrays."""
        if self.n_scales == 0:
            return np.zeros((0, 4), np.int32), False
        frame = self.frame(gray)
        lattice = self.max_y * self.max_x
        while True:
            prog = self.program()
            h = prog.run(frame)
            out = prog.read(h)
            if self.do_canny_pruning and not out["canny_done"][0]:
                self._canny_steps *= 4
                continue
            packed = self._merge(out["packed"])
            if (packed[:, 0] > self.cap).any() and self.cap < lattice:
                self.cap = min(self.cap * 4, lattice)
                continue
            break
        overflow = bool((packed[:, 0] > self.cap).any())
        acap = (packed.shape[1] - 2) // 2
        host = None
        boxes = []
        for k in range(self.n_scales):
            na = int(packed[k, 1])
            if na == 0:
                continue
            if na <= acap:
                sy = packed[k, 2:2 + na]
                sx = packed[k, 2 + acap:2 + acap + na]
            else:
                if host is None:
                    full = self._frame_device(self.put(frame), self.cap,
                                              self._canny_steps)
                    host = [self._merge(full[n].cpu().numpy())
                            for n in ("sy", "sx", "ok")]
                m = host[2][k]
                sy, sx = host[0][k][m], host[1][k][m]
            boxes.append(np.stack([sx, sy, np.full_like(sx, self.win_w[k]),
                                   np.full_like(sx, self.win_h[k])], axis=1))
        cand = (np.concatenate(boxes).astype(np.int32) if boxes
                else np.zeros((0, 4), np.int32))
        return cand, overflow

    def find_biggest_object(self, gray, min_neighbors: int = 3,
                            min_size: Tuple[int, int] = (0, 0),
                            rough_search: bool = False) -> np.ndarray:
        """CV_HAAR_FIND_BIGGEST_OBJECT search with the windows evaluated on
        the device (tempcv.cpp:1349-1454, 1477-1489).  Scales descend from
        the largest; after the first scale with candidates the scan
        narrows to an eps-expanded ROI around the biggest grouped box and
        the smallest window rises to 0.4 (0.6 with DO_ROUGH_SEARCH) of it.
        The loop is sequential host logic, so every scale reads its
        windows back.  Build the detector with ``min_size=(0, 0)`` so that
        every factor is there, and pass the caller's minSize here.
        Returns the biggest box [1, 4], or [0, 4]."""
        eps = 0.2
        if self.n_scales == 0:
            return np.zeros((0, 4), np.int32)
        if self._fbo_acap is None:
            self._fbo_acap = min(self.cap, ACCEPT_CAP)
        planes = self._prep(self.put(gray))
        H, W = self.H, self.W
        min_w, min_h = min_size
        scan_roi = None
        candidates: List[Tuple[int, int, int, int]] = []
        lattice = self.max_y * self.max_x

        def run_scale(k, roi):
            # regrow the survivor cap and the accept cap rather than clamp:
            # a dense frame could otherwise change the biggest object
            while True:
                acap = self._fbo_acap
                p = self._pack([self._per_scale(planes, k, self.cap, roi)],
                               self.cap, acap)[0][0]
                grew = False
                if int(p[0]) > self.cap and self.cap < lattice:
                    self.cap = min(self.cap * 4, lattice)
                    grew = True
                if int(p[1]) > acap and acap < self.cap:
                    self._fbo_acap = min(self.cap, acap * 4)
                    grew = True
                if not grew:
                    break
            na = min(int(p[1]), acap)
            if not na:
                return np.zeros((0, 4), np.int32)
            return np.stack([p[2 + acap:2 + acap + na], p[2:2 + na],
                             np.full(na, self.win_w[k], np.int32),
                             np.full(na, self.win_h[k], np.int32)], axis=1)

        for k in reversed(range(self.n_scales)):
            ystep = max(2.0, float(self.scales[k]))
            win_w, win_h = int(self.win_w[k]), int(self.win_h[k])
            if win_w < min_w or win_h < min_h:
                break  # descending scales: nothing smaller qualifies
            if scan_roi is None:
                roi = (0, int(cv_round((H - win_h) / ystep)),
                       0, int(cv_round((W - win_w) / ystep)))
            else:
                rx, ry, rw, rh = scan_roi
                roi = (int(cv_round(ry / ystep)),
                       int(cv_round((ry + rh - win_h) / ystep)),
                       int(cv_round(rx / ystep)),
                       int(cv_round((rx + rw - win_w) / ystep)))
            candidates.extend(map(tuple, run_scale(k, roi).tolist()))
            if candidates and scan_roi is None:
                # lock on: group, expand the biggest box by eps, raise the
                # smallest window (tempcv.cpp:1422-1454)
                grouped, _ = group_rectangles(
                    np.asarray(candidates, np.int64),
                    max(min_neighbors, 1), eps)
                if len(grouped):
                    mx = grouped[int(np.argmax(grouped[:, 2]
                                               * grouped[:, 3]))]
                    candidates.append(tuple(int(v) for v in mx))
                    dx = int(cv_round(mx[2] * eps))
                    dy = int(cv_round(mx[3] * eps))
                    rx = max(int(mx[0]) - dx, 0)
                    ry = max(int(mx[1]) - dy, 0)
                    rw = min(int(mx[2]) + dx * 2, W - 1 - rx)
                    rh = min(int(mx[3]) + dy * 2, H - 1 - ry)
                    scan_roi = (rx, ry, rw, rh)
                    min_scale = 0.6 if rough_search else 0.4
                    min_w = int(cv_round(mx[2] * min_scale))
                    min_h = int(cv_round(mx[3] * min_scale))
        boxes = np.asarray(candidates, np.int64).reshape(-1, 4)
        boxes, _ = group_rectangles(boxes, max(min_neighbors, 1), eps)
        if not len(boxes):
            return np.zeros((0, 4), np.int32)
        biggest = boxes[int(np.argmax(boxes[:, 2] * boxes[:, 3]))]
        return biggest[None].astype(np.int32)

    def detect(self, gray, min_neighbors: int = 3) -> DetectionResult:
        """Candidates and their grouping (cvHaarDetectObjectsForROC's
        tail, tempcv.cpp:1461-1472)."""
        cand, overflow = self.candidates(gray)
        if min_neighbors != 0:
            boxes, neigh = group_rectangles(cand, max(min_neighbors, 1),
                                            eps=0.2)
        else:
            boxes, neigh = cand, np.ones(len(cand), np.int32)
        return DetectionResult(boxes=boxes, neighbors=neigh,
                               candidates=cand, survivor_overflow=overflow)
