"""Scale-image pyramid detector (torch; CUDA kernels on the card).

Port of ``clfacedetection_tpu/detect/pyramid.py``: OpenCV's
CV_HAAR_SCALE_IMAGE mode (tempcv.cpp:1257-1328, 989-1113).  All pyramid
levels are resized with the pinned fixed-point bilinear resize and packed
into ONE canvas (``PyramidPlan``, numpy); one integral pass serves every
level, and a static visit lattice keeps every window inside its level.

Per batch of frames the device pipeline is

    canvas + integrals (plain torch) -> dense front (kernel)
    -> survivor compaction (kernel) -> survivor tail (kernels)
    -> accept compaction (kernel) -> ONE packed int32 readback
       [n_surv, n_acc, acc_y[acap], acc_x[acap]] per frame

with no host synchronisation inside it: JAX's three phases,
``_front_device`` (prep and front), ``_compact_device`` and
``_tail_device`` (tail and packing), which the row strips and the
sharded API call apart.  On the card the float32 pipeline
runs as a captured program (``runtime/program.py``): a CUDA graph per
batch size at the current cap, replayed, its packed output copied to a
pinned host slot (JAX's ``_jit_pipeline``).  Three survivor tails, as in the
JAX package (``pyramid.py:427-481``): tail2 walks the cascade inside its
kernel with early exit and serves stump cascades with upright features,
sequential stages and windows up to 31 px wide; the v1 tail serves
every other cascade of the zoo (CART trees, tilted features, stage
trees, wide windows).  On the default strategy it is one kernel that
walks each survivor's stages from the integral planes (``tail_walk``);
``strategy="block"`` keeps JAX's v1 structure for every cascade: every
node's value in one kernel (``haar_tail``), then the CART walks, stage
sums and stage-tree path tests in a second (``tail_rows``).
``strategy="direct"`` takes the node values from one stencil matrix
product instead (JAX's XLA tail; ``ops/stencil.py``), then the same
``tail_rows``.  With ``output_levels`` every frame also packs its ROC
windows (exit stage and stage sum, tempcv.cpp:1084-1095) into a second
readback.  float64 runs the plain versions of the front and the tails,
on the card too: those kernels are float32, as the JAX package's Pallas
path is; its compactions launch the compaction kernel, which has no
float type.  The plain versions read their tables from the cascade
table's cache, so float64 on the card is captured as a CUDA graph too.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import trace
from ..models.compile import (compile_cascade, cv_round, scale_factors,
                              truncate_cascade)
from ..models.spec import CascadeSpec
from ..ops.compact_kernel import compact, compact_plain
from ..ops.cascade_table import CascadeTable
from ..ops.haar_front import (front_masks_plain, front_plain, haar_front,
                              vnf_plain)
from ..ops.haar_tail import haar_tail, tail_values_plain
from ..ops.haar_tail2 import haar_tail2, tail2_plain
from ..ops.integral import IntegralImages, integral_images
from ..ops.resize import ResizePlan, resize_bilinear_u8, resize_plan
from ..ops.stencil import build_stencils, stencil_values
from ..ops.tail_rows import tail_rows, tail_rows_plain
from ..ops.tail_walk import tail_walk, tail_walk_plain
from ..trace import span
from .detector import (STRATEGIES, DetectionResult, _build_clf_tables,
                       _stage_paths, default_device, grouped, served)
from .grouping import group_rectangles

__all__ = ["PyramidDetector", "PyramidPlan", "default_device"]

ACCEPT_CAP = 4096   # accepted windows read back per frame in one array
# node values of one chunk of the direct strategy's product
_DIRECT_CHUNK_ELEMS = 1 << 26


@dataclasses.dataclass(frozen=True)
class _Level:
    factor: float
    h: int
    w: int
    oy: int          # canvas row offset
    ox: int          # canvas column offset
    ystep: int       # 1 if factor > 2 else 2
    win_w: int       # cvRound(w0 * factor): output box size
    win_h: int


def _pack_levels(dims: List[Tuple[int, int]], cw: int,
                 quantum: int = 8) -> Tuple[List[Tuple[int, int]], int]:
    """First-fit occupancy-grid packing of ``(h, w)`` rectangles into a
    strip of width ``cw`` on a ``quantum``-aligned grid; returns offsets
    and the used height."""
    if not dims:
        return [], 1
    gq = quantum
    gw = max(1, cw // gq)
    gh = (sum(h for h, _ in dims) + gq - 1) // gq + 1
    occ = np.zeros((gh, gw), np.int32)
    offsets: List[Tuple[int, int]] = []
    used_h = 0
    for h, w in dims:
        ch = -(-h // gq)
        cw_ = min(-(-w // gq), gw)
        ii = np.zeros((gh + 1, gw + 1), np.int64)
        ii[1:, 1:] = occ.cumsum(0).cumsum(1)
        ys = gh - ch + 1
        xs = gw - cw_ + 1
        free = (ii[ch:ch + ys, cw_:cw_ + xs] - ii[:ys, cw_:cw_ + xs]
                - ii[ch:ch + ys, :xs] + ii[:ys, :xs]) == 0
        gy, gx = np.argwhere(free)[0]
        occ[gy:gy + ch, gx:gx + cw_] = 1
        offsets.append((int(gy) * gq, int(gx) * gq))
        used_h = max(used_h, int(gy) * gq + h)
    return offsets, max(used_h, 1)


@dataclasses.dataclass
class PyramidPlan:
    """Host-side static geometry of the packed pyramid (numpy)."""

    levels: List[_Level]
    canvas_h: int
    canvas_w: int

    @classmethod
    def build(cls, spec: CascadeSpec, image_shape: Tuple[int, int],
              scale_factor: float, min_size: Tuple[int, int],
              max_size: Optional[Tuple[int, int]]) -> "PyramidPlan":
        H, W = image_shape
        factors = scale_factors(spec.window_w, spec.window_h, W, H,
                                scale_factor, min_size, max_size,
                                mode="scale_image")
        dims = [(int(cv_round(H / f)), int(cv_round(W / f)))
                for f in factors]
        if not dims:
            return cls(levels=[], canvas_h=1, canvas_w=1)
        # the strip width that minimises the (32, 256)-padded grid area,
        # as the JAX plan chooses it, so both packages share one canvas
        w_max = max(w for _, w in dims)
        best = None
        cands = {-(-(base + 1) // 256) * 256 - 1
                 for base in (w_max, w_max * 3 // 2, 2 * w_max)}
        cands.add(-(-(w_max + 1) // 256) * 256 + 255)
        for cw_cand in cands:
            if cw_cand < w_max:
                continue
            offs, hh = _pack_levels(dims, cw_cand)
            grid_area = (-(-(hh + 1) // 32) * 32) * \
                (-(-(cw_cand + 1) // 256) * 256)
            if best is None or grid_area < best[0]:
                best = (grid_area, cw_cand, offs, hh)
        _, cw, offsets, used_h = best
        levels = [
            _Level(factor=f, h=h, w=w, oy=oy, ox=ox,
                   ystep=1 if f > 2 else 2,
                   win_w=int(cv_round(spec.window_w * f)),
                   win_h=int(cv_round(spec.window_h * f)))
            for f, (h, w), (oy, ox) in zip(factors, dims, offsets)]
        return cls(levels=levels, canvas_h=used_h, canvas_w=cw)

    def visit_mask(self, w0: int, h0: int) -> np.ndarray:
        """Static scan lattice on the canvas (tempcv.cpp:1015-1020,1092)."""
        m = np.zeros((self.canvas_h + 1, self.canvas_w + 1), bool)
        for lv in self.levels:
            y2, x2 = lv.h - h0, lv.w - w0
            if y2 <= 0 or x2 <= 0:
                continue
            ys = np.arange(0, y2, lv.ystep)
            xs = np.arange(0, x2, lv.ystep)
            m[np.ix_(lv.oy + ys, lv.ox + xs)] = True
        return m

    def _level_map(self) -> np.ndarray:
        lm = getattr(self, "_lm", None)
        if lm is None:
            lm = np.full((self.canvas_h + 1, self.canvas_w + 1), -1,
                         np.int16)
            for i, lv in enumerate(self.levels):
                lm[lv.oy:lv.oy + lv.h, lv.ox:lv.ox + lv.w] = i
            self._lm = lm
        return lm

    def boxes_for(self, cy: np.ndarray, cx: np.ndarray) -> np.ndarray:
        """Canvas scan positions -> original-image boxes
        (Rect(cvRound(x*f), cvRound(y*f), winW, winH), tempcv.cpp:1096)."""
        cy = np.asarray(cy, np.int64)
        cx = np.asarray(cx, np.int64)
        idx = self._level_map()[cy, cx].astype(np.int64)
        f = np.array([lv.factor for lv in self.levels])
        oy = np.array([lv.oy for lv in self.levels])
        ox = np.array([lv.ox for lv in self.levels])
        ww = np.array([lv.win_w for lv in self.levels], np.int32)
        wh = np.array([lv.win_h for lv in self.levels], np.int32)
        out = np.empty((len(cy), 4), np.int32)
        out[:, 0] = cv_round((cx - ox[idx]) * f[idx])
        out[:, 1] = cv_round((cy - oy[idx]) * f[idx])
        out[:, 2] = ww[idx]
        out[:, 3] = wh[idx]
        return out


class PyramidDetector:
    """Scale-image detector for one (cascade, frame shape) pair.

    ``device`` is where the pipeline runs: the card by default (an error
    without one); ``device="cpu"`` runs the plain PyTorch versions.  On a
    CUDA device the front, compaction and tails run as CUDA kernels in
    float32; in float64 the front and tails run their plain versions (the
    JAX package's Pallas path is float32 only, ``pyramid.py:417-419,
    439-443``) and the compactions their kernel; on the CPU the plain
    versions run, in float32 or float64.  ``cap`` is the
    survivor slot count per frame; it grows 4x while a frame overflows it
    (``candidates``/``detect``).  ``strategy`` picks the survivor tail:
    ``None``/``"per_stage"`` take tail2 where the cascade allows it and
    the v1 tail's walk (``tail_walk``) otherwise; ``"block"`` always takes
    the v1 tail's node values and decisions (``haar_tail``, ``tail_rows``);
    ``"direct"`` the stencil product.  ``output_levels`` adds the ROC
    output (``candidates_with_levels``); for sequential cascades it lowers
    ``front_k`` to ``n_stages - 4``, so that every window the ROC reports
    reaches the tail (JAX ``pyramid.py:370-376``).  ``candidates``,
    ``candidates_with_levels`` and ``detect`` run the pipeline through
    :meth:`program`: on the card a CUDA graph, on the CPU the eager
    function."""

    def __init__(self, spec: CascadeSpec, image_shape: Tuple[int, int],
                 scale_factor: float = 1.1,
                 min_size: Tuple[int, int] = (0, 0),
                 max_size: Optional[Tuple[int, int]] = None,
                 front_stages: int = 4,
                 cap: Optional[int] = None,
                 dtype: torch.dtype = torch.float32,
                 max_stages: Optional[int] = None,
                 strategy: Optional[str] = None,
                 output_levels: bool = False,
                 device=None):
        self.spec = spec
        self.H, self.W = int(image_shape[0]), int(image_shape[1])
        self.device = torch.device(device) if device is not None \
            else default_device()
        if dtype not in (torch.float32, torch.float64):
            raise ValueError(f"dtype must be float32 or float64, got {dtype}")
        if strategy not in STRATEGIES:
            raise ValueError(f"unknown strategy {strategy!r}")
        self.strategy = strategy
        self.dtype = dtype
        c = compile_cascade(spec)
        if max_stages is not None:
            c = truncate_cascade(c, max_stages)
        self.compiled = c
        self.n_stages = c.spec.n_stages
        self.is_tree = c.is_tree
        self.paths = _stage_paths(c)
        self.front_k = max(1, min(front_stages, self.n_stages))
        if self.is_tree:
            # the front ANDs its stages, which is sound only over the
            # stages common to every root-to-leaf path: a window may fail
            # stage 5 and pass through a sibling subtree (pyramid.py:359-369)
            common = min(len(p) for p in self.paths)
            for i in range(common):
                if len({p[i] for p in self.paths}) != 1:
                    common = i
                    break
            self.front_k = max(1, min(self.front_k, common))
        self.output_levels = bool(output_levels)
        if self.output_levels and not self.is_tree:
            # windows that exit within 4 stages of the end are reported
            # (tempcv.cpp:1087), so they must reach the tail; a stage
            # tree reports accepted windows only (pyramid.py:370-376)
            self.front_k = max(1, min(self.front_k, self.n_stages - 4))
        self.plan = PyramidPlan.build(spec, image_shape, scale_factor,
                                      min_size, max_size)
        self.n_levels = len(self.plan.levels)
        # ONE program (its graph's memory pool held at its peak), for the
        # batch size and cap it was made for, on mesh position ``slot``'s
        # stream (runtime/mesh.py); its twins at other positions (``_on``)
        self._program = None
        self.slot = 0
        self._twins: Dict[tuple, "PyramidDetector"] = {}
        # whether the survivor tail is the walk (``tail_walk``)
        self.walk_tail = False
        if self.n_levels == 0:
            return

        w0, h0 = spec.window_w, spec.window_h
        self.w0, self.h0 = w0, h0
        self.hv, self.wv = self.plan.canvas_h + 1, self.plan.canvas_w + 1
        tables = _build_clf_tables(c, [1.0])
        sc1 = c.at_scale(1.0)
        self.table = CascadeTable.build(c, tables, sc1.equ_corner_y,
                                        sc1.equ_corner_x, sc1.inv_area)
        # tail2 where the JAX package takes it (pyramid.py:476-481)
        self.use_tail2 = (strategy not in ("block", "direct")
                          and self.table.T == 1
                          and not self.is_tree and not c.has_tilted
                          and w0 + 1 <= 32)
        self.walk_tail = not self.use_tail2 and strategy not in ("block",
                                                                 "direct")
        if strategy == "direct":
            # JAX's (h0 + 1) x (w0 + 1) patch (pyramid.py:509-537)
            sten = build_stencils(self.table, h0 + 1, w0 + 1)
            self._stencils = tuple(
                None if m is None else torch.from_numpy(m).to(
                    self.device, dtype) for m in sten)
        vm = self.plan.visit_mask(w0, h0)
        self.n_visit = int(vm.sum())
        if cap is None:
            cap = int(2 ** np.ceil(np.log2(
                min(max(self.n_visit // 16, 256), 16384))))
        self.cap = min(int(cap), max(self.n_visit, 1))
        # the XLA path's plane pad: every window corner stays in the plane
        self._pad = w0 + h0 + 4
        dev = self.device
        self._visit = torch.from_numpy(vm).to(dev)
        self._resize = {
            i: resize_plan((self.H, self.W), (lv.h, lv.w), dev)
            for i, lv in enumerate(self.plan.levels)
            if (lv.h, lv.w) != (self.H, self.W)}

    # ------------------------------------------------------------- prep
    def _assemble_canvas(self, frames: torch.Tensor) -> torch.Tensor:
        """[B, H, W] uint8 -> [B, canvas_h, canvas_w] uint8."""
        plan = self.plan
        canvas = torch.zeros((frames.shape[0], plan.canvas_h, plan.canvas_w),
                             dtype=torch.uint8, device=frames.device)
        for i, lv in enumerate(plan.levels):
            lvl = (frames if i not in self._resize else
                   resize_bilinear_u8(frames, (lv.h, lv.w), self._resize[i]))
            canvas[:, lv.oy:lv.oy + lv.h, lv.ox:lv.ox + lv.w] = lvl
        return canvas

    def _prep_planes(self, frames: torch.Tensor) -> IntegralImages:
        """Canvas, integral planes, zero pad: (sum, sq_hi, sq_lo, tilted),
        each int32 [B, Hv + pad, Wv + pad]; ``tilted`` only for cascades
        with tilted features (pyramid.py:762-771), else None."""
        return integral_images(self._assemble_canvas(frames), self._pad,
                               with_tilted=self.compiled.has_tilted)

    # --------------------------------------------------------- pipeline
    def _plain(self, plain: bool) -> bool:
        """Whether the front and the tails run their plain versions: on
        the plain path, and in float64 (their kernels are float32).  The
        compactions take theirs on the plain path alone."""
        return plain or self.dtype == torch.float64

    def _front_device(self, frames: torch.Tensor, plain: bool = False
                      ) -> Dict[str, object]:
        """Phase 1 (JAX ``_front_device``): canvas, integral planes and the
        dense front over [B, H, W] uint8 frames: ``planes``
        (``IntegralImages``), ``vnf`` [B, Hv, Wv] and ``front`` bool
        [B, Hv * Wv]."""
        front_fn = front_plain if self._plain(plain) else haar_front
        ii = self._prep_planes(frames)
        front, vnf = front_fn(ii.sum, ii.sq_hi, ii.sq_lo, self._visit,
                              self.table, self.front_k, self.dtype,
                              ii.tilted)
        return dict(planes=ii, vnf=vnf,
                    front=front.reshape(frames.shape[0], -1))

    def _compact_device(self, front_flat: torch.Tensor, cap: int,
                        plain: bool = False):
        """Phase 2 (JAX ``_compact_device``): (surv_idx int32 [B, cap],
        n_surv int32 [B]) from the flat front; unused slots hold the flag
        count ``Hv * Wv``."""
        compact_fn = compact_plain if plain else compact
        return compact_fn(front_flat, cap)

    def _tail_device(self, s: torch.Tensor, tilted: Optional[torch.Tensor],
                     vnf: torch.Tensor, surv_idx: torch.Tensor,
                     n_surv: torch.Tensor, cap: int, plain: bool = False
                     ) -> Dict[str, torch.Tensor]:
        """Phase 3 (JAX ``_tail_device``): the survivor tail over the slots
        ``surv_idx`` (a slot holding ``Hv * Wv`` is padding) of the sum
        (and tilted) plane and the vnf map, then the accept compaction
        into the packed array [B, 2 + 2*acap] (and the ROC's with
        ``output_levels``)."""
        compact_fn = compact_plain if plain else compact
        plain = self._plain(plain)
        n = self.hv * self.wv
        if self.use_tail2:
            tail_fn = tail2_plain if plain else haar_tail2
            rows = tail_fn(s, vnf, surv_idx, self.table, self.front_k)
        else:
            rows = self._tail_v1(s, tilted, vnf, surv_idx, plain)
        ok = rows[..., 1] > 0
        acap = min(cap, ACCEPT_CAP)
        acc, n_acc = compact_fn(ok, acap)
        acc_flat = surv_idx.gather(1, torch.where(acc < cap, acc, 0).long())
        acc_y = torch.div(acc_flat, self.wv, rounding_mode="floor")
        packed = torch.cat([n_surv[:, None], n_acc[:, None], acc_y,
                            acc_flat - acc_y * self.wv], dim=1)
        out = dict(packed=packed, surv_idx=surv_idx, ok=ok)
        if self.output_levels:
            # every window whose exit stage is within 4 of the end, pass
            # or fail (pyramid.py:1124-1130), in one packed array
            # [n_surv, n_roc, y, x, level, weight] of the pipeline dtype
            # (pyramid.py:1090-1108)
            valid = (surv_idx >= 0) & (surv_idx < n)
            ok_roc = (ok | (self.n_stages - rows[..., 2] < 4)) & valid
            roc, n_roc = compact_fn(ok_roc, acap)
            sel = torch.where(roc < cap, roc, 0).long()
            flat = surv_idx.gather(1, sel)
            y = torch.div(flat, self.wv, rounding_mode="floor")
            dt = rows.dtype
            out["packed_roc"] = torch.cat([
                n_surv[:, None].to(dt), n_roc[:, None].to(dt), y.to(dt),
                (flat - y * self.wv).to(dt), rows[..., 2].gather(1, sel),
                rows[..., 3].gather(1, sel)], dim=1)
            out.update(ok_roc=ok_roc, rows=rows)
        return out

    def _detect_device(self, frames: torch.Tensor, cap: int,
                       plain: bool = False) -> Dict[str, torch.Tensor]:
        """The device pipeline over [B, H, W] uint8 frames on
        ``self.device``, the three phases in turn; no host
        synchronisation.  ``plain`` runs the plain PyTorch versions of the
        kernels on the same device (the reference a card run is checked
        against); float64 always does for the front and the tails."""
        f = self._front_device(frames, plain)
        surv_idx, n_surv = self._compact_device(f["front"], cap, plain)
        ii = f["planes"]
        return self._tail_device(ii.sum, ii.tilted, f["vnf"], surv_idx,
                                 n_surv, cap, plain)

    def _tail_v1(self, s, tilted, vnf, surv_idx, plain: bool = False):
        """The v1 tail, as tail2's rows [B, cap, 4]: on the default
        strategy one walk of each survivor's stages from the planes
        (``tail_walk``); with ``strategy="block"`` JAX's structure, every
        node's value (``haar_tail``) then votes, stage sums and accept
        (``tail_rows``); with ``"direct"`` the stencil product then
        ``tail_rows``."""
        n = self.hv * self.wv
        valid = (surv_idx >= 0) & (surv_idx < n)
        svnf = vnf.reshape(vnf.shape[0], -1).gather(
            1, torch.where(valid, surv_idx, 0).long())
        paths = self.paths if self.is_tree else None
        if self.strategy not in ("block", "direct"):
            walk_fn = tail_walk_plain if plain else tail_walk
            return walk_fn(s, tilted, svnf, surv_idx, self.hv, self.wv,
                           self.table, self.front_k, paths)
        rows_fn = tail_rows_plain if plain else tail_rows
        if self.strategy == "direct":
            return self._tail_direct(s, tilted, svnf, surv_idx, rows_fn,
                                     paths)
        tail_fn = tail_values_plain if plain else haar_tail
        # the node values are passed on without a name here, so that the
        # plain version can free them once the stage sums are taken
        return rows_fn(tail_fn(s, tilted, surv_idx, self.hv, self.wv,
                               self.table, self.dtype),
                       svnf, surv_idx, n, self.table, self.front_k, paths)

    def _tail_direct(self, s, tilted, svnf, surv_idx, rows_fn, paths):
        """``strategy="direct"``: node values from the stencil product,
        chunked over slots so that a chunk's values stay under
        ``_DIRECT_CHUNK_ELEMS`` (``_tail_accept``, pyramid.py:644-669),
        then ``rows_fn`` on each chunk."""
        B, cap = surv_idx.shape
        n = self.hv * self.wv
        nn = self.table.n_clf * self.table.T
        step = max(1, _DIRECT_CHUNK_ELEMS // max(1, B * nn))
        sten_sum, sten_tilt = self._stencils
        out = []
        for a in range(0, cap, step):
            idx = surv_idx[:, a:a + step].contiguous()
            vals = stencil_values(s, tilted, idx, self.hv, self.wv,
                                  self.h0 + 1, self.w0 + 1, sten_sum,
                                  sten_tilt)
            out.append(rows_fn(vals, svnf[:, a:a + step].contiguous(), idx,
                               n, self.table, self.front_k, paths))
            del vals
        return torch.cat(out, dim=1)

    def frames(self, frames) -> torch.Tensor:
        """[B, H, W] (or [H, W]) uint8 -> a [B, H, W] tensor where it lies
        (a numpy array: on the host), checked against the frame shape."""
        t = torch.as_tensor(np.asarray(frames, np.uint8)) \
            if not isinstance(frames, torch.Tensor) else frames
        if t.dtype != torch.uint8:
            raise ValueError(f"frames must be uint8, got {t.dtype}")
        if t.ndim == 2:
            t = t[None]
        if tuple(t.shape[1:]) != (self.H, self.W):
            raise ValueError(f"frames of shape {tuple(t.shape)} do not match "
                             f"the detector's {(self.H, self.W)}")
        return t.contiguous()

    def put(self, frames) -> torch.Tensor:
        """[B, H, W] (or [H, W]) uint8 -> a [B, H, W] tensor on the
        detector's device."""
        return self.frames(frames).to(self.device)

    def program(self, B: int, cap: int):
        """The pipeline for ``B`` frames at ``cap`` survivor slots as a
        ``runtime.program.Program`` (JAX's ``_jit_pipeline``): a CUDA graph
        on the card, in float32 or float64, and the eager function on the
        CPU.  The detector
        keeps one program: another batch size or cap releases the old one
        once its replays are done, so that one graph's pool at a time
        holds memory."""
        # imported here: the runtime package imports this module
        from ..runtime.program import Program
        p = self._program
        if p is not None and p.key == (B, cap):
            return p
        self._program = None
        if p is not None:
            p.release()
        names = ("packed", "packed_roc") if self.output_levels \
            else ("packed",)
        self._program = Program(
            functools.partial(self._detect_device, cap=cap),
            (B, self.H, self.W), self.device,
            graph=self.device.type == "cuda", readback=names, key=(B, cap),
            slot=self.slot)
        return self._program

    def _on(self, device, slot: int = 0) -> "PyramidDetector":
        """This detector at a mesh position: the same plan, tables and
        knobs, its tensors on ``device`` and its program on the stream of
        position ``slot``; made once a (device, slot), and itself at its
        own.  Its ``cap`` is the caller's to keep."""
        # imported here: the runtime package imports this module
        from ..runtime.program import indexed
        device = indexed(device)
        key = (device, slot)
        if key == (indexed(self.device), self.slot):
            return self
        twin = self._twins.get(key)
        if twin is None:
            twin = copy.copy(self)
            twin.device, twin.slot = device, slot
            twin._program, twin._twins = None, {}
            if self.n_levels:
                twin._visit = self._visit.to(device)
                twin._resize = {i: ResizePlan(*(t.to(device) for t in p))
                                for i, p in self._resize.items()}
                if self.strategy == "direct":
                    twin._stencils = tuple(None if m is None else
                                           m.to(device)
                                           for m in self._stencils)
            self._twins[key] = twin
        return twin

    def readback(self, res, cap: int) -> List[Tuple[np.ndarray, bool]]:
        """(candidates, overflow) per frame from a run: a program's
        ``Handle`` (its packed output, read from the pinned slot) or an
        eager output dict.  A frame that accepted more than ``ACCEPT_CAP``
        windows needs the full arrays (pyramid.py:1239-1243): an eager dict
        holds them; a handle's batch runs again eagerly, since a later
        replay may have overwritten the graph's."""
        if isinstance(res, dict):
            return self.unpack(res["packed"].cpu().numpy(), cap, lambda: res)
        return self.unpack(res.program.read(res)["packed"], cap,
                           lambda: self._detect_device(self.put(res.frames),
                                                       cap))

    def unpack(self, packed: np.ndarray, cap: int, full,
               ) -> List[Tuple[np.ndarray, bool]]:
        """(candidates, overflow) per frame from the packed readback;
        ``full()`` gives the outputs with ``surv_idx`` and ``ok`` for a
        frame that accepted more than the packed array holds."""
        acap = (packed.shape[1] - 2) // 2
        host = None
        out = []
        with span("host.unpack"):
            for b, p in enumerate(packed):
                overflow = bool(p[0] > cap)
                n_acc = int(p[1])
                if n_acc <= acap:
                    ay, ax = p[2:2 + n_acc], p[2 + acap:2 + acap + n_acc]
                else:
                    if host is None:
                        trace.count("host.full_reruns")
                        dev = full()
                        host = (dev["surv_idx"].cpu().numpy(),
                                dev["ok"].cpu().numpy())
                    flat = host[0][b][host[1][b]]
                    ay, ax = flat // self.wv, flat % self.wv
                cand = (self.plan.boxes_for(ay, ax) if len(ay)
                        else np.zeros((0, 4), np.int32))
                out.append((cand, overflow))
        return out

    def walk_cap(self, cap: int) -> Optional[int]:
        """``cap`` where the survivor tail is the walk, else None: an
        entry of ``served``'s ``walk_caps``."""
        return cap if self.walk_tail else None

    def run_regrow(self, frames: torch.Tensor,
                   ) -> List[Tuple[np.ndarray, bool]]:
        """(candidates, overflow) per frame of a [B, H, W] batch, through
        the program at the current cap; the cap grows 4x and the batch
        runs again while a frame overflows it."""
        B = frames.shape[0]
        while True:
            h = self.program(B, self.cap).run(frames)
            res = self.readback(h, self.cap)
            if not any(o for _, o in res) or self.cap >= self.n_visit:
                served(B, [h.host["packed"]], [self.walk_cap(self.cap)])
                return res
            trace.count("cap.regrowths")
            self.cap = min(self.cap * 4, self.n_visit)

    # ------------------------------------------------------------------
    def candidates(self, gray) -> Tuple[np.ndarray, bool]:
        """Raw candidates (x, y, w, h) in original-image coordinates and
        whether the survivor cap overflowed."""
        if self.n_levels == 0:
            return np.zeros((0, 4), np.int32), False
        frames = self.frames(gray)
        if frames.shape[0] != 1:
            raise ValueError("candidates takes one frame; batch with "
                             "BatchedPyramidDetector")
        return self.run_regrow(frames)[0]

    def candidates_with_levels(self, gray):
        """(boxes, reject_levels, level_weights, overflow): the ROC output
        of one frame (tempcv.cpp:1084-1095), with the survivor cap regrown
        as in ``candidates``; needs ``output_levels=True``.  ONE packed
        readback; when more than ``ACCEPT_CAP`` windows qualify the frame
        runs again eagerly for the full arrays (pyramid.py:1246-1285)."""
        if not self.output_levels:
            raise ValueError("build the detector with output_levels=True")
        empty = (np.zeros((0, 4), np.int32), np.zeros(0, np.int32),
                 np.zeros(0, np.float64))
        if self.n_levels == 0:
            return empty + (False,)
        frames = self.frames(gray)
        if frames.shape[0] != 1:
            raise ValueError("candidates_with_levels takes one frame")

        def roc():
            h = self.program(1, self.cap).run(frames)
            return h.program.read(h)

        out = roc()
        while out["packed_roc"][0, 0] > self.cap and self.cap < self.n_visit:
            trace.count("cap.regrowths")
            self.cap = min(self.cap * 4, self.n_visit)
            out = roc()
        served(1, [out["packed"]], [self.walk_cap(self.cap)])
        pr = out["packed_roc"][0]
        overflow = bool(pr[0] > self.cap)
        acap = (len(pr) - 2) // 4
        n_roc = int(pr[1])
        if n_roc == 0:
            return empty + (overflow,)
        if n_roc <= acap:
            ay = pr[2:2 + n_roc].astype(np.int64)
            ax = pr[2 + acap:2 + acap + n_roc].astype(np.int64)
            lvl = pr[2 + 2 * acap:2 + 2 * acap + n_roc].astype(np.int32)
            wgt = pr[2 + 3 * acap:2 + 3 * acap + n_roc].astype(np.float64)
        else:
            trace.count("host.full_reruns")
            dev = self._detect_device(self.put(frames), self.cap)
            ok = dev["ok_roc"][0].cpu().numpy()
            flat = dev["surv_idx"][0].cpu().numpy()[ok].astype(np.int64)
            rows = dev["rows"][0].cpu().numpy()[ok]
            ay, ax = flat // self.wv, flat % self.wv
            lvl = rows[:, 2].astype(np.int32)
            wgt = rows[:, 3].astype(np.float64)
        return self.plan.boxes_for(ay, ax), lvl, wgt, overflow

    def detect(self, gray, min_neighbors: int = 3) -> DetectionResult:
        cand, overflow = self.candidates(gray)
        with span("host.group"):
            return grouped([finish(cand, overflow, min_neighbors)])[0]

    def stage_entering_counts(self, gray) -> np.ndarray:
        """The visited windows ENTERING each stage under scalar per-stage
        early exit, then the final accepts: int64 ``[n_stages + 1]`` (JAX
        ``pyramid.py:607-642``).  The per-scene work profile of the
        reference's CPU evaluator (tempcv.cpp:919-948: stage s runs only
        where stages 0..s-1 passed), which ``utils.flops.
        scalar_floor_flops`` counts.

        The windows entering stage k are the front's survivors at depth
        k.  On the card the front kernel runs at every depth k = 1..
        n_stages over one set of integral planes (float32: the kernel's
        type), each mask summed on the card and the counts read back once;
        on the CPU the plain front's masks, each stage once.  Stage-tree
        cascades raise ``ValueError``: a window may fail a stage and pass
        through a sibling subtree, so no stage is entered by a prefix."""
        if self.is_tree:
            raise ValueError("scalar early-exit counts are undefined for "
                             "stage-tree cascades")
        S = self.n_stages
        if self.n_levels == 0:
            return np.zeros(S + 1, np.int64)
        frames = self.put(gray)
        if frames.shape[0] != 1:
            raise ValueError("stage_entering_counts takes one frame")
        ii = self._prep_planes(frames)
        if self.device.type == "cuda":
            if self.dtype != torch.float32:
                raise NotImplementedError(
                    "the front kernel runs in float32 only: build the "
                    "detector in float32 for its counts on the card")
            masks = (haar_front(ii.sum, ii.sq_hi, ii.sq_lo, self._visit,
                                self.table, k, self.dtype, ii.tilted)[0]
                     for k in range(1, S + 1))
        else:
            vnf = vnf_plain(ii.sum, ii.sq_hi, ii.sq_lo, self.table,
                            self.hv, self.wv, self.dtype)
            masks = front_masks_plain(ii.sum, self._visit, self.table, S,
                                      vnf, ii.tilted)
        counts = [self._visit.sum(dtype=torch.int64)]
        counts += [m.sum(dtype=torch.int64) for m in masks]
        return torch.stack(counts).cpu().numpy()


def finish(cand: np.ndarray, overflow: bool,
           min_neighbors: int) -> DetectionResult:
    """Group one frame's candidates into a ``DetectionResult``."""
    if min_neighbors != 0:
        boxes, neigh = group_rectangles(cand, max(min_neighbors, 1), eps=0.2)
    else:
        boxes, neigh = cand, np.ones(len(cand), np.int32)
    return DetectionResult(boxes=boxes, neighbors=neigh, candidates=cand,
                           survivor_overflow=overflow)
