"""Dense front-stage Haar evaluation: CUDA kernel and its plain twin.

Port of the TPU kernel ``clfacedetection_tpu/ops/haar_front.py``
(``build_front_kernel``) and of its XLA specification
``PyramidDetector._front_from_planes`` / ``_front_maps``
(``pyramid.py:556-605,1015-1043``).  For every canvas position: the
variance factor ``vnf`` over the ``equ`` rect, then stages
``0..front_k-1`` (CART walks on ``node < thr * vnf``, sequential stage
sums, ``>= stage_thr``), ANDed with the static visit lattice.  Tilted
nodes read the RSAT plane.

``haar_front`` runs ``csrc/haar_front.cu`` on a CUDA tensor and
``front_plain`` on a CPU tensor.  ``front_plain`` is the specification:
the same float32 operation order as the JAX XLA path, so the mask and
``vnf`` are bit-equal to JAX's and to the kernel's.

The kernel gives each block of 8 warps a 64x128 tile and runs each stage
over the tile's live positions only, with the planes and the front
stages' table in shared memory; ``front_launch`` decides, once per table
and depth, whether the table fits there.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from .. import kernels
from .cascade_table import STAGE_WORDS, STUMP_WORDS, CascadeTable

__all__ = ["haar_front", "front_plain", "front_votes_plain", "vnf_plain",
           "variance_factor", "front_table_words", "front_smem_bytes",
           "front_launch"]

# csrc/haar_front.cu: a block of 8 warps owns BLOCK_Y x BLOCK_X positions;
# its shared memory holds row masks and two lists of uint16 positions,
# then the staged table, then the plane tiles with their window halo
BLOCK_Y, BLOCK_X = 64, 128
LIST_SMEM = BLOCK_Y * 4 * 4 + 2 * BLOCK_Y * BLOCK_X * 2
MAX_SMEM = 232448          # shared memory a block may take on the H100


def front_table_words(table: CascadeTable, front_k: int,
                      stump_view: bool) -> int:
    """Words of the table that the front reads: every stage record, then
    the classifiers up to the last one of stages ``0..front_k-1`` (in the
    stump view or the packed records).  A multiple of four, so the kernel
    stages it in 16-byte copies."""
    n = max((int(table.stage_clf0[s] + table.stage_cnt[s])
             for s in range(front_k)), default=0)
    stride = STUMP_WORDS if stump_view else table.clf_words
    return table.n_stages * STAGE_WORDS + n * stride


def front_smem_bytes(table: CascadeTable, table_words: int) -> int:
    """Dynamic shared memory of one block of the kernel with
    ``table_words`` of the table staged (its launch computes the same)."""
    pitch = (BLOCK_X + table.max_dx) | 1
    planes = 2 if table.has_tilted else 1
    return LIST_SMEM + table_words * 4 \
        + planes * (BLOCK_Y + table.max_dy) * pitch * 4


def front_launch(table: CascadeTable, front_k: int) -> int:
    """Words of the table that the kernel stages in shared memory: the
    front's part of the stump view where the cascade has one, else of the
    packed table; 0 where it does not fit beside the planes, and the
    kernel reads the table through L1.  Worked out once per table and
    ``front_k``."""
    words = table.front_words.get(front_k)
    if words is None:
        words = front_table_words(table, front_k, table.stumps is not None)
        if front_smem_bytes(table, words) > MAX_SMEM:
            words = 0
        table.front_words[front_k] = words
    return words


def _rect(p: torch.Tensor, ya: int, xa: int, yb: int, xb: int,
          hv: int, wv: int) -> torch.Tensor:
    """Rect sum at every position from four shifted slices (int32)."""
    return (p[:, ya:ya + hv, xa:xa + wv] - p[:, ya:ya + hv, xb:xb + wv]
            - p[:, yb:yb + hv, xa:xa + wv] + p[:, yb:yb + hv, xb:xb + wv])


def variance_factor(win_sum: torch.Tensor, sq_hi: torch.Tensor,
                    sq_lo: torch.Tensor, inv_area: float,
                    dtype=torch.float32) -> torch.Tensor:
    """The variance factor from the int32 window sums of the ``sum``,
    ``sq_hi`` and ``sq_lo`` planes over the variance rect.

    float32: ``var = fma(win_sq, inv, -(mean*mean))`` rounded once, which
    is what XLA:CPU computes for ``win_sq*inv - mean*mean``.  The fma is
    emulated in float64, where the product of two float32 values is
    exact; the second rounding to float32 could in principle differ from
    a true fma on a rounding tie.  float64: separately rounded, with the
    unrounded ``inv_area`` (the JAX f64 path's constant)."""
    win_sum = win_sum.to(dtype)
    win_sq = sq_hi.to(dtype) * 256.0 + sq_lo.to(dtype)
    if dtype == torch.float32:
        inv = float(np.float32(inv_area))
        mean = win_sum * inv
        var = (win_sq.double() * inv - (mean * mean).double()).float()
        # torch.sqrt on float32 CPU tensors is not correctly rounded (it
        # differs from IEEE sqrt in ~0.7% of values); in float64 then
        # rounded to float32 it is, like the kernel's __fsqrt_rn
        root = torch.sqrt(var.double().clamp(min=0)).float()
    else:
        mean = win_sum * inv_area
        var = win_sq * inv_area - mean * mean
        root = torch.sqrt(var.clamp(min=0))
    return torch.where(var >= 0, root, torch.ones_like(var))


def vnf_plain(sum_: torch.Tensor, sq_hi: torch.Tensor, sq_lo: torch.Tensor,
              table: CascadeTable, hv: int, wv: int,
              dtype=torch.float32) -> torch.Tensor:
    """Variance factor map [B, hv, wv] (``variance_factor`` at every
    position)."""
    ya, xa, yb, xb = table.equ
    return variance_factor(_rect(sum_, ya, xa, yb, xb, hv, wv),
                           _rect(sq_hi, ya, xa, yb, xb, hv, wv),
                           _rect(sq_lo, ya, xa, yb, xb, hv, wv),
                           table.inv_area, dtype)


def _corner_sum(p: torch.Tensor, corners: np.ndarray, hv: int,
                wv: int) -> torch.Tensor:
    """Rect sum at every position from its four generic (y, x) corners,
    signs + - - + (int32; exact for upright and tilted rects)."""
    (y0, x0), (y1, x1), (y2, x2), (y3, x3) = (map(int, c) for c in corners)
    return (p[:, y0:y0 + hv, x0:x0 + wv] - p[:, y1:y1 + hv, x1:x1 + wv]
            - p[:, y2:y2 + hv, x2:x2 + wv] + p[:, y3:y3 + hv, x3:x3 + wv])


def _clf_vote_dense(planes, table: CascadeTable, clf: int,
                    vnf: torch.Tensor, hv: int, wv: int) -> torch.Tensor:
    """A classifier's vote at every position (``_front_maps``,
    pyramid.py:568-595): node values in rect order, ``cond = node <
    thr * vnf``, and the walk from node 0 to the reached leaf's alpha."""
    dtype = vnf.dtype

    def node_value(t):
        p = planes[1] if table.tilted[clf, t] else planes[0]
        nv = None
        for k in range(int(table.n_rects[clf, t])):
            rs = _corner_sum(p, table.corners[clf, t, k], hv, wv).to(dtype)
            term = rs * float(table.weights[clf, t, k])
            nv = term if nv is None else nv + term
        return nv if nv is not None else torch.zeros_like(vnf)

    nvals = [node_value(t) for t in range(int(table.clf_nodes[clf]))]

    def walk(t):
        cond = nvals[t] < float(table.thr[clf, t]) * vnf

        def branch(link):
            if link <= 0:
                return torch.full_like(vnf, float(table.alpha[clf, -link]))
            return walk(int(link))

        return torch.where(cond, branch(int(table.left[clf, t])),
                           branch(int(table.right[clf, t])))

    return walk(0)


def _stage_sum_dense(planes, table: CascadeTable, st: int,
                     vnf: torch.Tensor, hv: int, wv: int) -> torch.Tensor:
    """Stage sum at every position: a sequential sum of the classifiers'
    votes in classifier order from 0 (pyramid.py:597-605)."""
    c0, cnt = int(table.stage_clf0[st]), int(table.stage_cnt[st])
    ssum = torch.zeros_like(vnf)
    for clf in range(c0, c0 + cnt):
        ssum = ssum + _clf_vote_dense(planes, table, clf, vnf, hv, wv)
    return ssum


def front_plain(sum_: torch.Tensor, sq_hi: torch.Tensor,
                sq_lo: torch.Tensor, visit: torch.Tensor, table: CascadeTable,
                front_k: int, dtype=torch.float32,
                tilted: Optional[torch.Tensor] = None):
    """(front bool [B, Hv, Wv], vnf [B, Hv, Wv]) from padded planes
    [B, Hp, Wp]; ``visit`` is the [Hv, Wv] scan lattice and ``tilted`` the
    RSAT plane (needed when a node is tilted)."""
    hv, wv = visit.shape
    vnf = vnf_plain(sum_, sq_hi, sq_lo, table, hv, wv, dtype)
    return front_votes_plain(sum_, visit, table, front_k, vnf, tilted), vnf


def front_votes_plain(sum_: torch.Tensor, visit: torch.Tensor,
                      table: CascadeTable, front_k: int, vnf: torch.Tensor,
                      tilted: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The front mask for a given vnf map: visit AND stages 0..front_k-1."""
    hv, wv = visit.shape
    front = visit.unsqueeze(0).expand(sum_.shape[0], hv, wv).clone()
    for st in range(front_k):
        ssum = _stage_sum_dense((sum_, tilted), table, st, vnf, hv, wv)
        front &= ssum >= float(table.stage_thr[st])
    return front


def haar_front(sum_: torch.Tensor, sq_hi: torch.Tensor, sq_lo: torch.Tensor,
               visit: torch.Tensor, table: CascadeTable, front_k: int,
               dtype=torch.float32, tilted: Optional[torch.Tensor] = None):
    """Front mask and vnf map.  CPU tensors run ``front_plain``; CUDA
    tensors launch the kernel (float32 only).  ``tilted`` is the RSAT
    plane, required when the table has a tilted node."""
    if table.has_tilted and tilted is None:
        raise ValueError("the cascade has tilted features: pass the tilted "
                         "plane")
    planes = (sum_, sq_hi, sq_lo) + ((tilted,) if tilted is not None else ())
    if any(p.dtype != torch.int32 or p.ndim != 3 or not p.is_contiguous()
           or p.shape != sum_.shape or p.device != sum_.device
           for p in planes):
        raise ValueError("planes must be contiguous int32 [B, Hp, Wp] "
                         "tensors of one shape on one device")
    if visit.dtype != torch.bool or visit.ndim != 2 \
            or not visit.is_contiguous() or visit.device != sum_.device:
        raise ValueError("visit must be a contiguous bool [Hv, Wv] tensor "
                         "on the planes' device")
    hv, wv = visit.shape
    B, hp, wp = sum_.shape
    if hp < hv + table.max_dy or wp < wv + table.max_dx:
        raise ValueError(f"planes {hp}x{wp} too small for a {hv}x{wv} "
                         f"grid plus the window")
    if not 0 <= front_k <= table.n_stages:
        raise ValueError(f"front_k {front_k} outside [0, {table.n_stages}]")
    if sum_.device.type == "cpu":
        return front_plain(sum_, sq_hi, sq_lo, visit, table, front_k, dtype,
                           tilted)
    if sum_.device.type != "cuda":
        raise ValueError(f"unsupported device {sum_.device}")
    if dtype != torch.float32:
        raise NotImplementedError("the CUDA front runs in float32 only")
    front = torch.empty((B, hv, wv), dtype=torch.bool, device=sum_.device)
    vnf = torch.empty((B, hv, wv), dtype=torch.float32, device=sum_.device)
    stump = table.stumps is not None
    words = front_launch(table, front_k)
    tab = table.device_buffer(sum_.device, stumps=stump)
    ya, xa, yb, xb = table.equ
    # the kernel stages the tilted plane when it gets one, as
    # front_smem_bytes counts it: only for a cascade with tilted nodes
    with torch.cuda.device(sum_.device):
        err = kernels.lib().clfd_haar_front(
            sum_.data_ptr(), sq_hi.data_ptr(), sq_lo.data_ptr(),
            tilted.data_ptr() if table.has_tilted else None, visit.data_ptr(),
            tab.data_ptr(), front.data_ptr(), vnf.data_ptr(),
            B, hv, wv, hp, wp, table.n_stages, front_k, words, table.max_dy,
            table.max_dx, ya, xa, yb, xb, int(stump),
            ctypes.c_float(float(np.float32(table.inv_area))),
            torch.cuda.current_stream(sum_.device).cuda_stream)
    kernels.check("clfd_haar_front", err)
    kernels.count(haar_front)
    return front, vnf


haar_front.launches = 0
