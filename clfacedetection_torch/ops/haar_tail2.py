"""Survivor tail with the cascade walk: CUDA kernel and its plain twin.

Port of the TPU kernel ``clfacedetection_tpu/ops/haar_tail2.py``
(``build_tail2_kernel``).  Per survivor slot (a flat canvas index, or the
pad value ``Hv*Wv``): walk stages ``front_k..n_stages-1`` with early exit
and return the TPU kernel's lanes 0-3 as float32 ``[B, cap, 4]``: vnf,
alive, exit stage (``n_stages`` on a pass) and the stage sum of the last
stage entered.  Pad slots give ``(0, 0, n_stages, 0)``.

Node values come straight from four corners of the ``sum`` plane, summed
in the front's order (see ``csrc/haar_tail2.cu`` for why that order and
how it relates to the JAX tails' matrix product).  ``tail2_plain`` is the
specification and matches the kernel bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from .cascade_table import CascadeTable

__all__ = ["haar_tail2", "tail2_plain"]


def _stage_tensors(table: CascadeTable, st: int, wp: int, device, dtype):
    """Stage ``st``'s stumps for ``tail2_plain`` on ``device``, made once
    (``CascadeTable.cached``): the offsets of each rect's four corners in
    a plane of width ``wp`` (int64 [cnt, 3] each), then its weights
    [cnt, 3], thresholds and left and right leaves [cnt] in ``dtype``."""
    def make():
        npdt = np.float64 if dtype == torch.float64 else np.float32
        c0 = int(table.stage_clf0[st])
        sl = slice(c0, c0 + int(table.stage_cnt[st]))
        cor = table.corners[sl, 0].astype(np.int64)     # [cnt, 3, 4, 2]
        clfs = np.arange(sl.start, sl.stop)
        host = [cor[..., j, 0] * wp + cor[..., j, 1] for j in range(4)] + [
            table.weights[sl, 0].astype(npdt), table.thr[sl, 0].astype(npdt),
            # stumps: node 0 of each classifier, its leaves
            # alpha[-left/-right]
            table.alpha[clfs, -table.left[sl, 0]].astype(npdt),
            table.alpha[clfs, -table.right[sl, 0]].astype(npdt)]
        return tuple(torch.from_numpy(a).to(device) for a in host)
    return table.cached(("tail2", st, wp, dtype), device, make)


def tail2_plain(sum_: torch.Tensor, vnf: torch.Tensor, surv_idx: torch.Tensor,
                table: CascadeTable, front_k: int) -> torch.Tensor:
    """[B, cap, 4] tail rows, vectorised over survivors and a stage's
    nodes; the stage sum itself runs sequentially in classifier order.
    Its tables come from the table's cache, so a run copies nothing from
    the host once they are made."""
    B, hv, wv = vnf.shape
    wp = sum_.shape[2]
    dtype = vnf.dtype
    dev = vnf.device
    n = hv * wv
    valid = (surv_idx >= 0) & (surv_idx < n)
    idx = torch.where(valid, surv_idx, 0).long()
    y = torch.div(idx, wv, rounding_mode="floor")
    base = y * wp + (idx - y * wv)                       # [B, cap]
    flat = sum_.reshape(B, -1)
    svnf = vnf.reshape(B, -1).gather(1, idx)
    alive = valid.clone()
    level = torch.full_like(svnf, float(table.n_stages))
    weight = torch.zeros_like(svnf)
    for st in range(front_k, table.n_stages):
        *offs, w, thr, a_l, a_r = _stage_tensors(table, st, wp, dev, dtype)

        def corner(off):
            """Integral entries at one corner of every rect of the stage
            for every survivor: int32 [B, cap, cnt, 3]."""
            idx = (base[:, :, None, None] + off).reshape(B, -1)
            return flat.gather(1, idx).reshape(B, -1, *off.shape)

        rs = (corner(offs[0]) - corner(offs[1]) - corner(offs[2])
              + corner(offs[3])).to(dtype)               # [B, cap, cnt, 3]
        terms = rs * w
        nv = terms[..., 0]
        for k in range(1, 3):
            # rects past a node's count have weight 0 and corners (0, 0):
            # adding their exact 0 leaves the comparison unchanged
            nv = nv + terms[..., k]
        vote = torch.where(nv < thr * svnf[..., None], a_l, a_r)
        ssum = torch.zeros_like(svnf)
        for j in range(vote.shape[-1]):
            ssum = ssum + vote[..., j]
        weight = torch.where(alive, ssum, weight)
        fail = ~(ssum >= float(table.stage_thr[st]))
        level = torch.where(alive & fail, float(st), level)
        alive = alive & ~fail
    return torch.stack([torch.where(valid, svnf, 0.0), alive.to(dtype),
                        level, weight], dim=-1)


def haar_tail2(sum_: torch.Tensor, vnf: torch.Tensor, surv_idx: torch.Tensor,
               table: CascadeTable, front_k: int) -> torch.Tensor:
    """Tail rows for survivor slots ``surv_idx`` (int32 [B, cap]).  CPU
    tensors run ``tail2_plain``; CUDA tensors launch the kernel."""
    if sum_.dtype != torch.int32 or sum_.ndim != 3 \
            or not sum_.is_contiguous():
        raise ValueError("sum must be a contiguous int32 [B, Hp, Wp] tensor")
    if vnf.ndim != 3 or not vnf.is_contiguous() \
            or vnf.shape[0] != sum_.shape[0]:
        raise ValueError("vnf must be a contiguous [B, Hv, Wv] tensor")
    if surv_idx.dtype != torch.int32 or surv_idx.ndim != 2 \
            or not surv_idx.is_contiguous() \
            or surv_idx.shape[0] != sum_.shape[0]:
        raise ValueError("surv_idx must be a contiguous int32 [B, cap] tensor")
    if not (sum_.device == vnf.device == surv_idx.device):
        raise ValueError("tensors must share one device")
    B, hv, wv = vnf.shape
    _, hp, wp = sum_.shape
    if hp < hv + table.max_dy or wp < wv + table.max_dx:
        raise ValueError(f"sum plane {hp}x{wp} too small for a {hv}x{wv} "
                         f"grid plus the window")
    if not 0 <= front_k <= table.n_stages:
        raise ValueError(f"front_k {front_k} outside [0, {table.n_stages}]")
    if table.stumps is None:
        raise ValueError("tail2 takes stump cascades with upright features")
    if sum_.device.type == "cpu":
        return tail2_plain(sum_, vnf, surv_idx, table, front_k)
    if sum_.device.type != "cuda":
        raise ValueError(f"unsupported device {sum_.device}")
    if vnf.dtype != torch.float32:
        raise NotImplementedError("the CUDA tail runs in float32 only")
    cap = surv_idx.shape[1]
    out = torch.empty((B, cap, 4), dtype=torch.float32, device=sum_.device)
    tab = table.device_buffer(sum_.device, stumps=True)
    with kernels.on_device(sum_.device):
        err = kernels.lib().clfd_haar_tail2(
            sum_.data_ptr(), vnf.data_ptr(), surv_idx.data_ptr(),
            tab.data_ptr(), out.data_ptr(), B, hv, wv, hp, wp, cap,
            table.n_stages, front_k,
            torch.cuda.current_stream(sum_.device).cuda_stream)
    kernels.check("clfd_haar_tail2", err)
    # the slots launched beside the launches: ``survivors`` over
    # ``tail2.slots`` is the share of slots that held a window
    kernels.count(haar_tail2, {"tail2.slots": B * cap})
    return out
