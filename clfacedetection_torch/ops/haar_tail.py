"""v1 survivor tail, every node's value: CUDA kernel and its plain twin.

Port of the TPU kernel ``clfacedetection_tpu/ops/haar_tail.py``
(``build_tail_kernel``): for every survivor slot (a flat canvas index, or
a pad value outside ``[0, Hv*Wv)``) the value of every node of the
cascade, float32 ``[B, cap, n_clf * T]``, node ``(c, t)`` in column
``c * T + t``.  Nodes a classifier does not have, and pad slots, are 0.
Votes, CART walks, stage sums and path masks run on this output in a
second kernel (``ops/tail_rows.py``), where the JAX package runs them in
XLA.

Node values use the front's numerics (``haar_front``): each rect is the
int32 difference of its four corners in the ``sum`` or ``tilted`` plane,
cast to float32, times its weight, summed in rect order.  The JAX tails
take node values from an f32 matrix product of corrected patches with a
stencil, so they agree with this twin to f32 rounding, and on tilted
nodes to the corner-only correction's ~2 bits (``pyramid.py:676-686``).
``haar_tail`` runs ``csrc/haar_tail.cu`` on a CUDA tensor and
``tail_values_plain`` on a CPU tensor; the two are bit-equal.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import kernels
from .cascade_table import CascadeTable

__all__ = ["haar_tail", "tail_values_plain", "patch_shape"]

# int32 elements of one gathered corner chunk [B, cap, nodes, 3, 4]
_CHUNK_ELEMS = 1 << 26


def patch_shape(table: CascadeTable):
    """(rows, cols) of the window patch that holds every corner."""
    return table.max_dy + 1, table.max_dx + 1


def tail_values_plain(sum_: torch.Tensor, tilted: Optional[torch.Tensor],
                      surv_idx: torch.Tensor, hv: int, wv: int,
                      table: CascadeTable,
                      dtype=torch.float32) -> torch.Tensor:
    """[B, cap, n_clf * T] node values in ``dtype``, chunked over nodes so
    that the gathered corners stay under ``_CHUNK_ELEMS`` elements."""
    B, cap = surv_idx.shape
    wp = sum_.shape[2]
    dev = sum_.device
    n = hv * wv
    ph, pw = patch_shape(table)
    valid = (surv_idx >= 0) & (surv_idx < n)
    idx = torch.where(valid, surv_idx, 0).long()
    y = torch.div(idx, wv, rounding_mode="floor")
    base = y * wp + (idx - y * wv)                       # [B, cap]
    dy, dx = np.meshgrid(np.arange(ph), np.arange(pw), indexing="ij")
    off = torch.from_numpy((dy * wp + dx).reshape(-1)).to(dev)
    gidx = (base[:, :, None] + off).reshape(B, -1)
    patch = [sum_.reshape(B, -1).gather(1, gidx).reshape(B, cap, -1)]
    if table.has_tilted:
        patch.append(tilted.reshape(B, -1).gather(1, gidx).reshape(B, cap,
                                                                   -1))
    # [B, planes*P, cap]: selecting patch columns copies whole rows
    patch = torch.cat(patch, dim=2).transpose(1, 2).contiguous()
    T = table.T
    nn = table.n_clf * T
    # patch column of every corner of every rect of every node
    cor = table.corners.reshape(nn, 3, 4, 2).astype(np.int64)
    col = cor[..., 0] * pw + cor[..., 1] \
        + table.tilted.reshape(nn, 1, 1) * (ph * pw)     # [nn, 3, 4]
    w = table.weights.reshape(nn, 3)
    nr = table.n_rects.reshape(nn)
    out = torch.empty((B, cap, nn), dtype=dtype, device=dev)
    step = max(1, _CHUNK_ELEMS // max(1, B * cap * 12))
    for a in range(0, nn, step):
        b = min(nn, a + step)
        m = b - a
        c = torch.from_numpy(col[a:b].reshape(-1)).to(dev)
        v = patch.index_select(1, c).reshape(B, m, 3, 4, cap)
        rs = (v[:, :, :, 0] - v[:, :, :, 1] - v[:, :, :, 2]
              + v[:, :, :, 3]).to(dtype)                 # [B, m, 3, cap]
        terms = rs * torch.from_numpy(w[a:b]).to(dev, dtype)[..., None]
        has = torch.from_numpy(nr[a:b]).to(dev)[:, None]
        nv = terms[:, :, 0]
        for k in (1, 2):
            nv = torch.where(has > k, nv + terms[:, :, k], nv)
        out[:, :, a:b] = torch.where(valid[:, None], nv, 0.0).transpose(1, 2)
    return out


def haar_tail(sum_: torch.Tensor, tilted: Optional[torch.Tensor],
              surv_idx: torch.Tensor, hv: int, wv: int,
              table: CascadeTable, dtype=torch.float32) -> torch.Tensor:
    """Node values for survivor slots ``surv_idx`` (int32 [B, cap]) on the
    [B, Hp, Wp] ``sum`` (and ``tilted``) planes of an ``hv`` x ``wv``
    visit grid.  CPU tensors run ``tail_values_plain``; CUDA tensors
    launch the kernel (float32 only)."""
    planes = (sum_,) + ((tilted,) if table.has_tilted else ())
    if table.has_tilted and tilted is None:
        raise ValueError("the cascade has tilted features: pass the tilted "
                         "plane")
    if any(p.dtype != torch.int32 or p.ndim != 3 or not p.is_contiguous()
           or p.shape != sum_.shape or p.device != sum_.device
           for p in planes):
        raise ValueError("planes must be contiguous int32 [B, Hp, Wp] "
                         "tensors of one shape on one device")
    if surv_idx.dtype != torch.int32 or surv_idx.ndim != 2 \
            or not surv_idx.is_contiguous() \
            or surv_idx.shape[0] != sum_.shape[0] \
            or surv_idx.device != sum_.device:
        raise ValueError("surv_idx must be a contiguous int32 [B, cap] "
                         "tensor on the planes' device")
    B, hp, wp = sum_.shape
    if hp < hv + table.max_dy or wp < wv + table.max_dx:
        raise ValueError(f"planes {hp}x{wp} too small for a {hv}x{wv} "
                         f"grid plus the window")
    if sum_.device.type == "cpu":
        return tail_values_plain(sum_, tilted, surv_idx, hv, wv, table,
                                 dtype)
    if sum_.device.type != "cuda":
        raise ValueError(f"unsupported device {sum_.device}")
    if dtype != torch.float32:
        raise NotImplementedError("the CUDA tail runs in float32 only")
    cap = surv_idx.shape[1]
    ph, pw = patch_shape(table)
    nn = table.n_clf * table.T
    out = torch.empty((B, cap, nn), dtype=torch.float32, device=sum_.device)
    tab = table.device_buffer(sum_.device, nodes=True)
    with torch.cuda.device(sum_.device):
        err = kernels.lib().clfd_haar_tail(
            sum_.data_ptr(), tilted.data_ptr() if table.has_tilted else None,
            surv_idx.data_ptr(), tab.data_ptr(), out.data_ptr(), B, hv, wv, hp,
            wp, cap, nn, ph, pw,
            torch.cuda.current_stream(sum_.device).cuda_stream)
    kernels.check("clfd_haar_tail", err)
    kernels.count(haar_tail)
    return out


haar_tail.launches = 0
