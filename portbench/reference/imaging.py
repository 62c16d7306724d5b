"""The pyramid's images: OpenCV 2.4's fixed-point bilinear resize and the
integral images, in plain PyTorch on any device.

``resize_u8`` is ``cvResize(INTER_LINEAR)`` on uint8 (imgproc's
``resizeGeneric_`` with ``HResizeLinear`` and ``VResizeLinear<uchar>``):
source coordinate ``(d + 0.5) * scale - 0.5``, clamped at the borders,
weights rounded to 11 fraction bits in float32, the horizontal pass in
int32, then ``>> 4``, ``* w >> 16`` and ``(v + 2) >> 2``.

``integrals`` gives ``cv2.integral3``'s planes as exact numbers: the sum
(int64), the squared sum (float64, whole numbers below 2**53) and the
45-degree tilted sum (int64), each (..., H + 1, W + 1) with a zero first
row and column.  The tilted plane follows OpenCV's recurrence one row at a
time:

    U(y, x) = U(y-1, x+1) + p(y-1, x-1) + p(y-2, x-1)
    T(y, x) = T(y-1, x-1) + U(y, x),     T(y, 0) = T(y-1, 1)

over rows padded on the right by H, so that the leftward carries never
reach the edge.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["resize_u8", "integrals"]

_COEF_SCALE = 2048


def _axis(src: int, dst: int):
    scale = np.float64(src) / dst
    fd = (np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5
    s = np.floor(fd).astype(np.int64)
    f = (fd - s).astype(np.float32)
    f = np.where(s < 0, np.float32(0), f)
    s = np.maximum(s, 0)
    f = np.where(s >= src - 1, np.float32(1), f)
    s = np.minimum(s, max(src - 2, 0))
    c0 = np.rint((np.float32(1) - f) * np.float32(_COEF_SCALE))
    c1 = np.rint(f * np.float32(_COEF_SCALE))
    return s, np.minimum(s + 1, src - 1), c0.astype(np.int64), \
        c1.astype(np.int64)


def resize_u8(img: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """uint8 (..., H, W) -> uint8 (..., h2, w2)."""
    h, w = img.shape[-2:]
    h2, w2 = out_hw
    dev = img.device
    x0, x1, cx0, cx1 = (torch.from_numpy(a).to(dev) for a in _axis(w, w2))
    y0, y1, cy0, cy1 = (torch.from_numpy(a).to(dev) for a in _axis(h, h2))
    a = img.to(torch.int64)
    t = a.index_select(-1, x0) * cx0 + a.index_select(-1, x1) * cx1
    r0 = t.index_select(-2, y0) >> 4
    r1 = t.index_select(-2, y1) >> 4
    v = ((cy0[:, None] * r0) >> 16) + ((cy1[:, None] * r1) >> 16)
    return ((v + 2) >> 2).clamp(0, 255).to(torch.uint8)


def _integral(p: torch.Tensor) -> torch.Tensor:
    return F.pad(p.cumsum(-1).cumsum(-2), (1, 0, 1, 0))


def _tilted(p: torch.Tensor) -> torch.Tensor:
    """p: int64 (B, H, W) -> int64 (B, H + 1, W + 1)."""
    B, H, W = p.shape
    P = W + H + 2
    rows = F.pad(p, (1, P - W - 1))       # rows[:, y, x] = p(y, x - 1)
    zero = torch.zeros((B, 1), dtype=p.dtype, device=p.device)
    U = torch.zeros((B, P), dtype=p.dtype, device=p.device)
    T = torch.zeros((B, P), dtype=p.dtype, device=p.device)
    out = [T[:, :W + 1]]
    for y in range(1, H + 1):
        U = torch.cat([U[:, 1:], zero], 1) + rows[:, y - 1]
        if y >= 2:
            U = U + rows[:, y - 2]
        Tn = torch.cat([zero, T[:, :-1]], 1) + U
        Tn[:, 0] = T[:, 1]
        T = Tn
        out.append(T[:, :W + 1])
    return torch.stack(out, 1)


def integrals(gray: torch.Tensor, tilted: bool):
    """(sum int64, squared sum float64, tilted int64 or None) of uint8
    (B, H, W)."""
    p = gray.to(torch.int64)
    s = _integral(p)
    sq = _integral(p * p).to(torch.float64)
    return s, sq, (_tilted(p) if tilted else None)
