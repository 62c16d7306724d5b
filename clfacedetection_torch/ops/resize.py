"""Bilinear uint8 resize with OpenCV 2.4 fixed-point semantics (torch).

Port of ``clfacedetection_tpu/ops/resize.py``: INTER_RESIZE_COEF_BITS =
11 and the ``>>4 / >>16 / +2>>2`` cast chain of the uchar
``VResizeLinear``, in int32 arithmetic, so the result is bit-equal to
the JAX and numpy versions.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

__all__ = ["resize_coeffs", "ResizePlan", "resize_plan",
           "resize_bilinear_u8", "resize_bilinear_u8_np"]

COEF_BITS = 11
COEF_SCALE = 1 << COEF_BITS  # 2048


def resize_coeffs(src: int, dst: int) -> Tuple[np.ndarray, np.ndarray,
                                               np.ndarray]:
    """Source index + 2-tap fixed-point weights for one axis:
    fx = (dx+0.5)*scale - 0.5 with border clamping, coefficients
    cvRound(f * 2048) computed in float32."""
    scale = np.float64(src) / dst
    d = np.arange(dst, dtype=np.float64)
    fd = (d + 0.5) * scale - 0.5
    s = np.floor(fd).astype(np.int64)
    f = (fd - s).astype(np.float32)
    f = np.where(s < 0, np.float32(0), f)
    s = np.maximum(s, 0)
    f = np.where(s >= src - 1, np.float32(1), f)
    s = np.minimum(s, max(src - 2, 0))
    c0 = np.rint((np.float32(1) - f) * np.float32(COEF_SCALE)).astype(np.int32)
    c1 = np.rint(f * np.float32(COEF_SCALE)).astype(np.int32)
    return s.astype(np.int32), c0, c1


def resize_bilinear_u8_np(img: np.ndarray, out_hw: Tuple[int, int]
                          ) -> np.ndarray:
    """Numpy twin of ``resize_bilinear_u8`` (bit-equal), for the golden
    path's scale-image mode."""
    h2, w2 = out_hw
    h, w = img.shape[-2:]
    sx, cx0, cx1 = resize_coeffs(w, w2)
    sy, cy0, cy1 = resize_coeffs(h, h2)
    a = img.astype(np.int32)
    t = a[..., :, sx] * cx0 + a[..., :, np.minimum(sx + 1, w - 1)] * cx1
    r0 = t[..., sy, :] >> 4
    r1 = t[..., np.minimum(sy + 1, h - 1), :] >> 4
    val = ((cy0[:, None] * r0) >> 16) + ((cy1[:, None] * r1) >> 16)
    return np.clip((val + 2) >> 2, 0, 255).astype(np.uint8)


class ResizePlan(NamedTuple):
    """Gather indices and coefficients of one (src -> dst) resize, on the
    device that runs it (built once, so a frame's resize copies nothing
    from the host)."""

    sx0: torch.Tensor   # int64 [w2]
    sx1: torch.Tensor   # int64 [w2]
    cx0: torch.Tensor   # int32 [w2]
    cx1: torch.Tensor   # int32 [w2]
    sy0: torch.Tensor   # int64 [h2]
    sy1: torch.Tensor   # int64 [h2]
    cy0: torch.Tensor   # int32 [h2, 1]
    cy1: torch.Tensor   # int32 [h2, 1]


def resize_plan(src_hw: Tuple[int, int], out_hw: Tuple[int, int],
                device) -> ResizePlan:
    h, w = src_hw
    h2, w2 = out_hw
    sx, cx0, cx1 = resize_coeffs(w, w2)
    sy, cy0, cy1 = resize_coeffs(h, h2)

    def t(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    return ResizePlan(
        t(sx, torch.int64), t(np.minimum(sx + 1, w - 1), torch.int64),
        t(cx0, torch.int32), t(cx1, torch.int32),
        t(sy, torch.int64), t(np.minimum(sy + 1, h - 1), torch.int64),
        t(cy0[:, None], torch.int32), t(cy1[:, None], torch.int32))


def resize_bilinear_u8(img: torch.Tensor, out_hw: Tuple[int, int],
                       plan: Optional[ResizePlan] = None) -> torch.Tensor:
    """Resize uint8 (..., H, W) to (..., h2, w2)."""
    if plan is None:
        plan = resize_plan(tuple(img.shape[-2:]), out_hw, img.device)
    a = img.to(torch.int32)
    t = (a.index_select(-1, plan.sx0) * plan.cx0
         + a.index_select(-1, plan.sx1) * plan.cx1)
    r0 = t.index_select(-2, plan.sy0) >> 4
    r1 = t.index_select(-2, plan.sy1) >> 4
    val = ((plan.cy0 * r0) >> 16) + ((plan.cy1 * r1) >> 16)
    return ((val + 2) >> 2).clamp_(0, 255).to(torch.uint8)
