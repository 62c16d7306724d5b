"""Grayscale conversion and integral images (torch).

Port of ``clfacedetection_tpu/ops/integral.py``:

* ``sum``: int32, exact (255 * 4M pixels < 2^31);
* the squared sum as two int32 planes, ``sq_hi = (p*p) >> 8`` and
  ``sq_lo = (p*p) & 0xFF``, so 4-corner window differences are exact
  integers and ``hi * 256 + lo`` is rebuilt in float only afterwards.

All planes are (..., H+1, W+1) with a zero first row and column, like
``cv2.integral``.  The tilted (RSAT) integral is not ported yet: no
cascade of the ported slice uses tilted features.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

__all__ = ["bgr_to_gray", "bgra_to_gray", "IntegralImages",
           "integral_images", "integral_2d"]

# OpenCV's 15-bit fixed-point BGR->gray coefficients (cvtColor BGR2GRAY)
_CV_SHIFT = 15
_CV_R, _CV_G, _CV_B = 9798, 19235, 3735


def bgr_to_gray(img: torch.Tensor) -> torch.Tensor:
    """uint8 BGR (..., H, W, 3) -> uint8 gray (..., H, W), bit-exact with
    ``cv2.cvtColor(BGR2GRAY)``."""
    if img.ndim < 3 or img.shape[-1] != 3:
        raise ValueError(
            f"bgr_to_gray expects (..., H, W, 3) BGR input, got "
            f"{tuple(img.shape)}")
    b = img[..., 0].to(torch.int32)
    g = img[..., 1].to(torch.int32)
    r = img[..., 2].to(torch.int32)
    y = (r * _CV_R + g * _CV_G + b * _CV_B
         + (1 << (_CV_SHIFT - 1))) >> _CV_SHIFT
    return y.to(torch.uint8)


def bgra_to_gray(img: torch.Tensor) -> torch.Tensor:
    """uint8 BGRA (..., H, W, 4) -> uint8 gray; alpha ignored."""
    if img.ndim < 3 or img.shape[-1] != 4:
        raise ValueError(
            f"bgra_to_gray expects (..., H, W, 4) BGRA input, got "
            f"{tuple(img.shape)}")
    return bgr_to_gray(img[..., :3])


class IntegralImages(NamedTuple):
    sum: torch.Tensor     # int32 (..., H+1, W+1)
    sq_hi: torch.Tensor   # int32, integral of (p*p) >> 8
    sq_lo: torch.Tensor   # int32, integral of (p*p) & 0xFF


def integral_2d(x: torch.Tensor, pad_after: int = 0) -> torch.Tensor:
    """(..., H, W) int32 -> (..., H+1+pad_after, W+1+pad_after) int32
    inclusive 2-D prefix sum with a zero first row and column, and
    ``pad_after`` zero rows and columns at the end.  ``dtype=int32`` keeps
    the cumsum in int32 (torch would otherwise promote to int64)."""
    s = torch.cumsum(torch.cumsum(x, dim=-1, dtype=torch.int32), dim=-2,
                     dtype=torch.int32)
    return F.pad(s, (1, pad_after, 1, pad_after))


def integral_images(gray: torch.Tensor, pad_after: int = 0) -> IntegralImages:
    """Integral planes of uint8 gray (..., H, W)."""
    p = gray.to(torch.int32)
    p2 = p * p
    return IntegralImages(integral_2d(p, pad_after),
                          integral_2d(p2 >> 8, pad_after),
                          integral_2d(p2 & 0xFF, pad_after))
