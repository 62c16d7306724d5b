"""Grayscale conversion and integral images (torch).

Port of ``clfacedetection_tpu/ops/integral.py``:

* ``sum``: int32, exact (255 * 4M pixels < 2^31);
* the squared sum as two int32 planes, ``sq_hi = (p*p) >> 8`` and
  ``sq_lo = (p*p) & 0xFF``, so 4-corner window differences are exact
  integers and ``hi * 256 + lo`` is rebuilt in float only afterwards.

All planes are (..., H+1, W+1) with a zero first row and column, like
``cv2.integral``; the tilted (RSAT) plane of ``cv2.integral3`` is
``tilted_integral``, for cascades with 45-degree features.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

__all__ = ["bgr_to_gray", "bgra_to_gray", "IntegralImages",
           "integral_images", "integral_2d", "tilted_integral"]

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
    tilted: Optional[torch.Tensor] = None   # int32 RSAT, with_tilted only


def integral_2d(x: torch.Tensor, pad_after: int = 0) -> torch.Tensor:
    """(..., H, W) int32 -> (..., H+1+pad_after, W+1+pad_after) int32
    inclusive 2-D prefix sum with a zero first row and column, and
    ``pad_after`` zero rows and columns at the end.  ``dtype=int32`` keeps
    the cumsum in int32 (torch would otherwise promote to int64)."""
    s = torch.cumsum(torch.cumsum(x, dim=-1, dtype=torch.int32), dim=-2,
                     dtype=torch.int32)
    return F.pad(s, (1, pad_after, 1, pad_after))


def _shear(x: torch.Tensor, sign: int) -> torch.Tensor:
    """[..., R, L] -> [..., R, L + R - 1] with out[r, c] = x[r, c - r]
    (``sign=1``, anti-diagonals become columns) or x[r, c + r - (R - 1)]
    (``sign=-1``, diagonals become columns); zeros elsewhere.  A strided
    view of the zero-padded input, made contiguous."""
    R, L = x.shape[-2:]
    lead = x.shape[:-2]
    z = F.pad(x, (R - 1, R - 1)).contiguous()            # row length L+2R-2
    rl = L + 2 * R - 2
    step = rl - 1 if sign > 0 else rl + 1
    off = R - 1 if sign > 0 else 0
    size = lead + (R, L + R - 1)
    stride = tuple(z.stride()[:-2]) + (step, 1)
    return z.as_strided(size, stride, z.storage_offset() + off).contiguous()


def _unshear(s: torch.Tensor, sign: int, L: int) -> torch.Tensor:
    """Inverse of ``_shear`` for the first ``L`` columns."""
    R, C = s.shape[-2:]
    step = C + 1 if sign > 0 else C - 1
    off = 0 if sign > 0 else R - 1
    size = s.shape[:-2] + (R, L)
    stride = tuple(s.stride()[:-2]) + (step, 1)
    return s.as_strided(size, stride, s.storage_offset() + off)


def tilted_integral(gray: torch.Tensor) -> torch.Tensor:
    """45-degree rotated integral (RSAT) of uint8 (..., H, W) ->
    int32 (..., H+1, W+1), bit-equal to the JAX package's
    ``tilted_integral`` (and so to ``cv2.integral3``).

    JAX runs the row recurrence (``integral.py:184-186``)

        U(y, x) = U(y-1, x+1) + p(y-1, x-1) + p(y-2, x-1)
        T(y, x) = T(y-1, x-1) + U(y, x),   T(y, 0) = T(y-1, 1)

    one row at a time.  Unrolled, U is a running sum down each
    anti-diagonal of q(y, x) = p(y-1, x-1) + p(y-2, x-1), and T is a
    running sum down each diagonal of U (column 0 of U left out) plus the
    column-0 value C(y - x) where the diagonal starts; the column rule
    gives C(y) = C(y-2) + U(y-1, 1).  So three cumsums over sheared views
    replace the H-step loop.  All sums are int32 additions, exact modulo
    2^32, so the order does not change a bit."""
    lead = gray.shape[:-2]
    H, W = gray.shape[-2:]
    p = gray.to(torch.int32)
    # q over rows 0..H and columns 0..W (row 0 and column 0 are zero)
    q = F.pad(p, (1, 0, 1, 0))
    q = q + F.pad(p, (1, 0, 2, 0))[..., :H + 1, :]
    U = _unshear(torch.cumsum(_shear(q, 1), dim=-2, dtype=torch.int32),
                 1, W + 1)                             # [..., H+1, W+1]
    Up = U.clone()
    Up[..., 0] = 0
    D = _unshear(torch.cumsum(_shear(Up, -1), dim=-2, dtype=torch.int32),
                 -1, W + 1)
    # C(y): C(0) = C(1) = 0, C(y) = C(y-2) + U(y-1, 1)
    v = torch.zeros(lead + (H + 1,), dtype=torch.int32, device=gray.device)
    if W >= 1 and H >= 1:
        v[..., 2:] = U[..., 1:H, 1]
    C = torch.zeros_like(v)
    C[..., 0::2] = torch.cumsum(v[..., 0::2], dim=-1, dtype=torch.int32)
    C[..., 1::2] = torch.cumsum(v[..., 1::2], dim=-1, dtype=torch.int32)
    # T(y, x) = D(y, x) + C(y - x) where x <= y
    yy = torch.arange(H + 1, device=gray.device)[:, None]
    xx = torch.arange(W + 1, device=gray.device)[None, :]
    d = yy - xx
    start = C[..., d.clamp(min=0)]                      # [..., H+1, W+1]
    return D + torch.where(d >= 0, start, torch.zeros_like(start))


def integral_images(gray: torch.Tensor, pad_after: int = 0,
                    with_tilted: bool = False) -> IntegralImages:
    """Integral planes of uint8 gray (..., H, W); ``with_tilted`` adds the
    RSAT plane, padded like the others."""
    p = gray.to(torch.int32)
    p2 = p * p
    tilted = None
    if with_tilted:
        tilted = F.pad(tilted_integral(gray), (0, pad_after, 0, pad_after))
    return IntegralImages(integral_2d(p, pad_after),
                          integral_2d(p2 >> 8, pad_after),
                          integral_2d(p2 & 0xFF, pad_after), tilted)
