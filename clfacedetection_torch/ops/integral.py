"""Grayscale conversion and integral images (torch).

Port of ``clfacedetection_tpu/ops/integral.py``:

* gray: OpenCV's ``cvtColor`` (``mode="cv"``) and the reference GPU
  kernel's float multiply-accumulate (``mode="clif"``), per frame or per
  row, and ``invert``; bit-equal to JAX's on the CPU;
* ``sum``: int32, exact (255 * 4M pixels < 2^31);
* the squared sum as two int32 planes, ``sq_hi = (p*p) >> 8`` and
  ``sq_lo = (p*p) & 0xFF``, so 4-corner window differences are exact
  integers and ``hi * 256 + lo`` is rebuilt in float only afterwards.

All planes are (..., H+1, W+1) with a zero first row and column, like
``cv2.integral``; the tilted (RSAT) plane of ``cv2.integral3`` is
``tilted_integral``, for cascades with 45-degree features.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["bgr_to_gray", "bgr_to_gray_per_row", "bgra_to_gray", "invert",
           "IntegralImages", "integral_images", "integral_2d",
           "tilted_integral"]

# OpenCV's 15-bit fixed-point BGR->gray coefficients (cvtColor BGR2GRAY)
_CV_SHIFT = 15
_CV_R, _CV_G, _CV_B = 9798, 19235, 3735
# the reference GPU kernel's float coefficients (clif.cl:4-18), as the
# float32 constants that JAX multiplies by
_CLIF_B, _CLIF_G, _CLIF_R = 0.114, 0.587, 0.299


def invert(img: torch.Tensor) -> torch.Tensor:
    """255 - pixel, in the input's dtype (the reference's ``invert``
    kernel, clif.cl:123-137; JAX ``ops/integral.py:44-49``)."""
    return 255 - img


def _channels(img: torch.Tensor, what: str, n: int):
    if img.ndim < 3 or img.shape[-1] != n:
        raise ValueError(f"{what} expects (..., H, W, {n}) input, got "
                         f"{tuple(img.shape)}")
    return img[..., 0], img[..., 1], img[..., 2]


def _truncate(y: torch.Tensor) -> torch.Tensor:
    """C-style truncation toward zero, then the clamp to [0, 255]."""
    return y.to(torch.int32).clamp(0, 255).to(torch.uint8)


def bgr_to_gray(img: torch.Tensor, mode: str = "cv") -> torch.Tensor:
    """uint8 BGR (..., H, W, 3) -> uint8 gray (..., H, W).

    ``mode="cv"``: ``cv2.cvtColor(BGR2GRAY)``'s fixed-point rounding,
    bit-exact.  ``mode="clif"``: the reference GPU kernel's float32
    multiply-accumulate, then truncation and clamp (clif.cl:4-18),
    bit-equal to JAX's ``bgr_to_gray(mode="clif")``: XLA:CPU rounds each
    product and each sum there, ``(0.114 b + 0.587 g) + 0.299 r``."""
    b, g, r = _channels(img, "bgr_to_gray", 3)
    if mode == "cv":
        b, g, r = (c.to(torch.int32) for c in (b, g, r))
        y = (r * _CV_R + g * _CV_G + b * _CV_B
             + (1 << (_CV_SHIFT - 1))) >> _CV_SHIFT
        return y.to(torch.uint8)
    if mode == "clif":
        f = torch.float32
        y = (b.to(f) * _f32(_CLIF_B, img) + g.to(f) * _f32(_CLIF_G, img)) \
            + r.to(f) * _f32(_CLIF_R, img)
        return _truncate(y)
    raise ValueError(f"unknown grayscale mode {mode!r}")


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def bgr_to_gray_per_row(img: torch.Tensor, mode: str = "clif"
                        ) -> torch.Tensor:
    """The reference's row-parallel ``bgrToGrayscalePerRow``
    (clif.cl:35-74), bit-equal to JAX's ``bgr_to_gray_per_row``.  JAX maps
    ``bgr_to_gray`` over the rows, and XLA:CPU contracts that loop body's
    clif arithmetic into two fmas, ``fma(0.299, r, fma(0.114, b, 0.587
    g))`` (each rounded once; measured over every BGR triple), so the
    clif mode here computes that, each fma exact in float64 and rounded to
    float32 once.  ``mode="cv"`` is ``bgr_to_gray``'s."""
    b, g, r = _channels(img, "bgr_to_gray_per_row", 3)
    if mode != "clif":
        return bgr_to_gray(img, mode)
    d = torch.float64
    inner = (b.to(d) * float(np.float32(_CLIF_B))
             + (g.to(torch.float32) * _f32(_CLIF_G, img)).to(d)
             ).to(torch.float32)
    y = (r.to(d) * float(np.float32(_CLIF_R)) + inner.to(d)) \
        .to(torch.float32)
    return _truncate(y)


def bgra_to_gray(img: torch.Tensor, mode: str = "cv") -> torch.Tensor:
    """uint8 BGRA (..., H, W, 4) -> uint8 gray; alpha ignored: the BGR
    conversion of the first three channels (``cvtColor(BGRA2GRAY)``)."""
    _channels(img, "bgra_to_gray", 4)
    return bgr_to_gray(img[..., :3], mode)


@dataclasses.dataclass(frozen=True, eq=False)
class IntegralImages:
    """The integral planes of one frame or a batch: each int32
    (..., H+1+pad_after, W+1+pad_after), the last ``pad_after`` rows and
    columns zero (``integral_images``).  Unpacks, indexes and slices as
    the tuple of its four planes, ``(sum, sq_hi, sq_lo, tilted)``."""

    sum: torch.Tensor     # int32
    sq_hi: torch.Tensor   # int32, integral of (p*p) >> 8
    sq_lo: torch.Tensor   # int32, integral of (p*p) & 0xFF
    tilted: Optional[torch.Tensor] = None   # int32 RSAT, with_tilted only
    pad_after: int = 0    # zero rows and columns after the planes

    def planes(self) -> tuple:
        return (self.sum, self.sq_hi, self.sq_lo, self.tilted)

    def __iter__(self):
        return iter(self.planes())

    def __len__(self) -> int:
        return 4

    def __getitem__(self, i):
        return self.planes()[i]

    @property
    def height(self) -> int:
        """H: the frame's rows, the pad left out."""
        return self.sum.shape[-2] - 1 - self.pad_after

    @property
    def width(self) -> int:
        """W: the frame's columns, the pad left out."""
        return self.sum.shape[-1] - 1 - self.pad_after

    def sqsum_f64(self) -> np.ndarray:
        """The float64 squared-sum integral (``cv2.integral``'s layout,
        (..., H+1, W+1), the pad left out) on the host: ``hi * 256 + lo``,
        for test oracles."""
        h, w = self.height + 1, self.width + 1
        hi = self.sq_hi[..., :h, :w].cpu().numpy().astype(np.float64)
        lo = self.sq_lo[..., :h, :w].cpu().numpy().astype(np.float64)
        return hi * 256.0 + lo


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
                          integral_2d(p2 & 0xFF, pad_after), tilted,
                          pad_after)
