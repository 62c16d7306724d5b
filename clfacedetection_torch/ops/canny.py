"""Canny edge detection, bit-exact with OpenCV (aperture 3, L1 gradient).

Port of ``clfacedetection_tpu/ops/canny.py``.  ``CV_HAAR_DO_CANNY_PRUNING``
needs it: the reference computes ``cvCanny(img, 0, 50, 3)`` once per frame
and prunes the windows whose edge density is too low (tempcv.cpp:1339-1343,
1386-1405).

* Sobel 3x3 dx/dy with replicated borders; magnitude |dx| + |dy| (L1).
* Non-maximum suppression with the TG22 fixed-point sector test (TG22 =
  13573 = tan(22.5 deg) in Q15): horizontal sectors compare (>, >=)
  against left/right, vertical (>, >=) against up/down, diagonal strictly
  (>) against both diagonal neighbours chosen by sign(dx^dy); neighbours
  outside the image have magnitude zero.
* Hysteresis: candidates are NMS survivors with mag > low; edges are the
  8-connected flood of {candidates with mag > high}, a fixpoint of
  dilation masked by the candidates.  The fixpoint does not depend on the
  order of the steps, so it equals OpenCV's stack-based fill exactly.

``canny_np`` (numpy) is the specification; ``canny`` (torch, on the
tensor's device) runs ``GROW_STEPS`` dilation steps between two
convergence checks, so the host waits once per block of steps, not once
per step; or, for a CUDA graph, a fixed number of steps and a flag on the
device that says whether they reached the fixpoint.  Both are exact and
bit-equal.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["canny", "canny_np", "GROW_STEPS"]

_TG22 = 13573  # tan(22.5 deg) * 2^15
GROW_STEPS = 16  # hysteresis steps between two convergence checks
_NEIGHBOURS = [(di, dj) for di in (-1, 0, 1) for dj in (-1, 0, 1)
               if di or dj]


def _sobel_np(img: np.ndarray):
    p = np.pad(img.astype(np.int32), 1, mode="edge")
    H, W = img.shape
    kx = ((-1, 0, 1), (-2, 0, 2), (-1, 0, 1))
    ky = ((-1, -2, -1), (0, 0, 0), (1, 2, 1))
    dx = sum(kx[i][j] * p[i:i + H, j:j + W]
             for i in range(3) for j in range(3) if kx[i][j])
    dy = sum(ky[i][j] * p[i:i + H, j:j + W]
             for i in range(3) for j in range(3) if ky[i][j])
    return dx, dy


def canny_np(img: np.ndarray, low: float, high: float) -> np.ndarray:
    """NumPy Canny of uint8 (H, W); uint8 {0, 255} like ``cv2.Canny``."""
    H, W = img.shape
    dx, dy = _sobel_np(img)
    mag = np.abs(dx) + np.abs(dy)
    low_i, high_i = int(np.floor(low)), int(np.floor(high))
    mp = np.pad(mag, 1)

    def nb(di, dj):
        return mp[1 + di:1 + di + H, 1 + dj:1 + dj + W]

    x = np.abs(dx)
    y = np.abs(dy) << 15
    horiz = y < x * _TG22
    vert = y > x * _TG22 + ((2 * x) << 15)
    s_pos = (dx ^ dy) >= 0
    okh = (mag > nb(0, -1)) & (mag >= nb(0, 1))
    okv = (mag > nb(-1, 0)) & (mag >= nb(1, 0))
    d1 = np.where(s_pos, nb(-1, -1), nb(-1, 1))
    d2 = np.where(s_pos, nb(1, 1), nb(1, -1))
    okd = (mag > d1) & (mag > d2)
    cand = (mag > low_i) & np.where(horiz, okh, np.where(vert, okv, okd))
    edges = cand & (mag > high_i)
    while True:
        ep = np.pad(edges, 1)
        grown = np.zeros_like(edges)
        for di, dj in _NEIGHBOURS:
            grown |= ep[1 + di:1 + di + H, 1 + dj:1 + dj + W]
        new = edges | (grown & cand)
        if (new == edges).all():
            return edges.astype(np.uint8) * 255
        edges = new


def canny(img: torch.Tensor, low: float, high: float,
          steps: Optional[int] = None):
    """Canny of a uint8 (H, W) tensor on its device; uint8 {0, 255}.

    A hysteresis step is a 3x3 max-pool of the edge map (0 or 1, so exact)
    masked by the candidates.  By default the steps run in blocks of
    ``GROW_STEPS`` until one changes nothing.  With ``steps``, exactly that
    many run and the host reads nothing, as a CUDA graph needs: the result
    is then ``(edges, done)``, ``done`` an int32 [1] on the device that is
    1 when one more step would change nothing (the fixpoint is reached)
    and 0 when the caller must run more steps."""
    H, W = img.shape
    dev = img.device
    # replicated border: clamp the row and column indices
    rows = torch.arange(-1, H + 1, device=dev).clamp(0, H - 1)
    cols = torch.arange(-1, W + 1, device=dev).clamp(0, W - 1)
    p = img.to(torch.int32).index_select(0, rows).index_select(1, cols)

    def tap(i, j):
        return p[i:i + H, j:j + W]

    dx = (tap(0, 2) - tap(0, 0)) + 2 * (tap(1, 2) - tap(1, 0)) \
        + (tap(2, 2) - tap(2, 0))
    dy = (tap(2, 0) - tap(0, 0)) + 2 * (tap(2, 1) - tap(0, 1)) \
        + (tap(2, 2) - tap(0, 2))
    mag = dx.abs() + dy.abs()
    low_i, high_i = int(np.floor(low)), int(np.floor(high))
    mp = F.pad(mag, (1, 1, 1, 1))

    def nb(di, dj):
        return mp[1 + di:1 + di + H, 1 + dj:1 + dj + W]

    x = dx.abs()
    y = dy.abs() << 15
    horiz = y < x * _TG22
    vert = y > x * _TG22 + ((2 * x) << 15)
    s_pos = (dx ^ dy) >= 0
    okh = (mag > nb(0, -1)) & (mag >= nb(0, 1))
    okv = (mag > nb(-1, 0)) & (mag >= nb(1, 0))
    d1 = torch.where(s_pos, nb(-1, -1), nb(-1, 1))
    d2 = torch.where(s_pos, nb(1, 1), nb(1, -1))
    okd = (mag > d1) & (mag > d2)
    cand = (mag > low_i) & torch.where(horiz, okh, torch.where(vert, okv,
                                                               okd))
    # the edges as a 0/1 float map: a step's 8-neighbour OR is a max-pool
    # (out-of-image neighbours pad as -inf and never win over the centre)
    cand_f = cand.to(torch.float32)[None, None]
    edges = (cand & (mag > high_i)).to(torch.float32)[None, None]

    def grow(e):
        return F.max_pool2d(e, 3, stride=1, padding=1) * cand_f

    if steps is None:
        while True:
            before = edges
            for _ in range(GROW_STEPS):
                edges = grow(edges)
            if torch.equal(edges, before):
                return (edges[0, 0] > 0).to(torch.uint8) * 255
    for _ in range(int(steps)):
        edges = grow(edges)
    done = torch.eq(grow(edges), edges).all().to(torch.int32).reshape(1)
    return (edges[0, 0] > 0).to(torch.uint8) * 255, done
