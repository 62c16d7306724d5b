"""Node values as one matrix product: the ``"direct"`` strategy's tail.

Port of the JAX package's XLA tail (``_build_stencils`` and
``_tail_accept_chunk``, ``clfacedetection_tpu/detect/pyramid.py:509-537,
671-714``): each survivor's window patch of an integral plane, made
window-local by subtracting its corner (and, for the upright ``sum``
plane, its first row and column: upright rect corners pair up, so those
terms cancel out of every rect), times a signed corner-weight stencil
``[patch, n_clf * T]``, gives every node's value in one ``torch.matmul``.
Tilted corners do not pair up, so the tilted patch keeps the corner-only
correction, as in JAX.

This is a plain matrix product that JAX leaves to XLA, so it stays a
library call here; the float32 product runs without TF32.  Its summation
order is not the rect order, so its node values differ from the v1
tail's (``haar_tail``) in the last bits, as the JAX package's do.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .cascade_table import CascadeTable

__all__ = ["build_stencils", "window_patches", "stencil_values"]


def build_stencils(table: CascadeTable, ph: int, pw: int
                   ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """float32 [ph * pw, n_clf * T] signed corner-weight stencils over a
    ``ph`` x ``pw`` window patch: one for the ``sum`` plane and, for
    cascades with tilted features, one for the tilted plane (else None).
    Entry (y * pw + x, c * T + t) sums sign * weight over the corners of
    node (c, t) at (y, x), in rect then corner order (JAX's order, so the
    stencils are equal to JAX's ``_sten_sum`` / ``_sten_tilt``)."""
    nn = table.n_clf * table.T
    P = ph * pw
    if table.max_dy >= ph or table.max_dx >= pw:
        raise ValueError(f"a {ph}x{pw} patch does not hold every corner")
    sten = np.zeros((2 * P, nn), np.float32)
    cor = table.corners.reshape(nn, 3, 4, 2).astype(np.int64)
    w = table.weights.reshape(nn, 3)
    nr = table.n_rects.reshape(nn)
    plane = table.tilted.reshape(nn).astype(np.int64) * P
    cols = np.arange(nn)
    for k in range(3):
        live = nr > k
        for j, sign in enumerate((1.0, -1.0, -1.0, 1.0)):
            row = plane + cor[:, k, j, 0] * pw + cor[:, k, j, 1]
            np.add.at(sten, (row[live], cols[live]),
                      np.float32(sign) * w[live, k])
    return sten[:P], (sten[P:] if table.has_tilted else None)


def window_patches(plane: torch.Tensor, surv_idx: torch.Tensor, hv: int,
                   wv: int, ph: int, pw: int,
                   full_correction: bool) -> torch.Tensor:
    """int32 [B, cap, ph * pw] window patches of ``plane`` [B, Hp, Wp] at
    the slots ``surv_idx`` (pad slots take the window at 0), made
    window-local: minus the patch's corner and, with ``full_correction``,
    minus its first row and column too.  int32 arithmetic wraps, but the
    results are window-local and exact."""
    B, cap = surv_idx.shape
    wp = plane.shape[2]
    valid = (surv_idx >= 0) & (surv_idx < hv * wv)
    idx = torch.where(valid, surv_idx, 0).long()
    y = torch.div(idx, wv, rounding_mode="floor")
    base = y * wp + (idx - y * wv)                        # [B, cap]
    # the patch offsets made on the device: no copy from the host, which
    # a CUDA graph could not hold
    dev = plane.device
    off = (torch.arange(ph, device=dev)[:, None] * wp
           + torch.arange(pw, device=dev)[None, :]).reshape(-1)
    g = (base[:, :, None] + off).reshape(B, -1)
    raw = plane.reshape(B, -1).gather(1, g).reshape(B, cap, ph, pw)
    r = raw - raw[:, :, :1, :1]
    if full_correction:
        r = r - r[:, :, :1, :] - r[:, :, :, :1]
    return r.reshape(B, cap, ph * pw)


def stencil_values(sum_: torch.Tensor, tilted: Optional[torch.Tensor],
                   surv_idx: torch.Tensor, hv: int, wv: int, ph: int,
                   pw: int, sten_sum: torch.Tensor,
                   sten_tilt: Optional[torch.Tensor]) -> torch.Tensor:
    """Node values [B, cap, n_clf * T] in the stencils' dtype: the ``sum``
    patches (full correction) times ``sten_sum``, plus the tilted patches
    (corner-only correction) times ``sten_tilt``."""
    dtype = sten_sum.dtype
    if sum_.device.type == "cuda" and dtype == torch.float32 and (
            torch.get_float32_matmul_precision() != "highest"
            or torch.backends.cuda.matmul.allow_tf32):
        raise RuntimeError("the direct strategy's float32 product needs "
                           "full float32: set torch.backends.cuda.matmul."
                           "allow_tf32 = False and the float32 matmul "
                           "precision to \"highest\"")
    B, cap = surv_idx.shape
    p = window_patches(sum_, surv_idx, hv, wv, ph, pw, True)
    vals = torch.matmul(p.to(dtype), sten_sum)
    if sten_tilt is not None:
        p = window_patches(tilted, surv_idx, hv, wv, ph, pw, False)
        vals = vals + torch.matmul(p.to(dtype), sten_tilt)
    return vals
