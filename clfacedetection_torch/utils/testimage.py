"""Procedural test imagery (numpy): deterministic faces and scenes.

Port of ``synth_face`` and ``synth_scene`` from
``clfacedetection_tpu/utils/testimage.py``; the same arguments give the
same pixels as the JAX package's functions.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = ["synth_face", "synth_scene"]


def synth_face(shape: Tuple[int, int] = (120, 160),
               center: Optional[Tuple[int, int]] = None,
               size: float = 40.0,
               seed: int = 3,
               noise: float = 6.0) -> np.ndarray:
    """Crude frontal face (skin oval, eyes/brows, nose, mouth) on a noisy
    background. ``size`` is roughly the detected box edge * 0.9."""
    H, W = shape
    cy, cx = center if center is not None else (H // 2, W // 2)
    img = np.full((H, W), 105, np.float32)
    rng = np.random.default_rng(seed)
    img += rng.normal(0, noise, (H, W)).astype(np.float32)
    _paint_face(img, cy, cx, size)
    return np.clip(img, 0, 255).astype(np.uint8)


def synth_scene(shape: Tuple[int, int] = (1080, 1920),
                faces: Sequence[Tuple[int, int, float]] = ((540, 960, 90.0),),
                seed: int = 3,
                noise: float = 6.0,
                texture: float = 25.0) -> np.ndarray:
    """A larger scene with several faces at (cy, cx, size).

    The background carries multi-octave smooth texture plus pixel noise —
    flat-noise backgrounds reject unrealistically *slowly* in the early
    cascade stages (low variance normalizes the stump thresholds toward
    zero), which would skew survivor statistics and benchmarks."""
    H, W = shape
    rng = np.random.default_rng(seed)
    img = np.full((H, W), 105, np.float32)
    for cell in (64, 16, 4):
        coarse = rng.normal(0, texture, (H // cell + 2, W // cell + 2))
        yy = np.arange(H) / cell
        xx = np.arange(W) / cell
        y0 = yy.astype(int)
        x0 = xx.astype(int)
        fy = (yy - y0)[:, None]
        fx = (xx - x0)[None, :]
        c00 = coarse[np.ix_(y0, x0)]
        c01 = coarse[np.ix_(y0, x0 + 1)]
        c10 = coarse[np.ix_(y0 + 1, x0)]
        c11 = coarse[np.ix_(y0 + 1, x0 + 1)]
        img += ((1 - fy) * ((1 - fx) * c00 + fx * c01)
                + fy * ((1 - fx) * c10 + fx * c11)).astype(np.float32)
        texture *= 0.5
    img += rng.normal(0, noise, (H, W)).astype(np.float32)
    for cy, cx, size in faces:
        _paint_face(img, cy, cx, size)
    return np.clip(img, 0, 255).astype(np.uint8)


def _paint_face(img: np.ndarray, cy: float, cx: float, s: float) -> None:
    H, W = img.shape
    # local patch bounding the face keeps painting O(face), not O(image)
    r = int(s * 1.5) + 2
    y0, y1 = max(0, int(cy) - r), min(H, int(cy) + r)
    x0, x1 = max(0, int(cx) - r), min(W, int(cx) + r)
    if y0 >= y1 or x0 >= x1:
        return
    yy, xx = np.mgrid[y0:y1, x0:x1].astype(np.float32)
    patch = img[y0:y1, x0:x1]

    def blob(by, bx, ry, rx, amp):
        m = ((yy - by) / ry) ** 2 + ((xx - bx) / rx) ** 2
        patch[...] += amp * np.exp(-m * 2.0)

    # damp background texture under the face so the painted features
    # dominate (real faces are smooth relative to scene texture)
    env = np.exp(-(((yy - cy) / (s * 0.62)) ** 2
                   + ((xx - cx) / (s * 0.48)) ** 2) * 2.0)
    patch[...] = patch * (1 - 0.85 * env) + 105.0 * 0.85 * env

    blob(cy, cx, s * 0.62, s * 0.48, 95)                   # skin oval
    blob(cy - s * 0.18, cx - s * 0.20, s * 0.07, s * 0.12, -85)  # L eye
    blob(cy - s * 0.18, cx + s * 0.20, s * 0.07, s * 0.12, -85)  # R eye
    blob(cy - s * 0.30, cx - s * 0.20, s * 0.04, s * 0.14, -40)  # L brow
    blob(cy - s * 0.30, cx + s * 0.20, s * 0.04, s * 0.14, -40)  # R brow
    blob(cy + s * 0.05, cx, s * 0.16, s * 0.06, 25)        # nose ridge
    blob(cy + s * 0.18, cx, s * 0.045, s * 0.10, -45)      # nostrils
    blob(cy + s * 0.34, cx, s * 0.05, s * 0.18, -65)       # mouth
    blob(cy + s * 0.48, cx, s * 0.06, s * 0.25, 20)        # chin light
