"""Test imagery (numpy): the bundled photograph and procedural scenes.

Port of ``photo_gray``, ``photo_scene``, ``synth_face`` and
``synth_scene`` from ``clfacedetection_tpu/utils/testimage.py``; the same
arguments give the same pixels as the JAX package's functions.

The JAX package decodes ``grace_hopper.jpg`` and resizes it with PIL.
Here the decoded pixels are a data file (``data/grace_hopper_rgb.npz``,
written by ``tools/export_photo.py``), and ``_resize_u8`` is a numpy copy
of Pillow's bilinear resampler, byte for byte: no PIL is needed.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = ["synth_face", "synth_scene", "photo_gray", "photo_scene",
           "PHOTO_FACE_BOX"]

_DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data")

#: frontalface_alt detection on the raw photo (x, y, w, h), minNeighbors=3
PHOTO_FACE_BOX = (146, 101, 232, 232)

_photo_cache: dict = {}

# Pillow's fixed-point resampling: coefficients carry 22 fraction bits
_PRECISION_BITS = 22


def photo_gray() -> np.ndarray:
    """The bundled photograph as OpenCV-convention grayscale uint8
    (0.299R + 0.587G + 0.114B, the clif.cl:1-2 coefficients)."""
    if "gray" not in _photo_cache:
        with np.load(os.path.join(_DATA_DIR, "grace_hopper_rgb.npz")) as f:
            rgb = f["rgb"].astype(np.float32)
        gray = 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]
        _photo_cache["gray"] = np.clip(gray, 0, 255).astype(np.uint8)
    return _photo_cache["gray"].copy()


def _bilinear_coeffs(in_size: int, out_size: int):
    """Pillow's ``precompute_coeffs`` and ``normalize_coeffs_8bpc`` for the
    bilinear filter: per output pixel, the first source pixel ``xmin``,
    the count of taps and their int coefficients ``int(w * 2**22 + 0.5)``
    (support scaled by ``max(in/out, 1)``).  Returns source indices
    [out, ksize] (clamped; taps past the count weigh 0), coefficients
    [out, ksize] and the (xmin, count) bounds."""
    scale = in_size / out_size
    fscale = max(scale, 1.0)
    support = fscale                   # the bilinear filter's support is 1
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size, dtype=np.float64) + 0.5) * scale
    # C's (int) cast truncates toward zero
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    count = np.minimum((center + support + 0.5).astype(np.int64),
                       in_size) - xmin
    tap = np.arange(ksize)[None, :]
    d = np.abs((tap + xmin[:, None] - center[:, None] + 0.5) / fscale)
    w = np.where((d < 1.0) & (tap < count[:, None]), 1.0 - d, 0.0)
    total = np.zeros(out_size)
    for k in range(ksize):             # the C loop's order of summation
        total = total + w[:, k]
    w = w / np.where(total != 0.0, total, 1.0)[:, None]
    kk = (0.5 + w * (1 << _PRECISION_BITS)).astype(np.int64)
    idx = np.minimum(xmin[:, None] + tap, in_size - 1)
    return idx, kk, xmin, count


def _resample(src: np.ndarray, idx: np.ndarray, kk: np.ndarray,
              axis: int) -> np.ndarray:
    """One pass: out = clip8(2**21 + sum_k src[idx[:, k]] * kk[:, k]) along
    ``axis`` (0: rows, 1: columns), all rows or columns at once."""
    src = src.astype(np.int64)
    shape = list(src.shape)
    shape[axis] = idx.shape[0]
    acc = np.full(shape, 1 << (_PRECISION_BITS - 1), np.int64)
    for k in range(idx.shape[1]):
        if axis == 0:
            acc += src[idx[:, k]] * kk[:, k, None]
        else:
            acc += src[:, idx[:, k]] * kk[:, k]
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def _resize_u8(img: np.ndarray, shape: Tuple[int, int]) -> np.ndarray:
    """``Image.fromarray(img).resize((W, H), Image.BILINEAR)`` for a uint8
    gray image, byte for byte: a horizontal pass over the source rows
    that the vertical pass reads, a uint8 intermediate, then the vertical
    pass (Pillow's ``ImagingResampleInner``)."""
    H, W = shape
    h, w = img.shape
    if (h, w) == (H, W):
        return img.copy()
    iy, ky, ymin, ycount = _bilinear_coeffs(h, H)
    out = img
    if w != W:
        ix, kx, _, _ = _bilinear_coeffs(w, W)
        first, last = int(ymin[0]), int(ymin[-1] + ycount[-1])
        out = _resample(img[first:last], ix, kx, axis=1)
        iy = np.minimum(iy - first, last - first - 1)
    if h != H:
        out = _resample(out, iy, ky, axis=0)
    return out


def photo_scene(shape: Tuple[int, int] = (1080, 1920),
                face_sizes: Sequence[int] = (70, 110, 180),
                seed: int = 7) -> np.ndarray:
    """A ``shape`` frame with real-photo statistics: the photograph
    upscaled as backdrop, plus one pasted copy per entry of
    ``face_sizes`` scaled so its face box is about that many pixels.
    Deterministic for a given (shape, face_sizes, seed)."""
    key = (tuple(shape), tuple(face_sizes), seed)
    if key in _photo_cache:
        return _photo_cache[key].copy()
    H, W = shape
    base = photo_gray()
    bh, bw = base.shape
    # backdrop: cover-fit crop of the upscaled photo
    s = max(H / bh, W / bw)
    up = _resize_u8(base, (int(round(bh * s)) + 1, int(round(bw * s)) + 1))
    scene = up[:H, :W].copy()
    rng = np.random.default_rng(seed)
    fw = PHOTO_FACE_BOX[2]
    for size in face_sizes:
        f = size / fw
        ph, pw = max(8, int(round(bh * f))), max(8, int(round(bw * f)))
        if ph > H or pw > W:
            continue  # pasted photo would not fit this frame
        patch = _resize_u8(base, (ph, pw))
        y = int(rng.integers(0, max(1, H - ph)))
        x = int(rng.integers(0, max(1, W - pw)))
        scene[y:y + ph, x:x + pw] = patch
    _photo_cache[key] = scene
    return scene.copy()


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
