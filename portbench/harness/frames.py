"""Frames made from a seed: the bundled photograph as backdrop, with
pasted copies of it whose face is a chosen size.

``photo_gray``, ``resize_u8`` and ``photo_scene`` are a frozen copy of the
program's scene generator (``utils/testimage.py``): the photograph's
decoded pixels (``data/grace_hopper_rgb.npz``) in OpenCV's gray
convention, and Pillow's bilinear resampler byte for byte.  ``pool`` makes
a traffic mix's frames: every frame is the cover-fit upscaled photograph,
and the mix's fixed multiset of face sizes is dealt over the frames in an
order, and at positions, drawn from the seed; so every seed has the same
sizes and the same number of faces, in another arrangement.
"""

from __future__ import annotations

import os
from typing import Dict, Sequence, Tuple

import numpy as np

__all__ = ["photo_gray", "resize_u8", "photo_scene", "pool",
           "PHOTO_FACE_BOX"]

_DATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "grace_hopper_rgb.npz")

#: the photograph's face (x, y, w, h)
PHOTO_FACE_BOX = (146, 101, 232, 232)
_BITS = 22


def photo_gray() -> np.ndarray:
    with np.load(_DATA) as f:
        rgb = f["rgb"].astype(np.float32)
    gray = 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]
    return np.clip(gray, 0, 255).astype(np.uint8)


def _coeffs(n_in: int, n_out: int):
    scale = n_in / n_out
    support = max(scale, 1.0)
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(n_out, dtype=np.float64) + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    count = np.minimum((center + support + 0.5).astype(np.int64),
                       n_in) - xmin
    tap = np.arange(ksize)[None, :]
    d = np.abs((tap + xmin[:, None] - center[:, None] + 0.5) / support)
    w = np.where((d < 1.0) & (tap < count[:, None]), 1.0 - d, 0.0)
    total = np.zeros(n_out)
    for k in range(ksize):
        total = total + w[:, k]
    w = w / np.where(total != 0.0, total, 1.0)[:, None]
    kk = (0.5 + w * (1 << _BITS)).astype(np.int64)
    return np.minimum(xmin[:, None] + tap, n_in - 1), kk, xmin, count


def _pass(src: np.ndarray, idx, kk, axis: int) -> np.ndarray:
    src = src.astype(np.int64)
    shape = list(src.shape)
    shape[axis] = idx.shape[0]
    acc = np.full(shape, 1 << (_BITS - 1), np.int64)
    for k in range(idx.shape[1]):
        if axis == 0:
            acc += src[idx[:, k]] * kk[:, k, None]
        else:
            acc += src[:, idx[:, k]] * kk[:, k]
    return np.clip(acc >> _BITS, 0, 255).astype(np.uint8)


def resize_u8(img: np.ndarray, shape: Tuple[int, int]) -> np.ndarray:
    """Pillow's ``Image.resize(BILINEAR)`` of a uint8 gray image."""
    H, W = shape
    h, w = img.shape
    if (h, w) == (H, W):
        return img.copy()
    iy, ky, ymin, ycount = _coeffs(h, H)
    out = img
    if w != W:
        ix, kx, _, _ = _coeffs(w, W)
        first, last = int(ymin[0]), int(ymin[-1] + ycount[-1])
        out = _pass(img[first:last], ix, kx, axis=1)
        iy = np.minimum(iy - first, last - first - 1)
    if h != H:
        out = _pass(out, iy, ky, axis=0)
    return out


def _backdrop(base: np.ndarray, shape) -> np.ndarray:
    H, W = shape
    bh, bw = base.shape
    s = max(H / bh, W / bw)
    up = resize_u8(base, (int(round(bh * s)) + 1, int(round(bw * s)) + 1))
    return up[:H, :W].copy()


def _patch_shape(base: np.ndarray, size: int):
    f = size / PHOTO_FACE_BOX[2]
    bh, bw = base.shape
    return max(8, int(round(bh * f))), max(8, int(round(bw * f)))


def photo_scene(shape=(1080, 1920), face_sizes: Sequence[int] = (70, 110, 180),
                seed: int = 7) -> np.ndarray:
    """The program's ``photo_scene``: the same arguments give the same
    pixels."""
    H, W = shape
    base = photo_gray()
    scene = _backdrop(base, shape)
    rng = np.random.default_rng(seed)
    for size in face_sizes:
        ph, pw = _patch_shape(base, size)
        if ph > H or pw > W:
            continue
        patch = resize_u8(base, (ph, pw))
        y = int(rng.integers(0, max(1, H - ph)))
        x = int(rng.integers(0, max(1, W - pw)))
        scene[y:y + ph, x:x + pw] = patch
    return scene


def pool(shape, n: int, faces: Sequence[int], sizes: Sequence[int],
         seed: int) -> np.ndarray:
    """``n`` frames (n, H, W) uint8.  Frame i gets ``faces[i % len(faces)]``
    pasted faces (that list dealt over the frames in a seeded order); the
    face sizes are ``sizes`` repeated to the number of faces, in a seeded
    order; each paste's position is uniform over the frame."""
    H, W = shape
    base = photo_gray()
    back = _backdrop(base, shape)
    rng = np.random.default_rng(int(seed))
    counts = rng.permutation(np.resize(np.asarray(faces), n))
    order = rng.permutation(np.resize(np.asarray(sizes), int(counts.sum())))
    patches: Dict[int, np.ndarray] = {}
    out = np.empty((n, H, W), np.uint8)
    k = 0
    for i in range(n):
        out[i] = back
        for _ in range(int(counts[i])):
            size = int(order[k])
            k += 1
            if size not in patches:
                patches[size] = resize_u8(base, _patch_shape(base, size))
            p = patches[size]
            ph, pw = p.shape
            if ph > H or pw > W:
                continue
            y = int(rng.integers(0, max(1, H - ph)))
            x = int(rng.integers(0, max(1, W - pw)))
            out[i, y:y + ph, x:x + pw] = p
    return out
