"""Native (C++) host components, built with ``g++`` and loaded via ctypes.

Two sources, the port's copies of the JAX package's: ``grouping.cpp``
(the partition and ``groupRectangles`` of ``detect/grouping.py``, whose
numpy code stays the specification and the fallback) and
``haar_oracle.cpp`` (``COracle``, a window oracle that re-derives the
cascade from the raw ``CascadeSpec`` arrays, independently of
``models/compile.py`` and ``detect/reference_impl.py``).

The library is built at first use into ``clfacedetection_torch/build/``
under a name keyed by a hash of the sources and flags.  Concurrent
builders (test workers, threads, processes) are safe: the build holds an
``fcntl.flock`` on a lock file in that directory, compiles to a
temporary name and renames it into place with ``os.replace``, so no
process ever loads a half-written library.  A failed build raises with
the compiler's output; ``native_available()`` answers False then, and
``CLFD_NO_NATIVE=1`` makes the grouping take its numpy route.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["CXX_FLAGS", "build", "native_available", "native_error",
           "group_rectangles_native", "partition_native", "COracle",
           "oracle_candidates"]

_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD = os.path.join(os.path.dirname(_DIR), "build")
_SRCS = [os.path.join(_DIR, "grouping.cpp"),
         os.path.join(_DIR, "haar_oracle.cpp")]
CXX_FLAGS = ["-O2", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None


def _cxx() -> str:
    found = shutil.which(os.environ.get("CXX", "g++"))
    if not found:
        raise RuntimeError("no C++ compiler: put g++ on PATH or set CXX")
    return found


def build(build_dir: Optional[str] = None) -> str:
    """Build the library (once per source hash) and return its path."""
    build_dir = build_dir or _BUILD
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for p in _SRCS:
        with open(p, "rb") as f:
            h.update(os.path.basename(p).encode() + f.read())
    out = os.path.join(build_dir, f"libclfd_native_{h.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(build_dir, exist_ok=True)
    with open(os.path.join(build_dir, "native.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(out):          # another builder finished first
            return out
        tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
        try:
            proc = subprocess.run([_cxx()] + CXX_FLAGS + ["-o", tmp] + _SRCS,
                                  capture_output=True, text=True,
                                  timeout=300)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"g++ failed on the native library ({proc.returncode}):"
                    f"\n{proc.stdout}\n{proc.stderr}")
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c = ctypes
    i16p, i32p = c.POINTER(c.c_int16), c.POINTER(c.c_int32)
    i64p, f32p = c.POINTER(c.c_int64), c.POINTER(c.c_float)
    f64p, u8p = c.POINTER(c.c_double), c.POINTER(c.c_uint8)
    lib.clfd_partition.restype = c.c_int
    lib.clfd_partition.argtypes = [i64p, c.c_int, c.c_double, i32p]
    lib.clfd_group_rectangles.restype = c.c_int
    lib.clfd_group_rectangles.argtypes = [
        i64p, c.c_int, c.c_int, c.c_double, c.c_int, i64p, i32p]
    lib.clfd_oracle_create.restype = c.c_void_p
    lib.clfd_oracle_create.argtypes = [
        c.c_int, c.c_int, c.c_int, c.c_int,
        i16p, i16p, i16p, i16p, f32p, u8p, f32p, i32p, i32p,
        i32p, i32p, i32p, f32p,
        i32p, i32p, f32p, i32p, i32p, i32p,
        c.c_int, c.c_int]
    lib.clfd_oracle_set_images.restype = None
    lib.clfd_oracle_set_images.argtypes = [
        c.c_void_p, i32p, f64p, i32p, c.c_int, c.c_int, c.c_double]
    lib.clfd_oracle_run.restype = None
    lib.clfd_oracle_run.argtypes = [c.c_void_p, i32p, i32p, c.c_int, i32p,
                                    f64p]
    lib.clfd_oracle_destroy.restype = None
    lib.clfd_oracle_destroy.argtypes = [c.c_void_p]
    return lib


def _load() -> Optional[ctypes.CDLL]:
    """The library, built on first call; None (and ``native_error()``)
    if it cannot be built or loaded."""
    global _lib, _error
    with _lock:
        if _lib is None and _error is None:
            try:
                _lib = _bind(ctypes.CDLL(build()))
            except (RuntimeError, OSError, subprocess.SubprocessError) as e:
                _error = f"{type(e).__name__}: {e}"
        return _lib


def native_available() -> bool:
    return _load() is not None


def native_error() -> Optional[str]:
    """Why the library is unavailable (the compiler's output), or None."""
    _load()
    return _error


def _ptr(a: np.ndarray, t):
    return a.ctypes.data_as(ctypes.POINTER(t))


def _as_i64(boxes: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(boxes, np.int64).reshape(-1, 4))


def partition_native(boxes: np.ndarray,
                     eps: float) -> Optional[Tuple[np.ndarray, int]]:
    lib = _load()
    if lib is None:
        return None
    b = _as_i64(boxes)
    labels = np.empty(len(b), np.int32)
    ncls = lib.clfd_partition(_ptr(b, ctypes.c_int64), len(b), float(eps),
                              _ptr(labels, ctypes.c_int32))
    return labels, int(ncls)


def group_rectangles_native(boxes: np.ndarray, group_threshold: int,
                            eps: float = 0.2, variant: str = "opencv"
                            ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    lib = _load()
    if lib is None:
        return None
    b = _as_i64(boxes)
    n = len(b)
    out_b = np.empty((max(n, 1), 4), np.int64)
    out_n = np.empty(max(n, 1), np.int32)
    m = lib.clfd_group_rectangles(
        _ptr(b, ctypes.c_int64), n, int(group_threshold), float(eps),
        1 if variant == "clod" else 0,
        _ptr(out_b, ctypes.c_int64), _ptr(out_n, ctypes.c_int32))
    return out_b[:m].astype(np.int32), out_n[:m]


class COracle:
    """Independent window-evaluation oracle (``haar_oracle.cpp``).

    Driven by the *raw* ``CascadeSpec`` arrays: the C side re-derives the
    hidden cascade (stage bias, third-rect drop), the per-scale corner
    and weight tables and the run loop from the reference's semantics
    (tempcv.cpp:549-948).  ``run`` returns the
    ``cvRunHaarClassifierCascadeSum`` contract: codes 1 pass, ``-i`` fail
    at stage i, 0 stage-tree fail, -1 out of bounds, plus the stage sum
    where evaluation stopped.
    """

    def __init__(self, spec):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native library unavailable: {_error}")
        self._lib = lib
        c = ctypes

        def arr(a, dt):
            return np.ascontiguousarray(np.asarray(a, dt))

        # C copies the tables in create(); the buffers live until then
        k = dict(
            rx=arr(spec.rect_x, np.int16), ry=arr(spec.rect_y, np.int16),
            rw=arr(spec.rect_w, np.int16), rh=arr(spec.rect_h, np.int16),
            wgt=arr(spec.rect_weight, np.float32),
            tilt=arr(spec.tilted, np.uint8),
            thr=arr(spec.node_threshold, np.float32),
            left=arr(spec.left, np.int32), right=arr(spec.right, np.int32),
            cno=arr(spec.clf_node_ofs, np.int32),
            cnc=arr(spec.clf_node_cnt, np.int32),
            cao=arr(spec.clf_alpha_ofs, np.int32),
            al=arr(spec.alphas, np.float32),
            sco=arr(spec.stage_clf_ofs, np.int32),
            scc=arr(spec.stage_clf_cnt, np.int32),
            sth=arr(spec.stage_threshold, np.float32),
            sp=arr(spec.stage_parent, np.int32),
            sn=arr(spec.stage_next, np.int32),
            sc=arr(spec.stage_child, np.int32))
        self._h = lib.clfd_oracle_create(
            int(spec.n_stages), int(spec.n_classifiers), int(spec.n_nodes),
            len(k["al"]),
            _ptr(k["rx"], c.c_int16), _ptr(k["ry"], c.c_int16),
            _ptr(k["rw"], c.c_int16), _ptr(k["rh"], c.c_int16),
            _ptr(k["wgt"], c.c_float), _ptr(k["tilt"], c.c_uint8),
            _ptr(k["thr"], c.c_float), _ptr(k["left"], c.c_int32),
            _ptr(k["right"], c.c_int32),
            _ptr(k["cno"], c.c_int32), _ptr(k["cnc"], c.c_int32),
            _ptr(k["cao"], c.c_int32), _ptr(k["al"], c.c_float),
            _ptr(k["sco"], c.c_int32), _ptr(k["scc"], c.c_int32),
            _ptr(k["sth"], c.c_float), _ptr(k["sp"], c.c_int32),
            _ptr(k["sn"], c.c_int32), _ptr(k["sc"], c.c_int32),
            int(spec.window_w), int(spec.window_h))
        self._imgs = None

    def set_images(self, sum_img, sqsum_img, tilted_img, scale):
        s = np.ascontiguousarray(sum_img, np.int32)
        q = np.ascontiguousarray(sqsum_img, np.float64)
        t = (np.ascontiguousarray(tilted_img, np.int32)
             if tilted_img is not None else s)
        self._imgs = (s, q, t)    # kept alive: C holds raw pointers
        self._lib.clfd_oracle_set_images(
            self._h, _ptr(s, ctypes.c_int32), _ptr(q, ctypes.c_double),
            _ptr(t, ctypes.c_int32), int(s.shape[1]), int(s.shape[0]),
            float(scale))

    def run(self, xs, ys):
        if self._imgs is None:
            raise RuntimeError("call set_images first")
        xs = np.ascontiguousarray(xs, np.int32).ravel()
        ys = np.ascontiguousarray(ys, np.int32).ravel()
        n = len(xs)
        codes = np.empty(n, np.int32)
        sums = np.empty(n, np.float64)
        self._lib.clfd_oracle_run(
            self._h, _ptr(xs, ctypes.c_int32), _ptr(ys, ctypes.c_int32), n,
            _ptr(codes, ctypes.c_int32), _ptr(sums, ctypes.c_double))
        return codes, sums

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.clfd_oracle_destroy(self._h)
            self._h = None


def oracle_candidates(gray: np.ndarray, spec, mode: str = "scale_image",
                      scale_factor: float = 1.1,
                      min_size: Tuple[int, int] = (0, 0)
                      ) -> Tuple[List[Tuple[int, int, int, int]], int, float]:
    """A full-depth detection sweep of ``gray`` by ``COracle``: the
    candidates (x, y, w, h) in frame pixels, the windows evaluated and
    the seconds spent in C.

    ``"scale_image"``: per level the pinned resize, the integrals and the
    codes over the scan lattice (ystep = factor > 2 ? 1 : 2,
    tempcv.cpp:1015-1020).  ``"scale_cascade"``: one set of integrals,
    the features rescaled per scale in C, and the skip-by-2 walk
    (ScaleCascade_Invoker, tempcv.cpp:1139-1170) replayed on the codes of
    the whole grid (a skipped window never decides which later windows
    are visited)."""
    from ..detect.reference_impl import integrals
    from ..models import cv_round, scale_factors, scan_grid
    from ..ops.resize import resize_bilinear_u8_np
    if mode not in ("scale_image", "scale_cascade"):
        raise ValueError(f"unknown mode {mode!r}")
    H, W = gray.shape
    w0, h0 = spec.window_w, spec.window_h
    co = COracle(spec)
    if mode == "scale_cascade":
        planes = integrals(gray, spec.has_tilted)
    out, windows, run_s = [], 0, 0.0
    for f in scale_factors(w0, h0, W, H, scale_factor, min_size, None,
                           mode=mode):
        win_w, win_h = int(cv_round(w0 * f)), int(cv_round(h0 * f))
        if mode == "scale_image":
            sz_h, sz_w = int(cv_round(H / f)), int(cv_round(W / f))
            y2, x2 = sz_h - h0, sz_w - w0
            if y2 <= 0 or x2 <= 0:
                continue
            lvl = resize_bilinear_u8_np(gray, (sz_h, sz_w))
            co.set_images(*integrals(lvl, spec.has_tilted), 1.0)
            step = 1 if f > 2 else 2
            ys, xs = np.meshgrid(np.arange(0, y2, step),
                                 np.arange(0, x2, step), indexing="ij")
            xs, ys = xs.ravel().astype(np.int32), ys.ravel().astype(np.int32)
            t = time.perf_counter()
            codes, _ = co.run(xs, ys)
            run_s += time.perf_counter() - t
            windows += len(xs)
            out += [(int(cv_round(x * f)), int(cv_round(y * f)), win_w, win_h)
                    for x, y in zip(xs[codes == 1], ys[codes == 1])]
            continue
        co.set_images(*planes, f)
        _, xs, ys = scan_grid(W, H, win_w, win_h, f)
        if not len(xs) or not len(ys):
            continue
        gy, gx = np.meshgrid(ys.astype(np.int32), xs.astype(np.int32),
                             indexing="ij")
        t = time.perf_counter()
        codes = co.run(gx.ravel(), gy.ravel())[0].reshape(len(ys), len(xs))
        run_s += time.perf_counter() - t
        windows += codes.size
        for iy in range(len(ys)):
            ix = 0
            while ix < len(xs):
                r = int(codes[iy, ix])
                if r > 0:
                    out.append((int(xs[ix]), int(ys[iy]), win_w, win_h))
                ix += 1 if r != 0 else 2
    return out, windows, run_s
