"""Build and load the hand-written CUDA kernels.

``nvcc`` compiles every ``clfacedetection_torch/csrc/*.cu`` into one
shared library with a plain C interface, at first use, into
``clfacedetection_torch/build/`` under a name keyed by a hash of the
sources and flags; ``ctypes`` loads it.  Each C entry point launches on
the stream it is given and returns ``cudaGetLastError()``.

Flags: ``sm_90a`` (Hopper); ``-fmad=false`` and no fast-math, so that no
multiply-add is contracted behind the source's back (the kernels spell
out the one FMA they need with ``__fmaf_rn``).
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

__all__ = ["NVCC_FLAGS", "lib", "check"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(_PKG, "build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures: every pointer and the stream are c_void_p
_SIGNATURES = {
    "clfd_haar_front": [_P] * 8 + [_I] * 11 + [_F, _P],
    "clfd_compact_count": [_P, _P, _I, _I, _I, _P],
    "clfd_compact_scan": [_P, _P, _P, _I, _I, _P],
    "clfd_compact_scatter": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "clfd_haar_tail2": [_P] * 5 + [_I] * 8 + [_P],
    "clfd_haar_tail": [_P] * 5 + [_I] * 11 + [_P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return path


def _sources():
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu"))
                  + glob.glob(os.path.join(_CSRC, "*.cuh")))


def _build() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        with open(p, "rb") as f:
            h.update(os.path.basename(p).encode() + f.read())
    out = os.path.join(_BUILD, f"libclfd_kernels_{h.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cu = [p for p in _sources() if p.endswith(".cu")]
    proc = subprocess.run([_nvcc()] + NVCC_FLAGS + ["-o", tmp] + cu,
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(_build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
        return _lib


def check(name: str, err: int) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
