"""Build and load the hand-written CUDA kernels.

``nvcc`` compiles every ``clfacedetection_torch/csrc/*.cu`` at first
use, one process per source, all started together, and links the objects
into one shared library with a plain C interface in
``clfacedetection_torch/build/``, under a name keyed by a hash of the
sources and flags; ``ctypes`` loads it.  ``ptxas`` reports each kernel's
registers and shared memory into ``<library>.log`` (``build_log()``).
Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``.  Each op's wrapper counts its launches
(``count``: the counter ``launches.<wrapper>`` of ``trace``): a launch
that runs on the card, never one that a CUDA graph capture only records;
a graph's replays are not the wrapper's to count.
A wrapper launches under ``on_device``: the tensor's card made current
only where it is not already.

Flags: ``sm_90a`` (Hopper); ``-fmad=false`` and no fast-math, so that no
multiply-add is contracted behind the source's back (the kernels spell
out the one FMA they need with ``__fmaf_rn``).
"""

from __future__ import annotations

import contextlib
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Optional

from .. import trace

__all__ = ["NVCC_FLAGS", "lib", "check", "count", "on_device", "smem_setups",
           "build_log", "sass"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(_PKG, "build")

_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = _ARCH + ["-std=c++17", "-O3", "-fmad=false", "-Xcompiler",
                      "-fPIC", "-Xptxas=-v"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_path: Optional[str] = None

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures: every pointer and the stream are c_void_p
_SIGNATURES = {
    "clfd_haar_front": [_P] * 8 + [_I] * 15 + [_F, _P],
    "clfd_compact": [_P] * 4 + [_I] * 5 + [_P],
    "clfd_haar_tail2": [_P] * 5 + [_I] * 8 + [_P],
    "clfd_haar_tail": [_P] * 5 + [_I] * 9 + [_P],
    "clfd_tail_rows": [_P] * 6 + [_I] * 9 + [_P],
    "clfd_tail_walk": [_P] * 8 + [_I] * 14 + [_P],
    "clfd_chain": [_P] * 2 + [_I] * 4 + [_P],
    "clfd_smem_setups": [],
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


def _run(cmd):
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _finish(procs, names):
    """Wait for every process, then raise on the first that failed."""
    outs = [p.communicate() for p in procs]
    for p, name, (out, err) in zip(procs, names, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name} ({p.returncode}):\n"
                               f"{out}\n{err}")
    return [out + err for out, err in outs]


def _build() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        with open(p, "rb") as f:
            h.update(os.path.basename(p).encode() + f.read())
    out = os.path.join(_BUILD, f"libclfd_kernels_{h.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{out}.{os.getpid()}"
    cu = [p for p in _sources() if p.endswith(".cu")]
    objs = [f"{tmp}.{os.path.basename(p)}.o" for p in cu]
    procs = [_run([_nvcc()] + NVCC_FLAGS + ["-c", "-o", o, p])
             for p, o in zip(cu, objs)]
    logs = _finish(procs, [os.path.basename(p) for p in cu])
    _finish([_run([_nvcc()] + _ARCH + ["-shared", "-o", f"{tmp}.tmp"]
                  + objs)], ["the link"])
    for o in objs:
        os.remove(o)
    with open(f"{out}.log", "w") as f:
        f.write("".join(logs))
    os.replace(f"{tmp}.tmp", out)
    return out


def build_log() -> str:
    """What ``ptxas`` said of each kernel (registers, shared memory,
    spills) when the library was built."""
    lib()
    with open(f"{_lib_path}.log") as f:
        return f.read()


def sass() -> str:
    """The library's SASS, as ``cuobjdump -sass`` (beside ``nvcc``) prints
    it."""
    lib()
    tool = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    return subprocess.run([tool, "-sass", _lib_path], capture_output=True,
                          text=True, check=True, timeout=300).stdout


def lib() -> ctypes.CDLL:
    """The kernel library, built on first call."""
    global _lib, _lib_path
    with _lock:
        if _lib is None:
            t0 = time.perf_counter()
            _lib_path = _build()
            handle = ctypes.CDLL(_lib_path)
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
            trace.count("kernels.library_s", time.perf_counter() - t0)
        return _lib


def check(name: str, err: int) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def on_device(device):
    """The context a launch on ``device`` (a CUDA tensor's device) runs in:
    ``torch.cuda.device(device)`` where another card is current, else
    none, so that a launch on the current card pays for no device
    switch."""
    import torch
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def smem_setups() -> int:
    """How many times the process has read a card's shared-memory limits
    for a kernel (``csrc/launch.cuh`` ``ClfdSmem``): once per kernel and
    device."""
    return int(lib().clfd_smem_setups())


def count(wrapper, more: Optional[dict] = None) -> None:
    """One more launch of ``wrapper``'s kernel (the counter
    ``launches.<wrapper's name>``), and ``more``'s amounts added to its
    counters, unless the current stream is capturing a CUDA graph: the
    capture records the launch and runs nothing."""
    import torch
    if not torch.cuda.is_current_stream_capturing():
        trace.count(f"launches.{wrapper.__name__}")
        for name, n in (more or {}).items():
            trace.count(name, n)
