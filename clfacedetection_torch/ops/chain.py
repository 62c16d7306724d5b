"""Op-chain microbenchmark kernel: CUDA kernel and its plain twin.

Port of the TPU kernel ``scripts/mb_vpu3.py`` ``chain_call`` and of the
four trip bodies that its ``main()`` times (``mb_vpu3.py:83-114``), plus
the empty body of its dispatch sweep (``:75-80``).  ``x`` is float32
``[gh, 384]``; the result ``[gh, gw]`` holds, at row ``r`` and column
``o``, the chain over row ``r`` from column ``o % 256``: ``acc`` starts
at ``x[r, c]`` and each of ``trips`` trips applies the body.  So the
``[gh, 256]`` chain block repeats ``gw / 256`` times across, as on the
TPU grid, and the kernel (``csrc/mb_chain.cu``) computes every output.
``chain_plain`` is the specification and matches the kernel bit for bit
(float32, every operation rounded on its own).

The kernel's thread runs C contiguous columns of one row (a width fixed
by body in the kernel, which its SASS names) and loads its row window
from shared memory once a trip, 16 bytes at a time:
``window_words(body, C)`` words, the offsets of ``OFFSETS`` rounded out
to 16-byte groups.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from .. import kernels

__all__ = ["chain", "chain_plain", "BODIES", "OPS_PER_TRIP", "FLOAT_OPS",
           "OFFSETS", "window_words", "GH", "GW",
           "BH", "BW", "IN_W"]

GH, GW = 2272, 1280        # the JAX's grid: the 1080p front's padded canvas
BH, BW = 32, 256           # its block; BW columns make one chain block
IN_W = BW + 128            # row width of x

_F32 = np.float32


def _empty_trip(x, acc, t):
    return acc


def _slices_trip(x, acc, t):
    for i in range(32):
        c = (i * 7 + 3) % 100
        acc = acc + x[:, c:c + BW]
    return acc * float(_F32(0.5))


def _arith_trip(x, acc, t):
    x0 = x[:, 7:7 + BW]
    for i in range(16):
        s = float(_F32(t) + _F32(i))
        acc = torch.maximum(acc * float(_F32(0.9999)), x0 * s)
    return acc


def _cmpsel_trip(x, acc, t):
    x0 = x[:, 3:3 + BW]
    for i in range(16):
        c = acc < x0 * float(_F32(0.5 + i * 0.01))
        acc = acc + torch.where(c, float(_F32(0.25)), float(_F32(-0.25)))
    return acc


def _rect_trip(x, acc, t):
    for i in range(16):
        c = (i * 7 + 3) % 50
        d = (i * 11 + 17) % 50
        acc = acc + (x[:, c:c + BW] - x[:, d:d + BW]) * float(_F32(0.01))
    return acc


#: body name -> (plain trip, the kernel's body code)
_TRIPS: Dict[str, Tuple[Callable, int]] = {
    "empty": (_empty_trip, 0), "slices": (_slices_trip, 1),
    "arith": (_arith_trip, 2), "cmpsel": (_cmpsel_trip, 3),
    "rect": (_rect_trip, 4)}
BODIES = tuple(_TRIPS)
#: the JAX's operations a trip (mb_vpu3.py bench(..., ops_per_trip))
OPS_PER_TRIP = {"empty": 0, "slices": 33, "arith": 48, "cmpsel": 64,
                "rect": 80}
#: the arithmetic among them a trip (rect's 80 count its 32 slices too)
FLOAT_OPS = {"empty": 0, "slices": 33, "arith": 48, "cmpsel": 64,
             "rect": 48}
#: the column offsets from an element that a trip reads
OFFSETS = {"empty": (), "slices": tuple((i * 7 + 3) % 100 for i in range(32)),
           "arith": (7,), "cmpsel": (3,),
           "rect": tuple(sorted({v for i in range(16)
                                 for v in ((i * 7 + 3) % 50,
                                           (i * 11 + 17) % 50)}))}


def window_words(body: str, cols: int) -> int:
    """Words of shared memory that one trip of the kernel loads for a
    thread of ``cols`` columns: its offsets' span, rounded out to 16-byte
    groups (a thread's first column starts one)."""
    off = OFFSETS[body]
    if not off:
        return 0
    lo = min(off) // 4 * 4
    hi = -(-(cols + max(off)) // 4) * 4
    return hi - lo


def _check(x: torch.Tensor, body: str, trips: int, gw: int) -> None:
    if body not in _TRIPS:
        raise ValueError(f"unknown body {body!r}; one of {BODIES}")
    if x.dtype != torch.float32 or x.ndim != 2 or x.shape[1] != IN_W \
            or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous float32 [gh, {IN_W}] "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")
    if x.shape[0] < 1 or x.shape[0] % BH or gw < BW or gw % BW:
        raise ValueError(f"need gh a multiple of {BH} and gw of {BW}, got "
                         f"{x.shape[0]}, {gw}")
    if trips < 0:
        raise ValueError(f"trips must be >= 0, got {trips}")


def chain_plain(x: torch.Tensor, body: str, trips: int,
                gw: int = GW) -> torch.Tensor:
    """float32 [gh, gw]: the chain block [gh, 256], computed once and
    repeated ``gw / 256`` times across."""
    _check(x, body, trips, gw)
    fn = _TRIPS[body][0]
    acc = x[:, 0:BW]
    for t in range(trips):
        acc = fn(x, acc, t)
    return acc.repeat(1, gw // BW)


def chain(x: torch.Tensor, body: str, trips: int,
          gw: int = GW) -> torch.Tensor:
    """The op chain ``body`` over ``trips`` trips, float32 [gh, gw].  CPU
    tensors run ``chain_plain``; CUDA tensors launch the kernel."""
    _check(x, body, trips, gw)
    if x.device.type == "cpu":
        return chain_plain(x, body, trips, gw)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned (the kernel stages its "
                         "rows with 16-byte loads)")
    gh = x.shape[0]
    out = torch.empty((gh, gw), dtype=torch.float32, device=x.device)
    with kernels.on_device(x.device):
        err = kernels.lib().clfd_chain(
            x.data_ptr(), out.data_ptr(), gh, gw, _TRIPS[body][1], int(trips),
            torch.cuda.current_stream(x.device).cuda_stream)
    kernels.check("clfd_chain", err)
    kernels.count(chain)
    return out
