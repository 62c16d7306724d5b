"""Ordered stream compaction: CUDA kernel and its plain twin.

Port of the TPU kernel ``clfacedetection_tpu/ops/compact_kernel.py``
(``build_compact_kernel``) with the contract of the XLA ``_compact``
(``pyramid.py:119-135``): per frame, the ascending flat indices of the
first ``cap`` set flags, padded with the flag count ``n``, and the TRUE
number of set flags (``> cap`` signals overflow).  On the port's path it
runs twice per frame: over the front mask (survivors) and over the tail's
alive flags (accepts).  It never syncs the host, where ``torch.nonzero``
would.
"""

from __future__ import annotations

import torch

from .. import kernels

__all__ = ["compact", "compact_plain", "TILE"]

TILE = 2048   # flags per tile of csrc/compact.cu (kThreads * kPasses)


def compact_plain(flags: torch.Tensor, cap: int):
    """(idx int32 [B, cap], n int32 [B]) from bool flags [B, n]: one
    exclusive cumsum and one scatter, as ``_compact`` does."""
    B, n = flags.shape
    ones = flags.to(torch.int32)
    pos = torch.cumsum(ones, dim=1, dtype=torch.int32) - ones
    total = pos[:, -1] + ones[:, -1]
    slot = torch.where(flags & (pos < cap), pos, cap).long()
    src = torch.arange(n, dtype=torch.int32, device=flags.device)
    out = torch.full((B, cap + 1), n, dtype=torch.int32, device=flags.device)
    out.scatter_(1, slot, src.expand(B, n))
    return out[:, :cap].contiguous(), total


def compact(flags: torch.Tensor, cap: int):
    """Ordered compaction of bool flags [B, n] into ``cap`` slots.  CPU
    tensors run ``compact_plain``; CUDA tensors launch the kernel."""
    if flags.dtype != torch.bool or flags.ndim != 2 \
            or not flags.is_contiguous():
        raise ValueError("flags must be a contiguous bool [B, n] tensor")
    B, n = flags.shape
    cap = int(cap)
    if cap < 1 or n < 1:
        raise ValueError(f"need cap >= 1 and n >= 1, got {cap}, {n}")
    if flags.device.type == "cpu":
        return compact_plain(flags, cap)
    if flags.device.type != "cuda":
        raise ValueError(f"unsupported device {flags.device}")
    dev = flags.device
    n_tiles = -(-n // TILE)
    counts = torch.empty((B, n_tiles), dtype=torch.int32, device=dev)
    offsets = torch.empty((B, n_tiles), dtype=torch.int32, device=dev)
    total = torch.empty((B,), dtype=torch.int32, device=dev)
    out = torch.empty((B, cap), dtype=torch.int32, device=dev)
    lib = kernels.lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    kernels.check("clfd_compact_count", lib.clfd_compact_count(
        flags.data_ptr(), counts.data_ptr(), n, n_tiles, B, stream))
    kernels.check("clfd_compact_scan", lib.clfd_compact_scan(
        counts.data_ptr(), offsets.data_ptr(), total.data_ptr(), n_tiles, B,
        stream))
    kernels.check("clfd_compact_scatter", lib.clfd_compact_scatter(
        flags.data_ptr(), offsets.data_ptr(), total.data_ptr(),
        out.data_ptr(), n, n_tiles, cap, B, stream))
    compact.launches += 1
    return out, total


compact.launches = 0
