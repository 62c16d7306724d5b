"""Ordered stream compaction: CUDA kernel and its plain twin.

Port of the TPU kernel ``clfacedetection_tpu/ops/compact_kernel.py``
(``build_compact_kernel``) with the contract of the XLA ``_compact``
(``pyramid.py:119-135``): per frame, the ascending flat indices of the
first ``cap`` set flags, padded with the flag count ``n``, and the TRUE
number of set flags (``> cap`` signals overflow).  On the port's path it
runs twice per frame: over the front mask (survivors) and over the tail's
alive flags (accepts).  It never syncs the host, where ``torch.nonzero``
would.

The kernel (``csrc/compact.cu``) is one launch per call: a single-pass
scan with decoupled look-back.  Its scratch (per-tile status words and
three counters) is kept across calls for each device, stream, batch and
flag count (and never freed, so that a CUDA graph can replay the
launch), and cleans itself at the end of every launch, so a call
allocates only its two outputs.
"""

from __future__ import annotations

from typing import Dict

import torch

from .. import kernels

__all__ = ["compact", "compact_plain", "TILE"]

TILE = 16384  # flags per tile of csrc/compact.cu (kThreads * kPer)


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


class ScratchCache:
    """Zero-initialised int64 scratch buffers kept by key, for the life of
    the process: a CUDA graph that captured a launch keeps pointing at its
    buffer, so none is ever freed (each holds a few KB).  The kernel leaves
    a buffer as it found it, so one is reused by every call with the same
    key; the key holds the stream, so that calls on two streams never share
    one.  A buffer is made outside graph capture: made during a capture it
    would come from the graph's pool, its zeroing only recorded."""

    def __init__(self):
        self._bufs: "Dict[tuple, torch.Tensor]" = {}

    def get(self, key: tuple, words: int, device,
            capturing: bool = False) -> torch.Tensor:
        buf = self._bufs.get(key)
        if buf is None:
            if capturing:
                raise RuntimeError(
                    "compact: the first call for a batch, flag count and "
                    "stream must run before a CUDA graph captures it")
            buf = torch.zeros(words, dtype=torch.int64, device=device)
            self._bufs[key] = buf
        if buf.numel() != words:
            raise ValueError(f"scratch for {key} holds {buf.numel()} words, "
                             f"not {words}")
        return buf

    def __len__(self) -> int:
        return len(self._bufs)


_scratch = ScratchCache()


def scratch_words(B: int, n: int) -> int:
    """Words of the kernel's scratch: a status word per tile of every
    frame, then three 32-bit counters (in two words)."""
    return B * -(-n // TILE) + 2


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
    stream = torch.cuda.current_stream(dev).cuda_stream
    key = (str(dev), stream, B, n)
    scratch = _scratch.get(key, scratch_words(B, n), dev,
                           torch.cuda.is_current_stream_capturing())
    out = torch.empty((B, cap), dtype=torch.int32, device=dev)
    total = torch.empty((B,), dtype=torch.int32, device=dev)
    vec = int(flags.data_ptr() % 16 == 0 and n % 16 == 0)
    with torch.cuda.device(dev):
        err = kernels.lib().clfd_compact(
            flags.data_ptr(), scratch.data_ptr(), out.data_ptr(),
            total.data_ptr(), n, -(-n // TILE), cap, B, vec, stream)
    kernels.check("clfd_compact", err)
    kernels.count(compact)
    return out, total


compact.launches = 0
