"""The port's ordered compaction (plain twin of csrc/compact.cu) against
the JAX package's ``_compact`` and ``_compact_hier``.  Indices, their
raster order and the TRUE count must be EQUAL, empty, full and
overflowing (n > cap) masks included."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clfacedetection_tpu.detect.pyramid import _compact, _compact_hier

from clfacedetection_torch import trace
from clfacedetection_torch.ops import compact_kernel as tcompact

# The suite runs in several worker processes at once; one torch thread
# each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

N = 5000


def _flags(rate, seed, n=N):
    rng = np.random.default_rng(seed)
    if rate == 0:
        return np.zeros(n, bool)
    if rate == 1:
        return np.ones(n, bool)
    return rng.random(n) < rate


@pytest.mark.parametrize("rate", [0.0, 0.001, 0.05, 0.5, 1.0])
@pytest.mark.parametrize("cap", [1, 64, 700, N])
def test_compact_equals_jax(rate, cap):
    flags = np.stack([_flags(rate, 11), _flags(rate, 12)])
    launches = trace.counters().get("launches.compact", 0)
    idx, n = tcompact.compact(torch.from_numpy(flags), cap)
    # CPU: plain twin
    assert trace.counters().get("launches.compact", 0) == launches
    assert idx.dtype == n.dtype == torch.int32
    assert idx.shape == (2, cap)
    jc = jax.jit(_compact, static_argnums=1)
    for b in range(2):
        jidx, jn = jc(jnp.asarray(flags[b]), cap)
        np.testing.assert_array_equal(idx[b].numpy(), np.asarray(jidx))
        assert int(n[b]) == int(jn) == int(flags[b].sum())
        if int(n[b]) > cap:          # overflow stays visible
            assert int(n[b]) == int(flags[b].sum()) > cap


@pytest.mark.parametrize("rate,cap,n", [(0.001, 256, 128 * 3000),
                                        (0.002, 2048, 128 * 3000),
                                        (0.0, 64, 128 * 3000),
                                        (0.3, 4096, 128 * 160)])
def test_compact_equals_jax_hier(rate, cap, n):
    flags = _flags(rate, 5, n=n)
    jidx, jn = jax.jit(_compact_hier, static_argnums=1)(jnp.asarray(flags),
                                                        cap)
    # capb (alive 128-blocks) must not overflow for the contract to hold
    assert int((flags.reshape(-1, 128).any(1)).sum()) <= max(2048,
                                                            cap // 4)
    idx, n = tcompact.compact(torch.from_numpy(flags)[None], cap)
    np.testing.assert_array_equal(idx[0].numpy(), np.asarray(jidx))
    assert int(n[0]) == int(jn)


def test_compact_rejects_bad_inputs():
    with pytest.raises(ValueError):
        tcompact.compact(torch.zeros((1, 10), dtype=torch.uint8), 4)
    with pytest.raises(ValueError):
        tcompact.compact(torch.zeros((1, 10), dtype=torch.bool), 0)


def test_scratch_cache_reuses_by_key():
    """The compaction's scratch is kept per (device, stream, B, n) key:
    the same key gets the same zeroed buffer, another stream another one.
    No buffer is ever evicted, however many keys come, since a CUDA graph
    may still point at it; and none is made during graph capture.  CPU
    tensors and fake keys stand in for the card's."""
    cache = tcompact.ScratchCache()
    words = tcompact.scratch_words(2, 3 * tcompact.TILE + 1)
    assert words == 2 * 4 + 2           # four tiles a frame, then counters
    key = ("cuda:0", 111, 2, 12289)
    a = cache.get(key, words, "cpu")
    assert a.dtype == torch.int64 and a.numel() == words
    assert not a.any()
    assert cache.get(key, words, "cpu", capturing=True) is a
    b = cache.get(("cuda:0", 222, 2, 12289), words, "cpu")   # other stream
    assert b is not a and len(cache) == 2
    for stream in range(1000, 1040):                         # many keys
        cache.get(("cuda:0", stream, 8, 12289), words * 4, "cpu")
    assert len(cache) == 42
    assert cache.get(key, words, "cpu") is a                 # still held
    with pytest.raises(RuntimeError, match="capture"):
        cache.get(("cuda:0", 333, 2, 12289), words, "cpu", capturing=True)
    assert len(cache) == 42
    with pytest.raises(ValueError):
        cache.get(key, words + 1, "cpu")
