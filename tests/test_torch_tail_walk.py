"""The v1 route's walk (plain twin of csrc/tail_walk.cu) against the
pair it replaces on the default strategy and against the JAX package.

* Bits: ``tail_walk_plain`` equals ``tail_rows_plain(tail_values_plain(
  ...))`` in all four columns (vnf, alive, exit stage, stage sum), float32
  and float64, for CART (frontalface_alt2), tilted CART
  (eye_tree_eyeglasses), a stage tree (frontalface_alt_tree cut to 12
  stages), a 45x11 window (mcs_eyepair_big) and stumps
  (frontalface_alt), over B = 2 frames with unequal survivor counts and
  padding between the live slots; also with every slot padding, with
  ``front_k`` at the last stage and past it, each stage run over every
  slot under a mask (the CUDA graph's way), and in small chunks.  The walk
  evaluates a stage only for the survivors that enter it, so this
  equality is the proof that leaving the rest out changes no bit.
* JAX: the default route's rows (``PyramidDetector._tail_v1``) against
  the JAX XLA tail ``_tail_device_xla`` on JAX's survivors, at
  docs/PARITY.md's bounds as ``test_torch_tail.py`` holds the pair:
  alive-set Jaccard >= 0.995 and >= 99.5% of survivors with the same exit
  stage (the stage tree's accept only).
* Routes: the default strategy calls ``tail_walk``, ``"block"``
  ``haar_tail`` then ``tail_rows``, ``"direct"`` the stencil product then
  ``tail_rows``, float64 and ``plain=True`` ``tail_walk_plain``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clfacedetection_tpu.detect.pyramid import PyramidDetector as JDet
from clfacedetection_tpu.models import load_cascade as j_load_cascade
from clfacedetection_tpu.utils import synth_scene

from clfacedetection_torch import trace
from clfacedetection_torch.detect import pyramid as tpyramid
from clfacedetection_torch.detect.pyramid import PyramidDetector as TDet
from clfacedetection_torch.models import load_cascade as t_load_cascade
from clfacedetection_torch.ops import tail_walk as twalk
from clfacedetection_torch.ops.compact_kernel import compact_plain
from clfacedetection_torch.ops.haar_front import front_plain
from clfacedetection_torch.ops.haar_tail import tail_values_plain
from clfacedetection_torch.ops.tail_rows import tail_rows_plain
from clfacedetection_torch.ops.tail_walk import (tail_walk, tail_walk_plain,
                                                 walk_plan)

# The suite runs in several worker processes at once; one torch thread
# each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

SHAPE = (120, 160)
CASES = [                              # (cascade, max_stages, front)
    ("haarcascade_frontalface_alt2", None, 3),      # CART, T=2
    ("haarcascade_eye_tree_eyeglasses", None, 3),   # CART, T=3, tilted
    ("haarcascade_frontalface_alt_tree", 12, 5),    # stage tree
    ("haarcascade_mcs_eyepair_big", None, 3),       # 45x11 window, tilted
    ("haarcascade_frontalface_alt", 10, 3),         # stumps
]
SEEDS = ((9, ((60, 80, 40.0),)), (4, ((50, 60, 30.0),)))


@functools.lru_cache(maxsize=None)
def _det(name, max_stages, front):
    return TDet(t_load_cascade(name), SHAPE, front_stages=front,
                max_stages=max_stages, device="cpu")


def _frames():
    return np.stack([synth_scene(SHAPE, faces=f, seed=s) for s, f in SEEDS])


def _inputs(td, dtype=torch.float32):
    """The front's survivors of two frames, each frame's in order with a
    pad slot after every third and a -1 slot, then padding to a common
    cap that is no multiple of 16 or 32; their vnf; the planes."""
    frames = torch.from_numpy(_frames())
    ii = td._prep_planes(frames)
    mask, vnf = front_plain(ii.sum, ii.sq_hi, ii.sq_lo, td._visit, td.table,
                            td.front_k, dtype, tilted=ii.tilted)
    n = td.hv * td.wv
    surv, cnt = compact_plain(mask.reshape(2, -1), n)
    rows = []
    for b in range(2):
        sl = []
        for i, v in enumerate(surv[b, :int(cnt[b])].tolist()):
            sl.append(v)
            if i % 3 == 2:
                sl.append(n)
        sl.insert(len(sl) // 2, -1)
        rows.append(sl)
    assert len(rows[0]) != len(rows[1]) and min(map(len, rows)) > 1
    cap = max(map(len, rows)) + 7
    if cap % 16 == 0:
        cap += 1
    st = torch.full((2, cap), n, dtype=torch.int32)
    for b, sl in enumerate(rows):
        st[b, :len(sl)] = torch.tensor(sl, dtype=torch.int32)
    ok = (st >= 0) & (st < n)
    svnf = vnf.reshape(2, -1).gather(1, torch.where(ok, st, 0).long())
    return ii, st, svnf


def _pair(td, ii, st, svnf, front_k=None):
    """The pair the walk replaces: every node's value, then the rows."""
    fk = td.front_k if front_k is None else front_k
    values = tail_values_plain(ii.sum, ii.tilted, st, td.hv, td.wv,
                               td.table, svnf.dtype)
    return tail_rows_plain(values, svnf, st, td.hv * td.wv, td.table, fk,
                           td.paths if td.is_tree else None)


def _walk(td, ii, st, svnf, front_k=None, **kw):
    fk = td.front_k if front_k is None else front_k
    return tail_walk_plain(ii.sum, ii.tilted, svnf, st, td.hv, td.wv,
                           td.table, fk, td.paths if td.is_tree else None,
                           **kw)


def _same_bits(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    iv = torch.int64 if a.dtype == torch.float64 else torch.int32
    np.testing.assert_array_equal(a.view(iv).numpy(), b.view(iv).numpy())


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name,max_stages,front", CASES)
def test_walk_equals_values_then_rows(name, max_stages, front, dtype):
    """Every column of every slot, padding interleaved, B = 2 with unequal
    counts; the masked walk and each frame alone give the same bits."""
    td = _det(name, max_stages, front)
    ii, st, svnf = _inputs(td, getattr(torch, dtype))
    want = _pair(td, ii, st, svnf)
    got = _walk(td, ii, st, svnf)
    _same_bits(got, want)
    _same_bits(_walk(td, ii, st, svnf, masked=True), want)
    for b in range(2):
        one = tail_walk_plain(ii.sum[b:b + 1], None if ii.tilted is None
                              else ii.tilted[b:b + 1], svnf[b:b + 1],
                              st[b:b + 1], td.hv, td.wv, td.table,
                              td.front_k, td.paths if td.is_tree else None)
        _same_bits(one[0], got[b])
    ok = (st >= 0) & (st < td.hv * td.wv)
    S = td.n_stages
    np.testing.assert_array_equal(
        got[~ok].numpy(), np.tile(np.array([0, 0, S, 0], got.numpy().dtype),
                                  (int((~ok).sum()), 1)))
    if td.is_tree:                                 # both outcomes occur
        assert 0 < int((got[..., 1][ok] > 0).sum()) < int(ok.sum())
    else:                                          # exits at many stages
        assert len(torch.unique(got[..., 2][ok])) > 2


@pytest.mark.parametrize("name,max_stages,front", CASES)
def test_walk_edge_cases(name, max_stages, front):
    """Every slot padding; ``front_k`` at the last stage and past it (a
    stage tree then walks from stage 0: the prefix it may skip is the
    common one)."""
    td = _det(name, max_stages, front)
    ii, st, svnf = _inputs(td)
    S = td.n_stages
    pad = torch.full_like(st, td.hv * td.wv)
    rows = _walk(td, ii, pad, svnf)
    np.testing.assert_array_equal(
        rows.numpy(), np.tile(np.float32([0, 0, S, 0]), (2, st.shape[1], 1)))
    for fk in (S - 1, S):
        _same_bits(_walk(td, ii, st, svnf, fk), _pair(td, ii, st, svnf, fk))
        _same_bits(_walk(td, ii, st, svnf, fk, masked=True),
                   _pair(td, ii, st, svnf, fk))


def test_walk_chunks_keep_every_bit(monkeypatch):
    """The plain walk's stages in chunks of a few classifiers give the
    same bits as one chunk each."""
    td = _det("haarcascade_eye_tree_eyeglasses", None, 3)
    ii, st, svnf = _inputs(td)
    want = _walk(td, ii, st, svnf)
    monkeypatch.setattr(twalk, "_CHUNK_ELEMS", 3 * 12 * 3 * 800)
    _same_bits(_walk(td, ii, st, svnf), want)


@pytest.mark.parametrize("name,max_stages,front", [CASES[0], CASES[2]])
def test_walk_enters_only_needed_stages(name, max_stages, front,
                                        monkeypatch):
    """The windows each stage is evaluated at: a sequential cascade's
    survivors from ``front_k`` to their exit stage; a stage tree's where
    the stage is a root or its parent passed, and path 0's leaf at every
    survivor."""
    td = _det(name, max_stages, front)
    ii, st, svnf = _inputs(td)
    seen = {}
    real = twalk._stage_sums

    def spy(flat, base, vnf, table, stage, *rest):
        seen[stage] = base.numel()
        return real(flat, base, vnf, table, stage, *rest)

    monkeypatch.setattr(twalk, "_stage_sums", spy)
    rows = _walk(td, ii, st, svnf)
    ok = ((st >= 0) & (st < td.hv * td.wv)).reshape(-1)
    lv = rows[..., 2].reshape(-1)[ok].long()
    S, fk = td.n_stages, td.front_k
    if not td.is_tree:
        want = {s: int((lv >= s).sum()) for s in range(fk, S)}
        assert {s: c for s, c in seen.items()} == \
            {s: c for s, c in want.items() if c}
        return
    s_lo, parents, leaf0 = walk_plan(td.table, fk, td.paths)
    assert s_lo == fk and leaf0 == td.paths[0][-1]
    n_ok = int(ok.sum())
    assert seen[s_lo] == n_ok and seen[leaf0] == n_ok
    # a stage below a failed parent is skipped: fewer windows than slots
    assert min(seen.values()) < n_ok
    assert sum(seen.values()) < n_ok * (S - s_lo)


def test_walk_plan():
    """The first stage walked, the parents and path 0's leaf; a parent
    after its stage, a stage with two parents or on no path raise."""
    seq = _det("haarcascade_frontalface_alt2", None, 3)
    assert walk_plan(seq.table, 3) == (3, None, -1)
    assert walk_plan(seq.table, 99)[0] == seq.n_stages
    td = _det("haarcascade_frontalface_alt_tree", 12, 5)
    s_lo, parents, leaf0 = walk_plan(td.table, 5, td.paths)
    assert s_lo == 5 and leaf0 == td.paths[0][-1]
    for p in td.paths:
        assert parents[p[0]] == -1
        assert all(parents[b] == a for a, b in zip(p, p[1:]))
    assert (parents < np.arange(td.n_stages)).all()
    # a prefix that a path leaves, or a leaf inside it: walk from stage 0
    assert walk_plan(td.table, 6, td.paths)[0] == 0
    chain = [list(range(12))]
    assert walk_plan(td.table, 5, chain)[0] == 5
    with pytest.raises(ValueError, match="does not come before"):
        walk_plan(td.table, 5, [[0, 1, 2, 3, 4, 6, 5, 7, 8, 9, 10, 11]])
    with pytest.raises(ValueError, match="two parents"):
        walk_plan(td.table, 5, [list(range(12)), [0, 2, 3, 4, 5, 6, 7, 8,
                                                  9, 10, 11]])
    with pytest.raises(ValueError, match="no root-to-leaf"):
        walk_plan(td.table, 5, [list(range(11))])


def test_walk_rejects_bad_inputs():
    td = _det("haarcascade_eye_tree_eyeglasses", None, 3)
    ii, st, svnf = _inputs(td)
    args = (td.hv, td.wv, td.table, td.front_k)
    launches = trace.counters().get("launches.tail_walk", 0)
    _same_bits(tail_walk(ii.sum, ii.tilted, svnf, st, *args),
               _walk(td, ii, st, svnf))
    # CPU: the plain twin
    assert trace.counters().get("launches.tail_walk", 0) == launches
    with pytest.raises(ValueError, match="tilted"):
        tail_walk(ii.sum, None, svnf, st, *args)
    with pytest.raises(ValueError, match="int32"):
        tail_walk(ii.sum, ii.tilted, svnf, st.long(), *args)
    with pytest.raises(ValueError, match="svnf"):
        tail_walk(ii.sum, ii.tilted, svnf[:, 1:], st, *args)
    with pytest.raises(ValueError, match="too small"):
        tail_walk(ii.sum[:, :-30].contiguous(),
                  ii.tilted[:, :-30].contiguous(), svnf, st, *args)
    with pytest.raises(ValueError, match="front_k"):
        tail_walk(ii.sum, ii.tilted, svnf, st, td.hv, td.wv, td.table,
                  td.n_stages + 1)


@functools.lru_cache(maxsize=None)
def _jax_det(name, max_stages, front):
    """A JAX detector and its jitted front, compaction and XLA tail, made
    once per file for each configuration."""
    jd = JDet(j_load_cascade(name), SHAPE, front_stages=front,
              max_stages=max_stages, dtype=jnp.float32, output_levels=True,
              use_pallas_front=False, cap=4096)
    return (jd, jax.jit(jd._front_device), jax.jit(jd._compact_device),
            jax.jit(jd._tail_device_xla))


@pytest.mark.parametrize("name,max_stages,front", CASES[:4] + [
    ("haarcascade_mcs_nose", None, 3)])             # tilted stumps
def test_default_route_against_jax(name, max_stages, front, monkeypatch):
    """The default v1 route on JAX's survivors and vnf: its accepted set
    and exit stages against JAX's XLA tail in the PARITY bounds, its pad
    slots (0, 0, S, 0); the route ran the walk."""
    frame = synth_scene(SHAPE, faces=SEEDS[0][1], seed=SEEDS[0][0])
    jd, front_fn, compact_fn, tail_fn = _jax_det(name, max_stages, front)
    f = front_fn(jnp.asarray(frame))
    surv, n_surv = compact_fn(f["front"])
    n = int(n_surv)
    assert 0 < n <= jd.cap
    jt = tail_fn(f["planes"], f["vnf"], surv, n_surv)
    td = TDet(t_load_cascade(name), SHAPE, front_stages=jd.front_k,
              max_stages=max_stages, device="cpu")
    assert td.front_k == jd.front_k and not td.use_tail2
    calls = []
    monkeypatch.setattr(tpyramid, "tail_walk", lambda *a: calls.append(1)
                        or tail_walk(*a))
    ii = td._prep_planes(torch.from_numpy(frame)[None])
    vnf = torch.from_numpy(np.array(f["vnf"]).reshape(1, td.hv, td.wv))
    rows = td._tail_v1(ii.sum, ii.tilted, vnf,
                       torch.from_numpy(np.array(surv, np.int32))[None])[0]
    assert calls == [1]
    alive = rows[:n, 1].numpy() > 0
    ok = np.asarray(jt["ok"])[:n]
    union = (alive | ok).sum()
    assert union == 0 or (alive & ok).sum() / union >= 0.995
    if not td.is_tree:
        same = rows[:n, 2].numpy().astype(np.int32) == \
            np.asarray(jt["level"])[:n]
        assert same.mean() >= 0.995, f"{(~same).sum()} of {n} levels differ"
    np.testing.assert_array_equal(
        rows[n:].numpy(),
        np.tile(np.float32([0, 0, td.n_stages, 0]), (jd.cap - n, 1)))


ROUTE_NAMES = ("tail_walk", "tail_walk_plain", "haar_tail",
               "tail_values_plain", "tail_rows", "tail_rows_plain",
               "stencil_values", "haar_tail2", "tail2_plain")


@pytest.mark.parametrize("strategy,dtype,plain,want", [
    (None, "float32", False, {"tail_walk"}),
    ("per_stage", "float32", False, {"tail_walk"}),
    ("block", "float32", False, {"haar_tail", "tail_rows"}),
    ("direct", "float32", False, {"stencil_values", "tail_rows"}),
    (None, "float32", True, {"tail_walk_plain"}),
    (None, "float64", False, {"tail_walk_plain"}),
    ("block", "float64", False, {"tail_values_plain", "tail_rows_plain"}),
])
def test_routes(strategy, dtype, plain, want, monkeypatch):
    """Which tail functions each route calls (spies on the pipeline's
    names), and the default and ``"block"`` routes' candidates equal."""
    spec = t_load_cascade("haarcascade_frontalface_alt2")
    td = TDet(spec, SHAPE, max_stages=6, strategy=strategy,
              dtype=getattr(torch, dtype), device="cpu")
    calls = set()
    for fn in ROUTE_NAMES:
        real = getattr(tpyramid, fn)

        def spy(*a, _real=real, _fn=fn, **kw):
            calls.add(_fn)
            return _real(*a, **kw)
        monkeypatch.setattr(tpyramid, fn, spy)
    frames = torch.from_numpy(_frames()[:1])
    got = td.readback(td._detect_device(frames, td.cap, plain=plain),
                      td.cap)[0][0]
    assert calls == want
    if strategy == "block":
        ref = TDet(spec, SHAPE, max_stages=6, dtype=getattr(torch, dtype),
                   device="cpu")
        np.testing.assert_array_equal(
            got, ref.readback(ref._detect_device(frames, ref.cap),
                              ref.cap)[0][0])
    assert len(got) > 0


def test_stump_cascade_default_route_takes_tail2(monkeypatch):
    """A stump cascade that tail2 serves keeps tail2 on the default
    route, and takes the pair on ``"block"``: the walk serves only the
    cascades tail2 refuses."""
    spec = t_load_cascade("haarcascade_frontalface_alt")
    frames = torch.from_numpy(_frames()[:1])
    for strategy, want in ((None, {"haar_tail2"}),
                           ("block", {"haar_tail", "tail_rows"})):
        calls = set()
        for fn in ROUTE_NAMES:
            real = getattr(tpyramid, fn)

            def spy(*a, _real=real, _fn=fn, **kw):
                calls.add(_fn)
                return _real(*a, **kw)
            monkeypatch.setattr(tpyramid, fn, spy)
        td = TDet(spec, SHAPE, max_stages=6, strategy=strategy,
                  device="cpu")
        td._detect_device(frames, td.cap)
        assert calls == want
        monkeypatch.undo()
