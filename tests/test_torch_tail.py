"""The port's v1 tail (plain twin of csrc/haar_tail.cu) and its cascade
table against the JAX package.

* Table: ``CascadeTable`` holds JAX ``_build_clf_tables`` at scale 1, and
  its packed buffer decodes back to the same numbers.
* Node values: JAX's own ``_tail_accept_chunk`` arithmetic (window patches
  cut from JAX's planes, corrected, times ``_sten_sum``/``_sten_tilt``
  with ``Precision.HIGHEST``) against ``tail_values_plain``.  The port
  differences the four corners in int32, so its values are the exact node
  values rounded a few times: against float64 node values from the same
  corners it holds rtol 1e-4 with atol 1e-4 of each node's largest
  magnitude (measured: at most 3.7e-6 of that magnitude).  The JAX values
  carry the f32 matrix product's rounding of the patch products, which
  cancel in a rect sum (up to 5e-3 of a node's largest magnitude on these
  scenes, mostly on tilted nodes, whose patches get only the corner-only
  correction).  Against JAX the port is therefore held to rtol 1e-4 plus
  that product's own error bound, 2^-20 * sum |patch * stencil| (16 ulps
  of the absolute products, for at most 12 nonzero terms per node).
* Decisions: ``tail_rows`` on those values against the JAX XLA tail
  ``_tail_device_xla`` built with ``output_levels=True``, at tail2's
  bounds (alive-set Jaccard >= 0.995, >= 99.5% of survivors with the same
  exit stage); the stage tree's accept only.  With padding between the
  live slots and a batch of two unequal frames, the exit stages and stage
  sums too: the stage sums within 1e-4 of JAX's where the exit stages
  agree (JAX sums votes of matrix-product node values in ``jnp.sum``
  order; measured at most 4.6e-5 apart).
* The decisions kernel's table (``CascadeTable.rows``, the path buffer)
  walked the kernel's way in numpy gives ``tail_rows_plain``'s bits.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clfacedetection_tpu.detect import detector as jdetector
from clfacedetection_tpu.detect.pyramid import PyramidDetector as JDet
from clfacedetection_tpu.models import compile as jcompile
from clfacedetection_tpu.models import load_cascade as j_load_cascade
from clfacedetection_tpu.utils import synth_scene

from clfacedetection_torch import kernels, trace
from clfacedetection_torch.detect.pyramid import PyramidDetector as TDet
from clfacedetection_torch.models import load_cascade as t_load_cascade
from clfacedetection_torch.ops import cascade_table as ctab
from clfacedetection_torch.ops import haar_tail as ttail
from clfacedetection_torch.ops import tail_rows as trows
from clfacedetection_torch.ops.tail_rows import tail_rows, tail_rows_plain

# The suite runs in several worker processes at once; one torch thread
# each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

SHAPE = (120, 160)
CASES = [                             # (cascade, max_stages, front)
    ("haarcascade_frontalface_alt2", None, 3),     # CART, T=2
    ("haarcascade_mcs_nose", None, 3),             # tilted stumps
    ("haarcascade_eye_tree_eyeglasses", None, 3),  # CART, T=3, tilted
    ("haarcascade_mcs_eyepair_big", None, 3),      # 45x11 window, tilted
    ("haarcascade_frontalface_alt_tree", 16, 5),   # stage tree
]


@pytest.mark.parametrize("name", ["haarcascade_frontalface_alt2",
                                  "haarcascade_eye_tree_eyeglasses",
                                  "haarcascade_frontalface_alt_tree"])
def test_cascade_table_holds_jax_tables(name):
    jc = jcompile.compile_cascade(j_load_cascade(name))
    jt = jdetector._build_clf_tables(jc, [1.0])
    td = TDet(t_load_cascade(name), SHAPE, device="cpu")
    tab = td.table
    assert (tab.T, tab.n_clf) == (jt.T, jt.n_clf)
    np.testing.assert_array_equal(tab.clf_nodes, jt.clf_valid_nodes)
    np.testing.assert_array_equal(tab.alpha, jt.alpha)
    valid = np.arange(jt.T)[None] < jt.clf_valid_nodes[:, None]
    for mine, theirs in ((tab.left, jt.left), (tab.right, jt.right),
                         (tab.thr, jt.threshold), (tab.tilted, jt.use_tilted)):
        np.testing.assert_array_equal(mine[valid], theirs[valid])
    np.testing.assert_array_equal(tab.stage_thr, jc.stage_threshold)
    # the rects of weight != 0, in order, with JAX's corners and weights
    for c in range(0, jt.n_clf, 7):
        for t in range(int(jt.clf_valid_nodes[c])):
            keep = np.nonzero(jt.weight[0, c, t])[0]
            nr = int(tab.n_rects[c, t])
            assert nr == len(keep)
            np.testing.assert_array_equal(tab.weights[c, t, :nr],
                                          jt.weight[0, c, t, keep])
            np.testing.assert_array_equal(tab.corners[c, t, :nr, :, 0],
                                          jt.corner_y[0, c, t, keep])
            np.testing.assert_array_equal(tab.corners[c, t, :nr, :, 1],
                                          jt.corner_x[0, c, t, keep])
    # the packed buffer decodes back to the arrays
    S = tab.n_stages
    st = tab.packed[:S * ctab.STAGE_WORDS].reshape(S, ctab.STAGE_WORDS)
    np.testing.assert_array_equal(st[:, 0], tab.stage_clf0)
    np.testing.assert_array_equal(st[:, 1], tab.stage_cnt)
    np.testing.assert_array_equal(st[:, 2].view(np.float32), tab.stage_thr)
    assert (st[:, 3] == tab.clf_words).all()
    assert tab.clf_words == ctab.CLF_HEAD + tab.T * ctab.NODE_WORDS
    cl = tab.packed[S * ctab.STAGE_WORDS:].reshape(tab.n_clf, tab.clf_words)
    np.testing.assert_array_equal(cl[:, 0], tab.clf_nodes)
    np.testing.assert_array_equal(cl[:, 1:2 + tab.T].view(np.float32),
                                  tab.alpha)
    nd = cl[:, ctab.CLF_HEAD:].reshape(tab.n_clf, tab.T, ctab.NODE_WORDS)
    np.testing.assert_array_equal(nd[..., 0], tab.n_rects)
    np.testing.assert_array_equal(nd[..., 1], tab.tilted)
    np.testing.assert_array_equal(nd[..., 2], tab.left)
    np.testing.assert_array_equal(nd[..., 3], tab.right)
    np.testing.assert_array_equal(nd[..., 4].view(np.float32), tab.thr)
    np.testing.assert_array_equal(nd[..., 5:8].view(np.float32), tab.weights)
    np.testing.assert_array_equal(nd[..., 8:].reshape(tab.corners.shape),
                                  tab.corners)


@functools.lru_cache(maxsize=None)
def _jax_det(name, max_stages, front):
    """A JAX detector and its jitted front, compaction and XLA tail, made
    once per file for each configuration."""
    jd = JDet(j_load_cascade(name), SHAPE, front_stages=front,
              max_stages=max_stages, dtype=jnp.float32, output_levels=True,
              use_pallas_front=False, cap=4096)
    return (jd, jax.jit(jd._front_device), jax.jit(jd._compact_device),
            jax.jit(jd._tail_device_xla))


def _jax_tail(name, max_stages, front, frame):
    jd, front_fn, compact_fn, tail_fn = _jax_det(name, max_stages, front)
    f = front_fn(jnp.asarray(frame))
    surv, n_surv = compact_fn(f["front"])
    assert 0 < int(n_surv) <= jd.cap
    jt = tail_fn(f["planes"], f["vnf"], surv, n_surv)
    return jd, f, np.asarray(surv), int(n_surv), jt


def _jax_node_values(jd, planes, sy, sx):
    """Node values as ``_tail_accept_chunk`` computes them
    (pyramid.py:676-714), and the absolute-product sums of that matrix
    product (its rounding-error scale)."""
    ph, pw = jd.h0 + 1, jd.w0 + 1
    n = len(sy)

    def patch(img, full):
        img = np.asarray(img)
        raw = np.stack([img[y:y + ph, x:x + pw] for y, x in zip(sy, sx)])
        r = raw - raw[:, :1, :1]
        if full:
            r = r - r[:, :1, :] - r[:, :, :1]
        return r.reshape(n, -1).astype(np.float32)

    dot = lambda a, b: np.asarray(jnp.dot(
        a, b, precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32))
    p_sum = patch(planes["sum"], True)
    vals = dot(p_sum, jd._sten_sum)
    mag = np.abs(p_sum).astype(np.float64) @ np.abs(jd._sten_sum)
    if jd._sten_tilt is not None:
        p_tilt = patch(planes["tilted"], False)
        vals = vals + dot(p_tilt, jd._sten_tilt)
        mag += np.abs(p_tilt).astype(np.float64) @ np.abs(jd._sten_tilt)
    return vals, mag


def _exact_node_values(td, ii, sy, sx):
    """float64 node values from the int32 corners of the port's planes."""
    tab = td.table
    nn = tab.n_clf * tab.T
    cor = tab.corners.reshape(nn, 3, 4, 2)
    w = tab.weights.reshape(nn, 3).astype(np.float64)
    tl = tab.tilted.reshape(nn)
    s = ii.sum[0].numpy().astype(np.int64)
    t = ii.tilted[0].numpy().astype(np.int64) if ii.tilted is not None \
        else s
    out = np.zeros((len(sy), nn))
    for k in range(3):
        for j, sign in enumerate((1, -1, -1, 1)):
            yy = sy[:, None] + cor[None, :, k, j, 0]
            xx = sx[:, None] + cor[None, :, k, j, 1]
            out += sign * np.where(tl[None], t[yy, xx], s[yy, xx]) \
                * w[None, :, k]
    return out


@pytest.mark.parametrize("name,max_stages,front", CASES)
def test_tail_values_and_decisions_against_jax(name, max_stages, front):
    frame = synth_scene(SHAPE, faces=((60, 80, 40.0),), seed=9)
    jd, f, surv, n, jt = _jax_tail(name, max_stages, front, frame)
    td = TDet(t_load_cascade(name), SHAPE, front_stages=jd.front_k,
              max_stages=max_stages, device="cpu")
    assert td.front_k == jd.front_k and not td.use_tail2
    ii = td._prep_planes(torch.from_numpy(frame)[None])
    surv_t = torch.from_numpy(surv.astype(np.int32))[None]
    launches = trace.counters().get("launches.haar_tail", 0)
    vals = ttail.haar_tail(ii.sum, ii.tilted, surv_t, td.hv, td.wv,
                           td.table)[0]
    # CPU: plain twin
    assert trace.counters().get("launches.haar_tail", 0) == launches
    nn = td.table.n_clf * td.table.T
    assert vals.shape == (jd.cap, nn) and vals.dtype == torch.float32
    assert not vals[n:].any()                          # pad slots are 0
    tv = vals[:n].numpy().astype(np.float64)
    sy, sx = surv[:n] // td.wv, surv[:n] % td.wv

    exact = _exact_node_values(td, ii, sy, sx)
    scale = np.abs(exact).max(axis=0)
    assert (np.abs(tv - exact) <= 1e-4 * np.abs(exact) + 1e-4 * scale).all()

    jv, mag = _jax_node_values(jd, f["planes"], sy, sx)
    jv, mag = jv[:, :nn], mag[:, :nn]        # JAX keeps truncated stages
    assert (np.abs(tv - jv) <= 1e-4 * np.abs(jv) + 2.0 ** -20 * mag).all()

    svnf = torch.from_numpy(np.asarray(f["vnf"]).reshape(-1)[
        np.where(surv < td.hv * td.wv, surv, 0)])[None]
    launches = trace.counters().get("launches.tail_rows", 0)
    rows = tail_rows(vals[None], svnf, surv_t, td.hv * td.wv, td.table,
                     td.front_k, td.paths if td.is_tree else None)[0]
    # CPU: plain twin
    assert trace.counters().get("launches.tail_rows", 0) == launches
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


def test_tail_rejects_bad_inputs():
    td = TDet(t_load_cascade("haarcascade_mcs_nose"), (60, 80),
              device="cpu")
    ii = td._prep_planes(torch.zeros((1, 60, 80), dtype=torch.uint8))
    idx = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="tilted"):
        ttail.haar_tail(ii.sum, None, idx, td.hv, td.wv, td.table)
    with pytest.raises(ValueError):
        ttail.haar_tail(ii.sum, ii.tilted, idx.long(), td.hv, td.wv,
                        td.table)
    with pytest.raises(ValueError):
        ttail.haar_tail(ii.sum[:, :-30], ii.tilted[:, :-30], idx, td.hv,
                        td.wv, td.table)


def test_chunking_keeps_every_bit(monkeypatch):
    """Node values chunked over nodes and votes chunked over stage groups
    give the same bits as one chunk each."""
    name = "haarcascade_eye_tree_eyeglasses"
    frame = synth_scene(SHAPE, faces=((60, 80, 40.0),), seed=9)
    td = TDet(t_load_cascade(name), SHAPE, front_stages=3, max_stages=8,
              device="cpu")
    ii = td._prep_planes(torch.from_numpy(frame)[None])
    n = td.hv * td.wv
    idx = np.random.default_rng(3).choice(n, 300).astype(np.int32)
    idx[-20:] = n                                     # pad slots
    surv = torch.from_numpy(idx)[None]
    valid = (surv >= 0) & (surv < n)
    svnf = torch.rand(1, 300, generator=torch.Generator().manual_seed(0))

    def run():
        vals = ttail.tail_values_plain(ii.sum, ii.tilted, surv, td.hv,
                                       td.wv, td.table)
        return vals, tail_rows(vals.clone(), svnf, surv, n, td.table,
                               td.front_k)

    v1, r1 = run()
    monkeypatch.setattr(ttail, "_CHUNK_ELEMS", 300 * 12 * 5)
    monkeypatch.setattr(trows, "_VOTE_CHUNK_ELEMS", 300 * 3 * 40)
    v2, r2 = run()
    assert 0 < r1[0, :, 1].sum() < 280 and valid.sum() == 280
    np.testing.assert_array_equal(v1.numpy().view(np.int32),
                                  v2.numpy().view(np.int32))
    np.testing.assert_array_equal(r1.numpy().view(np.int32),
                                  r2.numpy().view(np.int32))


@pytest.mark.parametrize("name,max_stages", [
    ("haarcascade_frontalface_alt2", 6),            # CART, T=2
    ("haarcascade_eye_tree_eyeglasses", 6),         # CART, T=3, tilted
    ("haarcascade_mcs_eyepair_big", 6),             # 46x12 patch, tilted
])
def test_node_view_walk_equals_plain(name, max_stages):
    """The kernel's node view holds the table: a walk of its records over
    window patches (offsets into the patch, weights, the rect count; the
    kernel's order of operations) gives ``tail_values_plain``'s bits."""
    frame = synth_scene(SHAPE, faces=((60, 80, 40.0),), seed=9)
    td = TDet(t_load_cascade(name), SHAPE, front_stages=3,
              max_stages=max_stages, device="cpu")
    tab = td.table
    ii = td._prep_planes(torch.from_numpy(frame)[None])
    n = td.hv * td.wv
    idx = np.random.default_rng(5).choice(n, 64).astype(np.int32)
    idx[::7] = n                                       # pad slots
    plain = ttail.tail_values_plain(ii.sum, ii.tilted,
                                    torch.from_numpy(idx)[None], td.hv,
                                    td.wv, tab)[0].numpy()
    ph, pw = ttail.patch_shape(tab)
    planes = [ii.sum[0].numpy()] + ([ii.tilted[0].numpy()]
                                    if tab.has_tilted else [])
    rec = tab.nodes.reshape(-1, ctab.NODE_VIEW_WORDS)
    nn = tab.n_clf * tab.T
    assert len(rec) % ctab.NODE_VIEW_PAD == 0
    assert len(rec) - nn < ctab.NODE_VIEW_PAD and not rec[nn:].any()
    rec = rec[:nn]
    np.testing.assert_array_equal(rec[:, 0], tab.n_rects.reshape(-1))
    w = rec[:, 13:16].view(np.float32)
    np.testing.assert_array_equal(w, tab.weights.reshape(-1, 3))
    for slot, i in enumerate(idx):
        if i >= n:
            assert not plain[slot].any()
            continue
        y, x = divmod(int(i), td.wv)
        patch = np.concatenate([p[y:y + ph, x:x + pw].reshape(-1)
                                for p in planes])
        c = patch[rec[:, 1:13]].reshape(-1, 3, 4).astype(np.int64)
        rs = (c[..., 0] - c[..., 1] - c[..., 2] + c[..., 3]).astype(
            np.int32).astype(np.float32)
        nv = np.zeros(len(rec), np.float32)
        for k in range(3):
            term = rs[:, k] * w[:, k]
            nv = np.where(rec[:, 0] > k, term if k == 0 else nv + term, nv)
        np.testing.assert_array_equal(nv.view(np.int32),
                                      plain[slot].view(np.int32))


def test_tail_values_with_padding_interleaved_and_unequal_batch():
    """B = 2 frames with unequal survivor counts, padding between live
    slots in compaction order and a slot count that is no multiple of 32:
    every live slot's node values against JAX's and the exact ones, every
    pad slot zero."""
    name = "haarcascade_eye_tree_eyeglasses"
    jd, front, compact, _ = _jax_det(name, None, 3)
    td = TDet(t_load_cascade(name), SHAPE, front_stages=jd.front_k,
              device="cpu")
    n_flat = td.hv * td.wv
    frames = [synth_scene(SHAPE, faces=((60, 80, 40.0),), seed=9),
              synth_scene(SHAPE, faces=((50, 60, 30.0),), seed=4)]
    lists, outs = [], []
    for fr in frames:
        f = front(jnp.asarray(fr))
        surv, n_surv = compact(f["front"])
        live = np.asarray(surv)[:int(n_surv)]
        slots = []
        for i, v in enumerate(live):
            slots.append(v)
            if i % 3 == 2:
                slots.append(n_flat)
        lists.append(np.int32(slots))
        outs.append(f)
    assert len(lists[0]) != len(lists[1])
    cap = max(map(len, lists)) + 7
    assert cap % 32
    surv = np.full((2, cap), n_flat, np.int32)
    for b, sl in enumerate(lists):
        surv[b, :len(sl)] = sl
    ii = [td._prep_planes(torch.from_numpy(fr)[None]) for fr in frames]
    s = torch.cat([i.sum for i in ii])
    t = torch.cat([i.tilted for i in ii])
    vals = ttail.haar_tail(s, t, torch.from_numpy(surv), td.hv, td.wv,
                           td.table)
    nn = td.table.n_clf * td.table.T
    assert vals.shape == (2, cap, nn)
    for b in range(2):
        valid = surv[b] < n_flat
        assert not vals[b][~valid].any()
        tv = vals[b][valid].numpy().astype(np.float64)
        sy, sx = surv[b][valid] // td.wv, surv[b][valid] % td.wv
        exact = _exact_node_values(td, ii[b], sy, sx)
        scale = np.abs(exact).max(axis=0)
        assert (np.abs(tv - exact)
                <= 1e-4 * np.abs(exact) + 1e-4 * scale).all()
        jv, mag = _jax_node_values(jd, outs[b]["planes"], sy, sx)
        jv, mag = jv[:, :nn], mag[:, :nn]
        assert (np.abs(tv - jv) <= 1e-4 * np.abs(jv) + 2.0 ** -20 * mag).all()


ROWS_CASES = [                        # (cascade, max_stages, front)
    ("haarcascade_mcs_nose", None, 3),             # stumps, tilted
    ("haarcascade_frontalface_alt2", None, 3),     # CART, T=2
    ("haarcascade_eye_tree_eyeglasses", None, 3),  # CART, T=3, tilted
    ("haarcascade_frontalface_alt_tree", 16, 5),   # stage tree
]


def _interleaved(lists, n_flat, extra=7):
    """[len(lists), cap] slots: each frame's live slots in order with a
    pad slot after every third, then padding to a common cap."""
    rows = []
    for live in lists:
        sl = []
        for i, v in enumerate(live):
            sl.append(v)
            if i % 3 == 2:
                sl.append(n_flat)
        rows.append(sl)
    cap = max(map(len, rows)) + extra
    surv = np.full((len(rows), cap), n_flat, np.int32)
    for b, sl in enumerate(rows):
        surv[b, :len(sl)] = sl
    return surv


@pytest.mark.parametrize("name,max_stages,front", ROWS_CASES)
def test_tail_rows_with_padding_interleaved_and_unequal_batch(
        name, max_stages, front):
    """``tail_rows_plain`` over B = 2 frames with unequal survivor counts
    and padding between the live slots: each live slot's alive flag, exit
    stage and stage sum against JAX's XLA tail on that frame, pad slots
    (0, 0, S, 0), and each frame's rows equal to a batch of one."""
    jd, front_fn, compact_fn, tail_fn = _jax_det(name, max_stages, front)
    td = TDet(t_load_cascade(name), SHAPE, front_stages=jd.front_k,
              max_stages=max_stages, device="cpu")
    S, n_flat = td.n_stages, td.hv * td.wv
    frames = [synth_scene(SHAPE, faces=((60, 80, 40.0),), seed=9),
              synth_scene(SHAPE, faces=((50, 60, 30.0),), seed=4)]
    lists, jts, vnfs = [], [], []
    for fr in frames:
        f = front_fn(jnp.asarray(fr))
        surv, n_surv = compact_fn(f["front"])
        lists.append(np.asarray(surv)[:int(n_surv)])
        jts.append(tail_fn(f["planes"], f["vnf"], surv, n_surv))
        vnfs.append(np.asarray(f["vnf"]).reshape(-1))
    assert len(lists[0]) != len(lists[1]) and min(map(len, lists)) > 0
    surv = _interleaved(lists, n_flat)
    ii = [td._prep_planes(torch.from_numpy(fr)[None]) for fr in frames]
    s = torch.cat([i.sum for i in ii])
    t = torch.cat([i.tilted for i in ii]) if td.table.has_tilted else None
    st = torch.from_numpy(surv)
    vals = ttail.tail_values_plain(s, t, st, td.hv, td.wv, td.table)
    svnf = torch.from_numpy(np.stack([
        v[np.where(sv < n_flat, sv, 0)] for v, sv in zip(vnfs, surv)]))
    paths = td.paths if td.is_tree else None
    rows = tail_rows_plain(vals, svnf, st, n_flat, td.table, td.front_k,
                           paths)
    assert rows.shape == (2, surv.shape[1], 4)
    for b in range(2):
        valid = surv[b] < n_flat
        np.testing.assert_array_equal(
            rows[b][~valid].numpy(),
            np.tile(np.float32([0, 0, S, 0]), ((~valid).sum(), 1)))
        one = tail_rows_plain(vals[b:b + 1].clone(), svnf[b:b + 1],
                              st[b:b + 1], n_flat, td.table, td.front_k,
                              paths)[0]
        np.testing.assert_array_equal(one.numpy().view(np.int32),
                                      rows[b].numpy().view(np.int32))
        r = rows[b][valid].numpy()
        n = len(lists[b])
        jt = jts[b]
        alive, ok = r[:, 1] > 0, np.asarray(jt["ok"])[:n]
        union = (alive | ok).sum()
        assert union == 0 or (alive & ok).sum() / union >= 0.995
        same = r[:, 2].astype(np.int32) == np.asarray(jt["level"])[:n]
        assert same.mean() >= 0.995, f"{(~same).sum()} of {n} levels differ"
        near = np.abs(r[:, 3] - np.asarray(jt["weight"])[:n]) <= 1e-4
        assert near[same].mean() >= 0.995
        np.testing.assert_array_equal(r[:, 0], svnf[b][valid].numpy())


def _rows_walk(table, values, svnf, surv, n, front_k, paths):
    """The decisions kernel's algorithm in numpy, from its own table
    (``CascadeTable.rows``, the path buffer): a classifier's record walked
    for every slot, stage sums in classifier order, a sequential cascade's
    slots dropped at their first failing stage."""
    S, T = table.n_stages, table.T
    stages = table.rows[:4 * S].reshape(S, 4)
    rec = table.rows[4 * S:].reshape(-1, ctab.ROW_WORDS)
    assert len(rec) == table.n_clf and not rec[:, 13:].any()
    thr, left, right = rec[:, 0:3].view(np.float32), rec[:, 3:6], rec[:, 6:9]
    alpha = rec[:, 9:13].view(np.float32)
    B, cap, _ = values.shape
    ok = (surv >= 0) & (surv < n)
    out = np.tile(np.float32([0, 0, S, 0]), (B, cap, 1))
    live = ok.copy()
    sums = np.zeros((B, cap, S), np.float32)
    passed = np.zeros((B, cap, S), bool)
    for s in range(0 if paths is not None else min(front_k, S), S):
        c0, cnt, sthr = stages[s, 0], stages[s, 1], \
            stages[s, 2:3].view(np.float32)[0]
        ssum = np.zeros((B, cap), np.float32)
        for c in range(c0, c0 + cnt):
            v = values[:, :, c * T:(c + 1) * T]
            node = np.zeros((B, cap), np.int64)
            vote = np.zeros((B, cap), np.float32)
            done = np.zeros((B, cap), bool)
            for _ in range(T):
                nv = np.take_along_axis(v, node[..., None], 2)[..., 0]
                go = nv < thr[c][node] * svnf
                nxt = np.where(go, left[c][node], right[c][node])
                leaf = (nxt <= 0) & ~done
                vote = np.where(leaf, alpha[c][np.minimum(-nxt, T)], vote)
                done |= nxt <= 0
                node = np.clip(nxt, 0, T - 1)
            ssum = ssum + vote
        sums[..., s], passed[..., s] = ssum, ssum >= sthr
        if paths is None:
            stop = live & (~passed[..., s] | (s == S - 1))
            out[stop] = np.stack([svnf, passed[..., s].astype(np.float32),
                                  np.where(passed[..., s], S, s),
                                  ssum], -1)[stop]
            live &= passed[..., s]
    if paths is None:
        if front_k >= S:
            out[ok] = np.stack([svnf, np.ones_like(svnf),
                                np.full_like(svnf, S),
                                np.zeros_like(svnf)], -1)[ok]
        return out
    buf = trows._path_buffer(table, paths, "cpu").numpy()
    pb = buf[:4 * len(paths)].reshape(-1, 4).view(np.uint32)
    of_stage = buf[4 * len(paths):]
    assert len(of_stage) == S
    assert (of_stage >= 0).sum() == len({p[-1] for p in paths})
    bits = (1 << np.arange(S, dtype=np.uint64)).astype(np.uint64)
    mask = np.bitwise_or.reduce(np.where(passed, bits, np.uint64(0)), -1)
    for b in range(B):
        for i in np.nonzero(ok[b])[0]:
            first = next((p for p, r in enumerate(pb) if not
                          ((int(r[0]) | int(r[1]) << 32) & ~int(mask[b, i]))),
                         -1)
            leaf = int(np.nonzero(of_stage == pb[max(first, 0), 2])[0][0])
            out[b, i] = (svnf[b, i], float(first >= 0),
                         S if first >= 0 else 0, sums[b, i, leaf])
    return out


@pytest.mark.parametrize("name,max_stages,front", ROWS_CASES + [
    ("haarcascade_frontalface_alt", 6, 6),          # front_k = S
])
def test_rows_view_walk_equals_plain(name, max_stages, front):
    """The decisions kernel's table and algorithm (``_rows_walk``) give
    ``tail_rows_plain``'s bits on a scene's front survivors and random
    windows, with padding between live slots, B = 2."""
    from clfacedetection_torch.ops.compact_kernel import compact_plain
    from clfacedetection_torch.ops.haar_front import front_plain
    td = TDet(t_load_cascade(name), SHAPE, front_stages=front,
              max_stages=max_stages, device="cpu")
    tab = td.table
    n, S = td.hv * td.wv, td.n_stages
    frame = synth_scene(SHAPE, faces=((60, 80, 40.0),), seed=9)
    ii = td._prep_planes(torch.from_numpy(np.stack([frame, frame[::-1]])
                                          .copy()))
    mask, vnf = front_plain(ii.sum, ii.sq_hi, ii.sq_lo, td._visit, tab,
                            td.front_k, tilted=ii.tilted)
    surv, cnt = compact_plain(mask.reshape(2, -1), 160)
    surv = surv.numpy()
    rng = np.random.default_rng(11)
    surv[:, ::5] = n
    surv[:, 120:140] = rng.choice(n, (2, 20))
    surv[1, -15:] = -1
    st = torch.from_numpy(surv)
    ok = (st >= 0) & (st < n)
    svnf = vnf.reshape(2, -1).gather(1, torch.where(ok, st, 0).long())
    values = ttail.tail_values_plain(ii.sum, ii.tilted, st, td.hv, td.wv,
                                     tab)
    paths = td.paths if td.is_tree else None
    want = tail_rows_plain(values, svnf, st, n, tab, td.front_k,
                           paths).numpy()
    got = _rows_walk(tab, values.numpy(), svnf.numpy(), surv, n,
                     td.front_k, paths)
    assert len(np.unique(want[..., 2][ok.numpy()])) > 1 or td.front_k == S
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_tail_rows_rejects_bad_inputs():
    td = TDet(t_load_cascade("haarcascade_frontalface_alt2"), (60, 80),
              max_stages=4, device="cpu")
    nn = td.table.n_clf * td.table.T
    vals = torch.zeros((1, 8, nn))
    svnf = torch.ones((1, 8))
    idx = torch.zeros((1, 8), dtype=torch.int32)
    n = td.hv * td.wv
    with pytest.raises(ValueError, match="nodes"):
        tail_rows(vals[..., 1:], svnf, idx, n, td.table, td.front_k)
    with pytest.raises(ValueError, match="int32"):
        tail_rows(vals, svnf, idx.long(), n, td.table, td.front_k)
    with pytest.raises(ValueError):
        tail_rows(vals, svnf[:, 1:], idx, n, td.table, td.front_k)


@pytest.mark.parametrize("entry", sorted(kernels._SIGNATURES))
def test_entry_point_signature_matches_its_source(entry):
    """The ctypes argument list of a kernel's C entry point matches its
    declaration in ``csrc/``: a pointer for every ``*`` parameter, an int
    for every ``int``, a float for every ``float``, in order."""
    import ctypes
    import glob
    import os
    import re
    csrc = os.path.join(os.path.dirname(kernels.__file__), os.pardir, "csrc")
    decls = []
    for path in glob.glob(os.path.join(csrc, "*.cu")):
        with open(path) as f:
            decls += re.findall(r'extern "C" int ' + entry + r'\(([^)]*)\)',
                                f.read())
    assert len(decls) == 1, entry
    want = []
    # an entry point without parameters declares "()" or "(void)"
    params = [] if decls[0].strip() in ("", "void") else decls[0].split(",")
    for param in params:
        param = " ".join(param.split())
        if "*" in param:
            want.append(ctypes.c_void_p)
        elif param.startswith(("int ", "const int ")):
            want.append(ctypes.c_int)
        else:
            assert param.startswith("float "), param
            want.append(ctypes.c_float)
    assert kernels._SIGNATURES[entry] == want
