"""The port's survivor tail (plain twin of csrc/haar_tail2.cu) against the
JAX XLA tail ``PyramidDetector._tail_device_xla`` built with
``output_levels=True``, on the same survivors and vnf map.

Tolerances: the JAX tail sums a stage's votes with ``jnp.sum`` over node
values from a matrix product; the port sums them sequentially from
four-corner node values.  Stage sums ("weight") may therefore differ in
their last bits: rtol 1e-5, atol 1e-6 (a few float32 ulps of sums of at
most 213 alphas of magnitude < 2), for all but 0.5% of survivors.  A node value within float32 noise of
``thr * vnf`` can also vote the other way, so alive and exit stage are
held to the docs/PARITY.md f32 bound: alive-set Jaccard >= 0.995 and at
most 0.5% of survivors with another exit stage (on these scenes 0-2
windows of 2,000-8,000 differ).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clfacedetection_tpu.detect.pyramid import PyramidDetector as JDet
from clfacedetection_tpu.models import load_cascade as j_load_cascade
from clfacedetection_tpu.utils import synth_face, synth_scene

from clfacedetection_torch import trace
from clfacedetection_torch.detect.pyramid import PyramidDetector as TDet
from clfacedetection_torch.models import load_cascade as t_load_cascade
from clfacedetection_torch.ops import haar_tail2 as ttail

# The suite runs in several worker processes at once; one torch thread
# each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

CASES = [
    ("haarcascade_frontalface_alt", 4, "face"),
    ("haarcascade_frontalface_alt", 3, "scene"),
    ("haarcascade_frontalface_default", 3, "face"),
    ("haarcascade_eye", 3, "scene"),
    ("haarcascade_profileface", 3, "scene"),
]


@pytest.mark.parametrize("name,front_k,kind", CASES)
def test_tail2_equals_jax_xla_tail(name, front_k, kind):
    shape = (120, 160)
    frame = synth_face(shape) if kind == "face" else synth_scene(
        shape, faces=((60, 80, 40.0),), seed=9)
    jd = JDet(j_load_cascade(name), shape, front_stages=front_k,
              dtype=jnp.float32, output_levels=True, use_pallas_front=False,
              cap=8192)
    f = jax.jit(jd._front_device)(jnp.asarray(frame))
    surv, n_surv = jax.jit(jd._compact_device)(f["front"])
    assert 0 < int(n_surv) <= jd.cap
    jt = jax.jit(jd._tail_device_xla)(f["planes"], f["vnf"], surv, n_surv)

    td = TDet(t_load_cascade(name), shape, front_stages=jd.front_k,
              device="cpu")
    assert td.front_k == jd.front_k
    s = td._prep_planes(torch.from_numpy(frame)[None]).sum
    vnf = torch.from_numpy(np.array(f["vnf"]))[None]
    surv_t = torch.from_numpy(np.array(surv, np.int32))[None]
    launches = trace.counters().get("launches.haar_tail2", 0)
    rows = ttail.haar_tail2(s, vnf, surv_t, td.table, td.front_k)[0]
    # CPU: plain twin
    assert trace.counters().get("launches.haar_tail2", 0) == launches
    assert rows.shape == (jd.cap, 4) and rows.dtype == torch.float32

    n = int(n_surv)
    alive = rows[:n, 1].numpy() > 0
    ok = np.asarray(jt["ok"])[:n]
    jl = np.asarray(jt["level"])[:n]
    pl = rows[:n, 2].numpy().astype(np.int32)
    assert ok.any() or (jl < jd.n_stages).all()
    union = (alive | ok).sum()
    assert union == 0 or (alive & ok).sum() / union >= 0.995
    # a window whose node value lies within float32 noise of thr * vnf can
    # vote the other way (the JAX tail's matrix-product node values are not
    # the JAX front's either: where JAX level < front_k its tail fails a
    # stage its own front passed); such windows stay under the PARITY rate
    same = pl == jl
    assert same.mean() >= 0.995, f"{(~same).sum()} of {n} levels differ"
    # a flipped vote inside the exit stage moves its sum by an alpha
    close = np.isclose(rows[:n, 3].numpy(), np.asarray(jt["weight"])[:n],
                       rtol=1e-5, atol=1e-6)
    assert (close & same).mean() >= 0.995
    # vnf lane: the survivor's own vnf; pad slots are (0, 0, n_stages, 0)
    flat = np.asarray(f["vnf"]).reshape(-1)
    np.testing.assert_array_equal(rows[:n, 0].numpy(),
                                  flat[np.asarray(surv)[:n]])
    pad = rows[n:].numpy()
    np.testing.assert_array_equal(
        pad, np.tile(np.float32([0, 0, jd.n_stages, 0]), (len(pad), 1)))


def test_tail2_float64_on_cpu():
    name, shape = "haarcascade_frontalface_alt", (120, 160)
    td = TDet(t_load_cascade(name), shape, front_stages=3, max_stages=10,
              dtype=torch.float64, device="cpu")
    s, hi, lo, _ = td._prep_planes(torch.from_numpy(synth_face(shape))[None])
    from clfacedetection_torch.ops.haar_front import front_plain
    front, vnf = front_plain(s, hi, lo, td._visit, td.table, td.front_k,
                             torch.float64)
    idx = torch.nonzero(front.reshape(-1))[:, 0].to(torch.int32)[None]
    rows = ttail.haar_tail2(s, vnf, idx, td.table, td.front_k)
    assert rows.dtype == torch.float64
    rows32 = ttail.haar_tail2(s, vnf.float(), idx, td.table, td.front_k)
    agree = (rows[0, :, 1] == rows32[0, :, 1]).double().mean()
    assert agree >= 0.995


@pytest.mark.parametrize("name", sorted({c for c, _, _ in CASES})
                         + ["haarcascade_frontalface_alt2",
                            "haarcascade_mcs_nose"])
def test_stump_view_decodes_to_the_table(name):
    """tail2's compact stump view holds the table's numbers: per stump its
    upright rects as (ya, xa, yb, xb), weights, threshold and both leaf
    values; CART and tilted cascades have none."""
    from clfacedetection_torch.ops import cascade_table as ctab
    tab = TDet(t_load_cascade(name), (60, 80), device="cpu").table
    if tab.T != 1 or tab.has_tilted:
        assert tab.stumps is None
        with pytest.raises(ValueError, match="stump view"):
            tab.device_buffer("cpu", stumps=True)
        return
    S, C, W = tab.n_stages, tab.n_clf, ctab.STAGE_WORDS
    st = tab.stumps[:S * W].reshape(S, W)
    np.testing.assert_array_equal(st[:, :3], tab.packed[:S * W].reshape(
        S, W)[:, :3])
    assert not st[:, 3].any()
    nd = tab.stumps[S * W:].reshape(C, ctab.STUMP_WORDS)
    np.testing.assert_array_equal(nd[:, 0], tab.n_rects[:, 0])
    cor = tab.corners[:, 0]                             # [C, 3, 4, 2]
    np.testing.assert_array_equal(
        nd[:, 1:13].reshape(C, 3, 4),
        np.stack([cor[:, :, 0, 0], cor[:, :, 0, 1], cor[:, :, 3, 0],
                  cor[:, :, 3, 1]], axis=-1))
    # the other two corners are those of an upright rect
    np.testing.assert_array_equal(cor[:, :, 1], np.stack(
        [cor[:, :, 0, 0], cor[:, :, 3, 1]], axis=-1))
    np.testing.assert_array_equal(cor[:, :, 2], np.stack(
        [cor[:, :, 3, 0], cor[:, :, 0, 1]], axis=-1))
    f = nd[:, 13:19].view(np.float32)
    np.testing.assert_array_equal(f[:, :3], tab.weights[:, 0])
    np.testing.assert_array_equal(f[:, 3], tab.thr[:, 0])
    idx = np.arange(C)
    np.testing.assert_array_equal(f[:, 4], tab.alpha[idx, -tab.left[:, 0]])
    np.testing.assert_array_equal(f[:, 5], tab.alpha[idx, -tab.right[:, 0]])
    assert not nd[:, 19].any()


@functools.lru_cache(maxsize=None)
def _jax_tail2(name, front_k, shape=(120, 160), cap=8192):
    """A JAX detector and its jitted front, compaction and XLA tail, made
    once for the tests below."""
    jd = JDet(j_load_cascade(name), shape, front_stages=front_k,
              dtype=jnp.float32, output_levels=True, use_pallas_front=False,
              cap=cap)
    td = TDet(t_load_cascade(name), shape, front_stages=jd.front_k,
              device="cpu")
    return (jd, td, jax.jit(jd._front_device), jax.jit(jd._compact_device),
            jax.jit(jd._tail_device_xla))


def _jax_rows(key, f, surv):
    """The JAX XLA tail's (ok, level, weight) on a slot list of one frame
    (padded to the JAX detector's cap with the pad index)."""
    jd, td, _, _, tail = _jax_tail2(*key)
    n = len(surv)
    full = np.full(jd.cap, td.hv * td.wv, np.int32)
    full[:n] = surv
    jt = tail(f["planes"], f["vnf"], jnp.asarray(full), jnp.int32(n))
    return (np.asarray(jt["ok"])[:n], np.asarray(jt["level"])[:n],
            np.asarray(jt["weight"])[:n])


def _hold_to_jax(rows, surv, n_flat, jax_rows, n_stages):
    """Port rows [cap, 4] against the JAX tail on the same slots, at the
    module's tolerances; padding slots exactly (0, 0, S, 0)."""
    ok, level, weight = jax_rows
    valid = surv < n_flat
    alive = rows[:, 1].numpy() > 0
    assert not ok[~valid].any()
    union = (alive | ok).sum()
    assert union == 0 or (alive & ok).sum() / union >= 0.995
    same = rows[valid, 2].numpy().astype(np.int32) == level[valid]
    assert same.mean() >= 0.995
    close = np.isclose(rows[valid, 3].numpy(), weight[valid], rtol=1e-5,
                       atol=1e-6)
    assert (close & same).mean() >= 0.995
    np.testing.assert_array_equal(
        rows[~valid].numpy(),
        np.tile(np.float32([0, 0, n_stages, 0]), ((~valid).sum(), 1)))


def _setup(key, frame):
    """The JAX front's outputs on ``frame``, its survivors in compaction
    order, and the port's detector and ``sum`` plane."""
    jd, td, front, compact, _ = _jax_tail2(*key)
    f = front(jnp.asarray(frame))
    surv, n_surv = compact(f["front"])
    s = td._prep_planes(torch.from_numpy(frame)[None]).sum
    n = int(n_surv)
    assert 0 < n <= jd.cap
    return f, np.asarray(surv)[:n].astype(np.int32), td, s


def test_tail2_padding_interleaved_in_compaction_order():
    """Padding slots between live ones (ascending survivors, a pad after
    every second) and a cap that is no multiple of the kernel's chunk
    (``csrc/haar_tail2.cu`` takes 16 to 512 slots a block by batch x cap:
    16 at a cap this small), as the strips path lays them out."""
    key = ("haarcascade_frontalface_alt", 4)
    frame = synth_scene((120, 160), faces=((60, 80, 40.0),), seed=9)
    f, live, td, s = _setup(key, frame)
    n_flat = td.hv * td.wv
    slots = []
    for i, v in enumerate(live):
        slots.append(v)
        if i % 2:
            slots.append(n_flat)
    slots += [n_flat] * 5
    surv = np.int32(slots)
    assert len(surv) % 16 and (surv == n_flat).sum() > 5
    rows = ttail.haar_tail2(s, torch.from_numpy(np.array(f["vnf"]))[None],
                            torch.from_numpy(surv)[None], td.table,
                            td.front_k)[0]
    _hold_to_jax(rows, surv, n_flat, _jax_rows(key, f, surv), td.n_stages)


def test_tail2_batch_of_two_with_unequal_counts():
    """B = 2 frames whose survivor counts differ: each frame's rows equal
    the JAX tail on its own slots, and the pad index fills the shorter
    frame's slots past its count."""
    key = ("haarcascade_frontalface_alt", 4)
    frames = [synth_scene((120, 160), faces=((60, 80, 40.0),), seed=9),
              synth_face((120, 160))]
    got = [_setup(key, fr) for fr in frames]
    td = got[0][2]
    n_flat = td.hv * td.wv
    counts = [len(g[1]) for g in got]
    assert counts[0] != counts[1]
    cap = max(counts) + 3
    surv = np.full((2, cap), n_flat, np.int32)
    for b, g in enumerate(got):
        surv[b, :counts[b]] = g[1]
    s = torch.cat([g[3] for g in got])
    vnf = torch.from_numpy(np.stack([np.array(g[0]["vnf"]) for g in got]))
    rows = ttail.haar_tail2(s, vnf, torch.from_numpy(surv), td.table,
                            td.front_k)
    for b, (f, _, _, _) in enumerate(got):
        _hold_to_jax(rows[b], surv[b], n_flat, _jax_rows(key, f, surv[b]),
                     td.n_stages)


def test_tail2_survivors_that_pass_all_and_die_first():
    """A slot list of windows that pass every stage beside windows that die
    at the first tail stage, interleaved: the kernel's live lists keep
    the first to the end and drop the others at once."""
    key = ("haarcascade_frontalface_alt", 4)
    f, live, td, s = _setup(key, synth_face((120, 160)))
    ok, level, _ = _jax_rows(key, f, live)
    deep = live[ok]
    dead = live[level == td.front_k]
    assert len(deep) and len(dead)
    k = min(len(deep), len(dead))
    surv = np.empty(2 * k, np.int32)
    surv[0::2], surv[1::2] = deep[:k], dead[:k]
    vnf = torch.from_numpy(np.array(f["vnf"]))[None]
    rows = ttail.haar_tail2(s, vnf, torch.from_numpy(surv)[None], td.table,
                            td.front_k)[0]
    _hold_to_jax(rows, surv, td.hv * td.wv, _jax_rows(key, f, surv),
                 td.n_stages)
    assert (rows[0::2, 2] == td.n_stages).float().mean() >= 0.995
    assert (rows[1::2, 2] == td.front_k).float().mean() >= 0.995


def _jax_full_front(name, n_stages, shape=(120, 160), cap=8192):
    """A JAX detector cut to ``n_stages`` whose front runs every stage
    (``front_k == n_stages``), with its jitted front, compaction and XLA
    tail, and the port's detector on the same cut."""
    jd = JDet(j_load_cascade(name), shape, front_stages=n_stages,
              max_stages=n_stages, dtype=jnp.float32,
              use_pallas_front=False, cap=cap)
    td = TDet(t_load_cascade(name), shape, front_stages=n_stages,
              max_stages=n_stages, device="cpu")
    assert td.front_k == jd.front_k == td.n_stages == n_stages
    return (jd, td, jax.jit(jd._front_device), jax.jit(jd._compact_device),
            jax.jit(jd._tail_device_xla))


def _kernel_equals_plain(s, vnf, surv, table, front_k, rows):
    """Where a card is present, the kernel on it gives ``rows`` (the plain
    twin's, on the CPU) bit for bit."""
    if not torch.cuda.is_available():
        return
    dev = torch.device("cuda")
    got = ttail.haar_tail2(s.to(dev), vnf.to(dev), surv.to(dev), table,
                           front_k).cpu()
    assert torch.equal(got.view(torch.int32), rows.view(torch.int32))


LAYOUTS = ["pad_run_then_live", "padding_row", "ragged_cap",
           "front_k_is_n_stages", "every_tail_stage", "descending",
           "each_window_twice"]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_tail2_wide_chunk_layouts(layout):
    """Slot layouts that blocks of many slots meet (``csrc/haar_tail2.cu``:
    16 to 512 slots a block, its windows listed from wherever they sit):
    a run of padding longer than the largest chunk before the survivors; a
    batch row of padding only beside a full one; a cap that is no
    multiple of 16 or 512; ``front_k == n_stages``, where no stage is left
    and every window passes with a stage sum of 0; survivors exiting at
    every tail stage and passing all of them, interleaved; the survivors
    in descending order; and each survivor in two slots, both of which get
    its row.  The plain twin against the JAX XLA tail, and the kernel
    against it where a card is present."""
    name = "haarcascade_frontalface_alt"
    frame = synth_face((120, 160))
    if layout == "front_k_is_n_stages":
        jd, td, front, compact, tail = _jax_full_front(name, 6)
        f = front(jnp.asarray(frame))
        surv_j, n_surv = compact(f["front"])
        n = int(n_surv)
        assert 0 < n <= jd.cap
        jt = tail(f["planes"], f["vnf"], surv_j, n_surv)
        surv = np.asarray(surv_j).astype(np.int32)[None]
        s = td._prep_planes(torch.from_numpy(frame)[None]).sum
        vnf = torch.from_numpy(np.array(f["vnf"]))[None]
        rows = ttail.haar_tail2(s, vnf, torch.from_numpy(surv), td.table,
                                td.front_k)
        r = rows[0].numpy()
        np.testing.assert_array_equal(r[:, 1] > 0, np.asarray(jt["ok"]))
        assert (r[:n, 1] == 1).all() and (r[:, 2] == td.n_stages).all()
        assert not r[:, 3].any()
        np.testing.assert_array_equal(
            r[:n, 0], np.asarray(f["vnf"]).reshape(-1)[surv[0, :n]])
        assert not r[n:, 0].any()
        _kernel_equals_plain(s, vnf, torch.from_numpy(surv), td.table,
                             td.front_k, rows)
        return

    key = (name, 4)
    f, live, td, s = _setup(key, frame)
    n_flat = td.hv * td.wv
    vnf = torch.from_numpy(np.array(f["vnf"]))[None]
    if layout == "pad_run_then_live":
        surv = np.concatenate([np.full(600, n_flat, np.int32), live])[None]
    elif layout == "padding_row":
        cap = len(live) + 40
        surv = np.full((2, cap), n_flat, np.int32)
        surv[0, :len(live)] = live
        s, vnf = torch.cat([s, s]), torch.cat([vnf, vnf])
    elif layout == "ragged_cap":
        cap = -(-len(live) // 512) * 512 + 21
        assert cap % 16 and cap % 512
        surv = np.full((1, cap), n_flat, np.int32)
        surv[0, :len(live)] = live
    elif layout == "descending":
        surv = live[::-1].copy()[None]
    elif layout == "each_window_twice":
        surv = np.concatenate([live, live[::-1]])[None]
    else:
        _, level, _ = _jax_rows(key, f, live)
        groups = [live[level == L][:4] for L in range(td.front_k,
                                                     td.n_stages + 1)]
        assert all(len(g) for g in groups), [len(g) for g in groups]
        picked = [g[i] for i in range(4) for g in groups if i < len(g)]
        surv = np.int32(picked)[None]
    rows = ttail.haar_tail2(s, vnf, torch.from_numpy(surv), td.table,
                            td.front_k)
    for b in range(surv.shape[0]):
        jax_rows = _jax_rows(key, f, surv[b])
        if (surv[b] < n_flat).any():
            _hold_to_jax(rows[b], surv[b], n_flat, jax_rows, td.n_stages)
        else:                       # the row of padding alone
            assert not jax_rows[0].any()
            np.testing.assert_array_equal(rows[b].numpy(), np.tile(
                np.float32([0, 0, td.n_stages, 0]), (surv.shape[1], 1)))
    if layout == "every_tail_stage":
        got = set(rows[0, :, 2].numpy().astype(int).tolist())
        assert got == set(range(td.front_k, td.n_stages + 1))
    if layout == "each_window_twice":
        k = len(live)
        np.testing.assert_array_equal(rows[0, :k].numpy(),
                                      rows[0, k:].numpy()[::-1])
    _kernel_equals_plain(s, vnf, torch.from_numpy(surv), td.table,
                         td.front_k, rows)
