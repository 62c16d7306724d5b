"""The port's dense front (plain twin of csrc/haar_front.cu) against the
JAX XLA front ``PyramidDetector._front_from_planes``, which the JAX
package's CPU tests use as the Pallas front's specification: stump
cascades, CART trees (frontalface_alt2, T=2; eye_tree_eyeglasses, T=3
with tilted nodes) and tilted stumps (mcs_nose).

Tolerances: float32 mask and vnf BIT-EQUAL; float64 mask equal and vnf
within rtol 1e-12 (XLA contracts the variance into an fma, the port's
float64 path rounds separately).  The float32 vnf is JAX's fused form at
every position: 150 recompilations of JAX's front in six loaded
processes never gave the separately rounded value at any position.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clfacedetection_tpu.detect.pyramid import PyramidDetector as JDet
from clfacedetection_tpu.models import load_cascade as j_load_cascade
from clfacedetection_tpu.utils import synth_scene

from clfacedetection_torch import trace
from clfacedetection_torch.detect.pyramid import PyramidDetector as TDet
from clfacedetection_torch.models import load_cascade as t_load_cascade
from clfacedetection_torch.models.zoo import artifact_dir
from clfacedetection_torch.ops import haar_front as tfront

# The suite runs in several worker processes at once; one torch thread
# each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

CASES = [
    ("haarcascade_frontalface_alt", (120, 160), 4),
    ("haarcascade_frontalface_default", (120, 160), 4),
    ("haarcascade_eye", (120, 160), 4),
    ("haarcascade_profileface", (120, 160), 4),
    ("haarcascade_frontalface_alt", (480, 640), 10),   # minSize 40x40
    ("haarcascade_frontalface_alt2", (120, 160), 4),
    ("haarcascade_mcs_nose", (120, 160), 4),
    ("haarcascade_eye_tree_eyeglasses", (120, 160), 4),
]


def _scene(shape):
    h, w = shape
    return synth_scene(shape, faces=((h // 2, w // 2, h / 3.0),), seed=5)


def _pair(name, shape, front_k, jdt, tdt):
    min_size = (40, 40) if shape[0] >= 480 else (0, 0)
    jd = JDet(j_load_cascade(name), shape, front_stages=front_k, dtype=jdt,
              min_size=min_size, use_pallas_front=False)
    td = TDet(t_load_cascade(name), shape, front_stages=front_k, dtype=tdt,
              min_size=min_size, device="cpu")
    return jd, td


def _run(jd, td, frame):
    planes = jax.jit(jd._prep_planes)(jnp.asarray(frame))
    jf = jax.jit(jd._front_from_planes)(*planes)
    ii = td._prep_planes(torch.from_numpy(frame)[None])
    if ii.tilted is not None:
        np.testing.assert_array_equal(ii.tilted[0].numpy(),
                                      np.asarray(planes[0]["tilted"]))
    return jf, ii


@pytest.mark.parametrize("name,shape,front_k", CASES)
def test_front_f32_bit_equal(name, shape, front_k):
    jd, td = _pair(name, shape, front_k, jnp.float32, torch.float32)
    frame = _scene(shape)
    jf, ii = _run(jd, td, frame)
    s, hi, lo, tilted = ii
    launches = trace.counters().get("launches.haar_front", 0)
    front, vnf = tfront.haar_front(s, hi, lo, td._visit, td.table,
                                   td.front_k, tilted=tilted)
    # CPU: plain twin
    assert trace.counters().get("launches.haar_front", 0) == launches
    jfront = np.asarray(jf["front"])
    assert jfront.sum() > 0
    np.testing.assert_array_equal(front.reshape(-1).numpy(), jfront)
    np.testing.assert_array_equal(vnf[0].numpy().view(np.int32),
                                  np.asarray(jf["vnf"]).view(np.int32))
    # votes on JAX's own vnf: a vote fault cannot hide behind the variance
    votes = tfront.front_votes_plain(
        s, td._visit, td.table, td.front_k,
        torch.from_numpy(np.array(jf["vnf"]))[None], tilted)
    np.testing.assert_array_equal(votes.reshape(-1).numpy(), jfront)


@pytest.mark.parametrize("name,shape,front_k", CASES[:2])
def test_front_f64(name, shape, front_k):
    jd, td = _pair(name, shape, front_k, jnp.float64, torch.float64)
    frame = _scene(shape)
    jf, ii = _run(jd, td, frame)
    s, hi, lo, _ = ii
    front, vnf = tfront.haar_front(s, hi, lo, td._visit, td.table,
                                   td.front_k, torch.float64)
    assert vnf.dtype == torch.float64
    np.testing.assert_array_equal(front.reshape(-1).numpy(),
                                  np.asarray(jf["front"]))
    np.testing.assert_allclose(vnf[0].numpy(), np.asarray(jf["vnf"]),
                               rtol=1e-12, atol=0)


def test_front_rejects_bad_inputs():
    td = TDet(t_load_cascade("haarcascade_frontalface_alt"), (120, 160),
              device="cpu")
    s, hi, lo, _ = td._prep_planes(torch.zeros((1, 120, 160),
                                               dtype=torch.uint8))
    with pytest.raises(ValueError):
        tfront.haar_front(s.to(torch.int64), hi, lo, td._visit, td.table, 2)
    with pytest.raises(ValueError):
        tfront.haar_front(s[:, :-30], hi[:, :-30], lo[:, :-30], td._visit,
                          td.table, 2)
    with pytest.raises(ValueError):
        tfront.haar_front(s, hi, lo, td._visit.to(torch.uint8), td.table, 2)


def test_front_needs_the_tilted_plane():
    td = TDet(t_load_cascade("haarcascade_mcs_nose"), (60, 80),
              device="cpu")
    s, hi, lo, tilted = td._prep_planes(torch.zeros((1, 60, 80),
                                                    dtype=torch.uint8))
    assert tilted is not None and tilted.shape == s.shape
    with pytest.raises(ValueError, match="tilted"):
        tfront.haar_front(s, hi, lo, td._visit, td.table, 2)


@pytest.mark.parametrize("name,view", [
    ("haarcascade_frontalface_alt", True),          # stumps, stump view
    ("haarcascade_frontalface_alt", False),
    ("haarcascade_frontalface_alt2", False),        # CART, T=2
    ("haarcascade_eye_tree_eyeglasses", False),     # CART, T=3, tilted
])
def test_front_table_prefix_decodes_to_the_table(name, view):
    """The words the front stages in shared memory hold every stage record
    and every classifier of stages 0..front_k-1, and decode to the
    table's fields."""
    td = TDet(t_load_cascade(name), (120, 160), device="cpu")
    t, fk = td.table, td.front_k
    words = tfront.front_table_words(t, fk, view)
    assert words % 4 == 0
    buf = (t.stumps if view else t.packed)[:words]
    S = t.n_stages
    st = buf[:S * 4].reshape(S, 4)
    np.testing.assert_array_equal(st[:, 0], t.stage_clf0)
    np.testing.assert_array_equal(st[:, 1], t.stage_cnt)
    np.testing.assert_array_equal(st[:, 2].view(np.float32), t.stage_thr)
    stride = 20 if view else t.clf_words
    clfs = buf[S * 4:].reshape(-1, stride)
    n = int(max(t.stage_clf0[s] + t.stage_cnt[s] for s in range(fk)))
    assert len(clfs) == n            # the last front classifier, no more
    for i in (0, n - 1):
        if view:
            assert clfs[i, 0] == t.n_rects[i, 0]
            np.testing.assert_array_equal(clfs[i, 13:16].view(np.float32),
                                          t.weights[i, 0])
            assert clfs[i, 16].view(np.float32) == t.thr[i, 0]
            continue
        assert clfs[i, 0] == t.clf_nodes[i]
        np.testing.assert_array_equal(clfs[i, 1:2 + t.T].view(np.float32),
                                      t.alpha[i])
        nd = clfs[i, 8:].reshape(t.T, 32)
        np.testing.assert_array_equal(nd[:, 0], t.n_rects[i])
        np.testing.assert_array_equal(nd[:, 1], t.tilted[i])
        np.testing.assert_array_equal(nd[:, 2], t.left[i])
        np.testing.assert_array_equal(nd[:, 3], t.right[i])
        np.testing.assert_array_equal(nd[:, 4].view(np.float32), t.thr[i])
        np.testing.assert_array_equal(nd[:, 8:].reshape(t.T, 3, 4, 2),
                                      t.corners[i])


def test_front_design_fits_shared_memory():
    """For every cascade of the zoo a block's lists and plane tiles fit in
    its shared memory; the front stages' table is staged beside them
    where it fits (in the stump view for stump cascades) and read through
    L1 where it does not; the choice is made once per table and depth."""
    zoo = sorted(p.stem for p in Path(artifact_dir()).glob("*.npz"))
    assert len(zoo) == 19
    staged = {}
    for name in zoo:
        td = TDet(t_load_cascade(name), (120, 160), front_stages=10,
                  device="cpu")
        t, fk = td.table, td.front_k
        assert tfront.front_smem_bytes(t, 0) <= tfront.MAX_SMEM, name
        full = tfront.front_table_words(t, fk, t.stumps is not None)
        words = tfront.front_launch(t, fk)
        assert words in (0, full), name
        assert (words == full) == (tfront.front_smem_bytes(t, full)
                                   <= tfront.MAX_SMEM), name
        assert t.front_words == {fk: words}
        staged[name] = words
    # alt: 22 stage records and the 384 stumps of stages 0-9, 80 bytes each
    assert staged["haarcascade_frontalface_alt"] == 22 * 4 + 384 * 20
    # mcs_upperbody: tilted (two plane tiles) and a 137 KB table prefix
    assert staged["haarcascade_mcs_upperbody"] == 0
    assert sum(w == 0 for w in staged.values()) == 4
