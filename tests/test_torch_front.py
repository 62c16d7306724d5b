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

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clfacedetection_tpu.detect.pyramid import PyramidDetector as JDet
from clfacedetection_tpu.models import load_cascade as j_load_cascade
from clfacedetection_tpu.utils import synth_scene

from clfacedetection_torch.detect.pyramid import PyramidDetector as TDet
from clfacedetection_torch.models import load_cascade as t_load_cascade
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
    launches = tfront.haar_front.launches
    front, vnf = tfront.haar_front(s, hi, lo, td._visit, td.table,
                                   td.front_k, tilted=tilted)
    assert tfront.haar_front.launches == launches   # CPU: plain twin
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
