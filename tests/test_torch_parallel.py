"""The port's multi-device layer against the JAX package, on the CPU.

The counterparts of ``tests/test_parallel.py``, ``test_strips.py`` and
``test_scale_split.py``.  The JAX tests run on eight virtual CPU devices;
the port's run on meshes that repeat one device (``Mesh([cpu] * k)``),
which run the same k-way logic: strip offsets, per-strip cap slices and
regrowth, batch splitting, round-robin scale dispatch and the merges.
Every sharded path gives candidates equal box for box, and in order, to
the JAX package's single-device detector on the same seeded frames
(float32 in scale-image mode; float64 in scale-cascade mode, where the
two packages sum stages in different orders).  One case runs JAX's own
``StripShardedPyramidDetector`` on its virtual devices and holds the cap
it regrew to equal to the port's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from clfacedetection_tpu.detect import PyramidDetector as JPyramid
from clfacedetection_tpu.detect import ScaleCascadeDetector as JScale
from clfacedetection_tpu.models import load_cascade as j_load_cascade
from clfacedetection_tpu.parallel import \
    StripShardedPyramidDetector as JStrips

import clfacedetection_torch as ct
from clfacedetection_torch.parallel import (StripShardedPyramidDetector,
                                            detect_sharded, gather_detections)
from clfacedetection_torch.runtime import Mesh, data_parallel_mesh
from clfacedetection_torch.runtime.batch import MeshHandle
from clfacedetection_torch.utils import synth_face

# one torch thread per test worker process
torch.set_num_threads(1)

SHAPE = (96, 128)
DEFAULT = "haarcascade_frontalface_default"
NOSE = "haarcascade_mcs_nose"
PROFILE = "haarcascade_profileface"
CPU = torch.device("cpu")
# the truncated depth of the scale-image cases: one JAX compile serves
# them all
STAGES = 6


def _mesh(k, axis="data"):
    return Mesh([CPU] * k, (axis,))


@functools.lru_cache(maxsize=None)
def _face(shape, size, seed):
    return synth_face(shape, size=size, seed=seed)


@functools.lru_cache(maxsize=None)
def _frames():
    return np.stack([synth_face(SHAPE, size=30.0, seed=i) for i in range(8)])


@functools.lru_cache(maxsize=None)
def _jax_pyramid(name, shape, max_stages, cap=None):
    return JPyramid(j_load_cascade(name), shape, max_stages=max_stages,
                    cap=cap)


@functools.lru_cache(maxsize=None)
def _jax_candidates(name, shape, max_stages, frame_key):
    """The JAX single-device candidates of one frame: ``frame_key`` is
    ("face", size, seed) or ("batch", i)."""
    if frame_key[0] == "batch":
        frame = _frames()[frame_key[1]]
    else:
        frame = _face(shape, *frame_key[1:])
    got, ovf = _jax_pyramid(name, shape, max_stages).candidates(frame)
    return np.asarray(got), ovf


def _port(name, shape=SHAPE, **kw):
    return ct.PyramidDetector(ct.load_cascade(name), shape, device="cpu",
                              **kw)


# ---------------------------------------------------------------- strips
@pytest.mark.parametrize("k", [2, 4, 8])
def test_strips_match_jax_single(k):
    """The counterpart of ``test_strips_match_single_truncated``, over
    2, 4 and 8 strips: candidates equal to JAX's single-device ones, in
    order, and to the port's own single-device detector."""
    frame = _face(SHAPE, 40.0, 3)
    det = _port(DEFAULT, max_stages=STAGES, cap=256)
    sdet = StripShardedPyramidDetector(det, _mesh(k, "strips"))
    assert sdet.Hs % 8 == 0 and sdet.Hs * k >= det.hv
    got, ovf = sdet.candidates(frame)
    want, want_ovf = _jax_candidates(DEFAULT, SHAPE, STAGES,
                                     ("face", 40.0, 3))
    assert len(want) > 0
    np.testing.assert_array_equal(got, want)
    assert ovf == want_ovf
    ref, _ = _port(DEFAULT, max_stages=STAGES, cap=256).candidates(frame)
    np.testing.assert_array_equal(got, ref)


def test_strips_tilted_cascade():
    """``test_strips_mesh4_tilted``: the tilted plane goes through the
    strip slices, and the v1 tail runs after the gather."""
    shape = (80, 96)
    frame = _face(shape, 36.0, 11)
    det = _port(NOSE, shape, max_stages=4, cap=256)
    assert not det.use_tail2 and det.table.has_tilted
    got, _ = StripShardedPyramidDetector(
        det, _mesh(4, "strips")).candidates(frame)
    want, _ = _jax_candidates(NOSE, shape, 4, ("face", 36.0, 11))
    assert len(want) > 0
    np.testing.assert_array_equal(got, want)


def test_strips_regrow_cap_equals_jax():
    """``test_strips_overflow_regrow``: from cap 64 a strip overflows its
    slice and the cap regrows until every strip fits; the candidates
    equal the port's single-device ones and JAX's strips', and the cap the
    port regrew to equals
    the one JAX's own strip detector regrew to on its 8 virtual devices,
    whose candidates JAX's tests hold equal to its single-device ones."""
    frame = _face(SHAPE, 40.0, 5)
    det = _port(DEFAULT, max_stages=2, cap=64)
    got, ovf = StripShardedPyramidDetector(
        det, _mesh(8, "strips")).candidates(frame)
    assert not ovf and det.cap > 64 and det.cap % 8 == 0
    ref, _ = _port(DEFAULT, max_stages=2).candidates(frame)
    np.testing.assert_array_equal(got, ref)
    jdet = JPyramid(j_load_cascade(DEFAULT), SHAPE, max_stages=2, cap=64)
    jgot, jovf = JStrips(jdet, JMesh(np.array(jax.devices()[:8]),
                                     ("strips",))).candidates(frame)
    assert jdet.cap == det.cap
    assert jovf == ovf
    np.testing.assert_array_equal(got, np.asarray(jgot))


@pytest.mark.parametrize("case", ["no_levels", "no_axis", "cap"])
def test_strips_refuse(case):
    """JAX's checks and messages: no pyramid level, no such axis, a cap
    that the mesh size does not divide."""
    if case == "no_levels":
        det = _port(DEFAULT, (16, 16))
        with pytest.raises(ValueError, match="no pyramid levels"):
            StripShardedPyramidDetector(det, _mesh(2, "strips"))
    elif case == "no_axis":
        with pytest.raises(ValueError, match="mesh has no axis 'strips'"):
            StripShardedPyramidDetector(_port(DEFAULT, max_stages=2),
                                        _mesh(2, "data"))
    else:
        with pytest.raises(ValueError, match="not divisible by mesh size 3"):
            StripShardedPyramidDetector(
                _port(DEFAULT, max_stages=2, cap=256), _mesh(3, "strips"))


# ------------------------------------------------------------ batch mesh
def _batch_mesh(k=8, **kw):
    return ct.BatchedPyramidDetector(ct.load_cascade(DEFAULT), SHAPE, 8,
                                     mesh=_mesh(k), max_stages=STAGES,
                                     device="cpu", **kw)


def _assert_jax_frames(results):
    assert len(results) == 8
    for i, r in enumerate(results):
        want, _ = _jax_candidates(DEFAULT, SHAPE, STAGES, ("batch", i))
        np.testing.assert_array_equal(r.candidates, want, f"frame {i}")
    assert sum(len(r.candidates) for r in results) > 0


def test_batch_mesh_matches_jax_single():
    """``test_batched_matches_single``: batch 8 over 8 positions, each
    frame's candidates equal to JAX's single-device ones; one program a
    position, for 1 frame at the shared cap."""
    det = _batch_mesh(cap=32)
    res = det.detect(_frames(), min_neighbors=0)
    _assert_jax_frames(res)
    assert det.det.cap > 32, "no shard overflowed the small cap"
    assert all(d._program.key == (1, det.det.cap) for d in det._dets)
    assert [d.slot for d in det._dets] == list(range(8))
    h = det.run_device(_frames())
    assert isinstance(h, MeshHandle) and len(h.handles) == 8


@pytest.mark.parametrize("threaded", [True, False])
def test_batch_mesh_stream(threaded):
    """``detect_stream`` over the mesh, threaded and unthreaded: results
    in order, equal to JAX's single-device candidates."""
    det = _batch_mesh(k=4)
    frames = _frames()
    batches = [frames, frames[::-1].copy(), frames]
    got = list(det.detect_stream(iter(batches), min_neighbors=0, depth=2,
                                 threaded=threaded))
    assert len(got) == 3
    _assert_jax_frames(got[0])
    _assert_jax_frames(got[1][::-1])
    _assert_jax_frames(got[2])


def test_detect_sharded_gather_detections():
    """``test_shard_map_matches_batched``: the explicit API equals the
    batch mesh box for box, and JAX's single-device grouping."""
    det = _batch_mesh()
    ref = det.detect(_frames(), min_neighbors=1)
    out = detect_sharded(det.det, _frames(), _mesh(8))
    assert out["packed"].shape[0] == 8 and out["surv_idx"].shape[0] == 8
    got = gather_detections(out, det.det, min_neighbors=1)
    jdet = _jax_pyramid(DEFAULT, SHAPE, STAGES)
    for i, (r, g) in enumerate(zip(ref, got)):
        np.testing.assert_array_equal(g.boxes, r.boxes)
        np.testing.assert_array_equal(g.candidates, r.candidates)
        np.testing.assert_array_equal(
            g.boxes, jdet.detect(_frames()[i], min_neighbors=1).boxes)


def test_multi_cascade_mesh_matches_unsharded():
    """``MultiCascadeBatchedDetector(mesh=)`` over 4 positions equals the
    unsharded one for each cascade, and JAX's single-device detector for
    frontalface_default."""
    names = (DEFAULT, PROFILE)
    specs = [ct.load_cascade(n) for n in names]
    kw = dict(max_stages=STAGES, device="cpu")
    multi = ct.MultiCascadeBatchedDetector(specs, SHAPE, 8, mesh=_mesh(4),
                                           **kw)
    got = multi.detect(_frames(), min_neighbors=0)
    want = ct.MultiCascadeBatchedDetector(specs, SHAPE, 8, **kw).detect(
        _frames(), min_neighbors=0)
    assert all(p is not None and p.key[0] == 2 for p in multi._programs)
    for k in range(len(names)):
        for b in range(8):
            np.testing.assert_array_equal(got[k][b].candidates,
                                          want[k][b].candidates)
    _assert_jax_frames(got[0])
    assert sum(len(r.candidates) for r in got[1]) > 0


@pytest.mark.slow
def test_batch_mesh_full_depth():
    """``test_batched_full_depth_matches_single``: full-depth
    frontalface_alt at 240x320 over 8 positions equals JAX's
    single-device detector."""
    name, shape = "haarcascade_frontalface_alt", (240, 320)
    frames = np.stack([synth_face(shape, size=80.0, seed=i)
                       for i in range(8)])
    det = ct.BatchedPyramidDetector(ct.load_cascade(name), shape, 8,
                                    mesh=_mesh(8), min_size=(40, 40),
                                    device="cpu")
    res = det.detect(frames, min_neighbors=0)
    jdet = JPyramid(j_load_cascade(name), shape, min_size=(40, 40))
    total = 0
    for i in range(8):
        want, _ = jdet.candidates(frames[i])
        np.testing.assert_array_equal(res[i].candidates, np.asarray(want))
        total += len(want)
    assert total > 0


# ---------------------------------------------------------- scale split
@functools.lru_cache(maxsize=None)
def _jax_scale():
    """JAX's float64 scale-cascade detector, one compile for both cases."""
    return JScale(j_load_cascade(DEFAULT), SHAPE, max_stages=8,
                  dtype=jnp.float64)


def _scale(max_stages, **kw):
    return ct.ScaleCascadeDetector(ct.load_cascade(DEFAULT), SHAPE,
                                   max_stages=max_stages, device="cpu",
                                   **kw)


def test_scale_split_matches_jax():
    """``test_scale_split_matches_single``: 8 positions, scale i on
    position i % 8, the host merge in scale order; candidates equal to
    JAX's single-device ones in order."""
    frame = _face(SHAPE, 44.0, 2)
    det = _scale(8, dtype=torch.float64)
    det.candidates(frame)
    assert det._program is not None
    det.shard_scales([CPU] * 8)
    assert det._program is None, "a program made before the split stays"
    got, ovf = det.candidates(frame)
    want, want_ovf = _jax_scale().candidates(frame)
    assert len(want) > 0
    np.testing.assert_array_equal(got, np.asarray(want))
    assert ovf == want_ovf


def test_scale_split_grouped_detection():
    """``test_scale_split_grouped_detection``: 4 positions, grouped boxes
    and candidates equal to JAX's single-device detection."""
    frame = _face(SHAPE, 50.0, 4)
    det = _scale(8, dtype=torch.float64).shard_scales([CPU] * 4)
    got = det.detect(frame, 1)
    want = _jax_scale().detect(frame, 1)
    assert len(want.boxes) > 0
    np.testing.assert_array_equal(got.boxes, want.boxes)
    np.testing.assert_array_equal(got.candidates, want.candidates)


def test_scale_split_fbo_still_single_device():
    """find-biggest-object stays on the detector's device after
    ``shard_scales``: its box equals the unsplit detector's (held to
    JAX's in ``test_torch_golden.py``)."""
    frame = _face(SHAPE, 50.0, 6)
    ref = _scale(6).find_biggest_object(frame, min_neighbors=1)
    det = _scale(6).shard_scales([CPU] * 8)
    got = det.find_biggest_object(frame, min_neighbors=1)
    assert got.shape == (1, 4)
    np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------- error paths
@pytest.mark.parametrize("case", ["batch", "multi_batch", "axis", "empty",
                                  "empty_scales", "mixed", "no_card"])
def test_mesh_refuses(case, monkeypatch):
    """A batch the mesh does not divide (JAX's message), a missing axis,
    an empty device list, devices of two types, and
    ``data_parallel_mesh()`` without a card: each raises."""
    spec = ct.load_cascade(DEFAULT)
    if case == "batch":
        with pytest.raises(ValueError, match="batch 6 not divisible by "
                           "mesh size 4"):
            ct.BatchedPyramidDetector(spec, SHAPE, 6, mesh=_mesh(4),
                                      max_stages=2, device="cpu")
    elif case == "multi_batch":
        with pytest.raises(ValueError, match="batch 5 not divisible by "
                           "mesh size 2"):
            ct.MultiCascadeBatchedDetector([spec], SHAPE, 5, mesh=_mesh(2),
                                           max_stages=2, device="cpu")
    elif case == "axis":
        with pytest.raises(ValueError, match="mesh has no axis 'data'"):
            ct.BatchedPyramidDetector(spec, SHAPE, 4,
                                      mesh=_mesh(2, "strips"),
                                      max_stages=2, device="cpu")
    elif case == "empty":
        with pytest.raises(ValueError, match="at least one device"):
            data_parallel_mesh([])
    elif case == "empty_scales":
        with pytest.raises(ValueError, match="need at least one device"):
            _scale(2).shard_scales([])
    elif case == "mixed":
        with pytest.raises(ValueError, match="of one type"):
            Mesh([CPU, torch.device("cuda", 0)])
    else:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            data_parallel_mesh()
