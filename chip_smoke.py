#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``clfacedetection_torch/csrc``, holds each
kernel against its plain PyTorch version on the card at the 1080p shapes
of the headline settings (scaleFactor 1.1, minSize 40x40, minNeighbors 3,
front_stages 10, cap 20480), drives the main paths through the entry
points and times kernels and paths with CUDA events:

* tail2's path: frontalface_alt (stumps, upright): front, compaction and
  tail2 kernels, ``PyramidDetector.detect``, a VGA frame against the CPU,
  a batch-8 ``detect_stream`` against single frames;
* the v1 tail's path: frontalface_alt2 (CART), eye_tree_eyeglasses (CART
  of three nodes, tilted) and frontalface_alt_tree (stage tree): the front
  with its CART and tilted branches and the v1 tail kernel bit-equal to
  their plain versions, ``detect`` equal to the plain path on the card;
  ``strategy="block"`` on frontalface_alt equal to the per-stage path; a
  VGA sweep of the 15 cascades this path serves against the CPU; a
  batch-8 ``detect_stream`` of frontalface_alt2 against single frames;
* the v1 tail's decisions kernel (``csrc/tail_rows.cu``: votes, stage
  sums, stage-tree paths) bit-equal to its plain version (the parent's
  torch code) on those three cascades at their main paths' slot counts
  (alt_tree's regrown 327,680), all padding, a ragged cap, from a CUDA
  graph and at batch 8; timed with events, from a graph and beside its
  plain version, with its bound from the run's exit stages;
* the v1 route's walk (``csrc/tail_walk.cu``: the default strategy's tail
  for every cascade tail2 refuses, each survivor's stages walked from the
  integral planes): bit-equal to its plain version (the entering slots
  listed, and every slot under a mask as in a float64 graph) and to
  ``tail_rows`` on ``haar_tail``'s values, on those three cascades at
  their main paths' slot counts, all padding, a cap that is no multiple
  of its 16-slot chunk, from a CUDA graph and at batch 8; timed with
  events, from a graph and beside its plain version and that pair, with
  its bound from the stages this run's survivors enter; the alt2 and
  alt_tree frames from their captured graphs on the default route and on
  ``strategy="block"`` in turns, with the memory each graph reserves;
* ``strategy="direct"`` (the stencil product, then the decisions kernel)
  on frontalface_alt at 1080p against the CPU's direct path within the
  docs/PARITY.md bounds, timed; the ROC output (``candidates_with_levels``)
  of frontalface_alt (tail2) and frontalface_alt2 (the v1 tail), its packed
  readback bit-equal to the plain path's; float64 on the card (the plain
  front and tails, the compaction kernel) box for box with the CPU at
  VGA;
* the JAX bench's scene: ``photo_scene`` at 1080p through frontalface_alt's
  ``detect``, equal to the plain path, its front survivors printed beside
  the JAX's 18,388;
* scale-cascade mode (``ScaleCascadeDetector``, plain PyTorch over the
  scales; its compactions run the compaction kernel): the reference demo's
  configuration (frontalface_default, 640x480, scaleFactor 1.1, minSize
  40x40) through ``CascadeClassifier(mode="scale_cascade")``, the card
  against the CPU in float32 (PARITY bounds, minNeighbors 3 and 0) and in
  float64 (box for box), timed at front 3 and at front ``n_stages`` (from
  the detector's CUDA graph; the eager frame beside it); CART,
  tilted, stage-tree and Canny-pruning cascades at 240x320 against the CPU
  (``canny`` on the card bit-equal to ``canny_np``); find-biggest-object's
  search on the card in float64 against the golden path, with and without
  rough search; frontalface_alt at 1080p timed, float32 against the
  card's float64; its launches a frame from the profiler at the end;
* the chain microbenchmark (``mb_vpu3``): the chain kernel bit-equal to its
  plain version at float32 [2272, 384] -> [2272, 1280] and at 64 x 512 for
  its five bodies at 4 and 16 trips, then the tool
  ``clfacedetection_torch.tools.mb_vpu3`` with every count from 0: the op
  rates, the SASS of the trip loops (checked: each
  trip loads its window's shared words once, holds at least the source's
  float operations and loads nothing from device memory), their issue and
  shared-memory floors at the SM clock sampled meanwhile, ``ptxas``'s
  spills (none allowed), the bf16 product chain and the front sweep on
  ``photo_scene``.

tail2 is held bit-equal at batch 1 and 8, on ``photo_scene``, with every
slot padding, at a cap that is no multiple of its chunk (16 slots at cap
20,480), with an overflowing compaction, replayed from a CUDA graph, and
in the benchmark's regime (8 1080p ``photo_scene`` frames at
``front_stages`` 4 and cap 1,048,576, 72% padding, timed a frame); the v1 tail with
every slot padding, at a cap that is no multiple of 32 and at batch 8
(frontalface_alt2 and eye_tree_eyeglasses).  Both are timed at batch 1
and per frame at batch 8, with CUDA events around back-to-back calls and
from a replayed CUDA graph (device time alone).  Both lay out their
shared memory at launch, so every cascade of the zoo runs each tail that
serves it at 240x320 (tail2 at every ``front_k``; the decisions kernel
and the walk on every cascade), bit-equal to plain.  The v1 path's phase
breakdowns (alt2 at batch 1 and 8, alt_tree at batch 1) put the walk's
time beside its bound, its plain version's time and the pair's time on
the same slots.

The front is held bit-equal at batch 1 and 8 and at a ragged grid (batch
2); its per-stage prefix times and the lane work of the old and the new
lane assignment come from its own masks.  The compaction is held
bit-equal at batch 1 and 8, all-false, all-true, ragged and overflowing,
and replayed from a CUDA graph, and timed two ways beside
``torch.nonzero_static``: CUDA events around back-to-back calls (call ms,
host included) and device time alone (a CUDA graph of the calls replayed,
and ``torch.profiler`` kernel durations).  The profiler runs last: once
it has run, every later launch of the process costs more host time
(measured by timing frontalface_alt's batch-1 pipeline again after it).

The ``programs`` phase holds every float32 path's captured CUDA graph
(``runtime/program.py``) against its eager path, byte for byte in the
readback: frontalface_alt at batch 1 and 8 (``synth_scene`` and
``photo_scene``), ``strategy="block"`` and ``"direct"``, the ROC output of
alt and alt2, alt2 and alt_tree (at its regrown 327,680 slots), a batch-8
``detect_stream`` over 8 batches threaded and unthreaded against the eager
stream and one that regrows its cap in the middle, BASELINE config 5
(profileface, upperbody, fullbody) in one ``MultiCascadeBatchedDetector``
graph against each cascade's own detector with one copy to the host a
batch, and scale-cascade mode's demo configuration; it prints eager and
graph ms a frame, capture and instantiation times, graph nodes and the
memory reserved.  Its float64 case holds the float64 graphs (the plain
front and tails, the compaction kernel) against their eager paths byte
for byte and against the CPU's float64 candidates at VGA: frontalface_alt
at batch 1 and 8, frontalface_alt2, frontalface_alt_tree at full depth,
the ROC output of frontalface_alt and the 4-strip program; scale-cascade
mode's demo in float64 is held the same way in its phase.

The ``flops`` phase runs ``PyramidDetector.stage_entering_counts`` on
1080p ``photo_scene`` (the front kernel once a depth, 22 launches) and
checks its count at stage 10 against the front-10 graph's survivors
(18,389) and its last count against a full-depth front's candidates;
``utils/flops.py``'s counts are printed beside the graph's device time.
Early on, the ``context`` line times the compaction's eager call with the
wrappers' old device context (entered on every launch) and with
``kernels.on_device`` (entered only for another card), and the ``smem``
line checks that launches on another stream of a card that is set up do
no shared-memory setup (``csrc/launch.cuh``): the pipelines of two
detectors and the chain kernel's five bodies.

Four phases then take cascade files and the host's native code: ``xml``
writes every zoo cascade as OpenCV XML (the port's writer), loads each by
path through ``CascadeClassifier`` and by name through
``$CLFD_CASCADE_DIR``, and holds the specs equal to the ``.npz`` ones and
the card's candidates and boxes byte-equal to the ``.npz`` route's (VGA
for all 19, 1080p frontalface_alt at batch 8 from its graph, the
scale-cascade demo), printing parse seconds; ``native`` builds the C++
library afresh (seconds, g++ version), fails unless it loads, holds the
native grouping (both variants, thresholds 1 and 3) equal to the numpy
specification on the main paths' own candidates with ms a frame of
each route, and runs the batch-8 stream threaded and unthreaded with
each route in turns (frames/s, equal results); ``oracle`` holds float64
on the card box for box, and float32 within the PARITY bounds, against
the port's C oracle at full depth (1080p ``photo_scene``:
frontalface_alt, alt2, alt_tree; the scale-cascade demo in float64),
printing its windows/s; ``demo`` runs ``tools/demo.py`` with the default
cascade as an XML path.  They run before the profiler, like every timed
phase.

The ``mesh`` phase then runs the multi-device layer (``runtime/mesh.py``,
``parallel/``) on every card where the machine has several, else on
positions that repeat card 0, each on a stream of its own: 1080p
frontalface_alt at batch 8 over 8 positions (every frame's packed
readback byte-equal to the single-device batch-8 program's, on both
scenes; ``detect_sharded`` + ``gather_detections`` box for box), BASELINE
config 5 over 4 positions (byte-equal to the unsharded graph), row strips
on ``photo_scene`` (k = 8 and 4, one regrowing from cap 256 * k, and the
tilted mcs_nose at VGA through the v1 tail) equal to
``PyramidDetector.candidates``, and ``shard_scales`` over 4 positions at
the demo configuration box for box; it prints host and device ms of the
8-strip frame, the batch-8 stream's frames/s and the sharded demo's ms,
each beside the single-device figure, and graph nodes.

A wrapper counts the launches of its kernel that run on the card: eager
calls and a program's warm-up, never a graph capture (which runs
nothing) and never a replay (which calls no wrapper); the programs count
their replays.  The ``launches`` of the kernels line are the main paths'
own runs at the end of the script (frontalface_alt and frontalface_alt2
at 1080p, batch 1, frontalface_alt2 on ``strategy="block"`` (the run that
carries ``haar_tail`` and ``tail_rows`` since the walk took the default
route), scale-cascade mode's demo and frontalface_alt loaded from XML,
each through
``detect`` and its graph replay), counted from ``torch.profiler``'s kernel
records by each kernel's symbol, with every count set to 0 just before;
the profiler runs last because it slows every later launch's host side.

Each phase prints one line; the line before the last is the JSON record
of the kernels, the last ``{"ok": true, "device": {...}}``.  Any failure
exits non-zero before those lines.  Without a CUDA device, or without the
package beside it, the script exits 2 and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

SHAPE = (1080, 1920)
VGA = (480, 640)
CASCADE = "haarcascade_frontalface_alt"
KNOBS = dict(scale_factor=1.1, min_size=(40, 40), front_stages=10,
             cap=20480)
MIN_NEIGHBORS = 3
BATCH = 8
N_BATCHES = 3
FACES = ((540, 960, 90.0), (300, 400, 60.0), (800, 1500, 140.0),
         (200, 1600, 45.0))

KERNELS = [
    ("haar_front", "clfacedetection_torch/csrc/haar_front.cu",
     "clfacedetection_tpu/ops/haar_front.py:47"),
    ("compact", "clfacedetection_torch/csrc/compact.cu",
     "clfacedetection_tpu/ops/compact_kernel.py:37"),
    ("haar_tail2", "clfacedetection_torch/csrc/haar_tail2.cu",
     "clfacedetection_tpu/ops/haar_tail2.py:137"),
    ("haar_tail", "clfacedetection_torch/csrc/haar_tail.cu",
     "clfacedetection_tpu/ops/haar_tail.py:116"),
    ("chain", "clfacedetection_torch/csrc/mb_chain.cu",
     "scripts/mb_vpu3.py:40"),
    # no Pallas kernel: JAX computes the v1 tail's votes and stage sums in
    # XLA on its tail kernel's output
    ("tail_rows", "clfacedetection_torch/csrc/tail_rows.cu",
     "clfacedetection_tpu/detect/pyramid.py:922"),
    # the default route's v1 tail: the TPU kernel's node values and the
    # XLA decisions on them, in one walk
    ("tail_walk", "clfacedetection_torch/csrc/tail_walk.cu",
     "clfacedetection_tpu/ops/haar_tail.py:116"),
]
V1_CASCADES = ("haarcascade_frontalface_alt2",
               "haarcascade_eye_tree_eyeglasses",
               "haarcascade_frontalface_alt_tree")
# the cascades that tail2 refuses and the v1 tail serves
V1_SERVED = (
    "haarcascade_eye_tree_eyeglasses", "haarcascade_frontalface_alt2",
    "haarcascade_frontalface_alt_tree", "haarcascade_fullbody",
    "haarcascade_lefteye_2splits", "haarcascade_lowerbody",
    "haarcascade_mcs_eyepair_big", "haarcascade_mcs_eyepair_small",
    "haarcascade_mcs_lefteye", "haarcascade_mcs_mouth", "haarcascade_mcs_nose",
    "haarcascade_mcs_righteye", "haarcascade_mcs_upperbody",
    "haarcascade_righteye_2splits", "haarcascade_upperbody")
SWEEP_KNOBS = dict(scale_factor=1.1, min_size=(40, 40), front_stages=10,
                   cap=4096)
# the reference demo's configuration (main.cpp:145 with flags=0, SURVEY.md
# C11): scale-cascade mode, frontalface_default (25 stages, 2,913 stumps,
# 24x24 window), 640x480, scaleFactor 1.1, minSize 40x40
DEMO_CASCADE = "haarcascade_frontalface_default"
DEMO_KNOBS = dict(scale_factor=1.1, min_size=(40, 40))
# every scale-cascade path at 240x320, card against CPU: CART, tilted, stage
# tree (its depth cut: a stage tree's tail takes every stage of every
# survivor, which the CPU reference pays for) and Canny pruning; each on a
# frame where it finds candidates at minSize 40x40 (synth_scene's faces are
# 10-31 px there, photo_scene's 60 and 100)
SC_SHAPE = (240, 320)
SC_PATHS = (("haarcascade_frontalface_alt2", None, False, "photo"),
            ("haarcascade_mcs_nose", None, False, "synth"),
            ("haarcascade_frontalface_alt_tree", 12, False, "synth"),
            ("haarcascade_frontalface_default", None, True, "photo"))
# find-biggest-object against the golden path, a per-window Python loop:
# depth cut as in the tests
FBO_STAGES = 6
# the JAX bench's survivors on photo_scene at 1080p, front_k 10 (TPU v5e
# run of the JAX package, docs/PERF.md:57)
JAX_PHOTO_SURVIVORS = 18388
# the card's front-10 survivors there (the front kernel, equal to
# front_plain bit for bit; chip_smoke.py runs on the H100 since the front
# was ported)
PHOTO_SURVIVORS = 18389
# the device-context measurement: back-to-back compaction calls a round
CONTEXT_REPS = 200
# the float64 programs: the strip program's positions (of card 0)
F64_STRIPS = 4
CHAIN_TRIPS = (4, 16)
# the programs phase: batches of the batch-8 stream, the cap a regrowing
# stream starts at, and BASELINE config 5's cascades
STREAM_BATCHES = 8
STREAM_SMALL_CAP = 256
CONFIG5 = ("haarcascade_profileface", "haarcascade_upperbody",
           "haarcascade_fullbody")
# the oracle phase: full-depth parity against the C oracle on photo_scene
ORACLE_CASES = ("haarcascade_frontalface_alt", "haarcascade_frontalface_alt2",
                "haarcascade_frontalface_alt_tree")
ROOT = os.path.dirname(os.path.abspath(__file__))


# each kernel's symbol in csrc/; the profiler's records name it demangled
# ("(anonymous namespace)::front_kernel<true, false>(Front)") or mangled
KERNEL_SYMBOLS = {"haar_front": "front_kernel", "compact": "compact_kernel",
                  "haar_tail2": "tail2_kernel", "haar_tail": "tail_kernel",
                  "chain": "chain_kernel", "tail_rows": "rows_kernel",
                  "tail_walk": "walk_kernel"}


class SmokeFailure(Exception):
    pass


def need(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


T0 = time.perf_counter()


def say(phase: str, **kv) -> None:
    """One line of a phase, with the seconds since the script started."""
    print(f"[{phase}] t={time.perf_counter() - T0:.1f} "
          + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


def frame(seed: int, shape=SHAPE):
    from clfacedetection_torch.utils import synth_scene
    sy, sx = shape[0] / SHAPE[0], shape[1] / SHAPE[1]
    faces = [(cy * sy, cx * sx, s * min(sy, sx)) for cy, cx, s in FACES]
    return synth_scene(shape, faces=faces, seed=seed)


def timed(fn, reps: int) -> float:
    """Device milliseconds per call, from CUDA events, after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


# the port's counters (``clfacedetection_torch.trace``) at ``reset_counts``
_COUNTS_AT_RESET: dict = {}


def _since_reset(name: str):
    from clfacedetection_torch import trace
    return trace.counters().get(name, 0) - _COUNTS_AT_RESET.get(name, 0)


def reset_counts(counters) -> None:
    """Every count from 0: the port's counters are never reset, so this
    takes the snapshot that ``read_counts`` and ``count_routes``
    subtract."""
    from clfacedetection_torch import trace
    _COUNTS_AT_RESET.clear()
    _COUNTS_AT_RESET.update(trace.counters())


def read_counts(counters) -> dict:
    """Each kernel's launches since ``reset_counts`` that its wrapper
    counted (``launches.<wrapper>``): eager calls and programs' warm-ups
    (not graph replays)."""
    import torch
    torch.cuda.synchronize()
    return {k: _since_reset(f"launches.{c.__name__}")
            for k, c in counters.items()}


def count_routes(counters) -> dict:
    """The wrappers' counts and the programs' replays since
    ``reset_counts``."""
    return dict(wrapper=read_counts(counters),
                replays=_since_reset("program.replays"))


def profiled_drive(counters, fn, what: str):
    """``fn()``, a drive of a main path, under ``torch.profiler`` with
    every count from 0.  Returns its result and each kernel's executions
    on the card, from the profiler's kernel records by the kernel's
    symbol (a graph replay's launches included) and their device ms
    (the records' durations summed), beside the wrappers' counts (eager
    launches) and the programs' replays."""
    import re
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    reset_counts(counters)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    wrapper = read_counts(counters)
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    names = [e.name for e in events]

    def mine(sym, name):
        return re.search(rf"(?:^|[\s:\d]){sym}(?:[<(IE]|$)", name)

    launches = {k: sum(1 for n in names if mine(sym, n))
                for k, sym in KERNEL_SYMBOLS.items()}
    device_ms = {k: sum(e.time_range.end - e.time_range.start
                        for e in events if mine(sym, e.name)) / 1e3
                 for k, sym in KERNEL_SYMBOLS.items()}
    need(all(launches[k] >= wrapper[k] for k in launches),
         f"{what}: the profiler saw fewer launches {launches} than the "
         f"wrappers counted {wrapper}")
    return out, dict(launches=launches, device_ms=device_ms, wrapper=wrapper,
                     replays=_since_reset("program.replays"),
                     device_records=len(names))


def host_ms(fn, reps: int) -> float:
    """Host milliseconds per call of ``fn`` (which ends in a readback to
    the host), the mean of ``reps`` calls after one warm-up."""
    fn()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t) * 1e3 / reps


def replay_ms(prog, reps: int) -> float:
    """Device ms per replay of a program's graph: CUDA events around
    ``reps`` back-to-back replays on the program stream."""
    import torch
    s = prog.stream
    with torch.cuda.stream(s):
        prog.graph.replay()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record(s)
        for _ in range(reps):
            prog.graph.replay()
        stop.record(s)
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def graph_nodes(prog):
    """The node count of a program's CUDA graph (``cuGraphGetNodes``), or
    None where this torch keeps no graph after instantiating it."""
    import ctypes
    try:
        raw = prog.graph.raw_cuda_graph()
    except (AttributeError, RuntimeError):
        return None
    n = ctypes.c_size_t(0)
    err = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(raw), None, ctypes.byref(n))
    return int(n.value) if err == 0 else None


def same_bytes(a, b) -> bool:
    """Two numpy arrays of one dtype and shape, equal byte for byte."""
    import numpy as np
    return (a.dtype == b.dtype and a.shape == b.shape
            and np.array_equal(np.ascontiguousarray(a).view(np.uint8),
                               np.ascontiguousarray(b).view(np.uint8)))


def bits_equal(a, b) -> bool:
    import torch
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and bool(torch.equal(a, b))


def max_abs_err(a, b) -> float:
    """Largest |a - b| in float64, a few million elements at a time (the
    v1 tail's outputs reach 11 GB)."""
    a, b = a.reshape(-1), b.reshape(-1)
    step = 1 << 24
    return max((float((a[i:i + step].double() - b[i:i + step].double())
                      .abs().max()) for i in range(0, a.numel(), step)),
               default=0.0)


def peaks():
    """The H100 SXM data-sheet peaks (dense) that the port keeps in
    ``utils/flops.py``: HBM bytes/s, and 32-bit operations/s outside the
    tensor cores (the kernels' integer and float32 arithmetic; the data
    sheet counts an FMA as two, so adds, multiplies, compares and selects
    issue at half this rate: the mb_vpu3 phase measures them)."""
    from clfacedetection_torch.utils.flops import (PEAK_BYTES,
                                                   PEAK_FLOPS_F32_HIGHEST)
    return PEAK_BYTES, PEAK_FLOPS_F32_HIGHEST


def bound(nbytes: float, ops: float) -> dict:
    """The least time the card could take: bytes over the HBM rate or
    operations over the 32-bit rate, whichever is larger."""
    peak_bytes, peak_ops = peaks()
    tb, to = nbytes / peak_bytes * 1e3, ops / peak_ops * 1e3
    return dict(bound_ms=max(tb, to),
                bound_by="bytes" if tb >= to else "operations")


def _rect_ops(table, clfs, root_only: bool) -> float:
    """32-bit operations of one window's pass over classifiers ``clfs``:
    per rect 3 integer adds, a convert, a multiply and an add; per node a
    multiply, a compare and a select; per classifier the stage add.  With
    ``root_only`` a CART classifier counts its root node only (a lower
    bound: the walk visits at least the root)."""
    nr = table.n_rects[clfs]
    nodes = nr[:, :1] if root_only else nr
    return float((nodes * 6).sum() + 3 * (nodes > 0).sum() + len(clfs))


def stage_ops(table):
    import numpy as np
    return np.array([_rect_ops(table, np.arange(c0, c0 + n), True)
                     for c0, n in zip(table.stage_clf0, table.stage_cnt)])


def front_masks(planes, visit, table, front_k):
    """The kernel's masks at depths 0..front_k: depth k is the visited
    windows that pass stages 0..k-1, the windows that enter stage k."""
    from clfacedetection_torch.ops.haar_front import haar_front
    s, hi, lo, tilted = planes
    return [haar_front(s, hi, lo, visit, table, k, tilted=tilted)[0]
            for k in range(front_k + 1)]


def front_bound(planes, visit, table, masks) -> dict:
    """Bytes: every plane read once, the visit mask, the mask and vnf
    written once, the table.  Operations: vnf at every position, then
    each stage's root nodes at the positions that enter it (counted from
    the kernel's own masks)."""
    s, hi, lo, tilted = planes
    B = s.shape[0]
    n = B * visit.numel()
    nbytes = sum(p.numel() * 4 for p in (s, hi, lo, tilted)
                 if p is not None) + visit.numel() + n * 5 \
        + table.packed.nbytes
    ops_st = stage_ops(table)
    ops = 20.0 * n
    for st in range(len(masks) - 1):
        ops += float(masks[st].sum()) * ops_st[st]
    return bound(nbytes, ops)


def lane_work(table, masks) -> dict:
    """Lane-classifiers that the front runs, from its masks (a classifier
    is a stump for stump cascades): ``rows`` for one thread a position and
    a warp on 32 columns of a row, walking a stage while any lane lives
    (the first design); ``tiles`` for a warp on a 32x32 tile that runs
    each stage over its live positions in chunks of 32 (this design);
    ``live`` for the live windows alone."""
    import torch
    import torch.nn.functional as F
    cnt = table.stage_cnt.astype(float)
    rows = tiles = live = 0.0
    for st in range(len(masks) - 1):
        m = masks[st]
        B, hv, wv = m.shape
        m = F.pad(m.to(torch.int32), (0, -wv % 32, 0, -hv % 32))
        H, W = m.shape[1:]
        per_tile = m.reshape(B, H // 32, 32, W // 32, 32).sum((2, 4))
        warps_live = (m.reshape(B, H, W // 32, 32).sum(3) > 0).sum()
        rows += 32 * cnt[st] * float(warps_live)
        tiles += 32 * cnt[st] * float(((per_tile + 31) // 32).sum())
        live += cnt[st] * float(m.sum())
    return dict(rows=rows, tiles=tiles, live=live,
                rows_live_share=live / max(rows, 1.0),
                tiles_live_share=live / max(tiles, 1.0))


def graph_ms(fn, reps: int) -> float:
    """Device ms per call of ``fn`` alone: a CUDA graph of ``reps`` calls
    (warmed up on the capture stream first), replayed five times between
    two CUDA events."""
    import torch
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=s):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        g.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (5 * reps)


def profiled(fn, reps: int) -> dict:
    """Device ms per call of ``fn`` alone from ``torch.profiler``: the
    durations of its kernels (and memsets) summed over ``reps`` calls, and
    their count per call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    every = list(prof.events())
    ev = [e for e in every if e.device_type == DeviceType.CUDA]
    need(len(ev) > 0, f"the profiler saw no device work ({len(every)} "
         f"host events: {sorted({e.name for e in every})[:8]})")
    us = sum(e.time_range.end - e.time_range.start for e in ev)
    return dict(device_ms=us / 1e3 / reps, kernels_per_call=len(ev) / reps)


def profiler_warmup(tries: int = 5) -> list:
    """``torch.profiler`` traces of a small kernel, their records
    discarded, until one holds its device records: the first traces of a
    process have come back without them on the H100 (the first trace in
    one run of four; two traces in a row in another run).  Returns the
    device records each trace saw, for the log; the traces that measure
    need their own."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    x = torch.ones(1024, device="cuda")
    seen = []
    while len(seen) < tries and not any(seen):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            (x + 1).sum()
            torch.cuda.synchronize()
        seen.append(sum(1 for e in prof.events()
                        if e.device_type == DeviceType.CUDA))
    return seen


def nonzero_static(flags, cap):
    import torch
    return lambda: torch.nonzero_static(flags[0], size=cap)


def compaction_times(flags, cap) -> dict:
    """The compaction and ``torch.nonzero_static`` on the same flags, each
    timed with CUDA events around 20 back-to-back calls (host included)
    and from a replayed CUDA graph (device alone); and the compaction of
    one 16,384-flag tile, the kernel's fixed cost."""
    from clfacedetection_torch.ops.compact_kernel import compact
    nz = nonzero_static(flags, cap)
    one = flags[:1, :16384].contiguous()
    return dict(ms=timed(lambda: compact(flags, cap), 20),
                library_ms=timed(nz, 20),
                graph_ms=graph_ms(lambda: compact(flags, cap), 20),
                library_graph_ms=graph_ms(nz, 20),
                one_tile_graph_ms=graph_ms(lambda: compact(one, cap), 20))


def survivor_bases(surv, hv, wv, hp, wp):
    """Flat indices into the [B, Hp, Wp] planes of the top-left corner of
    every valid survivor's window."""
    import torch
    B = surv.shape[0]
    idx = surv.long()
    valid = (idx >= 0) & (idx < hv * wv)
    y = torch.div(idx, wv, rounding_mode="floor")
    frame0 = torch.arange(B, device=surv.device)[:, None] * (hp * wp)
    return (frame0 + y * wp + idx - y * wv)[valid], valid


def corner_offsets(table, clfs, tilted: bool, wp: int):
    """Distinct flat offsets (dy * Wp + dx) of the corners of every rect
    that classifiers ``clfs`` read from one plane (every node counted)."""
    import numpy as np
    live = np.arange(3)[None, None] < table.n_rects[clfs][..., None]
    live &= (table.tilted[clfs] == tilted)[..., None]
    cor = table.corners[clfs][live].astype(np.int64)     # [m, 4, 2]
    return np.unique(cor[..., 0] * wp + cor[..., 1])


def mark(mask, bases, offs) -> None:
    """Set ``mask`` at every base + offset, on the card, in chunks."""
    import torch
    if len(offs) == 0 or bases.numel() == 0:
        return
    off = torch.as_tensor(offs, device=bases.device)
    step = max(1, (1 << 26) // len(offs))
    for i in range(0, bases.numel(), step):
        mask[(bases[i:i + step, None] + off).reshape(-1)] = True


def tail2_bound(table, rows, surv, hv, wv, hp, wp, front_k) -> dict:
    """Bytes: slot indices, each survivor's vnf, every distinct ``sum``
    plane entry that the survivors' walks read (a survivor that exits at
    stage L reads the corners of stages front_k..L; windows overlap, so
    each entry counts once), the rows written, the stump table.
    Operations: the stages each survivor walks, ``front_k`` up to its exit
    stage."""
    import numpy as np
    import torch
    B, cap = surv.shape
    bases, valid = survivor_bases(surv, hv, wv, hp, wp)
    lv = rows[..., 2][valid].long().clamp(max=table.n_stages - 1)
    mask = torch.zeros(B * hp * wp, dtype=torch.bool, device=surv.device)
    for L in torch.unique(lv).tolist():
        clfs = np.arange(int(table.stage_clf0[front_k]),
                         int(table.stage_clf0[L] + table.stage_cnt[L]))
        mark(mask, bases[lv == L], corner_offsets(table, clfs, False, wp))
    n_valid = bases.numel()
    nbytes = B * cap * 4 + n_valid * 4 + int(mask.sum()) * 4 \
        + B * cap * 16 + table.stumps.nbytes
    ops_st = stage_ops(table)
    cum = np.concatenate([[0.0], np.cumsum(ops_st)])
    ops = float((cum[lv.cpu().numpy() + 1] - cum[front_k]).sum())
    return bound(nbytes, ops)


def tail_bound(table, surv, hv, wv, hp, wp) -> dict:
    """Bytes: slot indices, every distinct plane entry that some node of
    some survivor reads (each entry once, however many windows overlap
    it), every node value written, the table.  Operations: every node of
    every survivor."""
    import numpy as np
    import torch
    B, cap = surv.shape
    bases, _ = survivor_bases(surv, hv, wv, hp, wp)
    clfs = np.arange(table.n_clf)
    read = 0
    for tilted in ((False, True) if table.has_tilted else (False,)):
        mask = torch.zeros(B * hp * wp, dtype=torch.bool, device=surv.device)
        mark(mask, bases, corner_offsets(table, clfs, tilted, wp))
        read += int(mask.sum())
    nn = table.n_clf * table.T
    nbytes = B * cap * 4 + read * 4 + B * cap * nn * 4 + table.nodes.nbytes
    ops = bases.numel() * float(table.n_rects.sum() * 6)
    return bound(nbytes, ops)


def stencil_matmul(table, ii, surv, hv, wv):
    """The v1 tail's function as one PyTorch call: prebuilt f32 patches
    [cap, planes*P] times the signed corner-weight stencil [planes*P, NN]
    (the TPU kernel's own body; the package's ``"direct"`` strategy builds
    both, ``ops/stencil.py``).  Returns a timer of the matmul alone (patch
    extraction excluded) and its output."""
    import numpy as np
    import torch
    from clfacedetection_torch.ops.haar_tail import patch_shape
    from clfacedetection_torch.ops.stencil import (build_stencils,
                                                   window_patches)
    ph, pw = patch_shape(table)
    sten = [m for m in build_stencils(table, ph, pw) if m is not None]
    sten_t = torch.from_numpy(np.concatenate(sten)).cuda()
    parts = [window_patches(ii.sum, surv[:1], hv, wv, ph, pw, True)[0]]
    if table.has_tilted:
        parts.append(window_patches(ii.tilted, surv[:1], hv, wv, ph, pw,
                                    False)[0])
    # window-local corrections keep f32 exact, as the TPU kernel does
    patch = torch.cat(parts, dim=1).float()
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ms = timed(lambda: torch.matmul(patch, sten_t), 10)
        out = torch.matmul(patch, sten_t)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return ms, out


def rows_args(det, ii, surv, vnf):
    """The decisions kernel's arguments for slots ``surv``: the v1 tail's
    node values, the survivors' vnf, the slots, Hv*Wv, the table, front_k
    and the stage-tree paths."""
    import torch
    from clfacedetection_torch.ops.haar_tail import haar_tail
    n = det.hv * det.wv
    valid = (surv >= 0) & (surv < n)
    svnf = vnf.reshape(surv.shape[0], -1).gather(
        1, torch.where(valid, surv, 0).long())
    values = haar_tail(ii.sum, ii.tilted, surv, det.hv, det.wv, det.table)
    return (values, svnf, surv, n, det.table, det.front_k,
            det.paths if det.is_tree else None)


def rows_case(det, args, what) -> None:
    """The decisions kernel bit-equal to its plain version on ``args``."""
    from clfacedetection_torch.ops.tail_rows import tail_rows, tail_rows_plain
    need(bits_equal(tail_rows(*args), tail_rows_plain(*args)),
         f"{det.spec.name}: tail_rows ({what}) differs from its plain "
         f"version")


def rows_bound(table, rows, surv, n, front_k, tree: bool) -> dict:
    """Bytes: slot indices, each valid slot's vnf, the node values of the
    stages each valid slot walks (a sequential cascade's slot from front_k
    to its exit stage, a stage tree's every stage), the rows written, the
    table's rows view.  Operations: per classifier walked its root node's
    product, compare and select and the stage add (a lower bound: a CART
    walk visits at least its root)."""
    import numpy as np
    B, cap = surv.shape
    valid = ((surv >= 0) & (surv < n)).cpu().numpy()
    S, T = table.n_stages, table.T
    cnt = table.stage_cnt.astype(np.float64)
    cum = np.concatenate([[0.0], np.cumsum(cnt)])
    if tree:
        clfs = np.full(int(valid.sum()), cum[S])
    else:
        lv = rows[..., 2].cpu().numpy()[valid].astype(np.int64)
        s_lo = min(front_k, S)
        clfs = cum[np.minimum(lv, S - 1) + 1] - cum[s_lo] if s_lo < S \
            else np.zeros(len(lv))
    n_valid = int(valid.sum())
    nbytes = B * cap * 4 + n_valid * 4 + float(clfs.sum()) * T * 4 \
        + B * cap * 16 + table.rows.nbytes
    return bound(nbytes, float(clfs.sum()) * 4 + n_valid * S)


def graph_rows(det, args, want) -> None:
    """The decisions kernel captured in a CUDA graph, replayed three
    times, each replay bit-equal to the plain rows ``want``."""
    import torch
    from clfacedetection_torch.ops.tail_rows import tail_rows
    st = torch.cuda.Stream()
    st.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(st):
        tail_rows(*args)
    torch.cuda.current_stream().wait_stream(st)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=st):
        gr = tail_rows(*args)
    for _ in range(3):
        g.replay()
        torch.cuda.synchronize()
        need(bits_equal(gr, want), f"{det.spec.name}: tail_rows replayed "
             f"from a CUDA graph differs")


def check_rows(det, ii, surv, vnf, stack8=None) -> dict:
    """The decisions kernel at the main path's shapes: bit-equal to its
    plain version on the detector's survivors, with every slot padding, at
    a cap that is no multiple of its 32-slot warp and from a CUDA graph;
    with ``stack8``, at batch 8 too.  Timed with CUDA events, from a
    replayed graph and beside its plain version (the parent's torch code);
    its bound from this run's exit stages."""
    import torch
    from clfacedetection_torch.ops.compact_kernel import compact
    from clfacedetection_torch.ops.haar_front import haar_front
    from clfacedetection_torch.ops.tail_rows import tail_rows, tail_rows_plain
    name = det.spec.name
    args = rows_args(det, ii, surv, vnf)
    rk = tail_rows(*args)
    rp = tail_rows_plain(*args)
    torch.cuda.synchronize()
    need(bits_equal(rk, rp), f"{name}: tail_rows differs from its plain "
         f"version")
    n = det.hv * det.wv
    cases = ["main"]
    rows_case(det, (args[0], args[1], torch.full_like(surv, n)) + args[3:],
              "all padding")
    cases.append("all_padding")
    ragged = det.cap - 7
    need(ragged % 32 != 0, "the ragged cap is a multiple of 32")
    rows_case(det, (args[0][:, :ragged].contiguous(),
                    args[1][:, :ragged].contiguous(),
                    surv[:, :ragged].contiguous()) + args[3:],
              f"cap {ragged}")
    cases.append(f"cap_{ragged}")
    graph_rows(det, args, rp)
    cases.append("graph")
    out = dict(max_abs_err=max_abs_err(rk, rp),
               ms=timed(lambda: tail_rows(*args), 10),
               graph_ms=graph_ms(lambda: tail_rows(*args), 5),
               plain_ms=timed(lambda: tail_rows_plain(*args), 1),
               **rows_bound(det.table, rp, surv, n, det.front_k,
                            det.is_tree),
               library_ms=None, accepted=int((rk[..., 1] > 0).sum()))
    del args, rk, rp
    if stack8 is not None:
        ii8 = det._prep_planes(det.put(stack8))
        fk8, vk8 = haar_front(ii8.sum, ii8.sq_hi, ii8.sq_lo, det._visit,
                              det.table, det.front_k, tilted=ii8.tilted)
        surv8, _ = compact(fk8.reshape(fk8.shape[0], -1), det.cap)
        a8 = rows_args(det, ii8, surv8, vk8)
        rows_case(det, a8, "batch 8")
        cases.append("batch8")
        B8 = surv8.shape[0]
        p8 = tail_rows_plain(*a8)
        out.update(batch8_ms_per_frame=timed(lambda: tail_rows(*a8), 10) / B8,
                   batch8_graph_ms_per_frame=graph_ms(
                       lambda: tail_rows(*a8), 5) / B8,
                   batch8_plain_ms_per_frame=timed(
                       lambda: tail_rows_plain(*a8), 1) / B8,
                   batch8_bound_ms_per_frame=rows_bound(
                       det.table, p8, surv8, n, det.front_k,
                       det.is_tree)["bound_ms"] / B8)
        del a8, p8
    out["cases"] = cases
    say("kernel", name="tail_rows", cascade=name, slots=det.cap,
        cases=",".join(cases), equal_to_plain=True,
        **{k: v for k, v in out.items() if k != "cases"})
    return out


def walk_args(det, ii, surv, vnf):
    """The walk's arguments for slots ``surv``: the planes, the survivors'
    vnf, the slots, the grid, the table, front_k and the stage-tree
    paths."""
    import torch
    n = det.hv * det.wv
    valid = (surv >= 0) & (surv < n)
    svnf = vnf.reshape(surv.shape[0], -1).gather(
        1, torch.where(valid, surv, 0).long())
    return (ii.sum, ii.tilted, svnf, surv, det.hv, det.wv, det.table,
            det.front_k, det.paths if det.is_tree else None)


def pair_rows(args):
    """The rows of the pair that the walk replaces on the default route
    (the ``"block"`` route's tail), on the walk's arguments: every node's
    value (``haar_tail``), then ``tail_rows``."""
    from clfacedetection_torch.ops.haar_tail import haar_tail
    from clfacedetection_torch.ops.tail_rows import tail_rows
    s, t, svnf, surv, hv, wv, table, front_k, paths = args
    return tail_rows(haar_tail(s, t, surv, hv, wv, table), svnf, surv,
                     hv * wv, table, front_k, paths)


def walk_case(det, args, what) -> None:
    """The walk bit-equal to its plain version and to the pair on
    ``args``."""
    from clfacedetection_torch.ops.tail_walk import tail_walk, tail_walk_plain
    got = tail_walk(*args)
    need(bits_equal(got, tail_walk_plain(*args)),
         f"{det.spec.name}: tail_walk ({what}) differs from its plain "
         f"version")
    need(bits_equal(got, pair_rows(args)),
         f"{det.spec.name}: tail_walk ({what}) differs from "
         f"tail_rows(haar_tail(...))")


def walk_entries(args):
    """The plain walk over the slots that enter each stage (on the card,
    its CPU way: the entering slots listed) and, by stage, the flat plane
    indices of the windows it evaluated the stage at (their top-left
    ``sum`` entries): the walk's own work on this run's data."""
    from clfacedetection_torch.ops import tail_walk as twalk
    seen = {}
    real = twalk._stage_sums

    def spy(flat, base, svnf, table, st, *rest):
        seen[st] = base.clone()
        return real(flat, base, svnf, table, st, *rest)

    twalk._stage_sums = spy
    try:
        rows = twalk.tail_walk_plain(*args, masked=False)
    finally:
        twalk._stage_sums = real
    return rows, seen


def walk_bound(table, entries, surv, n, hp, wp) -> dict:
    """Bytes: slot indices, each valid slot's vnf, every distinct plane
    entry (``sum`` and ``tilted``) that the stages the survivors enter
    read (each entry once, however many windows overlap it), the rows
    written, the packed table.  Operations: each stage entered, at each
    window that enters it, its root nodes (a lower bound: a CART walk
    visits at least its root)."""
    import numpy as np
    import torch
    B, cap = surv.shape
    n_valid = int(((surv >= 0) & (surv < n)).sum())
    read = 0
    for tilted in ((False, True) if table.has_tilted else (False,)):
        mask = torch.zeros(B * hp * wp, dtype=torch.bool, device=surv.device)
        for st, bases in entries.items():
            c0 = int(table.stage_clf0[st])
            clfs = np.arange(c0, c0 + int(table.stage_cnt[st]))
            mark(mask, bases, corner_offsets(table, clfs, tilted, wp))
        read += int(mask.sum())
    nbytes = B * cap * 4 + n_valid * 4 + read * 4 + B * cap * 16 \
        + table.packed.nbytes
    ops_st = stage_ops(table)
    ops = sum(float(bases.numel()) * ops_st[st]
              for st, bases in entries.items())
    return dict(bound(nbytes, ops),
                windows_entered=sum(b.numel() for b in entries.values()))


def once_ms(fn):
    """``fn()`` and its device ms, CUDA events around one call."""
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def graph_walk(det, args, want) -> None:
    """The walk captured in a CUDA graph, replayed three times, each
    replay bit-equal to ``want``."""
    import torch
    from clfacedetection_torch.ops.tail_walk import tail_walk
    st = torch.cuda.Stream()
    st.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(st):
        tail_walk(*args)
    torch.cuda.current_stream().wait_stream(st)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=st):
        gr = tail_walk(*args)
    for _ in range(3):
        g.replay()
        torch.cuda.synchronize()
        need(bits_equal(gr, want), f"{det.spec.name}: tail_walk replayed "
             f"from a CUDA graph differs")


def check_walk(det, ii, surv, vnf, stack8=None) -> dict:
    """The walk at the main path's shapes: bit-equal to its plain version
    (both ways: the entering slots listed, and every slot under a mask as
    in a float64 graph) and to the pair it replaces (``tail_rows`` on
    ``haar_tail``'s values) on the detector's survivors; with every slot
    padding, at a cap that is no multiple of its 16-slot chunk and from a
    CUDA graph; with ``stack8``, at batch 8 too.  Timed with CUDA events,
    from a replayed graph and beside its plain version and the pair; its
    bound from the stages this run's survivors enter."""
    import torch
    from clfacedetection_torch.ops.compact_kernel import compact
    from clfacedetection_torch.ops.haar_front import haar_front
    from clfacedetection_torch.ops.tail_walk import tail_walk, tail_walk_plain
    name = det.spec.name
    n = det.hv * det.wv
    hp, wp = ii.sum.shape[1:]
    args = walk_args(det, ii, surv, vnf)
    rk = tail_walk(*args)
    rp, entries = walk_entries(args)
    rm, plain_ms = once_ms(lambda: tail_walk_plain(*args))
    need(bits_equal(rk, rp) and bits_equal(rk, rm),
         f"{name}: tail_walk differs from its plain version")
    pr = pair_rows(args)
    need(bits_equal(rk, pr), f"{name}: tail_walk differs from "
         f"tail_rows(haar_tail(...))")
    out = dict(max_abs_err=max(max_abs_err(rk, rp), max_abs_err(rk, rm)),
               pair_max_abs_err=max_abs_err(rk, pr))
    del rp, rm, pr
    cases = ["main", "plain_listed", "plain_masked", "pair"]
    walk_case(det, args[:3] + (torch.full_like(surv, n),) + args[4:],
              "all padding")
    cases.append("all_padding")
    ragged = det.cap - 7
    need(ragged % 16 != 0, "the ragged cap is a multiple of 16")
    walk_case(det, args[:2] + (args[2][:, :ragged].contiguous(),
                               surv[:, :ragged].contiguous()) + args[4:],
              f"cap {ragged}")
    cases.append(f"cap_{ragged}")
    graph_walk(det, args, rk)
    cases.append("graph")
    out.update(ms=timed(lambda: tail_walk(*args), 10),
               graph_ms=graph_ms(lambda: tail_walk(*args), 5),
               plain_ms=plain_ms,
               pair_ms=timed(lambda: pair_rows(args), 3),
               **walk_bound(det.table, entries, surv, n, hp, wp),
               library_ms=None, accepted=int((rk[..., 1] > 0).sum()),
               survivors=int(((surv >= 0) & (surv < n)).sum()))
    del args, rk, entries
    if stack8 is not None:
        ii8 = det._prep_planes(det.put(stack8))
        fk8, vk8 = haar_front(ii8.sum, ii8.sq_hi, ii8.sq_lo, det._visit,
                              det.table, det.front_k, tilted=ii8.tilted)
        surv8, _ = compact(fk8.reshape(fk8.shape[0], -1), det.cap)
        a8 = walk_args(det, ii8, surv8, vk8)
        walk_case(det, a8, "batch 8")
        cases.append("batch8")
        B8 = surv8.shape[0]
        _, e8 = walk_entries(a8)
        _, p8 = once_ms(lambda: tail_walk_plain(*a8))
        out.update(batch8_ms_per_frame=timed(lambda: tail_walk(*a8), 10) / B8,
                   batch8_graph_ms_per_frame=graph_ms(
                       lambda: tail_walk(*a8), 5) / B8,
                   batch8_plain_ms_per_frame=p8 / B8,
                   batch8_pair_ms_per_frame=timed(
                       lambda: pair_rows(a8), 3) / B8,
                   batch8_bound_ms_per_frame=walk_bound(
                       det.table, e8, surv8, n, hp, wp)["bound_ms"] / B8)
        del a8, e8
    out["cases"] = cases
    say("kernel", name="tail_walk", cascade=name, slots=det.cap,
        cases=",".join(cases), equal_to_plain=True, equal_to_pair=True,
        **{k: v for k, v in out.items() if k != "cases"})
    return out


def walk_scenes(det, scenes) -> dict:
    """The walk on each scene of ``scenes`` (name -> a frame) at batch 1
    and at batch 8 (eight copies of the frame, or ``stack8`` for
    ``synth``): bit-equal to its plain version on the front's survivors
    (the cap grown 4x while a frame overflows it), its device ms a frame
    (CUDA events around back-to-back calls) and its bound a frame from
    the stages this run's survivors enter."""
    import numpy as np
    from clfacedetection_torch.ops.compact_kernel import compact
    from clfacedetection_torch.ops.haar_front import haar_front
    from clfacedetection_torch.ops.tail_walk import tail_walk
    out = {}
    for scene, frames in scenes.items():
        for frames_ in (frames[:1], frames if len(frames) == BATCH
                        else np.stack([frames[0]] * BATCH)):
            B = len(frames_)
            ii = det._prep_planes(det.put(frames_))
            fk, vk = haar_front(ii.sum, ii.sq_hi, ii.sq_lo, det._visit,
                                det.table, det.front_k, tilted=ii.tilted)
            flat = fk.reshape(B, -1)
            n_true = int(flat.sum(1).max())
            cap = det.cap
            while cap < n_true:
                cap *= 4
            surv, _ = compact(flat, cap)
            args = walk_args(det, ii, surv, vk)
            rp, entries = walk_entries(args)
            need(bits_equal(tail_walk(*args), rp),
                 f"{det.spec.name}: tail_walk on {scene} at batch {B} "
                 f"differs from its plain version")
            b = walk_bound(det.table, entries, surv, det.hv * det.wv,
                           *ii.sum.shape[1:])
            out[f"{scene}_b{B}"] = dict(
                cap=cap, survivors=int(flat.sum()),
                windows_entered=b["windows_entered"],
                ms_per_frame=timed(lambda: tail_walk(*args), 10) / B,
                bound_ms_per_frame=b["bound_ms"] / B, bound_by=b["bound_by"])
            del args, rp, entries, ii, fk, vk, surv
    say("walk_scenes", cascade=det.spec.name, equal_to_plain=True,
        **{k: json.dumps(v) for k, v in out.items()})
    return out


def route_programs(ct, det, gray, what):
    """The frame on the default route (the walk) and on ``"block"`` (the
    pair), each from a fresh detector's captured graph at ``det``'s cap,
    in turns: ``program_case`` of each, and the memory its capture left
    reserved (``memory_reserved`` after the capture and ``empty_cache``,
    less before it)."""
    import torch
    out = []
    for strategy in (None, "block"):
        d = ct.PyramidDetector(det.spec, SHAPE, device="cuda",
                               strategy=strategy, **dict(KNOBS, cap=det.cap))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        r0 = torch.cuda.memory_reserved()
        d.program(1, d.cap)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        pool = (torch.cuda.memory_reserved() - r0) / 1e9
        route = "block" if strategy else "walk"
        rec = program_case(d, gray[None], f"{what} {route}", reps=3)
        rec["graph_reserved_gb"] = pool
        say("programs", case=f"{what} {route}", graph_reserved_gb=pool)
        release_programs(d)
        del d
        out.append(rec)
    return out


def _iou(a, b) -> float:
    iw = max(0, min(a[0] + a[2], b[0] + b[2]) - max(a[0], b[0]))
    ih = max(0, min(a[1] + a[3], b[1] + b[3]) - max(a[1], b[1]))
    inter = iw * ih
    return inter / float(a[2] * a[3] + b[2] * b[3] - inter)


def parity(a, b) -> dict:
    """docs/PARITY.md's f32 bounds between two results: the candidate
    sets' Jaccard, and whether the grouped boxes match 1:1 at IoU >= 0.9."""
    sa = set(map(tuple, a.candidates.tolist()))
    sb = set(map(tuple, b.candidates.tolist()))
    jac = len(sa & sb) / max(1, len(sa | sb))
    matched = len(a.boxes) == len(b.boxes) and all(
        max(_iou(x, y) for y in b.boxes) >= 0.9 for x in a.boxes)
    return dict(jaccard=jac, boxes_matched=bool(matched),
                n_candidates=[len(sa), len(sb)])


def check_front_batch(det, frames) -> float:
    """The front at batch B bit-equal to the plain front; returns its ms
    per frame."""
    from clfacedetection_torch.ops.haar_front import front_plain, haar_front
    ii = det._prep_planes(frames)
    args = (ii.sum, ii.sq_hi, ii.sq_lo, det._visit, det.table, det.front_k)
    fk, vk = haar_front(*args, tilted=ii.tilted)
    fp, vp = front_plain(*args, tilted=ii.tilted)
    need(bits_equal(fk, fp) and bits_equal(vk, vp),
         f"front at batch {frames.shape[0]} differs from the plain front")
    ms = timed(lambda: haar_front(*args, tilted=ii.tilted), 10) \
        / frames.shape[0]
    say("front_batch", batch=frames.shape[0], survivors=int(fk.sum()),
        equal_to_plain=True, ms_per_frame=ms)
    return ms


def check_front_ragged(spec) -> None:
    """The front on a grid that is no multiple of the tile on either axis
    (a 479x641 pair's canvas, cut to 549x709 positions), batch 2."""
    import numpy as np
    import clfacedetection_torch as ct
    from clfacedetection_torch.ops.haar_front import front_plain, haar_front
    shape = (479, 641)
    det = ct.PyramidDetector(spec, shape, device="cuda", **KNOBS)
    ii = det._prep_planes(det.put(np.stack([frame(sd, shape)
                                            for sd in (3, 11)])))
    hv, wv = det.hv - 13, det.wv - 59
    need(hv % 32 and wv % 32, f"grid {hv}x{wv} is not ragged")
    py, px = ii.sum.shape[1] - det.hv, ii.sum.shape[2] - det.wv
    s, hi, lo = (p[:, :hv + py, :wv + px].contiguous() for p in ii[:3])
    visit = det._visit[:hv, :wv].contiguous()
    args = (s, hi, lo, visit, det.table, det.front_k)
    fk, vk = haar_front(*args)
    fp, vp = front_plain(*args)
    need(bits_equal(fk, fp) and bits_equal(vk, vp),
         "front on the ragged grid differs from the plain front")
    say("front_ragged", grid=f"{hv}x{wv}", batch=2,
        plane=f"{s.shape[1]}x{s.shape[2]}", survivors=int(fk.sum()),
        equal_to_plain=True)


def check_compaction(flags1, flags8, cap) -> None:
    """The compaction bit-equal to the plain one, with the true count: at
    batch 1 and 8, all-false, all-true, flag counts that are no multiple
    of the 16,384-flag tile (and of 16, which takes the byte loads),
    forced overflow, and replayed from a CUDA graph."""
    import torch
    from clfacedetection_torch.ops.compact_kernel import (compact,
                                                          compact_plain)
    gen = torch.Generator(device=flags1.device)
    gen.manual_seed(7)

    def rand(B, n, rate):
        return torch.rand((B, n), generator=gen, device=flags1.device) < rate

    n8 = flags8.shape[1]
    n_true = int(flags1.sum())
    cases = [
        ("batch1", flags1, cap),
        ("overflow", flags1, max(1, n_true // 2)),
        ("batch8", flags8, cap),
        ("all_false", torch.zeros_like(flags8), cap),
        ("all_true", torch.ones_like(flags8), cap),
        ("ragged_n", rand(3, 16384 * 5 + 1232, 0.01), 1000),
        ("n_not_16", rand(2, 100003, 0.3), 40000),
        ("tiny_n", rand(3, 5, 0.5), 8),
    ]
    for what, f, c in cases:
        ik, nk = compact(f, c)
        ip, np_ = compact_plain(f, c)
        need(bits_equal(ik, ip) and bits_equal(nk, np_)
             and bits_equal(nk, f.sum(1, dtype=torch.int32)),
             f"compaction ({what}) differs from the plain one")
    need(int(compact(flags1, cases[1][2])[1][0]) > cases[1][2],
         "the overflowing compaction hides the overflow")
    # a graph replays the same launch: the scratch must clean itself
    ip, np_ = compact_plain(flags8, cap)
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        compact(flags8, cap)
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=s):
        gi, gn = compact(flags8, cap)
    for _ in range(3):
        g.replay()
        torch.cuda.synchronize()
        need(bits_equal(gi, ip) and bits_equal(gn, np_),
             "compaction replayed from a CUDA graph differs")
    say("compact_cases", cases=",".join(c[0] for c in cases) + ",graph",
        n=n8, equal_to_plain=True)


def unfused_front(det, ii, mask) -> dict:
    """The front's survivors with the variance rounded as the TPU rounds it
    (``win_sq * inv`` and ``mean * mean`` each rounded, then subtracted:
    no fma, where XLA:CPU, the plain front and the kernel fuse), the same
    votes; and the windows where that mask differs from ``mask``."""
    import numpy as np
    import torch
    from clfacedetection_torch.ops.haar_front import _rect, front_votes_plain
    t = det.table
    hv, wv = det._visit.shape
    ya, xa, yb, xb = t.equ

    def rect(p):
        return _rect(p, ya, xa, yb, xb, hv, wv).float()

    inv = float(np.float32(t.inv_area))
    mean = rect(ii.sum) * inv
    var = (rect(ii.sq_hi) * 256.0 + rect(ii.sq_lo)) * inv - mean * mean
    vnf = torch.where(var >= 0, torch.sqrt(var.clamp(min=0)),
                      torch.ones_like(var))
    m = front_votes_plain(ii.sum, det._visit, t, det.front_k, vnf)
    diff = (m != mask).nonzero()
    return dict(survivors=int(m.sum()), n_differ=int(diff.shape[0]),
                differ=diff[:8].tolist())


def check_kernels(det, gray, stack8):
    """Each kernel against its plain version on the card, at the main
    path's shapes; returns per-kernel error and times, and the survivor
    flags that the compaction took."""
    import torch
    from clfacedetection_torch.ops.compact_kernel import (compact,
                                                          compact_plain)
    from clfacedetection_torch.ops.haar_front import front_plain, haar_front
    from clfacedetection_torch.ops.haar_tail2 import haar_tail2, tail2_plain
    frames = det.put(gray)
    ii = det._prep_planes(frames)
    s, hi, lo = ii[:3]
    args = (s, hi, lo, det._visit, det.table, det.front_k)
    fk, vk = haar_front(*args)
    fp, vp = front_plain(*args)
    torch.cuda.synchronize()
    need(bits_equal(fk, fp), "front mask differs from its plain version")
    need(bits_equal(vk, vp), "front vnf differs from its plain version")
    masks = front_masks(ii, det._visit, det.table, det.front_k)
    need(bits_equal(masks[-1], fk), "front masks disagree")
    prefix = [timed(lambda k=k: haar_front(s, hi, lo, det._visit, det.table,
                                           k), 10)
              for k in range(1, det.front_k + 1)]
    out = {"haar_front": dict(
        max_abs_err=max(max_abs_err(vk, vp), max_abs_err(fk, fp)),
        ms=timed(lambda: haar_front(*args), 20),
        plain_ms=timed(lambda: front_plain(*args), 2),
        **front_bound(ii, det._visit, det.table, masks),
        library_ms=None, prefix_ms=prefix,
        lane_classifiers=lane_work(det.table, masks))}
    say("kernel", name="haar_front", grid=f"{det.hv}x{det.wv}",
        survivors=int(fk.sum()), **out["haar_front"])
    frames8 = det.put(stack8)
    out["haar_front"]["batch8_ms_per_frame"] = check_front_batch(det,
                                                                 frames8)
    check_front_ragged(det.spec)

    flags = fk.reshape(1, -1)
    ii8 = det._prep_planes(frames8)
    fk8, vk8 = haar_front(*ii8[:3], det._visit, det.table, det.front_k)
    check_compaction(flags, fk8.reshape(fk8.shape[0], -1), det.cap)
    ik, nk = compact(flags, det.cap)
    ip, np_ = compact_plain(flags, det.cap)
    out["compact"] = dict(
        max_abs_err=max_abs_err(ik, ip),
        plain_ms=timed(lambda: compact_plain(flags, det.cap), 5),
        **bound(flags.numel() + det.cap * 4 + 4, float(flags.numel())),
        **compaction_times(flags, det.cap))
    say("kernel", name="compact", flags=flags.shape[1], n=int(nk[0]),
        cap=det.cap, **out["compact"])

    targs = (s, vk, ik, det.table, det.front_k)
    rk = haar_tail2(*targs)
    rp = tail2_plain(*targs)
    need(bits_equal(rk, rp), "tail rows differ from their plain version")
    out["haar_tail2"] = dict(
        max_abs_err=max_abs_err(rk, rp),
        ms=timed(lambda: haar_tail2(*targs), 20),
        graph_ms=graph_ms(lambda: haar_tail2(*targs), 20),
        plain_ms=timed(lambda: tail2_plain(*targs), 2),
        **tail2_bound(det.table, rp, ik, det.hv, det.wv, *s.shape[1:],
                      det.front_k),
        library_ms=None)
    out["haar_tail2"].update(check_tail2_cases(det, targs, rp, ii8, fk8,
                                               vk8))
    say("kernel", name="haar_tail2", slots=det.cap,
        accepted=int((rk[..., 1] > 0).sum()), **out["haar_tail2"])
    return out, flags


def tail2_case(det, s, vnf, surv, what) -> None:
    """tail2 bit-equal to its plain version on these slots."""
    from clfacedetection_torch.ops.haar_tail2 import haar_tail2, tail2_plain
    args = (s, vnf, surv, det.table, det.front_k)
    need(bits_equal(haar_tail2(*args), tail2_plain(*args)),
         f"tail2 ({what}) differs from its plain version")


def check_tail2_stream(spec) -> dict:
    """tail2 in the benchmark's regime: a batch of 8 1080p ``photo_scene``
    frames (three pasted faces each, their sizes and places apart) at
    ``front_stages`` 4, each frame's survivors in a cap of 1,048,576 slots
    (about 72% padding).  Bit-equal to its plain version (run over the
    slots 16,384 at a time), timed with CUDA events and from a replayed
    graph, a frame beside the batch-1 ``synth_scene`` case, with its
    bound from the run's exit stages."""
    import numpy as np
    import torch
    import clfacedetection_torch as ct
    from clfacedetection_torch.ops.compact_kernel import compact
    from clfacedetection_torch.ops.haar_front import haar_front
    from clfacedetection_torch.ops.haar_tail2 import haar_tail2, tail2_plain
    from clfacedetection_torch.utils import photo_scene
    cap, B = 1 << 20, BATCH
    det = ct.PyramidDetector(spec, SHAPE, device="cuda", scale_factor=1.1,
                             min_size=(40, 40), front_stages=4, cap=cap)
    frames = np.stack([photo_scene(SHAPE, (60 + 20 * i, 100 + 10 * i,
                                           140 + 8 * i), seed=i + 1)
                       for i in range(B)])
    ii = det._prep_planes(det.put(frames))
    fk, vk = haar_front(ii.sum, ii.sq_hi, ii.sq_lo, det._visit, det.table,
                        det.front_k)
    surv, n = compact(fk.reshape(B, -1), cap)
    need(int(n.max()) <= cap, "the stream regime overflows its cap")
    args = (ii.sum, vk, surv, det.table, det.front_k)
    rows = haar_tail2(*args)
    step = 1 << 14
    plain = torch.cat([tail2_plain(ii.sum, vk, surv[:, i:i + step]
                                   .contiguous(), det.table, det.front_k)
                       for i in range(0, cap, step)], dim=1)
    need(bits_equal(rows, plain),
         "tail2 (batch 8, cap 1,048,576) differs from its plain version")
    ms = timed(lambda: haar_tail2(*args), 10)
    gms = graph_ms(lambda: haar_tail2(*args), 5)
    out = dict(frames=B, front_k=det.front_k, cap=cap,
               survivors=n.tolist(),
               padding=round(1.0 - float(n.sum()) / (B * cap), 4),
               equal_to_plain=True, ms=ms, graph_ms=gms,
               ms_per_frame=ms / B, graph_ms_per_frame=gms / B,
               **tail2_bound(det.table, plain, surv, det.hv, det.wv,
                             *ii.sum.shape[1:], det.front_k))
    say("kernel", name="haar_tail2", regime="stream_b8_cap1048576", **out)
    return out


def check_tail2_cases(det, targs, rows, ii8, fk8, vk8) -> dict:
    """tail2 bit-equal to its plain version beyond the main path's call:
    at batch 8 (``synth_scene``), every slot padding, a cap that is no
    multiple of the kernel's chunk (16 slots here), an overflowing
    compaction (a true count above the cap: every slot live), and replayed
    from a CUDA graph; the batch-8 times per frame."""
    import torch
    from clfacedetection_torch.ops.compact_kernel import compact
    from clfacedetection_torch.ops.haar_tail2 import haar_tail2
    s, vk, ik, table, front_k = targs
    B8 = fk8.shape[0]
    cases = []
    surv8, n8 = compact(fk8.reshape(B8, -1), det.cap)
    tail2_case(det, ii8.sum, vk8, surv8, "batch 8")
    cases.append("batch8")
    n = det.hv * det.wv
    pad = torch.full_like(ik, n)
    tail2_case(det, s, vk, pad, "all padding")
    cases.append("all_padding")
    ragged = det.cap - 5
    need(ragged % 16 != 0, "the ragged cap is a multiple of the chunk")
    flags = (ik[0] < n).new_zeros(n)
    flags[ik[0][ik[0] < n].long()] = True
    ir, nr = compact(flags[None], ragged)
    need(int(nr[0]) < ragged, "the ragged cap holds no padding")
    tail2_case(det, s, vk, ir, f"cap {ragged}")
    cases.append(f"cap_{ragged}")
    io, no = compact(flags[None], 4096)
    need(int(no[0]) > 4096, "the small cap does not overflow")
    tail2_case(det, s, vk, io, "overflowing cap 4096")
    cases.append("overflow_4096")
    # a graph replays the launch with the same inputs
    st = torch.cuda.Stream()
    st.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(st):
        haar_tail2(*targs)
    torch.cuda.current_stream().wait_stream(st)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=st):
        gr = haar_tail2(*targs)
    for _ in range(3):
        g.replay()
        torch.cuda.synchronize()
        need(bits_equal(gr, rows), "tail2 replayed from a CUDA graph differs")
    cases.append("graph")
    a8 = (ii8.sum, vk8, surv8, table, front_k)
    say("tail2_cases", cases=",".join(cases), equal_to_plain=True)
    return dict(cases=cases,
                batch8_ms_per_frame=timed(lambda: haar_tail2(*a8), 20) / B8,
                batch8_graph_ms_per_frame=graph_ms(
                    lambda: haar_tail2(*a8), 10) / B8,
                batch8_survivors=n8.tolist())


def tail_case(det, planes, surv, what) -> None:
    """The v1 tail bit-equal to its plain version on these slots."""
    from clfacedetection_torch.ops.haar_tail import (haar_tail,
                                                     tail_values_plain)
    args = (planes.sum, planes.tilted, surv, det.hv, det.wv, det.table)
    need(bits_equal(haar_tail(*args), tail_values_plain(*args)),
         f"{det.spec.name}: v1 tail ({what}) differs from its plain version")


def check_tail_cases(det, ii, surv, stack8) -> dict:
    """The v1 tail bit-equal to its plain version with every slot padding,
    at a cap that is no multiple of 32, and at batch 8 (``synth_scene``);
    the batch-8 time per frame."""
    import torch
    from clfacedetection_torch.ops.compact_kernel import compact
    from clfacedetection_torch.ops.haar_front import haar_front
    from clfacedetection_torch.ops.haar_tail import haar_tail
    n = det.hv * det.wv
    tail_case(det, ii, torch.full_like(surv, n), "all padding")
    valid = surv[0][surv[0] < n].long()
    flags = torch.zeros(n, dtype=torch.bool, device=surv.device)
    flags[valid] = True
    ragged = det.cap - 7
    need(ragged % 32 != 0, "the ragged cap is a multiple of 32")
    tail_case(det, ii, compact(flags[None], ragged)[0], f"cap {ragged}")
    ii8 = det._prep_planes(det.put(stack8))
    fk8, _ = haar_front(ii8.sum, ii8.sq_hi, ii8.sq_lo, det._visit, det.table,
                        det.front_k, tilted=ii8.tilted)
    B8 = fk8.shape[0]
    surv8, n8 = compact(fk8.reshape(B8, -1), det.cap)
    tail_case(det, ii8, surv8, "batch 8")
    a8 = (ii8.sum, ii8.tilted, surv8, det.hv, det.wv, det.table)
    cases = ["all_padding", f"cap_{ragged}", "batch8"]
    say("tail_cases", cascade=det.spec.name, cases=",".join(cases),
        equal_to_plain=True)
    return dict(cases=cases,
                batch8_ms_per_frame=timed(lambda: haar_tail(*a8), 10) / B8,
                batch8_graph_ms_per_frame=graph_ms(
                    lambda: haar_tail(*a8), 3) / B8,
                batch8_survivors=n8.tolist())


def check_v1(det, gray, stack8=None) -> dict:
    """The front (CART and tilted branches) and the v1 tail kernel against
    their plain versions at the main path's shapes; with ``stack8``, the
    tail's edge cases and batch 8 too."""
    import torch
    from clfacedetection_torch.ops.compact_kernel import compact
    from clfacedetection_torch.ops.haar_front import front_plain, haar_front
    from clfacedetection_torch.ops.haar_tail import (haar_tail,
                                                     tail_values_plain)
    from clfacedetection_torch.ops.integral import (integral_images,
                                                    tilted_integral)
    frames = det.put(gray)
    ii = det._prep_planes(frames)
    args = (ii.sum, ii.sq_hi, ii.sq_lo, det._visit, det.table, det.front_k)
    fk, vk = haar_front(*args, tilted=ii.tilted)
    fp, vp = front_plain(*args, tilted=ii.tilted)
    torch.cuda.synchronize()
    name = det.spec.name
    need(bits_equal(fk, fp), f"{name}: front mask differs from plain")
    need(bits_equal(vk, vp), f"{name}: front vnf differs from plain")
    masks = front_masks(ii, det._visit, det.table, det.front_k)
    front = dict(
        max_abs_err=max(max_abs_err(vk, vp), max_abs_err(fk, fp)),
        ms=timed(lambda: haar_front(*args, tilted=ii.tilted), 20),
        plain_ms=timed(lambda: front_plain(*args, tilted=ii.tilted), 2),
        **front_bound(ii, det._visit, det.table, masks),
        library_ms=None, lane_classifiers=lane_work(det.table, masks))
    n_true = int(fk.sum())
    need(n_true <= det.cap, f"{name}: {n_true} survivors overflow the cap "
         f"{det.cap} (check after the main path has regrown it)")
    surv, _ = compact(fk.reshape(1, -1), det.cap)
    targs = (ii.sum, ii.tilted, surv, det.hv, det.wv, det.table)
    tk = haar_tail(*targs)
    tp = tail_values_plain(*targs)
    torch.cuda.synchronize()
    need(bits_equal(tk, tp), f"{name}: v1 tail values differ from plain")
    err = max_abs_err(tk, tp)
    del tp
    lib_ms, lib_out = stencil_matmul(det.table, ii, surv, det.hv, det.wv)
    lib_err = max_abs_err(lib_out[:n_true], tk[0, :n_true])
    del lib_out
    n_nodes = tk.shape[2]
    del tk
    tail = dict(
        max_abs_err=err,
        ms=timed(lambda: haar_tail(*targs), 10),
        plain_ms=timed(lambda: tail_values_plain(*targs), 1),
        **tail_bound(det.table, surv, det.hv, det.wv, *ii.sum.shape[1:]),
        library_ms=lib_ms,
        library_max_abs_err=lib_err)
    if det.cap <= KNOBS["cap"]:
        # device time alone; a graph of alt_tree's 11 GB outputs would not
        # fit, and its calls are long enough for the host not to show
        tail["graph_ms"] = graph_ms(lambda: haar_tail(*targs), 5)
    if stack8 is not None:
        tail.update(check_tail_cases(det, ii, surv, stack8))
    say("kernel", name="haar_front", cascade=name, front_k=det.front_k,
        survivors=n_true, **front)
    say("kernel", name="haar_tail", cascade=name, slots=det.cap,
        nodes=n_nodes, **tail)
    out = {"haar_front": front, "haar_tail": tail,
           "tail_rows": check_rows(det, ii, surv, vk, stack8),
           "tail_walk": check_walk(det, ii, surv, vk, stack8)}
    if det.table.has_tilted:
        canvas = det._assemble_canvas(frames)
        out["rsat_ms"] = timed(lambda: tilted_integral(canvas), 10)
        out["integrals_ms"] = timed(lambda: integral_images(canvas), 10)
        say("rsat", cascade=name, canvas=f"{canvas.shape[1]}x"
            f"{canvas.shape[2]}", rsat_ms=out["rsat_ms"],
            three_upright_integrals_ms=out["integrals_ms"])
    return out


def check_zoo_tails(ct) -> dict:
    """Each tail's block laid out and launched for every cascade of the
    zoo on a 240x320 ``synth_scene``, bit-equal to its plain version on
    the front's survivors: tail2 at every ``front_k`` of the cascades it
    serves (every stage count of its shared-memory layout), the v1 tail,
    its decisions kernel and the walk at the detector's ``front_k`` for
    all (the patch stride, slots a block, T, the round of records and the
    stage tree; the walk also equal to the pair)."""
    import glob
    import torch
    from clfacedetection_torch.models.zoo import artifact_dir
    from clfacedetection_torch.ops.compact_kernel import compact
    from clfacedetection_torch.ops.haar_front import haar_front
    from clfacedetection_torch.ops.haar_tail import (haar_tail,
                                                     tail_values_plain)
    from clfacedetection_torch.ops.haar_tail2 import haar_tail2, tail2_plain
    shape = (240, 320)
    g = frame(5, shape)
    served = {}
    for path in sorted(glob.glob(os.path.join(artifact_dir(), "*.npz"))):
        cname = os.path.basename(path)[:-4]
        det = ct.PyramidDetector(ct.load_cascade(cname), shape,
                                 device="cuda", **SWEEP_KNOBS)
        ii = det._prep_planes(det.put(g))
        tab = det.table

        def survivors(fk):
            mask, vnf = haar_front(ii.sum, ii.sq_hi, ii.sq_lo, det._visit,
                                   tab, fk, tilted=ii.tilted)
            return compact(mask.reshape(1, -1), det.cap)[0], vnf

        depths = range(tab.n_stages + 1) if det.use_tail2 else ()
        for fk in depths:
            surv, vnf = survivors(fk)
            args = (ii.sum, vnf, surv, tab, fk)
            need(bits_equal(haar_tail2(*args), tail2_plain(*args)),
                 f"{cname}: tail2 at front_k {fk} differs from plain")
        surv, vnf = survivors(det.front_k)
        args = (ii.sum, ii.tilted, surv, det.hv, det.wv, tab)
        need(bits_equal(haar_tail(*args), tail_values_plain(*args)),
             f"{cname}: v1 tail differs from plain")
        rows_case(det, rows_args(det, ii, surv, vnf), "zoo")
        walk_case(det, walk_args(det, ii, surv, vnf), "zoo")
        served[cname] = "tail2+v1" if det.use_tail2 else "v1"
        del det, ii
    torch.cuda.synchronize()
    say("zoo_tails", shape=f"{shape[0]}x{shape[1]}", cascades=len(served),
        tail2=sum(v != "v1" for v in served.values()), tail_rows=len(served),
        tail_walk=len(served), equal_to_plain=True)
    return served


# the chain's second shape, where a block's run of tiles is short (most
# blocks of the grid get none)
CHAIN_SMALL = (64, 512)


def check_chain() -> dict:
    """The chain kernel bit-equal to its plain version for every body at 4
    and 16 trips, at the JAX's full shape, float32 [2272, 384] -> [2272,
    1280], and at ``CHAIN_SMALL``; at the full shape the plain version's
    time and the bound of each.  Bytes: x read once, the output written
    once; operations: the arithmetic of a trip (``FLOAT_OPS``: the JAX's
    operations but rect's 32 slices, which the kernel reads from
    registers) for every element and trip."""
    import numpy as np
    import torch
    from clfacedetection_torch.ops.chain import (BODIES, FLOAT_OPS, GH, GW,
                                                 IN_W, chain, chain_plain)
    out = {}
    for gh, gw in ((GH, GW), CHAIN_SMALL):
        x = torch.from_numpy(np.random.default_rng(11).random(
            (gh, IN_W)).astype(np.float32)).cuda()
        for body in BODIES:
            for tr in CHAIN_TRIPS:
                p = chain_plain(x, body, tr, gw)
                k = chain(x, body, tr, gw)
                torch.cuda.synchronize()
                need(bits_equal(k, p), f"chain {body} at {tr} trips, "
                     f"{gh}x{gw} differs from its plain version")
                if (gh, gw) != (GH, GW):
                    out[f"{body}@{tr}"]["max_abs_err_small"] = \
                        max_abs_err(k, p)
                    continue
                out[f"{body}@{tr}"] = dict(
                    max_abs_err=max_abs_err(k, p),
                    plain_ms=timed(lambda: chain_plain(x, body, tr), 3),
                    **bound(x.numel() * 4 + GH * GW * 4,
                            float(GH * GW * FLOAT_OPS[body] * tr)))
    say("kernel", name="chain", shape=f"{GH}x{IN_W}->{GH}x{GW}",
        small=f"{CHAIN_SMALL[0]}x{IN_W}->{CHAIN_SMALL[0]}x{CHAIN_SMALL[1]}",
        bodies=",".join(BODIES), trips=CHAIN_TRIPS, equal_to_plain=True,
        bounds=json.dumps({k: round(v["bound_ms"], 5)
                           for k, v in out.items()}))
    return out


def check_sass(sass: dict) -> None:
    """Each chain body's trip loop (counted from its SASS by the tool, at
    the width C that its kernel's name gives): its shared words an element
    equal its window's words over C (every word of the window loaded once
    a trip, none more), at least the JAX's arithmetic operations as float
    instructions an element, and no load that may read device memory."""
    from clfacedetection_torch.ops.chain import (BODIES, FLOAT_OPS,
                                                 window_words)
    for body in BODIES[1:]:
        c = sass.get(body)
        need(c is not None, f"no SASS for chain body {body}")
        words = window_words(body, c["cols"]) / c["cols"]
        need(c["shared_words"] == words
             and c["float_ops"] >= FLOAT_OPS[body]
             and c["global_loads"] == 0,
             f"chain {body} at {c['cols']} columns: the trip loop reads "
             f"{c['shared_words']} shared words and holds "
             f"{c['float_ops']} float instructions an element and "
             f"{c['global_loads']} global loads; the window is {words} "
             f"words an element, the source {FLOAT_OPS[body]} operations")


def check_chain_spills(ptxas: dict) -> None:
    """``ptxas`` reported every ``chain_kernel`` instance (one a body)
    and spilled nothing in any."""
    from clfacedetection_torch.ops.chain import BODIES
    need(len(ptxas) == len(BODIES),
         f"ptxas reported {len(ptxas)} chain kernels")
    for name, p in ptxas.items():
        need(p.get("spill_stores") == 0 and p.get("spill_loads") == 0,
             f"ptxas: {name} spills ({p})")


def chain_record(checks: dict, tool: dict) -> dict:
    """The chain's entry of the kernels line from ``check_chain``'s checks
    and the ``mb_vpu3`` tool's run, after the SASS invariant and ptxas's
    spills are checked: the headline (slices at 16 trips), and per body
    and trip count the time, the width C, the trip loop's issue and shared
    floors at the SM clock sampled during the timings, the shares of the
    issue floor in the time and in the trips' slope, the bound and the T
    op/s by the JAX's op counts."""
    check_sass(tool["sass"])
    check_chain_spills(tool["ptxas"])
    chains, fl = tool["chains"], tool["floors"]
    need(fl is not None, "no SM clock read during the chain timings")
    per_body = {}
    for key, v in checks.items():
        body, tr = key.split("@")[0], int(key.split("@")[1])
        rec = dict(v)
        cols = tool["sass"][body]["cols"]
        if body != "empty":
            rec.update(ms=chains[body]["ms"][tr],
                       tops=chains[body]["tops_at"][tr], cols=cols,
                       **fl[body][tr])
            rec["share_of_issue_floor"] = rec["issue_ms"] / rec["ms"]
            rec["slope_share_of_issue_floor"] = rec["issue_ms"] / (
                chains[body]["trip_ms"] * tr)
        per_body[key] = rec
        if body != "empty":
            say("chain", body=body, trips=tr, cols=cols,
                **{k: round(rec[k], 5) for k in (
                    "ms", "issue_ms", "shared_ms", "bound_ms", "tops",
                    "share_of_issue_floor", "slope_share_of_issue_floor")})
    head = per_body[f"slices@{CHAIN_TRIPS[-1]}"]
    return dict(
        max_abs_err=max(max(c["max_abs_err"], c["max_abs_err_small"])
                        for c in checks.values()),
        ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
        bound_by=head["bound_by"], library_ms=None,
        headline=f"slices at {CHAIN_TRIPS[-1]} trips, "
                 f"{tool['sass']['slices']['cols']} columns a thread",
        per_body=per_body,
        clock=tool["clock"], empty_ms=tool["empty_ms"],
        rates={b: dict(tops=c["tops"], ps_per_elem_op=c["ps_per_elem_op"],
                       ms=c["ms"], spread=c["spread"])
               for b, c in chains.items()},
        floors=fl, sass=tool["sass"],
        ptxas=tool["ptxas"], matmul=tool["matmul"],
        front_sweep=tool["front"])


def best_ms(det, gray, reps: int = 3) -> float:
    """Host milliseconds of the best of ``reps`` ``detect`` calls (each
    ends in its readback), after the calls the caller warmed it with."""
    best = None
    for _ in range(reps):
        t = time.perf_counter()
        det.detect(gray, MIN_NEIGHBORS)
        ms = (time.perf_counter() - t) * 1e3
        best = ms if best is None else min(best, ms)
    return best


def check_scale_cascade(ct, counters) -> dict:
    """Scale-cascade mode (``ScaleCascadeDetector``, plain PyTorch over the
    scales, its compactions through the compaction kernel):

    * the demo configuration through ``CascadeClassifier(mode=
      "scale_cascade")`` with every count from 0 (the compaction launched,
      no other kernel), the card in float32 against the CPU in float32
      within the PARITY bounds at minNeighbors 3 and 0, and in float64
      box for box; ms a frame (the graph), best of 3, at front 3 and at
      front ``n_stages``; the demo's graph against the eager frame
      function, byte for byte, with both times, the graph's nodes and its
      capture and instantiation times;
    * every path at 240x320 through the classifier, the card against the
      CPU in float32 within the PARITY bounds: frontalface_alt2 (CART),
      mcs_nose (tilted), frontalface_alt_tree (stage tree) and
      frontalface_default with ``CV_HAAR_DO_CANNY_PRUNING``, whose
      ``canny`` on the card is bit-equal to ``canny_np``;
    * find-biggest-object at 240x320: the card's search in float64
      against the CPU's golden path, with and without
      ``CV_HAAR_DO_ROUGH_SEARCH``, and once through the classifier;
    * frontalface_alt at 1080p: ms a frame and candidates, float32 within
      the PARITY bounds of the card's own float64.

    Returns the record and the demo detector (for the profiler's launch
    count at the end of the run)."""
    import numpy as np
    import torch
    from clfacedetection_torch.detect.detector import DetectionResult
    from clfacedetection_torch.detect.reference_impl import \
        detect_multi_scale_reference
    from clfacedetection_torch.ops.canny import canny, canny_np
    from clfacedetection_torch.utils import photo_scene
    t0 = time.perf_counter()
    api = ct.api

    def zero():
        reset_counts(counters)

    def counts():
        return read_counts(counters)

    def only_compact(what, launches):
        need(launches["compact"] > 0
             and not any(v for k, v in launches.items() if k != "compact"),
             f"{what}: the compaction kernel alone should run: {launches}")

    def within_parity(what, a, b):
        need(len(a.candidates) > 0, f"{what}: no candidates")
        p = parity(a, b)
        need(p["jaccard"] >= 0.995 and p["boxes_matched"],
             f"{what}: outside the PARITY bounds: {p}")
        return p

    def raw(res):
        """minNeighbors 0 of a result: its candidates are the boxes."""
        return DetectionResult(res.candidates, np.ones(len(res.candidates),
                                                       np.int32),
                               res.candidates, res.survivor_overflow)

    out = {}
    spec = ct.load_cascade(DEMO_CASCADE)
    demo = frame(5, VGA)
    clf = ct.CascadeClassifier(spec, device="cuda", mode="scale_cascade")
    zero()
    r3 = clf.detect_multi_scale_full(demo, min_neighbors=MIN_NEIGHBORS,
                                     **DEMO_KNOBS)
    launches = counts()
    only_compact("demo", launches)
    (det,) = clf._detectors.values()
    need(not r3.survivor_overflow and len(r3.candidates) > 0,
         f"demo: {len(r3.candidates)} candidates, overflow "
         f"{r3.survivor_overflow}")
    t1 = time.perf_counter()
    c3 = ct.ScaleCascadeDetector(spec, VGA, device="cpu", cap=det.cap,
                                 **DEMO_KNOBS).detect(demo, MIN_NEIGHBORS)
    cpu_s = time.perf_counter() - t1
    demo_rec = dict(
        scales=det.n_scales, lattice=f"{det.max_y}x{det.max_x}",
        cap=det.cap, front_k=det.front_k, candidates=len(r3.candidates),
        boxes=r3.boxes.tolist(), launches=launches,
        parity_3=within_parity("demo f32", r3, c3),
        parity_0=within_parity("demo f32, minNeighbors 0", raw(r3), raw(c3)),
        equal_to_cpu=bool(np.array_equal(r3.candidates, c3.candidates)),
        cpu_seconds=cpu_s)
    g64 = ct.ScaleCascadeDetector(spec, VGA, device="cuda",
                                  dtype=torch.float64, **DEMO_KNOBS)
    zero()
    r64 = g64.detect(demo, MIN_NEIGHBORS)
    demo_rec["f64_launches"] = counts()
    p64 = ct.ScaleCascadeDetector(spec, VGA, device="cpu",
                                  dtype=torch.float64, cap=g64.cap,
                                  **DEMO_KNOBS).detect(demo, MIN_NEIGHBORS)
    need(np.array_equal(r64.candidates, p64.candidates)
         and np.array_equal(r64.boxes, p64.boxes),
         "demo f64: the card's boxes differ from the CPU's")
    demo_rec["f64_candidates"] = len(r64.candidates)
    demo_rec["f64_parity_to_f32"] = parity(r3, r64)
    # the float64 frame from its CUDA graph (the programs phase's float64
    # case of scale-cascade mode): byte-equal to the eager frame
    only_compact("demo f64", demo_rec["f64_launches"])
    p64g = g64.program()
    need(p64g.graphed and p64g.graph is not None,
         "demo f64: no CUDA graph")

    def eager64():
        return g64._frame_device(g64.put(demo), g64.cap, g64._canny_steps)[
            "packed"].cpu().numpy()

    need(same_bytes(p64g.read(p64g.run(demo))["packed"], eager64()),
         "demo f64: the graph's packed array differs from the eager path's")
    demo_rec["f64_program"] = dict(
        nodes=graph_nodes(p64g), capture_s=p64g.capture_s,
        instantiate_s=p64g.instantiate_s,
        graph_host_ms=host_ms(lambda: p64g.read(p64g.run(demo)), 3),
        eager_host_ms=host_ms(eager64, 3),
        reserved_gb=torch.cuda.memory_reserved() / 1e9)
    say("programs", case="float64_scale_cascade_demo", equal_to_eager=True,
        equal_to_cpu=True, **demo_rec["f64_program"])
    p64g.release()
    del g64, p64g
    demo_rec["ms_front_3"] = best_ms(det, demo)
    # the programs phase's scale-cascade case: the demo's graph (prep, the
    # scale loop and the pack) against the eager frame function
    prog = det.program()
    need(prog.graphed and prog.graph is not None, "demo: no CUDA graph")

    def eager_frame():
        return det._frame_device(det.put(demo), det.cap, det._canny_steps)[
            "packed"].cpu().numpy()

    need(same_bytes(prog.read(prog.run(demo))["packed"], eager_frame()),
         "demo: the graph's packed array differs from the eager path's")
    zero()
    prog.read(prog.run(demo))
    per_frame = count_routes(counters)
    demo_rec["program"] = dict(
        nodes=graph_nodes(prog), capture_s=prog.capture_s,
        instantiate_s=prog.instantiate_s,
        replays_per_frame=per_frame["replays"],
        wrapper_launches_per_frame=per_frame["wrapper"],
        graph_ms=host_ms(lambda: prog.read(prog.run(demo)), 5),
        eager_ms=host_ms(eager_frame, 3),
        graph_device_ms=replay_ms(prog, 5),
        reserved_gb=torch.cuda.memory_reserved() / 1e9)
    say("programs", case="scale_cascade_demo", equal_to_eager=True,
        **{k: json.dumps(v) if isinstance(v, dict) else v
           for k, v in demo_rec["program"].items()})
    deep = ct.ScaleCascadeDetector(spec, VGA, device="cuda",
                                   front_stages=spec.n_stages, **DEMO_KNOBS)
    t1 = time.perf_counter()
    rd = deep.detect(demo, MIN_NEIGHBORS)
    demo_rec["front_n_first_seconds"] = time.perf_counter() - t1
    demo_rec["parity_front_n"] = within_parity("demo front n_stages", rd, r3)
    demo_rec["ms_front_n"] = best_ms(deep, demo)
    demo_rec["front_n"] = deep.front_k
    del deep
    out["demo"] = demo_rec
    say("scale_cascade", case="demo", shape=f"{VGA[0]}x{VGA[1]}",
        cascade=DEMO_CASCADE, **{k: json.dumps(v) if isinstance(
            v, (dict, list)) else v for k, v in demo_rec.items()})

    # every path at 240x320 through the classifier, card against CPU
    ph = photo_scene(SC_SHAPE, face_sizes=(60, 100))
    scenes = {"synth": frame(5, SC_SHAPE), "photo": ph}
    paths = {}
    for cname, depth, canny_flag, scene in SC_PATHS:
        small = scenes[scene]
        flags = api.CV_HAAR_DO_CANNY_PRUNING if canny_flag else 0
        knobs = dict(DEMO_KNOBS, flags=flags, min_neighbors=MIN_NEIGHBORS,
                     max_stages=depth)
        cc = ct.CascadeClassifier(cname, device="cuda", mode="scale_cascade")
        zero()
        rc = cc.detect_multi_scale_full(small, **knobs)
        pl = counts()
        only_compact(cname, pl)
        (cd,) = cc._detectors.values()
        need(cd.do_canny_pruning == canny_flag,
             f"{cname}: the Canny flag was not routed")
        need(len(rc.candidates) > 0, f"{cname}: no candidates")
        pc = ct.CascadeClassifier(cname, device="cpu", mode="scale_cascade") \
            .detect_multi_scale_full(small, cap=cd.cap, **knobs)
        key = cname + (" canny" if canny_flag else "")
        paths[key] = dict(scene=scene, max_stages=depth,
                          candidates=len(rc.candidates),
                          launches=pl, parity=within_parity(key, rc, pc),
                          equal_to_cpu=bool(np.array_equal(rc.candidates,
                                                           pc.candidates)))
        if canny_flag:
            edges = canny(torch.from_numpy(small).cuda(), 0, 50)
            need(np.array_equal(edges.cpu().numpy(), canny_np(small, 0, 50)),
                 "canny on the card differs from canny_np")
            paths[key]["canny_equal_to_numpy"] = True
    out["paths"] = paths
    say("scale_cascade", case="paths", shape=f"{SC_SHAPE[0]}x{SC_SHAPE[1]}",
        **{k: json.dumps(v) for k, v in paths.items()})

    # find-biggest-object: the card's search (float64) and the golden path
    fdet = ct.ScaleCascadeDetector(spec, SC_SHAPE, device="cuda",
                                   dtype=torch.float64,
                                   max_stages=FBO_STAGES)
    fbo = {}
    for rough in (False, True):
        kw = dict(min_neighbors=1, min_size=(40, 40), rough_search=rough)
        zero()
        got = fdet.find_biggest_object(ph, **kw)
        fl = counts()
        only_compact("find-biggest", fl)
        t1 = time.perf_counter()
        gold = detect_multi_scale_reference(
            ph, spec, find_biggest_object=True, max_stages=FBO_STAGES, **kw)
        need(got.shape == (1, 4) and np.array_equal(got, gold),
             f"find-biggest (rough {rough}): card {got.tolist()}, golden "
             f"{gold.tolist()}")
        fbo[f"rough_{rough}"] = dict(box=got.tolist(), launches=fl,
                                     golden_seconds=time.perf_counter() - t1)
    flags = api.CV_HAAR_FIND_BIGGEST_OBJECT | api.CV_HAAR_DO_ROUGH_SEARCH
    via = ct.CascadeClassifier(spec, device="cuda", dtype=torch.float64) \
        .detect_multi_scale(ph, min_neighbors=1, min_size=(40, 40),
                            flags=flags, max_stages=FBO_STAGES)
    need(np.array_equal(via, np.asarray(fbo["rough_True"]["box"])),
         f"find-biggest through the classifier: {via.tolist()}")
    out["find_biggest"] = fbo
    say("scale_cascade", case="find_biggest",
        shape=f"{SC_SHAPE[0]}x{SC_SHAPE[1]}", equal_to_golden=True,
        **{k: json.dumps(v) for k, v in fbo.items()})

    # frontalface_alt at 1080p: float32 against the card's own float64
    big = frame(3)
    aspec = ct.load_cascade(CASCADE)
    b32 = ct.ScaleCascadeDetector(aspec, SHAPE, device="cuda", **DEMO_KNOBS)
    zero()
    rb = b32.detect(big, MIN_NEIGHBORS)
    bl = counts()
    only_compact("1080p", bl)
    b64 = ct.ScaleCascadeDetector(aspec, SHAPE, device="cuda",
                                  dtype=torch.float64, cap=b32.cap,
                                  **DEMO_KNOBS)
    rb64 = b64.detect(big, MIN_NEIGHBORS)
    release_programs(b64)
    del b64
    out["1080p"] = dict(
        cascade=CASCADE, scales=b32.n_scales, cap=b32.cap,
        candidates=len(rb.candidates), boxes=rb.boxes.tolist(),
        launches=bl, parity_to_f64=within_parity("1080p f32", rb, rb64),
        ms=best_ms(b32, big))
    del b32
    out["seconds"] = time.perf_counter() - t0
    say("scale_cascade", case="1080p", shape=f"{SHAPE[0]}x{SHAPE[1]}",
        seconds=round(out["seconds"], 3),
        **{k: json.dumps(v) if isinstance(v, (dict, list)) else v
           for k, v in out["1080p"].items()})
    torch.cuda.empty_cache()
    return out, det, demo


def program_case(det, frames, what: str, reps: int = 10) -> dict:
    """The detector's program for ``frames`` (host uint8 [B, H, W]) at its
    cap against the eager ``_detect_device``: the graph's readback outputs
    equal the eager path's byte for byte.  Host ms a frame (host frames in,
    numpy out) and device ms a frame (CUDA events around back-to-back
    calls of the device part: eager calls, graph replays) for both, the
    capture and instantiation times, the graph's nodes and the memory
    reserved after the capture."""
    import torch
    B, cap = len(frames), det.cap
    t0 = time.perf_counter()
    prog = det.program(B, cap)
    build_s = time.perf_counter() - t0
    need(prog.graphed and prog.graph is not None,
         f"{what}: the program is not a CUDA graph")
    got = prog.read(prog.run(frames))
    fr = det.put(frames)
    eager = det._detect_device(fr, cap)
    for k in prog.names:
        need(same_bytes(got[k], eager[k].cpu().numpy()),
             f"{what}: the graph's {k} differs from the eager path's")
    del eager
    rec = dict(batch=B, cap=cap, nodes=graph_nodes(prog),
               capture_s=prog.capture_s, instantiate_s=prog.instantiate_s,
               build_s=build_s,
               accepted=int(got["packed"][:, 1].sum()),
               reserved_gb=torch.cuda.memory_reserved() / 1e9)
    rec["graph_host_ms"] = host_ms(lambda: prog.read(prog.run(frames)),
                                   reps) / B
    rec["eager_host_ms"] = host_ms(
        lambda: det._detect_device(det.put(frames), cap)["packed"].cpu()
        .numpy(), reps) / B
    rec["graph_device_ms"] = replay_ms(prog, reps) / B
    rec["eager_device_ms"] = timed(lambda: det._detect_device(fr, cap),
                                   reps) / B
    say("programs", case=what, equal_to_eager=True,
        **{k: json.dumps(v) if isinstance(v, dict) else v
           for k, v in rec.items()})
    return rec


def same_results(got, want, what: str) -> None:
    """Two lists of per-batch DetectionResult lists: equal candidates,
    boxes and neighbour counts, frame for frame, in order."""
    import numpy as np
    need(len(got) == len(want), f"{what}: {len(got)} batches, not "
         f"{len(want)}")
    for i, (g, w) in enumerate(zip(got, want)):
        need(len(g) == len(w), f"{what}: batch {i} lost frames")
        for b, (x, y) in enumerate(zip(g, w)):
            need(np.array_equal(x.candidates, y.candidates)
                 and np.array_equal(x.boxes, y.boxes)
                 and np.array_equal(x.neighbors, y.neighbors),
                 f"{what}: batch {i} frame {b} differs")


def check_stream_programs(ct, spec, stack) -> dict:
    """``detect_stream`` at batch 8 over ``STREAM_BATCHES`` batches from
    its programs, threaded and unthreaded, against the eager stream (the
    parent's: ``_detect_device`` enqueued, readback and grouping on one
    worker thread), in order; frames/s of each, eager and graph in turns.
    Then a stream that starts at ``STREAM_SMALL_CAP`` and regrows in the
    middle, against the same batches at the large cap."""
    import numpy as np
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor
    from clfacedetection_torch.detect.pyramid import finish
    frames = list(stack.values())
    batches = [np.stack([frames[(i + j) % len(frames)]
                         for j in range(BATCH)])
               for i in range(STREAM_BATCHES)]
    bdet = ct.BatchedPyramidDetector(spec, SHAPE, batch=BATCH,
                                     device="cuda", **KNOBS)
    det = bdet.det
    list(bdet.detect_stream(batches[:2], MIN_NEIGHBORS))   # the capture
    cap = det.cap

    def eager_stream():
        ex, q, out = ThreadPoolExecutor(1), deque(), []

        def drain(dev):
            return [finish(c, o, MIN_NEIGHBORS)
                    for c, o in det.readback(dev, cap)]
        try:
            for b in batches:
                q.append(ex.submit(drain, det._detect_device(det.put(b),
                                                             cap)))
                if len(q) >= 2:
                    out.append(q.popleft().result())
            while q:
                out.append(q.popleft().result())
        finally:
            ex.shutdown(wait=True)
        return out

    def fps(fn):
        t = time.perf_counter()
        out = fn()
        return out, len(batches) * BATCH / (time.perf_counter() - t)

    want, e1 = fps(eager_stream)
    got_t, g_t = fps(lambda: list(bdet.detect_stream(batches, MIN_NEIGHBORS,
                                                     threaded=True)))
    got_u, g_u = fps(lambda: list(bdet.detect_stream(batches, MIN_NEIGHBORS,
                                                     threaded=False)))
    _, e2 = fps(eager_stream)
    same_results(got_t, want, "threaded graph stream")
    same_results(got_u, want, "unthreaded graph stream")
    need(det.cap == cap, "the stream regrew its cap at the large cap")
    flat = np.full((BATCH,) + SHAPE, 128, np.uint8)
    regrow = [flat, flat, batches[0], batches[1], flat, batches[2]]
    small = ct.BatchedPyramidDetector(spec, SHAPE, batch=BATCH,
                                      device="cuda",
                                      **dict(KNOBS, cap=STREAM_SMALL_CAP))
    t0 = time.perf_counter()
    got_r = list(small.detect_stream(regrow, MIN_NEIGHBORS))
    regrow_s = time.perf_counter() - t0
    need(small.det.cap > STREAM_SMALL_CAP, "the small-cap stream never "
         "regrew")
    need(small.det._program.key == (BATCH, small.det.cap),
         "the regrown stream's program is not at its grown cap")
    same_results(got_r, [bdet.detect(b, MIN_NEIGHBORS) for b in regrow],
                 "regrowing stream")
    rec = dict(batch=BATCH, batches=len(batches),
               frames=len(batches) * BATCH, cap=cap,
               eager_fps=[e1, e2], graph_threaded_fps=g_t,
               graph_unthreaded_fps=g_u, regrow_from=STREAM_SMALL_CAP,
               regrow_to=small.det.cap, regrow_seconds=regrow_s)
    say("programs", case="stream", equal_to_eager=True, **rec)
    return rec


def check_config5(ct, counters, frames8):
    """BASELINE config 5 at 1080p, batch 8: profileface (tail2), upperbody
    and fullbody (the v1 tail) in one ``MultiCascadeBatchedDetector``
    graph.  Every kernel of both tails runs in it; one copy to the host a
    batch (the stacked packed array); each cascade's candidates equal its
    own ``BatchedPyramidDetector``'s (its own graphs); the fused graph's
    readback equals the fused eager function's byte for byte; ms a frame
    of both."""
    import torch
    specs = [ct.load_cascade(n) for n in CONFIG5]
    t0 = time.perf_counter()
    multi = ct.MultiCascadeBatchedDetector(specs, SHAPE, BATCH,
                                           device="cuda", **KNOBS)
    reset_counts(counters)
    res = multi.detect(frames8, MIN_NEIGHBORS)
    launches = read_counts(counters)
    routes = count_routes(counters)
    first_s = time.perf_counter() - t0
    need(all(launches[k] > 0 for k in ("haar_front", "compact",
                                       "haar_tail2", "tail_walk")),
         f"config 5 did not run both tails' kernels: {launches}")
    prog = multi._program
    caps = prog.key[1]
    need(prog.graphed and prog.names == ("packed_all",)
         and len(prog.static) == 1,
         "config 5: more than one copy to the host a batch")
    need(sum(len(r.candidates) for rk in res for r in rk) > 0,
         "config 5: no candidates")
    for k, spec in enumerate(specs):
        single = ct.BatchedPyramidDetector(spec, SHAPE, BATCH,
                                           device="cuda", **KNOBS)
        same_results([res[k]], [single.detect(frames8, MIN_NEIGHBORS)],
                     f"config 5 {CONFIG5[k]}")
        need(single.det.cap == caps[k], f"config 5 {CONFIG5[k]}: cap "
             f"{caps[k]} against its own detector's {single.det.cap}")
        del single
    fused = multi._fused(caps)
    fr = multi.put(frames8)
    got = prog.read(prog.run(frames8))["packed_all"]
    need(same_bytes(got, fused(fr)["packed_all"].cpu().numpy()),
         "config 5: the graph's packed array differs from the eager one")
    rec = dict(cascades=list(CONFIG5), batch=BATCH, caps=list(caps),
               candidates=[sum(len(r.candidates) for r in rk) for rk in res],
               launches=launches, routes=routes, first_seconds=first_s,
               nodes=graph_nodes(prog), capture_s=prog.capture_s,
               instantiate_s=prog.instantiate_s,
               reserved_gb=torch.cuda.memory_reserved() / 1e9)
    rec["graph_host_ms"] = host_ms(lambda: prog.read(prog.run(frames8)),
                                   5) / BATCH
    rec["eager_host_ms"] = host_ms(
        lambda: fused(multi.put(frames8))["packed_all"].cpu().numpy(),
        5) / BATCH
    rec["graph_device_ms"] = replay_ms(prog, 5) / BATCH
    rec["eager_device_ms"] = timed(lambda: fused(fr), 5) / BATCH
    say("programs", case="config5", equal_to_own_detectors=True,
        **{k: json.dumps(v) if isinstance(v, (dict, list)) else v
           for k, v in rec.items()})
    return rec, multi


def dtoh_copies(fn) -> int:
    """Copies from the card to the host that ``fn`` makes, from the
    profiler's memcpy records."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA
               and "DtoH" in e.name)


def breakdown(det, frames) -> dict:
    """Device ms per frame of each phase of the v1 path's default route,
    from CUDA events recorded between the phases of one pass (one
    synchronise): the tail is the walk (``tail_walk``).  In the same pass,
    on the same slots, the pair that the ``"block"`` route runs instead
    (``haar_tail`` then ``tail_rows``), and ``block_total``, the frame with
    the pair in the walk's place.  The walk's plain version and bound at
    these shapes are ``check_walk``'s."""
    import torch
    from clfacedetection_torch.detect.pyramid import ACCEPT_CAP
    from clfacedetection_torch.ops.compact_kernel import compact
    from clfacedetection_torch.ops.haar_front import haar_front
    from clfacedetection_torch.ops.tail_walk import tail_walk
    B, cap = frames.shape[0], det.cap
    names = ("prep", "haar_front", "compact", "tail_walk", "accept_pack",
             "block_tail")
    best = None
    for _ in range(4):                          # first pass warms up
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
        ev[0].record()
        ii = det._prep_planes(frames)
        ev[1].record()
        front, vnf = haar_front(ii.sum, ii.sq_hi, ii.sq_lo, det._visit,
                                det.table, det.front_k, tilted=ii.tilted)
        ev[2].record()
        surv, n_surv = compact(front.reshape(B, -1), cap)
        ev[3].record()
        args = walk_args(det, ii, surv, vnf)
        rows = tail_walk(*args)
        ev[4].record()
        ok = rows[..., 1] > 0
        acc, n_acc = compact(ok, min(cap, ACCEPT_CAP))
        flat = surv.gather(1, torch.where(acc < cap, acc, 0).long())
        torch.cat([n_surv[:, None], n_acc[:, None], flat], dim=1)
        ev[5].record()
        pair = pair_rows(args)
        ev[6].record()
        torch.cuda.synchronize()
        del pair
        t = [ev[i].elapsed_time(ev[i + 1]) / B for i in range(6)]
        if best is None or sum(t[:5]) < sum(best[:5]):
            best = t
    del args
    total = sum(best[:5])
    return dict(zip(names, best), total=total,
                block_total=total - best[3] + best[5])


# ---- this slice's phases: XML cascades, the native library, the C
# oracle, the demo ----------------------------------------------------------

def work_dir(name: str) -> str:
    """A fresh directory for ``name`` under the package's ignored build
    directory (the script writes nothing outside its checkout)."""
    import shutil
    path = os.path.join(ROOT, "clfacedetection_torch", "build", name)
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    return path


def check_xml(ct, stack8, vga) -> dict:
    """Every zoo cascade written as OpenCV XML by the port's writer (the
    card has no cv2 and no cascade files), then loaded back through
    ``CascadeClassifier(path)`` and by name through ``$CLFD_CASCADE_DIR``:
    specs equal to the ``.npz`` ones, array for array and dtype for
    dtype; card candidates and boxes byte-equal to the ``.npz`` route's at
    VGA for all 19, at 1080p frontalface_alt batch 8 through its CUDA
    graph, and at the scale-cascade demo configuration.  Prints each
    cascade's parse seconds."""
    import numpy as np
    import torch
    from clfacedetection_torch.models import (ARRAY_FIELDS, CASCADE_NAMES,
                                              parse_haar_xml, write_haar_xml)
    from clfacedetection_torch.models import zoo
    t0 = time.perf_counter()
    xml_dir = work_dir("xml")

    def same_spec(a, b, what):
        need((a.window_w, a.window_h) == (b.window_w, b.window_h)
             and all(getattr(a, f).dtype == getattr(b, f).dtype
                     and np.array_equal(getattr(a, f), getattr(b, f))
                     for f in ARRAY_FIELDS),
             f"xml {what}: the parsed spec differs from the .npz one")

    def same_result(a, b, what):
        need(np.array_equal(a.candidates, b.candidates)
             and a.candidates.dtype == b.candidates.dtype
             and np.array_equal(a.boxes, b.boxes)
             and np.array_equal(a.neighbors, b.neighbors),
             f"xml {what}: the card's result differs from the .npz route's")

    parse_s, paths, cands = {}, {}, {}
    old_env = os.environ.get("CLFD_CASCADE_DIR")
    os.environ["CLFD_CASCADE_DIR"] = xml_dir
    try:
        for name in CASCADE_NAMES:
            spec = ct.load_cascade(name)
            path = os.path.join(xml_dir, f"{name}.xml")
            write_haar_xml(spec, path)
            # a second file under a name of its own: the artifacts come
            # first in the search, so the zoo's names resolve to the .npz
            write_haar_xml(spec, os.path.join(xml_dir, f"xml_{name}.xml"))
            t1 = time.perf_counter()
            parsed = parse_haar_xml(path)
            parse_s[name] = time.perf_counter() - t1
            same_spec(parsed, spec, name)
            need(zoo.available_cascades()[f"xml_{name}"].endswith(".xml"),
                 f"xml {name}: $CLFD_CASCADE_DIR was not searched")
            same_spec(ct.load_cascade(f"xml_{name}"), spec, f"{name} by name")
            clf_x = ct.CascadeClassifier(path, device="cuda")
            same_spec(clf_x.spec, spec, f"{name} classifier")
            clf_n = ct.CascadeClassifier(spec, device="cuda")
            rx = clf_x.detect_multi_scale_full(
                vga, min_neighbors=MIN_NEIGHBORS, **SWEEP_KNOBS)
            rn = clf_n.detect_multi_scale_full(
                vga, min_neighbors=MIN_NEIGHBORS, **SWEEP_KNOBS)
            same_result(rx, rn, f"{name} at VGA")
            cands[name] = len(rx.candidates)
            paths[name] = path
            del clf_x, clf_n
        torch.cuda.empty_cache()
    finally:
        if old_env is None:
            os.environ.pop("CLFD_CASCADE_DIR", None)
        else:
            os.environ["CLFD_CASCADE_DIR"] = old_env
    say("xml", part="vga", cascades=len(cands), equal_to_npz=True,
        candidates=json.dumps(cands),
        parse_seconds=json.dumps({k: round(v, 4)
                                  for k, v in parse_s.items()}))

    # 1080p frontalface_alt, batch 8, through its CUDA graph
    rec = dict(parse_seconds=parse_s, vga_candidates=cands, paths=paths)
    out = {}
    for route, cascade in (("xml", paths[CASCADE]), ("npz", CASCADE)):
        b = ct.BatchedPyramidDetector(ct.load_cascade(cascade), SHAPE,
                                      batch=BATCH, device="cuda", **KNOBS)
        out[route] = b.detect(stack8, MIN_NEIGHBORS)
        need(b.det._program is not None and b.det._program.graphed,
             f"xml 1080p batch 8 ({route}): no CUDA graph")
        del b
    for i, (a, b) in enumerate(zip(out["xml"], out["npz"])):
        same_result(a, b, f"1080p batch 8 frame {i}")
    rec["b8_candidates"] = sum(len(r.candidates) for r in out["xml"])
    # the scale-cascade demo configuration
    demo = frame(5, VGA)
    res = {}
    for route, cascade in (("xml", paths[DEMO_CASCADE]),
                           ("npz", DEMO_CASCADE)):
        clf = ct.CascadeClassifier(cascade, device="cuda",
                                   mode="scale_cascade")
        res[route] = clf.detect_multi_scale_full(
            demo, min_neighbors=MIN_NEIGHBORS, **DEMO_KNOBS)
        del clf
    same_result(res["xml"], res["npz"], "scale-cascade demo")
    rec["demo_candidates"] = len(res["xml"].candidates)
    torch.cuda.empty_cache()
    rec["seconds"] = time.perf_counter() - t0
    say("xml", part="1080p_b8_and_demo", equal_to_npz=True,
        b8_candidates=rec["b8_candidates"],
        demo_candidates=rec["demo_candidates"],
        seconds=round(rec["seconds"], 3))
    return rec


def check_native(ct, spec, stack, cand_sets) -> dict:
    """The native library: built afresh into a directory of its own
    (seconds and the compiler's version printed), that copy loaded and
    called once, and the package's own copy loadable; on the main
    paths' own candidates (``cand_sets``: name -> one candidate array a
    frame) the grouping's native route equals its numpy specification
    (``CLFD_NO_NATIVE=1``) for both variants at grouping thresholds 1
    (where the demo's minNeighbors 0 groups) and 3, with ms a frame of
    each route.  Then the batch-8 stream (threaded and unthreaded,
    ``STREAM_BATCHES`` batches) with each route in turns: its frames/s,
    its results equal."""
    import ctypes
    import shutil
    import numpy as np
    from clfacedetection_torch import native
    from clfacedetection_torch.detect.grouping import group_rectangles
    t0 = time.perf_counter()
    gxx = subprocess.run([shutil.which("g++") or "g++", "--version"],
                         capture_output=True, text=True,
                         timeout=60).stdout.splitlines()
    t1 = time.perf_counter()
    lib = native.build(work_dir("native"))
    build_s = time.perf_counter() - t1
    # the fresh copy loads and partitions three boxes into two classes
    fresh = native._bind(ctypes.CDLL(lib))
    boxes = np.ascontiguousarray([[10, 10, 50, 50], [11, 10, 50, 51],
                                  [200, 200, 30, 30]], np.int64)
    labels = np.empty(3, np.int32)
    n = fresh.clfd_partition(native._ptr(boxes, ctypes.c_int64), 3, 0.2,
                             native._ptr(labels, ctypes.c_int32))
    need(n == 2 and labels.tolist() == [0, 0, 1],
         f"the fresh build partitions wrongly: {n} {labels.tolist()}")
    need(native.native_available(),
         f"the native library does not load: {native.native_error()}")
    need(os.path.basename(lib) == os.path.basename(native.build()),
         "the fresh build's name differs from the package's")
    say("native", part="build", seconds=round(build_s, 3),
        gxx=repr(gxx[0] if gxx else "unknown"),
        flags=" ".join(native.CXX_FLAGS))

    def route(no_native: bool):
        if no_native:
            os.environ["CLFD_NO_NATIVE"] = "1"
        else:
            os.environ.pop("CLFD_NO_NATIVE", None)

    reps = 5
    grouping = {}
    try:
        for what, frames in cand_sets.items():
            rec = dict(frames=len(frames),
                       candidates=int(sum(len(c) for c in frames)))
            for thr in (1, 3):
                for variant in ("opencv", "clod"):
                    got = {}
                    for no_native in (False, True):
                        route(no_native)
                        got[no_native] = [group_rectangles(c, thr, 0.2,
                                                           variant)
                                          for c in frames]
                    need(all(np.array_equal(a[0], b[0])
                             and np.array_equal(a[1], b[1])
                             for a, b in zip(got[False], got[True])),
                         f"native {what}: threshold {thr} {variant}: the "
                         f"native grouping differs from numpy's")
            for no_native in (False, True):
                route(no_native)
                t = time.perf_counter()
                for _ in range(reps):
                    for c in frames:
                        group_rectangles(c, MIN_NEIGHBORS, 0.2)
                key = ("numpy" if no_native else "native") + "_ms_per_frame"
                rec[key] = (time.perf_counter() - t) * 1e3 / (
                    reps * len(frames))
            rec["ratio"] = rec["numpy_ms_per_frame"] / max(
                rec["native_ms_per_frame"], 1e-9)
            grouping[what] = rec
            say("native", part="grouping", path=what, equal_to_numpy=True,
                **rec)
    finally:
        route(False)

    # the batch-8 stream with each route in turns (native, numpy, numpy,
    # native), threaded and unthreaded
    frames = list(stack.values())
    batches = [np.stack([frames[(i + j) % len(frames)]
                         for j in range(BATCH)])
               for i in range(STREAM_BATCHES)]
    bdet = ct.BatchedPyramidDetector(spec, SHAPE, batch=BATCH,
                                     device="cuda", **KNOBS)
    list(bdet.detect_stream(batches[:2], MIN_NEIGHBORS))   # the capture
    stream, want = {}, None
    try:
        for threaded in (True, False):
            for no_native in (False, True, True, False):
                route(no_native)
                t = time.perf_counter()
                got = list(bdet.detect_stream(batches, MIN_NEIGHBORS,
                                              threaded=threaded))
                fps = len(batches) * BATCH / (time.perf_counter() - t)
                want = want or got
                same_results(got, want, f"native stream (threaded "
                             f"{threaded}, numpy {no_native})")
                key = ("threaded" if threaded else "unthreaded") + \
                    ("_numpy_fps" if no_native else "_native_fps")
                stream.setdefault(key, []).append(fps)
    finally:
        route(False)
    del bdet
    stream["candidates_per_frame"] = sum(
        len(r.candidates) for b in want for r in b) / (len(want) * BATCH)
    say("native", part="stream", batch=BATCH, batches=STREAM_BATCHES,
        equal=True, **{k: json.dumps(v) if isinstance(v, list) else v
                       for k, v in stream.items()})
    return dict(build_seconds=build_s, gxx=gxx[0] if gxx else None,
                grouping=grouping, stream=stream,
                seconds=time.perf_counter() - t0)


def check_oracle(ct) -> dict:
    """Full-depth parity on the card against the port's C oracle
    (``COracle``), no stage cut: scale-image mode on ``photo_scene`` at the
    headline settings (``SHAPE``) with frontalface_alt, alt2 and
    alt_tree, float64 (a CUDA graph of the plain front and tails and the
    compaction kernel; alt_tree's at 327,680 slots) box for box and
    float32 (the kernels) within docs/PARITY.md's bounds (candidate Jaccard >= 0.995, grouped boxes 1:1 at IoU >= 0.9);
    scale-cascade mode at the demo configuration in float64, box for box.
    Prints the windows the oracle evaluated and its windows/s."""
    import types
    import numpy as np
    import torch
    from clfacedetection_torch.detect.grouping import group_rectangles
    from clfacedetection_torch.native import oracle_candidates
    from clfacedetection_torch.utils import photo_scene
    t0 = time.perf_counter()
    out = {}

    def boxes_set(b):
        return set(map(tuple, np.asarray(b, np.int64).reshape(-1, 4)
                       .tolist()))

    for name in ORACLE_CASES:
        spec = ct.load_cascade(name)
        photo = photo_scene(SHAPE)
        t1 = time.perf_counter()
        ref, windows, run_s = oracle_candidates(
            photo, spec, "scale_image", KNOBS["scale_factor"],
            KNOBS["min_size"])
        oracle_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        d64 = ct.PyramidDetector(spec, SHAPE, device="cuda",
                                 dtype=torch.float64, **KNOBS)
        c64, o64 = d64.candidates(photo)
        f64_s = time.perf_counter() - t1
        # its CUDA graph's pool (alt_tree: 327,680 slots of float64 node
        # values) leaves the card before the next detector's
        f64_gb = torch.cuda.max_memory_reserved() / 1e9
        release_programs(d64)
        del d64
        need(not o64 and len(ref) > 0, f"oracle {name}: overflow {o64}, "
             f"{len(ref)} oracle boxes")
        s64, sref = boxes_set(c64), set(ref)
        need(s64 == sref, f"oracle {name}: float64 on the card has "
             f"{len(s64 - sref)} extra and {len(sref - s64)} missing of "
             f"{len(sref)}")
        d32 = ct.PyramidDetector(spec, SHAPE, device="cuda", **KNOBS)
        r32 = d32.detect(photo, MIN_NEIGHBORS)
        del d32
        torch.cuda.empty_cache()
        ref_arr = np.asarray(ref, np.int32).reshape(-1, 4)
        p = parity(r32, types.SimpleNamespace(
            candidates=ref_arr,
            boxes=group_rectangles(ref_arr, MIN_NEIGHBORS, 0.2)[0]))
        need(p["jaccard"] >= 0.995 and p["boxes_matched"],
             f"oracle {name}: float32 outside the PARITY bounds: {p}")
        out[name] = dict(shape=f"{SHAPE[0]}x{SHAPE[1]}", windows=windows,
                         oracle_candidates=len(ref),
                         oracle_seconds=oracle_s, oracle_run_seconds=run_s,
                         windows_per_s=windows / run_s,
                         f64_card_seconds=f64_s, f64_equal=True,
                         f64_max_reserved_gb=f64_gb,
                         f32_parity=p)
        say("oracle", mode="scale_image", cascade=name,
            **{k: json.dumps(v) if isinstance(v, dict) else v
               for k, v in out[name].items()})
    # scale-cascade mode: the demo configuration, float64, box for box
    spec = ct.load_cascade(DEMO_CASCADE)
    demo = frame(5, VGA)
    t1 = time.perf_counter()
    ref, windows, run_s = oracle_candidates(demo, spec, "scale_cascade",
                                            **DEMO_KNOBS)
    oracle_s = time.perf_counter() - t1
    g64 = ct.ScaleCascadeDetector(spec, VGA, device="cuda",
                                  dtype=torch.float64, **DEMO_KNOBS)
    c64, o64 = g64.candidates(demo)
    release_programs(g64)
    del g64
    need(not o64 and len(ref) > 0 and boxes_set(c64) == set(ref),
         f"oracle demo: float64 scale-cascade differs from the C oracle "
         f"({len(c64)} against {len(ref)})")
    out["scale_cascade_demo"] = dict(
        shape=f"{VGA[0]}x{VGA[1]}", windows=windows,
        oracle_candidates=len(ref), oracle_seconds=oracle_s,
        oracle_run_seconds=run_s, windows_per_s=windows / run_s,
        f64_equal=True)
    say("oracle", mode="scale_cascade", cascade=DEMO_CASCADE,
        **out["scale_cascade_demo"])
    out["seconds"] = time.perf_counter() - t0
    return out


def check_demo(xml_path: str) -> dict:
    """``tools/demo.py`` in this process on the card, with the default
    cascade given as an XML path.  The golden baseline is skipped: its
    numpy window loop takes minutes at 640x480, and the oracle phase
    holds the demo configuration box for box in its stead.  Prints the
    demo's lines."""
    from clfacedetection_torch.tools import demo
    t0 = time.perf_counter()
    out = demo.main(["--cascade", xml_path, "--skip-baseline",
                     "--out-dir", work_dir("demo"), "--device", "cuda"],
                    log=lambda line: print(f"[demo] {line}", flush=True))
    need(out["cascade"] == DEMO_CASCADE and all(
        os.path.getsize(p) > 0 for p in out["files"].values()),
        f"demo: {out['cascade']} or its files are wrong")
    need(len(out["boxes"]["scale_cascade"]) > 0, "demo: no boxes")
    need(out["strips"]["match"], f"demo: the row-strip section did not "
         f"match the single-device detector: {out['strips']}")
    rec = dict(ms=out["ms"], batched=out["batched"], multi=out["multi"],
               strips=out["strips"],
               boxes={k: len(v) for k, v in out["boxes"].items()},
               seconds=time.perf_counter() - t0)
    say("demo", **{k: json.dumps(v) if isinstance(v, dict) else v
                   for k, v in rec.items()})
    return rec


def count_run(counters, fn):
    """``fn()`` with every count from 0; its result and the wrappers'
    counts (``read_counts``: eager launches, a program's warm-up
    included)."""
    reset_counts(counters)
    out = fn()
    return out, read_counts(counters)


def mesh_devices(k: int):
    """The devices of a k-position mesh: every card where the machine has
    more than one (``data_parallel_mesh``, cut to k), else k positions of
    card 0, each on a stream of its own."""
    import torch
    from clfacedetection_torch.runtime import data_parallel_mesh
    if torch.cuda.device_count() > 1:
        return list(data_parallel_mesh().devices[:k])
    return [torch.device("cuda", 0)] * k


def release_programs(*objs) -> None:
    """Let go of the captured programs of detectors (and of their mesh
    positions), so that their graph pools leave the card."""
    import torch
    for o in objs:
        for d in getattr(o, "_dets", [o]):
            multi = hasattr(d, "_programs")
            for p in (d._programs if multi else [d._program]):
                if p is not None:
                    p.release()
            if multi:
                d._programs = [None] * len(d._programs)
            else:
                d._program = None
    torch.cuda.empty_cache()


def context_cost(flags, cap) -> dict:
    """The compaction's eager call, ``compact(flags, cap)`` on the 1080p
    front mask, with the wrappers' device context as it was (entered on
    every launch: ``kernels.on_device`` replaced by ``torch.cuda.device``)
    and as it is (entered only for another card): call ms from the host
    clock around ``CONTEXT_REPS`` back-to-back calls and a synchronize,
    device ms from CUDA events around the same calls; three rounds in
    turns, the least of each kept and every round printed."""
    import torch
    from clfacedetection_torch import kernels
    from clfacedetection_torch.ops.compact_kernel import compact
    helper = kernels.on_device
    modes = {"always": torch.cuda.device, "helper": helper}
    runs = {m: dict(call_ms=[], event_ms=[]) for m in modes}
    try:
        for order in (("always", "helper"), ("helper", "always"),
                      ("always", "helper")):
            for m in order:
                kernels.on_device = modes[m]
                compact(flags, cap)
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                t0 = time.perf_counter()
                start.record()
                for _ in range(CONTEXT_REPS):
                    compact(flags, cap)
                stop.record()
                torch.cuda.synchronize()
                runs[m]["call_ms"].append(
                    (time.perf_counter() - t0) * 1e3 / CONTEXT_REPS)
                runs[m]["event_ms"].append(
                    start.elapsed_time(stop) / CONTEXT_REPS)
    finally:
        kernels.on_device = helper
    rec = {m: dict(call_ms=min(v["call_ms"]), event_ms=min(v["event_ms"]),
                   rounds=v) for m, v in runs.items()}
    rec["context_us_a_call"] = 1e3 * (rec["always"]["call_ms"]
                                      - rec["helper"]["call_ms"])
    say("context", kernel="compact", flags=int(flags.shape[1]), cap=cap,
        reps=CONTEXT_REPS,
        **{k: json.dumps(v) if isinstance(v, dict) else v
           for k, v in rec.items()})
    return rec


def check_smem_setups(cases) -> dict:
    """``ClfdSmem`` (``csrc/launch.cuh``) keeps each kernel's shared-memory
    limits per device: once the eager pipeline of each (detector, frame)
    of ``cases`` and the chain kernel's five bodies ran on the current
    stream, running them again on another stream of the card, then on the
    current stream, sets nothing up (the counter ``kernels.smem_setups``
    stays put)."""
    import torch
    from clfacedetection_torch import trace
    from clfacedetection_torch.ops.chain import BODIES, IN_W, chain
    x = torch.rand((32, IN_W), device="cuda")

    def run_all():
        for det, gray in cases:
            det._detect_device(det.put(gray), det.cap)
        for body in BODIES:
            chain(x, body, 1, 256)

    run_all()
    torch.cuda.synchronize()
    before = trace.counters()["kernels.smem_setups"]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run_all()
    torch.cuda.current_stream().wait_stream(side)
    run_all()
    torch.cuda.synchronize()
    after = trace.counters()["kernels.smem_setups"]
    need(before > 0 and after == before,
         f"ClfdSmem: {after - before} setups on a card already set up "
         f"({before} before)")
    rec = dict(setups=after, setups_on_relaunch=after - before,
               cases=len(cases) + len(BODIES))
    say("smem", **rec)
    return rec


def check_float64_programs(ct, counters) -> dict:
    """float64 on the card as CUDA graphs: the front and the tails in
    their plain versions (their kernels are float32), the compactions in
    their kernel, at VGA with the sweep's knobs.  Each graph's readback is
    byte-equal to its eager float64 path and its candidates equal the
    CPU's float64, frame for frame: frontalface_alt at batch 1 and 8,
    frontalface_alt2 (the v1 tail's plain node values), frontalface_alt_tree
    at full depth, the ROC output of frontalface_alt (its float64 readback
    slot) and the strip program (``F64_STRIPS`` positions of card 0); the
    first run of each (the cap regrown where a frame overflowed; its time
    ``first_s``, warm-ups and captures included) launches the compaction
    kernel and no other.  Prints eager and graph host ms a
    frame, graph nodes and the memory reserved for each case, and lets
    each program go after its case.  (Scale-cascade mode's float64 graph
    is checked in the scale_cascade phase.)"""
    import numpy as np
    import torch
    from clfacedetection_torch.parallel import StripShardedPyramidDetector
    from clfacedetection_torch.runtime import Mesh
    f64 = torch.float64
    t0 = time.perf_counter()
    vga = [frame(5, VGA), frame(11, VGA)]
    wants = {}

    def cpu(cname, i, **kw):
        key = (cname, i)
        if key not in wants:
            wants[key] = ct.PyramidDetector(
                ct.load_cascade(cname), VGA, device="cpu", dtype=f64,
                **SWEEP_KNOBS, **kw).candidates(vga[i])
        return wants[key]

    def only_compact(what, launches):
        need(launches["compact"] > 0
             and not any(v for k, v in launches.items() if k != "compact"),
             f"{what}: float64 ran {launches}, not the compaction kernel "
             f"alone")

    def graph_case(what, cname, det, idx, owner=None):
        """The graph of ``owner`` (``det``, or the strips over it) for the
        frames ``vga[idx]`` against its eager path and the CPU: its
        ``candidates`` first, a frame at a time, which regrows the cap."""
        owner = owner or det
        frames = np.stack([vga[i] for i in idx])
        B = len(idx)
        reset_counts(counters)
        t1 = time.perf_counter()
        for i in sorted(set(idx)):
            c, o = owner.candidates(vga[i])
            need(not o, f"{what}: overflow")
        first_s = time.perf_counter() - t1
        only_compact(what, read_counts(counters))
        if owner is det:
            prog = det.program(B, det.cap)

            def eager(fr):
                return det._detect_device(fr, det.cap)
        else:
            prog = owner.program(det.cap)

            def eager(fr):
                return owner._strips_device(fr, det.cap)
        need(prog.graphed and prog.graph is not None,
             f"{what}: float64 is not a CUDA graph")
        got = prog.read(prog.run(frames))
        want = eager(det.put(frames))
        for k in prog.names:
            need(same_bytes(got[k], want[k].cpu().numpy()),
                 f"{what}: the float64 graph's {k} differs from the eager "
                 f"path's")
        for b, (c, o) in enumerate(det.unpack(got["packed"], det.cap,
                                              lambda: want)):
            wc, wo = cpu(cname, idx[b])
            need(o == wo and np.array_equal(c, wc),
                 f"{what}: frame {b}: {len(c)} candidates on the card, "
                 f"{len(wc)} on the CPU")
        rec = dict(batch=B, cap=det.cap, first_s=first_s,
                   nodes=graph_nodes(prog),
                   capture_s=prog.capture_s,
                   instantiate_s=prog.instantiate_s,
                   candidates=[len(cpu(cname, i)[0]) for i in idx],
                   graph_host_ms=host_ms(lambda: prog.read(prog.run(frames)),
                                         3) / B,
                   eager_host_ms=host_ms(lambda: eager(det.put(frames))[
                       "packed"].cpu().numpy(), 3) / B,
                   reserved_gb=torch.cuda.memory_reserved() / 1e9)
        release_programs(owner)
        say("programs", case=f"float64_{what}", equal_to_eager=True,
            equal_to_cpu=True, **{k: json.dumps(v) if isinstance(
                v, (dict, list)) else v for k, v in rec.items()})
        return rec

    def pyramid(cname, **kw):
        return ct.PyramidDetector(ct.load_cascade(cname), VGA, device="cuda",
                                  dtype=f64, **SWEEP_KNOBS, **kw)

    alt, alt2, tree = CASCADE, V1_CASCADES[0], V1_CASCADES[2]
    out = {}
    det = pyramid(alt)
    out["alt_b1"] = graph_case("alt_b1", alt, det, [0])
    out["alt_b8"] = graph_case("alt_b8", alt, det, [0, 1] * 4)
    for what, cname in (("alt2", alt2), ("alt_tree", tree)):
        out[what] = graph_case(what, cname, pyramid(cname), [0])
    # the ROC output: its packed_roc readback is float64
    rd = pyramid(alt, output_levels=True)
    out["roc_alt"] = graph_case("roc_alt", alt, rd, [0])
    got = rd.candidates_with_levels(vga[0])
    want = ct.PyramidDetector(ct.load_cascade(alt), VGA, device="cpu",
                              dtype=f64, output_levels=True,
                              **SWEEP_KNOBS).candidates_with_levels(vga[0])
    need(rd._program.outputs["packed_roc"].dtype == f64
         and all(np.array_equal(a, b) for a, b in zip(got, want)),
         "float64 ROC: the card's boxes, levels or weights differ from the "
         "CPU's")
    out["roc_alt"]["windows"] = len(got[0])
    release_programs(rd)
    # the strip program: the strips' fronts forked onto the positions'
    # streams of card 0, in one graph
    sd = pyramid(alt)
    strips = StripShardedPyramidDetector(
        sd, Mesh([torch.device("cuda", 0)] * F64_STRIPS, ("strips",)))
    out["strips"] = graph_case(f"strips{F64_STRIPS}", alt, sd, [0], strips)
    out["seconds"] = time.perf_counter() - t0
    say("programs", case="float64", seconds=round(out["seconds"], 3))
    return out


def check_flops(ct, counters, spec, photo, front10_candidates) -> dict:
    """``utils/flops.py`` and ``PyramidDetector.stage_entering_counts`` at
    the headline settings on 1080p ``photo_scene``: the counts launch the
    front kernel once a depth (``n_stages`` launches, no other kernel);
    ``entering[front_k]`` equals the front-10 graph's ``n_surv``
    (``PHOTO_SURVIVORS``) and ``entering[-1]`` the candidates of a
    ``front_stages=n_stages`` detector on the card (JAX's own
    cross-check), printed beside the front-10 pipeline's candidates;
    ``pipeline_flops`` and ``scalar_floor_flops`` beside the graph's
    device ms, with their shares of the float32 peak (information
    only)."""
    import numpy as np
    import torch
    from clfacedetection_torch.utils.flops import (PEAK_FLOPS_F32_HIGHEST,
                                                   pipeline_flops,
                                                   scalar_floor_flops)
    t0 = time.perf_counter()
    det = ct.PyramidDetector(spec, SHAPE, device="cuda", **KNOBS)
    det.stage_entering_counts(photo)
    reset_counts(counters)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ent = det.stage_entering_counts(photo)
    ent_ms = (time.perf_counter() - t1) * 1e3
    launches = read_counts(counters)
    need(launches["haar_front"] == det.n_stages
         and not any(v for k, v in launches.items() if k != "haar_front"),
         f"flops: stage_entering_counts ran {launches}, not the front "
         f"kernel {det.n_stages} times")
    need(ent[0] == det.n_visit and bool(np.all(np.diff(ent) <= 0)),
         f"flops: entering counts {ent.tolist()}")
    prog = det.program(1, det.cap)
    n_surv = int(prog.read(prog.run(photo[None]))["packed"][0, 0])
    need(int(ent[det.front_k]) == n_surv == PHOTO_SURVIVORS,
         f"flops: entering[{det.front_k}] = {ent[det.front_k]}, the "
         f"front-{det.front_k} graph's n_surv {n_surv}, expected "
         f"{PHOTO_SURVIVORS}")
    graph_ms = replay_ms(prog, 20)
    release_programs(det)
    full = ct.PyramidDetector(spec, SHAPE, device="cuda",
                              **dict(KNOBS, front_stages=det.n_stages))
    fc, fo = full.candidates(photo)
    release_programs(full)
    need(not fo and len(fc) == int(ent[-1]),
         f"flops: entering[-1] = {ent[-1]}, a front_stages={det.n_stages} "
         f"detector's candidates {len(fc)}")
    pf = pipeline_flops(det, n_surv)
    fl = scalar_floor_flops(det, ent)
    sec = graph_ms * 1e-3
    rec = dict(
        entering=ent.tolist(), entering_ms=ent_ms, launches=launches,
        n_surv=n_surv, final=int(ent[-1]), full_depth_candidates=len(fc),
        front10_candidates=front10_candidates,
        graph_device_ms=graph_ms, pipeline_flops=pf,
        scalar_floor_flops=fl["scalar_floor_flops"],
        scalar_node_evals=fl["scalar_node_evals"],
        peak_f32=PEAK_FLOPS_F32_HIGHEST,
        useful_share=pf["useful_flops"] / sec / PEAK_FLOPS_F32_HIGHEST,
        executed_share=pf["executed_vpu_ops"] / sec / PEAK_FLOPS_F32_HIGHEST,
        floor_share=fl["scalar_floor_flops"] / sec / PEAK_FLOPS_F32_HIGHEST,
        seconds=time.perf_counter() - t0)
    say("flops", shape=f"{SHAPE[0]}x{SHAPE[1]}", scene="photo_scene",
        front_k=det.front_k, **{k: json.dumps(v) if isinstance(
            v, (dict, list)) else v for k, v in rec.items()})
    return rec



def check_mesh(ct, counters, spec, frames8, photo, sc_det, sc_frame):
    """The multi-device layer (``runtime/mesh.py``, ``parallel/``) on
    ``data_parallel_mesh()`` where the machine has several cards, else on
    positions that repeat card 0 (each on a stream of its own):

    * 1080p frontalface_alt at the headline settings, batch 8 over 8
      positions (``BatchedPyramidDetector(mesh=)``): every frame's packed
      readback byte-equal to the single-device batch-8 program's, on
      ``synth_scene`` and ``photo_scene``; ``detect`` equal frame for
      frame; ``detect_sharded`` + ``gather_detections`` box for box;
    * BASELINE config 5 through ``MultiCascadeBatchedDetector(mesh=)``,
      batch 8 over 4 positions, its packed readback byte-equal to the
      unsharded graph's at the same caps;
    * ``StripShardedPyramidDetector`` at 1080p alt on ``photo_scene`` with
      k = 8 and 4, one regrowing from cap 256 * k, and mcs_nose (tilted,
      the v1 tail) at VGA with k = 4: candidates and overflow equal to
      ``PyramidDetector.candidates``;
    * ``shard_scales`` over 4 positions at the demo configuration, equal
      box for box to the single-device detector;
    * times beside the single-device figures of the same run: host and
      device ms a frame of the 8-strip frame, frames/s of the batch-8
      stream, the sharded demo's ms a frame; graph nodes.

    Each case's wrapper counts show the kernels (not the plain versions)
    launched; the programs are released at the end.  Returns the record
    and the main-path drives the kernels line reads: (name, detector,
    input, the kernels it runs) of the single-device batch 8, the batch
    mesh, the 8 strips and the sharded demo."""
    import numpy as np
    import torch
    from clfacedetection_torch.parallel import (
        StripShardedPyramidDetector, detect_sharded, gather_detections)
    from clfacedetection_torch.runtime import Mesh
    from clfacedetection_torch.runtime.batch import _read as read_run
    t_all = time.perf_counter()
    rec = {"cards": torch.cuda.device_count()}
    dev8, dev4 = mesh_devices(8), mesh_devices(4)
    rec["positions"] = {"8": [str(d) for d in dev8],
                        "4": [str(d) for d in dev4]}

    def front_path(launches, what, tail=("haar_tail2",)):
        uses = ("haar_front", "compact") + tuple(tail)
        need(all(launches[k] > 0 for k in uses),
             f"{what}: the kernels did not launch: {launches}")

    # ---- the batch mesh: 8 positions, batch 8 --------------------------
    photo8 = np.stack([photo] * BATCH)
    single = ct.BatchedPyramidDetector(spec, SHAPE, BATCH, device="cuda",
                                       **KNOBS)
    bm = ct.BatchedPyramidDetector(spec, SHAPE, BATCH,
                                   mesh=Mesh(dev8), **KNOBS)
    for scene, fr in (("synth", frames8), ("photo", photo8)):
        want = single.detect(fr, MIN_NEIGHBORS)
        got, launches = count_run(counters,
                                  lambda: bm.detect(fr, MIN_NEIGHBORS))
        need(single.det.cap == bm.det.cap == KNOBS["cap"],
             f"batch mesh {scene}: caps {single.det.cap} / {bm.det.cap}")
        same_results([got], [want], f"batch mesh {scene}")
        need(same_bytes(read_run(single.run_device(fr), "packed"),
                        read_run(bm.run_device(fr), "packed")),
             f"batch mesh {scene}: the packed readback differs from the "
             f"single-device batch-8 program's")
        gd, sharded = count_run(counters, lambda: gather_detections(
            detect_sharded(bm.det, fr, Mesh(dev8)), bm.det, MIN_NEIGHBORS))
        same_results([gd], [want], f"detect_sharded {scene}")
        front_path(sharded, f"detect_sharded {scene}")
        if scene == "synth":
            # the positions' warm-ups: the photo's batch replays them
            front_path(launches, "batch mesh")
        rec[f"batch_{scene}"] = dict(
            candidates=sum(len(r.candidates) for r in got),
            packed_equal=True, launches=launches,
            detect_sharded_launches=sharded)
        say("mesh", case=f"batch8x8_{scene}", detect_sharded_equal=True,
            **{a: json.dumps(v) if isinstance(v, dict) else v
               for a, v in rec[f"batch_{scene}"].items()})
    rec["batch_nodes"] = graph_nodes(bm._dets[1]._program)
    # the batch-8 stream, single device and mesh in turns
    batches = [frames8, photo8] * (STREAM_BATCHES // 2)

    def fps(d):
        t = time.perf_counter()
        got = list(d.detect_stream(batches, MIN_NEIGHBORS))
        return got, len(batches) * BATCH / (time.perf_counter() - t)

    s1, f1 = fps(single)
    m1, g1 = fps(bm)
    m2, g2 = fps(bm)
    s2, f2 = fps(single)
    same_results(m1, s1, "mesh stream")
    same_results(m2, s2, "mesh stream, second")
    rec["stream_fps"] = dict(single=[f1, f2], mesh=[g1, g2])
    say("mesh", case="stream", batches=len(batches), single_fps=[f1, f2],
        mesh_fps=[g1, g2], equal=True)

    # ---- config 5 over 4 positions --------------------------------------
    specs = [ct.load_cascade(n) for n in CONFIG5]
    m5 = ct.MultiCascadeBatchedDetector(specs, SHAPE, BATCH, device="cuda",
                                        **KNOBS)
    m5m = ct.MultiCascadeBatchedDetector(specs, SHAPE, BATCH,
                                         mesh=Mesh(dev4), **KNOBS)
    want5 = m5.detect(frames8, MIN_NEIGHBORS)
    got5, l5 = count_run(counters,
                         lambda: m5m.detect(frames8, MIN_NEIGHBORS))
    need(m5._caps() == m5m._caps(), f"config 5 mesh: caps {m5m._caps()} "
         f"against {m5._caps()}")
    for k in range(len(specs)):
        same_results([got5[k]], [want5[k]], f"config 5 mesh {CONFIG5[k]}")
    need(same_bytes(read_run(m5.run_device(frames8), "packed_all"),
                    read_run(m5m.run_device(frames8), "packed_all")),
         "config 5 mesh: the packed readback differs from the unsharded "
         "graph's")
    front_path(l5, "config 5 mesh", ("haar_tail2", "tail_walk"))
    rec["config5"] = dict(caps=list(m5m._caps()), packed_equal=True,
                          launches=l5,
                          nodes=graph_nodes(m5m._programs[1]))
    say("mesh", case="config5_b8x4", packed_equal=True,
        caps=list(m5m._caps()), launches=json.dumps(l5),
        nodes=rec["config5"]["nodes"])
    release_programs(m5, m5m)
    del m5, m5m

    # ---- row strips -----------------------------------------------------
    strips = {}
    pdet = ct.PyramidDetector(spec, SHAPE, device="cuda", **KNOBS)
    ref, ref_ovf = pdet.candidates(photo)
    for k, cap0 in ((8, KNOBS["cap"]), (4, KNOBS["cap"]), (8, 256 * 8)):
        sd = ct.PyramidDetector(spec, SHAPE, device="cuda",
                                **dict(KNOBS, cap=cap0))
        sdet = StripShardedPyramidDetector(sd, Mesh(mesh_devices(k),
                                                    ("strips",)))
        (got, ovf), sl = count_run(counters,
                                   lambda: sdet.candidates(photo))
        need(np.array_equal(got, ref) and ovf == ref_ovf,
             f"strips k={k} from cap {cap0}: candidates differ from "
             f"PyramidDetector.candidates")
        front_path(sl, f"strips k={k}")
        what = f"k{k}_cap{cap0}"
        strips[what] = dict(k=k, Hs=sdet.Hs, cap_from=cap0, cap=sd.cap,
                            candidates=len(got), launches=sl,
                            graphed=sdet._program.graphed)
        if cap0 == 256 * 8:
            need(sd.cap > cap0, "the regrowing strips never regrew")
        say("mesh", case=f"strips_{what}", equal_to_single=True,
            **{a: json.dumps(v) if isinstance(v, dict) else v
               for a, v in strips[what].items()})
        if (k, cap0) == (8, KNOBS["cap"]):
            s8 = sdet
        else:
            release_programs(sdet)
    # the tilted cascade through the v1 tail, VGA, k = 4
    nose = ct.load_cascade("haarcascade_mcs_nose")
    vga = frame(5, VGA)
    ndet = ct.PyramidDetector(nose, VGA, device="cuda", **SWEEP_KNOBS)
    nref, novf = ndet.candidates(vga)
    nsd = StripShardedPyramidDetector(
        ct.PyramidDetector(nose, VGA, device="cuda", **SWEEP_KNOBS),
        Mesh(mesh_devices(4), ("strips",)))
    (ngot, ngovf), nl = count_run(counters, lambda: nsd.candidates(vga))
    need(np.array_equal(ngot, nref) and ngovf == novf,
         "strips of mcs_nose: candidates differ from the single detector")
    front_path(nl, "strips mcs_nose", ("tail_walk",))
    strips["mcs_nose_vga_k4"] = dict(candidates=len(ngot), launches=nl)
    say("mesh", case="strips_mcs_nose_vga_k4", equal_to_single=True,
        candidates=len(ngot), launches=json.dumps(nl))
    release_programs(nsd, ndet)
    # the 8-strip frame's times beside the single-device frame's
    sp = s8._program
    one = pdet.program(1, pdet.cap)
    ph = photo[None]
    rec["strip_times"] = dict(
        strips_host_ms=host_ms(lambda: sp.read(sp.run(ph)), 10),
        single_host_ms=host_ms(lambda: one.read(one.run(ph)), 10),
        strips_device_ms=replay_ms(sp, 10),
        single_device_ms=replay_ms(one, 10),
        strips_nodes=graph_nodes(sp), single_nodes=graph_nodes(one),
        strips_cap=s8.det.cap, single_cap=pdet.cap)
    rec["strips"] = strips
    say("mesh", case="strip_times", **rec["strip_times"])
    release_programs(pdet)

    # ---- shard_scales: the demo configuration over 4 positions ----------
    dspec = ct.load_cascade(DEMO_CASCADE)
    sc4 = ct.ScaleCascadeDetector(dspec, VGA, device="cuda", **DEMO_KNOBS)
    sc4.cap = sc_det.cap
    sc4.shard_scales(mesh_devices(4))
    (c4, o4), scl = count_run(counters, lambda: sc4.candidates(sc_frame))
    c1, o1 = sc_det.candidates(sc_frame)
    need(np.array_equal(c4, c1) and o4 == o1 and len(c1) > 0,
         "shard_scales: candidates differ from the single-device detector")
    need(scl["compact"] > 0, f"shard_scales: no compaction kernel: {scl}")
    d4 = sc4.detect(sc_frame, MIN_NEIGHBORS)
    d1 = sc_det.detect(sc_frame, MIN_NEIGHBORS)
    need(np.array_equal(d4.boxes, d1.boxes), "shard_scales: boxes differ")
    sc4.detect(sc_frame, MIN_NEIGHBORS)
    rec["shard_scales"] = dict(
        positions=len(mesh_devices(4)), candidates=len(c4),
        boxes=len(d4.boxes), launches=scl,
        sharded_ms=best_ms(sc4, sc_frame), single_ms=best_ms(sc_det,
                                                             sc_frame),
        sharded_device_ms=replay_ms(sc4._program, 3),
        single_device_ms=replay_ms(sc_det.program(), 3),
        sharded_nodes=graph_nodes(sc4._program),
        single_nodes=graph_nodes(sc_det.program()))
    say("mesh", case="shard_scales_demo", equal_to_single=True,
        **{a: json.dumps(v) if isinstance(v, dict) else v
           for a, v in rec["shard_scales"].items()})
    rec["reserved_gb"] = torch.cuda.memory_reserved() / 1e9
    release_programs(sc4, single, bm, s8)
    rec["seconds"] = time.perf_counter() - t_all
    say("mesh", case="done", seconds=round(rec["seconds"], 3),
        reserved_gb=rec["reserved_gb"])
    tail2 = ("haar_front", "compact", "haar_tail2")
    return rec, [("batch8_" + CASCADE, single, frames8, tail2),
                 ("mesh_batch8x8", bm, frames8, tail2),
                 ("mesh_strips8", s8, photo, tail2),
                 ("mesh_shard_scales4", sc4, sc_frame, ("compact",))]


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import clfacedetection_torch as ct
    except ImportError as e:
        print(f"chip_smoke: the clfacedetection_torch package is missing "
              f"({e})", file=sys.stderr)
        return 2
    from clfacedetection_torch import kernels
    from clfacedetection_torch.ops.compact_kernel import compact
    from clfacedetection_torch.ops.haar_front import haar_front
    from clfacedetection_torch.ops.haar_tail import haar_tail
    from clfacedetection_torch.ops.haar_tail2 import haar_tail2
    from clfacedetection_torch.ops.chain import chain
    from clfacedetection_torch.ops.tail_rows import tail_rows
    from clfacedetection_torch.ops.tail_walk import tail_walk
    counters = {"haar_front": haar_front, "compact": compact,
                "haar_tail2": haar_tail2, "haar_tail": haar_tail,
                "chain": chain, "tail_rows": tail_rows,
                "tail_walk": tail_walk}

    def counted(fn):
        return count_run(counters, fn)

    def drive(det, gray):
        """One detect() through the entry point with every count from 0;
        returns the result and the counts.  On a detector's first call
        they are its program's warm-up, the one eager run before the
        capture."""
        return counted(lambda: det.detect(gray, min_neighbors=MIN_NEIGHBORS))

    def same_as_plain(det, gray, res, what):
        frames = det.put(gray)
        plain_cand, _ = det.readback(
            det._detect_device(frames, det.cap, plain=True), det.cap)[0]
        need(len(res.candidates) == len(plain_cand)
             and bool((res.candidates == plain_cand).all()),
             f"{what}: candidates differ from the plain path on the card")

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    say("device", name=repr(name), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)
    print(f"nvidia-smi: {smi[0] if smi else 'unavailable'}", flush=True)

    t0 = time.perf_counter()
    kernels.lib()
    say("build", seconds=round(time.perf_counter() - t0, 3),
        flags=" ".join(kernels.NVCC_FLAGS))
    for line in kernels.build_log().splitlines():
        if "entry function" in line or "registers" in line \
                or "spill" in line:
            print(f"[ptxas] {line.strip()}", flush=True)

    # ---- tail2's path: frontalface_alt ------------------------------
    spec = ct.load_cascade(CASCADE)
    gray = frame(3)
    det = ct.PyramidDetector(spec, SHAPE, device="cuda", **KNOBS)
    say("plan", levels=det.n_levels, canvas=f"{det.hv}x{det.wv}",
        visited=det.n_visit, front_k=det.front_k, cap=det.cap)
    import numpy as np
    seeds = [3, 11, 17, 29]
    stack = {sd: frame(sd) for sd in seeds + [5, 13, 19, 23]}
    results, flags1 = check_kernels(det, gray,
                                    np.stack(list(stack.values())))
    # the wrappers' device context, with and without (the compaction)
    results["compact"]["context"] = context_cost(flags1, det.cap)

    res, launches = drive(det, gray)
    need(all(launches[k] > 0 for k in ("haar_front", "compact",
                                       "haar_tail2"))
         and launches["haar_tail"] == 0 and launches["chain"] == 0
         and launches["tail_rows"] == 0 and launches["tail_walk"] == 0,
         f"tail2's path did not run its kernels: {launches}")
    need(not res.survivor_overflow, "survivor cap overflowed")
    need(len(res.candidates) > 0, "no candidates at 1080p")
    same_as_plain(det, gray, res, "1080p frontalface_alt")
    say("detect", shape=f"{SHAPE[0]}x{SHAPE[1]}",
        candidates=len(res.candidates), launches=json.dumps(launches),
        boxes=json.dumps(res.boxes.tolist()),
        neighbors=json.dumps(res.neighbors.tolist()))

    # the JAX bench's scene: photo_scene, the survivors beside the JAX's
    from clfacedetection_torch.utils import photo_scene
    photo = photo_scene(SHAPE)
    # a detector of its own, so that the drive warms up and captures its
    # program (a replay of det's would call no wrapper)
    pdet = ct.PyramidDetector(spec, SHAPE, device="cuda", **KNOBS)
    pres, photo_launches = drive(pdet, photo)
    del pdet
    need(all(photo_launches[k] > 0 for k in ("haar_front", "compact",
                                             "haar_tail2"))
         and photo_launches["haar_tail"] == 0
         and photo_launches["tail_walk"] == 0
         and photo_launches["chain"] == 0,
         f"photo_scene did not run tail2's path: {photo_launches}")
    need(not pres.survivor_overflow, "photo_scene: survivor cap overflowed")
    same_as_plain(det, photo, pres, "1080p photo_scene")
    pii = det._prep_planes(det.put(photo))
    pmask, pvnf = haar_front(pii.sum, pii.sq_hi, pii.sq_lo, det._visit,
                             det.table, det.front_k)
    photo_surv = int(pmask.sum())
    unfused = unfused_front(det, pii, pmask)
    # tail2 on the photo's survivors: bit-equal, and its time
    psurv, pn = compact(pmask.reshape(1, -1), det.cap)
    tail2_case(det, pii.sum, pvnf, psurv, "photo_scene")
    pargs = (pii.sum, pvnf, psurv, det.table, det.front_k)
    results["haar_tail2"].update(
        photo_ms=timed(lambda: haar_tail2(*pargs), 20),
        photo_graph_ms=graph_ms(lambda: haar_tail2(*pargs), 20))
    say("kernel", name="haar_tail2", scene="photo_scene",
        survivors=int(pn[0]), equal_to_plain=True,
        ms=results["haar_tail2"]["photo_ms"],
        graph_ms=results["haar_tail2"]["photo_graph_ms"])
    results["haar_tail2"]["stream"] = check_tail2_stream(spec)
    del pii, pmask, pvnf, psurv
    say("photo_scene", shape=f"{SHAPE[0]}x{SHAPE[1]}", front_k=det.front_k,
        survivors=photo_surv, jax_survivors=JAX_PHOTO_SURVIVORS,
        survivors_equal=photo_surv == JAX_PHOTO_SURVIVORS,
        unfused_variance=json.dumps(unfused),
        candidates=len(pres.candidates), launches=json.dumps(photo_launches),
        boxes=json.dumps(pres.boxes.tolist()),
        neighbors=json.dumps(pres.neighbors.tolist()))

    vga = frame(5, VGA)
    vc, vo = ct.PyramidDetector(spec, VGA, device="cuda", **KNOBS) \
        .candidates(vga)
    cc, co = ct.PyramidDetector(spec, VGA, device="cpu", **KNOBS) \
        .candidates(vga)
    need(vo == co and vc.shape == cc.shape and bool((vc == cc).all()),
         "VGA candidates on the card differ from the CPU plain path")
    say("vga", candidates=len(vc), equal_to_cpu=True)

    def stream_equals_singles(spec, det, what):
        """Batched stream: every frame equal to the single-frame path."""
        singles = {sd: det.detect(stack[sd], MIN_NEIGHBORS) for sd in seeds}
        order = [seeds[i % len(seeds)] for i in range(BATCH * N_BATCHES)]
        bdet = ct.BatchedPyramidDetector(spec, SHAPE, batch=BATCH,
                                         device="cuda", **KNOBS)
        batches = [np.stack([stack[sd] for sd in order[i:i + BATCH]])
                   for i in range(0, len(order), BATCH)]
        got = [r for out in bdet.detect_stream(batches, MIN_NEIGHBORS)
               for r in out]
        need(len(got) == len(order), f"{what}: stream lost frames")
        for sd, r in zip(order, got):
            one = singles[sd]
            need(np.array_equal(r.candidates, one.candidates)
                 and np.array_equal(r.boxes, one.boxes),
                 f"{what}: stream frame (seed {sd}) differs from the "
                 f"single-frame path")
        say("stream", cascade=what, batch=BATCH, batches=N_BATCHES,
            frames=len(got), candidates=sum(len(r.candidates) for r in got),
            equal_to_single=True)
        return bdet

    bdet = stream_equals_singles(spec, det, CASCADE)

    def path_times(det, bdet, what, plain_reps=2):
        """Device ms/frame, kernel path vs plain path."""
        times = {}
        for b in (1, BATCH):
            fr = bdet.put(np.stack([stack[seeds[i % 4]] for i in range(b)]))
            cap = det.cap
            k = timed(lambda: det._detect_device(fr, cap), 10) / b
            p = timed(lambda: det._detect_device(fr, cap, plain=True),
                      plain_reps) / b
            times[str(b)] = {"kernel": k, "plain": p}
            say("time", cascade=what, batch=b, kernel_ms_per_frame=round(k, 4),
                plain_ms_per_frame=round(p, 4))
        return times

    ms_per_frame = {CASCADE: path_times(det, bdet, CASCADE)}
    del bdet

    # ---- programs: the paths from their captured CUDA graphs ---------
    t_prog = time.perf_counter()
    stack8 = np.stack(list(stack.values()))
    programs = {}
    for what, frames_ in (("alt_b1_synth", gray[None]),
                          ("alt_b1_photo", photo[None]),
                          ("alt_b8_synth", stack8),
                          ("alt_b8_photo", np.stack([photo] * BATCH))):
        programs[what] = program_case(det, frames_, what)
    programs["stream"] = check_stream_programs(ct, spec, stack)
    programs["config5"], multi5 = check_config5(ct, counters, stack8)
    programs["seconds"] = time.perf_counter() - t_prog
    say("programs", case="alt_stream_config5",
        seconds=round(programs["seconds"], 3))

    # ---- flops: the accounting and the entering counts on the card ----
    flops = check_flops(ct, counters, spec, photo, len(pres.candidates))

    # ---- the v1 tail's path: CART, tilted, stage tree ----------------
    v1 = {}
    v1_launches = {}
    tree_phases = {}
    for cname in V1_CASCADES:
        vdet = ct.PyramidDetector(ct.load_cascade(cname), SHAPE,
                                  device="cuda", **KNOBS)
        need(not vdet.use_tail2, f"{cname} took tail2")
        say("plan", cascade=cname, levels=vdet.n_levels,
            canvas=f"{vdet.hv}x{vdet.wv}", front_k=vdet.front_k,
            cap=vdet.cap, nodes=vdet.table.n_clf * vdet.table.T,
            tilted=vdet.table.has_tilted, tree=vdet.is_tree)
        vres, vl = drive(vdet, gray)
        if vdet.is_tree:
            tree_cands = vres.candidates
        need(all(vl[k] > 0 for k in ("haar_front", "compact", "tail_walk"))
             and vl["haar_tail2"] == 0 and vl["haar_tail"] == 0
             and vl["tail_rows"] == 0,
             f"{cname}: the v1 path did not run its kernels: {vl}")
        same_as_plain(vdet, gray, vres, f"1080p {cname}")
        v1_launches[cname] = vl
        say("detect", cascade=cname, candidates=len(vres.candidates),
            overflow=vres.survivor_overflow, cap=vdet.cap,
            launches=json.dumps(vl), boxes=json.dumps(vres.boxes.tolist()))
        if vdet._program is not None:
            vdet._program.release()
            vdet._program = None
        if cname != V1_CASCADES[1]:
            # the programs phase's v1 cases: the graph at the cap the main
            # path regrew to (alt_tree: 327,680 slots) against the eager
            # path, on the default route (the walk) and on "block" (the
            # pair) in turns, with the memory each graph reserves; each
            # graph is let go, for the plain versions' room
            programs[cname], programs[cname + "_block"] = route_programs(
                ct, vdet, gray, cname)
            programs[cname]["max_reserved_gb"] = \
                torch.cuda.max_memory_reserved() / 1e9
        # after the main path, so that the kernels are held to their plain
        # versions at the slot count it ran with (regrown where it overflowed)
        v1[cname] = check_v1(vdet, gray, None if vdet.is_tree
                             else np.stack(list(stack.values())))
        # the walk on both scenes, batch 1 and 8
        v1[cname]["tail_walk"]["scenes"] = walk_scenes(vdet, {
            "synth": np.stack(list(stack.values())), "photo": photo[None]})
        if vdet.is_tree:
            # the frame of the cascade with the most survivors, batch 1
            tree_phases = {cname: {"1": breakdown(vdet, vdet.put(gray))}}
            say("phases", cascade=cname, batch=1,
                **tree_phases[cname]["1"])
        del vdet
        torch.cuda.empty_cache()

    # strategy="block" on frontalface_alt: the v1 tail, same candidates
    bl = ct.PyramidDetector(spec, SHAPE, device="cuda", strategy="block",
                            **KNOBS)
    bres, bll = drive(bl, gray)
    need(bll["haar_tail"] > 0 and bll["tail_rows"] > 0
         and bll["haar_tail2"] == 0 and bll["tail_walk"] == 0,
         f"strategy=block did not take the v1 tail: {bll}")
    need(np.array_equal(bres.candidates, res.candidates)
         and np.array_equal(bres.boxes, res.boxes),
         "strategy=block differs from the per-stage path")
    say("block", cascade=CASCADE, candidates=len(bres.candidates),
        launches=json.dumps(bll), equal_to_per_stage=True)
    programs["block"] = program_case(bl, gray[None], "block", reps=3)
    del bl

    # strategy="direct" on frontalface_alt: the stencil product, then the
    # decisions kernel; the card against the CPU in the PARITY bounds
    t0 = time.perf_counter()
    dr = ct.PyramidDetector(spec, SHAPE, device="cuda", strategy="direct",
                            **KNOBS)
    dres, dl = drive(dr, gray)
    need(all(dl[k] > 0 for k in ("haar_front", "compact", "tail_rows"))
         and dl["haar_tail"] == 0 and dl["haar_tail2"] == 0
         and dl["tail_walk"] == 0,
         f"strategy=direct did not run its kernels: {dl}")
    t1 = time.perf_counter()
    cres = ct.PyramidDetector(spec, SHAPE, device="cpu", strategy="direct",
                              **KNOBS).detect(gray, MIN_NEIGHBORS)
    cpu_s = time.perf_counter() - t1
    direct = dict(parity(dres, cres), launches=dl, cpu_seconds=cpu_s,
                  per_stage=parity(dres, res))
    need(direct["jaccard"] >= 0.995 and direct["boxes_matched"],
         f"strategy=direct on the card misses the PARITY bounds against "
         f"the CPU: {direct}")
    dfr = dr.put(gray)
    direct["ms_per_frame"] = timed(lambda: dr._detect_device(dfr, dr.cap),
                                   5)
    direct["per_stage_ms_per_frame"] = timed(
        lambda: det._detect_device(dfr, det.cap), 5)
    direct["seconds"] = time.perf_counter() - t0
    programs["direct"] = program_case(dr, gray[None], "direct", reps=3)
    say("direct", cascade=CASCADE, candidates=len(dres.candidates),
        **{k: json.dumps(v) if isinstance(v, dict) else v
           for k, v in direct.items()})
    del dr

    # ROC at 1080p: frontalface_alt through tail2, frontalface_alt2
    # through the v1 tail; the kernels' packed ROC readback bit-equal to
    # the plain path's on the card
    roc = {}
    for cname, tail in ((CASCADE, "haar_tail2"), (V1_CASCADES[0],
                                                  "tail_walk")):
        rd = ct.PyramidDetector(ct.load_cascade(cname), SHAPE,
                                device="cuda", output_levels=True, **KNOBS)
        (rb, rlv, rw, rov), rl = counted(
            lambda: rd.candidates_with_levels(gray))
        need(rl[tail] > 0 and rl["haar_front"] > 0 and rl["compact"] > 0,
             f"ROC of {cname} did not run its kernels: {rl}")
        need(len(rb) > 0 and not rov, f"ROC of {cname}: no windows")
        fr = rd.put(gray)
        pk = rd._detect_device(fr, rd.cap)["packed_roc"]
        pp = rd._detect_device(fr, rd.cap, plain=True)["packed_roc"]
        need(bits_equal(pk, pp), f"ROC of {cname}: levels or weights "
             f"differ from the plain path on the card")
        roc[cname] = dict(windows=len(rb), launches=rl, front_k=rd.front_k,
                          levels=np.bincount(rlv).tolist()[-5:],
                          max_abs_err=max_abs_err(pk, pp),
                          ms_per_frame=timed(
                              lambda: rd._detect_device(fr, rd.cap), 5))
        say("roc", cascade=cname, equal_to_plain=True,
            **{k: json.dumps(v) if isinstance(v, (dict, list)) else v
               for k, v in roc[cname].items()})
        programs[f"roc_{cname}"] = program_case(rd, gray[None],
                                                f"roc {cname}", reps=3)
        del rd

    # float64 on the card: the plain front and tails, the compaction
    # kernel, box for box with the CPU
    programs["float64"] = check_float64_programs(ct, counters)
    f64 = {cname: dict(candidates=programs["float64"][what]["candidates"][0],
                       card_seconds=programs["float64"][what]["first_s"])
           for what, cname in (("alt_b1", CASCADE),
                               ("alt2", V1_CASCADES[0]))}
    say("float64", shape=f"{VGA[0]}x{VGA[1]}", equal_to_cpu=True,
        launched="compact", **{k: json.dumps(v) for k, v in f64.items()})

    # VGA sweep of every cascade the v1 tail serves: card = CPU
    t0 = time.perf_counter()
    sweep = {}
    for cname in V1_SERVED:
        cs = ct.load_cascade(cname)
        g = frame(5, VGA)
        dc = ct.PyramidDetector(cs, VGA, device="cuda", **SWEEP_KNOBS)
        need(not dc.use_tail2, f"{cname} took tail2")
        gc, go = dc.candidates(g)
        pc, po = ct.PyramidDetector(cs, VGA, device="cpu",
                                    **SWEEP_KNOBS).candidates(g)
        need(go == po and gc.shape == pc.shape and bool((gc == pc).all()),
             f"VGA {cname}: card candidates differ from the CPU")
        sweep[cname] = len(gc)
    say("vga_sweep", shape=f"{VGA[0]}x{VGA[1]}", cascades=len(sweep),
        seconds=round(time.perf_counter() - t0, 3),
        candidates=json.dumps(sweep), equal_to_cpu=True)
    zoo_tails = check_zoo_tails(ct)

    # batch-8 stream of frontalface_alt2, phase breakdown, path times
    a2 = V1_CASCADES[0]
    a2spec = ct.load_cascade(a2)
    a2det = ct.PyramidDetector(a2spec, SHAPE, device="cuda", **KNOBS)
    # the "block" route's detector: the main-path run that carries the
    # v1 pair (haar_tail, tail_rows) at the end
    a2blk = ct.PyramidDetector(a2spec, SHAPE, device="cuda", strategy="block",
                               **KNOBS)
    a2b = stream_equals_singles(a2spec, a2det, a2)
    smem = check_smem_setups([(det, gray), (a2det, gray)])
    phases = {}
    for b in (1, BATCH):
        fr = a2b.put(np.stack([stack[seeds[i % 4]] for i in range(b)]))
        phases[str(b)] = breakdown(a2det, fr)
        say("phases", cascade=a2, batch=b, **phases[str(b)])
    ms_per_frame[a2] = path_times(a2det, a2b, a2, plain_reps=1)

    # ---- scale-cascade mode: the reference demo's configuration --------
    sc, sc_det, sc_frame = check_scale_cascade(ct, counters)

    # ---- the chain microbenchmark: mb_vpu3 ----------------------------
    from clfacedetection_torch.tools import mb_vpu3
    t0 = time.perf_counter()
    chain_checks = check_chain()
    reset_counts(counters)
    tool = mb_vpu3.main(device="cuda", log=lambda line: print(
        f"[mb_vpu3] {line}", flush=True))
    mb_launches = read_counts(counters)
    need(all(mb_launches[k] > 0 for k in ("chain", "haar_front", "compact",
                                          "haar_tail2")),
         f"mb_vpu3 did not run its kernels: {mb_launches}")
    results["chain"] = chain_record(chain_checks, tool)
    say("rates", peak_ops_tops=peaks()[1] / 1e12, empty_ms=tool["empty_ms"],
        matmul_bf16_tflops=round(tool["matmul"]["tflops"], 3),
        tops=json.dumps({b: round(r["tops"], 4)
                         for b, r in results["chain"]["rates"].items()}),
        seconds=round(time.perf_counter() - t0, 3))

    # ---- XML cascades, the native library, the C oracle, the demo ------
    xml = check_xml(ct, stack8, vga)
    cfg5 = multi5.detect(stack8, min_neighbors=0)
    native = check_native(ct, spec, stack, {
        "alt_synth": [res.candidates], "alt_photo": [pres.candidates],
        "alt_tree": [tree_cands],
        "config5": [r.candidates for rk in cfg5 for r in rk],
        "demo": [sc_det.candidates(sc_frame)[0]]})
    oracle = check_oracle(ct)
    demo = check_demo(xml["paths"][DEMO_CASCADE])
    mesh, mesh_drives = check_mesh(ct, counters, spec, stack8, photo,
                                   sc_det, sc_frame)
    xdet = ct.PyramidDetector(ct.load_cascade(xml["paths"][CASCADE]), SHAPE,
                              device="cuda", **KNOBS)

    # the profiler last (see the head of this file): the compaction's and
    # nonzero_static's device time from their kernels' durations, then
    # frontalface_alt's batch-1 pipeline timed again
    say("profiled", name="warmup", device_records=profiler_warmup())
    comp = results["compact"]
    comp.update(profiled(lambda: compact(flags1, det.cap), 20))
    comp.update({f"library_{k}": v for k, v in
                 profiled(nonzero_static(flags1, det.cap), 20).items()})
    fr1 = det.put(np.stack([stack[seeds[0]]]))
    after = timed(lambda: det._detect_device(fr1, det.cap), 10)
    ms_per_frame[CASCADE]["1"]["kernel_after_profiler"] = after
    say("profiled", name="compact", device_ms=comp["device_ms"],
        kernels_per_call=comp["kernels_per_call"],
        library_device_ms=comp["library_device_ms"],
        library_kernels_per_call=comp["library_kernels_per_call"])
    say("time", cascade=CASCADE, batch=1, after_profiler=True,
        kernel_ms_per_frame=round(after, 4))
    # the demo configuration's kernels a frame and device time, from the
    # profiler (one frame at front 3), eager and from its graph, beside
    # their host times: the device's busy share
    sc_prog = sc_det.program()
    sc_prof = profiled(lambda: sc_det._frame_device(
        sc_det.put(sc_frame), sc_det.cap, sc_det._canny_steps)[
            "packed"].cpu(), 1)
    sc_gprof = profiled(lambda: sc_prog.read(sc_prog.run(sc_frame)), 1)
    pr = sc["demo"]["program"]
    sc["demo"].update(
        launches_per_frame=sc_prof["kernels_per_call"],
        device_ms=sc_prof["device_ms"],
        device_busy_share=sc_prof["device_ms"] / pr["eager_ms"],
        graph_kernels_per_frame=sc_gprof["kernels_per_call"],
        graph_device_ms=sc_gprof["device_ms"],
        graph_device_busy_share=sc_gprof["device_ms"] / pr["graph_ms"],
        graph_replay_share=pr["graph_device_ms"] / pr["graph_ms"])
    say("profiled", name="scale_cascade", cascade=DEMO_CASCADE,
        launches_per_frame=sc_prof["kernels_per_call"],
        device_ms=sc_prof["device_ms"], eager_host_ms=pr["eager_ms"],
        graph_kernels_per_frame=sc_gprof["kernels_per_call"],
        graph_device_ms=sc_gprof["device_ms"], graph_host_ms=pr["graph_ms"])
    # config 5: one copy from the card to the host a batch
    d2h = dtoh_copies(lambda: multi5._read(multi5.run_device(stack8)))
    need(d2h == 1, f"config 5: {d2h} copies to the host a batch, not 1")
    programs["config5"]["dtoh_copies_per_batch"] = d2h
    programs["max_reserved_gb"] = torch.cuda.max_memory_reserved() / 1e9
    say("profiled", name="config5", dtoh_copies_per_batch=d2h,
        max_reserved_gb=programs["max_reserved_gb"])

    # the main paths' own runs, for the kernels line: each detector's
    # program exists (one detect first), then every count from 0, one
    # detect through the entry point under the profiler, every count read
    main = {}
    for what, mdet, img, uses in (
            (CASCADE, det, gray, ("haar_front", "compact", "haar_tail2")),
            (a2, a2det, gray, ("haar_front", "compact", "tail_walk")),
            ("block_" + a2, a2blk, gray, ("haar_front", "compact",
                                          "haar_tail", "tail_rows")),
            ("scale_cascade", sc_det, sc_frame, ("compact",)),
            ("xml_" + CASCADE, xdet, gray, ("haar_front", "compact",
                                            "haar_tail2")),
            *mesh_drives):
        mdet.detect(img, MIN_NEIGHBORS)
        _, main[what] = profiled_drive(
            counters, lambda: mdet.detect(img, MIN_NEIGHBORS), what)
        ml = main[what]["launches"]
        need(main[what]["replays"] >= 1
             and all(ml[k] > 0 for k in uses)
             and not any(v for k, v in ml.items() if k not in uses),
             f"{what}: the main path's replay ran {ml}, not {uses}")
        say("main_path", path=what, **{k: json.dumps(v) if isinstance(
            v, dict) else v for k, v in main[what].items()})

    entry = dict(results)
    entry["haar_tail"] = v1[a2]["haar_tail"]
    entry["tail_rows"] = v1[a2]["tail_rows"]
    entry["tail_walk"] = v1[a2]["tail_walk"]
    paths = {CASCADE: launches, "photo_scene": photo_launches,
             **v1_launches, "mb_vpu3": mb_launches,
             "direct": direct["launches"],
             "scale_cascade": sc["demo"]["launches"]}
    # each kernel's launches in its main path's run: the compaction's on
    # scale-cascade mode's path (the demo configuration), the slice this
    # record was extended for; the v1 pair's on alt2's "block" route,
    # which carries it since the walk took the default route; the chain's
    # in the mb_vpu3 run (eager)
    path_of = {"haar_front": main[CASCADE]["launches"],
               "haar_tail2": main[CASCADE]["launches"],
               "haar_tail": main["block_" + a2]["launches"],
               "tail_rows": main["block_" + a2]["launches"],
               "tail_walk": main[a2]["launches"],
               "compact": main["scale_cascade"]["launches"],
               "chain": mb_launches}
    entry["compact"] = dict(
        entry["compact"],
        launches_tail2_path=main[CASCADE]["launches"]["compact"])
    record = {"kernels": [
        dict(name=k, route="cuda", source=src, replaces=rep,
             launches=path_of[k][k], **entry[k])
        for k, src, rep in KERNELS]}
    record["main_path_runs"] = main
    # launches a frame of 1080p frontalface_alt at batch 8: one graph of
    # the batch, and the 8-position mesh (a graph a position)
    record["launches_a_frame"] = {
        w: {k: main[w]["launches"][k] / BATCH for k in KERNEL_SYMBOLS}
        for w in ("batch8_" + CASCADE, "mesh_batch8x8")}
    say("main_path", launches_a_frame=json.dumps(record["launches_a_frame"]))
    # each kernel's device ms a frame in those runs (profiler durations)
    record["device_ms_a_frame"] = {
        w: {k: main[w]["device_ms"][k] / BATCH for k in KERNEL_SYMBOLS}
        for w in ("batch8_" + CASCADE, "mesh_batch8x8")}
    say("main_path",
        device_ms_a_frame=json.dumps(record["device_ms_a_frame"]))
    record["launches_by_path"] = paths
    record["launches_counted_as"] = (
        "kernels line: the profiler's kernel records of each main path's "
        "own run (a graph replay, through detect); launches_by_path: the "
        "wrappers' counts of eager launches (a program's warm-up), "
        "captures and replays not counted")
    record["photo_scene"] = dict(survivors=photo_surv,
                                 jax_survivors=JAX_PHOTO_SURVIVORS,
                                 unfused_variance=unfused,
                                 candidates=len(pres.candidates),
                                 boxes=pres.boxes.tolist())
    record["v1_checks"] = v1
    record["phases_ms_per_frame"] = {a2: phases, **tree_phases}
    record["ms_per_frame"] = ms_per_frame
    record["vga_sweep"] = sweep
    record["zoo_tails"] = zoo_tails
    record["direct"] = direct
    record["roc"] = roc
    record["float64"] = f64
    record["scale_cascade"] = sc
    record["programs"] = programs
    record["xml"] = {k: v for k, v in xml.items() if k != "paths"}
    record["native"] = native
    record["oracle"] = oracle
    record["demo"] = demo
    record["mesh"] = mesh
    record["flops"] = flops
    record["smem"] = smem
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
