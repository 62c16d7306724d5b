#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``clfacedetection_torch/csrc``, holds each
kernel against its plain PyTorch version on the card at the 1080p shapes
of frontalface_alt with the headline settings (scaleFactor 1.1, minSize
40x40, minNeighbors 3, front_stages 10, cap 20480), drives the main path
(``PyramidDetector.detect`` and ``BatchedPyramidDetector.detect_stream``)
and times the kernel path against the plain path with CUDA events.

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
]


class SmokeFailure(Exception):
    pass


def need(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def say(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


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


def bits_equal(a, b) -> bool:
    import torch
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and bool(torch.equal(a, b))


def max_abs_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def check_kernels(det, gray) -> dict:
    """Each kernel against its plain version on the card, at the main
    path's shapes; returns per-kernel error and times."""
    import torch
    from clfacedetection_torch.ops.compact_kernel import (compact,
                                                          compact_plain)
    from clfacedetection_torch.ops.haar_front import front_plain, haar_front
    from clfacedetection_torch.ops.haar_tail2 import haar_tail2, tail2_plain
    frames = det.put(gray)
    s, hi, lo = det._prep_planes(frames)
    args = (s, hi, lo, det._visit, det.table, det.front_k)
    fk, vk = haar_front(*args)
    fp, vp = front_plain(*args)
    torch.cuda.synchronize()
    need(bits_equal(fk, fp), "front mask differs from its plain version")
    need(bits_equal(vk, vp), "front vnf differs from its plain version")
    out = {"haar_front": dict(
        max_abs_err=max(max_abs_err(vk, vp), max_abs_err(fk, fp)),
        ms=timed(lambda: haar_front(*args), 20),
        plain_ms=timed(lambda: front_plain(*args), 2))}
    say("kernel", name="haar_front", grid=f"{det.hv}x{det.wv}",
        survivors=int(fk.sum()), **out["haar_front"])

    flags = fk.reshape(1, -1)
    n_true = int(flags.sum())
    ik, nk = compact(flags, det.cap)
    ip, np_ = compact_plain(flags, det.cap)
    need(bits_equal(ik, ip) and bits_equal(nk, np_),
         "compaction differs from its plain version")
    need(int(nk[0]) == n_true, "compaction count is not the true count")
    small = max(1, n_true // 2)                # forced overflow
    ok_, on = compact(flags, small)
    op, opn = compact_plain(flags, small)
    need(bits_equal(ok_, op) and bits_equal(on, opn) and int(on[0]) > small,
         "overflowing compaction differs or hides the overflow")
    out["compact"] = dict(
        max_abs_err=max_abs_err(ik, ip),
        ms=timed(lambda: compact(flags, det.cap), 20),
        plain_ms=timed(lambda: compact_plain(flags, det.cap), 5))
    say("kernel", name="compact", flags=flags.shape[1], n=n_true,
        cap=det.cap, overflow_cap=small, **out["compact"])

    targs = (s, vk, ik, det.table, det.front_k)
    rk = haar_tail2(*targs)
    rp = tail2_plain(*targs)
    need(bits_equal(rk, rp), "tail rows differ from their plain version")
    out["haar_tail2"] = dict(
        max_abs_err=max_abs_err(rk, rp),
        ms=timed(lambda: haar_tail2(*targs), 20),
        plain_ms=timed(lambda: tail2_plain(*targs), 2))
    say("kernel", name="haar_tail2", slots=det.cap,
        accepted=int((rk[..., 1] > 0).sum()), **out["haar_tail2"])
    return out


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
    from clfacedetection_torch.ops.haar_tail2 import haar_tail2
    counters = {"haar_front": haar_front, "compact": compact,
                "haar_tail2": haar_tail2}

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

    spec = ct.load_cascade(CASCADE)
    gray = frame(3)
    det = ct.PyramidDetector(spec, SHAPE, device="cuda", **KNOBS)
    say("plan", levels=det.n_levels, canvas=f"{det.hv}x{det.wv}",
        visited=det.n_visit, front_k=det.front_k, cap=det.cap)
    results = check_kernels(det, gray)

    # main path: counters from 0, one detect() through the kernels
    for fn in counters.values():
        fn.launches = 0
    res = det.detect(gray, min_neighbors=MIN_NEIGHBORS)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    need(all(v > 0 for v in launches.values()),
         f"a kernel was not launched on the main path: {launches}")
    need(not res.survivor_overflow, "survivor cap overflowed")
    frames = det.put(gray)
    plain_cand, plain_ovf = det.readback(
        det._detect_device(frames, det.cap, plain=True), det.cap)[0]
    need(len(res.candidates) > 0, "no candidates at 1080p")
    need(bool((res.candidates == plain_cand).all())
         and len(res.candidates) == len(plain_cand),
         "1080p candidates differ from the plain path on the card")
    say("detect", shape=f"{SHAPE[0]}x{SHAPE[1]}",
        candidates=len(res.candidates), launches=json.dumps(launches),
        boxes=json.dumps(res.boxes.tolist()),
        neighbors=json.dumps(res.neighbors.tolist()))

    vga = frame(5, VGA)
    vc, vo = ct.PyramidDetector(spec, VGA, device="cuda", **KNOBS) \
        .candidates(vga)
    cc, co = ct.PyramidDetector(spec, VGA, device="cpu", **KNOBS) \
        .candidates(vga)
    need(vo == co and vc.shape == cc.shape and bool((vc == cc).all()),
         "VGA candidates on the card differ from the CPU plain path")
    say("vga", candidates=len(vc), equal_to_cpu=True)

    # batched stream: every frame equal to the single-frame path
    seeds = [3, 11, 17, 29]
    singles = {sd: det.detect(frame(sd), MIN_NEIGHBORS) for sd in seeds}
    order = [seeds[i % len(seeds)] for i in range(BATCH * N_BATCHES)]
    bdet = ct.BatchedPyramidDetector(spec, SHAPE, batch=BATCH,
                                     device="cuda", **KNOBS)
    import numpy as np
    stack = {sd: frame(sd) for sd in seeds}
    batches = [np.stack([stack[sd] for sd in order[i:i + BATCH]])
               for i in range(0, len(order), BATCH)]
    got = [r for out in bdet.detect_stream(batches, MIN_NEIGHBORS)
           for r in out]
    need(len(got) == len(order), "stream lost frames")
    for sd, r in zip(order, got):
        one = singles[sd]
        need(np.array_equal(r.candidates, one.candidates)
             and np.array_equal(r.boxes, one.boxes),
             f"stream frame (seed {sd}) differs from the single-frame path")
    say("stream", batch=BATCH, batches=N_BATCHES, frames=len(got),
        equal_to_single=True)

    # device ms/frame, kernel path vs plain path
    times = {}
    for b in (1, BATCH):
        fr = bdet.put(np.stack([stack[seeds[i % 4]] for i in range(b)]))
        cap = det.cap
        k = timed(lambda: det._detect_device(fr, cap), 10) / b
        p = timed(lambda: det._detect_device(fr, cap, plain=True), 2) / b
        times[b] = (k, p)
        say("time", batch=b, kernel_ms_per_frame=round(k, 4),
            plain_ms_per_frame=round(p, 4))

    record = {"kernels": [
        dict(name=k, route="cuda", source=src, replaces=rep,
             launches=launches[k], **results[k])
        for k, src, rep in KERNELS]}
    record["ms_per_frame"] = {str(b): {"kernel": k, "plain": p}
                              for b, (k, p) in times.items()}
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
