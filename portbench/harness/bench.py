"""One run of one cell: set-up, the measured window, the traced slice,
the reference's judgement and the result line.

    set-up    build the program's entry, make the pool of frames from the
              seed, run every pool frame through the timed entry once
    window    the cell's traffic for ``seconds`` (never traced)
    slice     with ``trace``: ``mix["trace_frames"]`` more frames under the
              profiler, kept as a summary (``trace.py``)
    judge     the program's objects freed, the reference on the judged
              pool frames, every served result of them compared

The metrics are found by name: the cell's end-to-end metrics (``trace``
0) or per-layer metrics (``trace`` 1) in ``BENCHMARK.json``, each read by
``metrics/<name>.py``'s ``read(ctx)``, which returns a number, a dict with
``value`` and more keys, or None where it finds nothing to read.
"""

from __future__ import annotations

import glob
import json
import os
import subprocess
import sys
import time
from typing import Dict, Optional

from .cell import CHECKOUT, ROOT, Cell, load_module

__all__ = ["run", "NoCard"]


class NoCard(Exception):
    """No CUDA card, or fewer than the cell asks for."""


def _benchmark() -> dict:
    with open(os.path.join(CHECKOUT, "BENCHMARK.json")) as f:
        return json.load(f)


def _metrics(workload: str, trace: bool) -> list:
    entries = _benchmark()["per_layer" if trace else "end_to_end"]
    return [m for m in entries
            if "workloads" not in m or workload in m["workloads"]]


def _groups() -> Dict[str, dict]:
    out = {}
    for p in sorted(glob.glob(os.path.join(ROOT, "layers", "*.json"))):
        with open(p) as f:
            out[os.path.basename(p)[:-5]] = json.load(f)
    return out


def _power_limit() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip().splitlines()[0].split(",")[-1].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def run(workload: str, seed: int, seconds: float, trace: bool,
        t_start: float, device=None, overrides: Optional[dict] = None,
        err=sys.stderr) -> dict:
    """The run's result (the last line's object).  ``device`` None means
    the card, which must be there; the tests pass the CPU."""
    import torch
    cell = Cell(workload, None, overrides)
    if device is None:
        need = int(cell.spec["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < need:
            raise NoCard(f"the cell needs {need} CUDA card(s); "
                         f"found {torch.cuda.device_count()}")
        device = torch.device("cuda", 0)
    device = torch.device(device)
    cell.device = device
    card = device.type == "cuda"
    power = _power_limit() if card else "not read"

    cell.setup()
    frames = cell.frames(seed)
    cell.run(frames, seed, count=len(frames))
    if card:
        torch.cuda.synchronize(device)
    t_window = time.perf_counter()
    setup_s = t_window - t_start
    served = cell.run(frames, seed, seconds=seconds)
    attempted = len(served)
    end = t_window + seconds
    summary = slice_frames = None
    if trace:
        from .trace import span, traced
        n = int(cell.mix["trace_frames"])
        sliced, summary = traced(lambda: cell.run(frames, seed + 1, count=n,
                                                  span=span))
        slice_frames = len(sliced)
    peak = torch.cuda.max_memory_allocated(device) if card else 0
    cell.release()

    t_ref = time.perf_counter()
    sample = cell.judged(seed)
    refs = cell.reference(frames, sample)
    worst, failed, judged = cell.judge(served, refs)
    print(f"setup_s {setup_s:.2f}; window {len(served)} frames; reference "
          f"and judgement of {judged} results {time.perf_counter() - t_ref:.2f}"
          f" s; power limit {power}", file=err)

    from .flops import floor
    from ..reference.cascade import Cascade
    cascades = [Cascade(p) for p in cell.paths]
    floors = [floor(cascades, refs[int(i)], cell.cfg["mode"]) for i in sample]
    ctx = dict(cell=cell, served=served, seconds=seconds, end=end,
               setup_s=setup_s, attempted=attempted, trace=summary,
               slice_frames=slice_frames, floors=floors, groups=_groups(),
               power_limit=power)
    ctx["frames_per_s"] = sum(1 for s in served if s.t1 <= end) / seconds
    metrics = {}
    for m in _metrics(workload, trace):
        v = load_module("metrics", m["name"]).read(ctx)
        if v is None:
            continue
        v = dict(v) if isinstance(v, dict) else {"value": float(v)}
        v["unit"] = m["unit"]
        metrics[m["name"]] = v

    dev = {"platform": "gpu" if card else device.type,
           "kind": torch.cuda.get_device_name(device) if card else "cpu",
           "count": 1, "memory_peak_bytes": int(peak),
           "power_limit": power}
    result = {"correct": bool(judged > 0 and all(
        worst[k] <= cell.limits[k] for k in worst)),
        "attempted": attempted, "failed": failed, "metrics": metrics,
        "device": dev}
    if summary is not None:
        from .trace import breakdown
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        result["breakdown"] = breakdown(summary)
        os.makedirs(os.path.join(CHECKOUT, "bench_out"), exist_ok=True)
        with open(os.path.join(CHECKOUT, "bench_out",
                               f"trace-{workload}-{seed}.json"), "w") as f:
            json.dump(dict(summary, slice_frames=slice_frames), f)
    checks = {k: {"value": worst[k], "limit": cell.limits[k]} for k in worst}
    checks["judged"] = {"value": judged, "limit": "more than 0"}
    result["checks"] = checks
    for k, v in checks.items():
        print(f"check {k}: {v['value']} (limit {v['limit']})", file=err)
    return result
