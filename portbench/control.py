"""The readings that a cell's limits are set from, on the card.

    python3 portbench/control.py --workload <cell> --seeds 1,2,... \
        --control-seeds 1,2,3 [--seconds 3]

For each seed, in one process: the seed's pool of frames through the
cell's timed entry (every frame once, then ``--seconds`` of the cell's
traffic), the float64 reference on the judged frames, and the worst of
each compared number over the served results (the program's readings).
For each control seed, the reference in bfloat16 (``reference/detect.py``)
put in the program's place on the same frames: the control's readings.
A cell's limit lies above the program's highest reading and below the
control's lowest.  Prints one JSON line a reading and writes them all to
``bench_out/control-<cell>.json``.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def readings(workload, seeds, control_seeds, seconds, device=None,
             overrides=None):
    """[(kind, seed, {number: worst}), ...] for the program and the
    control."""
    import torch
    from portbench.harness.cell import Cell, Served
    device = torch.device(device or "cuda")
    cell = Cell(workload, device, overrides)
    cell.setup()
    out = []
    for seed in sorted(set(seeds) | set(control_seeds)):
        frames = cell.frames(seed)
        sample = cell.judged(seed)
        if seed in seeds:
            cell.run(frames, seed, count=len(frames))
            served = cell.run(frames, seed, seconds=seconds)
            refs = cell.reference(frames, sample)
            worst, _, judged = cell.judge(served, refs)
            out.append(("program", seed, dict(worst, judged=judged)))
        if seed in control_seeds:
            if seed not in seeds:
                refs = cell.reference(frames, sample)
            low = cell.reference(frames, sample, precision="bfloat16")
            served = [Served(int(i), [(d.candidates, d.boxes, d.neighbors)
                                      for d in low[int(i)]], 0.0, 0.0)
                      for i in sample]
            worst, _, judged = cell.judge(served, refs)
            out.append(("control", seed, dict(worst, judged=judged)))
    return out


def main(argv=None) -> int:
    import argparse
    import json
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    a = ap.parse_args(argv)
    seeds = [int(s) for s in a.seeds.split(",") if s]
    ctrl = [int(s) for s in a.control_seeds.split(",") if s]
    rows = []
    for kind, seed, r in readings(a.workload, seeds, ctrl, a.seconds):
        rows.append(dict(kind=kind, seed=seed, **r))
        print(json.dumps(rows[-1]), flush=True)
    os.makedirs("bench_out", exist_ok=True)
    with open(os.path.join("bench_out", f"control-{a.workload}.json"),
              "w") as f:
        json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
