"""The highest rate an open-loop cell sustains, by a sweep on the card.

    python3 portbench/sweep.py --workload alt-1080p-live-photo \
        --rates 110,120,130,140 --repeats 3 --seconds 15 --seed 1

Builds the cell once, then offers each rate for ``--seconds`` (the mix
with its ``rate`` replaced), the rates in turn and the turns
``--repeats`` times, each turn with its own seed, and prints, a line a
rate and turn: the latency's median and 95th percentile, its mean in the
first and the last quarter of the window, and how late the last frame
came back after the window's end.  A rate is sustained where, in every
turn, the last quarter's mean latency is no longer than the first's by
more than 2 ms: the backlog does not grow.  The lag is printed, not
judged: the frame due last may be the last of cameras due together, so
its lag is a tail of one arrangement, not a backlog.  The last line gives
the knee, the highest rate sustained with every lower rate, and four
fifths of it.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def sustained(row) -> bool:
    return row["mean_last_ms"] <= row["mean_first_ms"] + 2.0


def main(argv=None) -> int:
    import argparse
    import json
    import time

    import numpy as np
    import torch

    from portbench.harness.cell import Cell
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--seed", type=int, default=1)
    a = ap.parse_args(argv)
    rates = sorted(float(r) for r in a.rates.split(","))
    cell = Cell(a.workload, torch.device("cuda"))
    cell.setup()
    frames = cell.frames(a.seed)
    cell.run(frames, a.seed, count=len(frames))
    rows = []
    for turn in range(a.repeats):
        for rate in rates:
            cell.mix["rate"] = rate
            t0 = time.perf_counter()
            served = cell.run(frames, a.seed + turn, seconds=a.seconds)
            lat = np.array([s.t1 - s.t0 for s in served]) * 1e3
            q = max(1, len(served) // 4)
            rows.append(dict(
                rate=rate, turn=turn, frames=len(served),
                p50_ms=float(np.percentile(lat, 50)),
                p95_ms=float(np.percentile(lat, 95)),
                mean_first_ms=float(lat[:q].mean()),
                mean_last_ms=float(lat[-q:].mean()),
                lag_ms=1e3 * (served[-1].t1 - (t0 + a.seconds))))
            print(json.dumps(rows[-1]), flush=True)
    knee = None
    for rate in rates:
        if not all(sustained(r) for r in rows if r["rate"] == rate):
            break
        knee = rate
    print(json.dumps(dict(knee=knee, rate=None if knee is None
                          else 0.8 * knee)), flush=True)
    os.makedirs("bench_out", exist_ok=True)
    with open(os.path.join("bench_out", f"sweep-{a.workload}.json"),
              "w") as f:
        json.dump(dict(rows=rows, knee=knee), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
