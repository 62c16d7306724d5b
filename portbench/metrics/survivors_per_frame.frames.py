"""Windows the survivor compaction keeps a frame (the packed readback's
count of survivors, every cascade of the configuration summed) over the
whole process, from the program's counters; ``tail_yield_pct``: the
survivors the tail accepts, in %; ``candidates_per_frame`` and
``boxes_per_frame``: what the grouping takes in and gives out a frame."""

from portbench.harness.cell import load_module


def read(ctx):
    c = load_module("metrics", "_program").counters()
    if not c or not c.get("frames") or "survivors" not in c:
        return None
    n = c["frames"]
    out = {"value": c["survivors"] / n, "frames": n,
           "candidates_per_frame": c.get("candidates", 0) / n,
           "boxes_per_frame": c.get("boxes", 0) / n}
    if c["survivors"]:
        out["tail_yield_pct"] = 100.0 * c.get("accepted", 0) / c["survivors"]
    return out
