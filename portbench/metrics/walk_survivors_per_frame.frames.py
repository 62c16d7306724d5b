"""Windows a frame that the walk tail (``csrc/tail_walk.cu``) serves: the
survivors of the cascades whose tail is the walk over the whole process,
from the program's counters (``served.walk_survivors`` / ``frames``).
``walk_slot_use_pct``: those survivors over the slots the walk ran over
(B x cap a served batch), in %; ``walk_yield_pct``: the windows the walk
accepted over its survivors, in %; ``walk_ms``: ``walk_kernel``'s device
ms a frame in the traced slice, where there is one.  None where the
program has no such counters."""

from portbench.harness.cell import load_module


def read(ctx):
    c = load_module("metrics", "_program").counters()
    if not c or not c.get("frames") or "served.walk_survivors" not in c:
        return None
    n, surv = c["frames"], c["served.walk_survivors"]
    out = {"value": surv / n, "frames": n}
    if c.get("served.walk_slots"):
        out["walk_slot_use_pct"] = 100.0 * surv / c["served.walk_slots"]
    if surv:
        out["walk_yield_pct"] = 100.0 * c.get("served.walk_accepted",
                                              0) / surv
    if ctx.get("trace") and ctx.get("slice_frames"):
        layers = load_module("metrics", "_layers")
        s = sum(v[1] for k, v in ctx["trace"]["kernels"].items()
                if layers._match("walk_kernel", k))
        out["walk_ms"] = 1e3 * s / ctx["slice_frames"]
    return out
