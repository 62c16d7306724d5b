"""The whole detection step's share of the card's float32 peak, in %: the
scalar early-exit floor of a frame's operations (``harness/flops.py``,
from the reference's entering counts on the judged frames, every cascade
of the configuration summed, mean over the frames) times the run's
frames/s over its untraced window, over 66.9e12 operations a second."""

import numpy as np

from portbench.harness.flops import PEAK_F32_OPS


def share(ctx):
    if not ctx["floors"] or ctx["frames_per_s"] <= 0:
        return None
    ops = float(np.mean([f["ops"] for f in ctx["floors"]]))
    return {"value": 100.0 * ops * ctx["frames_per_s"] / PEAK_F32_OPS,
            "ops_per_frame": ops, "power_limit": ctx["power_limit"]}
