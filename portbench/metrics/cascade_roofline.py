"""The cascade kernels' share of their roofline, in %: the least time of
a frame's cascade work, the larger of its variance and stage operations
over 66.9e12 a second and its bytes (integral planes read once, candidates
written once) over 3.35e12 a second, from the floor on the reference's
entering counts; over the device seconds a frame of the kernels that
``layers/cascade.json`` names, in the traced slice.  ``bound`` says which
quotient was the larger."""

import numpy as np

from portbench.harness.cell import load_module
from portbench.harness.flops import PEAK_BYTES, PEAK_F32_OPS


def read(ctx):
    layers = load_module("metrics", "_layers")
    ms = layers.per_frame_ms(ctx, "cascade")
    if not ms or not ctx["floors"]:
        return None
    t_ops = float(np.mean([f["cascade_ops"] for f in ctx["floors"]])) \
        / PEAK_F32_OPS
    t_bytes = float(np.mean([f["bytes"] for f in ctx["floors"]])) / PEAK_BYTES
    least = max(t_ops, t_bytes)
    return {"value": 100.0 * least / (ms * 1e-3),
            "bound": "ops" if t_ops >= t_bytes else "bytes",
            "power_limit": ctx["power_limit"]}
