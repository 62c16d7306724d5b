"""Kernel ms a frame in the traced slice: the device's share of one
frame's service (copies and sets left out)."""


def read(ctx):
    t = ctx["trace"]
    if not t or not ctx["slice_frames"]:
        return None
    return 1e3 * sum(v[1] for v in t["kernels"].values()) \
        / ctx["slice_frames"]
