"""Kernel records a frame in the traced slice (copies and sets left
out)."""


def read(ctx):
    t = ctx["trace"]
    if not t or not ctx["slice_frames"]:
        return None
    return sum(v[0] for v in t["kernels"].values()) / ctx["slice_frames"]
