"""Frames whose results reached the caller inside the window, over the
window's length (host clock): ``frames_per_s`` of the demo's one camera,
a metric of its own so that its bound is its own."""


def read(ctx):
    return ctx["frames_per_s"]
