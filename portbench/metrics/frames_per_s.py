"""Frames whose grouped results reached the caller inside the window, over
the window's length (host clock)."""


def read(ctx):
    return ctx["frames_per_s"]
