"""Seconds from the process's start to the window's: imports, the card's
context, the kernel and native builds or loads, the detector, the frames,
and every pool frame through the timed entry once (its captures)."""


def read(ctx):
    return ctx["setup_s"]
