"""Host ms a frame of the grouping (the program's ``host.group`` spans,
on the stream's drain thread) in the traced slice."""

from portbench.harness.cell import load_module


def read(ctx):
    s = load_module("metrics", "_program").spans()
    if not s or "host.group" not in s or not ctx["slice_frames"]:
        return None
    return 1e3 * s["host.group"]["seconds"] / ctx["slice_frames"]
