"""Host ms a frame inside ``detect_multi_scale_full`` in the demo's cell,
the card's readback wait left out (``_host.py``)."""

from portbench.harness.cell import load_module


def read(ctx):
    return load_module("metrics", "_host").read(ctx)
