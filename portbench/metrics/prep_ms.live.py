"""Device ms a frame of the kernels outside the program's hand-written
library (copies and sets left out), in the traced slice: the resize
pyramid, the canvas, the integrals and the packing (``_layers.py``)."""

from portbench.harness.cell import load_module


def read(ctx):
    return load_module("metrics", "_layers").per_frame_ms(ctx, "prep")
