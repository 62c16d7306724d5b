"""The whole detection step's share of the card's float32 peak, in %
(``_mfu.py``), in the cells that ``frames_per_s`` measures."""

from portbench.harness.cell import load_module


def read(ctx):
    return load_module("metrics", "_mfu").share(ctx)
