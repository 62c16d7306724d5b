"""The 95th percentile of the window's frame latencies (``_latency.py``),
in ms."""

from portbench.harness.cell import load_module


def read(ctx):
    return load_module("metrics", "_latency").percentile(ctx, 95)
