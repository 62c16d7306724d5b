"""Seconds of set-up that the programs spent on the card's graphs: each
capture's eager warm-up, capture and instantiation, summed over the
process, from the program's counters; beside them the detector builds,
the kernel library's load or build, and the captures, cap regrowths and
detectors built."""

from portbench.harness.cell import load_module

PARTS = ("program.warmup_s", "program.capture_s", "program.instantiate_s")
MORE = ("detector.build_s", "kernels.library_s", "program.captures",
        "cap.regrowths", "detector.built")


def read(ctx):
    c = load_module("metrics", "_program").counters()
    if not c:
        return None
    out = {"value": sum(c.get(k, 0) for k in PARTS)}
    out.update({k: c.get(k, 0) for k in PARTS + MORE})
    return out
