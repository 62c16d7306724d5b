"""Host ms a frame inside the entry point: the seconds of the slice's
``entry.detect`` spans less, within them, the wait for the card's
readback (``program.wait``) and the graph's launch (``program.replay``),
over the slice's frames.  The launch is reported apart, as
``program.replay_ms``, because the CUDA profiler of a traced run records
each kernel the graph launches inside it, at a cost of its own.  Beside
them each span of the slice (``<span>_ms``: seconds over frames, self
seconds for ``entry.detect`` itself), so that the host's share of a frame
is told step by step."""

from portbench.harness.cell import load_module


def read(ctx):
    prog = load_module("metrics", "_program")
    s = prog.spans()
    n = ctx["slice_frames"]
    if not s or "entry.detect" not in s or not n:
        return None
    ms = 1e3 / n
    off = sum(prog.within(s, k, "entry.detect")
              for k in ("program.wait", "program.replay"))
    out = {"value": (s["entry.detect"]["seconds"] - off) * ms,
           "entry.detect.self_ms": s["entry.detect"]["self_seconds"] * ms}
    for name, v in sorted(s.items()):
        if name != "entry.detect":
            out[f"{name}_ms"] = v["seconds"] * ms
    return out
