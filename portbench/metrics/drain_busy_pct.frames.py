"""How busy the stream's one drain thread is, in % of the traced slice:
its ``stream.drain`` spans less the card's readback waits inside them
(``program.wait`` within ``stream.drain``), over the slice's span.  Near
100 the drain thread, not the card, sets the stream's pace.  Beside it
the process's back-pressure counters: ``program.slots_grown`` (a
readback slot made because every slot was still held: the enqueue ran
ahead of the drain) and ``program.stage_waits`` (an upload that waited
for the card to read the staging buffer before it)."""

from portbench.harness.cell import load_module

BACKPRESSURE = ("program.slots_grown", "program.stage_waits")


def read(ctx):
    prog = load_module("metrics", "_program")
    s = prog.spans()
    t = ctx["trace"]
    if not s or "stream.drain" not in s or not t or t["window_s"] <= 0:
        return None
    busy = s["stream.drain"]["seconds"] \
        - prog.within(s, "program.wait", "stream.drain")
    out = {"value": 100.0 * busy / t["window_s"],
           "drains": s["stream.drain"]["count"]}
    c = prog.counters() or {}
    out.update({k: c.get(k, 0) for k in BACKPRESSURE})
    return out
