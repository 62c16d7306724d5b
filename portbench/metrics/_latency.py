"""A percentile of the latency of every frame of the window: a frame's
time from its due time (open loop) or submission (closed loop) to the
return of its grouped results.  In a closed loop the frames counted are
those that came back inside the window; in an open loop those due inside
it, each waited for."""

import numpy as np


def percentile(ctx, q: float):
    served = ctx["served"]
    if ctx["cell"].mix["generator"] != "live":
        served = [s for s in served if s.t1 <= ctx["end"]]
    if not served:
        return None
    lat = np.array([s.t1 - s.t0 for s in served]) * 1e3
    return {"value": float(np.percentile(lat, q)), "frames": len(lat)}
