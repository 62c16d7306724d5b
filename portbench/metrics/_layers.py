"""Device seconds of the traced slice by layer group: each kernel is
matched by ``layers/<group>.json``'s symbol patterns; a kernel that no
group claims is the prep's (the resizes, the canvas, the integrals and
the packing, all plain PyTorch)."""

import re


def _match(sym: str, name: str) -> bool:
    return re.search(rf"(?:^|[\s:\d]){re.escape(sym)}(?:[<(IE]|$)", name) \
        is not None


def group_of(groups: dict, name: str) -> str:
    for g, spec in groups.items():
        if any(_match(s, name) for s in spec["symbols"]):
            return spec["layer"]
    return "prep"


def seconds(ctx, layer: str) -> float:
    return sum(v[1] for k, v in ctx["trace"]["kernels"].items()
               if group_of(ctx["groups"], k) == layer)


def per_frame_ms(ctx, layer: str):
    if not ctx["trace"] or not ctx["slice_frames"]:
        return None
    return 1e3 * seconds(ctx, layer) / ctx["slice_frames"]
