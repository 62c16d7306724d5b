"""The chain kernel of this checkout against another checkout's, on the
card, with one timer.

    python -m clfacedetection_torch.tools.chain_ab OTHER

OTHER is the root of another checkout of the repo (an unpacked ``git
archive`` of an earlier commit, say).  Its package is imported under
another name, so that both builds of the kernels load in one process.
Each of ``ROUNDS`` rounds times the four chains of ``tools/mb_vpu3.py``
at 4 and 16 trips, the other checkout first, then this one twice, then
the other again, each call one of ``GRAPH_CALLS`` in a replayed CUDA graph
(``mb_vpu3``'s timer).  Before the timings it holds the two kernels'
outputs equal.  Prints a line a checkout and body, and then one JSON
object: every reading, and per checkout and body the median ms at each
trip count and the slope's T op/s by the JAX's op counts.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import statistics
import sys

import numpy as np
import torch

from ..ops.chain import GH, GW, IN_W, OPS_PER_TRIP, chain
from .mb_vpu3 import CHAINS, TRIPS, Timer, _chain_ms

__all__ = ["main", "load_other", "ROUNDS"]

_OTHER = "clfd_other"
ROUNDS = 2


def load_other(root: str):
    """``ops.chain`` of the checkout at ``root``, its package imported as
    ``clfd_other``."""
    pkg = os.path.join(os.path.abspath(root), "clfacedetection_torch")
    spec = importlib.util.spec_from_file_location(
        _OTHER, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[_OTHER] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module(f"{_OTHER}.ops.chain")


def main(other_root: str, log=print) -> dict:
    dev = torch.device("cuda")
    other = load_other(other_root).chain
    x = torch.from_numpy(np.random.default_rng(0).random(
        (GH, IN_W)).astype(np.float32)).to(dev)
    fns = {"other": other, "this": chain}
    for body, _ in CHAINS:
        for tr in TRIPS:
            if not torch.equal(other(x, body, tr, GW),
                               chain(x, body, tr, GW)):
                raise RuntimeError(f"{body} at {tr} trips: the checkouts "
                                   f"differ")
    timer = Timer(dev)
    runs = {k: {b: {tr: [] for tr in TRIPS} for b, _ in CHAINS}
            for k in fns}
    for _ in range(ROUNDS):
        for key in ("other", "this", "this", "other"):
            for body, _ in CHAINS:
                for tr in TRIPS:
                    ms, _ = _chain_ms(
                        timer, lambda: fns[key](x, body, tr, GW))
                    runs[key][body][tr].append(ms)
    nel = GH * GW
    t0, t1 = TRIPS
    out = {}
    for key, by_body in runs.items():
        out[key] = {}
        for body, r in by_body.items():
            ms = {tr: statistics.median(v) for tr, v in r.items()}
            slope = (ms[t1] - ms[t0]) / ((t1 - t0) * OPS_PER_TRIP[body])
            out[key][body] = dict(ms=ms, tops=nel / slope * 1e3 / 1e12)
            log(f"{key:5s} {body:6s}: " + ", ".join(
                f"{tr} trips {ms[tr]:.5f} ms" for tr in TRIPS)
                + f"; slope {out[key][body]['tops']:.2f} T op/s")
    res = dict(device=torch.cuda.get_device_name(dev), other=other_root,
               rounds=ROUNDS, runs=runs, median=out)
    log(json.dumps(res))
    return res


def _args(argv):
    p = argparse.ArgumentParser(
        prog="python -m clfacedetection_torch.tools.chain_ab",
        description=__doc__.split("\n\n")[0])
    p.add_argument("other", help="root of the other checkout")
    return p.parse_args(argv)


if __name__ == "__main__":
    main(_args(sys.argv[1:]).other)
