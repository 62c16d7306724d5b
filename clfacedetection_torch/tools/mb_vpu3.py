"""Op-rate microbenchmarks and the front sweep, on the card.

    python -m clfacedetection_torch.tools.mb_vpu3 [--device cpu]

Port of ``scripts/mb_vpu3.py``: every section of its ``main()``, in
order, through the port's kernels.

* the empty sweep: the chain kernel with the identity body, one trip;
* the four op chains (``ops/chain.py``: slice+add, mul+max, mul+cmp+sel+
  add, the rect mix) at 4 and 16 trips over f32 [2272, 384] ->
  [2272, 1280]; the slope between the two gives ps per element and
  operation and the rate in T operations/s, with the JAX's operations a
  trip and ``NEL = gh * gw`` elements, with the card's SM clock sampled
  meanwhile; each trip loop's instructions counted in the SASS
  (``cuobjdump -sass``), and its floors: warp instructions at 4 a clock
  an SM, shared bytes at 128 a clock an SM;
* the bf16 product chain: 16 products of [2048, 768] by [768, 2048]
  through ``torch.matmul`` (the JAX leaves it to XLA too);
* the front sweep: frontalface_alt on ``photo_scene((1080, 1920))``, min
  size 40x40, ``cap=16384``, ``front_stages`` 1 to 12: prep and front
  per depth, with the survivors and the ms per node and element of each
  step;
* at ``front_stages=12``: prep only, front + compaction, the full
  pipeline.

Times are CUDA events around back-to-back calls, repeated three times
until the three agree within 5% (the median is printed with their
spread); a chain's call is one of ``GRAPH_CALLS`` in a replayed CUDA
graph, so that its time is the card's alone.  It runs on the card unless
given ``device="cpu"``, where the kernels' plain versions run and the
times are host times of the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import re
import statistics
import subprocess
import sys
import threading
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import kernels
from ..detect.pyramid import PyramidDetector, default_device
from ..models import load_cascade
from ..ops.chain import (BODIES, FLOAT_OPS, GH, GW, IN_W, OPS_PER_TRIP,
                         chain, window_words)
from ..ops.compact_kernel import compact
from ..ops.haar_front import haar_front
from ..utils import photo_scene

__all__ = ["main", "Timer", "ClockSampler", "CHAINS", "CUMN", "TRIPS",
           "trip_loop_counts", "floors", "ptxas_spills"]

#: the four chains of mb_vpu3.py, its names
CHAINS = (("slices", "lane-slice+add"), ("arith", "mul+max+mul (3ops)"),
          ("cmpsel", "mul+cmp+sel+add (4ops)"),
          ("rect", "2slice+sub+mul+add (5op)"))
#: frontalface_alt's nodes in stages 0..11, summed (mb_vpu3.py:141)
CUMN = np.cumsum([3, 16, 21, 39, 33, 44, 50, 51, 56, 71, 80, 103])
FRONT_KS = (1, 2, 4, 6, 8, 10, 12)
TRIPS = (4, 16)
MATMUL = (2048, 768, 2048)


class Timer:
    """ms per call of ``fn``: the median of three windows of back-to-back
    calls, each window at least ``window_ms`` long; the window doubles
    until the three agree within 5% (at most ``tries`` times).  CUDA
    events on the card, the host clock on the CPU."""

    SPREAD = 0.05

    def __init__(self, device: torch.device, window_ms: float = 30.0,
                 tries: int = 4):
        self.cuda = device.type == "cuda"
        self.window_ms = window_ms
        self.tries = tries

    def _window(self, fn: Callable, reps: int) -> float:
        if not self.cuda:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            return (time.perf_counter() - t0) * 1e3 / reps
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / reps

    def __call__(self, fn: Callable) -> Tuple[float, float]:
        """(ms per call, spread of the three windows)."""
        fn()                                    # warm up
        if self.cuda:
            torch.cuda.synchronize()
        one = max(self._window(fn, 1), 1e-4)
        target = self.window_ms
        for _ in range(self.tries):
            reps = max(1, int(np.ceil(target / one)))
            ms = [self._window(fn, reps) for _ in range(3)]
            spread = (max(ms) - min(ms)) / min(ms)
            if spread <= self.SPREAD:
                break
            target *= 2
        return statistics.median(ms), spread


_FLOAT_OPS = ("FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSEL", "FSET")
# loads that may read device memory (LD: a generic address)
_GLOBAL_LOADS = ("LDG", "LDGSTS", "LD")
#: an SM of the H100 issues four warp instructions a clock (one a
#: scheduler) and serves 128 bytes of shared memory a clock
ISSUE_PER_CLOCK = 4
SHARED_BYTES_PER_CLOCK = 128
# "/*0530*/  @!P0 LDS R4, [R2+0xc] ;": address, opcode, operands; a
# branch names its target's address ("BRA 0x2f0")
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                   r"([A-Z][A-Z0-9_.]*)([^;]*);")
_TARGET = re.compile(r"\b0x([0-9a-f]+)\b")
# chain_kernel<body, cols>
_KERNEL = re.compile(r"chain_kernelILi(\d+)ELi(\d+)E")


def _functions(sass: str):
    """(name, lines) of every function in a ``cuobjdump -sass`` listing."""
    name, lines = None, []
    for line in sass.splitlines():
        if "Function : " in line:
            if name is not None:
                yield name, lines
            name, lines = line.split("Function : ")[1].strip(), []
        elif name is not None:
            lines.append(line)
    if name is not None:
        yield name, lines


def _base(opcode: str) -> str:
    return opcode.split(".")[0]


def _shared_words(opcode: str) -> int:
    """32-bit words that one lane's shared load reads: ``LDS`` 1,
    ``LDS.64`` 2, ``LDS.128`` 4; 0 for any other instruction."""
    if _base(opcode) != "LDS":
        return 0
    mods = opcode.split(".")[1:]
    return 4 if "128" in mods else 2 if "64" in mods else 1


def _trip_loop(lines) -> Optional[Dict[str, int]]:
    """Counts by opcode (modifiers kept) of the loop (a backward branch's
    span) that holds the most float instructions, the smallest such on a
    tie; None when no loop holds one."""
    insns = [(int(m.group(1), 16), m.group(2), m.group(3))
             for m in map(_INSN.search, lines) if m]
    best, best_n = None, 0
    for addr, op, args in insns:
        t = _TARGET.search(args) if _base(op) == "BRA" else None
        if t is None or int(t.group(1), 16) > addr:
            continue
        start = int(t.group(1), 16)
        counts: Dict[str, int] = {}
        for a, o, _ in insns:
            if start <= a <= addr:
                counts[o] = counts.get(o, 0) + 1
        n = sum(v for o, v in counts.items() if _base(o) in _FLOAT_OPS)
        if n > best_n or (n == best_n and best is not None
                          and sum(counts.values()) < sum(best.values())):
            best, best_n = counts, n
    return best


def trip_loop_counts(sass: str) -> Dict[str, dict]:
    """Per chain body, from the SASS of ``chain_kernel<body, cols>``
    (``csrc/mb_chain.cu``; ``cols`` read from its name): its trip loop's
    instructions for one trip.  A lane runs ``cols`` elements, so per
    element and trip: the shared words read (a load counted by its width),
    the float instructions, every opcode; per warp and trip: every
    instruction (``warp_insns``, the issue floor's count) and the loads
    that may read device memory."""
    out = {}
    for name, lines in _functions(sass):
        m = _KERNEL.search(name)
        if m is None:
            continue
        body, cols = BODIES[int(m.group(1))], int(m.group(2))
        counts = _trip_loop(lines) or {}
        insns = sum(counts.values())
        out[body] = dict(
            cols=cols,
            shared_words=sum(_shared_words(o) * n
                             for o, n in counts.items()) / cols,
            float_ops=sum(n for o, n in counts.items()
                          if _base(o) in _FLOAT_OPS) / cols,
            warp_insns=insns, insns_per_elem=insns / cols,
            global_loads=sum(n for o, n in counts.items()
                             if _base(o) in _GLOBAL_LOADS),
            opcodes={k: v / cols for k, v in sorted(counts.items())},
            jax_ops=OPS_PER_TRIP[body], jax_float_ops=FLOAT_OPS[body],
            window_words=window_words(body, cols))
    return out


def floors(counts: dict, nel: int, trips: int, sms: int,
           clock_mhz: float) -> dict:
    """The trip loops' floors in ms for ``nel`` elements and ``trips``
    trips, from one body's ``trip_loop_counts``: its warp instructions at
    ``ISSUE_PER_CLOCK`` an SM, and its shared bytes at
    ``SHARED_BYTES_PER_CLOCK`` an SM, on ``sms`` SMs at ``clock_mhz``."""
    hz = sms * clock_mhz * 1e6
    work = float(nel) * trips
    return dict(issue_ms=work * counts["insns_per_elem"] / 32
                / ISSUE_PER_CLOCK / hz * 1e3,
                shared_ms=work * counts["shared_words"] * 4
                / SHARED_BYTES_PER_CLOCK / hz * 1e3)


def ptxas_spills(log: str) -> Dict[str, dict]:
    """Per kernel that ``ptxas -v`` reported on (``kernels.build_log()``):
    its registers and the bytes it spills (stores, loads)."""
    out: Dict[str, dict] = {}
    cur = None
    for line in log.splitlines():
        m = re.search(r"(?:entry function '|Function properties for )"
                      r"([^' ]+)", line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return out


def smi_id(dev: torch.device) -> str:
    """The card ``dev`` as ``nvidia-smi -i`` names it: its PCI bus id
    (``nvidia-smi`` numbers the cards in PCI order and ignores
    ``CUDA_VISIBLE_DEVICES``, so a CUDA ordinal may name another card)."""
    p = torch.cuda.get_device_properties(dev)
    return f"{p.pci_domain_id:08X}:{p.pci_bus_id:02X}:{p.pci_device_id:02X}.0"


class ClockSampler:
    """The SM clock (``nvidia-smi``'s ``clocks.sm``, MHz) of the card that
    ``nvidia-smi -i`` calls ``card`` (``smi_id``), read over and over from
    a thread while the ``with`` block runs; no samples where
    ``nvidia-smi`` is missing."""

    QUERY = ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
             "--format=csv,noheader,nounits"]

    EVERY_S = 0.1

    def __init__(self, card: str):
        self.card = card
        self.cmd = self.QUERY + ["-i", card]
        self.samples: list = []
        self.top_mhz: Optional[float] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.is_set():
            try:
                out = subprocess.run(self.cmd, capture_output=True,
                                     text=True, timeout=10).stdout
                sm, top = (float(v) for v in out.strip().split(","))
            except (OSError, ValueError, subprocess.SubprocessError):
                return
            self.samples.append(sm)
            self.top_mhz = top
            self._stop.wait(self.EVERY_S)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()

    def summary(self) -> dict:
        s = sorted(self.samples)
        return dict(card=self.card,
                    median_mhz=statistics.median(s) if s else None,
                    min_mhz=s[0] if s else None,
                    max_mhz=s[-1] if s else None,
                    clocks_max_sm_mhz=self.top_mhz, samples=len(s))


def _say(log, name: str, text: str) -> None:
    log(f"{name:26s}: {text}")


#: chain calls in one CUDA graph when a chain is timed on the card: its
#: device time alone (an eager call's host time is about what a 4-trip
#: chain takes on the card)
GRAPH_CALLS = 10


def _chain_ms(timer: Timer, fn: Callable) -> Tuple[float, float]:
    """(ms per call of ``fn``, spread): on the card from the replays of a
    CUDA graph of ``GRAPH_CALLS`` calls, on the CPU from the calls."""
    if not timer.cuda:
        return timer(fn)
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_CALLS):
            fn()
    ms, spread = timer(graph.replay)
    return ms / GRAPH_CALLS, spread


def chain_rates(x: torch.Tensor, gw: int, timer: Timer,
                log=print) -> Dict[str, dict]:
    """The four chains: ms at each trip count, the T op/s of each by the
    JAX's op counts, and the slope: ms a trip, ps/elem/op and T op/s
    (mb_vpu3.py bench)."""
    nel = x.shape[0] * gw
    t0, t1 = TRIPS
    out = {}
    for body, label in CHAINS:
        ms, spread = {}, {}
        for tr in TRIPS:
            ms[tr], spread[tr] = _chain_ms(
                timer, lambda tr=tr: chain(x, body, tr, gw))
        slope = (ms[t1] - ms[t0]) / ((t1 - t0) * OPS_PER_TRIP[body])
        ps = slope * 1e9 / nel
        tops = nel / max(slope, 1e-9) * 1e3 / 1e12
        out[body] = dict(
            ms=ms, spread=spread, ps_per_elem_op=ps, tops=tops,
            trip_ms=(ms[t1] - ms[t0]) / (t1 - t0),
            tops_at={tr: nel * OPS_PER_TRIP[body] * tr / ms[tr] / 1e9
                     for tr in TRIPS},
            ops_per_trip=OPS_PER_TRIP[body])
        _say(log, label, f"{ms} -> {ps:6.4f} ps/elem/op  ({tops:.2f} Top/s)"
             f"  spread {max(spread.values()):.3f}")
    return out


def matmul_rate(dev: torch.device, shape: Tuple[int, int, int],
                timer: Timer, rng: np.random.Generator, log=print) -> dict:
    """16 bf16 products [m, k] x [k, n], each sliced to [k, k] and scaled
    (mb_vpu3.py:117-132; the loop never reads its carry, as there)."""
    m, k, n = shape
    a = torch.from_numpy((rng.random((m, k)) * 0.01).astype(np.float32)) \
        .to(dev, torch.bfloat16)
    b = torch.from_numpy((rng.random((k, n)) * 0.01).astype(np.float32)) \
        .to(dev, torch.bfloat16)

    def mmb():
        acc = a[0:k, 0:k]
        for _ in range(16):
            acc = (torch.matmul(a, b)[0:k, 0:k].float() * 1e-3) \
                .to(torch.bfloat16)
        return acc.float().sum()

    ms, spread = timer(mmb)
    one, one_spread = timer(lambda: torch.matmul(a, b))
    fl = 2 * m * k * n
    tflops, one_tflops = fl * 16 / ms / 1e9, fl / one / 1e9
    _say(log, "bf16 matmul", f"{ms:.4f} ms/16mm = {tflops:.1f} TFLOP/s"
         f"  spread {spread:.3f}; one product alone {one:.4f} ms = "
         f"{one_tflops:.1f} TFLOP/s  spread {one_spread:.3f}")
    return dict(ms=ms, spread=spread, tflops=tflops, shape=list(shape),
                one_ms=one, one_spread=one_spread, one_tflops=one_tflops)


def _front(det: PyramidDetector, frames: torch.Tensor, ii=None):
    ii = det._prep_planes(frames) if ii is None else ii
    return haar_front(ii.sum, ii.sq_hi, ii.sq_lo, det._visit, det.table,
                      det.front_k, tilted=ii.tilted)[0]


def front_sweep(dev: torch.device, shape: Tuple[int, int], nel: int,
                timer: Timer, cap: int = 16384,
                front_ks: Sequence[int] = FRONT_KS, log=print) -> dict:
    """frontalface_alt on ``photo_scene(shape)``: prep + front at each
    depth (mb_vpu3.py:135-155), and the front alone on planes made once,
    with the ms per node and element of each step from the front alone
    (prep at batch 1 is many small launches, bound by the host); then prep
    only, front + compaction and the full pipeline at the last depth
    (:157-170)."""
    spec = load_cascade("haarcascade_frontalface_alt")
    gray = photo_scene(shape)
    sweep = []
    prev_nodes, prev_ms = 0, 0.0
    det = frames = None
    for fk in front_ks:
        det = PyramidDetector(spec, shape, min_size=(40, 40),
                              front_stages=fk, cap=cap, device=dev)
        frames = det.put(gray)
        ii = det._prep_planes(frames)
        ms, spread = timer(lambda d=det: _front(d, frames)
                           .sum(dtype=torch.int32))
        fms, fspread = timer(lambda d=det: _front(d, frames, ii))
        surv = int(_front(det, frames, ii).sum())
        cum = int(CUMN[fk - 1])
        dms, dn = fms - prev_ms, cum - prev_nodes
        # ms -> ps is 1e9 (mb_vpu3.py:151 multiplies by 1e12: fs)
        extra = (f"  (front +{dms:7.4f} ms /{dn:4d} n = "
                 f"{dms / dn / nel * 1e9:7.4f} ps/elem/node)"
                 if prev_nodes else "")
        log(f"front fk={fk:2d} nodes={cum:4d}: {ms:7.4f} ms (spread "
            f"{spread:.3f}), front alone {fms:7.4f} ms (spread "
            f"{fspread:.3f}), survivors {surv:7d}{extra}")
        sweep.append(dict(front_k=fk, nodes=cum, ms=ms, spread=spread,
                          front_ms=fms, front_spread=fspread,
                          survivors=surv))
        prev_nodes, prev_ms = cum, fms
    prep, _ = timer(lambda: det._prep_planes(frames).sum[:, ::64, ::64]
                    .float().sum())
    log(f"prep only: {prep:.4f} ms")
    fc, _ = timer(lambda: compact(_front(det, frames).reshape(1, -1),
                                  det.cap)[0][:, :8])
    log(f"front+compact: {fc:.4f} ms")
    full, _ = timer(lambda: det._detect_device(frames, det.cap)
                    ["packed"][:, :40])
    log(f"full pipeline: {full:.4f} ms")
    return dict(sweep=sweep, prep_ms=prep, front_compact_ms=fc,
                full_ms=full, front_k=front_ks[-1], shape=list(shape),
                cap=cap)


def main(device=None, gh: int = GH, gw: int = GW,
         shape: Tuple[int, int] = (1080, 1920),
         matmul: Tuple[int, int, int] = MATMUL,
         front_ks: Sequence[int] = FRONT_KS,
         timer: Optional[Timer] = None, log=print) -> dict:
    """Run every section; returns what it printed as a dict.  ``device``
    is the card unless ``"cpu"`` is given (an error without a card)."""
    dev = torch.device(device) if device is not None else default_device()
    timer = timer if timer is not None else Timer(dev)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    log(f"device: {name} ({dev})")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random((gh, IN_W)).astype(np.float32)).to(dev)
    nel = gh * gw

    empty, spread = timer(lambda: chain(x, "empty", 1, gw))
    _say(log, "empty sweep (dispatch)", f"{empty:.4f} ms/call  spread "
         f"{spread:.3f}")
    res = dict(device=name, gh=gh, gw=gw, nel=nel, bodies=list(BODIES),
               empty_ms=empty, empty_spread=spread)
    clock = ClockSampler(smi_id(dev)) if dev.type == "cuda" else None
    with clock or contextlib.nullcontext():
        res["chains"] = chain_rates(x, gw, timer, log=log)
    if dev.type == "cuda":
        res["clock"] = clock.summary()
        mhz = res["clock"]["median_mhz"]
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        _say(log, "sm clock", f"{res['clock']} ({sms} SMs)")
        sass = kernels.sass()
        res["sass"] = trip_loop_counts(sass)
        for body in BODIES:
            c = res["sass"][body]
            _say(log, f"sass {body}", f"C = {c['cols']}: "
                 f"{c['shared_words']:g} shared words, "
                 f"{c['float_ops']:g} float instructions, "
                 f"{c['insns_per_elem']:g} instructions a trip and element "
                 f"(JAX ops {c['jax_ops']}, {c['global_loads']} global "
                 f"loads); {c['opcodes']}")
        res["floors"] = {
            b: {tr: floors(k, nel, tr, sms, mhz) for tr in TRIPS}
            for b, k in res["sass"].items() if b != "empty"} if mhz else None
        if mhz:
            for body, _ in CHAINS:
                f = res["floors"][body][TRIPS[-1]]
                _say(log, f"floors {body}", f"issue {f['issue_ms']:.4f} ms, "
                     f"shared {f['shared_ms']:.4f} ms at {TRIPS[-1]} trips "
                     f"and {mhz:g} MHz")
        res["ptxas"] = {k: v for k, v in
                        ptxas_spills(kernels.build_log()).items()
                        if _KERNEL.search(k)}
    res["matmul"] = matmul_rate(dev, matmul, timer, rng, log)
    res["front"] = front_sweep(dev, shape, nel, timer, front_ks=front_ks,
                               log=log)
    return res


def _args(argv):
    p = argparse.ArgumentParser(
        prog="python -m clfacedetection_torch.tools.mb_vpu3",
        description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu (the plain versions)")
    return p.parse_args(argv)


if __name__ == "__main__":
    main(_args(sys.argv[1:]).device)
