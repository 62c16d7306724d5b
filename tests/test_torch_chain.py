"""The port of the op-chain microbenchmark (``scripts/mb_vpu3.py``): the
plain chain (twin of ``csrc/mb_chain.cu``) against the JAX ``chain_call``
run in Pallas interpret mode, and the tool ``tools/mb_vpu3.py`` on the CPU.

Tolerances: BIT-EQUAL for every body at 4 trips and at 1 trip, except the
rect body at 1 trip.  There XLA:CPU contracts ``(a - b) * 0.01 + acc``
into one fma (the loop of one trip is straight-line code; at 4 trips the
trip-invariant product is hoisted out of the loop and stays separate):
JAX is then held bit-equal to the fma form and the port bit-equal to the
separately rounded form, which the TPU and the kernel (built with
``-fmad=false``) compute.  The JAX module is patched inside the tests
only (its grid shrunk to 64x512, ``pallas_call`` in interpret mode).
"""

import importlib.util
import os
import re
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from clfacedetection_torch import trace
from clfacedetection_torch.ops import chain as tchain
from clfacedetection_torch.tools import mb_vpu3 as tool

# The suite runs in several worker processes at once; one torch thread
# each keeps them from oversubscribing the cores.
torch.set_num_threads(1)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GH, GW = 64, 512


def _load_jax_script():
    """scripts/mb_vpu3.py as a module (it sets an environment default on
    import: kept out of the test process)."""
    path = os.path.join(_ROOT, "scripts", "mb_vpu3.py")
    spec = importlib.util.spec_from_file_location("_mb_vpu3_jax", path)
    mod = importlib.util.module_from_spec(spec)
    with mock.patch.dict(os.environ):
        spec.loader.exec_module(mod)
    return mod


MB = _load_jax_script()
BW = MB.BW


# The JAX's trip bodies, copied from the closures of mb_vpu3.main()
def _empty(x_ref, acc, t):
    return acc


def _slices_trip(x_ref, acc, t):
    for i in range(32):
        c = (i * 7 + 3) % 100
        acc = acc + x_ref[:, c:c + BW]
    return acc * np.float32(0.5)


def _arith_trip(x_ref, acc, t):
    x0 = x_ref[:, 7:7 + BW]
    for i in range(16):
        acc = jnp.maximum(acc * np.float32(0.9999),
                          x0 * (t.astype(jnp.float32) + np.float32(i)))
    return acc


def _cmpsel_trip(x_ref, acc, t):
    x0 = x_ref[:, 3:3 + BW]
    for i in range(16):
        c = acc < x0 * np.float32(0.5 + i * 0.01)
        acc = acc + jnp.where(c, np.float32(0.25), np.float32(-0.25))
    return acc


def _rect_trip(x_ref, acc, t):
    for i in range(16):
        c = (i * 7 + 3) % 50
        d = (i * 11 + 17) % 50
        acc = acc + (x_ref[:, c:c + BW]
                     - x_ref[:, d:d + BW]) * np.float32(0.01)
    return acc


JAX_BODIES = {"empty": _empty, "slices": _slices_trip, "arith": _arith_trip,
              "cmpsel": _cmpsel_trip, "rect": _rect_trip}


def _interp(*a, **k):
    k["interpret"] = True
    return _ORIG(*a, **k)


_ORIG = pl.pallas_call


def _jax_chain(body, trips, x):
    with mock.patch.object(MB, "GH", GH), mock.patch.object(MB, "GW", GW), \
            mock.patch.object(MB.pl, "pallas_call", _interp):
        return np.asarray(MB.chain_call(JAX_BODIES[body], trips)(
            jnp.asarray(x)))


def _rect_numpy(x, trips, fused):
    """The rect chain in numpy: every operation rounded to float32, or
    the multiply-add fused (emulated in float64: the product is exact)."""
    acc = x[:, 0:BW]
    k = np.float32(0.01)
    for _ in range(trips):
        for i in range(16):
            c, d = (i * 7 + 3) % 50, (i * 11 + 17) % 50
            diff = x[:, c:c + BW] - x[:, d:d + BW]
            if fused:
                acc = (diff.astype(np.float64) * np.float64(k)
                       + acc).astype(np.float32)
            else:
                acc = acc + diff * k
    return np.tile(acc, (1, GW // BW))


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("trips", [1, 4])
@pytest.mark.parametrize("body", tchain.BODIES)
def test_chain_plain_bit_equal_to_jax(body, trips):
    x = np.random.default_rng(7 + trips).random(
        (GH, tchain.IN_W)).astype(np.float32)
    got = tchain.chain_plain(torch.from_numpy(x), body, trips, GW).numpy()
    want = _jax_chain(body, trips, x)
    assert got.shape == want.shape == (GH, GW)
    if body == "rect" and trips == 1:
        # XLA:CPU's fma (see the module docstring)
        np.testing.assert_array_equal(_bits(want),
                                      _bits(_rect_numpy(x, 1, fused=True)))
        np.testing.assert_array_equal(_bits(got),
                                      _bits(_rect_numpy(x, 1, fused=False)))
    else:
        np.testing.assert_array_equal(_bits(got), _bits(want))
    if body == "rect":
        np.testing.assert_array_equal(_bits(got),
                                      _bits(_rect_numpy(x, trips, False)))
    # every 256-column block holds the same chain
    np.testing.assert_array_equal(got[:, :BW], got[:, BW:])


def test_chain_on_cpu_runs_the_plain_version():
    x = torch.from_numpy(np.random.default_rng(1).random(
        (32, tchain.IN_W)).astype(np.float32))
    before = trace.counters().get("launches.chain", 0)
    got = tchain.chain(x, "rect", 3, 256)
    assert trace.counters().get("launches.chain", 0) == before
    assert torch.equal(got, tchain.chain_plain(x, "rect", 3, 256))
    assert torch.equal(tchain.chain(x, "slices", 0, 512),
                       x[:, :BW].repeat(1, 2))


@pytest.mark.parametrize("shape,body,gw", [
    ((32, 383), "rect", 256),        # row width
    ((31, 384), "rect", 256),        # rows not a multiple of 32
    ((32, 384), "rect", 300),        # gw not a multiple of 256
    ((32, 384), "fma", 256),         # no such body
])
def test_chain_rejects_bad_input(shape, body, gw):
    with pytest.raises(ValueError):
        tchain.chain(torch.zeros(shape), body, 1, gw)


def test_chain_rejects_float64():
    with pytest.raises(ValueError):
        tchain.chain(torch.zeros((32, 384), dtype=torch.float64), "rect", 1)


def test_kernel_constants_are_numpy_float32():
    """The thresholds and factors that csrc/mb_chain.cu spells as hex
    literals are the float32 values that numpy and the plain chain use."""
    src = open(os.path.join(_ROOT, "clfacedetection_torch", "csrc",
                            "mb_chain.cu")).read()
    table = re.search(r"kThreshold\[16\] = \{([^}]*)\}", src).group(1)
    lits = [float.fromhex(v.strip().rstrip("f"))
            for v in table.split(",") if v.strip()]
    assert lits == [float(np.float32(0.5 + i * 0.01)) for i in range(16)]
    assert "0x1.fff2e4p-1f" in src
    assert float.fromhex("0x1.fff2e4p-1") == float(np.float32(0.9999))
    assert float(np.float32(0.01)) == float.fromhex("0x1.47ae14p-7")


def test_tool_runs_every_section_on_cpu():
    lines = []
    before = trace.counters().get("launches.chain", 0)
    res = tool.main(device="cpu", gh=32, gw=256, shape=(60, 80),
                    matmul=(32, 16, 32), front_ks=(1, 2),
                    timer=tool.Timer(torch.device("cpu"), 0.0, tries=1),
                    log=lines.append)
    assert trace.counters().get("launches.chain", 0) == before
    text = "\n".join(lines)
    for what in ["device: cpu", "empty sweep", "lane-slice+add",
                 "mul+max+mul", "mul+cmp+sel+add", "2slice+sub+mul+add",
                 "bf16 matmul", "front fk= 1", "front fk= 2", "prep only",
                 "front+compact", "full pipeline"]:
        assert what in text, what
    assert set(res["chains"]) == {"slices", "arith", "cmpsel", "rect"}
    assert "one product alone" in text and "front alone" in text
    assert [r["front_k"] for r in res["front"]["sweep"]] == [1, 2]
    assert all(r["survivors"] > 0 and r["front_ms"] > 0
               for r in res["front"]["sweep"])


def test_tool_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main()


def _sass(cols, rect_loads=("LDS R4, [R2+0xc]", "LDS R5, [R2+0x44]")):
    """A canned ``cuobjdump -sass`` listing: rect's and empty's kernels at
    ``cols`` columns a thread, and a kernel of another name; rect's trip
    loop (0x10-0x80) inside its tile loop (0x10-0xa0)."""
    loads = "".join(f"        /*00{1 + i:x}0*/                   {ld} ;\n"
                    for i, ld in enumerate(rect_loads))
    n = len(rect_loads)
    at = [f"{(1 + n + i) * 16:04x}" for i in range(9)]
    return f"""
\t\tFunction : _ZN12_GLOBAL__N_112chain_kernelILi4ELi{cols}EEEvPKfPfiiii
        /*0000*/                   LDC R1, c[0x0][0x28] ;
{loads}        /*{at[0]}*/                   FADD R6, R4, -R5 ;
        /*{at[1]}*/                   FMUL R6, R6, 0.0099999997764825820923 ;
        /*{at[2]}*/                   FADD R7, R7, R6 ;
        /*{at[3]}*/                   IADD3 R0, R0, 0x1, RZ ;
        /*{at[4]}*/                   ISETP.GE.AND P0, PT, R0, R3, PT ;
        /*{at[5]}*/               @!P0 BRA 0x10 ;
        /*{at[6]}*/                   STG.E [R8.64], R7 ;
        /*{at[7]}*/                   BRA 0x10 ;
        /*{at[8]}*/                   EXIT ;
\t\tFunction : _ZN12_GLOBAL__N_112chain_kernelILi0ELi{cols}EEEvPKfPfiiii
        /*0000*/                   LDS R4, [R2] ;
        /*0010*/                   STG.E [R8.64], R4 ;
        /*0020*/                   EXIT ;
\t\tFunction : clfd_other_kernel
        /*0000*/                   FADD R4, R4, R4 ;
        /*0010*/                   BRA 0x0 ;
"""


def test_trip_loop_counts_reads_the_innermost_float_loop():
    """The SASS counter takes, per chain body, the loop that holds the most
    float instructions (the trip loop, not the tile loop around it), and
    counts it per element of a lane's ``cols``."""
    got = tool.trip_loop_counts(_sass(1))
    assert set(got) == {"rect", "empty"}
    assert got["rect"]["cols"] == got["empty"]["cols"] == 1
    assert got["rect"]["shared_words"] == 2
    assert got["rect"]["float_ops"] == 3
    assert got["rect"]["opcodes"]["FADD"] == 2
    assert got["rect"]["jax_ops"] == 80 and got["rect"]["jax_float_ops"] == 48
    assert got["rect"]["warp_insns"] == 8 and got["rect"]["global_loads"] == 0
    assert got["empty"]["float_ops"] == 0 and got["empty"]["opcodes"] == {}
    halved = tool.trip_loop_counts(_sass(2))["rect"]
    assert halved["cols"] == 2
    assert halved["shared_words"] == 1 and halved["float_ops"] == 1.5
    assert halved["insns_per_elem"] == 4 and halved["warp_insns"] == 8


@pytest.mark.parametrize("loads,words,insns,global_loads", [
    (("LDS R4, [R2+0xc]",), 1, 7, 0),
    (("LDS.64 R4, [R2+0x10]",), 2, 7, 0),
    (("LDS.128 R4, [R2+0x10]",), 4, 7, 0),
    (("LDS.128 R4, [R2]", "LDS.128 R8, [R2+0x10]", "LDS.U8 R12, [R2+0x3]"),
     9, 9, 0),
    (("LDS.128 R4, [R2]", "LDG.E.128 R8, desc[UR4][R2.64]"), 4, 8, 1),
    (("LDS.128 R4, [R2]", "LD.E R8, [R2.64]"), 4, 8, 1),
])
def test_trip_loop_counts_shared_words_by_width(loads, words, insns,
                                                global_loads):
    """A shared load counts the words it reads (``LDS.128`` 4, ``.64`` 2,
    others 1); a load that may read device memory is counted apart."""
    got = tool.trip_loop_counts(_sass(16, loads))["rect"]
    assert got["shared_words"] == words / 16
    assert got["warp_insns"] == insns and got["insns_per_elem"] == insns / 16
    assert got["global_loads"] == global_loads
    assert got["window_words"] == tchain.window_words("rect", 16) == 68


@pytest.mark.parametrize("body,cols,words", [
    ("slices", 16, 116), ("rect", 16, 68), ("arith", 16, 20),
    ("cmpsel", 16, 20), ("empty", 16, 0), ("slices", 8, 108),
    ("slices", 32, 132), ("rect", 32, 84), ("arith", 8, 12),
])
def test_window_words(body, cols, words):
    """The 16-byte groups that cover a thread's reads in one trip: slices
    29 loads at 16 columns, rect 17, arith and cmpsel 5."""
    assert tchain.window_words(body, cols) == words


class _Reads:
    """Stands for x in a plain trip and records the first column of every
    slice that the trip reads."""

    def __init__(self, x):
        self.x, self.starts = x, set()

    def __getitem__(self, idx):
        self.starts.add(idx[1].start)
        return self.x[idx]


@pytest.mark.parametrize("body", tchain.BODIES)
def test_offsets_are_what_the_plain_trip_reads(body):
    """OFFSETS, which sizes the kernel's windows (``window_words``) and
    the SASS check, holds the columns that the specification's trip
    reads."""
    x = torch.zeros((2, tchain.IN_W))
    reads = _Reads(x)
    tchain._TRIPS[body][0](reads, x[:, :tchain.BW], 0)
    assert reads.starts == set(tchain.OFFSETS[body])


def test_floors():
    counts = dict(insns_per_elem=35.0, shared_words=7.25)
    f = tool.floors(counts, nel=2272 * 1280, trips=16, sms=132,
                    clock_mhz=1980.0)
    hz = 132 * 1980e6
    assert f["issue_ms"] == pytest.approx(
        2272 * 1280 * 16 * 35 / 32 / 4 / hz * 1e3)
    assert f["shared_ms"] == pytest.approx(
        2272 * 1280 * 16 * 7.25 * 4 / 128 / hz * 1e3)


PTXAS = """
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_112chain_kernelILi1ELi16EEEvPKfPfiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_112chain_kernelILi1ELi16EEEvPKfPfiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 152 registers, 5248 bytes smem, 384 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_112chain_kernelILi1ELi32EEEvPKfPfiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_112chain_kernelILi1ELi32EEEvPKfPfiiii
    24 bytes stack frame, 24 bytes spill stores, 28 bytes spill loads
ptxas info    : Used 255 registers, 7296 bytes smem, 384 bytes cmem[0]
"""


def test_ptxas_spills():
    got = tool.ptxas_spills(PTXAS)
    k16 = "_ZN12_GLOBAL__N_112chain_kernelILi1ELi16EEEvPKfPfiiii"
    k32 = "_ZN12_GLOBAL__N_112chain_kernelILi1ELi32EEEvPKfPfiiii"
    assert got[k16] == dict(spill_stores=0, spill_loads=0, registers=152)
    assert got[k32] == dict(spill_stores=24, spill_loads=28, registers=255)


def test_chain_ab_loads_another_checkout():
    """``tools/chain_ab.py`` imports another checkout's package under a
    name of its own, beside this one; its chain (here this checkout's own,
    on the CPU: the plain version) gives the same result."""
    from clfacedetection_torch.tools import chain_ab
    other = chain_ab.load_other(_ROOT)
    assert other.__name__ == "clfd_other.ops.chain"
    assert other.chain is not tchain.chain
    x = torch.from_numpy(np.random.default_rng(3).random(
        (32, tchain.IN_W)).astype(np.float32))
    assert torch.equal(other.chain(x, "rect", 2, 256),
                       tchain.chain(x, "rect", 2, 256))
