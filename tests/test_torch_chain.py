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
    before = tchain.chain.launches
    got = tchain.chain(x, "rect", 3, 256)
    assert tchain.chain.launches == before
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
    before = tchain.chain.launches
    res = tool.main(device="cpu", gh=32, gw=256, shape=(60, 80),
                    matmul=(32, 16, 32), front_ks=(1, 2),
                    timer=tool.Timer(torch.device("cpu"), 0.0, tries=1),
                    log=lines.append)
    assert tchain.chain.launches == before
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


SASS = """
\t\tFunction : _ZN12_GLOBAL__N_112chain_kernelILi4EEEvPKfPfiixi
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   LDS R4, [R2+0xc] ;
        /*0020*/                   LDS R5, [R2+0x44] ;
        /*0030*/                   FADD R6, R4, -R5 ;
        /*0040*/                   FMUL R6, R6, 0.0099999997764825820923 ;
        /*0050*/                   FADD R7, R7, R6 ;
        /*0060*/                   IADD3 R0, R0, 0x1, RZ ;
        /*0070*/                   ISETP.GE.AND P0, PT, R0, R3, PT ;
        /*0080*/               @!P0 BRA 0x10 ;
        /*0090*/                   STG.E [R8.64], R7 ;
        /*00a0*/                   BRA 0x10 ;
        /*00b0*/                   EXIT ;
\t\tFunction : _ZN12_GLOBAL__N_112chain_kernelILi0EEEvPKfPfiixi
        /*0000*/                   LDS R4, [R2] ;
        /*0010*/                   STG.E [R8.64], R4 ;
        /*0020*/                   EXIT ;
\t\tFunction : clfd_other_kernel
        /*0000*/                   FADD R4, R4, R4 ;
        /*0010*/                   BRA 0x0 ;
"""


def test_trip_loop_counts_reads_the_innermost_float_loop():
    """The SASS counter takes, per chain body, the loop that holds the most
    float instructions (the trip loop, not the unit loop around it)."""
    got = tool.trip_loop_counts(SASS, rows=1)
    assert set(got) == {"rect", "empty"}
    assert got["rect"]["shared_loads"] == 2
    assert got["rect"]["float_ops"] == 3
    assert got["rect"]["opcodes"]["FADD"] == 2
    assert got["rect"]["jax_ops"] == 80
    assert got["empty"]["float_ops"] == 0 and got["empty"]["opcodes"] == {}
    halved = tool.trip_loop_counts(SASS, rows=2)["rect"]
    assert halved["shared_loads"] == 1 and halved["float_ops"] == 1.5
