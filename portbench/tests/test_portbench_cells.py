"""Every cell of ``BENCHMARK.json`` parses into a runnable plan from its
files, found by name; the names keep to the contract's rules; the import
check compares whole top-level names; without a card a run exits with 2
and prints no result."""

import json
import os
import re
import subprocess
import sys

import pytest

from portbench.harness.cell import (CHECKOUT, ROOT, Cell, forbidden_modules,
                                    load, load_module)

with open(os.path.join(CHECKOUT, "BENCHMARK.json")) as _f:
    BENCH = json.load(_f)
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_plan(cell):
    import torch
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    spec = load("workloads", cell)
    for k in ("config", "traffic", "chips", "why"):
        assert spec[k] == entry[k], k
    conf = next(c for c in BENCH["configs"] if c["name"] == spec["config"])
    assert conf["file"] == f"portbench/configs/{spec['config']}.json"
    assert load("configs", spec["config"])["reduced"] == conf["reduced"]
    c = Cell(cell, torch.device("cpu"))
    assert all(os.path.exists(p) for p in c.paths)
    assert hasattr(c.generator, "setup") and hasattr(c.generator, "run")
    assert c.limits and set(c.limits) <= {"cand_gap", "box_gap"}
    assert 0 < len(c.judged(2 ** 31 + 5)) <= int(c.mix["pool"])
    reported = [m for kind in ("end_to_end", "per_layer")
                for m in BENCH[kind]
                if "workloads" not in m or cell in m["workloads"]]
    assert {m["name"] for m in reported} >= {"setup_s"}
    for m in reported:
        assert callable(load_module("metrics", m["name"]).read)


def test_names_and_keys():
    names = [c["name"] for c in BENCH["configs"]] + CELLS + \
        [m["name"] for k in ("end_to_end", "per_layer") for m in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert all(NAME.match(w["traffic"]) for w in BENCH["workloads"])
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert all(w in CELLS for w in m.get("workloads", CELLS))
    for g in os.listdir(os.path.join(ROOT, "layers")):
        spec = load("layers", g[:-5])
        assert spec["layer"] and spec["symbols"]


def test_import_check_whole_names():
    assert forbidden_modules({"jax", "jax.numpy", "numpy"}) == ["jax"]
    assert forbidden_modules({"clfacedetection_tpu.api"}) == \
        ["clfacedetection_tpu"]
    assert forbidden_modules({"clfacedetection_torch", "jaxtyping",
                              "clfacedetection_tpu_extra"}) == []
    assert forbidden_modules({"jaxlib.xla_client", "flax"}) == \
        ["flax", "jaxlib"]


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: this test is of a machine without one")
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1", "--trace",
                        "0"], cwd=CHECKOUT, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 2 and r.stdout.strip() == ""


def test_live_schedule_keeps_the_rate_and_draws_the_phases():
    import numpy as np
    live = load_module("traffic", "live")
    mix = dict(load("traffic", "photo-live"), rate=96)
    a = live.schedule(mix, 2 ** 31 + 11, seconds=25.0)
    b = live.schedule(mix, 2 ** 31 + 12, seconds=25.0)
    assert abs(len(a) - 96 * 25) <= 2 and abs(len(b) - 96 * 25) <= 2
    assert np.all(np.diff(a) >= 0) and 0 <= a[0] and a[-1] < 25.0
    assert not np.allclose(a[:100], b[:100])
    assert np.array_equal(a, live.schedule(mix, 2 ** 31 + 11, seconds=25.0))
    assert len(live.schedule(mix, 7, count=64)) == 64
