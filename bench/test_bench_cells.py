"""Each cell of BENCHMARK.json at the tiny CPU shapes through the
benchmark's command, and the contract's rules on BENCHMARK.json itself."""
from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
import types

import pytest
import torch

from bench import harness
from bench._testing import ROOT, run_tiny
from bench.harness import applies

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_result_line(capsys, cell, trace):
    rc, res, err = run_tiny(capsys, cell, "--trace", str(trace))
    assert rc == 0, err
    keys = list(res)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0 and res["attempted"] % 16 == 0
    want = SPEC["per_layer"] if trace else SPEC["end_to_end"]
    want = {m["name"]: m["unit"] for m in want if applies(m, cell)}
    got = res["metrics"]
    if trace:  # the device's metrics need the card's trace
        assert set(got) <= set(want)
        assert {"host_issue_ms"} <= set(got)
    else:
        assert set(got) == set(want)
    for name, m in got.items():
        assert m["unit"] == want[name] and m["value"] > 0
    limits = json.loads((ROOT / "bench" / "limits" /
                         f"{cell}.json").read_text())["limits"]
    assert set(res["checks"]) == set(limits)
    for name, c in res["checks"].items():
        assert c["value"] <= c["limit"] == limits[name]
    tail = err.strip().splitlines()[-len(limits):]
    assert [ln.split()[1] for ln in tail] == list(limits)


def test_run_refuses_with_jax_loaded(capsys, monkeypatch):
    """A run whose process holds JAX or the JAX package prints no
    result."""
    monkeypatch.setitem(sys.modules, "flax", types.ModuleType("flax"))
    capsys.readouterr()
    rc = harness.main(["--workload", CELLS[0], "--seed", "1", "--seconds",
                       "0.1", "--tiny"])
    out, err = capsys.readouterr()
    assert rc != 0 and out == "" and "flax" in err


def test_command_refuses_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the command would run")
    p = subprocess.run([sys.executable, "bench/run.py", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1"],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""


def test_command_refuses_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files, no run gives a result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "bench/run.py", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1", "--tiny"],
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode != 0 and p.stdout == ""


def test_benchmark_json_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    names = ([c["name"] for c in SPEC["configs"]] + CELLS
             + [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]])
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    for c in SPEC["configs"]:
        assert (ROOT / c["file"]).is_file() and c["reduced"] == []
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    for w in SPEC["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (ROOT / "bench" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "bench" / "limits" / f"{w['name']}.json").is_file()
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert (ROOT / "bench" / "metrics" / f"{m['name']}.py").is_file()
        for cell in m["workloads"]:
            assert applies(e2e[m["moves"]], cell)
    for cell in CELLS:
        assert any(applies(m, cell) for m in SPEC["per_layer"])
        assert any(applies(m, cell) for m in SPEC["end_to_end"]
                   if m["name"] != "setup_s")
