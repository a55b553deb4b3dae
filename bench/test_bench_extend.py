"""A later change adds a traffic mix, a cell and a per-layer metric by new
files and new entries of BENCHMARK.json alone: done here in a copy of the
benchmark, which then runs the new cell and reads the new metric, with no
file of the benchmark edited."""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys

from bench._testing import ROOT


def digests(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).digest()
            for p in sorted((root / "bench").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_mix_cell_and_metric_by_new_files(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(ROOT / "src", tmp_path / "src")
    before = digests(tmp_path)
    bench = tmp_path / "bench"
    (bench / "traffic" / "topk_small.json").write_text(json.dumps({
        "entry": "topk", "batch": 64, "trace_calls": 3,
        "describes": "one caller, closed loop, 64 uniform queries a call"}))
    limits = json.loads((bench / "limits" / "imagenet.topk.json").read_text())
    (bench / "limits" / "imagenet.topk_small.json").write_text(
        json.dumps(limits))
    (bench / "metrics" / "traced_calls.py").write_text(
        '"""traced_calls: how many calls the trace covered."""\n\n\n'
        'def read(rec):\n    return float(len(rec["calls"])) or None\n')
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "imagenet.topk_small",
                              "config": "imagenet", "traffic": "topk_small",
                              "chips": 1, "why": "small batches"})
    spec["per_layer"].append({"name": "traced_calls", "unit": "calls",
                              "better": "higher", "source": "host_clock",
                              "layer": "caller", "moves": "queries_per_s",
                              "workloads": ["imagenet.topk_small"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    p = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "imagenet.topk_small",
         "--seed", "11", "--seconds", "0.3", "--trace", "1", "--tiny"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    assert res["metrics"]["traced_calls"] == {"value": 3.0, "unit": "calls"}
    after = digests(tmp_path)
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == {
        "bench/traffic/topk_small.json",
        "bench/limits/imagenet.topk_small.json",
        "bench/metrics/traced_calls.py"}
