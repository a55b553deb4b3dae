"""The program's own spans in the benchmark, at the tiny CPU shapes: with
the profiler on, a ``--trace 1`` run prints the per-layer metrics read
from the program's profiler session; a ``--trace 0`` run the same
end-to-end names as before; a program without the session or the symbol
map still runs traced, without them; the readers on hand-made spans.

On the CPU the harness starts no profiler, so these tests raise the
profiler's flag themselves (``torch.autograd.profiler``), which is what
the program reads to start its session; the sync count needs the card.
"""
from __future__ import annotations

import contextlib
import json

import pytest
import torch

from bench import harness, program
from bench._testing import ROOT, run_tiny
from bench.harness import applies

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
NEW = {"syncs_per_call", "pool_select_ms", "pool_assembly_ms", "draws_ms"}
# read on the CPU (host times of the program's spans)
ON_CPU = {"pool_select_ms", "pool_assembly_ms", "draws_ms"}


def metric(name):
    return harness.load_module(ROOT / "bench" / "metrics" / f"{name}.py",
                               f"test_metric_{name}")


@contextlib.contextmanager
def profiler_on():
    """The profiler's flag up, as while ``torch.profiler`` runs; on the
    way out the program's session is ended, as the program's next span
    would end it."""
    from repro_torch import cost_hook

    flag = torch.autograd.profiler
    flag._is_profiler_enabled = True
    try:
        yield
    finally:
        flag._is_profiler_enabled = False
        with cost_hook.span("after"):
            pass
    assert not cost_hook._SPANS


def run_profiled(capsys, cell, *extra):
    with profiler_on():
        return run_tiny(capsys, cell, "--trace", "1", *extra)


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_prints_the_new_metrics(capsys, cell):
    rc, res, err = run_profiled(capsys, cell)
    assert rc == 0, err
    assert res["correct"] is True
    want = {m["name"] for m in SPEC["per_layer"]
            if m["name"] in ON_CPU and applies(m, cell)}
    assert set(res["metrics"]) & NEW == want
    assert ("draws_ms" in want) == cell.endswith(".sample")
    assert err.count("bench: program spans ms a call {") == 1
    assert "bench: kernel " not in err  # the program's map is the list's


@pytest.mark.parametrize("cell", CELLS)
def test_untraced_run_prints_the_same_names(capsys, cell):
    rc, res, err = run_tiny(capsys, cell, "--trace", "0")
    assert rc == 0, err
    assert set(res["metrics"]) == {m["name"] for m in SPEC["end_to_end"]
                                   if applies(m, cell)}
    assert "program spans" not in err


@pytest.mark.parametrize("cell", ["imagenet.sample", "words.logz"])
def test_traced_run_without_the_program_session(capsys, monkeypatch, cell):
    """As on a program from before the session: the run succeeds, the new
    metrics are absent and every other one is there."""
    from repro_torch import cost_hook
    from repro_torch.kernels import ops

    rc, full, err = run_profiled(capsys, cell)
    assert rc == 0, err
    monkeypatch.delattr(cost_hook, "profiled")
    monkeypatch.delattr(ops, "kernel_symbols")
    rc, bare, err = run_profiled(capsys, cell)
    assert rc == 0, err
    assert bare["correct"] is True
    assert set(bare["metrics"]) == set(full["metrics"]) - NEW
    assert set(full["metrics"]) & NEW and not set(bare["metrics"]) & NEW
    assert "program spans" not in err


def test_symbol_drift_is_printed(capsys, monkeypatch):
    from repro_torch.kernels import ops

    real = ops.kernel_symbols()
    drifted = {**real, "fused_estimator": (("fused_estimator_combine_"
                                            "kernel",), ())}
    monkeypatch.setattr(ops, "kernel_symbols", lambda: drifted)
    rc, res, err = run_profiled(capsys, "imagenet.topk")
    assert rc == 0, err
    lines = [ln for ln in err.splitlines() if ln.startswith("bench: kernel ")]
    assert len(lines) == 1 and "fused_estimator:" in lines[0]


def span(i, name, t0, t1, parent=None, ms=1.0, syncs=None):
    return {"name": name, "id": i, "parent": parent, "top": 0, "t0": t0,
            "t1": t1, "ms": ms, "syncs": syncs}


def test_readers_keep_the_traced_calls_alone(monkeypatch):
    """Spans before, between and after the traced calls (warm-up, the
    checks after the window) are read by no metric; the record is built
    once a run and kept in it."""
    calls = [(1.0, 1.5, 2.0), (3.0, 3.5, 4.0)]
    spans = [span(0, "index.select", 0.1, 0.2, ms=9.0, syncs={"x:1": 5}),
             span(1, "index.select", 1.1, 1.2, ms=2.0, syncs={}),
             span(2, "index.select", 2.1, 2.2, ms=9.0, syncs={"x:1": 5}),
             span(3, "index.select", 3.1, 3.2, ms=4.0, syncs={"x:1": 1}),
             span(4, "index.select", 3.9, 4.1, ms=9.0, syncs={"x:1": 5})]
    read = []
    monkeypatch.setattr(program, "profiled", lambda: read.append(1) or spans)
    monkeypatch.setattr(program, "report", lambda rec: None)
    rec = {"calls": calls}
    assert metric("pool_select_ms").read(rec) == 3.0
    assert metric("syncs_per_call").read(rec) == 0.5
    assert metric("pool_assembly_ms").read(rec) is None
    assert len(read) == 1
    assert [s["id"] for s in rec["program"]["spans"]] == [1, 3]
    # nothing loaded: no metric
    monkeypatch.setattr(program, "profiled", lambda: [])
    rec = {"calls": calls}
    assert metric("pool_select_ms").read(rec) is None
    assert metric("syncs_per_call").read(rec) is None


def test_readers_on_hand_made_spans():
    calls = [(0.0, 0.5, 1.0), (2.0, 2.5, 3.0)]
    spans = [span(0, "index.topk_batch", 0.1, 0.6, ms=5.0, syncs={}),
             span(1, "index.pool", 0.2, 0.3, 0, ms=1.0, syncs={}),
             span(2, "index.pool", 0.3, 0.4, 0, ms=0.5,
                  syncs={"repro_torch/a.py:3": 2}),
             span(3, "index.topk_batch", 2.1, 2.6, ms=7.0,
                  syncs={"repro_torch/b.py:9": 1}),
             span(4, "index.pool", 2.2, 2.3, 3, ms=2.5,
                  syncs={"repro_torch/a.py:3": 1})]
    rec = {"calls": calls, "program": program.record(spans, calls)}
    assert [len(c) for c in rec["program"]["calls"]] == [3, 2]
    assert rec["program"]["sync_sites"] == [
        {"site": "repro_torch/a.py:3", "span": "index.pool", "count": 3},
        {"site": "repro_torch/b.py:9", "span": "index.topk_batch",
         "count": 1}]
    assert metric("syncs_per_call").read(rec) == 2.0
    assert metric("pool_assembly_ms").read(rec) == 2.0
    assert metric("pool_select_ms").read(rec) is None
    assert program.top_ms(rec) == {"index.topk_batch": 6.0}
    # nothing counted (the CPU): no sync metric, the times stay
    for s in spans:
        s["syncs"] = None
    rec["program"] = program.record(spans, calls)
    assert metric("syncs_per_call").read(rec) is None
    assert metric("pool_assembly_ms").read(rec) == 2.0
