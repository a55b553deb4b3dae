"""The program's spans and sync counter (``repro_torch.cost_hook``): with no
span recorder a span site is the one shared null context and reads no
clock, records no event and leaves the sync debug mode alone; the index,
sampler and estimator give the same bits with the recorder on and off; one
``local_gumbel_max`` call records its stages nested under one top-level
span; the cost recorder never sees a span; a sync warning is charged to
the innermost open span under the program's file and line; under
``torch.profiler`` a session of the program's own records the calls and
ends with the profiler; and every CUDA kernel symbol in ``csrc/`` is
declared by exactly one kernel."""
from __future__ import annotations

import inspect
import re
import warnings
from pathlib import Path

import pytest
import torch

from repro_torch import cost_hook
from repro_torch.core import gumbel
from repro_torch.core.estimators import (amortized_candidates,
                                         local_gumbel_max, stratified_logz)
from repro_torch.core.gumbel import TopK
from repro_torch.core.mips.ivf import IVFConfig, IVFIndex
from repro_torch.kernels import ops
from repro_torch.launch.cost_model import CostMode

CSRC = Path(__file__).resolve().parent.parent / "src" / "repro_torch" / "csrc"
N, D, B, K, L = 3000, 16, 8, 64, 64


def _case():
    gen = torch.Generator().manual_seed(0)
    db = torch.randn(N, D, generator=gen)
    db /= torch.linalg.norm(db, dim=1, keepdim=True)
    index = IVFIndex.build(db, IVFConfig(n_clusters=24, n_probe=6,
                                         kmeans_iters=2))
    h = db[torch.randint(0, N, (B,), generator=gen)] / 0.05
    keys = torch.stack([torch.full((B,), 2 ** 33 + 7), torch.arange(B),
                        torch.zeros(B, dtype=torch.long)], 1)
    return db, index, h, keys


def _sample(db, index, h, keys):
    return tuple(local_gumbel_max(db, h, k=K, l=L, keys=keys, index=index))


def _topk(db, index, h, keys):
    return tuple(index.topk_batch(h, K))


def _estimator(db, index, h, keys):
    ids, log_w = amortized_candidates(index.topk_batch(h, K), N, L, keys=keys)
    return ids, log_w, stratified_logz(db, h, ids, log_w)


PATHS = {"local_gumbel_max": _sample, "topk_batch": _topk,
         "estimator": _estimator}


def test_no_recorder_span_is_the_shared_null_context(monkeypatch):
    """With no span recorder every span site returns one object, and a
    whole sample / probe / estimate reads no clock, records no CUDA event
    and never touches the sync debug mode."""
    assert cost_hook.span("a") is cost_hook.span("b")
    touched = []

    def spy(what):
        def f(*a, **kw):
            touched.append(what)
        return f

    monkeypatch.setattr(cost_hook.time, "perf_counter", spy("clock"))
    monkeypatch.setattr(torch.cuda, "Event", spy("event"))
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", spy("mode"))
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", spy("mode"))
    case = _case()
    for fn in PATHS.values():
        fn(*case)
    assert touched == []


@pytest.mark.parametrize("path", sorted(PATHS))
def test_outputs_bit_identical_with_recorder_on_and_off(path):
    case = _case()
    off = PATHS[path](*case)
    with cost_hook.SpanRecorder(cuda=False) as rec:
        on = PATHS[path](*case)
    assert rec.read(), "the recorder saw no span"
    assert len(on) == len(off)
    for a, b in zip(on, off):
        if a is None:
            assert b is None
            continue
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_local_gumbel_max_records_its_stages():
    case = _case()
    with cost_hook.SpanRecorder(cuda=False) as rec:
        _sample(*case)
    spans = rec.read()
    by_id = {s["id"]: s for s in spans}
    path = [(s["name"], by_id[s["parent"]]["name"] if s["parent"] is not None
             else None) for s in spans]
    assert path == [
        ("sampler", None),
        ("index.topk_batch", "sampler"),
        ("index.centroids", "index.topk_batch"),
        ("index.gather_score", "index.topk_batch"),
        ("index.overflow", "index.topk_batch"),
        ("index.pool", "index.topk_batch"),
        ("index.pool", "index.topk_batch"),
        ("index.select", "index.topk_batch"),
        ("sampler.draws", "sampler"),
        ("sampler.plan", "sampler"),
        ("sampler.tail_score", "sampler"),
        ("sampler.finish", "sampler"),
    ]
    assert {s["top"] for s in spans} == {spans[0]["id"]}
    for s in spans:  # children lie inside their parent, on the host clock
        assert s["t0"] <= s["t1"] and s["ms"] >= 0 and s["syncs"] is None
        if s["parent"] is not None:
            p = by_id[s["parent"]]
            assert p["t0"] <= s["t0"] and s["t1"] <= p["t1"]
    # a second call is a second top-level span
    with cost_hook.SpanRecorder(cuda=False) as rec:
        _sample(*case)
        _sample(*case)
    tops = [s for s in rec.read() if s["parent"] is None]
    assert [s["name"] for s in tops] == ["sampler", "sampler"]


def test_cost_recorder_ignores_spans():
    """Under the cost model the span sites stay null, and a span recorder
    active beside it takes none of its kernel charges."""
    t, m, n, d = 8, 32, 256, 64
    meta = dict(device="meta")
    emb, h = torch.empty(n, d, **meta), torch.empty(t, d, **meta)
    ids = torch.empty(t, m, dtype=torch.long, **meta)
    log_w = torch.empty(t, m, **meta)

    def traced(spans: bool):
        with CostMode() as mode:
            assert cost_hook.span("x") is cost_hook.span("y")
            if spans:
                with cost_hook.SpanRecorder(cuda=False) as rec:
                    stratified_logz(emb, h, ids, log_w)
                assert [s["name"] for s in rec.read()] == ["estimator.logz"]
            else:
                stratified_logz(emb, h, ids, log_w)
        c = mode.cost
        return c.flops, c.hbm_bytes, c.kernels

    plain = traced(False)
    assert plain[2]["fused_estimator"]["charges"] == 1
    assert traced(True) == plain


def _fake_cuda(monkeypatch) -> dict:
    """CUDA as a span recorder sees it, on the CPU: events that read 0.25
    ms, a no-op synchronize, and a sync debug mode kept in the dict
    returned (``now``, and every mode ``set``)."""
    mode = {"now": 0, "set": []}

    class Event:
        def __init__(self, enable_timing=False):
            pass

        def record(self):
            pass

        def elapsed_time(self, other):
            return 0.25

    def set_mode(m):
        mode["set"].append(m)
        mode["now"] = m

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode",
                        lambda: mode["now"])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", set_mode)
    return mode


def _syncing_log(*a, **kw):
    """``torch.log`` that first gives the sync debug mode's warning."""
    warnings.warn(cost_hook.SYNC_WARNING, UserWarning)
    return _LOG(*a, **kw)


_LOG = torch.log


def test_sync_warning_charged_to_innermost_span(monkeypatch):
    """A synthetic sync warning, raised where ``gumbel.cutoff`` calls
    ``torch.log``, is charged to the innermost open span under
    ``core/gumbel.py``'s line, every time; one outside every span is not
    counted; the debug mode, the filters and ``showwarning`` come back."""
    mode = _fake_cuda(monkeypatch)
    filters, show = list(warnings.filters), warnings.showwarning
    kv = torch.full((3,), 5, dtype=torch.long)
    with cost_hook.SpanRecorder(cuda=True) as rec:
        assert mode["now"] == "warn"
        monkeypatch.setattr(torch, "log", _syncing_log)
        gumbel.cutoff(100, kv, 10)  # outside every span: not counted
        with cost_hook.span("sampler"):
            with cost_hook.span("sampler.plan"):
                gumbel.cutoff(100, kv, 10)
                gumbel.cutoff(100, kv, 10)
            with pytest.warns(UserWarning, match="not a sync"):
                warnings.warn("not a sync", UserWarning)
        monkeypatch.setattr(torch, "log", _LOG)
    assert mode["set"] == ["warn", 0] and mode["now"] == 0
    assert warnings.filters == filters and warnings.showwarning is show
    lines, first = inspect.getsourcelines(gumbel.cutoff)
    line = first + next(i for i, s in enumerate(lines) if "torch.log(" in s)
    spans = {s["name"]: s for s in rec.read()}
    assert spans["sampler.plan"]["syncs"] == {
        f"repro_torch/core/gumbel.py:{line}": 2}
    assert spans["sampler"]["syncs"] == {}
    assert spans["sampler.plan"]["ms"] == 0.25


def test_profiler_session_records_while_the_profiler_runs():
    """With no recorder active, a call under ``torch.profiler`` is
    recorded by a session of the program's own, which :func:`profiled`
    reads; the first call after the profiler stops ends the session and
    records nothing; the outputs keep their bits."""
    from torch.profiler import ProfilerActivity, profile

    case = _case()
    off = _sample(*case)
    with profile(activities=[ProfilerActivity.CPU]):
        on = _sample(*case)
        assert len(cost_hook._SPANS) == 1
    names = [s["name"] for s in cost_hook.profiled()]
    assert names[:2] == ["sampler", "index.topk_batch"]
    assert names.count("sampler") == 1 and "sampler.draws" in names
    assert not cost_hook._SPANS  # read after the stop: ended
    _sample(*case)
    assert not cost_hook._SPANS and len(cost_hook.profiled()) == len(names)
    for a, b in zip(on, off):
        assert (a is None and b is None) or torch.equal(a, b)


def test_profiler_session_counts_syncs_and_ends_with_the_profiler(
        monkeypatch):
    """A session on the card turns the sync debug mode on at its first
    span and charges a sync there; the first top-level span after the
    profiler stops restores the mode, the filters and ``showwarning``,
    and is itself the shared null context."""
    mode = _fake_cuda(monkeypatch)
    filters, show = list(warnings.filters), warnings.showwarning
    kv = torch.full((3,), 5, dtype=torch.long)
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled",
                        True)
    with cost_hook.span("sampler"):
        assert mode["now"] == "warn"
        with cost_hook.span("sampler.plan"):
            monkeypatch.setattr(torch, "log", _syncing_log)
            gumbel.cutoff(100, kv, 10)
            monkeypatch.setattr(torch, "log", _LOG)
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled",
                        False)
    assert mode["now"] == "warn"  # ended by the next span, not before
    assert cost_hook.span("sampler") is cost_hook.span("index.topk_batch")
    assert mode["set"] == ["warn", 0] and not cost_hook._SPANS
    assert warnings.filters == filters and warnings.showwarning is show
    spans = {s["name"]: s for s in cost_hook.profiled()}
    assert sum(spans["sampler.plan"]["syncs"].values()) == 1
    assert spans["sampler"]["syncs"] == {} and spans["sampler"]["ms"] == 0.25


def test_every_kernel_symbol_declared_once():
    """``ops.kernel_symbols`` names every ``__global__`` kernel of
    ``csrc/`` exactly once, and nothing else; its kernels are those with a
    launch counter (the paged ``flash_decode`` launches the dense one's
    symbols)."""
    src = "\n".join(p.read_text() for p in CSRC.glob("*.cu"))
    defined = set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\s*"
                             r"\([^)]*\)\s*)?(\w+_kernel)\s*\(", src))
    defined |= set(re.findall(r"^SCREEN_TOPK_KERNEL\((\w+)\)", src, re.M))
    declared = [s for one, others in ops.kernel_symbols().values()
                for s in one + others]
    assert len(declared) == len(set(declared))
    assert set(declared) == defined
    assert set(ops.kernel_symbols()) | {"flash_decode_paged"} == set(
        ops.launch_counts())
