"""The benchmark of the PyTorch and CUDA port (``repro_torch``) on the
paper's log-linear setting: one run of one cell.

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``:
the table's sizes, k, l, the index) and a traffic mix
(``traffic/<name>.json``: the entry the window drives, the batch, how many
calls are traced). The entry is ``entries/<entry>.py``, the
limits of the numbers compared are ``limits/<cell>.json`` and each per-layer
metric is read by ``metrics/<metric>.py``: a new cell, mix or metric is new
files and new entries in ``BENCHMARK.json``.

A run: set-up (the table on the device from the seed, the port's IVF
index, warm-up calls of the cell's own shape) is ``setup_s``; then a closed
loop of one caller for ``--seconds``: each call hands the port a batch of
fresh queries and waits for its results on the host. Once the window has
closed, the memory peak is read, the program's state is freed and the
reference (``reference/``) judges the checked calls, spread through the
window by a stride drawn from the seed. The result is one JSON line.
"""
from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import math
import statistics
import sys
import time
from contextlib import contextmanager, nullcontext
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
WARMUP_CALLS = 3  # calls of the cell's own shape before the window
CHECKED_QUERIES = 8192  # queries the reference judges, in calls spread
# over the window
TRACE_FIRST_CALL = 1  # the traced block starts at the window's 2nd call
# --tiny: the CPU test's shapes (the port's plain kernel versions run)
# (8 centres of ~375 rows: a query's top k = 192 lie in its own centre's
# clusters, as at the configurations' sizes)
TINY = {"n": 3000, "d": 32, "n_clusters": 54, "centers": 8, "batch": 16}


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0,
                   help="1: the reference in TF32 takes the program's "
                        "place (the comparison's control; must read not "
                        "correct)")
    p.add_argument("--tiny", action="store_true",
                   help="tests only: tiny shapes on the CPU")
    return p.parse_args(argv)


def fail(msg: str, code: int = 2) -> int:
    print(f"bench: {msg}", file=sys.stderr, flush=True)
    return code


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def applies(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load_cell(name: str) -> dict:
    """The cell's entries of ``BENCHMARK.json`` and its files, by name."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next((w for w in spec["workloads"] if w["name"] == name), None)
    if cell is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in spec["configs"] if c["name"] == cell["config"])
    return {
        "cell": cell,
        "cfg": json.loads((ROOT / conf["file"]).read_text()),
        "traffic": json.loads(
            (BENCH / "traffic" / f"{cell['traffic']}.json").read_text()),
        "limits": json.loads(
            (BENCH / "limits" / f"{name}.json").read_text())["limits"],
        "end_to_end": [m for m in spec["end_to_end"]
                       if applies(m, name)],
        "per_layer": [m for m in spec["per_layer"] if applies(m, name)],
    }


def default_kl(n: int, delta: float) -> int:
    """k = l with k·l >= n ln(1/δ) (Theorem 3.3 at c = 0), a multiple of
    64."""
    kl = math.sqrt(n * math.log(1.0 / delta))
    return max(64, int(math.ceil(kl / 64.0)) * 64)


def tiny(cfg: dict, traffic: dict) -> tuple[dict, dict]:
    cfg = {**cfg, "n": TINY["n"], "d": TINY["d"],
           "index": {**cfg["index"], "n_clusters": TINY["n_clusters"]},
           "table": {**cfg["table"], "centers": TINY["centers"]}}
    cfg["k"] = cfg["l"] = default_kl(cfg["n"], cfg["delta"])
    cfg["m_cap"] = int(cfg["l"] + 6 * math.sqrt(cfg["l"]) + 8)
    traffic = {**traffic, "batch": TINY["batch"]}
    return cfg, traffic


class Spans:
    """Host spans of the traced calls, and CUDA-event spans around the
    benchmark's calls into each layer (host clock on the CPU)."""

    def __init__(self, torch, cuda: bool):
        self.torch, self.cuda = torch, cuda
        self.host: list[tuple[str, float, float]] = []  # (label, us, us)
        self.pending: dict[str, list] = {}
        self.ms: dict[str, list[float]] = {}

    @contextmanager
    def layer(self, name: str):
        h0 = time.perf_counter()
        if self.cuda:
            e0 = self.torch.cuda.Event(enable_timing=True)
            e0.record()
        try:
            yield
        finally:
            h1 = time.perf_counter()
            self.host.append((f"issue:{name}", h0 * 1e6, h1 * 1e6))
            if self.cuda:
                e1 = self.torch.cuda.Event(enable_timing=True)
                e1.record()
                self.pending.setdefault(name, []).append((e0, e1))
            else:
                self.ms.setdefault(name, []).append(1e3 * (h1 - h0))

    def collect(self) -> dict[str, list[float]]:
        for name, evs in self.pending.items():
            self.ms.setdefault(name, []).extend(
                a.elapsed_time(b) for a, b in evs)
        self.pending = {}
        return self.ms


def no_span(name: str):
    return nullcontext()


class HostOut:
    """Takes a call's outputs to the host, as its caller does: into pinned
    buffers, then one synchronize (on the CPU they are there already)."""

    def __init__(self, torch, cuda: bool):
        self.torch, self.cuda = torch, cuda
        self.bufs: dict[str, object] = {}

    def __call__(self, out: dict) -> None:
        if not self.cuda:
            return
        torch = self.torch
        for k, v in out.items():
            buf = self.bufs.get(k)
            if buf is None or buf.shape != v.shape or buf.dtype != v.dtype:
                buf = self.bufs[k] = torch.empty(v.shape, dtype=v.dtype,
                                                 pin_memory=True)
            buf.copy_(v, non_blocking=True)
        torch.cuda.current_stream().synchronize()


def quantile(xs: list[float], q: int) -> float:
    """The q-th percentile (Python's exclusive method)."""
    if len(xs) < 2:
        return xs[0]
    return statistics.quantiles(xs, n=100)[q - 1]


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def run(args, t_start: float) -> int:
    try:
        spec = load_cell(args.workload)
    except (KeyError, FileNotFoundError, StopIteration) as e:
        return fail(f"cell {args.workload!r}: {e}")
    cell, cfg, traffic = spec["cell"], spec["cfg"], spec["traffic"]
    limits = spec["limits"]
    import torch

    if args.tiny:
        cfg, traffic = tiny(cfg, traffic)
        device, cuda = "cpu", False
    else:
        if not torch.cuda.is_available():
            return fail("torch.cuda.is_available() is false")
        if torch.cuda.device_count() < cell["chips"]:
            return fail(f"{cell['chips']} devices needed, "
                        f"{torch.cuda.device_count()} found")
        device, cuda = "cuda", True
        torch.cuda.reset_peak_memory_stats()
    from bench import data
    from bench.reference import judge as J
    from bench.reference import loglinear as ll
    from bench.reference import work as W

    entry = load_module(BENCH / "entries" / f"{traffic['entry']}.py",
                        f"bench_entry_{traffic['entry']}")
    n, b = cfg["n"], traffic["batch"]
    tcfg = cfg["table"]
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    phases = {"start": time.perf_counter() - t_start}
    db = data.table(args.seed, n, cfg["d"], tcfg["centers"], tcfg["noise"],
                    device)
    sync()
    phases["table"] = time.perf_counter() - t_start
    if args.control:
        from bench.control import Control as System
    else:
        from bench.port import Port as System
    sut = System(db, cfg)
    sync()
    phases["index"] = time.perf_counter() - t_start
    queries = data.Queries(args.seed, n, b, cfg["temperature"], device)
    host_out = HostOut(torch, cuda)

    def one_call(span):
        rows, q0 = queries.rows()
        theta, keys = queries.batch_of(db, rows, q0)
        t0 = time.perf_counter()
        out, keep = entry.call(sut, theta, keys, span)
        t_issue = time.perf_counter()
        host_out(out)
        t1 = time.perf_counter()
        return (t0, t_issue, t1), rows, q0, out, keep

    warm = []
    with torch.no_grad():
        for _ in range(WARMUP_CALLS):
            warm.append(one_call(no_span)[0])
    sync()
    setup_s = time.perf_counter() - t_start

    # calls to check: a stride that spreads CHECKED_QUERIES' calls over the
    # window at the warm-up's pace, from an offset drawn from the seed
    call_s = statistics.median(t1 - t0 for t0, _, t1 in warm)
    expect = max(1, int(args.seconds / max(call_s, 1e-6)))
    stride = max(1, expect // -(-CHECKED_QUERIES // b))
    offset = args.seed % stride
    trace_lo = TRACE_FIRST_CALL
    trace_hi = trace_lo + traffic["trace_calls"]
    spans = Spans(torch, cuda)
    tracer = None
    if args.trace and cuda:
        from bench.trace import Tracer
        tracer = Tracer(torch)
        sut.reset_launch_counts()
    times, checked, traced = [], [], []
    # the harness's own objects: collected once, then out of the cyclic
    # collector's way, so a full collection cannot pause a call
    gc.collect()
    gc.freeze()
    gc_before = sum(g["collections"] for g in gc.get_stats())
    t_w0 = time.perf_counter()
    with torch.no_grad():
        c = 0
        while (c == 0 or time.perf_counter() - t_w0 < args.seconds
               or (args.trace and c < trace_hi)):
            in_trace = bool(args.trace) and trace_lo <= c < trace_hi
            if tracer is not None and c == trace_lo:
                tracer.start()
            t, rows, q0, out, keep = one_call(
                spans.layer if in_trace else no_span)
            if tracer is not None and c == trace_hi - 1:
                tracer.stop()
            times.append(t)
            judge_it = c % stride == offset
            rec = None
            if judge_it or in_trace:  # the outputs the host received
                rec = (c, rows, q0, out, keep)
            if judge_it:
                checked.append(rec)
            if in_trace:
                traced.append(rec)
                prev = times[-2][2] if len(times) > 1 else t[0]
                spans.host += [("between_calls", prev * 1e6, t[0] * 1e6),
                               ("issue", t[0] * 1e6, t[1] * 1e6),
                               ("wait_results", t[1] * 1e6, t[2] * 1e6)]
            c += 1
        sync()
        t_w1 = time.perf_counter()
        if tracer is not None and trace_lo < c < trace_hi:
            tracer.stop()  # the window closed inside the traced block
    gc_window = sum(g["collections"] for g in gc.get_stats()) - gc_before
    gc.unfreeze()
    if not checked:  # a window far shorter than the warm-up foretold
        checked.append((c - 1, rows, q0, out, keep))
    launches = sut.launch_counts()
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    # ---- once the window has closed: S of each judged call, the index's
    # tables, then the program's state freed before the reference runs
    def with_s(recs):
        """(θ, keys, S ids, S values, outputs) of each call."""
        got = []
        with torch.no_grad():
            for _, rows, q0, outs, kept in recs:
                theta, keys = queries.batch_of(db, rows, q0)
                s_ids, s_vals = entry.top_k(sut, theta, outs, kept)
                got.append((theta, keys, s_ids.long(), s_vals.float(), outs))
        return got

    worked = with_s(traced)
    judged = with_s([r for r in checked if r[0] not in
                     {t[0] for t in traced}]) + worked
    tb = sut.tables()
    copy_faults = int((tb.member_vecs != ll.gather_rows(
        db, tb.member_ids)).any(-1).sum()) + int((tb.overflow_vecs != (
            ll.gather_rows(db, tb.overflow_ids))).any(-1).sum())
    tables_in = ll.Index(tb.centroids.float().clone(), tb.member_ids.clone(),
                         None, tb.overflow_ids.clone(), None, tb.spill_count)
    del tb, sut, checked, traced, keep, out, host_out
    if cuda:
        sync()
        torch.cuda.empty_cache()

    # ---- the reference judges
    t_ref = time.perf_counter()
    checks, tables = J.index(db, tables_in, cfg["index"], copy_faults)
    per_query: dict[str, list] = {}
    block = max(1, (1 << 30) // (8 * n))
    for theta, keys, s_ids, s_vals, outs in judged:
        for i in range(0, theta.shape[0], block):
            sl = slice(i, i + block)
            y = J.dense(db, theta[sl])
            nums = entry.judge(y, theta[sl], keys[sl], s_ids[sl],
                               s_vals[sl], {k: v[sl] for k, v in
                                            outs.items()},
                               tables, cfg, limits)
            for k, v in nums.items():
                per_query.setdefault(k, []).append(v.cpu())
            del y
    per_query = {k: torch.cat(v) for k, v in per_query.items()}
    n_judged = int(per_query["lost"].numel())
    # topk_miss: per judged call, the share of its queries' exact top-k
    # (float64 dense scores) that the index's top-k lost; it reads nothing
    # of the program's state, so it judges the index that set-up built
    sizes = [r[0].shape[0] for r in judged]
    miss = torch.tensor([float(r.mean()) for r in
                         per_query["lost"].split(sizes)])
    per_query["topk_miss"] = miss.repeat_interleave(torch.tensor(sizes))
    bad = torch.zeros(n_judged, dtype=torch.bool)
    for name in limits:
        if name in per_query:
            checks[name] = float(per_query[name].max())
            bad |= per_query[name] > limits[name]
    failed = int(bad.sum()) + sum(
        1 for name in checks if name.startswith("index_")
        and checks[name] > limits[name])
    missing = [name for name in limits if name not in checks]
    correct = not missing and all(checks[k] <= limits[k] for k in limits)
    ref_s = time.perf_counter() - t_ref

    # ---- metrics
    attempted = len(times) * b
    window_s = t_w1 - t_w0
    durs = [1e3 * (t1 - t0) for t0, _, t1 in times]
    values = {"queries_per_s": attempted / window_s,
              "call_p95_ms": quantile(durs, 95),
              "setup_s": setup_s}
    if "logz_abs_err" in per_query:
        values["logz_abs_err"] = float(per_query["logz_abs_err"].median())
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name() if cuda else "cpu",
                   "count": cell["chips"] if cuda else 0,
                   "memory_peak_bytes": int(peak)}
    breakdown = None
    if args.trace:
        rec = trace_record(tracer, spans, times, trace_lo, trace_hi, entry,
                           worked, tables, cfg, W, device_info["kind"])
        metrics = {}
        for m in spec["per_layer"]:
            mod = load_module(BENCH / "metrics" / f"{m['name']}.py",
                              f"bench_metric_{m['name']}")
            v = mod.read(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if rec.get("trace"):
            device_info["busy_s"] = rec["trace"]["busy_s"]
            device_info["window_s"] = rec["trace"]["window_s"]
            breakdown = rec["trace"]["breakdown"]
            if rec["trace"]["unlisted"]:
                print("bench: device events named like a kernel but not "
                      f"in kernel_symbols.json: {rec['trace']['unlisted']}",
                      file=sys.stderr)
        for k, nl in launches.items():
            if nl and rec.get("trace") and not rec["trace"][
                    "kernel_events"].get(k):
                print(f"bench: {k} launched {nl} times, but no device event "
                      "matched its symbols", file=sys.stderr)
    else:
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in spec["end_to_end"] if m["name"] in values}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": checks[k], "limit": limits[k]}
                        for k in limits if k in checks}
    found = forbidden_modules()
    if found:
        return fail(f"modules of JAX or the JAX package are loaded: {found}",
                    3)
    phases["warm"] = setup_s
    gaps_ms = [1e3 * (nxt[0] - prev[2])
               for prev, nxt in zip(times, times[1:])]
    print(f"bench: window {window_s:.3f} s, call ms p50 "
          f"{quantile(durs, 50):.3f} p95 {quantile(durs, 95):.3f} max "
          f"{max(durs):.3f} mean {statistics.mean(durs):.3f}, between calls "
          f"ms mean {statistics.mean(gaps_ms or [0]):.3f} max "
          f"{max(gaps_ms or [0]):.3f}, gc collections {gc_window}",
          file=sys.stderr)
    print(f"bench: {len(times)} calls, {n_judged} queries judged "
          f"({len(judged)} calls), launches {json.dumps(launches)}, "
          f"set-up s at its phases' ends {json.dumps(phases)}, "
          f"reference {ref_s:.3f} s, top-k miss over all judged "
          f"{float(per_query['lost'].mean()):.6g}", file=sys.stderr)
    for k in limits:
        print(f"check {k} {checks.get(k, 'missing')} limit {limits[k]}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def trace_record(tracer, spans, times, lo, hi, entry, worked, tables, cfg,
                 W, kind) -> dict:
    """What the per-layer metrics read: the traced calls' host spans and
    layer times, the reduced device trace and the least work of those
    calls."""
    from bench import trace

    calls = times[lo:hi]
    rec = {"calls": calls, "layer_ms": spans.collect(), "trace": None,
           "work": {}, "parts": entry.PARTS, "peak": W.peaks(kind)}
    for theta, keys, s_ids, s_vals, _ in worked:
        entry.work(rec["work"], theta, keys, s_ids, s_vals, tables, cfg)
    if rec["peak"] is not None:
        for part, (nbytes, flops) in rec["work"].items():
            least, by = W.least_s(nbytes, flops, rec["peak"])
            print(f"bench: work {part}: {nbytes / len(calls):.6g} bytes, "
                  f"{flops / len(calls):.6g} flops a call, least "
                  f"{1e3 * least / len(calls):.6g} ms a call, bound by "
                  f"{by}", file=sys.stderr)
    if tracer is not None and calls:
        evs, offset = tracer.events()
        if evs:
            rec["trace"] = trace.reduce(
                evs, offset, spans.host, calls[0][0] * 1e6,
                calls[-1][2] * 1e6, trace.kernel_symbols())
    return rec


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    return run(parse(argv), t_start)
