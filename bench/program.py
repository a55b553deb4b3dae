"""The program's own spans in a ``--trace 1`` run, reduced to what the
per-layer metrics read.

While the profiler traces the calls, the program records its spans itself
(a profiler session of ``repro_torch.cost_hook``), and
``cost_hook.profiled()`` gives them back as plain dicts. A program without
it, or a run that loaded no program (``--control 1``), gives no spans, and
every reader here then returns nothing. On the CPU the harness starts no
profiler, so there are none either.

A span: ``name`` (``<layer>.<stage>``), ``id``, ``parent``, ``top``, host
``t0`` / ``t1`` (``time.perf_counter`` seconds, the harness's clock),
``ms`` (device ms between CUDA events; host ms without CUDA) and ``syncs``
(``{"repro_torch/<file>:<line>": count}``, None where the program counted
none, as on the CPU).
"""
from __future__ import annotations

import json
import sys


def profiled() -> list[dict]:
    """The spans of the program's latest profiler session; ``[]`` where
    the program is not loaded or has no such session."""
    hook = sys.modules.get("repro_torch.cost_hook")
    read = getattr(hook, "profiled", None)
    return read() if read is not None else []


def record(spans: list[dict], calls) -> dict:
    """The spans that lie in the traced calls, each call's spans (those
    whose host interval lies in the call's [start, end]), and the sync
    sites, most first."""
    per_call = [[s for s in spans if t0 <= s["t0"] and s["t1"] <= t1]
                for t0, _, t1 in calls]
    spans = [s for c in per_call for s in c]
    sites: dict[tuple[str, str], int] = {}
    for s in spans:
        for site, n in (s["syncs"] or {}).items():
            sites[(site, s["name"])] = sites.get((site, s["name"]), 0) + n
    return {"spans": spans, "calls": per_call,
            "syncs_counted": any(s["syncs"] is not None for s in spans),
            "sync_sites": [{"site": site, "span": name, "count": n}
                           for (site, name), n in
                           sorted(sites.items(), key=lambda kv: -kv[1])]}


def of(rec: dict) -> dict:
    """The program's record of this traced run (``rec["program"]``),
    built at the first reader's call, which also prints the report."""
    if "program" not in rec:
        rec["program"] = record(profiled(), rec["calls"])
        if rec["program"]["spans"]:
            report(rec)
    return rec["program"]


def stage_ms(rec: dict, name: str) -> float | None:
    """ms a call of the spans named ``name``, summed within each traced
    call, the mean over the traced calls; None where no call has one."""
    calls = of(rec)["calls"]
    if not any(s["name"] == name for c in calls for s in c):
        return None
    return sum(s["ms"] for c in calls for s in c
               if s["name"] == name) / len(calls)


def top_ms(rec: dict) -> dict[str, float]:
    """ms a call of each top-level span name (mean over the traced calls),
    beside which the benchmark's own layer spans are printed."""
    calls = of(rec)["calls"]
    names = sorted({s["name"] for c in calls for s in c
                    if s["parent"] is None})
    return {n: sum(s["ms"] for c in calls for s in c
                   if s["name"] == n and s["parent"] is None) / len(calls)
            for n in names}


def declared_symbols() -> dict | None:
    """The program's map of its kernels' CUDA symbols (kernel -> (one a
    call, the others)), or None where it has none."""
    ops = sys.modules.get("repro_torch.kernels.ops")
    get = getattr(ops, "kernel_symbols", None)
    return get() if get is not None else None


def report(rec: dict) -> None:
    """On standard error: the program's top-level spans beside the
    benchmark's own layer spans (ms a call), each sync site with its count
    and span, and each kernel whose CUDA symbols as the program declares
    them differ from ``kernel_symbols.json``."""
    from bench import trace

    calls = rec["calls"]
    layer = {k: sum(v) / len(v) for k, v in rec["layer_ms"].items() if v}
    call_ms = 1e3 * sum(t1 - t0 for t0, _, t1 in calls) / len(calls)
    print(f"bench: program spans ms a call {json.dumps(top_ms(rec))}, the "
          f"benchmark's layer spans {json.dumps(layer)}, traced calls "
          f"{call_ms:.4f} ms", file=sys.stderr)
    for s in rec["program"]["sync_sites"]:
        print(f"bench: sync {s['site']} in {s['span']}: {s['count']} in "
              f"{len(calls)} traced calls", file=sys.stderr)
    declared = declared_symbols()
    if declared is None:
        return
    listed = trace.kernel_symbols()
    for k in sorted(set(declared) | set(listed)):
        mine = sorted(sym for group in declared.get(k, ()) for sym in group)
        if mine != sorted(listed.get(k, ())):
            print(f"bench: kernel {k}: the program declares symbols {mine}, "
                  f"kernel_symbols.json lists {sorted(listed.get(k, ()))}",
                  file=sys.stderr)
