"""The device trace of a ``--trace 1`` run: ``torch.profiler`` (CUPTI) over
a block of calls, reduced to the device's busy time, each kernel's device
time (overlaps counted once) and the idle gaps, each labelled by the
benchmark's host span that was open when it began.

The kernels are found by their CUDA symbols as the profiler names them,
listed in ``kernel_symbols.json`` beside this file.
"""
from __future__ import annotations

import json
import re
import time
from pathlib import Path

SYMBOLS = Path(__file__).resolve().parent / "kernel_symbols.json"
MARK_CYCLES = 2000  # the marker spin that ties host time to device time


def union_us(spans) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def gaps(spans, lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    out, at = [], lo
    for a, b in sorted(spans):
        if a > at:
            out.append((at, min(a, hi)))
        at = max(at, b)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(a, b) for a, b in out if b > a]


class Tracer:
    """Starts and stops the profiler around the traced calls, and ties
    host perf_counter time to the trace's timeline with a marker kernel
    launched right after a synchronize."""

    def __init__(self, torch):
        self.torch = torch
        self.prof = None
        self.mark_host_us = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        torch = self.torch
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize()
        self.mark_host_us = time.perf_counter() * 1e6
        torch.cuda._sleep(MARK_CYCLES)
        torch.cuda.synchronize()

    def stop(self) -> None:
        self.torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)

    def events(self) -> tuple[list[tuple[str, float, float]], float | None]:
        """(device events (name, start us, end us) on the trace's timeline,
        the offset that maps host perf_counter us onto it; None where the
        marker was not found)."""
        from torch.autograd import DeviceType

        evs = [(e.name, e.time_range.start, e.time_range.end)
               for e in self.prof.events()
               if e.device_type == DeviceType.CUDA]
        marks = [s for name, s, _ in evs if "spin_kernel" in name]
        offset = marks[0] - self.mark_host_us if marks else None
        return evs, offset


def kernel_symbols() -> dict[str, list[str]]:
    return json.loads(SYMBOLS.read_text())["kernels"]


def kernel_spans(evs, symbols: dict[str, list[str]]):
    """kernel -> its device intervals, and the device event names that
    carry a kernel's name but match none of its listed symbols."""
    pats = {k: [re.compile(rf"(^|[\s:]){re.escape(s)}[<(]") for s in syms]
            for k, syms in symbols.items()}
    spans = {k: [] for k in symbols}
    unlisted = set()
    for name, s, e in evs:
        hit = False
        for k, ps in pats.items():
            if any(p.search(name) for p in ps):
                spans[k].append((s, e))
                hit = True
        if not hit and any(k in name for k in symbols):
            unlisted.add(name[:120])
    return spans, sorted(unlisted)


def reduce(evs, offset, host_spans, lo_host_us: float, hi_host_us: float,
           symbols: dict[str, list[str]]) -> dict:
    """The traced window [lo, hi] (host us): busy seconds, window seconds,
    each kernel's device seconds, the top device operations and the idle
    gaps by the host span open at their start."""
    if offset is None:  # no marker: the trace's own first and last event
        lo, hi = min(s for _, s, _ in evs), max(e for _, _, e in evs)
        offset = lo - lo_host_us
    lo, hi = lo_host_us + offset, hi_host_us + offset
    inside = [(n, max(s, lo), min(e, hi)) for n, s, e in evs
              if e > lo and s < hi and "spin_kernel" not in n]
    busy = union_us([(s, e) for _, s, e in inside])
    by_op: dict[str, float] = {}
    for n, s, e in inside:
        by_op[n[:120]] = by_op.get(n[:120], 0.0) + (e - s) * 1e-6
    ks, unlisted = kernel_spans(inside, symbols)
    labelled: dict[str, float] = {}
    spans = sorted((a + offset, b + offset, name)
                   for name, a, b in host_spans)
    for a, b in gaps([(s, e) for _, s, e in inside], lo, hi):
        label = "untraced"
        for s0, s1, name in spans:  # innermost: the last that opens first
            if s0 <= a < s1:
                label = name
        labelled[label] = labelled.get(label, 0.0) + (b - a) * 1e-6
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(labelled.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy * 1e-6, "window_s": (hi - lo) * 1e-6,
            "kernel_s": {k: union_us(v) * 1e-6 for k, v in ks.items() if v},
            "kernel_events": {k: len(v) for k, v in ks.items()},
            "unlisted": unlisted,
            "breakdown": {"device_ops": [[n, s] for n, s in top],
                          "idle_gaps": [[n, s] for n, s in idle]}}
