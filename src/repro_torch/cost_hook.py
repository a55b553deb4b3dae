"""The active recorders: how a hand-written kernel's launch or a
collective, whose work a dispatch mode cannot see as such, reports it to
the cost model (:class:`repro_torch.launch.cost_model.CostMode`), and how
the program's stages report their spans (:class:`SpanRecorder`).

:mod:`repro_torch.kernels.ops` wraps each kernel call in :func:`kernel`
and :mod:`repro_torch.collectives` each collective in :func:`collective`.
With no recorder active either is one list lookup. A recorder has
``kernel(name, cost)``, ``collective(kind, axis, nbytes)`` and a
``suspended`` count, which is nonzero while the wrapper's own tensor ops
run: a launch is charged its kernel's count and a collective its traffic,
never the ops around them.

The index, the sampler and the estimator wrap each stage in
:func:`span`, named ``<layer>.<stage>`` (``index.select``,
``sampler.draws``). With no :class:`SpanRecorder` active and
``torch.profiler`` off it is one list lookup and one read of the
profiler's flag, and returns one shared null context: no clock is read, no
event recorded, nothing built. Span recorders stand on a stack of their
own, so a cost recorder never sees a span and a span recorder never takes
a kernel's or a collective's charge. While the profiler runs and no
recorder is active, the first span starts a recorder of its own, a
profiler session, which the first top-level span after the profiler stops
ends; :func:`profiled` reads the latest session, so a profiled run
carries the program's stages and its syncs without asking for them.
"""
from __future__ import annotations

import contextlib
import os
import sys
import time
import warnings

import torch
from torch.autograd import profiler as _profiler

__all__ = ["active", "recording", "kernel", "collective", "span",
           "profiled", "SpanRecorder", "SYNC_WARNING"]

_ACTIVE: list = []
_SPANS: list = []  # active span recorders, the innermost last
_NULL_SPAN = contextlib.nullcontext()
_SESSION: list = []  # the latest profiler session's recorder, if any
# the warning PyTorch's sync debug mode gives at each host-device sync
SYNC_WARNING = "called a synchronizing CUDA operation"
_PKG = os.path.dirname(os.path.abspath(__file__))  # .../repro_torch
_THIS = os.path.abspath(__file__)


def active():
    """The innermost recorder of :func:`recording`, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


@contextlib.contextmanager
def recording(rec):
    """Make ``rec`` the active recorder."""
    _ACTIVE.append(rec)
    try:
        yield rec
    finally:
        _ACTIVE.remove(rec)


@contextlib.contextmanager
def _suspended(rec):
    rec.suspended += 1
    try:
        yield
    finally:
        rec.suspended -= 1


@contextlib.contextmanager
def kernel(name: str, cost_fn, *args, **kw):
    """Around one kernel call: charge ``cost_fn(*args, **kw)`` (computed
    only when a recorder is active) as one call of kernel ``name``."""
    rec = active()
    if rec is None:
        yield
        return
    rec.kernel(name, cost_fn(*args, **kw))
    with _suspended(rec):
        yield


@contextlib.contextmanager
def collective(kind: str, axis: str, nbytes: int):
    """Around one collective over ``axis``: report its operand bytes."""
    rec = active()
    if rec is None:
        yield
        return
    rec.collective(kind, axis, nbytes)
    with _suspended(rec):
        yield


def span(name: str):
    """Around one stage of the program: a span of the innermost active
    :class:`SpanRecorder`, else, while ``torch.profiler`` runs, of a new
    profiler session, else the shared null context."""
    if _SPANS:
        return _SPANS[-1].span(name)
    if _profiler._is_profiler_enabled:
        rec = SpanRecorder(session=True)
        _SESSION[:] = [rec]
        return rec.__enter__().span(name)
    return _NULL_SPAN


def profiled() -> list[dict]:
    """The spans of the latest profiler session, as
    :meth:`SpanRecorder.read` gives them (``[]`` if there was none); a
    session whose profiler has stopped is ended first."""
    if not _SESSION:
        return []
    rec = _SESSION[0]
    if rec in _SPANS and not rec._open and not _profiler._is_profiler_enabled:
        rec.__exit__(None, None, None)
    return rec.read()


def _sync_site() -> str:
    """``repro_torch/<file>:<line>`` of the innermost frame inside the
    package (this module's own frames skipped), or ``?``."""
    f = sys._getframe(1)
    while f is not None:
        path = os.path.abspath(f.f_code.co_filename)
        if path.startswith(_PKG + os.sep) and path != _THIS:
            rel = os.path.relpath(path, os.path.dirname(_PKG))
            return f"{rel.replace(os.sep, '/')}:{f.f_lineno}"
        f = f.f_back
    return "?"


class SpanRecorder:
    """Records the program's spans while active (``with SpanRecorder() as
    rec: ...``, then ``rec.read()``), in memory until read.

    Each span keeps its name, its host start and end
    (``time.perf_counter`` seconds), its parent and the top-level span it
    belongs to. With ``cuda`` (default: whether CUDA is available) a span
    also records a pair of timing events on the current stream at its
    open and close, and while the recorder is active PyTorch's sync
    reporting is on (``torch.cuda.set_sync_debug_mode("warn")``): every
    host-device synchronization is charged to the innermost open span,
    under the file and line of the innermost frame inside ``repro_torch``;
    one made outside every span is not counted. Leaving restores the debug
    mode and the warning filters. Without ``cuda`` a span's time is its
    host time and nothing is counted. A ``session`` recorder is the one
    :func:`span` starts while the profiler runs: its first top-level span
    after the profiler stops ends it."""

    def __init__(self, cuda: bool | None = None, session: bool = False):
        self.cuda = torch.cuda.is_available() if cuda is None else cuda
        self.session = session
        self._spans: list[dict] = []
        self._events: list = []  # (open, close) events of each span, or None
        self._open: list[int] = []  # indices of the open spans
        self._mode = None
        self._caught = None
        self._show = None

    def __enter__(self) -> "SpanRecorder":
        if self.cuda:
            self._caught = warnings.catch_warnings()
            self._caught.__enter__()
            # every sync, not once per line as the default filter shows
            warnings.filterwarnings("always", message=SYNC_WARNING)
            self._show = warnings.showwarning
            warnings.showwarning = self._on_warning
            self._mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
        _SPANS.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _SPANS.remove(self)
        if self.cuda:
            torch.cuda.set_sync_debug_mode(self._mode)
            self._caught.__exit__(*exc)
            self._caught = self._show = None

    def _on_warning(self, message, category, filename, lineno, file=None,
                    line=None):
        if SYNC_WARNING not in str(message):
            self._show(message, category, filename, lineno, file, line)
            return
        if self._open:
            syncs = self._spans[self._open[-1]]["syncs"]
            site = _sync_site()
            syncs[site] = syncs.get(site, 0) + 1

    def span(self, name: str):
        if (self.session and not self._open
                and not _profiler._is_profiler_enabled):
            self.__exit__(None, None, None)  # the profiler has stopped
            return span(name)
        return self._span(name)

    @contextlib.contextmanager
    def _span(self, name: str):
        i = len(self._spans)
        parent = self._open[-1] if self._open else None
        rec = {"name": name, "id": i, "parent": parent,
               "top": i if parent is None else self._spans[parent]["top"],
               "t0": time.perf_counter(), "t1": None, "ms": None,
               "syncs": {} if self.cuda else None}
        self._spans.append(rec)
        self._open.append(i)
        ev = None
        if self.cuda:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        self._events.append(ev)
        try:
            yield
        finally:
            if ev is not None:
                ev[1].record()
            rec["t1"] = time.perf_counter()
            self._open.pop()

    def read(self) -> list[dict]:
        """The closed spans, oldest first, as plain dicts: ``name``,
        ``id``, ``parent`` and ``top`` (ids), ``t0`` / ``t1`` (host
        seconds), ``ms`` (device ms between the span's events after a
        synchronize; host ms without ``cuda``) and ``syncs`` (``{file:line:
        count}``, None where nothing was counted)."""
        if self.cuda:
            torch.cuda.synchronize()
        out = []
        for rec, ev in zip(self._spans, self._events):
            if rec["t1"] is None:
                continue
            if rec["ms"] is None:
                rec["ms"] = (ev[0].elapsed_time(ev[1]) if ev is not None
                             else 1e3 * (rec["t1"] - rec["t0"]))
            out.append({**rec, "syncs": None if rec["syncs"] is None
                        else dict(rec["syncs"])})
        return out
