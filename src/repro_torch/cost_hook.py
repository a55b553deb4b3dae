"""The active cost recorder: how a hand-written kernel's launch or a
collective, whose work a dispatch mode cannot see as such, reports it to
the cost model (:class:`repro_torch.launch.cost_model.CostMode`).

:mod:`repro_torch.kernels.ops` wraps each kernel call in :func:`kernel`
and :mod:`repro_torch.collectives` each collective in :func:`collective`.
With no recorder active either is one list lookup. A recorder has
``kernel(name, cost)``, ``collective(kind, axis, nbytes)`` and a
``suspended`` count, which is nonzero while the wrapper's own tensor ops
run: a launch is charged its kernel's count and a collective its traffic,
never the ops around them.
"""
from __future__ import annotations

import contextlib

__all__ = ["active", "recording", "kernel", "collective"]

_ACTIVE: list = []


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
