"""Admission-queue schedulers for the continuous-batching engine
(counterpart of ``repro/serve/scheduler.py``, the same policies).

Two policies (``ServeConfig.sched``):

* ``fifo`` — arrival order, full ``decode_window`` every dispatch, and
  head-of-line blocking when the head request can't get blocks (strict
  fairness: nobody overtakes).
* ``slo`` — requests are ordered by ``(priority, deadline)`` where
  ``deadline = t_enq + ttft_slo_s`` (lower priority value = more urgent;
  the TTFT field is the feedback: a request's remaining slack IS its
  urgency). A block-starved head request is skipped so smaller requests
  behind it can use the pool (no head-of-line blocking), and the decode
  window is picked PER DISPATCH from the engine's window variants: when
  the most urgent queued request's slack is smaller than the estimated
  wall cost of a full window (``window × ITL EWMA``), the scheduler
  shrinks the window so the admission loop comes around sooner — trading
  a little dispatch-amortization for TTFT on the queued request.

Schedulers are pure host-side policy: they order rids and pick window
sizes; slot/block accounting stays in the Server. On a multi-rank mesh
the Server hands every rank's scheduler rank 0's clock reading and ITL
EWMA, so all ranks order and pick alike.
"""
from __future__ import annotations

__all__ = ["FifoScheduler", "SloScheduler", "make_scheduler"]


class FifoScheduler:
    """Arrival order; fixed window; head-of-line blocking on block stalls."""

    name = "fifo"
    skip_blocked = False  # a blocked head request blocks everyone behind it

    def order(self, waiting: list[int], reqs: dict, now: float) -> list[int]:
        return list(waiting)  # arrival order (insertion order)

    def pick_window(self, waiting: list[int], reqs: dict, now: float,
                    itl_ms: float, windows: list[int]) -> int:
        return windows[-1]  # always the full fused window


class SloScheduler:
    """(priority, TTFT-deadline) order; skip-ahead; adaptive window."""

    name = "slo"
    skip_blocked = True  # block-starved head never blocks smaller requests

    def __init__(self, ttft_slo_s: float = 0.5):
        self.ttft_slo_s = ttft_slo_s

    def _deadline(self, req: dict) -> tuple:
        return (req.get("priority", 0), req["t_enq"] + self.ttft_slo_s)

    def order(self, waiting: list[int], reqs: dict, now: float) -> list[int]:
        return sorted(waiting, key=lambda rid: self._deadline(reqs[rid]))

    def pick_window(self, waiting: list[int], reqs: dict, now: float,
                    itl_ms: float, windows: list[int]) -> int:
        """Largest compiled window whose estimated wall cost fits the most
        urgent queued request's remaining TTFT slack. No queue (or no ITL
        estimate yet) -> full window; slack already blown -> smallest
        window, to reach the next admission point fastest."""
        if not waiting or itl_ms <= 0.0:
            return windows[-1]
        slack = min(
            reqs[rid]["t_enq"] + self.ttft_slo_s - now for rid in waiting
        )
        if slack <= 0.0:
            return windows[0]
        for w in reversed(windows):  # largest first
            if w * itl_ms * 1e-3 <= slack:
                return w
        return windows[0]


def make_scheduler(name: str, ttft_slo_s: float = 0.5):
    if name == "fifo":
        return FifoScheduler()
    if name == "slo":
        return SloScheduler(ttft_slo_s=ttft_slo_s)
    raise ValueError(f"unknown scheduler {name!r} (fifo | slo)")
