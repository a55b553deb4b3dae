"""Asynchronous double-buffered MIPS-index refresh (counterpart of
``repro/train/refresh.py``, DESIGN.md §7).

The synchronous refresh stalls the train loop at a window boundary for the
whole rebuild. :class:`AsyncIndexRefresher` runs the rebuild on a side
thread, and on CUDA on a stream of its own: ``kick`` hands it a snapshot of
the embedding rows and returns at once; the trainer keeps stepping against
the STALE index and calls ``swap`` at the next window boundary, which joins
the thread, makes the current stream wait on the rebuild's event and
returns the fresh index — same shapes, so the swap is a pointer exchange.

The snapshot must be a copy the trainer never mutates: the port's AdamW
updates the live params IN PLACE, so the rows handed to ``kick`` are a
clone, and it, like every tensor that crosses between the two streams, is
``record_stream``-ed so the caching allocator does not hand its memory out
while the other stream may still read it.

Determinism: the swap point is a function of the window schedule alone —
always the first boundary after the kick; ``swap`` blocks on an unfinished
rebuild rather than deferring — so a run's numbers never depend on the
rebuild's wall time. A sharded index's refresh is shard-local (no
collective), so the side thread never races the train loop's collectives.
"""
from __future__ import annotations

import threading
from typing import Any

import torch

__all__ = ["AsyncIndexRefresher"]


def _tensors(obj: Any):
    """The tensors an index (or a state) holds, for stream bookkeeping."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for x in obj:
            yield from _tensors(x)
    elif isinstance(obj, dict):
        for x in obj.values():
            yield from _tensors(x)
    elif obj is not None and hasattr(obj, "__dict__"):
        for x in vars(obj).values():
            if isinstance(x, (torch.Tensor, tuple, list, dict)) or hasattr(
                    x, "state") or hasattr(x, "local"):
                yield from _tensors(x)


class AsyncIndexRefresher:
    """At most one rebuild in flight; ``kick`` / ``swap`` / ``abandon`` are
    called from the trainer's thread only."""

    def __init__(self):
        self._thread: threading.Thread | None = None
        self._result: Any = None
        self._error: BaseException | None = None
        self._event: Any = None  # CUDA event recorded after the rebuild
        self.kick_step: int | None = None
        self.snapshot: Any = None  # drift baseline paired with the rebuild

    @property
    def in_flight(self) -> bool:
        return self._thread is not None

    def kick(self, index: Any, db: torch.Tensor, snapshot: Any,
             step: int) -> None:
        """Start ``index.refresh(db)`` on the side thread. ``db`` must be a
        copy the trainer will not mutate; ``snapshot`` becomes the drift
        baseline once the rebuild is swapped in."""
        if self._thread is not None:
            raise RuntimeError("one rebuild in flight at a time")
        self.kick_step = step
        self.snapshot = snapshot
        side = None
        if db.is_cuda:
            main = torch.cuda.current_stream(db.device)
            side = torch.cuda.Stream(device=db.device)
            side.wait_stream(main)  # the copy that made db is queued there
            db.record_stream(side)
            self._event = torch.cuda.Event()

        def rebuild():
            try:
                if side is None:
                    self._result = index.refresh(db)
                    return
                with torch.cuda.device(db.device), torch.cuda.stream(side):
                    self._result = index.refresh(db)
                    self._event.record(side)
            except BaseException as e:  # re-raised at swap()
                self._error = e

        self._thread = threading.Thread(target=rebuild, name="index-refresh",
                                        daemon=True)
        self._thread.start()

    def swap(self) -> tuple[Any, Any, int]:
        """Join the rebuild (blocking only on its unfinished rest) and
        return ``(fresh index, snapshot, kick step)``; the current stream
        waits on the rebuild before any later use of the fresh index."""
        if self._thread is None:
            raise RuntimeError("no rebuild in flight")
        self._thread.join()
        if self._error is not None:
            err = self._error
            self._reset()
            raise err
        new = self._result
        if self._event is not None:
            main = torch.cuda.current_stream()
            main.wait_event(self._event)
            for t in _tensors(new):
                if t.is_cuda:
                    t.record_stream(main)
        out = (new, self.snapshot, self.kick_step)
        self._reset()
        return out

    def abandon(self) -> None:
        """Preemption path: drain the thread and drop its result (a resume
        rebuilds the index from the checkpoint)."""
        if self._thread is not None:
            self._thread.join()
            if self._event is not None:
                self._event.synchronize()
            self._reset()

    def _reset(self) -> None:
        self._thread = None
        self._result = None
        self._error = None
        self._event = None
        self.kick_step = None
        self.snapshot = None
