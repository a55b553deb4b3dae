"""Paged KV block pool: host-side allocator + page-table construction
(counterpart of ``repro/serve/paging.py``, the same behaviour line for
line).

The device side (models/attention.py, models/transformer.py) stores attn
KV in a shared ``(n_blocks, block_len, KV, hd)`` pool addressed through
per-slot page tables; this module owns the HOST bookkeeping: which
physical blocks are free, how many a request needs for its whole
lifetime, and the ``(n_pages,)`` int32 page-table row the engine commits
into device state at admission.

Allocator invariants (DESIGN.md §12):

* **Whole-lifetime allocation at admission.** ``pages_needed`` covers the
  prompt AND every token the request may ever decode (``max_new``), so a
  request can never stall mid-decode waiting for a block — block
  exhaustion is only ever an *admission* stall, always recoverable when a
  running request finishes.
* **Sentinel for the unallocated.** Page-table entries past the needed
  pages hold ``spec.sentinel == n_blocks``. The device pool carries one
  extra "sink" block at that id: writes to sentinel pages land there, and
  reads of it are masked by the decode ``lengths`` before the softmax
  (the kernel never reads a row past ``lengths``). It is never mapped.
* **Free is idempotent on sentinels, rejects double-free.** Blocks return
  to the free list only once; the allocator raises on a block freed twice
  or out of range, because a double-freed block handed to two live
  requests corrupts both silently.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.models.config import ArchConfig
from repro_torch.models.transformer import PagedLayout

__all__ = ["PagedSpec", "BlockAllocator", "page_row"]


@dataclasses.dataclass(frozen=True)
class PagedSpec:
    """Resolved pool geometry for one serving config."""

    block_len: int
    n_blocks: int
    n_pages: int  # page-table width: ring_len(cfg, max_seq) // block_len

    @classmethod
    def from_arch(cls, cfg: ArchConfig, max_seq: int, block_len: int,
                  n_blocks: int) -> "PagedSpec":
        layout = PagedLayout(block_len=block_len, n_blocks=n_blocks)
        return cls(block_len=block_len, n_blocks=n_blocks,
                   n_pages=layout.n_pages(cfg, max_seq))

    @property
    def sentinel(self) -> int:
        return self.n_blocks

    @property
    def layout(self) -> PagedLayout:
        return PagedLayout(block_len=self.block_len, n_blocks=self.n_blocks)

    def pages_needed(self, prompt_len: int, max_new: int) -> int:
        """Blocks one request holds for its whole lifetime.

        The request writes KV at ring slots ``pos % (n_pages * block_len)``
        for pos in [0, prompt_len + max_new): a contiguous span from slot 0
        that touches ``ceil(span / block_len)`` pages, saturating at the
        full table once the ring wraps (SWA archs)."""
        span = min(prompt_len + max_new, self.n_pages * self.block_len)
        return -(-span // self.block_len)


class BlockAllocator:
    """LIFO free-list over physical block ids [0, n_blocks)."""

    def __init__(self, spec: PagedSpec):
        self.spec = spec
        self._free = list(range(spec.n_blocks - 1, -1, -1))  # pop() -> 0 first
        self._held: set[int] = set()

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_used(self) -> int:
        return self.spec.n_blocks - len(self._free)

    @property
    def utilization(self) -> float:
        return self.n_used / max(self.spec.n_blocks, 1)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def alloc(self, n: int) -> list[int]:
        if n > len(self._free):
            raise RuntimeError(
                f"block pool exhausted: need {n}, {len(self._free)} free "
                f"of {self.spec.n_blocks} (admission must gate on can_alloc)"
            )
        blocks = [self._free.pop() for _ in range(n)]
        self._held.update(blocks)
        return blocks

    def free(self, blocks: list[int]) -> None:
        for b in blocks:
            if b not in self._held:
                raise RuntimeError(
                    f"free of block {b} not currently held "
                    f"(double-free or never allocated)"
                )
            self._held.discard(b)
            self._free.append(b)


def page_row(spec: PagedSpec, blocks: list[int]) -> np.ndarray:
    """(n_pages,) int32 page-table row: allocated blocks in page order,
    sentinel (= n_blocks, OOB on device) for the unallocated tail."""
    if len(blocks) > spec.n_pages:
        raise ValueError(
            f"{len(blocks)} blocks exceed the {spec.n_pages}-page table"
        )
    row = np.full((spec.n_pages,), spec.sentinel, np.int32)
    row[: len(blocks)] = blocks
    return row
