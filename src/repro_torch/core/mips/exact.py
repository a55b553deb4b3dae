"""Brute-force MIPS oracle (counterpart of ``repro/core/mips/exact.py``):
exact top-k by dense scoring, O(n·d) per query."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.gumbel import TopK
from repro_torch.core.mips import base

__all__ = ["ExactConfig", "ExactIndex"]


@dataclasses.dataclass(frozen=True)
class ExactConfig:
    """Brute force has no knobs; the dataclass exists as the backend key."""


@base.register_backend(ExactConfig)
class ExactIndex:
    """Stateful oracle index: the state is the database itself."""

    def __init__(self, config: ExactConfig, db: torch.Tensor):
        self.config = config
        self.db = db  # (n, d)

    @classmethod
    def build(cls, db: torch.Tensor, config: ExactConfig | None = None):
        return cls(config or ExactConfig(), db)

    def refresh(self, db: torch.Tensor) -> "ExactIndex":
        return ExactIndex(self.config, db)

    def topk(self, q: torch.Tensor, k: int) -> TopK:
        """Exact top-k for a single query (d,)."""
        return base.single_query(self, q, k)

    def topk_batch(self, q: torch.Tensor, k: int) -> TopK:
        """q: (b, d) -> exact TopK with leading batch dim."""
        vals, ids = base.top_k(q @ self.db.T, k)
        return TopK(ids, vals.float())

    def memory_bytes(self) -> int:
        return base.state_bytes(self.db)
