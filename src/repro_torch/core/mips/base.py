"""Stateful MIPS Index API (counterpart of ``repro/core/mips/base.py``,
DESIGN.md §7).

An :class:`Index` owns a frozen per-backend config dataclass and a state of
device tensors. The config type selects the backend::

    index = build_index(IVFConfig(n_probe=8), db)
    topk  = index.topk_batch(q, k)   # TopK[(b, k)]
    topk  = index.topk(q[0], k)      # one query: TopK[(k,)]
    index = index.refresh(new_db)    # warm-started, same shapes
    index.memory_bytes()
"""
from __future__ import annotations

from typing import Any, Protocol, runtime_checkable

import torch

from repro_torch.core.gumbel import TopK

__all__ = [
    "Index",
    "single_query",
    "backend_cls",
    "build_index",
    "index_spill",
    "index_spill_parts",
    "register_backend",
    "state_bytes",
    "top_k",
]

# config dataclass type -> index class; filled by register_backend when each
# backend module is imported
_BACKENDS: dict[type, type] = {}


def register_backend(config_cls: type):
    """Class decorator mapping a config dataclass to its Index class."""

    def wrap(index_cls: type) -> type:
        _BACKENDS[config_cls] = index_cls
        return index_cls

    return wrap


@runtime_checkable
class Index(Protocol):
    """A built MIPS index over a database of feature rows ``(n, d)``."""

    config: Any

    @classmethod
    def build(cls, db: torch.Tensor, config: Any) -> "Index":
        """Construct the index over ``db``."""
        ...

    def refresh(self, db: torch.Tensor) -> "Index":
        """Rebuild over a drifted ``db`` of the SAME shape, warm-starting
        from the current state; the new state has the same shapes."""
        ...

    def topk(self, q: torch.Tensor, k: int) -> TopK:
        """(d,) query -> TopK[(k,)]."""
        ...

    def topk_batch(self, q: torch.Tensor, k: int) -> TopK:
        """(b, d) queries -> TopK[(b, k)]."""
        ...

    def memory_bytes(self) -> int:
        """Device memory held by the index state."""
        ...


def backend_cls(config: Any) -> type:
    """Index class registered for ``type(config)``."""
    try:
        return _BACKENDS[type(config)]
    except KeyError:
        known = sorted(c.__name__ for c in _BACKENDS)
        raise TypeError(
            f"no index backend registered for {type(config).__name__}; "
            f"known configs: {known}"
        ) from None


def build_index(config: Any, db: torch.Tensor, *, mesh=None,
                axis: str = "model", **kw) -> Index:
    """Build the index backend matching ``type(config)`` over ``db``.

    With ``mesh`` (:class:`repro_torch.launch.mesh.Mesh`), a
    :class:`repro_torch.core.mips.ShardedIndex` over the mesh ``axis``:
    ``db`` is then THIS rank's rows (the port's ranks hold only their
    slice of a sharded table), indexed shard-locally."""
    if mesh is not None:
        from repro_torch.core.mips.sharded import ShardedIndex

        return ShardedIndex.build_local(config, db, mesh, axis, **kw)
    return backend_cls(config).build(db, config, **kw)


def index_spill(index: Any) -> int:
    """Coverage shortfall of a built index; 0 means every database row is
    reachable at the configured probe / re-rank settings. The sum of
    :func:`index_spill_parts`, whose two counts call for different fixes."""
    return sum(index_spill_parts(index))


def index_spill_parts(index: Any) -> tuple[int, int]:
    """(rows an IVF / IVF-PQ build dropped from both the member tables and
    the overflow buffer — ``state.spill_count``, fixed by a larger
    ``overflow_frac``; for LSH, the member slots the bucket cap dropped —
    ``dropped_count``, fixed by a larger ``bucket_cap``; re-rank slots an
    IVF-PQ probe pool can never fill — ``state.rerank_spill``, fixed by a
    smaller ``PQConfig.rerank`` or more probed clusters). (0, 0) for None
    and for backends without the counters. Reads device scalars. A
    :class:`repro_torch.core.mips.ShardedIndex` sums its shards' counts (a
    collective over its axis)."""
    if hasattr(index, "spill_parts"):
        return index.spill_parts()
    st = getattr(index, "state", None)
    dropped = getattr(index, "dropped_count", None)
    if dropped is None:
        dropped = getattr(st, "spill_count", None)
    short = getattr(st, "rerank_spill", None)
    return (0 if dropped is None else int(dropped),
            0 if short is None else int(short))


def single_query(index: Any, q: torch.Tensor, k: int, **kw) -> TopK:
    """``index.topk_batch`` for one (d,) query -> TopK[(k,)]."""
    res = index.topk_batch(q[None], k, **kw)
    return TopK(res.ids[0], res.values[0])


def state_bytes(tree: Any) -> int:
    """Total bytes of the tensors in ``tree`` (tuples, lists, dicts)."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        tree = tree.values()
    if isinstance(tree, (tuple, list, type({}.values()))):
        return sum(state_bytes(x) for x in tree)
    return 0


def top_k(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` semantics over the last axis -> (values, indices):
    descending, the lower index first among equal values."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]
