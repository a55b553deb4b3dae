"""Sharded MIPS index over a model-sharded table (counterpart of
``repro/core/mips/sharded.py``, DESIGN.md §3.5).

Each rank of the mesh's ``model`` axis holds the plain backend index
(exact, IVF, IVF-PQ or LSH) over its own ``n // mp`` rows — the rows of the
output embedding it owns. Builds and refreshes are shard-local: no row
leaves its rank. The distributed head probes :meth:`ShardedIndex.local_index`
directly, shard by shard; :meth:`topk_batch` / :meth:`topk_adaptive` are
the GLOBAL queries (recall diagnostics, tests): per-shard probe, then an
all-gather of the ``(mp, b, k)`` values and global ids, merged in the
reference's order (shard-major within each query, then a stable top-k), so
equal values rank as the reference ranks them.

Where the reference stacks every shard's state on a leading shard axis of
one pytree, a rank here holds its own shard's state; the reference's
stacked state converts with
:func:`repro_torch.convert.sharded_index_from_jax`.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch import collectives as coll
from repro_torch.core.gumbel import TopK
from repro_torch.core.mips import base
from repro_torch.core.mips.adaptive import AdaptiveTopK

__all__ = ["ShardedIndex"]


def _merge(vals: torch.Tensor, gids: torch.Tensor, k: int
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """(mp, b, k') gathered values / global ids -> the global top-k, each
    query's candidates laid out shard-major (``moveaxis(0, 1).reshape(b,
    -1)``), ties to the earlier position."""
    b = vals.shape[1]
    av = vals.movedim(0, 1).reshape(b, -1)
    ag = gids.movedim(0, 1).reshape(b, -1)
    v, pos = base.top_k(av, k)
    return torch.gather(ag, 1, pos), v


class ShardedIndex:
    """This rank's shard of a model-sharded index: ``local`` is the backend
    index over rows ``[offset, offset + n_local)`` of the global table."""

    def __init__(self, config: Any, mesh, axis: str, n_local: int,
                 local: Any):
        self.config = config
        self.mesh = mesh
        self.axis = axis
        self.n_local = n_local
        self.local = local

    @property
    def ax(self) -> coll.Axis:
        return self.mesh.axis(self.axis)

    @property
    def mp(self) -> int:
        return self.ax.size

    @property
    def offset(self) -> int:
        return self.ax.index * self.n_local

    @property
    def state(self) -> Any:
        """The local backend's state (this shard's; the exact backend's
        is its rows)."""
        return getattr(self.local, "state", getattr(self.local, "db", None))

    # ------------------------------------------------------------ lifecycle
    @classmethod
    def build(cls, config: Any, db: torch.Tensor, mesh, axis: str = "model",
              **build_kw) -> "ShardedIndex":
        """Build over the GLOBAL table ``db`` (n, d): this rank indexes its
        contiguous ``n // mp`` rows (``n % mp != 0`` raises, as in the
        reference). ``build_kw`` leaves with a leading extent of ``mp``
        (e.g. per-shard ``init_cent`` (mp, C, d)) are cut to this shard."""
        mp = mesh.axis(axis).size
        n = db.shape[0]
        if n % mp:
            raise ValueError(
                f"db rows ({n}) must divide the mesh axis {axis!r} ({mp})")
        n_local = n // mp
        s = mesh.axis(axis).index
        kw = {k: (v[s] if isinstance(v, torch.Tensor) else v)
              for k, v in build_kw.items()}
        return cls.build_local(config, db[s * n_local:(s + 1) * n_local],
                               mesh, axis, **kw)

    @classmethod
    def build_local(cls, config: Any, db_loc: torch.Tensor, mesh,
                    axis: str = "model", **build_kw) -> "ShardedIndex":
        """Build over this rank's own rows ``db_loc`` (n_local, d)."""
        local = base.backend_cls(config).build(db_loc, config, **build_kw)
        return cls(config, mesh, axis, db_loc.shape[0], local)

    def refresh(self, db_loc: torch.Tensor) -> "ShardedIndex":
        """Shard-local rebuild over this rank's drifted rows (same shape);
        every state tensor keeps its shape."""
        if db_loc.shape[0] != self.n_local:
            raise ValueError(f"refresh over {db_loc.shape[0]} rows, the "
                             f"shard holds {self.n_local}")
        return ShardedIndex(self.config, self.mesh, self.axis, self.n_local,
                            self.local.refresh(db_loc))

    def local_index(self, state_loc: Any = None) -> Any:
        """The plain backend index of this shard (the reference peels it
        off the stacked state inside ``shard_map``)."""
        return self.local

    # -------------------------------------------------------------- queries
    def _gather(self, ids: torch.Tensor, vals: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
        live = ids >= 0
        gid = torch.where(live, ids.long() + self.offset,
                          torch.full_like(ids, -1, dtype=torch.int64))
        v = torch.where(live, vals.float(),
                        torch.full_like(vals, float("-inf"),
                                        dtype=torch.float32))
        return coll.all_gather(v, self.ax), coll.all_gather(gid, self.ax)

    def topk_batch(self, q: torch.Tensor, k: int) -> TopK:
        """GLOBAL approximate top-k of replicated queries ``(b, d)``: each
        shard probes its rows, then the cross-shard merge (global ids)."""
        tk = self.local.topk_batch(q, k)
        av, ag = self._gather(tk.ids, tk.values)
        ids, v = _merge(av, ag, k)
        return TopK(ids, v)

    def topk(self, q: torch.Tensor, k: int) -> TopK:
        res = self.topk_batch(q[None], k)
        return TopK(res.ids[0], res.values[0])

    def topk_adaptive(self, q: torch.Tensor, k: int, *, c: float = 0.0,
                      n_probe_init: int | None = None,
                      n_probe_max: int | None = None, fused: bool = False,
                      router=None) -> AdaptiveTopK:
        """GLOBAL certificate-gated adaptive probe: each shard widens over
        its own clusters, results merge as :meth:`topk_batch`'s. ``width``
        is the max over shards (they probe in parallel: the widest is the
        critical path) and ``certified`` the AND (the global pool is a
        certified top-k only if every shard's is)."""
        if not hasattr(self.local, "topk_adaptive"):
            raise TypeError(f"backend {type(self.local).__name__} has no "
                            "adaptive probe")
        atk = self.local.topk_adaptive(
            q, k, c=c, n_probe_init=n_probe_init, n_probe_max=n_probe_max,
            fused=fused, router=router)
        av, ag = self._gather(atk.ids, atk.values)
        ids, v = _merge(av, ag, k)
        width = coll.pmax(atk.width.long(), self.ax)
        cert = coll.pmin(atk.certified.to(torch.int32), self.ax).bool()
        return AdaptiveTopK(ids, v, width, cert)

    def memory_bytes(self) -> int:
        """The backend's own accounting of one shard, times ``mp`` (shards
        have the same geometry)."""
        return self.mp * self.local.memory_bytes()

    def spill_parts(self) -> tuple[int, int]:
        """:func:`repro_torch.core.mips.index_spill_parts` summed over the
        shards (a collective: every rank of the axis calls it)."""
        st = self.state
        dev = (st if isinstance(st, torch.Tensor) else next(
            x for x in st if isinstance(x, torch.Tensor))).device
        parts = torch.tensor(base.index_spill_parts(self.local),
                             dtype=torch.int64, device=dev)
        tot = coll.psum(parts, self.ax)
        return int(tot[0]), int(tot[1])
