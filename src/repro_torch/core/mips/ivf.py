"""IVF (k-means) MIPS index (counterpart of ``repro/core/mips/ivf.py``) —
the production index of the paper's experiments.

Clusters are padded to a fixed capacity so the probe is a centroid matmul,
a top-``n_probe`` and a gather+score of the probed clusters with static
shapes; rows past a cluster's capacity spill into an always-scanned
overflow buffer, so coverage is exact while ``spill_count == 0``. The build
runs on the index's device: Lloyd iterations, then a stable sort packing
rows into the member tables. ``refresh`` warm-starts Lloyd from the current
centroids and keeps every shape.

The probe's gather+score runs on the ``ivf_gather_score`` kernel for CUDA
queries (on the CPU, ``use_kernel`` takes the kernel's plain version), and :meth:`IVFIndex.screen_select` runs gather-score
and top-k together on ``ivf_screen_select``; both kernels score members
with one device function, so ``screen_select`` equals ``topk_batch`` with
the kernel bit for bit (DESIGN.md §10). :meth:`IVFIndex.topk_adaptive`
widens the probe per query until the gap certificate passes
(:mod:`repro_torch.core.mips.adaptive`), unfused on the same pool as
``topk_batch`` or fused on ``ivf_screen_select``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch import cost_hook
from repro_torch.core.gumbel import TopK
from repro_torch.core.mips import adaptive, base
from repro_torch.core.quant.kmeans import assign_clusters, lloyd
from repro_torch.kernels import ops, ref

__all__ = ["IVFConfig", "IVFIndex", "IVFState"]


def _pad_pool(scores: torch.Tensor, ids: torch.Tensor, k: int):
    """Pad a candidate pool narrower than k with dead slots (-inf, -1)."""
    if scores.shape[1] < k:
        pad = k - scores.shape[1]
        scores = torch.cat([scores, scores.new_full((scores.shape[0], pad),
                                                    -math.inf)], dim=1)
        ids = torch.cat([ids, ids.new_full((ids.shape[0], pad), -1)], dim=1)
    return scores, ids


@dataclasses.dataclass(frozen=True)
class IVFConfig:
    """Build- and query-time knobs. The geometry (cluster count, padded
    capacity, overflow size) is derived from the database size at build and
    then frozen: ``refresh`` keeps it."""

    n_clusters: int | None = None  # None -> max(4, sqrt(n))
    cap_factor: float = 3.0  # padded capacity ≈ cap_factor · n / n_clusters
    overflow_frac: float = 1.0 / 16.0  # overflow buffer ≈ n/16 rows
    kmeans_iters: int = 10  # Lloyd iterations for a cold build
    refresh_iters: int = 2  # warm-started iterations per refresh
    seed: int = 0  # seeds the cold build's row sample (torch.Generator)
    n_probe: int = 8  # clusters probed per query
    n_probe_init: int = 0  # adaptive probe: starting width (0 -> n_probe)
    n_probe_max: int = 0  # adaptive probe: widening ceiling (0 -> n_probe)
    use_kernel: bool = False  # CPU: the probe through ivf_gather_score's
    #   plain version (CUDA queries always take the kernel)


class IVFState(NamedTuple):
    centroids: torch.Tensor  # (n_c, d) f32
    member_ids: torch.Tensor  # (n_c, cap) i32, -1 padded
    member_vecs: torch.Tensor  # (n_c, cap, d) — gathered copy, 0 padded
    overflow_ids: torch.Tensor  # (o_cap,) i32, -1 padded
    overflow_vecs: torch.Tensor  # (o_cap, d)
    spill_count: torch.Tensor  # () i32 — rows that fit neither table (0 = exact)
    radii: torch.Tensor  # (n_c,) f32 — max ||x - c_j|| over rows of cluster j
    #   (-inf for empty clusters), the adaptive probe's bound

    @property
    def n_clusters(self) -> int:
        return self.centroids.shape[0]

    @property
    def cap(self) -> int:
        return self.member_ids.shape[1]


def _geometry(n: int, cfg: IVFConfig) -> tuple[int, int, int]:
    """Static (n_clusters, cap, o_cap) for a database of n rows."""
    n_c = min(cfg.n_clusters or max(4, int(math.sqrt(n))), n)
    cap = max(8, int(math.ceil(cfg.cap_factor * n / n_c / 8.0)) * 8)
    o_cap = max(8, int(math.ceil(cfg.overflow_frac * n / 8.0)) * 8)
    return n_c, cap, o_cap


def _pack_ids(assign: torch.Tensor, n_c: int, cap: int, o_cap: int):
    """Capacity-padded packing. Rows sorted (stably) by cluster; a row's
    rank within its cluster picks its slot: rank < cap goes to
    ``member_ids[cluster, rank]``, the rest spill to the overflow buffer in
    sorted order, and rows past the overflow buffer are counted in
    ``spill_count``. Returns (member_ids (n_c, cap), overflow_ids (o_cap,),
    spill_count ()), ids int32."""
    n = assign.shape[0]
    dev = assign.device
    order = torch.argsort(assign, stable=True)
    sorted_assign = assign[order]
    counts = torch.bincount(assign, minlength=n_c)
    starts = torch.cumsum(counts, 0) - counts  # first sorted pos per cluster
    rank = torch.arange(n, device=dev) - starts[sorted_assign]
    in_table = rank < cap
    # one sentinel slot past each table takes the dropped writes
    flat_pos = torch.where(in_table, sorted_assign * cap + rank, n_c * cap)
    member_ids = torch.full((n_c * cap + 1,), -1, dtype=torch.int32,
                            device=dev)
    member_ids[flat_pos] = order.to(torch.int32)
    ovf_rank = torch.cumsum((~in_table).long(), 0) - 1
    ovf_pos = torch.where(~in_table & (ovf_rank < o_cap), ovf_rank, o_cap)
    overflow_ids = torch.full((o_cap + 1,), -1, dtype=torch.int32, device=dev)
    overflow_ids[ovf_pos] = order.to(torch.int32)
    spill = torch.clamp((~in_table).sum() - o_cap, min=0).to(torch.int32)
    return member_ids[:-1].reshape(n_c, cap), overflow_ids[:-1], spill


def _schedule(cfg, n_c: int, n_probe_init: int | None,
              n_probe_max: int | None) -> tuple[int, tuple[int, ...]]:
    """(widest width, width schedule) of an adaptive query: the call's
    widths, else the config's, else ``n_probe``, capped at the cluster
    count."""
    w_max = min(n_probe_max or cfg.n_probe_max or cfg.n_probe, n_c)
    init = min(n_probe_init or cfg.n_probe_init or cfg.n_probe, w_max)
    return w_max, adaptive.stage_widths(init, w_max)


def _stage_pool(scores: torch.Tensor, ids: torch.Tensor, w: torch.Tensor,
                cap: int, w_max: int, k: int):
    """A ``w_max``-probe pool (members stage by stage, then the overflow)
    at per-row widths ``w``: row i keeps the members of its first ``w[i]``
    clusters and every overflow slot; masked and padded slots are dead
    (-inf, id -1), and the pool is padded to k."""
    slot = torch.arange(scores.shape[1], device=scores.device)
    live = (ids >= 0) & ((slot >= w_max * cap)[None, :]
                         | (slot[None, :] < (w * cap)[:, None]))
    return _pad_pool(
        torch.where(live, scores, torch.full_like(scores, -math.inf)),
        torch.where(live, ids, torch.full_like(ids, -1)), k)


def _gather_rows(db: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``db[ids]`` with dead ids (-1) as zero rows."""
    out = db[torch.clamp(ids.long(), min=0)]
    out[ids < 0] = 0
    return out


def _pack(db: torch.Tensor, assign: torch.Tensor, n_c: int, cap: int,
          o_cap: int):
    """:func:`_pack_ids` plus the gathered member / overflow row copies."""
    member_ids, overflow_ids, spill = _pack_ids(assign, n_c, cap, o_cap)
    return (member_ids, _gather_rows(db, member_ids), overflow_ids,
            _gather_rows(db, overflow_ids), spill)


def _cluster_radii(dbf: torch.Tensor, cent: torch.Tensor,
                   assign: torch.Tensor) -> torch.Tensor:
    """Per-cluster residual radius ``max ||x - c_j||`` over all rows
    assigned to j; -inf for empty clusters."""
    rn = torch.linalg.norm(dbf - cent[assign], dim=1)
    radii = torch.full((cent.shape[0],), -math.inf, device=dbf.device)
    return radii.scatter_reduce_(0, assign, rn, reduce="amax")


def _coarse_quantize(dbf: torch.Tensor, init_cent: torch.Tensor | None, *,
                     n_c: int, iters: int, seed: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Coarse k-means of the f32 rows ``dbf`` -> (centroids (n_c, d),
    assignment (n,)). ``init_cent=None`` cold-starts from ``n_c`` rows
    sampled with a ``torch.Generator`` seeded by ``seed`` (the reference's
    ``jax.random.permutation`` sample cannot be replayed here; tests pass
    its centroids in as ``init_cent``)."""
    if init_cent is None:
        gen = torch.Generator(device=dbf.device)
        gen.manual_seed(seed)
        rows = torch.randperm(dbf.shape[0], generator=gen,
                              device=dbf.device)[:n_c]
        init_cent = dbf[rows]
    cent = lloyd(dbf, init_cent.float(), iters)
    return cent, assign_clusters(dbf, cent)


def _device_build(db: torch.Tensor, init_cent: torch.Tensor | None, *,
                  n_c: int, cap: int, o_cap: int, iters: int, seed: int
                  ) -> IVFState:
    """Full index (re)build on ``db``'s device: k-means + pack."""
    dbf = db.float()
    cent, assign = _coarse_quantize(dbf, init_cent, n_c=n_c, iters=iters,
                                    seed=seed)
    return IVFState(cent, *_pack(db, assign, n_c, cap, o_cap),
                    _cluster_radii(dbf, cent, assign))


@base.register_backend(IVFConfig)
class IVFIndex:
    """Stateful IVF index: frozen config + device state."""

    def __init__(self, config: IVFConfig, state: IVFState):
        self.config = config
        self.state = state

    # ------------------------------------------------------------ lifecycle
    @classmethod
    def build(cls, db: torch.Tensor, config: IVFConfig | None = None, *,
              init_cent: torch.Tensor | None = None,
              iters: int | None = None) -> "IVFIndex":
        """Build over ``db``: Lloyd from ``init_cent`` (default: a seeded
        row sample) for ``iters`` iterations (default ``kmeans_iters``),
        then pack. ``iters=0`` with saved centroids re-packs ``db`` around
        them — how a resumed run rebuilds the exact index it had."""
        cfg = config or IVFConfig()
        n_c, cap, o_cap = _geometry(db.shape[0], cfg)
        state = _device_build(db, init_cent, n_c=n_c, cap=cap, o_cap=o_cap,
                              iters=cfg.kmeans_iters if iters is None
                              else iters, seed=cfg.seed)
        return cls(cfg, state)

    def refresh(self, db: torch.Tensor, *, iters: int | None = None
                ) -> "IVFIndex":
        """Warm-started rebuild over a drifted db (same n, d): Lloyd starts
        from the current centroids and the geometry is kept, so every state
        tensor keeps its shape."""
        st = self.state
        state = _device_build(
            db, st.centroids, n_c=st.n_clusters, cap=st.cap,
            o_cap=st.overflow_ids.shape[0],
            iters=self.config.refresh_iters if iters is None else iters,
            seed=self.config.seed,
        )
        return IVFIndex(self.config, state)

    # -------------------------------------------------------------- queries
    def _probe(self, qf: torch.Tensor, n_probe: int | None) -> torch.Tensor:
        """(b, n_probe) ids of the best-scoring centroids."""
        n_probe = min(n_probe or self.config.n_probe, self.state.n_clusters)
        with cost_hook.span("index.centroids"):
            _, probe = base.top_k(qf @ self.state.centroids.T, n_probe)
        return probe

    def _overflow_scores(self, qf: torch.Tensor) -> torch.Tensor:
        """(b, o_cap) exact scores of the overflow rows — one matmul outside
        the kernels, shared by both probe paths."""
        with cost_hook.span("index.overflow"):
            return (self.state.overflow_vecs.float() @ qf.T).T

    def _pool_scores(self, qf: torch.Tensor, probe: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        """Member + overflow candidate pool of the probe list: (scores, ids)
        of shape (b, n_probe·cap + o_cap). Padded slots carry id -1 and
        unmasked scores: each caller applies its own liveness mask, so the
        fixed and adaptive probes share this pool exactly."""
        st = self.state
        b = qf.shape[0]
        with cost_hook.span("index.gather_score"):
            if self.config.use_kernel or ops.kernel_route(qf):
                scores, ids = ops.ivf_gather_score(st.member_vecs,
                                                   st.member_ids, probe, qf)
            else:
                scores, ids = ref.ivf_gather_score_ref(st.member_vecs,
                                                       st.member_ids, probe,
                                                       qf)
                scores, ids = scores.reshape(b, -1), ids.reshape(b, -1)
        o_scores = self._overflow_scores(qf)
        with cost_hook.span("index.pool"):
            scores = torch.cat([scores, o_scores], dim=1)
            ids = torch.cat([ids, st.overflow_ids[None].expand(b, -1)], dim=1)
        return scores, ids

    def topk(self, q: torch.Tensor, k: int, *, n_probe: int | None = None
             ) -> TopK:
        """Approximate top-k for a single query (d,) -> TopK[(k,)]."""
        return base.single_query(self, q, k, n_probe=n_probe)

    def topk_batch(self, q: torch.Tensor, k: int, *,
                   n_probe: int | None = None) -> TopK:
        """Approximate top-k for a query batch (b, d) -> TopK[(b,k), (b,k)]:
        the probed clusters' members ∪ overflow, dead slots at -inf. The
        call is the span ``index.topk_batch``; its stages ``index.centroids``,
        ``index.gather_score``, ``index.overflow``, ``index.pool`` (twice)
        and ``index.select`` (:func:`repro_torch.cost_hook.span`)."""
        with cost_hook.span("index.topk_batch"):
            qf = q.float()
            scores, ids = self._pool_scores(qf, self._probe(qf, n_probe))
            with cost_hook.span("index.pool"):
                scores = torch.where(ids >= 0, scores,
                                     torch.full_like(scores, -math.inf))
                scores, ids = _pad_pool(scores, ids, k)
            with cost_hook.span("index.select"):
                vals, pos = base.top_k(scores, k)
                return TopK(torch.gather(ids, 1, pos), vals)

    def topk_adaptive(self, q: torch.Tensor, k: int, *, c: float = 0.0,
                      n_probe_init: int | None = None,
                      n_probe_max: int | None = None, fused: bool = False,
                      init_stage: torch.Tensor | None = None, router=None
                      ) -> adaptive.AdaptiveTopK:
        """Certificate-gated staged probe: start at ``n_probe_init``
        clusters and widen geometrically, per query, until the gap
        certificate passes or the width reaches ``n_probe_max``
        (:func:`repro_torch.core.mips.adaptive.staged_widen`).

        Unfused, the pool of the ``n_probe_max`` best clusters is scored
        once (``ivf_gather_score`` on CUDA queries) and each stage masks it
        to the row's width: a masked slot is dead (-inf, id -1). Fused,
        each stage is one ``ivf_screen_select`` at the rows' widths (0 for
        rows already done). Both take the same scores and tie-break, so
        they agree bit for bit; with init == max either equals
        :meth:`topk_batch` at that width bit for bit. ``init_stage``
        starts rows further along the schedule; ``router``
        (:class:`repro_torch.models.router.ProbeRouter`) predicts it from
        the centroid scores when it is not given."""
        st = self.state
        w_max, widths = _schedule(self.config, st.n_clusters, n_probe_init,
                                  n_probe_max)
        qf = q.float()
        with cost_hook.span("index.centroids"):
            c_scores = qf @ st.centroids.T  # (b, n_c)
            _, probe = base.top_k(c_scores, w_max)
        bound_table = adaptive.unprobed_bound_table(c_scores, st.radii, qf)
        if router is not None and init_stage is None:
            init_stage = router.init_stage(c_scores, qf, widths)
        if fused:
            o_scores = self._overflow_scores(qf)

            def stage_fn(w):
                return ops.ivf_screen_select(
                    st.member_vecs, st.member_ids, o_scores, st.overflow_ids,
                    probe, qf, k=k, probe_width=w)
        else:
            scores, ids = self._pool_scores(qf, probe)

            def stage_fn(w):
                with cost_hook.span("index.pool"):
                    sc, sids = _stage_pool(scores, ids, w, st.cap, w_max, k)
                with cost_hook.span("index.select"):
                    vals, pos = base.top_k(sc, k)
                    return vals, torch.gather(sids, 1, pos)

        return adaptive.staged_widen(stage_fn, bound_table, widths, k, c=c,
                                     no_spill=st.spill_count == 0,
                                     init_stage=init_stage)

    def screen_select(self, q: torch.Tensor, k: int, *,
                      n_probe: int | None = None) -> TopK:
        """Fused probe: gather-score AND top-k selection in one kernel call
        (``ivf_screen_select``): a score pass over the whole card writes one
        64-bit sort key per probed member slot, (b, n_probe·cap) of them in
        device memory (the scores and ids of :meth:`topk_batch`'s pool are
        never materialized), and a select kernel takes each query's top k
        of those keys and the overflow's. Equal to :meth:`topk_batch` with
        ``use_kernel`` (same scores, same tie-break, -inf picks as id -1,
        which are the pool's dead ids anyway)."""
        st = self.state
        qf = q.float()
        probe = self._probe(qf, n_probe)
        vals, ids = ops.ivf_screen_select(
            st.member_vecs, st.member_ids, self._overflow_scores(qf),
            st.overflow_ids, probe, qf, k=k,
        )
        return TopK(ids, vals)

    def memory_bytes(self) -> int:
        return base.state_bytes(self.state)
