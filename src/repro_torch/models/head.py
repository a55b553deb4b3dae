"""Distributed amortized LM head over the vocabulary sharded on the mesh's
``model`` axis (counterpart of ``repro/models/head.py``, DESIGN.md §3.5).

Each rank owns a contiguous slice of the output embedding's rows and runs
the SAME estimator core as the single-device head
(:mod:`repro_torch.core.estimators`) over it — an index-backed top-k probe
(this shard of a :class:`repro_torch.core.mips.ShardedIndex`, sublinear in
the slice) or the dense scan of the slice, the stratified Algorithm-3
partial, the lazy-Gumbel local max. This module holds only the shard
plumbing and the O(1)-per-token combines:

* loss: ``log Ẑ`` is the logsumexp over shards of the local ``log Ẑ_s``,
  the target logit a masked sum
  (:func:`repro_torch.core.estimators.combine_loss_psum`);
* sample: the global argmax of the per-shard lazy-Gumbel maxima is an exact
  global sample, and the certificates combine by a min
  (:func:`repro_torch.core.estimators.combine_sample_pmax`): one (value,
  id) pair per shard, where a full-logit gather moves |V|/mp per shard.

The hidden states enter through :func:`repro_torch.collectives.copy_to`,
so ``dL/dh`` sums every shard's terms. Each shard folds its model index
into the token keys (the reference's ``fold_in(key, midx)``), so shards
draw independently; ``draws`` injects one shard's raw numbers instead.
"""
from __future__ import annotations

import torch

from repro_torch import collectives as coll
from repro_torch.core import estimators as est
from repro_torch.core import rng
from repro_torch.core.amortized_head import HeadConfig

__all__ = ["dist_head_loss", "dist_head_sample", "batch_axes", "shard_geometry",
           "shard_keys"]


def batch_axes(mesh) -> tuple[str, ...]:
    """The mesh's batch axes. The port's ranks hold their data slice
    already, so no activation is placed by them (the reference's
    ``_token_spec``)."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def shard_geometry(cfg: HeadConfig, vp: int, mp: int) -> tuple[int, int, int]:
    """(rows, k, l) of one shard of a ``vp``-row table over ``mp`` shards:
    each shard probes ``max(8, k // mp)`` and draws ``max(8, l // mp)``."""
    return vp // mp, max(8, cfg.k // mp), max(8, cfg.l // mp)


def shard_keys(keys: torch.Tensor | None, midx: int) -> torch.Tensor | None:
    """Per-token keys with the shard's model index folded in."""
    if keys is None:
        return None
    return rng.fold_in(keys, torch.full(keys.shape[:-1], midx,
                                        dtype=torch.int64,
                                        device=keys.device))


def _local(mesh, emb_loc: torch.Tensor, cfg: HeadConfig):
    ax = mesh.model
    v_loc = emb_loc.shape[0]
    offset = ax.index * v_loc
    n_valid = min(max(cfg.n - offset, 0), v_loc)
    _, k_loc, l_loc = shard_geometry(cfg, v_loc * ax.size, ax.size)
    return ax, offset, n_valid, k_loc, l_loc


def dist_head_loss(mesh, emb_loc: torch.Tensor, h: torch.Tensor,
                   targets: torch.Tensor, cfg: HeadConfig, index=None, *,
                   keys: torch.Tensor | None = None,
                   draws: torch.Tensor | None = None) -> torch.Tensor:
    """Per-token NLL (T,), the same on every rank of the model axis.
    Differentiable in ``emb_loc`` (this rank's rows) and ``h``.

    ``h`` (T, d) and ``targets`` (T,) global ids are this data rank's
    tokens; ``index`` a :class:`ShardedIndex` over the same table; ``keys``
    ((T, 3)) key the amortized tail draws (the shard folds its index in);
    ``draws`` ((T, l_loc)) inject this shard's draws instead."""
    cfg = cfg.resolved()
    ax, offset, n_valid, k_loc, l_loc = _local(mesh, emb_loc, cfg)
    index_loc = index.local_index() if index is not None else None
    keys_loc = shard_keys(keys, ax.index)
    embf = emb_loc.float()
    hf = coll.copy_to(h.float(), ax)
    tgt = targets.long() - offset

    def one_chunk(hc, tc, kc, dc):
        return est.loss_partials(
            embf, hc, tc, mode=cfg.mode, k=k_loc, l=l_loc, index=index_loc,
            n_valid=n_valid, score_dtype=cfg.score_dt,
            use_kernel=cfg.use_kernel, keys=kc, draws=dc)

    parts = est.chunked_map(one_chunk, cfg.chunk, hf, tgt, keys_loc, draws)
    return est.combine_loss_psum(parts, cfg.mode, ax)


def dist_head_sample(mesh, emb_loc: torch.Tensor, h: torch.Tensor,
                     cfg: HeadConfig, index=None, *,
                     keys: torch.Tensor | None = None, draws=None,
                     router=None
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Distributed lazy-Gumbel sampling -> (ids (T,), ok (T,), width (T,)),
    the same on every rank of the model axis.

    ``keys`` ((T, 3) rows (seed, request id, position)) pin each token's
    randomness to its own key, with the shard's index folded in on top;
    ``draws`` (:class:`repro_torch.core.rng.Draws`) inject this shard's.
    ``width`` is each token's effective probe width under
    ``cfg.adaptive_probe``, the max over shards (they probe in parallel);
    -1 on fixed-width paths. ``router`` is replicated: each shard routes
    its own probe."""
    cfg = cfg.resolved()
    ax, offset, n_valid, k_loc, l_loc = _local(mesh, emb_loc, cfg)
    keys_loc = shard_keys(keys, ax.index)
    t = h.shape[0]
    dev = h.device
    width = torch.full((t,), -1, dtype=torch.int64, device=dev)
    embf = emb_loc.float()
    if cfg.mode == "exact":
        loc_best, val = est.dense_gumbel_max(embf, h.float(), n_valid,
                                             keys=keys_loc)
        gid = loc_best.long() + offset
        ok = torch.ones((t,), dtype=torch.bool, device=dev)
        bound = torch.full((t,), float("-inf"), device=dev)
    else:
        index_loc = index.local_index() if index is not None else None
        res = est.local_gumbel_max(
            embf, h.float(), k=k_loc, l=l_loc, keys=keys_loc,
            index=index_loc, n_valid=n_valid, c=cfg.c,
            fused=cfg.fused_decode, draws=draws,
            adaptive=cfg.adaptive_probe, router=router)
        gid = res.index.long() + offset
        val = res.max_val
        bound = res.bound
        ok = ~res.overflow
        width = res.width.long()
    gid_g, ok_g = est.combine_sample_pmax(gid, val, bound, ok, ax)
    return gid_g, ok_g, coll.pmax(width, ax)
