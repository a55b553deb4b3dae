"""Partition-function estimation, paper Algorithm 3 (counterpart of
``repro/core/partition.py``).

``Ẑ = Σ_{i∈S} e^{y_i} + (n-k)/l · Σ_{j∈T} e^{y_j}`` with S the
(approximate) top-k set and T an iid uniform sample, with replacement, from
the complement. Unbiased (Thm 3.4); relative error ε w.p. 1-δ for
``k l >= (2/3) ε^{-2} n e^c ln(1/δ)``. Computed in log space, per token of
a leading dimension t.

S ∪ T and the strata's log-weights come from
:func:`repro_torch.core.estimators.amortized_candidates`, the construction
the LM head's loss uses: dead S slots (value -inf, an underfilled probe)
weigh nothing and exclude nothing from the complement. With a full S this
is the reference's estimator exactly.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core import estimators as est
from repro_torch.core.gumbel import TopK

__all__ = ["PartitionEstimate", "partition_estimate", "stratified_logsumexp"]


class PartitionEstimate(NamedTuple):
    log_z: torch.Tensor  # (t,) f32 — log of the unbiased estimate Ẑ
    tail_ids: torch.Tensor  # (t, l) int64 — T (reused by expectations)
    tail_values: torch.Tensor  # (t, l) f32 — y over T


def _tail_weight(log_w_tail, like: torch.Tensor) -> torch.Tensor:
    """``log_w_tail`` (a number or (t,)) broadcastable against (t, l)."""
    lw = torch.as_tensor(log_w_tail, dtype=like.dtype, device=like.device)
    return lw[..., None] if lw.dim() else lw


def stratified_logsumexp(y_s: torch.Tensor, y_t: torch.Tensor,
                         log_w_tail) -> torch.Tensor:
    """``log(Σ_S e^{y_s} + e^{log_w_tail} Σ_T e^{y_t})`` over the last axis,
    numerically stable; ``log_w_tail`` is a number or one per token."""
    y_all = torch.cat([y_s, y_t + _tail_weight(log_w_tail, y_t)], dim=-1)
    return torch.logsumexp(y_all, dim=-1)


def stratified_scores(keys, topk: TopK, n, score_fn, l: int,
                      u: torch.Tensor | None):
    """S ∪ T of Algorithms 3 and 4 -> (ids (t, k+l) int64, their scores y
    (t, k+l) f32, S's log-weights (t, k), T's log-weight (t,)). S is
    RE-SCORED through ``score_fn``, not read from ``topk.values``: the
    estimate stays differentiable through both strata (∇ log Ẑ is
    Algorithm 4 with f = φ) and robust to stale index values."""
    k = topk.ids.shape[1]
    ids, log_w = est.amortized_candidates(topk, n, l, keys=keys, draws=u)
    ids = torch.clamp(ids, min=0)  # dead S slots (-1) weigh -inf
    y = score_fn(ids).float()
    return ids, y, log_w[:, :k], log_w[:, k]


def partition_estimate(keys, topk: TopK, n, score_fn: Callable, *, l: int,
                       u: torch.Tensor | None = None) -> PartitionEstimate:
    """Algorithm 3 per token. ``score_fn`` maps (t, m) ids to their (t, m)
    unnormalized log-probs. T's uniform indices come from ``keys`` ((t, 3)
    int64 rows, stream ``STREAM_COMPLEMENT``) or are injected as ``u``
    ((t, l) integers in [0, n - k))."""
    k = topk.ids.shape[1]
    ids, y, log_w_s, log_w_tail = stratified_scores(keys, topk, n, score_fn,
                                                    l, u)
    log_z = stratified_logsumexp(y[:, :k] + log_w_s, y[:, k:], log_w_tail)
    return PartitionEstimate(log_z, ids[:, k:], y[:, k:])
