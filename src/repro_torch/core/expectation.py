"""Expectation estimation under the model distribution, paper Algorithm 4
(counterpart of ``repro/core/expectation.py``).

``F = E_{i ~ softmax(y)}[f_i]`` is estimated with Algorithm 3's stratified
S ∪ T sample:

    Ĵ = Σ_S e^{y} f + (n-k)/l Σ_T e^{y} f,   F̂ = Ĵ / Ẑ.

Additive error ``εC`` (``|f| <= C``) w.p. 1-δ under Thm 3.5's conditions.
With ``f_i = φ(x_i)``, the feature rows, F̂ equals ``∇_θ log Ẑ`` of
Algorithm 3's estimator on the same S ∪ T — the identity the amortized LM
head's loss relies on.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core.gumbel import TopK
from repro_torch.core.partition import _tail_weight, stratified_scores

__all__ = ["ExpectationEstimate", "expectation_estimate", "stratified_softmax"]


class ExpectationEstimate(NamedTuple):
    value: torch.Tensor  # (t, ...) f32 — F̂
    log_z: torch.Tensor  # (t,) f32 — log Ẑ (shared byproduct)


def stratified_softmax(y_s: torch.Tensor, y_t: torch.Tensor, log_w_tail
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Normalized weights p̂ over S ∪ T (summing to 1 over the last axis)
    and log Ẑ; ``log_w_tail`` is a number or one per token."""
    y_all = torch.cat([y_s, y_t + _tail_weight(log_w_tail, y_t)], dim=-1)
    log_z = torch.logsumexp(y_all, dim=-1)
    return torch.exp(y_all - log_z[..., None]), log_z


def expectation_estimate(keys, topk: TopK, n, score_fn: Callable,
                         f_fn: Callable, *, l: int,
                         u: torch.Tensor | None = None
                         ) -> ExpectationEstimate:
    """Algorithm 4 per token.

    ``score_fn`` maps (t, m) ids to (t, m) unnormalized log-probs, ``f_fn``
    maps them to (t, m, ...) bounded function values. T comes from ``keys``
    or the injected ``u``, as in
    :func:`repro_torch.core.partition.partition_estimate` (the same keys
    give the same T)."""
    k = topk.ids.shape[1]
    ids, y, log_w_s, log_w_tail = stratified_scores(keys, topk, n, score_fn,
                                                    l, u)
    p_hat, log_z = stratified_softmax(y[:, :k] + log_w_s, y[:, k:],
                                      log_w_tail)
    f_all = f_fn(ids).float()  # (t, k+l, ...)
    value = torch.einsum("tm,tm...->t...", p_hat, f_all)
    return ExpectationEstimate(value, log_z)
