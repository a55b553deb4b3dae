"""Shard-local estimator core, sampling half (counterpart of
``repro/core/estimators.py``): the top-k probe, dead-slot sanitizing and
the batched lazy-Gumbel max, unfused and fused.

Conventions: ``emb`` is the feature table ``(v, d)`` and ids are row
indices. Every estimator quantity is float32 whatever the trunk's
precision policy: the Algorithm-2 certificate must fail because the probe
missed, never because of rounding.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.core import rng
from repro_torch.core.gumbel import (
    SampleResult,
    TopK,
    certificate,
    cutoff,
    default_m_cap,
    plan_tail,
    sample_fixed_b,
)
from repro_torch.core.mips.base import top_k
from repro_torch.kernels import ops

__all__ = [
    "topk_probe",
    "sanitize_topk",
    "local_gumbel_max",
    "dense_gumbel_max",
]


def _mask_probe(tk: TopK, n_valid) -> TopK:
    """Index probe result -> TopK with dead slots (id < 0, or a pad row
    >= n_valid) at value -inf."""
    ids = tk.ids.long()
    ok = ids >= 0
    if n_valid is not None:
        ok &= ids < n_valid
    vals = torch.where(ok, tk.values.float(),
                       torch.full_like(tk.values, -math.inf, dtype=torch.float32))
    return TopK(ids, vals)


def topk_probe(emb: torch.Tensor, h: torch.Tensor, k: int, *,
               index: Any = None, n_valid=None) -> TopK:
    """Top-k candidates S for queries ``h (t, d)``: index-backed when
    ``index`` is given, else a dense masked scan of ``emb``."""
    if index is None:
        scores = (h @ emb.T).float()
        if n_valid is not None:
            ok = torch.arange(emb.shape[0], device=emb.device) < n_valid
            scores = torch.where(ok[None, :], scores,
                                 torch.full_like(scores, -math.inf))
        vals, ids = top_k(scores, k)
        return TopK(ids, vals)
    return _mask_probe(index.topk_batch(h, k), n_valid)


def sanitize_topk(topk: TopK, n) -> tuple[torch.Tensor, torch.Tensor]:
    """Remap dead probe slots (value -inf) to the distinct virtual ids
    ``n + slot``, past every complement draw, so they exclude nothing.
    Returns (sanitized ids (t, k) int64, per-token live count (t,) int64)."""
    t, k = topk.ids.shape
    valid = ~torch.isneginf(topk.values)
    virt = n + torch.arange(k, device=topk.ids.device)[None, :]
    return torch.where(valid, topk.ids.long(), virt), valid.sum(1)


def local_gumbel_max(emb: torch.Tensor, h: torch.Tensor, *, k: int, l: int,
                     keys: torch.Tensor | None = None, index: Any = None,
                     n_valid=None, c: float = 0.0, m_cap: int | None = None,
                     fused: bool = False, draws: rng.Draws | None = None
                     ) -> SampleResult:
    """Batched lazy-Gumbel max (Algorithm 2) over the rows of ``emb`` for
    queries ``h (t, d)``.

    ``keys`` ((t, 3) int64) makes each token's randomness a function of its
    (seed, request id, position) row; ``draws`` injects the raw random
    numbers instead (tests). Both paths below consume the same draws.

    ``fused=True`` runs the probe through the index's ``screen_select``
    (gather-score + top-k in one kernel) when the index has one, and the
    tail finish through the ``tail_gather_argmax`` kernel. The unfused path
    with the ``ivf_gather_score`` kernel probe picks the same top-k (same
    scores, same tie-break) and scores the tail with a plain batched
    matmul, so the two agree on every sample up to the last bit of the
    tail scores."""
    nv = emb.shape[0] if n_valid is None else n_valid
    if m_cap is None:
        m_cap = default_m_cap(l)
    embf = emb.float()
    hf = h.float()
    screen = getattr(index, "screen_select", None) if fused else None
    if screen is not None:
        topk = _mask_probe(screen(hf, k), n_valid)
    else:
        topk = topk_probe(embf, hf, k, index=index, n_valid=n_valid)
    ids_clean, k_valid = sanitize_topk(topk, nv)
    if draws is None:
        if keys is None:
            raise ValueError("local_gumbel_max needs keys or draws")
        draws = rng.tail_draws(keys, k=k, m_cap=m_cap,
                               hi=torch.clamp(nv - k_valid, min=1), lam=l)
    if fused:
        return _fused_tail_argmax(embf, hf, ids_clean, topk.values, k_valid,
                                  nv, l=l, m_cap=m_cap, c=c, draws=draws)
    last = embf.shape[0] - 1

    def score_fn(ids):
        rows = embf[torch.clamp(ids, max=last)]  # (t, m, d)
        return torch.bmm(rows, hf[:, :, None])[..., 0]

    return sample_fixed_b(None, TopK(ids_clean, topk.values), nv, score_fn,
                          l=l, m_cap=m_cap, c=c, k_valid=k_valid, draws=draws)


def _fused_tail_argmax(embf: torch.Tensor, hf: torch.Tensor,
                       ids_clean: torch.Tensor, values: torch.Tensor,
                       k_valid: torch.Tensor, nv, *, l: int, m_cap: int,
                       c: float, draws: rng.Draws) -> SampleResult:
    """Algorithm-2 finish with the tail gather + perturbed argmax in one
    kernel. The tail plan (positions, heights, live count) is built from the
    same draws as :func:`sample_fixed_b` builds it; only the (t, m_cap, d)
    row gather and the argmax move into ``tail_gather_argmax``."""
    pert_s = values.float() + draws.g_s
    b = cutoff(nv, k_valid, l)
    plan = plan_tail(None, ids_clean, nv, b, l, m_cap, k_valid=k_valid,
                     draws=draws)
    # complement draws are < nv <= rows already; the clamp is defensive, as
    # in the unfused score_fn
    pos = torch.clamp(plan.pos, max=embf.shape[0] - 1)
    idx, max_val = ops.tail_gather_argmax(embf, pos, plan.m_used, pert_s,
                                          ids_clean, plan.heights, hf)
    ok, bound = certificate(values, b, c, max_val, plan.overflow)
    return SampleResult(idx.long(), ok, plan.m_used, max_val, bound,
                        plan.overflow)


def dense_gumbel_max(emb: torch.Tensor, h: torch.Tensor, n_valid=None, *,
                     keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact dense Gumbel-max per token: (ids (t,), perturbed max (t,))."""
    scores = h.float() @ emb.float().T
    if n_valid is not None:
        ok = torch.arange(emb.shape[0], device=emb.device) < n_valid
        scores = torch.where(ok[None, :], scores,
                             torch.full_like(scores, -math.inf))
    pert = scores + rng.gumbel(keys, scores.shape[1], rng.STREAM_DENSE)
    mx, idx = torch.max(pert, dim=-1)
    return idx, mx
