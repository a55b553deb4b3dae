"""Shard-local estimator core (counterpart of ``repro/core/estimators.py``).

* sampling: the top-k probe, dead-slot sanitizing and the batched
  lazy-Gumbel max (Algorithm 2), unfused and fused, and its top-``num``
  without replacement (:func:`local_gumbel_topk`, stochastic beam
  search's expansion);
* learning: S ∪ T candidates with stratum log-weights, the stratified
  ``log Ẑ`` (Algorithm 3) whose gradient is Algorithm 4's expectation
  estimator with f = φ, the loss partials and their one-shard combine, and
  the token chunking of the head;
* the Spring–Shrivastava LSH sampler (:func:`lsh_sampler_logz`), the second
  ``log Z`` estimator behind Algorithm 3's interface.

Conventions: ``emb`` is the feature table ``(v, d)`` and ids are row
indices. Every estimator quantity is float32 whatever the trunk's
precision policy: the Algorithm-2 certificate must fail because the probe
missed, never because of rounding. The cross-shard combines
(:func:`combine_loss_psum`, :func:`combine_sample_pmax`) run over a mesh
axis (:mod:`repro_torch.collectives`) with O(1) scalars per token.

Randomness: the tail draws of a token come from the counter-based
generator keyed by its ``keys`` row (:mod:`repro_torch.core.rng`), or are
injected as ``draws`` (the parity tests pass the reference's own numbers).
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import collectives as coll
from repro_torch.core import rng
from repro_torch.core.complement import sample_complement
from repro_torch.core.gumbel import (
    SampleResult,
    TopK,
    TopKSampleResult,
    certificate,
    cutoff,
    default_m_cap,
    gumbel_max_dense,
    plan_tail,
    sample_fixed_b,
    topk_fixed_b,
)
from repro_torch.core.mips.base import top_k
from repro_torch.core.mips.lsh import log_collision_prob, query_codes
from repro_torch.kernels import ops

__all__ = [
    "LossPartials",
    "topk_probe",
    "sanitize_topk",
    "amortized_candidates",
    "topk_only_candidates",
    "stratified_logz",
    "lsh_sampler_logz",
    "exact_logz",
    "target_partial",
    "loss_partials",
    "combine_loss",
    "combine_loss_psum",
    "combine_sample_pmax",
    "local_gumbel_max",
    "local_gumbel_topk",
    "dense_gumbel_max",
    "chunked_map",
]

_NEG_INF = float("-inf")


class LossPartials(NamedTuple):
    log_z: torch.Tensor  # (t,) stratified partial of log Ẑ (Alg 3)
    y_t: torch.Tensor  # (t,) target logit where locally owned, else 0.0


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
                     fused: bool = False, draws: rng.Draws | None = None,
                     adaptive: bool = False, router: Any = None
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
    tail scores.

    ``adaptive=True`` routes the probe through the index's
    certificate-gated staged widening (``topk_adaptive``,
    :mod:`repro_torch.core.mips.adaptive`; fused: the screens at per-row
    widths) when the index has one; the effective per-token width comes
    back in ``SampleResult.width`` (-1 on fixed-width paths). The
    Algorithm-2 certificate stays the authority on exactness: the gap
    certificate only routes bandwidth. ``router``
    (:class:`repro_torch.models.router.ProbeRouter`) predicts each query's
    starting stage."""
    nv = emb.shape[0] if n_valid is None else n_valid
    if m_cap is None:
        m_cap = default_m_cap(l)
    embf = emb.float()
    hf = h.float()
    width = None
    screen = getattr(index, "screen_select", None) if fused else None
    if adaptive and hasattr(index, "topk_adaptive"):
        atk = index.topk_adaptive(hf, k, c=c, fused=fused, router=router)
        topk = _mask_probe(TopK(atk.ids, atk.values), n_valid)
        width = atk.width
    elif screen is not None:
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
        res = _fused_tail_argmax(embf, hf, ids_clean, topk.values, k_valid,
                                 nv, l=l, m_cap=m_cap, c=c, draws=draws)
    else:
        res = sample_fixed_b(None, TopK(ids_clean, topk.values), nv,
                             _tail_score_fn(embf, hf), l=l, m_cap=m_cap, c=c,
                             k_valid=k_valid, draws=draws)
    if width is not None:
        res = res._replace(width=width.long())
    return res


def _tail_score_fn(embf: torch.Tensor, hf: torch.Tensor):
    """(t, m) ids -> (t, m) scores ``emb[id] · h`` per token (a batched
    matmul over the gathered rows; ids clamped to the table, defensively:
    complement draws are already below it)."""
    last = embf.shape[0] - 1

    def score_fn(ids):
        rows = embf[torch.clamp(ids, max=last)]  # (t, m, d)
        return torch.bmm(rows, hf[:, :, None])[..., 0]

    return score_fn


def local_gumbel_topk(emb: torch.Tensor, h: torch.Tensor, *, num: int,
                      k: int, l: int, keys: torch.Tensor | None = None,
                      index: Any = None, n_valid=None, c: float = 0.0,
                      m_cap: int | None = None,
                      draws: rng.Draws | None = None) -> TopKSampleResult:
    """Batched lazy-Gumbel top-``num`` WITHOUT replacement over the rows of
    ``emb`` for queries ``h (t, d)``: :func:`local_gumbel_max`'s probe,
    dead-slot sanitizing and key discipline, with
    :func:`repro_torch.core.gumbel.topk_fixed_b` as the finish. Each token
    gets the ``num`` largest perturbed values of ONE joint Gumbel draw
    (Kool et al. 2019) and the Algorithm-2 certificate on the whole kept
    set: the candidate draw of stochastic beam search
    (:mod:`repro_torch.workloads.structured`), one call per expansion.

    ``keys`` ((t, 3) int64) keys each token's draws (beam search derives
    them from the node path, so a beam's draw does not depend on its
    batch-mates); ``draws`` injects them instead."""
    nv = emb.shape[0] if n_valid is None else n_valid
    if m_cap is None:
        m_cap = default_m_cap(l)
    embf = emb.float()
    hf = h.float()
    topk = topk_probe(embf, hf, k, index=index, n_valid=n_valid)
    ids_clean, k_valid = sanitize_topk(topk, nv)
    if draws is None:
        if keys is None:
            raise ValueError("local_gumbel_topk needs keys or draws")
        draws = rng.tail_draws(keys, k=k, m_cap=m_cap,
                               hi=torch.clamp(nv - k_valid, min=1), lam=l)
    return topk_fixed_b(None, TopK(ids_clean, topk.values), nv,
                        _tail_score_fn(embf, hf), num=num, l=l, m_cap=m_cap,
                        c=c, k_valid=k_valid, draws=draws)


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
                        plan.overflow, torch.full_like(plan.m_used, -1))


def dense_gumbel_max(emb: torch.Tensor, h: torch.Tensor, n_valid=None, *,
                     keys: torch.Tensor, stream: int = rng.STREAM_DENSE
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact dense Gumbel-max per token: (ids (t,), perturbed max (t,)),
    the noise from ``stream`` of each token's ``keys`` row."""
    scores = h.float() @ emb.float().T
    if n_valid is not None:
        ok = torch.arange(emb.shape[0], device=emb.device) < n_valid
        scores = torch.where(ok[None, :], scores,
                             torch.full_like(scores, -math.inf))
    return gumbel_max_dense(keys, scores, return_max=True, stream=stream)


# --------------------------------------------------------------------------
# learning: candidates, stratified partials, loss (Algorithms 3 and 4)
# --------------------------------------------------------------------------
def amortized_candidates(topk: TopK, n, l: int, *,
                         keys: torch.Tensor | None = None,
                         draws: torch.Tensor | None = None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """S ∪ T with stratum log-weights (Algorithm 3) -> (ids (t, k+l) int64,
    log_w (t, k+l) f32).

    Dead S slots (value -inf) carry weight -inf, exclude nothing from the
    complement (:func:`sanitize_topk`), and the tail stratum's support and
    weight use the per-token count of LIVE exclusions, so the estimator
    stays unbiased under partial probe fills. An empty tail weighs -inf.
    ``keys`` ((t, 3) int64) keys each token's tail draw; ``draws`` ((t, l)
    integers in [0, n - live count)) injects it instead."""
    t, k = topk.ids.shape
    ids_clean, k_valid = sanitize_topk(topk, n)
    s_sorted = torch.sort(ids_clean, dim=1).values
    tail = sample_complement(keys, n, s_sorted, l, n_excluded=k_valid,
                             u=draws)  # (t, l)
    tail_n = float(n) - k_valid.float()
    log_w_tail = torch.where(tail_n > 0,
                             torch.log(torch.clamp(tail_n, min=1.0) / l),
                             torch.full_like(tail_n, _NEG_INF))
    ids = torch.cat([topk.ids.long(), tail], dim=1)
    log_w_s = torch.where(torch.isneginf(topk.values),
                          torch.full_like(topk.values, _NEG_INF),
                          torch.zeros_like(topk.values))
    log_w = torch.cat([log_w_s, log_w_tail[:, None].expand(t, l)], dim=1)
    return ids, log_w


def topk_only_candidates(topk: TopK, targets: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Truncated-support candidates: S with the target's duplicate slot
    masked — the target itself enters via the combine, exactly once."""
    dead = torch.isneginf(topk.values) | (topk.ids == targets[:, None])
    log_w = torch.where(dead, torch.full_like(topk.values, _NEG_INF),
                        torch.zeros_like(topk.values))
    return topk.ids.long(), log_w


class _FusedLogZ(torch.autograd.Function):
    """``log Σ_j w_j e^{y_j}`` through the ``fused_estimator`` kernel, with
    the reference's custom VJP (``estimators.py::_fused_logz``): d_h =
    g · expv (Algorithm 4's estimate); d_emb, the scatter of p · h, and p,
    the log_w cotangent, from the ``fused_estimator_bwd`` kernel, which
    takes the scores y the forward wrote (t × m fp32). Only ids, log_w,
    log_z, expv, y and references to emb and h are saved — never the
    (t, m, d) rows."""

    @staticmethod
    def forward(ctx, emb, h, ids, log_w):
        log_z, expv, y = ops.fused_estimator(emb, ids, h, log_w,
                                             return_y=True)
        ctx.save_for_backward(emb, h, ids, log_w, log_z, expv, y)
        return log_z

    @staticmethod
    def backward(ctx, g):
        emb, h, ids, log_w, log_z, expv, y = ctx.saved_tensors
        d_emb, p = ops.fused_estimator_bwd(emb, ids, h, log_w, log_z, g, y=y)
        d_h = (g[:, None] * expv).to(h.dtype)
        return d_emb.to(emb.dtype), d_h, None, p.to(log_w.dtype)


def stratified_logz(emb: torch.Tensor, h: torch.Tensor, ids: torch.Tensor,
                    log_w: torch.Tensor, *, use_kernel: bool = False
                    ) -> torch.Tensor:
    """Per-token ``log Σ_i w_i e^{y_i}`` over candidates (t,), differentiable
    w.r.t. ``emb`` and ``h`` (∇_h = Algorithm 4's expectation estimate).

    On CUDA (and meta) tensors the candidates always stream through the
    ``fused_estimator`` kernel (no (t, m, d) gather in device memory),
    backed by its backward kernel. On the CPU, ``use_kernel`` takes that
    route through the kernels' plain versions; without it the rows are
    gathered and differentiated through a logsumexp. All give the same
    value and gradients."""
    # -1 pads, and the tail ids past the table that an empty complement
    # draws (S covering every row), carry weight -inf: clamp them into the
    # table, as the reference's gather clamps
    ids = torch.clamp(ids.detach(), 0, emb.shape[0] - 1)
    log_w = log_w.float()  # stratum weights: fp32 always
    if use_kernel or ops.kernel_route(h):
        return _FusedLogZ.apply(emb, h, ids, log_w)
    # an embedding lookup, not ``emb[ids]``: advanced indexing's backward
    # on the CPU adds repeated rows with atomics across threads, in an order
    # that changes from run to run; the embedding backward does not
    rows = torch.nn.functional.embedding(ids, emb)  # (t, m, d)
    y = torch.einsum("tmd,td->tm", rows, h).float()
    return torch.logsumexp(y + log_w, dim=1)


# bytes of the (t, tables, cap) candidate ids and weights the LSH sampler
# holds at a time on its dense path
_LSH_CHUNK_BYTES = 2 << 30


def lsh_sampler_logz(index: Any, h: torch.Tensor, *, per_table: bool = False,
                     min_bit_prob: float = 1e-7) -> torch.Tensor:
    """Spring–Shrivastava (arXiv 1703.05160) unbiased LSH-sampler estimate
    of ``log Z``, the second estimator behind Algorithm 3's interface, with
    the buckets of an :class:`repro_torch.core.mips.LSHIndex` as the
    proposal.

    Per table ``t``, every row ``x`` in the query's bucket is weighted by
    its exact collision probability ``q1(x) = p(x)^n_bits`` (SRP per-bit
    agreement ``p = 1 - angle/π`` of the norm-completed vectors, as
    ``LSHIndex.bucket_log_probs`` gives it; the query's augmented
    coordinate is 0, so the score stays ``h·x``)::

        Z_t = Σ_{x in bucket_t(h)} e^{y_x} / q1(x),   E[Z_t] = Z

    and the estimate is the mean of the L per-table estimates. Unbiased
    only with lossless buckets: check ``index.dropped_count == 0``.

    The weight ``y - log q1`` does not depend on the table, so it is
    computed once per (query, row) and each table gathers scalars from it:
    the reference's ``(L, t, cap, d+1)`` row gather is never built. When
    the tables hold fewer slots than the table has rows (``L·cap < n``),
    only the query's live candidates are scored, each once
    (``LSHIndex.score_candidates``); otherwise every row is, as one
    product, and the tables are taken as many at a time as keep their
    candidate ids and weights within 2 GB. Either way the work grows with
    ``min(L·cap, n)``.

    Returns (t,) ``log Ẑ``, or with ``per_table`` the (t, L) per-table
    ``log Z_t`` (an empty bucket gives -inf, a legitimate ``Z_t = 0``).
    ``min_bit_prob`` floors the per-bit probability so that a retrieved
    near-antipodal row keeps a finite weight. All fp32."""
    hf = h.float()
    t = hf.shape[0]
    db_aug = index.db_aug
    n_tables, n_bits, cap = index.n_tables, index.n_bits, index.bucket_cap
    q_norm = torch.linalg.norm(hf, dim=1)[:, None]
    x_norm = torch.linalg.norm(db_aug, dim=1)
    if n_tables * cap < db_aug.shape[0]:
        cand = index.candidates(hf)  # (t, L·cap), table by table
        y, first = index.score_candidates(hf, cand)
        x_c = x_norm[torch.clamp(cand, min=0).long()]
        w = y - log_collision_prob(y, q_norm, x_c, n_bits, min_bit_prob)
        w = torch.where(cand >= 0, torch.gather(w, 1, first),
                        torch.full_like(w, -math.inf))
        log_zt = torch.logsumexp(w.reshape(t, n_tables, cap), dim=2).T
    else:
        y = hf @ db_aug[:, :-1].T  # (t, n): h·x, the augmented term is 0
        w_row = y - log_collision_prob(y, q_norm, x_norm[None, :], n_bits,
                                       min_bit_prob)  # (t, n) log(e^y / q1)
        del y
        codes = query_codes(index.proj, hf)  # (L, t)
        chunk = max(1, _LSH_CHUNK_BYTES // max(1, t * cap * 16))
        parts = []
        for l0 in range(0, n_tables, chunk):
            tabs = torch.arange(l0, min(l0 + chunk, n_tables),
                                device=hf.device)
            cand = index.table_ids[tabs[:, None], codes[tabs]]  # (c, t, cap)
            w = torch.gather(w_row[None].expand(len(tabs), -1, -1), 2,
                             torch.clamp(cand, min=0).long())
            w = torch.where(cand >= 0, w, torch.full_like(w, -math.inf))
            parts.append(torch.logsumexp(w, dim=2))  # (c, t)
        log_zt = torch.cat(parts, dim=0)  # (L, t)
    if per_table:
        return log_zt.T
    return torch.logsumexp(log_zt, dim=0) - math.log(n_tables)


def exact_logz(emb: torch.Tensor, h: torch.Tensor, n_valid=None
               ) -> torch.Tensor:
    """Dense per-token logsumexp over the valid rows (baseline)."""
    scores = (h @ emb.T).float()
    if n_valid is not None:
        ok = torch.arange(emb.shape[0], device=emb.device) < n_valid
        scores = torch.where(ok[None, :], scores,
                             torch.full_like(scores, _NEG_INF))
    return torch.logsumexp(scores, dim=-1)


def target_partial(emb: torch.Tensor, h: torch.Tensor, targets: torch.Tensor,
                   n_valid=None) -> torch.Tensor:
    """Target logit for owned targets, 0 elsewhere (t,)."""
    nv = emb.shape[0] if n_valid is None else n_valid
    inside = (targets >= 0) & (targets < nv)
    rows = torch.nn.functional.embedding(  # repeatable backward, as above
        torch.clamp(targets, 0, emb.shape[0] - 1), emb)
    y = torch.einsum("td,td->t", rows, h).float()
    return torch.where(inside, y, torch.zeros_like(y))


def loss_partials(emb: torch.Tensor, h: torch.Tensor, targets: torch.Tensor,
                  *, mode: str, k: int, l: int, index: Any = None,
                  n_valid=None, score_dtype=torch.float32,
                  use_kernel: bool = False, keys: torch.Tensor | None = None,
                  draws: torch.Tensor | None = None) -> LossPartials:
    """Loss partials for one (t, d) token block.

    The probe runs on detached queries and outside autograd; the candidate
    scores are then RECOMPUTED through the differentiable gather (or the
    kernel), so ∇(emb, h) flows through both strata (the Algorithm-4
    gradient), robust to stale index values."""
    emb_s = emb.to(score_dtype)
    h_s = h.to(score_dtype)
    targets = targets.long()
    if mode == "exact":
        return LossPartials(exact_logz(emb_s, h_s, n_valid),
                            target_partial(emb_s, h_s, targets, n_valid))
    with torch.no_grad():
        topk = topk_probe(emb_s.detach(), h_s.detach(), k, index=index,
                          n_valid=n_valid)
        if mode == "topk_only":
            ids, log_w = topk_only_candidates(topk, targets)
        else:  # amortized
            if keys is None and draws is None:
                raise ValueError("the amortized head needs keys or draws")
            n = emb.shape[0] if n_valid is None else n_valid
            ids, log_w = amortized_candidates(topk, n, l, keys=keys,
                                              draws=draws)
    log_z = stratified_logz(emb_s, h_s, ids, log_w, use_kernel=use_kernel)
    return LossPartials(log_z, target_partial(emb_s, h_s, targets, n_valid))


def combine_loss(p: LossPartials, mode: str
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """One-shard combine -> (per-token NLL, log Ẑ diagnostics)."""
    if mode == "topk_only":
        log_z = torch.logaddexp(p.log_z, p.y_t)  # target counted exactly once
    else:
        log_z = p.log_z
    return log_z - p.y_t, log_z


def combine_loss_psum(p: LossPartials, mode: str, axis: coll.Axis
                      ) -> torch.Tensor:
    """Cross-shard combine -> per-token NLL (T,), the same on every rank
    of ``axis``. The global ``log Ẑ`` is the logsumexp over shards of the
    local stratified partials (the stratified sum of per-shard Algorithm-3
    estimators, still unbiased in Z), and the target logit enters through a
    masked sum (exactly one shard owns it). The max is a detached
    stabiliser, as the reference's ``stop_gradient``; the sums are
    :func:`repro_torch.collectives.reduce_from`, whose backward passes the
    (replicated) upstream gradient to each shard's partial."""
    y_t_g = coll.reduce_from(p.y_t, axis)
    if mode == "topk_only":
        m = torch.maximum(coll.pmax(p.log_z.detach(), axis), y_t_g.detach())
        z = (coll.reduce_from(torch.exp(p.log_z - m), axis)
             + torch.exp(y_t_g - m))
        return m + torch.log(z) - y_t_g
    m = coll.pmax(p.log_z.detach(), axis)
    lse_g = m + torch.log(coll.reduce_from(torch.exp(p.log_z - m), axis))
    return lse_g - y_t_g


def combine_sample_pmax(gid: torch.Tensor, val: torch.Tensor,
                        bound: torch.Tensor, ok: torch.Tensor,
                        axis: coll.Axis) -> tuple[torch.Tensor, torch.Tensor]:
    """The global argmax of the per-shard lazy-Gumbel maxima is an exact
    global sample -> (global id (T,) int64, ok (T,) bool). It is certified
    iff the winner clears every shard's bound and no shard's tail buffer
    overflowed: ``ok`` is the min over shards of ``ok & (vmax >= bound)``.
    Ties go to the smaller global id."""
    vmax = coll.pmax(val, axis)
    cand = torch.where(val >= vmax, gid.long(),
                       torch.full_like(gid, 2 ** 30, dtype=torch.int64))
    gid_win = coll.pmin(cand, axis)
    ok_g = coll.pmin((ok & (vmax >= bound)).to(torch.int32), axis).bool()
    return gid_win, ok_g


# --------------------------------------------------------------------------
# token chunking
# --------------------------------------------------------------------------
def chunked_map(fn, chunk: int, *arrays):
    """``fn`` over token chunks of ``arrays`` (leading dim t; None entries
    pass through as None), each chunk under non-reentrant
    ``torch.utils.checkpoint``: the (chunk, k+l, d) candidate work is
    recomputed in the backward pass, so peak activation memory is
    O(chunk · (k+l) · d) whatever the sequence length. The last chunk is
    zero-padded to full size, as the reference pads it, and the padding is
    stripped from the result. ``fn(*chunk_arrays)`` returns a tuple (or
    NamedTuple) of (chunk, ...) tensors; the result is the same structure
    with leading dim t.

    Where the reference splits one key per chunk, the port's randomness is
    per token (``keys`` / ``draws`` rows chunked like the data), so a
    token's draws do not depend on the chunk size."""
    t = next(a for a in arrays if a is not None).shape[0]
    ch = min(chunk, max(1, t))
    nck = -(-t // ch)
    pad = nck * ch - t
    outs = []
    for c in range(nck):
        part = []
        for a in arrays:
            if a is None:
                part.append(None)
                continue
            a = a[c * ch:(c + 1) * ch]
            if a.shape[0] < ch:
                a = torch.cat([a, a.new_zeros((pad,) + a.shape[1:])])
            part.append(a)
        outs.append(checkpoint(fn, *part, use_reentrant=False,
                               preserve_rng_state=False))
    first = outs[0]
    joined = [torch.cat([o[i] for o in outs])[:t] for i in range(len(first))]
    return type(first)(*joined) if hasattr(first, "_fields") else tuple(joined)
