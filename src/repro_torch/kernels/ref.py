"""Plain-PyTorch versions of the port's kernels (counterpart of
``repro/kernels/ref.py``).

The CPU runs these in place of the kernels (``kernels/ops.py`` dispatches
by tensor device); on the card ``chip_smoke.py`` holds each kernel against
its plain version on the same inputs.

Top-k convention shared by every selection here and in the kernels:
descending values, the lower pool index first among equal values (what
``jax.lax.top_k`` does), pools narrower than k padded with (-inf, -1), and
an id of -1 for every -inf pick.
"""
from __future__ import annotations

import torch

from repro_torch.core.quant.pq import lut_scores

__all__ = [
    "flash_decode_ref",
    "flash_decode_paged_ref",
    "flash_decode_lse_ref",
    "ivf_gather_score_ref",
    "pq_lut_score_ref",
    "topk_select_ref",
    "ivf_screen_select_ref",
    "pq_screen_select_ref",
    "rerank_select_ref",
    "tail_gather_argmax_ref",
    "fused_estimator_ref",
    "fused_estimator_bwd_ref",
    "popular_rows_ref",
]


def flash_decode_ref(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor
                     ) -> torch.Tensor:
    """(B,Hq,hd), (B,S,Hkv,hd) x2, (B,) -> (B,Hq,hd) f32. Positions at or
    past ``lengths[b]`` are masked with -1e30."""
    b, hq, hd = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    qf = q.float()
    kf = k_cache.float().repeat_interleave(g, dim=2)  # (B, S, Hq, hd)
    vf = v_cache.float().repeat_interleave(g, dim=2)
    scores = torch.einsum("bhd,bshd->bhs", qf, kf) / (hd ** 0.5)
    pos = torch.arange(s, device=q.device)
    mask = pos[None, None, :] < lengths.to(q.device)[:, None, None]
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhs,bshd->bhd", p, vf)


def flash_decode_lse_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, lengths: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """``flash_decode(..., return_lse=True)``: (B,Hq,hd), (B,S,Hkv,hd) x2,
    (B,) -> (o (B,Hq,hd) f32, lse (B,Hq) f32), lse the natural log of
    Σ exp(q·k / √hd) over the positions below ``lengths[b]``. A row with
    no live position weighs nothing: o = 0 and lse = -inf (where the
    default call's -1e30 mask would average every position)."""
    b, hq, hd = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    qf = q.float()
    kf = k_cache.float().repeat_interleave(g, dim=2)  # (B, S, Hq, hd)
    vf = v_cache.float().repeat_interleave(g, dim=2)
    scores = torch.einsum("bhd,bshd->bhs", qf, kf) / (hd ** 0.5)
    pos = torch.arange(s, device=q.device)
    mask = pos[None, None, :] < lengths.to(q.device)[:, None, None]
    scores = torch.where(mask, scores, torch.full_like(scores, float("-inf")))
    lse = torch.logsumexp(scores, dim=-1)  # -inf on an empty row
    p = torch.exp(scores - torch.where(torch.isinf(lse), 0.0, lse)[..., None])
    return torch.einsum("bhs,bshd->bhd", p, vf), lse


def flash_decode_paged_ref(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, lengths: torch.Tensor,
                           pages: torch.Tensor) -> torch.Tensor:
    """The paged layout: (B,Hq,hd), (n_pool,block_len,Hkv,hd) x2, (B,),
    (B,n_pages) -> (B,Hq,hd) f32. Gathers each sequence's ring view through
    its page table (page ids clamped into the pool, as the reference's
    gather clamps its sentinel) and attends over it with
    :func:`flash_decode_ref`."""
    b, n_pages = pages.shape
    block_len = k_pool.shape[1]
    idx = torch.clamp(pages.long(), 0, k_pool.shape[0] - 1)
    shape = (b, n_pages * block_len) + k_pool.shape[2:]
    return flash_decode_ref(q, k_pool[idx].reshape(shape),
                            v_pool[idx].reshape(shape), lengths)


def ivf_gather_score_ref(member_vecs: torch.Tensor, member_ids: torch.Tensor,
                         probe: torch.Tensor, q: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """(n_c,cap,d), (n_c,cap), (b,np), (b,d) -> (scores, ids), both
    (b, np, cap): ``member_vecs[probe] · q`` and ``member_ids[probe]``."""
    probe = probe.long()
    gathered = member_vecs[probe].float()  # (b, np, cap, d)
    scores = torch.einsum("bpcd,bd->bpc", gathered, q.float())
    return scores, member_ids[probe].int()


def pq_lut_score_ref(member_codes: torch.Tensor, probe: torch.Tensor,
                     lut: torch.Tensor) -> torch.Tensor:
    """(n_c,cap,m) u8, (b,np), (b,m,ksub) -> (b, np, cap) f32 LUT sums of
    the probed members' codes, added in subspace order from 0.0
    (:func:`repro_torch.core.quant.pq.lut_scores`)."""
    b, n_probe = probe.shape
    cap, m = member_codes.shape[1:]
    codes = member_codes[probe.long()].reshape(b, n_probe * cap, m)
    return lut_scores(lut, codes).reshape(b, n_probe, cap)


def _probe_prefix(scores, ids, probe_width):
    """(b, np, cap) scores / ids with the stages at or past each row's
    ``probe_width`` dead (-inf, -1); None keeps every stage."""
    if probe_width is None:
        return scores, ids
    stage = torch.arange(scores.shape[1], device=scores.device)
    live = stage[None, :, None] < probe_width.to(scores.device)[:, None, None]
    return (torch.where(live, scores, torch.full_like(scores, float("-inf"))),
            torch.where(live, ids, torch.full_like(ids, -1)))


def _pool_select(scores, ids, overflow_scores, overflow_ids, k: int):
    """Top-k of the probed pool (b, np, cap) ∪ the overflow (b, o_cap), dead
    ids (< 0) at -inf."""
    b = scores.shape[0]
    scores = torch.cat([scores.reshape(b, -1), overflow_scores.float()], dim=1)
    o = overflow_ids.int()[None].expand(b, overflow_ids.shape[0])
    ids = torch.cat([ids.reshape(b, -1), o], dim=1)
    scores = torch.where(ids >= 0, scores, torch.full_like(scores, float("-inf")))
    return topk_select_ref(scores, ids, k)


def topk_select_ref(scores: torch.Tensor, ids: torch.Tensor, k: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k of a masked (b, pool) score/id pair under the module's
    convention -> (values (b,k) f32, ids (b,k) i32)."""
    b, pool = scores.shape
    if pool < k:
        pad = k - pool
        scores = torch.cat([scores, scores.new_full((b, pad), float("-inf"))],
                           dim=1)
        ids = torch.cat([ids, ids.new_full((b, pad), -1)], dim=1)
    vals, pos = torch.sort(scores, dim=1, descending=True, stable=True)
    vals, pos = vals[:, :k], pos[:, :k]
    out_ids = torch.gather(ids, 1, pos)
    out_ids = torch.where(torch.isneginf(vals), torch.full_like(out_ids, -1),
                          out_ids)
    return vals, out_ids.int()


def ivf_screen_select_ref(member_vecs, member_ids, overflow_scores,
                          overflow_ids, probe, q, k: int, probe_width=None
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """(n_c,cap,d), (n_c,cap), (b,o_cap), (o_cap,), (b,np), (b,d) -> top-k
    (values (b,k), ids (b,k)) of the probed pool ∪ overflow. Row i scores
    only its first ``probe_width[i]`` probes (None: all of them)."""
    scores, ids = _probe_prefix(
        *ivf_gather_score_ref(member_vecs, member_ids, probe, q), probe_width)
    return _pool_select(scores, ids, overflow_scores, overflow_ids, k)


def pq_screen_select_ref(member_codes, member_ids, coarse, overflow_scores,
                         overflow_ids, probe, lut, r: int, probe_width=None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """(n_c,cap,m) u8, (n_c,cap), (b,np), (b,o_cap), (o_cap,), (b,np),
    (b,m,ksub) -> top-r (values (b,r), ids (b,r)) of the LUT screen: each
    probed member scores its LUT sum plus its cluster's ``coarse`` term
    (``acc + coarse``, in that order), the overflow rows their exact
    ``overflow_scores``. Row i screens only its first ``probe_width[i]``
    probes (None: all of them)."""
    scores = (pq_lut_score_ref(member_codes, probe, lut)
              + coarse.float()[..., None])
    ids = member_ids[probe.long()].int()
    scores, ids = _probe_prefix(scores, ids, probe_width)
    return _pool_select(scores, ids, overflow_scores, overflow_ids, r)


def rerank_select_ref(db, cand, lut_vals, q, k: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """(n,d), (b,r), (b,r), (b,d) -> top-k (values (b,k), ids (b,k)) of the
    screening survivors re-scored exactly in fp32 (``db[cand] · q``); a
    survivor with id < 0 or screening value -inf is dead (-inf)."""
    rows = db[torch.clamp(cand.long(), 0, db.shape[0] - 1)].float()
    exact = torch.einsum("brd,bd->br", rows, q.float())
    dead = (cand < 0) | torch.isneginf(lut_vals)
    return topk_select_ref(
        torch.where(dead, torch.full_like(exact, float("-inf")), exact),
        cand.int(), k)


def tail_gather_argmax_ref(emb, pos, m_used, pert_s, s_ids, heights, h
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Algorithm-2 finish: perturbed argmax over S ∪ tail per token ->
    (index (t,) i32, max_val (t,) f32). The first maximal slot wins."""
    m_cap = pos.shape[1]
    rows = emb[pos.long()].float()  # (t, m_cap, d)
    y_tail = torch.einsum("tmd,td->tm", rows, h.float())
    live = (torch.arange(m_cap, device=pos.device)[None, :]
            < m_used.to(pos.device)[:, None])
    pert_t = torch.where(live, y_tail + heights.float(),
                         torch.full_like(y_tail, float("-inf")))
    pert = torch.cat([pert_s.float(), pert_t], dim=1)
    ids = torch.cat([s_ids.int(), pos.int()], dim=1)
    best = torch.argmax(pert, dim=1, keepdim=True)
    return (torch.gather(ids, 1, best)[:, 0],
            torch.gather(pert, 1, best)[:, 0])


def fused_estimator_ref(emb, ids, h, log_w, return_y: bool = False):
    """Stratified logsumexp + weighted expectation (Algorithms 3 + 4):
    (n,d), (t,m), (t,d), (t,m) -> (log_z (t,) f32, expv (t,d) f32), and
    with ``return_y`` the scores y (t,m) f32 too. Rows upcast to fp32; an
    all-dead token (every log_w -inf) gives log_z -inf and expv NaN, as the
    kernel and the Pallas kernel do."""
    rows = emb[ids.long()].float()  # (t, m, d)
    y = torch.einsum("tmd,td->tm", rows, h.float()) + log_w.float()
    log_z = torch.logsumexp(y, dim=1)
    p = torch.exp(y - log_z[:, None])
    expv = torch.einsum("tm,tmd->td", p, rows)
    return (log_z, expv, y) if return_y else (log_z, expv)


def fused_estimator_bwd_ref(emb, ids, h, log_w, log_z, g, y=None
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Backward of :func:`fused_estimator_ref`'s log_z for an upstream
    gradient ``g`` (t,), as the reference's custom VJP computes it
    (``repro/core/estimators.py::_fused_logz_bwd``): ``p = exp(y - log_z)
    · g`` and ``d_emb`` the scatter-add of ``p · h``. The scores ``y`` come
    from the forward (``return_y=True``) or, without them, from the
    candidate rows gathered again. -> (d_emb (n, d) f32, p (t, m) f32)."""
    hf = h.float()
    if y is None:
        rows = emb[ids.long()].float()
        y = torch.einsum("tmd,td->tm", rows, hf) + log_w.float()
    p = torch.exp(y - log_z.float()[:, None]) * g.float()[:, None]
    contrib = (p[..., None] * hf[:, None, :]).reshape(-1, hf.shape[1])
    d_emb = torch.zeros(emb.shape, dtype=torch.float32, device=emb.device)
    d_emb.index_add_(0, ids.long().reshape(-1), contrib)
    return d_emb, p


def popular_rows_ref(ids, log_w, n: int, uses: int, cap: int
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plan of the kernel forward: the rows of an (n, ·) table named by
    at least ``uses`` live slots (log_w > -inf) of (t, m) ids (clamped to
    [0, n), as the kernel's are), the first ``cap`` of them in row order ->
    (colmap (n,) i32: each row's column, or -1; rows (n_u,) i32; n_u (1,)
    i32)."""
    live = log_w != float("-inf")
    flat = ids.long().clamp(0, n - 1)[live]
    counts = torch.bincount(flat, minlength=n)
    popular = counts >= uses
    col = torch.cumsum(popular.long(), 0) - 1
    keep = popular & (col < cap)
    colmap = torch.where(keep, col, torch.full_like(col, -1)).int()
    rows = torch.nonzero(keep)[:, 0].int()
    return colmap, rows, torch.tensor([rows.numel()], dtype=torch.int32,
                                      device=ids.device)
