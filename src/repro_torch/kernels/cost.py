"""The work of each hand-written kernel: the bytes it must move (each
input read once, each output written once) and the operations it does,
as functions of its inputs' shapes and dtypes.

One count serves two readers: ``chip_smoke.py`` divides it by the card's
peaks for each kernel's bound, and the cost model
(:mod:`repro_torch.launch.cost_model`) charges it for every call, on the
card as on the meta device, where :mod:`repro_torch.kernels.ops` returns
outputs of the kernel's shapes and runs nothing. A launch through ctypes is
invisible to a dispatch mode, so the op reports its own count
(:mod:`repro_torch.cost_hook`).

Where the work depends on the data (the live ring rows, the distinct
probed clusters, the live candidates), the caller may pass this run's
figure as a keyword; without it the count is the most the shapes allow:
every row live, every probed cluster distinct. Nothing reads a device
value here, so a count on meta tensors is the count on CUDA tensors of the
same shapes. The ops of :mod:`repro_torch.kernels.ops` pass none of these
keywords (they read no device value either), so the count of a traced
step — the dry run's, ``chip_smoke.py``'s ``[cost]`` phase's — is an
upper bound for these kernels: ``flash_decode`` charged every ring row,
the screens every probed cluster as distinct and full. A caller that
knows the live figures on the host recounts with them.

``dtype`` names the peak the operations run at: ``"bf16"`` for the tensor
cores (``flash_decode`` on a bf16 ring), ``"fp32"`` otherwise.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["Cost", "nbytes", "flash_decode", "ivf_gather_score",
           "ivf_screen_select", "pq_lut_score", "pq_screen_select",
           "rerank_select", "tail_gather_argmax", "fused_estimator",
           "fused_estimator_bwd"]


class Cost(NamedTuple):
    bytes: float
    flops: float
    dtype: str  # "bf16" | "fp32": the peak the operations run at


def nbytes(*ts) -> int:
    """Bytes of the given tensors (None skipped)."""
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def _el(t: torch.Tensor) -> int:
    return t.element_size()


def _peak(t: torch.Tensor) -> str:
    return "bf16" if t.dtype in (torch.bfloat16, torch.float16) else "fp32"


def flash_decode(q, k_cache, lengths, *, pages=None, live=None,
                 lse: bool = False) -> Cost:
    """q (B, Hq, hd) against the ring (B, S, Hkv, hd), or the pool through
    ``pages`` (B, n_pages): q, lengths (and the page table) in, the live
    rows' K and V once, the fp32 output (and with ``lse`` the (B, Hq) fp32
    log-sum-exp) out; a 2·hd dot and a 2·hd weighted sum per (live row,
    query head). ``live``: the rows attended, Σ_b min(max(lengths_b, 1),
    S) (default B·S)."""
    b, hq, hd = q.shape
    hkv = k_cache.shape[2]
    s = k_cache.shape[1] if pages is None else pages.shape[1] * k_cache.shape[1]
    live = b * s if live is None else live
    nb = (nbytes(q, lengths, pages) + 2 * live * hkv * hd * _el(k_cache)
          + b * hq * hd * 4 + (b * hq * 4 if lse else 0))
    return Cost(nb, 4 * live * hq * hd, _peak(q))


def ivf_gather_score(member_vecs, member_ids, probe, q, *,
                     n_unique=None) -> Cost:
    """Each distinct probed tile (rows and ids) once, probe and q in, the
    (b, np, cap) scores and ids out; a 2d dot per (query, probe, member).
    ``n_unique``: distinct probed clusters (default min(n_c, b·np))."""
    n_c, cap, d = member_vecs.shape
    b, n_probe = probe.shape
    u = min(n_c, b * n_probe) if n_unique is None else n_unique
    nb = (u * cap * (d * _el(member_vecs) + _el(member_ids))
          + nbytes(probe, q) + b * n_probe * cap * 8)
    return Cost(nb, 2.0 * b * n_probe * cap * d, "fp32")


def ivf_screen_select(member_vecs, member_ids, overflow_scores, overflow_ids,
                      probe, q, k: int, *, n_unique=None, live_unique=None,
                      live_rows=None) -> Cost:
    """Each distinct probed tile's ids and live rows once, the overflow
    pair, probe and q in, the top-k (values, ids) out; a 2d dot per live
    probed member. ``n_unique``: distinct probed clusters; ``live_unique``:
    their live members; ``live_rows``: live members over (query, probe)
    (defaults: every probed cluster distinct and full)."""
    n_c, cap, d = member_vecs.shape
    b, n_probe = probe.shape
    u = min(n_c, b * n_probe) if n_unique is None else n_unique
    lu = u * cap if live_unique is None else live_unique
    lr = b * n_probe * cap if live_rows is None else live_rows
    nb = (lu * d * _el(member_vecs) + u * cap * _el(member_ids)
          + nbytes(overflow_scores, overflow_ids, probe, q) + b * k * 8)
    return Cost(nb, 2.0 * d * lr, "fp32")


def pq_lut_score(member_codes, probe, lut, *, n_unique=None) -> Cost:
    """The codes of the distinct probed tiles, probe and LUTs in; the (b,
    np, cap) fp32 sums out; m_sub adds per member. ``n_unique``: distinct
    probed clusters (default min(n_c, b·np))."""
    n_c, cap, m_sub = member_codes.shape
    b, n_probe = probe.shape
    u = min(n_c, b * n_probe) if n_unique is None else n_unique
    pool = b * n_probe * cap
    nb = u * cap * m_sub * _el(member_codes) + nbytes(probe, lut) + pool * 4
    return Cost(nb, float(pool * m_sub), "fp32")


def pq_screen_select(member_codes, member_ids, coarse, overflow_scores,
                     overflow_ids, probe, lut, r: int, *, tiles=None,
                     live_slots=None, live=None) -> Cost:
    """The ids of the probed tiles, the codes of their live members, LUTs,
    coarse, probe and the overflow pair in; the top-r (values, ids) out;
    m_sub + 1 adds per live probed member. ``tiles``: distinct probed
    clusters; ``live_slots``: their distinct live members; ``live``: live
    members over (query, probe) (defaults: all distinct and full)."""
    n_c, cap, m_sub = member_codes.shape
    b, n_probe = probe.shape
    u = min(n_c, b * n_probe) if tiles is None else tiles
    ls = u * cap if live_slots is None else live_slots
    lv = b * n_probe * cap if live is None else live
    nb = (u * cap * _el(member_ids) + ls * m_sub * _el(member_codes)
          + nbytes(lut, coarse, probe, overflow_scores, overflow_ids)
          + b * r * 8)
    return Cost(nb, float(lv * (m_sub + 1)), "fp32")


def rerank_select(db, cand, lut_vals, q, k: int, *, rows=None,
                  alive=None) -> Cost:
    """Each distinct live survivor row once, the candidates, screening
    values and q in; the top-k (values, ids) out; a 2d dot per live
    survivor. ``rows``: distinct live survivors (default min(n, b·R));
    ``alive``: live survivors (default b·R)."""
    n, d = db.shape
    b, r = cand.shape
    rows = min(n, b * r) if rows is None else rows
    alive = b * r if alive is None else alive
    nb = rows * d * _el(db) + nbytes(cand, lut_vals, q) + b * k * 8
    return Cost(nb, 2.0 * d * alive, "fp32")


def tail_gather_argmax(emb, pos, m_used, pert_s, s_ids, heights, h, *,
                       rows=None, m_total=None) -> Cost:
    """Each distinct live tail row once, the positions, counts, S-side
    values and ids, heights and h in; (index, max) out; a 2d dot per live
    tail slot. ``rows``: distinct live tail rows (default min(n, t·m_cap));
    ``m_total``: Σ m_used (default t·m_cap)."""
    n, d = emb.shape
    t, m_cap = pos.shape
    rows = min(n, t * m_cap) if rows is None else rows
    m_total = t * m_cap if m_total is None else m_total
    nb = (rows * d * _el(emb) + nbytes(pos, m_used, pert_s, s_ids, heights, h)
          + t * 8)
    return Cost(nb, 2.0 * d * m_total, "fp32")


def fused_estimator(emb, ids, h, log_w, *, return_y: bool = False,
                    rows=None, n_live=None) -> Cost:
    """Each live distinct row once, ids / log_w / h in, log_z / expv (and
    with ``return_y`` the (t, m) scores y) out; a 2d dot and a 2d weighted
    sum per live candidate. ``rows``: distinct live rows (default min(n,
    t·m)); ``n_live``: live candidates (default t·m)."""
    n, d = emb.shape
    t, m = ids.shape
    rows = min(n, t * m) if rows is None else rows
    n_live = t * m if n_live is None else n_live
    nb = (rows * d * _el(emb) + nbytes(ids, log_w, h) + t * 4 + t * d * 4
          + (t * m * 4 if return_y else 0))
    return Cost(nb, 4.0 * d * n_live, "fp32")


def fused_estimator_bwd(emb, ids, h, log_w, log_z, g, *, y=None,
                        n_live=None) -> Cost:
    """ids / y / h / log_z / g in once, the dense (n, d) d_emb and the (t,
    m) p out; p · h, a 2d fma per live candidate. ``n_live``: live
    candidates (default t·m)."""
    n, d = emb.shape
    t, m = ids.shape
    n_live = t * m if n_live is None else n_live
    nb = nbytes(ids, h, log_z, g, y) + n * d * 4 + t * m * 4
    return Cost(nb, 2.0 * d * n_live, "fp32")
