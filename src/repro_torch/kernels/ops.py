"""Kernel dispatch by tensor device (counterpart of ``repro/kernels/ops.py``).

A CPU tensor goes to the kernel's plain version in :mod:`.ref`; a CUDA
tensor goes to the kernel, which launches or raises. There is no fallback
from one to the other: a build or launch failure on the card propagates.
Each kernel wrapper keeps a plain integer count of its launches
(:func:`launch_counts`), so a run can show that the serving and training
paths went through the kernels.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import decode_fused as _df
from repro_torch.kernels import flash_decode as _fd
from repro_torch.kernels import fused_estimator as _fe
from repro_torch.kernels import ivf_gather_score as _igs
from repro_torch.kernels import pq_lut_score as _pls
from repro_torch.kernels import ref

__all__ = [
    "flash_decode",
    "ivf_gather_score",
    "ivf_screen_select",
    "pq_lut_score",
    "pq_screen_select",
    "rerank_select",
    "tail_gather_argmax",
    "fused_estimator",
    "fused_estimator_bwd",
    "launch_counts",
    "reset_launch_counts",
    "KERNELS",
]

_COUNTERS = (_fd.launches, _igs.launches, _pls.launches, _df.launches,
             _fe.launches)
KERNELS = tuple(k for c in _COUNTERS for k in c)


def launch_counts() -> dict[str, int]:
    """Kernel name -> launches since the last :func:`reset_launch_counts`."""
    return {k: v for c in _COUNTERS for k, v in c.items()}


def reset_launch_counts() -> None:
    for c in _COUNTERS:
        for k in c:
            c[k] = 0


def _on_cuda(t: torch.Tensor, name: str) -> bool:
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: no kernel or plain version for device {t.device}")


def flash_decode(q, k_cache, v_cache, lengths, pages=None) -> torch.Tensor:
    """(B,Hq,hd), (B,S,Hkv,hd) x2, (B,) -> (B,Hq,hd) f32; with ``pages``
    (B,n_pages) the caches are the paged pool (n_pool,block_len,Hkv,hd)."""
    if _on_cuda(q, "flash_decode"):
        return _fd.flash_decode(q, k_cache, v_cache, lengths, pages=pages)
    if pages is None:
        return ref.flash_decode_ref(q, k_cache, v_cache, lengths)
    return ref.flash_decode_paged_ref(q, k_cache, v_cache, lengths, pages)


def ivf_gather_score(member_vecs, member_ids, probe, q
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (scores (b, np*cap), ids (b, np*cap)) for the IVF probe."""
    b = probe.shape[0]
    if _on_cuda(q, "ivf_gather_score"):
        scores, ids = _igs.ivf_gather_score(member_vecs, member_ids, probe, q)
    else:
        scores, ids = ref.ivf_gather_score_ref(member_vecs, member_ids, probe, q)
    return scores.reshape(b, -1), ids.reshape(b, -1)


def ivf_screen_select(member_vecs, member_ids, overflow_scores, overflow_ids,
                      probe, q, *, k: int, probe_width=None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused IVF gather-score + pool top-k -> (values (b,k), ids (b,k))."""
    if _on_cuda(q, "ivf_screen_select"):
        return _df.ivf_screen_select(member_vecs, member_ids, overflow_scores,
                                     overflow_ids, probe, q, k=k,
                                     probe_width=probe_width)
    return ref.ivf_screen_select_ref(member_vecs, member_ids, overflow_scores,
                                     overflow_ids, probe, q, k,
                                     probe_width=probe_width)


def pq_lut_score(member_codes, probe, lut) -> torch.Tensor:
    """IVF-PQ LUT screen of the probed clusters -> (b, n_probe, cap) f32."""
    if _on_cuda(lut, "pq_lut_score"):
        return _pls.pq_lut_score(member_codes, probe, lut)
    return ref.pq_lut_score_ref(member_codes, probe, lut)


def pq_screen_select(member_codes, member_ids, coarse, overflow_scores,
                     overflow_ids, probe, lut, *, r: int, probe_width=None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused IVF-PQ LUT screen + pool top-r -> (values (b,r), ids (b,r))."""
    if _on_cuda(lut, "pq_screen_select"):
        return _df.pq_screen_select(member_codes, member_ids, coarse,
                                    overflow_scores, overflow_ids, probe, lut,
                                    r=r, probe_width=probe_width)
    return ref.pq_screen_select_ref(member_codes, member_ids, coarse,
                                    overflow_scores, overflow_ids, probe, lut,
                                    r, probe_width=probe_width)


def rerank_select(db, cand, lut_vals, q, *, k: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact re-rank of the screening survivors + top-k -> (values (b,k),
    ids (b,k))."""
    if _on_cuda(q, "rerank_select"):
        return _df.rerank_select(db, cand, lut_vals, q, k=k)
    return ref.rerank_select_ref(db, cand, lut_vals, q, k)


def tail_gather_argmax(emb, pos, m_used, pert_s, s_ids, heights, h
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused lazy-Gumbel tail gather + argmax -> (index (t,), max_val (t,))."""
    if _on_cuda(h, "tail_gather_argmax"):
        return _df.tail_gather_argmax(emb, pos, m_used, pert_s, s_ids,
                                      heights, h)
    return ref.tail_gather_argmax_ref(emb, pos, m_used, pert_s, s_ids,
                                      heights, h)


def fused_estimator(emb, ids, h, log_w, *, return_y: bool = False):
    """Alg-3/4 stratified estimator -> (log_z (t,), expv (t, d)), and with
    ``return_y`` the scores y (t, m) as a third output."""
    if _on_cuda(h, "fused_estimator"):
        return _fe.fused_estimator(emb, ids, h, log_w, return_y=return_y)
    return ref.fused_estimator_ref(emb, ids, h, log_w, return_y=return_y)


def fused_estimator_bwd(emb, ids, h, log_w, log_z, g, *, y=None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Its backward for upstream ``g`` (t,) -> (d_emb (n, d), p (t, m)),
    from the forward's scores ``y`` where given."""
    if _on_cuda(h, "fused_estimator_bwd"):
        return _fe.fused_estimator_bwd(emb, ids, h, log_w, log_z, g, y=y)
    return ref.fused_estimator_bwd_ref(emb, ids, h, log_w, log_z, g, y=y)
