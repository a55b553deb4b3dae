"""Kernel dispatch by tensor device (counterpart of ``repro/kernels/ops.py``).

A CPU tensor goes to the kernel's plain version in :mod:`.ref`; a CUDA
tensor goes to the kernel, which launches or raises. There is no fallback
from one to the other: a build or launch failure on the card propagates.
Each kernel wrapper keeps a plain integer count of its launches
(:func:`launch_counts`), so a run can show that the serving and training
paths went through the kernels.

A meta tensor (the cost model's dry run, :mod:`repro_torch.launch
.cost_model`) gets outputs of the kernel's shapes and dtypes on the meta
device and nothing runs: neither the kernel nor its plain version, whose
arithmetic is not the kernel's. Each op charges the kernel's count
(:mod:`repro_torch.kernels.cost`) to the active recorder
(:mod:`repro_torch.cost_hook`), on meta as on
CUDA tensors, so a traced step on the card and its meta trace record the
same work. CPU calls charge nothing: the plain versions are not the
kernels.
"""
from __future__ import annotations

import torch

from repro_torch import cost_hook
from repro_torch.kernels import cost
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
    "kernel_route",
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


def kernel_route(t: torch.Tensor) -> bool:
    """Whether a call on ``t`` takes the kernel's route: CUDA tensors, and
    meta tensors, which stand in for them in the cost model's trace."""
    return t.is_cuda or t.is_meta


def _route(t: torch.Tensor, name: str) -> str:
    if t.is_cuda:
        return "cuda"
    if t.is_meta:
        return "meta"
    if t.device.type == "cpu":
        return "cpu"
    raise ValueError(f"{name}: no kernel or plain version for device {t.device}")


def _meta(*shapes_dtypes):
    """Empty meta tensors of the kernel's output (shape, dtype)s."""
    out = tuple(torch.empty(s, dtype=d, device="meta")
                for s, d in shapes_dtypes)
    return out if len(out) > 1 else out[0]


_F32, _I32 = torch.float32, torch.int32


def flash_decode(q, k_cache, v_cache, lengths, pages=None, *,
                 return_lse: bool = False):
    """(B,Hq,hd), (B,S,Hkv,hd) x2, (B,) -> (B,Hq,hd) f32; with ``pages``
    (B,n_pages) the caches are the paged pool (n_pool,block_len,Hkv,hd).
    ``return_lse`` (dense ring only): ``(o, lse)``, lse (B,Hq) f32 the log
    of Σ exp(scaled score) over each row's live positions; a row of length
    0 gives o = 0 and lse = -inf (the default call keeps the reference's
    all-masked semantics there)."""
    if return_lse and pages is not None:
        raise ValueError("flash_decode: return_lse takes the dense ring only")
    route = _route(q, "flash_decode")
    name = "flash_decode" if pages is None else "flash_decode_paged"
    if route == "cpu":
        if return_lse:
            return ref.flash_decode_lse_ref(q, k_cache, v_cache, lengths)
        if pages is None:
            return ref.flash_decode_ref(q, k_cache, v_cache, lengths)
        return ref.flash_decode_paged_ref(q, k_cache, v_cache, lengths, pages)
    with cost_hook.kernel(name, cost.flash_decode, q, k_cache, lengths,
                     pages=pages, lse=return_lse):
        if route == "meta":
            b, hq, hd = q.shape
            if return_lse:
                return _meta(((b, hq, hd), _F32), ((b, hq), _F32))
            return _meta(((b, hq, hd), _F32))
        return _fd.flash_decode(q, k_cache, v_cache, lengths, pages=pages,
                                return_lse=return_lse)


def ivf_gather_score(member_vecs, member_ids, probe, q
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (scores (b, np*cap), ids (b, np*cap)) for the IVF probe."""
    b = probe.shape[0]
    route = _route(q, "ivf_gather_score")
    if route == "cpu":
        scores, ids = ref.ivf_gather_score_ref(member_vecs, member_ids, probe,
                                               q)
        return scores.reshape(b, -1), ids.reshape(b, -1)
    with cost_hook.kernel("ivf_gather_score", cost.ivf_gather_score, member_vecs,
                     member_ids, probe, q):
        if route == "meta":
            n = probe.shape[1] * member_vecs.shape[1]
            return _meta(((b, n), _F32), ((b, n), _I32))
        scores, ids = _igs.ivf_gather_score(member_vecs, member_ids, probe, q)
        return scores.reshape(b, -1), ids.reshape(b, -1)


def ivf_screen_select(member_vecs, member_ids, overflow_scores, overflow_ids,
                      probe, q, *, k: int, probe_width=None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused IVF gather-score + pool top-k -> (values (b,k), ids (b,k))."""
    args = (member_vecs, member_ids, overflow_scores, overflow_ids, probe, q)
    route = _route(q, "ivf_screen_select")
    if route == "cpu":
        return ref.ivf_screen_select_ref(*args, k, probe_width=probe_width)
    with cost_hook.kernel("ivf_screen_select", cost.ivf_screen_select, *args, k):
        if route == "meta":
            return _meta(((q.shape[0], k), _F32), ((q.shape[0], k), _I32))
        return _df.ivf_screen_select(*args, k=k, probe_width=probe_width)


def pq_lut_score(member_codes, probe, lut) -> torch.Tensor:
    """IVF-PQ LUT screen of the probed clusters -> (b, n_probe, cap) f32."""
    route = _route(lut, "pq_lut_score")
    if route == "cpu":
        return ref.pq_lut_score_ref(member_codes, probe, lut)
    with cost_hook.kernel("pq_lut_score", cost.pq_lut_score, member_codes, probe,
                     lut):
        if route == "meta":
            return _meta((tuple(probe.shape) + (member_codes.shape[1],),
                          _F32))
        return _pls.pq_lut_score(member_codes, probe, lut)


def pq_screen_select(member_codes, member_ids, coarse, overflow_scores,
                     overflow_ids, probe, lut, *, r: int, probe_width=None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused IVF-PQ LUT screen + pool top-r -> (values (b,r), ids (b,r))."""
    args = (member_codes, member_ids, coarse, overflow_scores, overflow_ids,
            probe, lut)
    route = _route(lut, "pq_screen_select")
    if route == "cpu":
        return ref.pq_screen_select_ref(*args, r, probe_width=probe_width)
    with cost_hook.kernel("pq_screen_select", cost.pq_screen_select, *args, r):
        if route == "meta":
            return _meta(((lut.shape[0], r), _F32), ((lut.shape[0], r), _I32))
        return _df.pq_screen_select(*args, r=r, probe_width=probe_width)


def rerank_select(db, cand, lut_vals, q, *, k: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact re-rank of the screening survivors + top-k -> (values (b,k),
    ids (b,k))."""
    route = _route(q, "rerank_select")
    if route == "cpu":
        return ref.rerank_select_ref(db, cand, lut_vals, q, k)
    with cost_hook.kernel("rerank_select", cost.rerank_select, db, cand, lut_vals,
                     q, k):
        if route == "meta":
            return _meta(((q.shape[0], k), _F32), ((q.shape[0], k), _I32))
        return _df.rerank_select(db, cand, lut_vals, q, k=k)


def tail_gather_argmax(emb, pos, m_used, pert_s, s_ids, heights, h
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused lazy-Gumbel tail gather + argmax -> (index (t,), max_val (t,))."""
    args = (emb, pos, m_used, pert_s, s_ids, heights, h)
    route = _route(h, "tail_gather_argmax")
    if route == "cpu":
        return ref.tail_gather_argmax_ref(*args)
    with cost_hook.kernel("tail_gather_argmax", cost.tail_gather_argmax, *args):
        if route == "meta":
            t = h.shape[0]
            return _meta(((t,), _I32), ((t,), _F32))
        return _df.tail_gather_argmax(*args)


def fused_estimator(emb, ids, h, log_w, *, return_y: bool = False):
    """Alg-3/4 stratified estimator -> (log_z (t,), expv (t, d)), and with
    ``return_y`` the scores y (t, m) as a third output."""
    route = _route(h, "fused_estimator")
    if route == "cpu":
        return ref.fused_estimator_ref(emb, ids, h, log_w, return_y=return_y)
    with cost_hook.kernel("fused_estimator", cost.fused_estimator, emb, ids, h,
                     log_w, return_y=return_y):
        if route == "meta":
            (t, m), d = ids.shape, emb.shape[1]
            outs = [((t,), _F32), ((t, d), _F32)]
            return _meta(*outs, *([((t, m), _F32)] if return_y else []))
        return _fe.fused_estimator(emb, ids, h, log_w, return_y=return_y)


def fused_estimator_bwd(emb, ids, h, log_w, log_z, g, *, y=None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Its backward for upstream ``g`` (t,) -> (d_emb (n, d), p (t, m)),
    from the forward's scores ``y`` where given."""
    route = _route(h, "fused_estimator_bwd")
    if route == "cpu":
        return ref.fused_estimator_bwd_ref(emb, ids, h, log_w, log_z, g, y=y)
    with cost_hook.kernel("fused_estimator_bwd", cost.fused_estimator_bwd, emb,
                     ids, h, log_w, log_z, g, y=y):
        if route == "meta":
            return _meta((tuple(emb.shape), _F32), (tuple(ids.shape), _F32))
        return _fe.fused_estimator_bwd(emb, ids, h, log_w, log_z, g, y=y)
