"""The fused decode head: ``ivf_screen_select`` and ``tail_gather_argmax``,
CUDA kernels for Hopper (``csrc/decode_fused.cu``; counterpart of
``repro/kernels/decode_fused.py``).

* :func:`ivf_screen_select` — IVF gather-score of the probed clusters and
  the top-k of the pool ∪ overflow, the pool held in shared memory. Members
  are scored by the device function ``ivf_gather_score`` uses, so its
  values are bitwise that kernel's.
* :func:`tail_gather_argmax` — the Algorithm-2 finish: tail rows gathered
  and scored against h, perturbed by the truncated-Gumbel heights, and the
  first-occurrence argmax over S ∪ tail.

Their plain versions are ``ref.ivf_screen_select_ref`` and
``ref.tail_gather_argmax_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ivf_gather_score import check_tables

__all__ = ["ivf_screen_select", "tail_gather_argmax", "launches"]

launches = {"ivf_screen_select": 0, "tail_gather_argmax": 0}

_SMEM_LIMIT = 232_448  # bytes of shared memory one H100 block may use


def _cuda(name: str, *ts):
    for t in ts:
        if t is not None and not t.is_cuda:
            raise ValueError(f"{name} kernel needs CUDA tensors")


def ivf_screen_select(member_vecs, member_ids, overflow_scores, overflow_ids,
                      probe, q, *, k: int, probe_width=None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel -> (values (b, k) f32, ids (b, k) i32)."""
    member_vecs, member_ids, probe, q = check_tables(
        member_vecs, member_ids, probe, q, "ivf_screen_select")
    n_c, cap, d = member_vecs.shape
    b, n_probe = probe.shape
    o_cap = overflow_ids.shape[0]
    if overflow_scores.shape != (b, o_cap) or overflow_ids.dim() != 1:
        raise ValueError(f"ivf_screen_select: overflow_scores "
                         f"{tuple(overflow_scores.shape)} / overflow_ids "
                         f"{tuple(overflow_ids.shape)} mismatch")
    if probe_width is not None and probe_width.shape != (b,):
        raise ValueError("ivf_screen_select: probe_width must be (b,)")
    _cuda("ivf_screen_select", overflow_scores, overflow_ids, probe_width)
    pool_pow2 = 1
    while pool_pow2 < max(n_probe * cap + o_cap, k):
        pool_pow2 *= 2
    fn_smem = build.bind("decode_fused", "ivf_screen_select_smem",
                         [build.I, build.I], restype=ctypes.c_longlong)
    if fn_smem(d, pool_pow2) > _SMEM_LIMIT:
        raise ValueError(f"ivf_screen_select: pool of {pool_pow2} slots at "
                         f"d={d} exceeds one block's shared memory")
    overflow_scores = overflow_scores.to(torch.float32).contiguous()
    overflow_ids = overflow_ids.to(torch.int32).contiguous()
    if probe_width is not None:
        probe_width = probe_width.to(torch.int32).contiguous()
    vals = torch.empty((b, k), dtype=torch.float32, device=q.device)
    ids = torch.empty((b, k), dtype=torch.int32, device=q.device)
    fn = build.bind("decode_fused", "ivf_screen_select_launch",
                    [build.P] * 9 + [build.I] * 8 + [build.P])
    err = fn(build.ptr(member_vecs), build.ptr(member_ids),
             build.ptr(overflow_scores), build.ptr(overflow_ids),
             build.ptr(probe), build.ptr(probe_width), build.ptr(q),
             build.ptr(vals), build.ptr(ids), n_c, cap, d, b, n_probe, o_cap,
             k, pool_pow2, build.stream())
    build.check(err, "ivf_screen_select")
    launches["ivf_screen_select"] += 1
    return vals, ids


def tail_gather_argmax(emb, pos, m_used, pert_s, s_ids, heights, h
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel -> (index (t,) i32, max_val (t,) f32)."""
    n, d = emb.shape
    t, m_cap = pos.shape
    k = pert_s.shape[1]
    if (heights.shape != (t, m_cap) or m_used.shape != (t,)
            or pert_s.shape != (t, k) or s_ids.shape != (t, k)
            or h.shape != (t, d)):
        raise ValueError("tail_gather_argmax: inconsistent shapes")
    if emb.dtype != torch.float32 or h.dtype != torch.float32:
        raise ValueError("tail_gather_argmax: emb and h must be float32")
    _cuda("tail_gather_argmax", emb, pos, m_used, pert_s, s_ids, heights, h)
    emb = emb.contiguous()
    if emb.data_ptr() % 16:
        raise ValueError("tail_gather_argmax: emb must be 16-byte aligned")
    if 4 * (((d + 3) & ~3) + m_cap + 64) > _SMEM_LIMIT:
        raise ValueError("tail_gather_argmax: d + m_cap exceed shared memory")
    args = [emb, pos.to(torch.int32).contiguous(),
            m_used.to(torch.int32).contiguous(),
            pert_s.to(torch.float32).contiguous(),
            s_ids.to(torch.int32).contiguous(),
            heights.to(torch.float32).contiguous(), h.contiguous()]
    idx = torch.empty((t,), dtype=torch.int32, device=h.device)
    max_val = torch.empty((t,), dtype=torch.float32, device=h.device)
    fn = build.bind("decode_fused", "tail_gather_argmax_launch",
                    [build.P] * 9 + [build.I] * 5 + [build.P])
    err = fn(*(build.ptr(a) for a in args), build.ptr(idx),
             build.ptr(max_val), n, d, t, m_cap, k, build.stream())
    build.check(err, "tail_gather_argmax")
    launches["tail_gather_argmax"] += 1
    return idx, max_val
