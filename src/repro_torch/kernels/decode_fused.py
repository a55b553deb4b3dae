"""The fused decode head: ``ivf_screen_select``, ``pq_screen_select``,
``rerank_select`` and ``tail_gather_argmax``, CUDA kernels for Hopper
(``csrc/decode_fused.cu``; counterpart of ``repro/kernels/decode_fused.py``).

* :func:`ivf_screen_select` — IVF gather-score of the probed clusters and
  the top-k of the pool ∪ overflow: a score pass over the whole card (the
  cluster-major code ``ivf_gather_score`` runs, so its values are bitwise
  that kernel's) writes one sort key per member slot into a workspace that
  shares one allocation with the outputs, and a select kernel takes each
  query's first k keys by a radix select. One C call enqueues both.
* :func:`pq_screen_select` — the IVF-PQ screen: each probed member's LUT
  sum (the device function ``pq_lut_score`` uses) plus its cluster's coarse
  score, and the top-r of the pool ∪ exact overflow scores. A score kernel
  spread over (query, part of a stage) blocks writes one sort key per member
  slot into a workspace that shares one allocation with the outputs, and
  ``ivf_screen_select``'s select kernel takes each query's first r keys. One
  C call enqueues both.
* :func:`rerank_select` — the exact fp32 re-rank of the r screening
  survivors against the database rows, and their top-k: a score kernel
  spread over (query, chunk of survivors) blocks writes one sort key per
  survivor into a workspace that shares one allocation with the outputs,
  and a select kernel sorts each query's keys. One C call enqueues both.
* :func:`tail_gather_argmax` — the Algorithm-2 finish: tail rows gathered
  and scored against h, perturbed by the truncated-Gumbel heights, and the
  first-occurrence argmax over S ∪ tail. A score kernel spread over (token,
  chunk of tail slots) blocks writes each chunk's (value, index) winner into
  a workspace that shares one allocation with the outputs, and an argmax
  kernel folds each token's S values and chunk winners. One C call enqueues
  both.

Their plain versions are ``ref.ivf_screen_select_ref``,
``ref.pq_screen_select_ref``, ``ref.rerank_select_ref`` and
``ref.tail_gather_argmax_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ivf_gather_score import check_tables, workspace_ints
from repro_torch.kernels.pq_lut_score import check_codes

__all__ = ["ivf_screen_select", "pq_screen_select", "rerank_select",
           "tail_gather_argmax", "launches", "symbols",
           "rerank_workspace_ints",
           "screen_workspace_ints", "tail_workspace_ints"]

launches = {"ivf_screen_select": 0, "pq_screen_select": 0,
            "rerank_select": 0, "tail_gather_argmax": 0}
# CUDA symbols by kernel (ops.kernel_symbols): (one a call, the others)
symbols = {
    "ivf_screen_select": (("ivf_screen_topk_kernel",),
                          ("ivf_screen_score_small_kernel",
                           "ivf_screen_plan_kernel",
                           "ivf_screen_score_kernel")),
    "tail_gather_argmax": (("tail_argmax_kernel",), ("tail_score_kernel",)),
    "pq_screen_select": (("pq_screen_topk_kernel",),
                         ("pq_screen_score_kernel",)),
    "rerank_select": (("rerank_score_kernel",), ("rerank_select_kernel",)),
}

_SMEM_LIMIT = 232_448  # bytes of shared memory one H100 block may use
RERANK_ROWS = 32  # survivors one rerank_select score block takes (the
#   kernel's kRerankRows; the card tests probe r around it)
SCREEN_POOL_MAX = 16_384  # the widest pool the screens' select kernel
#   holds: 16 keys in each of its 1,024 threads' registers
PQ_ROWS = 256  # members one pq_screen_select score block takes, one a
#   thread (pq_lut.cuh's pq::kRows)
TAIL_ROWS = 32  # tail slots one tail_gather_argmax score block takes, one
#   a warp (the kernel's kTailRows; the card tests probe m_used around it)


def _cuda(name: str, *ts):
    for t in ts:
        if t is not None and not t.is_cuda:
            raise ValueError(f"{name} kernel needs CUDA tensors")


def _pow2(n: int) -> int:
    """The least power of two >= n (and >= 1)."""
    return 1 << max(n - 1, 0).bit_length()


def _check_overflow(name, overflow_scores, overflow_ids, probe_width, b):
    """Validate a screen's overflow pair and probe widths; returns them as
    contiguous f32 / i32 CUDA tensors (probe_width may stay None)."""
    o_cap = overflow_ids.shape[0]
    if overflow_scores.shape != (b, o_cap) or overflow_ids.dim() != 1:
        raise ValueError(f"{name}: overflow_scores "
                         f"{tuple(overflow_scores.shape)} / overflow_ids "
                         f"{tuple(overflow_ids.shape)} mismatch")
    if probe_width is not None and probe_width.shape != (b,):
        raise ValueError(f"{name}: probe_width must be (b,)")
    _cuda(name, overflow_scores, overflow_ids, probe_width)
    if probe_width is not None:
        probe_width = probe_width.to(torch.int32).contiguous()
    return (overflow_scores.to(torch.float32).contiguous(),
            overflow_ids.to(torch.int32).contiguous(), probe_width)


def _check_pool(name: str, pool_pow2: int, k: int) -> None:
    """Raise unless the screens' select kernel holds a pool of pool_pow2
    slots and k winners in one block."""
    if pool_pow2 > SCREEN_POOL_MAX:
        raise ValueError(f"{name}: pool of {pool_pow2} slots exceeds the "
                         f"select kernel's {SCREEN_POOL_MAX}")
    fn_smem = build.bind("decode_fused", "screen_topk_smem", [build.I],
                         restype=ctypes.c_longlong)
    if fn_smem(k) > _SMEM_LIMIT:
        raise ValueError(f"{name}: k={k} exceeds one block's shared memory")


def screen_workspace_ints(b: int, n_probe: int, cap: int) -> int:
    """Int32 words of ``ivf_screen_select``'s and ``pq_screen_select``'s
    key workspace: one 64-bit sort key per (query, probed member slot)."""
    return 2 * b * n_probe * cap


def ivf_screen_select(member_vecs, member_ids, overflow_scores, overflow_ids,
                      probe, q, *, k: int, probe_width=None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernels -> (values (b, k) f32, ids (b, k) i32)."""
    member_vecs, member_ids, probe, q = check_tables(
        member_vecs, member_ids, probe, q, "ivf_screen_select")
    n_c, cap, d = member_vecs.shape
    b, n_probe = probe.shape
    o_cap = overflow_ids.shape[0]
    overflow_scores, overflow_ids, probe_width = _check_overflow(
        "ivf_screen_select", overflow_scores, overflow_ids, probe_width, b)
    pool_pow2 = _pow2(max(n_probe * cap + o_cap, k))
    _check_pool("ivf_screen_select", pool_pow2, k)
    # values, ids, the keys (8-byte aligned: 2 * b * k words before), then
    # the score pass's plan
    n_out = b * k
    n_keys = screen_workspace_ints(b, n_probe, cap)
    n_plan = workspace_ints(n_c, b, n_probe)
    buf = torch.empty(2 * n_out + n_keys + n_plan, dtype=torch.int32,
                      device=q.device)
    vals = buf[:n_out].view(torch.float32).view(b, k)
    ids = buf[n_out:2 * n_out].view(b, k)
    keys = buf.data_ptr() + 8 * n_out
    fn = build.bind("decode_fused", "ivf_screen_select_launch",
                    [build.P] * 11 + [ctypes.c_longlong] + [build.I] * 8
                    + [build.P])
    err = fn(build.ptr(member_vecs), build.ptr(member_ids),
             build.ptr(overflow_scores), build.ptr(overflow_ids),
             build.ptr(probe), build.ptr(probe_width), build.ptr(q),
             build.ptr(vals), build.ptr(ids), keys, keys + 4 * n_keys, n_plan,
             n_c, cap, d, b, n_probe, o_cap, k, pool_pow2, build.stream())
    build.check(err, "ivf_screen_select")
    launches["ivf_screen_select"] += 1
    return vals, ids


def pq_screen_select(member_codes, member_ids, coarse, overflow_scores,
                     overflow_ids, probe, lut, *, r: int, probe_width=None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernels -> (values (b, r) f32, ids (b, r) i32)."""
    member_codes, probe, lut = check_codes(member_codes, probe, lut,
                                           "pq_screen_select")
    n_c, cap, m_sub = member_codes.shape
    b, n_probe = probe.shape
    ksub = lut.shape[2]
    o_cap = overflow_ids.shape[0]
    if member_ids.shape != (n_c, cap) or coarse.shape != (b, n_probe):
        raise ValueError(f"pq_screen_select: member_ids "
                         f"{tuple(member_ids.shape)} / coarse "
                         f"{tuple(coarse.shape)} do not fit the tables")
    if r < 1:
        raise ValueError(f"pq_screen_select: r={r} must be positive")
    _cuda("pq_screen_select", member_ids, coarse)
    overflow_scores, overflow_ids, probe_width = _check_overflow(
        "pq_screen_select", overflow_scores, overflow_ids, probe_width, b)
    pool_pow2 = _pow2(max(n_probe * cap + o_cap, r))
    _check_pool("pq_screen_select", pool_pow2, r)
    member_ids = member_ids.to(torch.int32).contiguous()
    coarse = coarse.to(torch.float32).contiguous()
    # values, ids, then the keys (8-byte aligned: 2 * b * r words before)
    n_out = b * r
    buf = torch.empty(2 * n_out + screen_workspace_ints(b, n_probe, cap),
                      dtype=torch.int32, device=lut.device)
    vals = buf[:n_out].view(torch.float32).view(b, r)
    ids = buf[n_out:2 * n_out].view(b, r)
    fn = build.bind("decode_fused", "pq_screen_select_launch",
                    [build.P] * 11 + [build.I] * 9 + [build.P])
    err = fn(build.ptr(member_codes), build.ptr(member_ids), build.ptr(coarse),
             build.ptr(overflow_scores), build.ptr(overflow_ids),
             build.ptr(probe), build.ptr(probe_width), build.ptr(lut),
             build.ptr(vals), build.ptr(ids), buf.data_ptr() + 8 * n_out, n_c,
             cap, m_sub, ksub, b, n_probe, o_cap, r, pool_pow2,
             build.stream())
    build.check(err, "pq_screen_select")
    launches["pq_screen_select"] += 1
    return vals, ids


def rerank_workspace_ints(b: int, r: int) -> int:
    """Int32 words of ``rerank_select``'s key workspace: one 64-bit sort key
    per (query, survivor)."""
    return 2 * b * r


def rerank_select(db, cand, lut_vals, q, *, k: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernels -> (values (b, k) f32, ids (b, k) i32)."""
    _cuda("rerank_select", db, cand, lut_vals, q)
    if db.dim() != 2 or cand.dim() != 2:
        raise ValueError("rerank_select: db (n, d) and cand (b, r) expected")
    n, d = db.shape
    b, r = cand.shape
    if lut_vals.shape != (b, r) or q.shape != (b, d):
        raise ValueError(f"rerank_select: lut_vals {tuple(lut_vals.shape)} / "
                         f"q {tuple(q.shape)} do not fit cand {(b, r)}, d={d}")
    if not 0 < k <= r:
        raise ValueError(f"rerank_select: k={k} must be in 1..r={r}")
    if db.dtype != torch.float32 or q.dtype != torch.float32:
        raise ValueError("rerank_select: db and q must be float32")
    if n == 0 or n * d >= 2 ** 31:
        raise ValueError(f"rerank_select: n={n} rows of d={d} out of range")
    db = db.contiguous()
    if db.data_ptr() % 16:
        raise ValueError("rerank_select: db must be 16-byte aligned")
    fn_smem = build.bind("decode_fused", "rerank_select_smem",
                         [build.I] * 2, restype=ctypes.c_longlong)
    if fn_smem(d, r) > _SMEM_LIMIT:
        raise ValueError(f"rerank_select: r={r} at d={d} exceeds one "
                         "block's shared memory")
    cand = cand.to(torch.int32).contiguous()
    lut_vals = lut_vals.to(torch.float32).contiguous()
    q = q.contiguous()
    # values, ids, then the keys (8-byte aligned: 2 * b * k words before)
    n_out = b * k
    buf = torch.empty(2 * n_out + rerank_workspace_ints(b, r),
                      dtype=torch.int32, device=q.device)
    vals = buf[:n_out].view(torch.float32).view(b, k)
    ids = buf[n_out:2 * n_out].view(b, k)
    fn = build.bind("decode_fused", "rerank_select_launch",
                    [build.P] * 7 + [build.I] * 5 + [build.P])
    err = fn(build.ptr(db), build.ptr(cand), build.ptr(lut_vals), build.ptr(q),
             build.ptr(vals), build.ptr(ids), buf.data_ptr() + 8 * n_out, n, d,
             b, r, k, build.stream())
    build.check(err, "rerank_select")
    launches["rerank_select"] += 1
    return vals, ids


def tail_workspace_ints(t: int, m_cap: int) -> int:
    """Int32 words of ``tail_gather_argmax``'s workspace: one (value,
    index) pair per (token, chunk of ``TAIL_ROWS`` tail slots), at least
    one chunk a token."""
    return 2 * t * max(1, -(-m_cap // TAIL_ROWS))


def tail_gather_argmax(emb, pos, m_used, pert_s, s_ids, heights, h
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernels -> (index (t,) i32, max_val (t,) f32)."""
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
    if 4 * ((d + 3) & ~3) > _SMEM_LIMIT:
        raise ValueError("tail_gather_argmax: d exceeds one block's shared "
                         "memory")
    args = [emb, pos.to(torch.int32).contiguous(),
            m_used.to(torch.int32).contiguous(),
            pert_s.to(torch.float32).contiguous(),
            s_ids.to(torch.int32).contiguous(),
            heights.to(torch.float32).contiguous(), h.contiguous()]
    # index, max_val, then the (value, index) pairs (8-byte aligned: 2 t
    # words before)
    buf = torch.empty(2 * t + tail_workspace_ints(t, m_cap),
                      dtype=torch.int32, device=h.device)
    idx = buf[:t]
    max_val = buf[t:2 * t].view(torch.float32)
    fn = build.bind("decode_fused", "tail_gather_argmax_launch",
                    [build.P] * 10 + [build.I] * 5 + [build.P])
    err = fn(*(build.ptr(a) for a in args), build.ptr(idx),
             build.ptr(max_val), buf.data_ptr() + 8 * t, n, d, t, m_cap, k,
             build.stream())
    build.check(err, "tail_gather_argmax")
    launches["tail_gather_argmax"] += 1
    return idx, max_val
