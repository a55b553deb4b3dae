"""flash_decode: one-token GQA decode attention, a CUDA kernel for Hopper
(``csrc/flash_decode.cu``; counterpart of ``repro/kernels/flash_decode.py``).

Takes q ``(B, Hq, hd)`` and the dense KV ring ``(B, S, Hkv, hd)``, both in
the compute dtype (float32 or bfloat16), and ``lengths (B,)``; returns the
fp32 attention output ``(B, Hq, hd)``. Positions at or past ``lengths[b]``
are masked. The plain version is :func:`repro_torch.kernels.ref
.flash_decode_ref`.

With ``pages`` ``(B, n_pages)`` the cache is a shared block pool ``(n_pool,
block_len, Hkv, hd)`` and ring row ``r`` of sequence ``b`` lives in block
``pages[b, r // block_len]`` at offset ``r % block_len``; the kernel reads
the pool through the page table in place (its launches count as
``flash_decode_paged``). Its plain version, :func:`repro_torch.kernels.ref
.flash_decode_paged_ref`, gathers the ring view first.

The kernel splits each sequence into ``SPLIT_ROWS``-row blocks and combines
their partial softmax states in a second kernel, both enqueued by one C
call; the output and the split workspace share one allocation.

``return_lse=True`` (the dense ring) also returns each row's log-sum-exp
``(B, Hq)`` fp32 — the natural log of Σ exp(q·k / √hd) over its live rows,
``m + log(l)`` of the combine's merged state — so the partial softmaxes of
a ring split over ranks can be combined (:mod:`repro_torch.models
.attention`). A row of length 0 is then empty: no split reads it, its
output is 0 and its lse -inf, where the default call keeps the
reference's all-masked semantics (every row averaged). Its launches count
as ``flash_decode``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

__all__ = ["flash_decode", "launches", "symbols"]

# kernel launches (dense and paged layouts); reset by ops.reset_launch_counts
launches = {"flash_decode": 0, "flash_decode_paged": 0}
# CUDA symbols as the profiler names them, by kernel (ops.kernel_symbols):
# (those of which a call launches exactly one, the others it launches); the
# paged layout launches the same symbols
symbols = {"flash_decode": (("flash_decode_split_kernel",
                             "flash_decode_split_mma_kernel"),
                            ("flash_decode_combine_kernel",))}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SPLIT_ROWS = 64  # cache rows per split: the kernel's kSplit, which it checks


def workspace_floats(b: int, s: int, hq: int, hd: int) -> int:
    """Floats of the split workspace: one (acc[hd], m, l) record per
    (sequence, query head, split)."""
    return b * hq * -(-s // SPLIT_ROWS) * (hd + 2)


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                 lengths: torch.Tensor, pages: torch.Tensor | None = None,
                 return_lse: bool = False):
    """Launch the kernel on CUDA tensors; raises on anything it does not take.
    ``pages``: the paged layout (``k_cache`` / ``v_cache`` are the pool);
    ``return_lse``: ``(out, lse)`` (dense only)."""
    if return_lse and pages is not None:
        raise ValueError("flash_decode: return_lse takes the dense ring only")
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k_cache.shape)}"
                         f" v{tuple(v_cache.shape)}")
    b, hq, hd = q.shape
    bk, s, hkv, hdk = k_cache.shape
    if pages is not None:
        if pages.dim() != 2 or pages.shape[0] != b:
            raise ValueError(f"pages {tuple(pages.shape)} must be ({b}, "
                             "n_pages)")
        n_pool, block_len = bk, s
        s = pages.shape[1] * block_len  # the ring each page table spans
        if n_pool < 1 or block_len < 1:
            raise ValueError(f"empty pool {tuple(k_cache.shape)}")
        bk = b
    if lengths.shape != (b,):
        raise ValueError(f"lengths {tuple(lengths.shape)} must be ({b},)")
    if bk != b or hdk != hd or hq % hkv or hq // hkv > 32 or hd > 256:
        raise ValueError(f"unsupported geometry q{tuple(q.shape)} "
                         f"k{tuple(k_cache.shape)} (need Hq % Hkv == 0, "
                         f"Hq/Hkv <= 32, hd <= 256)")
    if q.dtype not in _DTYPES or k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}/{k_cache.dtype}/{v_cache.dtype}: "
                         "q, k and v must share float32 or bfloat16")
    for t in (q, k_cache, v_cache, lengths) + (() if pages is None
                                                  else (pages,)):
        if not t.is_cuda:
            raise ValueError("flash_decode kernel needs CUDA tensors")
    q, k_cache, v_cache = q.contiguous(), k_cache.contiguous(), v_cache.contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    n_out = b * hq * hd
    n_ws = workspace_floats(b, s, hq, hd)
    # [out | workspace | lse]: the default call's layout is the lse call's
    buf = torch.empty(n_out + n_ws + (b * hq if return_lse else 0),
                      dtype=torch.float32, device=q.device)
    out = buf[:n_out].view(b, hq, hd)
    ws = buf.data_ptr() + 4 * n_out
    if pages is None:
        lse = buf[n_out + n_ws:].view(b, hq) if return_lse else None
        fn = build.bind("flash_decode", "flash_decode_launch",
                        [build.P] * 6 + [build.I] * 7 + [build.P] * 2)
        err = fn(build.ptr(q), build.ptr(k_cache), build.ptr(v_cache),
                 build.ptr(lengths), build.ptr(out), ws, b, s, hq, hkv, hd,
                 SPLIT_ROWS, _DTYPES[q.dtype], build.stream(),
                 build.ptr(lse) if return_lse else None)
        build.check(err, "flash_decode")
        launches["flash_decode"] += 1
        return (out, lse) if return_lse else out
    pages = pages.to(torch.int32).contiguous()
    fn = build.bind("flash_decode", "flash_decode_paged_launch",
                    [build.P] * 7 + [build.I] * 9 + [build.P])
    err = fn(build.ptr(q), build.ptr(k_cache), build.ptr(v_cache),
             build.ptr(pages), build.ptr(lengths), build.ptr(out), ws, b,
             pages.shape[1], block_len, n_pool, hq, hkv, hd, SPLIT_ROWS,
             _DTYPES[q.dtype], build.stream())
    build.check(err, "flash_decode_paged")
    launches["flash_decode_paged"] += 1
    return out
