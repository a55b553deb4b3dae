"""ivf_gather_score: probed-cluster gather + score, a CUDA kernel for Hopper
(``csrc/ivf_gather_score.cu``; counterpart of
``repro/kernels/ivf_gather_score.py``).

Scores every member of each query's probed clusters against the query in
fp32 and copies the member ids alongside: ``scores = member_vecs[probe] · q``
and ``ids = member_ids[probe]``, both ``(b, n_probe, cap)``. The plain
version is :func:`repro_torch.kernels.ref.ivf_gather_score_ref`.

The kernel works cluster by cluster, reading each member row once per
chunk of queries that probe its cluster; for batches above 4 queries a
plan kernel first lists each cluster's (query, probe slot) pairs into an
int32 workspace, which shares one allocation with ``ids``. One C call
enqueues the kernels.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

__all__ = ["ivf_gather_score", "launches", "check_tables", "workspace_ints"]

launches = {"ivf_gather_score": 0}  # kernel launches; reset by ops.reset_launch_counts


def check_tables(member_vecs, member_ids, probe, q, name: str):
    """Validate the IVF tables and queries a kernel takes; returns them as
    contiguous f32 / i32 CUDA tensors."""
    if member_vecs.dim() != 3 or member_ids.shape != member_vecs.shape[:2]:
        raise ValueError(f"{name}: member_vecs {tuple(member_vecs.shape)} / "
                         f"member_ids {tuple(member_ids.shape)} mismatch")
    if probe.dim() != 2 or q.dim() != 2 or q.shape != (probe.shape[0],
                                                       member_vecs.shape[2]):
        raise ValueError(f"{name}: probe {tuple(probe.shape)} / q "
                         f"{tuple(q.shape)} do not fit d={member_vecs.shape[2]}")
    if member_vecs.dtype != torch.float32 or q.dtype != torch.float32:
        raise ValueError(f"{name}: member_vecs and q must be float32")
    for t in (member_vecs, member_ids, probe, q):
        if not t.is_cuda:
            raise ValueError(f"{name} kernel needs CUDA tensors")
    member_vecs = member_vecs.contiguous()
    if member_vecs.data_ptr() % 16:
        raise ValueError(f"{name}: member_vecs must be 16-byte aligned")
    return (member_vecs, member_ids.to(torch.int32).contiguous(),
            probe.to(torch.int32).contiguous(), q.contiguous())


def workspace_ints(n_c: int, b: int, n_probe: int) -> int:
    """Int32 workspace of a call, at its most: per-cluster counts, the
    ``b * n_probe`` (query, probe slot) pairs grouped by cluster, and one
    (cluster, first pair, pairs) record per work item — at most one item per
    probed cluster plus one per further ``qc`` pairs, bounded here at
    ``qc = 1`` — and the item count."""
    p = b * n_probe
    return n_c + p + 3 * (min(n_c, p) + p) + 1


def ivf_gather_score(member_vecs: torch.Tensor, member_ids: torch.Tensor,
                     probe: torch.Tensor, q: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel -> (scores (b, n_probe, cap) f32, ids (b, n_probe,
    cap) i32)."""
    member_vecs, member_ids, probe, q = check_tables(
        member_vecs, member_ids, probe, q, "ivf_gather_score")
    n_c, cap, d = member_vecs.shape
    b, n_probe = probe.shape
    scores = torch.empty((b, n_probe, cap), dtype=torch.float32,
                         device=q.device)
    n_ids = b * n_probe * cap
    ws_len = workspace_ints(n_c, b, n_probe)
    buf = torch.empty(n_ids + ws_len, dtype=torch.int32, device=q.device)
    ids = buf[:n_ids].view(b, n_probe, cap)
    fn = build.bind("ivf_gather_score", "ivf_gather_score_launch",
                    [build.P] * 7 + [ctypes.c_longlong] + [build.I] * 5
                    + [build.P])
    err = fn(build.ptr(member_vecs), build.ptr(member_ids), build.ptr(probe),
             build.ptr(q), build.ptr(scores), build.ptr(ids),
             buf.data_ptr() + 4 * n_ids, ws_len, n_c, cap, d, b, n_probe,
             build.stream())
    build.check(err, "ivf_gather_score")
    launches["ivf_gather_score"] += 1
    return scores, ids
