"""Lloyd k-means on device (counterpart of ``repro/core/quant/kmeans.py``):
nearest-centroid assignment by the ``|c|² - 2x·c`` trick, centroid updates
by ``index_add_`` (the reference's ``segment_sum``), empty clusters keeping
their previous centroid. The IVF coarse quantizer runs :func:`lloyd`; PQ
codebook training runs :func:`subspace_kmeans`, the same iteration with the
subspaces as a batch dimension (the reference vmaps ``lloyd``).

On CUDA ``index_add_`` of floats accumulates with atomics, so two builds
from the same inputs can differ in the last bits of a centroid: build an
index once and share it where two runs must see the same index.
"""
from __future__ import annotations

import torch

__all__ = ["assign_clusters", "lloyd", "subspace_kmeans"]


def assign_clusters(x: torch.Tensor, cent: torch.Tensor) -> torch.Tensor:
    """Nearest centroid per row: argmin |c|² - 2x·c (|x|² constant)."""
    sq_c = (cent * cent).sum(-1)
    return torch.argmin(sq_c[None, :] - 2.0 * (x @ cent.T), dim=1)


def lloyd(x: torch.Tensor, cent: torch.Tensor, iters: int) -> torch.Tensor:
    """``iters`` Lloyd iterations over ``x (n, d)`` from ``cent (k, d)``."""
    n = x.shape[0]
    k = cent.shape[0]
    ones = torch.ones((n,), dtype=torch.float32, device=x.device)
    for _ in range(iters):
        assign = assign_clusters(x, cent)
        sums = torch.zeros_like(cent).index_add_(0, assign, x)
        counts = torch.zeros((k,), dtype=torch.float32,
                             device=x.device).index_add_(0, assign, ones)
        cent = torch.where(counts[:, None] > 0,
                           sums / torch.clamp(counts, min=1.0)[:, None], cent)
    return cent


def subspace_kmeans(x: torch.Tensor, init: torch.Tensor, iters: int
                    ) -> torch.Tensor:
    """``iters`` Lloyd iterations in every subspace at once: ``x (m, n,
    d_sub)`` rows from ``init (m, k, d_sub)`` codebooks -> (m, k, d_sub)
    f32. Subspace ``i`` is :func:`lloyd` on ``x[i]`` from ``init[i]``; the
    subspaces' segments are kept apart by offsetting subspace i's cluster
    ids by ``i * k`` in one flat ``index_add_``."""
    x = x.float()
    cent = init.float()
    m, n, ds = x.shape
    k = cent.shape[1]
    offset = (torch.arange(m, device=x.device) * k)[:, None]  # (m, 1)
    flat_x = x.reshape(m * n, ds)
    ones = torch.ones((m * n,), dtype=torch.float32, device=x.device)
    for _ in range(iters):
        sq_c = (cent * cent).sum(-1)  # (m, k)
        assign = torch.argmin(
            sq_c[:, None, :] - 2.0 * torch.bmm(x, cent.transpose(1, 2)),
            dim=2)  # (m, n)
        seg = (assign + offset).reshape(-1)
        sums = torch.zeros((m * k, ds), dtype=torch.float32,
                           device=x.device).index_add_(0, seg, flat_x)
        counts = torch.zeros((m * k,), dtype=torch.float32,
                             device=x.device).index_add_(0, seg, ones)
        new = sums / torch.clamp(counts, min=1.0)[:, None]
        cent = torch.where(counts[:, None] > 0, new,
                           cent.reshape(m * k, ds)).reshape(m, k, ds)
    return cent
