"""Lloyd k-means on device (counterpart of ``repro/core/quant/kmeans.py``):
nearest-centroid assignment by the ``|c|² - 2x·c`` trick, centroid updates
by ``index_add_`` (the reference's ``segment_sum``), empty clusters keeping
their previous centroid.

On CUDA ``index_add_`` of floats accumulates with atomics, so two builds
from the same inputs can differ in the last bits of a centroid: build an
index once and share it where two runs must see the same index.
"""
from __future__ import annotations

import torch

__all__ = ["assign_clusters", "lloyd"]


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
