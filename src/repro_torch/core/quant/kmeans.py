"""Lloyd k-means on device (counterpart of ``repro/core/quant/kmeans.py``):
nearest-centroid assignment by the ``|c|² - 2x·c`` trick, centroid updates
by ``index_add_`` (the reference's ``segment_sum``), empty clusters keeping
their previous centroid. The IVF coarse quantizer runs :func:`lloyd`; PQ
codebook training runs :func:`subspace_kmeans`, the same iteration with the
subspaces as a batch dimension (the reference vmaps ``lloyd``).

:func:`anisotropic_lloyd` is the ScaNN-style score-aware variant, which
IVF-PQ codebook training runs when ``PQConfig.anisotropic_eta > 0``.

On CUDA ``index_add_`` of floats accumulates with atomics, so two builds
from the same inputs can differ in the last bits of a centroid: build an
index once and share it where two runs must see the same index.
"""
from __future__ import annotations

import torch

__all__ = ["assign_clusters", "lloyd", "subspace_kmeans",
           "cluster_outer", "anisotropic_lloyd",
           "anisotropic_subspace_kmeans"]

# elements of the (clusters, rows, d) member gather cluster_outer holds
_OUTER_ELEMS = 1 << 26


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


def cluster_outer(u: torch.Tensor, assign: torch.Tensor, k: int
                  ) -> torch.Tensor:
    """``Σ_{i: assign_i = j} u_i u_iᵀ`` for every cluster j -> (k, d, d),
    without the (n, d, d) per-row products: the rows are grouped by
    cluster (a stable sort), padded to the largest cluster, and each
    group's Gram matrix is one batched product, a chunk of clusters at a
    time. Reads the largest cluster size on the host."""
    n, d = u.shape
    counts = torch.bincount(assign, minlength=k)
    order = torch.argsort(assign, stable=True)
    starts = torch.cumsum(counts, 0) - counts
    width = max(1, int(counts.max()))
    out = torch.zeros((k, d, d), dtype=u.dtype, device=u.device)
    slot = torch.arange(width, device=u.device)
    chunk = max(1, _OUTER_ELEMS // (width * d))
    for c0 in range(0, k, chunk):
        cl = torch.arange(c0, min(c0 + chunk, k), device=u.device)
        pos = starts[cl][:, None] + slot[None, :]  # (c, width)
        live = slot[None, :] < counts[cl][:, None]
        rows = u[order[torch.clamp(pos, max=n - 1)]]  # (c, width, d)
        rows = rows * live[..., None]
        out[cl] = torch.bmm(rows.transpose(1, 2), rows)
    return out


def anisotropic_lloyd(x: torch.Tensor, u: torch.Tensor, cent: torch.Tensor,
                      iters: int, eta: float) -> torch.Tensor:
    """Weighted Lloyd under the ScaNN-style score-aware loss (Guo et al.
    2020): a row's quantization error is split against its direction ``u``
    (n, d) into a parallel and an orthogonal part, and the parallel part,
    which moves inner-product scores for the queries that rank the row
    highly, is weighted by ``eta``::

        loss(r, c) = (r-c)ᵀ (I + (η-1) u uᵀ) (r-c)

    Both phases are exact: assignment expands the quadratic per centroid
    (row-constant terms dropped), and the update solves each cluster's
    normal equations ``(n_j I + (η-1) Σ u uᵀ) c = Σ r + (η-1) Σ u ⟨u, r⟩``
    with one batched ``torch.linalg.solve`` over (k, d, d), Σ u uᵀ formed
    by :func:`cluster_outer`. ``eta = 1`` is standard Lloyd (up to
    rounding); empty clusters keep their centroid."""
    x = x.float()
    u = u.float()
    cent = cent.float()
    n, d = x.shape
    k = cent.shape[0]
    w = eta - 1.0
    a = (x * u).sum(-1)  # (n,) ⟨r, u⟩
    eye = torch.eye(d, dtype=torch.float32, device=x.device)
    ones = torch.ones((n,), dtype=torch.float32, device=x.device)
    for _ in range(iters):
        p = u @ cent.T  # (n, k) ⟨c_j, u_i⟩
        sq_c = (cent * cent).sum(-1)
        dist = sq_c[None, :] - 2.0 * (x @ cent.T) + w * (a[:, None] - p) ** 2
        assign = torch.argmin(dist, dim=1)
        counts = torch.zeros((k,), dtype=torch.float32,
                             device=x.device).index_add_(0, assign, ones)
        sx = torch.zeros_like(cent).index_add_(0, assign, x)
        sua = torch.zeros_like(cent).index_add_(0, assign, u * a[:, None])
        lhs = (counts[:, None, None] * eye + w * cluster_outer(u, assign, k)
               + 1e-6 * eye)
        rhs = sx + w * sua
        new = torch.linalg.solve(lhs, rhs[..., None])[..., 0]
        cent = torch.where(counts[:, None] > 0, new, cent)
    return cent


def anisotropic_subspace_kmeans(x: torch.Tensor, u: torch.Tensor,
                                init: torch.Tensor, iters: int, eta: float
                                ) -> torch.Tensor:
    """:func:`anisotropic_lloyd` in every subspace: ``x``, ``u`` (m, n,
    d_sub), ``init`` (m, k, d_sub) -> (m, k, d_sub) f32. ``u`` holds the
    subvectors of each row's GLOBAL unit direction (not re-normalized per
    subspace), as in the reference."""
    return torch.stack([anisotropic_lloyd(x[i], u[i], init[i], iters, eta)
                        for i in range(x.shape[0])])
