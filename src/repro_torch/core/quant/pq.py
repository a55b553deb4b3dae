"""Residual product quantization (counterpart of ``repro/core/quant/pq.py``):
encode / decode and the per-query lookup tables of the IVF-PQ index.

A ``(n, d)`` f32 row block is split into ``m_sub`` contiguous subvectors of
``d_sub = d // m_sub`` dims; each subvector becomes the uint8 id of its
nearest codeword in that subspace's ``(ksub, d_sub)`` codebook (``ksub <=
256``). Scoring is asymmetric: :func:`build_lut` tabulates every ``q_m ·
codeword`` once per query, after which a coded row scores ``Σ_m lut[m,
code_m]`` — table lookups and adds, no work proportional to ``d``.

:func:`lut_scores` sums the ``m_sub`` entries in subspace order starting
from 0.0, one add at a time: the order of the Pallas kernel's one-hot
accumulation (``repro/kernels/pq_lut_score.py::lut_tile_scores``) and of
the port's ``lut_sum`` device function (``csrc/pq_lut.cuh``), so the plain
path and both PQ kernels give the same bits.
"""
from __future__ import annotations

import torch

from repro_torch.core.quant.kmeans import (anisotropic_subspace_kmeans,
                                           subspace_kmeans)

__all__ = ["train_codebooks", "encode", "decode", "build_lut", "lut_scores"]


def _split(x: torch.Tensor, m_sub: int) -> torch.Tensor:
    """(n, d) -> (m_sub, n, d_sub) subspace view."""
    n, d = x.shape
    if d % m_sub:
        raise ValueError(f"feature dim {d} not divisible by m_sub={m_sub}")
    return x.reshape(n, m_sub, d // m_sub).transpose(0, 1)


def train_codebooks(x: torch.Tensor, m_sub: int, ksub: int, iters: int, *,
                    seed: int = 0, init: torch.Tensor | None = None,
                    anisotropic_eta: float = 0.0,
                    anchors: torch.Tensor | None = None) -> torch.Tensor:
    """``(m_sub, ksub, d_sub)`` codebooks trained on the rows ``x (n, d)``
    (residuals, for residual PQ) by ``iters`` Lloyd iterations per subspace.

    ``init=None`` cold-starts every subspace from ONE row sample of ``ksub``
    rows, drawn by a ``torch.Generator`` seeded with ``seed`` and repeated
    cyclically when ``n < ksub`` (the reference draws the sample with
    ``jax.random.permutation``, which cannot be replayed here: tests pass
    its codebooks in as ``init``). Passing the previous codebooks
    warm-starts a refresh with frozen shapes.

    ``anisotropic_eta > 0`` trains under the score-aware loss
    (:func:`repro_torch.core.quant.kmeans.anisotropic_lloyd`): the part of
    each row's quantization error parallel to its direction — taken from
    ``anchors``, the database rows whose residuals ``x`` are — is weighted
    by ``eta``. 0 (default) is standard k-means."""
    xs = _split(x.float(), m_sub)  # (m, n, d_sub)
    if init is None:
        n = x.shape[0]
        gen = torch.Generator(device=x.device)
        gen.manual_seed(seed)
        rows = torch.randperm(n, generator=gen, device=x.device)[:ksub]
        rows = rows.repeat(-(-ksub // rows.numel()))[:ksub]
        init = xs[:, rows, :]
    if anisotropic_eta > 0.0 and anchors is not None:
        a = anchors.float()
        u = a / torch.clamp(torch.linalg.norm(a, dim=1, keepdim=True),
                            min=1e-12)
        return anisotropic_subspace_kmeans(xs, _split(u, m_sub), init, iters,
                                           anisotropic_eta)
    return subspace_kmeans(xs, init, iters)


def encode(codebooks: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(m, ksub, d_sub), (n, d) -> (n, m) uint8 nearest-codeword ids; the
    first minimum wins, as ``jnp.argmin``."""
    cb = codebooks.float()
    xs = _split(x.float(), cb.shape[0])  # (m, n, d_sub)
    sq = (cb * cb).sum(-1)  # (m, ksub)
    dist = sq[:, None, :] - 2.0 * torch.bmm(xs, cb.transpose(1, 2))
    return torch.argmin(dist, dim=2).T.to(torch.uint8)


def decode(codebooks: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """(m, ksub, d_sub), (n, m) uint8 -> (n, d) f32 reconstruction."""
    cb = codebooks.float()
    m = cb.shape[0]
    rows = cb[torch.arange(m, device=cb.device)[None, :], codes.long()]
    return rows.reshape(codes.shape[0], m * cb.shape[2])  # (n, m, d_sub)


def build_lut(codebooks: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """(m, ksub, d_sub), (b, d) -> (b, m, ksub) tables ``lut[b, m, j] =
    q[b]_m · codebooks[m, j]``: ``d · ksub`` multiply-adds per query, a
    plain batched product (the reference leaves it to XLA too)."""
    m = codebooks.shape[0]
    b, d = q.shape
    qs = q.float().reshape(b, m, d // m)
    return torch.einsum("bmd,mkd->bmk", qs, codebooks.float())


def lut_scores(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """(b, m, ksub) f32, (b, c, m) uint8 -> (b, c) summed table lookups,
    ``Σ_m lut[b, m, codes[b, c, m]]`` added in subspace order from 0.0."""
    codes = codes.long()
    acc = torch.zeros(codes.shape[:2], dtype=torch.float32,
                      device=lut.device)
    for mi in range(codes.shape[2]):
        acc = acc + torch.gather(lut[:, mi, :].float(), 1, codes[:, :, mi])
    return acc
