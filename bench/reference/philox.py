"""A frozen copy of the port's counter-based random numbers (Philox-4x32-10,
Salmon et al., SC'11, in int64 torch ops, every word masked to 32 bits).

The benchmark's reference draws a query's tail atoms, complement indices
and Gumbel perturbations from this copy, keyed by the query's (seed, query
number, 0) row, so it can follow the port's stream without importing the
port. A draw is a pure function of (seed, query number, position, stream,
element index). Later changes to the port's generator do not change this
file: a port whose stream departs from it fails the benchmark's check.
"""
from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57  # Philox multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85  # Weyl key increments

STREAM_GUMBEL_S = 0  # Gumbel perturbation of the top-k stratum S
STREAM_POISSON = 1  # Exp(1) gaps whose partial sums give the Poisson count
STREAM_COMPLEMENT = 2  # uniform indices into the complement of S
STREAM_HEIGHTS = 3  # Exp(1) excess of the truncated-Gumbel tail heights


def _mulhilo(a: int, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    p0 = a * (b & 0xFFFF)
    p1 = a * (b >> 16)
    mid = p0 + ((p1 & 0xFFFF) << 16)
    return (p1 >> 16) + (mid >> 32), mid & MASK


def philox4x32(c0, c1, c2, c3, k0, k1, rounds: int = 10):
    for r in range(rounds):
        if r:
            k0 = (k0 + _W0) & MASK
            k1 = (k1 + _W1) & MASK
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _words(keys: torch.Tensor, n: int, stream: int) -> torch.Tensor:
    keys = keys.long()
    seed, rid, pos = keys[..., 0:1], keys[..., 1:2], keys[..., 2:3]
    ctr = torch.arange(n, device=keys.device)
    zero = torch.zeros_like(seed)
    out = philox4x32(ctr + zero, zero + stream, rid & MASK, pos & MASK,
                     seed & MASK, (seed >> 32) & MASK)
    return torch.stack(out, dim=-1)


def uniform(keys: torch.Tensor, n: int, stream: int) -> torch.Tensor:
    """(..., n) float64 uniforms in (0, 1), 52 random bits each."""
    w = _words(keys, (n + 1) // 2, stream)
    a = ((w[..., 0] >> 6) << 26) | (w[..., 1] >> 6)
    b = ((w[..., 2] >> 6) << 26) | (w[..., 3] >> 6)
    x = torch.stack([a, b], dim=-1).flatten(-2)[..., :n]
    return (x.double() + 0.5) * 2.0 ** -52


def gumbel(keys: torch.Tensor, n: int, stream: int) -> torch.Tensor:
    """(..., n) float64 standard Gumbel draws."""
    return -torch.log(-torch.log(uniform(keys, n, stream)))


def exponential(keys: torch.Tensor, n: int, stream: int) -> torch.Tensor:
    """(..., n) float64 Exp(1) draws."""
    return -torch.log(uniform(keys, n, stream))


def uniform_int(keys: torch.Tensor, n: int, hi: torch.Tensor,
                stream: int) -> torch.Tensor:
    """(..., n) int64 uniform integers in [0, hi) for a per-row ``hi``."""
    w = _words(keys, (n + 1) // 2, stream)
    a = (w[..., 0] << 31) | (w[..., 1] >> 1)
    b = (w[..., 2] << 31) | (w[..., 3] >> 1)
    x = torch.stack([a, b], dim=-1).flatten(-2)[..., :n]
    return torch.remainder(x, hi.long()[..., None])


def poisson_count(keys: torch.Tensor, lam: float, m_cap: int,
                  stream: int) -> torch.Tensor:
    """(...,) int64 Poisson(lam) count capped at m_cap + 1: the partial sums
    of m_cap + 1 Exp(1) gaps that are <= lam."""
    arrivals = torch.cumsum(exponential(keys, m_cap + 1, stream), dim=-1)
    return (arrivals <= lam).sum(-1)
