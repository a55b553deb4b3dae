"""Counter-based random numbers for the sampler (no counterpart in the JAX
package, where ``launch/steps.py`` folds (request id, position) into
threefry keys).

Philox-4x32-10 (Salmon et al., SC'11) written in int64 torch ops, every
word masked to 32 bits, so it runs unchanged on the CPU and the card. A
draw is a pure function of ``(seed, request id, position, stream, element
index)``: the key is the 64-bit seed, the counter is ``(element, stream,
request id, position)``. That makes a token's sample a function of its
request and position alone — independent of batch composition, slot and
decode window, which is what keeps decode window T=N ≡ T=1 and fused ≡
unfused inside the port.

``keys`` throughout is a ``(..., 3)`` int64 tensor of (seed, request id,
position) rows (:func:`repro_torch.launch.steps.slot_keys` builds them).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = [
    "Draws",
    "philox4x32",
    "uniform",
    "gumbel",
    "exponential",
    "uniform_int",
    "poisson_count",
    "tail_draws",
    "fold_in",
    "STREAM_GUMBEL_S",
    "STREAM_POISSON",
    "STREAM_COMPLEMENT",
    "STREAM_HEIGHTS",
    "STREAM_DENSE",
    "STREAM_STRICT",
]

_MASK = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57  # Philox multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85  # Weyl key increments

# one stream per kind of draw, so no two draws of a token share a counter
STREAM_GUMBEL_S = 0  # Gumbel perturbation of the top-k stratum S
STREAM_POISSON = 1  # Exp(1) gaps whose partial sums give the Poisson count
STREAM_COMPLEMENT = 2  # uniform indices into the complement of S
STREAM_HEIGHTS = 3  # Exp(1) excess of the truncated-Gumbel tail heights
STREAM_DENSE = 4  # Gumbel noise of the dense (exact-mode) sampler
STREAM_STRICT = 5  # Gumbel noise of strict serving's exact re-sample of a
#   token whose certificate failed (the reference folds 0x5743 into the key)


class Draws(NamedTuple):
    """The raw random numbers of one Algorithm-2 sample per token (leading
    dim t). Tests inject the reference's own numbers through this."""

    g_s: torch.Tensor  # (t, k) f32 Gumbel perturbations of S
    m: torch.Tensor  # (t,) int64 Poisson(l) tail atom count (> m_cap: overflow)
    u: torch.Tensor  # (t, m_cap) int64 uniform indices in [0, n - k_valid)
    exp: torch.Tensor  # (t, m_cap) f32 Exp(1) height excesses


def _mulhilo(a: int, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of a * b for 32-bit a, b, without overflowing
    int64: b is split into 16-bit halves."""
    p0 = a * (b & 0xFFFF)  # < 2^48
    p1 = a * (b >> 16)  # < 2^48
    mid = p0 + ((p1 & 0xFFFF) << 16)  # < 2^49
    return (p1 >> 16) + (mid >> 32), mid & _MASK


def philox4x32(c0, c1, c2, c3, k0, k1, rounds: int = 10):
    """Philox-4x32 on int64 tensors (or ints) holding 32-bit words;
    broadcasting. Returns the four output words."""
    for r in range(rounds):
        if r:
            k0 = (k0 + _W0) & _MASK
            k1 = (k1 + _W1) & _MASK
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _words(keys: torch.Tensor, n: int, stream: int) -> torch.Tensor:
    """(..., n, 4) int64 words for counters 0..n-1 of ``stream``."""
    keys = keys.long()
    seed, rid, pos = keys[..., 0:1], keys[..., 1:2], keys[..., 2:3]
    ctr = torch.arange(n, device=keys.device)
    zero = torch.zeros_like(seed)
    out = philox4x32(ctr + zero, zero + stream, rid & _MASK, pos & _MASK,
                     seed & _MASK, (seed >> 32) & _MASK)
    return torch.stack(out, dim=-1)


def uniform(keys: torch.Tensor, n: int, stream: int) -> torch.Tensor:
    """(..., n) float64 uniforms in (0, 1): 52 random bits each, offset by
    half a step so neither end is reachable."""
    w = _words(keys, (n + 1) // 2, stream)
    a = ((w[..., 0] >> 6) << 26) | (w[..., 1] >> 6)
    b = ((w[..., 2] >> 6) << 26) | (w[..., 3] >> 6)
    x = torch.stack([a, b], dim=-1).flatten(-2)[..., :n]
    return (x.double() + 0.5) * 2.0 ** -52


def gumbel(keys: torch.Tensor, n: int, stream: int) -> torch.Tensor:
    """(..., n) float32 standard Gumbel draws."""
    return (-torch.log(-torch.log(uniform(keys, n, stream)))).float()


def exponential(keys: torch.Tensor, n: int, stream: int) -> torch.Tensor:
    """(..., n) float64 Exp(1) draws."""
    return -torch.log(uniform(keys, n, stream))


def uniform_int(keys: torch.Tensor, n: int, hi: torch.Tensor,
                stream: int) -> torch.Tensor:
    """(..., n) int64 uniform integers in [0, hi) for a per-row ``hi``
    ((...,) int64 >= 1). Each is a 63-bit word taken modulo hi, so the
    modulo bias is below hi / 2^63 < 2^-32."""
    w = _words(keys, (n + 1) // 2, stream)
    a = (w[..., 0] << 31) | (w[..., 1] >> 1)
    b = (w[..., 2] << 31) | (w[..., 3] >> 1)
    x = torch.stack([a, b], dim=-1).flatten(-2)[..., :n]
    return torch.remainder(x, hi.long()[..., None])


def poisson_count(keys: torch.Tensor, lam, m_cap: int,
                  stream: int) -> torch.Tensor:
    """(...,) int64 Poisson(lam) count, capped at m_cap + 1: the number of
    arrivals of a rate-1 Poisson process in [0, lam], i.e. of partial sums
    of m_cap + 1 Exp(1) gaps that are <= lam. Exact below the cap, and a
    count of m_cap + 1 says exactly that the draw overflowed m_cap."""
    gaps = exponential(keys, m_cap + 1, stream)
    arrivals = torch.cumsum(gaps, dim=-1)
    lam = torch.as_tensor(lam, dtype=torch.float64, device=arrivals.device)
    return (arrivals <= lam[..., None] if lam.dim() else arrivals <= lam
            ).sum(-1)


def tail_draws(keys: torch.Tensor, *, k: int, m_cap: int, hi: torch.Tensor,
               lam) -> Draws:
    """All random numbers of one Algorithm-2 sample per key row."""
    return Draws(
        g_s=gumbel(keys, k, STREAM_GUMBEL_S),
        m=poisson_count(keys, lam, m_cap, STREAM_POISSON),
        u=uniform_int(keys, m_cap, hi, STREAM_COMPLEMENT),
        exp=exponential(keys, m_cap, STREAM_HEIGHTS).float(),
    )


def fold_in(keys: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """Child key rows: (..., 3) (seed, a, b) rows and (...,) int64 ``data``
    -> (seed, a', b'), where (a', b') are two Philox words of the counter
    (data, a, b) under the seed's key. A row's child depends on that row
    and ``data`` alone, so keys derived along a path (beam search folds
    each edge's token) are a function of the path, whatever rows share the
    batch."""
    keys = keys.long()
    seed = keys[..., 0]
    data = data.long()
    w = philox4x32(data & _MASK, (data >> 32) & _MASK, keys[..., 1] & _MASK,
                   keys[..., 2] & _MASK, seed & _MASK, (seed >> 32) & _MASK)
    return torch.stack([seed, w[0], w[1]], dim=-1)
