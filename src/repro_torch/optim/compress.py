"""Compressed gradient collectives: the int8 stochastic-rounding ring
all-reduce (counterpart of ``repro/optim/compress.py``).

A reduce-scatter and an all-gather around the ring of one mesh axis, built
from :func:`repro_torch.collectives.ppermute` hops whose payload is int8
with one fp32 scale per chunk: 4x fewer bytes on the wire than fp32, at the
cost of stochastic-rounding noise (unbiased). Accumulation is fp32 BETWEEN
hops, so the error grows like sqrt(P), not P; the reduced chunk is
quantized once and circulated as is in the all-gather.

The rounding noise is uniform from the port's counter-based generator
(:mod:`repro_torch.core.rng`), keyed by (seed, hop, rank): a run is a
function of its seed. :func:`quantize` takes the noise itself, which the
tests inject. ``TrainConfig.compress_grads`` is declared as in the
reference, which wires it to no step.
"""
from __future__ import annotations

import torch

from repro_torch import collectives as coll
from repro_torch.core import rng

__all__ = ["quantize", "dequantize", "ring_allreduce_int8", "hop_noise"]

_STREAM = 7  # the generator stream of the quantizer's rounding noise
_GATHER_HOP = 1000  # the all-gather's quantization, after every ring hop


def quantize(x: torch.Tensor, u: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """fp -> (int8, fp32 scale) with stochastic rounding: ``u`` uniform in
    [0, 1), x's shape (the reference's ``jax.random.uniform(key, ...)``)."""
    xf = x.float()
    scale = torch.max(torch.abs(xf)) / 127.0 + 1e-30
    y = xf / scale
    q = torch.clamp(torch.round(y + (u.float() - 0.5)), -127, 127)
    return q.to(torch.int8), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def hop_noise(seed: int, hop: int, rank: int, n: int, device
              ) -> torch.Tensor:
    """(n,) uniforms of one rank's quantization at ``hop``."""
    keys = torch.tensor([[seed, hop, rank]], dtype=torch.int64, device=device)
    return rng.uniform(keys, n, _STREAM)[0]


def ring_allreduce_int8(x: torch.Tensor, axis: coll.Axis, seed: int
                        ) -> torch.Tensor:
    """Sum of ``x`` ((n,) fp, n divisible by the axis size) over ``axis``
    with int8-quantized hops -> (n,) fp32. As in the reference, a rank
    keeps the chunk it reduced in fp32 and takes the others dequantized,
    so ranks agree up to one quantization of each chunk."""
    p = axis.size
    n = x.shape[0]
    if n % p:
        raise ValueError(f"length {n} must divide the axis size {p}")
    idx = axis.index
    rank = axis.ranks[idx]
    acc = x.float().reshape(p, n // p).clone()
    # reduce-scatter: after p - 1 hops this rank holds the sum of chunk
    # (idx + 1) % p
    for step in range(p - 1):
        send = acc[(idx - step) % p]
        q, s = quantize(send, hop_noise(seed, step, rank, send.numel(),
                                        x.device))
        q_r = coll.ppermute(q, axis)
        s_r = coll.ppermute(s.reshape(1), axis)[0]
        acc[(idx - step - 1) % p] += dequantize(q_r, s_r)
    own = (idx + 1) % p
    mine = acc[own].clone()
    out = torch.zeros_like(acc)
    out[own] = mine
    q, s = quantize(mine, hop_noise(seed, _GATHER_HOP, rank, mine.numel(),
                                    x.device))
    s = s.reshape(1)
    for step in range(p - 1):
        q = coll.ppermute(q, axis)
        s = coll.ppermute(s, axis)
        out[(own - step - 1) % p] = dequantize(q, s[0])
    return out.reshape(n)
