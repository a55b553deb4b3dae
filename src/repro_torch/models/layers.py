"""Shared building blocks (counterpart of ``repro/models/layers.py``): norms,
RoPE, SwiGLU MLP, the per-row causal-conv tail and the fan-in
truncated-normal initializer."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["dense_init", "masked_conv_tail", "rms_norm", "rope", "swiglu",
           "mlp_init"]

_SQRT2 = math.sqrt(2.0)


def _trunc_normal(shape, gen: torch.Generator, device) -> torch.Tensor:
    """Standard normal truncated to [-2, 2] by inverting the CDF of a
    uniform draw from ``gen`` (the construction ``jax.random
    .truncated_normal`` uses; the numbers differ, the law does not)."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / _SQRT2))
    hi = 0.5 * (1.0 + math.erf(2.0 / _SQRT2))
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    p = lo + u * (hi - lo)
    return (_SQRT2 * torch.erfinv(2.0 * p - 1.0)).clamp_(-2.0, 2.0)


def dense_init(gen: torch.Generator, shape, in_axis: int = -2,
               device=None) -> torch.Tensor:
    """Truncated-normal fan-in init, fp32 master weights."""
    fan_in = shape[in_axis]
    return _trunc_normal(shape, gen, device) * (1.0 / math.sqrt(fan_in))


def masked_conv_tail(x: torch.Tensor, lengths: torch.Tensor,
                     w1: int) -> torch.Tensor:
    """Per-row causal-conv tail for right-padded batched prefill: the ``w1``
    rows of ``x`` (B, L, C) just before each row's ``lengths[b]`` position,
    what a token-by-token decode of the same prompt would hold in its conv
    cache. Rows shorter than ``w1`` are zero-filled, as a zero-initialized
    decode conv cache is."""
    idx = (lengths.to(x.device).long()[:, None] - w1
           + torch.arange(w1, device=x.device)[None])  # (B, w1)
    tail = torch.gather(
        x, 1, idx.clamp(0, x.shape[1] - 1)[..., None].expand(-1, -1,
                                                             x.shape[2]))
    return torch.where((idx >= 0)[..., None], tail,
                       torch.zeros((), dtype=x.dtype, device=x.device))


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm with the ``1 + scale`` convention (zero-init scale = identity)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, half-split layout. x: (..., L, H, hd), positions:
    (..., L)."""
    hd = x.shape[-1]
    half = hd // 2
    ar = torch.arange(0, half, dtype=torch.float32, device=x.device)
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=x.device), -ar / half)
    ang = positions[..., None].float() * freqs  # (..., L, half)
    cos = torch.cos(ang)[..., None, :]  # (..., L, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
           w3: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP: (x@w1).silu * (x@w3) @ w2. Weights cast to compute dtype
    (a no-op for weights the caller already holds in that dtype)."""
    dt = x.dtype
    h = F.silu(x @ w1.to(dt)) * (x @ w3.to(dt))
    return h @ w2.to(dt)


def mlp_init(gen: torch.Generator, d: int, f: int, count: int,
             device=None) -> dict:
    """``count`` stacked SwiGLU layers: w1/w3 (count, d, f), w2 (count, f, d)."""
    return {
        "w1": dense_init(gen, (count, d, f), device=device),
        "w2": dense_init(gen, (count, f, d), device=device),
        "w3": dense_init(gen, (count, d, f), device=device),
    }
