"""GQA attention with a dense ring-buffer KV cache (counterpart of
``repro/models/attention.py``, attention family, dense layout).

Prefill attention is plain PyTorch: fp32 scores with the causal (and
sliding-window) mask, fp32 softmax, output cast back to the compute dtype
— the reference computes it outside any Pallas kernel too
(``blockwise_attention``). Decode attention goes through the
``flash_decode`` kernel (:mod:`repro_torch.kernels.ops`).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import dense_init, rope

__all__ = ["init", "attention", "prefill", "init_cache", "decode"]

_NEG = -1e30


def init(gen: torch.Generator, cfg: ArchConfig, count: int, device=None) -> dict:
    """``count`` stacked layers of q/k/v/o projections, (count, in, out)."""
    d = cfg.d_model
    return {
        "wq": dense_init(gen, (count, d, cfg.d_attn), device=device),
        "wk": dense_init(gen, (count, d, cfg.d_kv), device=device),
        "wv": dense_init(gen, (count, d, cfg.d_kv), device=device),
        "wo": dense_init(gen, (count, cfg.d_attn, d), device=device),
    }


def _qkv(p: dict, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor):
    b, l, _ = x.shape
    dt = x.dtype
    q = (x @ p["wq"].to(dt)).reshape(b, l, cfg.n_heads, cfg.head_dim)
    k = (x @ p["wk"].to(dt)).reshape(b, l, cfg.n_kv_heads, cfg.head_dim)
    v = (x @ p["wv"].to(dt)).reshape(b, l, cfg.n_kv_heads, cfg.head_dim)
    if cfg.use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool, window: int = 0) -> torch.Tensor:
    """(B, L, H, hd) queries against (B, L, KV, hd) keys/values -> (B, L, H,
    hd) in q's dtype; fp32 scores and softmax, masked entries -1e30."""
    b, l, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qf = q.float().reshape(b, l, kvh, g, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float()) * (1.0 / hd ** 0.5)
    qpos = torch.arange(l, device=q.device)[:, None]
    kpos = torch.arange(l, device=q.device)[None, :]
    ok = torch.ones((l, l), dtype=torch.bool, device=q.device)
    if causal:
        ok = kpos <= qpos
    if window > 0:
        ok = ok & (kpos > qpos - window)
    scores = torch.where(ok, scores, torch.full_like(scores, _NEG))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(b, l, h, hd).to(q.dtype)


def prefill(p: dict, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor,
            max_seq: int, *, window: int | None = None,
            lengths: torch.Tensor | None = None) -> tuple[torch.Tensor, dict]:
    """Forward + KV-cache build -> (out (B, L, d), {"k", "v"} (B, s_c, KV,
    hd)).

    ``lengths`` (right-padded batched prefill): ring slot j holds the newest
    VALID position p ≡ j (mod s_c), p < lengths[b] — the state a
    token-by-token decode of the prompt would leave — and slots with no
    valid position stay zero. Pads sit after every valid position, so the
    causal mask keeps them out of the valid outputs.
    """
    b, l, _ = x.shape
    dt = x.dtype
    win = cfg.window if window is None else window
    q, k, v = _qkv(p, cfg, x, positions)
    out = attention(q, k, v, causal=cfg.causal and not cfg.encoder_only,
                    window=win)
    s_c = min(win, max_seq) if win else max_seq
    shape = (b, s_c, cfg.n_kv_heads, cfg.head_dim)
    if lengths is not None:
        j = torch.arange(s_c, device=x.device)
        last = lengths.to(x.device).long()[:, None] - 1
        pj = last - torch.remainder(last - j[None], s_c)  # (B, s_c)
        live = (pj >= 0)[..., None, None]
        rows = torch.arange(b, device=x.device)[:, None]
        pc = pj.clamp(0, l - 1)
        ck = torch.where(live, k[rows, pc], torch.zeros((), dtype=dt,
                                                        device=x.device))
        cv = torch.where(live, v[rows, pc], torch.zeros((), dtype=dt,
                                                        device=x.device))
    elif l <= s_c:
        ck = torch.zeros(shape, dtype=dt, device=x.device)
        cv = torch.zeros(shape, dtype=dt, device=x.device)
        ck[:, :l] = k
        cv[:, :l] = v
    else:  # ring buffer: keep the last s_c keys at their ring slots
        slots = torch.arange(l - s_c, l, device=x.device) % s_c
        ck = torch.zeros(shape, dtype=dt, device=x.device)
        cv = torch.zeros(shape, dtype=dt, device=x.device)
        ck[:, slots] = k[:, l - s_c:]
        cv[:, slots] = v[:, l - s_c:]
    out = out.reshape(b, l, cfg.d_attn) @ p["wo"].to(dt)
    return out, {"k": ck.to(dt), "v": cv.to(dt)}


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, dtype,
               window: int | None = None, device=None) -> dict:
    """Zeroed dense KV ring, (batch, s_c, KV, hd) per leaf."""
    win = cfg.window if window is None else window
    s_c = min(win, max_seq) if win else max_seq
    shape = (batch, s_c, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode(p: dict, cfg: ArchConfig, x: torch.Tensor, cache: dict,
           pos: torch.Tensor, *, window: int | None = None
           ) -> tuple[torch.Tensor, dict]:
    """Single-token decode against the dense per-slot KV ring.

    The new token's K/V are written IN PLACE at ring slot ``pos % s_c`` of
    ``cache`` (the reference returns an updated copy; overwriting saves a
    full cache copy per layer and step), then ``flash_decode`` attends over
    the first ``min(pos + 1, s_c)`` slots.
    """
    b = x.shape[0]
    dt = x.dtype
    s_c = cache["k"].shape[1]
    q, k, v = _qkv(p, cfg, x, pos[:, None])
    slot = torch.remainder(pos.long(), s_c)
    ar = torch.arange(b, device=x.device)
    cache["k"][ar, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][ar, slot] = v[:, 0].to(cache["v"].dtype)
    lengths = torch.clamp(pos + 1, max=s_c).to(torch.int32)
    o = ops.flash_decode(q[:, 0], cache["k"], cache["v"], lengths)
    out = o.to(dt).reshape(b, 1, cfg.d_attn) @ p["wo"].to(dt)
    return out, cache
