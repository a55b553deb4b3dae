"""Griffin / RecurrentGemma recurrent block: conv + RG-LRU (counterpart of
``repro/models/rglru.py``).

The RG-LRU linear recurrence ``h_t = a_t ⊙ h_{t-1} + sqrt(1-a_t²) ⊙ (i_t ⊙
u_t)`` is associative over (a, b) pairs, (a₂,b₂)∘(a₁,b₁) = (a₁a₂, a₂b₁+b₂).
Training and prefill evaluate it with a Hillis–Steele doubling scan over the
sequence (log₂ L elementwise steps, fp32) where the reference calls
``jax.lax.associative_scan``; the two sum in different orders, so they agree
to rounding, not bit for bit. Decode is the O(1) state update. Gate
projections are block-diagonal (8 blocks), as in Griffin, and run in fp32;
``1 - a²`` is ``-expm1(2 log a)`` for stability near a → 1. The gelu is the
tanh approximation (``jax.nn.gelu``'s default).

**On a mesh** (``mesh=``), with ``tp`` dividing the 8 gate blocks: each
rank runs its ``W / tp`` channels, whole gate blocks — ``w_gate_branch``
/ ``w_in`` column-split, ``w_a`` / ``w_i`` gathered over ``model`` (the
reference splits each block's output columns) and cut to its blocks,
``lam`` and the conv taps sliced to its channels, ``w_out`` row-split —
and its decode ``state`` is its channels'. The conv tail stays whole on
every rank (the reference's cache placement), so prefill and decode
gather the tail. Where ``tp`` does not divide the 8 gate blocks (tp 16),
a split of the width would cut a gate block: every rank then computes
the whole block (:func:`repro_torch.models.tp.replicated`), and its decode
gathers the ``state``, whose width the reference's cache placement still
splits over ``model``, and keeps its own channels of the new one.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import collectives as coll
from repro_torch.models import tp as tp_lib
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import dense_init, masked_conv_tail
from repro_torch.models.ssm import _causal_conv, softplus

__all__ = ["init", "forward", "init_cache", "cache_bytes_per_slot", "decode",
           "scan"]

_N_BLOCKS = 8
_C_SCALE = 8.0  # Griffin's fixed `c` multiplier on the recurrence gate


def init(gen: torch.Generator, cfg: ArchConfig, count: int,
         device=None) -> dict:
    """``count`` stacked recurrent mixers, fp32, in the reference's
    structure."""
    d, w = cfg.d_model, cfg.lru_dim
    wb = w // _N_BLOCKS
    lam = torch.linspace(2.0, 6.0, w, dtype=torch.float32, device=device)
    return {
        "w_gate_branch": dense_init(gen, (count, d, w), device=device),
        "w_in": dense_init(gen, (count, d, w), device=device),
        "conv": dense_init(gen, (count, cfg.conv_width, w), in_axis=1,
                           device=device),
        "w_a": dense_init(gen, (count, _N_BLOCKS, wb, wb), device=device),
        "w_i": dense_init(gen, (count, _N_BLOCKS, wb, wb), device=device),
        # Λ such that a^c = sigmoid(Λ)^c spreads over (0.9, 0.999)
        "lam": lam[None].repeat(count, 1),
        "w_out": dense_init(gen, (count, w, d), device=device),
    }


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def _gates(p: dict, u: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Block-diagonal gate projections in fp32. u: (..., W) -> (log_a,
    gate_i), both (..., W) fp32 (W: the channels of ``p``'s blocks)."""
    shp = u.shape
    w = shp[-1]
    nb = p["w_a"].shape[0]
    ub = u.reshape(shp[:-1] + (nb, w // nb)).float()
    r = torch.sigmoid(torch.einsum("...nk,nkj->...nj", ub, p["w_a"]))
    gi = torch.sigmoid(torch.einsum("...nk,nkj->...nj", ub, p["w_i"]))
    # log a_t = -c * softplus(Λ) * r_t   (a in (0, 1), near 1 for small r)
    log_a = -_C_SCALE * softplus(p["lam"]) * r.reshape(shp)
    return log_a, gi.reshape(shp)


def scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of h_t = a_t h_{t-1} + b_t (h_{-1} = 0) along axis 1,
    by Hillis–Steele doubling: at offset s every position combines with the
    prefix ending s places before it. (B, L, W) fp32 -> h (B, L, W)."""
    l = a.shape[1]
    s = 1
    while s < l:
        a_prev = F.pad(a[:, :-s], (0, 0, s, 0), value=1.0)
        b_prev = F.pad(b[:, :-s], (0, 0, s, 0), value=0.0)
        a, b = a * a_prev, a * b_prev + b
        s *= 2
    return b


class _Split:
    """This rank's channels ``[c0, c0 + w)`` and gate blocks ``[n0, n0 +
    nb)``; ``ax`` is None off a mesh; ``rep``: the whole block on every
    rank (``tp`` not dividing the gate blocks), whose stored ``state``
    holds channels ``[s0, s0 + sw)``."""

    def __init__(self, cfg: ArchConfig, mesh):
        ax = tp_lib.model_axis(mesh)
        tp, m = (1, 0) if ax is None else (ax.size, ax.index)
        self.ax = ax
        self.rep = _N_BLOCKS % tp != 0
        # the stored state's channels (cache_shardings: the width over
        # model where it divides)
        whole = cfg.lru_dim % tp != 0 or cfg.lru_dim < tp
        self.sw = cfg.lru_dim if whole else cfg.lru_dim // tp
        self.s0 = 0 if whole else m * self.sw
        if self.rep:
            tp, m = 1, 0
        self.w = cfg.lru_dim // tp
        self.c0 = m * self.w
        self.nb = _N_BLOCKS // tp
        self.n0 = m * self.nb

    @property
    def split(self) -> bool:
        """Megatron-split over ``model``."""
        return self.ax is not None and not self.rep


def _leaves(p: dict, spec: dict | None, mesh, sp: _Split) -> dict:
    """The leaves this rank computes with: its channels' and gate
    blocks' on the Megatron route, all of them on the replicated one."""
    if sp.ax is None:
        return p
    if sp.rep:
        return {k: tp_lib.replicated(v, spec[k], mesh)
                for k, v in p.items()}
    ax = sp.ax
    out = dict(p)
    for k in ("w_a", "w_i"):
        full = tp_lib.whole(p[k], spec[k], mesh)
        out[k] = full[sp.n0:sp.n0 + sp.nb]
    out["lam"] = tp_lib.local(p["lam"], ax, 0, sp.c0, sp.w)
    out["conv"] = tp_lib.local(p["conv"], ax, 1, sp.c0, sp.w)
    return out


def _full_tail(tail: torch.Tensor, sp: _Split) -> torch.Tensor:
    """This rank's channels of a conv tail -> the whole tail (gathered)."""
    if not sp.split:
        return tail
    return torch.cat(coll.all_gather(tail, sp.ax).unbind(0), dim=-1)


def _rglru(p: dict, u: torch.Tensor,
           lengths: torch.Tensor | None = None) -> torch.Tensor:
    """u: (B, L, W) conv output -> the recurrence's output, fp32."""
    log_a, gi = _gates(p, u)
    if lengths is not None:  # pads become the identity (a = 1, b = 0)
        valid = (torch.arange(u.shape[1], device=u.device)[None, :]
                 < lengths.to(u.device)[:, None])
        log_a = torch.where(valid[..., None], log_a,
                            torch.zeros((), device=u.device))
    a = torch.exp(log_a)
    beta = torch.sqrt(-torch.expm1(2.0 * log_a))  # sqrt(1 - a^2)
    return scan(a, beta * gi * u.float())


def forward(p: dict, cfg: ArchConfig, x: torch.Tensor,
            return_cache: bool = False,
            lengths: torch.Tensor | None = None, mesh=None,
            spec: dict | None = None):
    """(B, L, d) -> (B, L, d) [, cache {"state" (B, W) fp32, "conv" (B,
    width-1, W)}]. ``spec``: the layer's per-layer specs, on a mesh. ``lengths`` (right-padded batched prefill): pads get
    log a = 0, the recurrence's identity, so the cached state is the state
    after each row's last valid token."""
    dt = x.dtype
    sp = _Split(cfg, mesh)
    p = _leaves(p, spec, mesh, sp)
    if sp.split:
        x = coll.copy_to(x, sp.ax)
    gate = _gelu(x @ p["w_gate_branch"].to(dt))
    u_raw = x @ p["w_in"].to(dt)
    u = _causal_conv(u_raw, p["conv"].to(dt))
    h = _rglru(p, u, lengths=lengths)
    out = (h.to(dt) * gate) @ p["w_out"].to(dt)
    if sp.split:
        out = coll.reduce_from(out, sp.ax)
    if not return_cache:
        return out
    w1 = cfg.conv_width - 1
    tail = (u_raw[:, -w1:] if lengths is None
            else masked_conv_tail(u_raw, lengths, w1))
    state = h[:, -1]
    if sp.rep and sp.sw < cfg.lru_dim:  # the stored state: its channels
        state = state[:, sp.s0:sp.s0 + sp.sw]
    return out, {"state": state, "conv": _full_tail(tail, sp)}


def init_cache(cfg: ArchConfig, batch: int, dtype, device=None) -> dict:
    """Per-slot decode state, fixed-size in the sequence (a (W,) fp32 state
    and the conv tail): slot-resident in the paged layout too."""
    w = cfg.lru_dim
    return {"state": torch.zeros((batch, w), dtype=torch.float32,
                                 device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, w), dtype=dtype,
                                device=device)}


def cache_bytes_per_slot(cfg: ArchConfig, dtype) -> int:
    """Device bytes one serving slot's RG-LRU state costs (max_seq-free)."""
    w = cfg.lru_dim
    itemsize = torch.empty((), dtype=dtype, device="meta").element_size()
    return 4 * w + (cfg.conv_width - 1) * w * itemsize


def decode(p: dict, cfg: ArchConfig, x: torch.Tensor, cache: dict,
           mesh=None, spec: dict | None = None
           ) -> tuple[torch.Tensor, dict]:
    """x: (B, 1, d) -> ((B, 1, d), new cache): the O(1) recurrent update,
    the conv taken in fp32 against the fp32 ``conv``."""
    dt = x.dtype
    sp = _Split(cfg, mesh)
    p = _leaves(p, spec, mesh, sp)
    if sp.split:
        x = coll.copy_to(x, sp.ax)
    gate = _gelu(x @ p["w_gate_branch"].to(dt))  # (B, 1, W)
    u = x @ p["w_in"].to(dt)
    tail = cache["conv"][..., sp.c0:sp.c0 + sp.w]  # every channel cached
    window = torch.cat([tail, u], dim=1)  # (B, width, W)
    u_c = torch.einsum("bwc,wc->bc", window.float(),
                       p["conv"].float()).to(dt)  # (B, W)
    log_a, gi = _gates(p, u_c)
    a = torch.exp(log_a)
    beta = torch.sqrt(-torch.expm1(2.0 * log_a))
    state = cache["state"]
    if sp.rep and sp.sw < cfg.lru_dim:  # every channel's, from the shares
        state = torch.cat(coll.all_gather(state, sp.ax).unbind(0), dim=-1)
    h = a * state + beta * gi * u_c.float()
    out = (h[:, None].to(dt) * gate) @ p["w_out"].to(dt)
    if sp.split:
        out = coll.reduce_from(out, sp.ax)
    new_tail = torch.cat([cache["conv"], _full_tail(u, sp)], dim=1)[:, 1:]
    if sp.rep and sp.sw < cfg.lru_dim:
        h = h[:, sp.s0:sp.s0 + sp.sw]
    return out, {"state": h, "conv": new_tail}
