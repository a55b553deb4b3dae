"""Mixture-of-Experts FFN with sort-based dispatch (counterpart of
``repro/models/moe.py``'s single-device ``forward``).

Each token's top-k expert assignments are flattened and sorted by expert id
(a stable sort); an assignment's rank within its expert's segment maps it to
a fixed-capacity slot, and overflow rides in a trash slot ``cap`` and is
dropped (capacity-factor semantics). The expert SwiGLUs run as batched
products over the (E, cap + 1, d) buffer. The router is an exact E-way
softmax.

Two choices keep the dispatch and the combine deterministic and equal to the
reference's:

* **Router ties.** ``lax.top_k`` breaks ties toward the lower expert index;
  the port selects through a stable descending sort, which does the same
  (router logits are bf16 cast to fp32, so ties among experts are real).
* **The combine.** The reference scatter-adds each assignment's output into
  its token in the compute dtype, in sorted order. The port puts every
  assignment back at its (token, k) place and sums a token's ``kx`` terms
  in that order (ascending sorted position, i.e. ascending expert id),
  starting from zero in the compute dtype: no atomics, so repeated runs
  and decode windows of any length give the same bits.

Pad tokens of a padded prefill route like any token and take capacity from
real ones, as in the reference.

:data:`TRACE` (None by default) is a measurement hook: set it to a list and
each call appends ``{"dropped", "assigned", "load"}`` device tensors (the
assignments that fell past capacity, all assignments, tokens per expert).
Under activation checkpointing a recomputed layer appends again.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import dense_init

__all__ = ["init", "forward", "route", "capacity", "TRACE"]

TRACE: list | None = None


def init(gen: torch.Generator, cfg: ArchConfig, count: int,
         device=None) -> dict:
    """``count`` stacked MoE layers: router (count, d, E), experts (count,
    E, d, f) / (count, E, f, d), fp32."""
    d, f, e = cfg.d_model, cfg.expert_d_ff, cfg.n_experts
    return {
        "router": dense_init(gen, (count, d, e), device=device),
        "w1": dense_init(gen, (count, e, d, f), device=device),
        "w2": dense_init(gen, (count, e, f, d), device=device),
        "w3": dense_init(gen, (count, e, d, f), device=device),
    }


def capacity(cfg: ArchConfig, t: int) -> int:
    """Slots per expert for ``t`` tokens: the capacity factor's share,
    truncated, rounded up to a multiple of 8, at least 8."""
    c = int(cfg.capacity_factor * t * cfg.experts_per_token / cfg.n_experts)
    return max(8, ((c + 7) // 8) * 8)


def route(p: dict, cfg: ArchConfig, x: torch.Tensor) -> dict:
    """The router and the sort-based dispatch of x (T, d).

    Returns {"probs" (T, E) fp32, "gates" (T, kx) fp32 renormalized,
    "idx" (T, kx) expert ids, "order" (T·kx,) the stable sort of the
    flattened ids, "sorted_e", "tok" (source token per sorted position),
    "rank" (position within the expert's segment), "keep" (rank < cap),
    "slot" (rank, or the trash slot cap), "cap"}."""
    t = x.shape[0]
    e, kx = cfg.n_experts, cfg.experts_per_token
    cap = capacity(cfg, t)
    logits = (x @ p["router"].to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    vals, pos = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = vals[:, :kx], pos[:, :kx]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    flat_e = idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    seg_start = torch.searchsorted(
        sorted_e, torch.arange(e, device=x.device), side="left")
    rank = torch.arange(t * kx, device=x.device) - seg_start[sorted_e]
    keep = rank < cap
    return {"probs": probs, "gates": gates, "idx": idx, "order": order,
            "sorted_e": sorted_e, "tok": order // kx, "rank": rank,
            "keep": keep, "slot": torch.where(keep, rank,
                                              torch.full_like(rank, cap)),
            "cap": cap}


def forward(p: dict, cfg: ArchConfig, x: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (T, d) -> (out (T, d) in x's dtype, aux loss () fp32: the
    Switch-style E · Σ_e f_e P_e)."""
    t, d = x.shape
    e, kx = cfg.n_experts, cfg.experts_per_token
    dt = x.dtype
    r = route(p, cfg, x)
    load = torch.bincount(r["idx"].reshape(-1), minlength=e)
    aux = e * torch.sum(r["probs"].mean(0) * (load.float() / (t * kx)))
    if TRACE is not None:
        TRACE.append({"dropped": (~r["keep"]).sum(), "assigned": t * kx,
                      "load": load})

    sorted_e, slot, keep, tok = r["sorted_e"], r["slot"], r["keep"], r["tok"]
    buf = torch.zeros((e, r["cap"] + 1, d), dtype=dt, device=x.device)
    buf = buf.index_put((sorted_e, slot), torch.where(
        keep[:, None], x[tok], torch.zeros((), dtype=dt, device=x.device)))
    h = F.silu(torch.bmm(buf, p["w1"].to(dt))) * torch.bmm(buf,
                                                           p["w3"].to(dt))
    y = torch.bmm(h, p["w2"].to(dt))  # (E, cap + 1, d)

    w = (r["gates"].reshape(-1)[r["order"]] * keep).to(dt)
    contrib = y[sorted_e, slot] * w[:, None]  # (T·kx, d), sorted order
    # back to (token, k) places; then each token's terms in ascending
    # sorted position, the order of the reference's scatter-add
    inv = torch.empty_like(r["order"])
    inv[r["order"]] = torch.arange(t * kx, device=x.device)
    by_pos = torch.sort(inv.reshape(t, kx), dim=-1).values  # (T, kx)
    terms = contrib[by_pos]  # (T, kx, d)
    out = torch.zeros((t, d), dtype=dt, device=x.device)
    for j in range(kx):
        out = out + terms[:, j]
    return out, aux
