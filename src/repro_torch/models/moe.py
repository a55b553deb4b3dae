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

**Distributed** (:func:`forward_dist`, the reference's ``forward_dist``):
routing and dispatch stay data-local; the experts are split over the
mesh's ``model`` axis — the expert dim in "ep", else the FFN hidden
("tp"), as :func:`repro_torch.launch.mesh.moe_mode` places them (the one
switch, ``launch.mesh.MOE_SHARDING``, decides storage and compute alike) —
and the one cross-rank collective is a sum of the combined (T_loc, d)
output.

:data:`TRACE` (None by default) is a measurement hook: set it to a list and
each call appends ``{"dropped", "assigned", "load"}`` device tensors (the
assignments that fell past capacity, all assignments, tokens per expert).
Under activation checkpointing a recomputed layer appends again.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import collectives as coll
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import dense_init

__all__ = ["init", "forward", "forward_dist", "route", "capacity", "TRACE"]

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


def forward(p: dict, cfg: ArchConfig, x: torch.Tensor,
            expert_offset: int = 0, n_local: int = 0
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (T, d) -> (out (T, d) in x's dtype, aux loss () fp32: the
    Switch-style E · Σ_e f_e P_e).

    With ``n_local`` set (expert parallelism), only the experts
    ``[expert_offset, expert_offset + n_local)`` run — ``p``'s expert
    weights then hold those ``n_local`` — and the output is a PARTIAL sum:
    assignments to other experts contribute zero (the caller sums over the
    expert-parallel axis). Routing and aux are the full layer's."""
    t, d = x.shape
    e, kx = cfg.n_experts, cfg.experts_per_token
    e_here = n_local or e
    dt = x.dtype
    r = route(p, cfg, x)
    load = torch.bincount(r["idx"].reshape(-1), minlength=e)
    aux = e * torch.sum(r["probs"].mean(0) * (load.float() / (t * kx)))
    if TRACE is not None:
        TRACE.append({"dropped": (~r["keep"]).sum(), "assigned": t * kx,
                      "load": load})

    sorted_e, slot, keep, tok = r["sorted_e"], r["slot"], r["keep"], r["tok"]
    if n_local:
        loc_e = sorted_e - expert_offset
        mine = (loc_e >= 0) & (loc_e < e_here)
        keep = keep & mine
        slot = torch.where(keep, slot, torch.full_like(slot, r["cap"]))
        sorted_e = torch.where(mine, loc_e, torch.zeros_like(loc_e))
    buf = torch.zeros((e_here, r["cap"] + 1, d), dtype=dt, device=x.device)
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


def forward_dist(p: dict, cfg: ArchConfig, x: torch.Tensor, mesh
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The MoE layer with its experts split over ``mesh``'s model axis:
    ``p`` holds this rank's experts ("ep": ``E / tp`` of them, full width)
    or every expert's slice of the FFN hidden ("tp"), as
    :func:`repro_torch.launch.mesh.moe_mode` places them. x: this data rank's
    (T, d) -> (out (T, d), aux ()), the same on every model rank.

    Routing is data-local and replicated over the model axis; the local
    experts run through :func:`forward`, then one sum of the combined
    (T, d) output over the axis (Megatron's row-parallel reduce, after the
    linear combine) and the mean of aux. ``x`` and the router weight enter
    through :func:`repro_torch.collectives.copy_to`, so their gradients sum
    every rank's terms."""
    ax = mesh.model
    mp = ax.size
    use_ep = mesh_lib.moe_mode(cfg, mp) == "ep"
    xin = coll.copy_to(x, ax)
    p_loc = dict(p, router=coll.copy_to(p["router"], ax))
    if use_ep:
        e_loc = cfg.n_experts // mp
        out_p, aux = forward(p_loc, cfg, xin, expert_offset=ax.index * e_loc,
                             n_local=e_loc)
    else:
        out_p, aux = forward(p_loc, cfg, xin)
    out = coll.reduce_from(out_p, ax)
    aux = coll.reduce_from(aux, ax) / mp
    return out, aux
