"""The least work of a call, and the least time it needs at the card's
peaks: what the call's inputs need, whatever implements it.

Counted from the inputs, the reference's own packing of the index and the
reference's draws; never from the program's counters, routes or capacity
ceilings. Every distinct row a call must read is counted once, at 4 bytes a
float32; a score is 2·d operations.
"""
from __future__ import annotations

import json
from pathlib import Path

import torch

from bench.reference import loglinear as ll

PEAKS = Path(__file__).resolve().parent.parent / "peaks.json"


def peaks(kind: str) -> dict | None:
    """The data-sheet peaks of the card named ``kind`` (None for a card the
    table does not hold)."""
    for name, p in json.loads(PEAKS.read_text())["cards"].items():
        if name in kind:
            return p
    return None


def least_s(nbytes: float, flops: float, peak: dict) -> tuple[float, str]:
    """(least seconds, the bound that binds: "bytes" or "flops")."""
    t_b = nbytes / peak["hbm_bytes_per_s"]
    t_f = flops / peak["fp32_flops_per_s"]
    return max(t_b, t_f), ("bytes" if t_b >= t_f else "flops")


def add(acc: dict, name: str, nbytes: float, flops: float) -> None:
    b, f = acc.get(name, (0.0, 0.0))
    acc[name] = (b + nbytes, f + flops)


def probe(acc: dict, q: torch.Tensor, tables: dict, n_probe: int) -> None:
    """``ivf_gather_score``: the live member rows of the distinct probed
    clusters (row and id) once, the probe list and the queries in, a score
    and an id out per live (query, member); ``probe`` adds the centroids and
    the overflow's live rows, each scored by every query."""
    b, d = q.shape
    cent = tables["centroids"]
    live = tables["live_per_cluster"]
    _, pr = ll.top_k(ll.mm(q, cent.T, "fp64"), n_probe)
    uniq = torch.unique(pr)
    rows = float(live[uniq].sum())
    pairs = float(live[pr].sum())
    add(acc, "ivf_gather_score", rows * (4 * d + 4) + b * n_probe * 4
        + b * d * 4 + pairs * 8, 2.0 * d * pairs)
    o_live = tables["overflow_live"]
    n_c = cent.shape[0]
    add(acc, "probe", rows * (4 * d + 4) + n_c * d * 4 + o_live * (4 * d + 4)
        + b * d * 4, 2.0 * d * (pairs + b * (n_c + o_live)))


def tail(acc: dict, keys, s_ids, s_vals, cfg: dict, d: int) -> None:
    """Algorithm 2's tail: the distinct rows of the live tail atoms once,
    one score per live atom."""
    n, l, m_cap = cfg["n"], cfg["l"], cfg["m_cap"]
    ids_clean, kv = ll.sanitize(s_ids, s_vals, n)
    draws = ll.tail_draws(keys, ids_clean, kv, n, l, m_cap)
    m = torch.clamp(draws.m, max=m_cap)
    live = (torch.arange(m_cap, device=m.device)[None, :] < m[:, None])
    rows = float(torch.unique(draws.pos[live]).numel())
    add(acc, "tail", rows * 4 * d, 2.0 * d * float(m.sum()))


def estimator(acc: dict, keys, s_ids, s_vals, cfg: dict, d: int) -> None:
    """Algorithm 3 (``fused_estimator``): the distinct live S ∪ T rows
    once, the candidate ids and weights and the queries in, log Ẑ out; one
    score per live candidate."""
    ids, log_w = ll.logz_candidates(keys, s_ids, s_vals, cfg["n"], cfg["l"])
    live = torch.isfinite(log_w)
    rows = float(torch.unique(ids[live]).numel())
    b, m = ids.shape
    add(acc, "fused_estimator", rows * 4 * d + b * m * 8 + b * d * 4 + b * 4,
        2.0 * d * float(live.sum()))
