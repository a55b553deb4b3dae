"""Lazy-Gumbel sampling (counterpart of ``repro/core/gumbel.py``; the
theory is documented there and in DESIGN.md §3): Algorithm 1
(:func:`sample_adaptive_b`, the adaptive cutoff), Algorithm 2
(:func:`sample_fixed_b`, the fixed cutoff), both with the Poissonized tail,
Gumbel top-k without replacement over the same pool (:func:`topk_fixed_b`),
the brute-force oracle :func:`gumbel_max_dense`, and the certificates: the
sampler's (:func:`certificate`) and the adaptive probe's stopping rule
(:func:`gap_certificate`).

Where the reference vmaps a per-token function, these functions take a
leading token dimension t. The random numbers come from the
counter-based generator of :mod:`repro_torch.core.rng` (``keys``), or are
injected whole through ``draws`` (:class:`repro_torch.core.rng.Draws`) —
which is how the parity tests feed the reference's own draws in.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from repro_torch.core import rng
from repro_torch.core.complement import complement_map

__all__ = [
    "TopK",
    "SampleResult",
    "TopKSampleResult",
    "TailPlan",
    "default_kl",
    "plan_tail",
    "certificate",
    "gap_certificate",
    "cutoff",
    "sample_adaptive_b",
    "sample_fixed_b",
    "topk_fixed_b",
    "gumbel_max_dense",
    "default_m_cap",
]


class TopK(NamedTuple):
    """Top-k set S: ids and their unnormalized log-probs (any order)."""

    ids: torch.Tensor  # (..., k) integer
    values: torch.Tensor  # (..., k) float32


class SampleResult(NamedTuple):
    index: torch.Tensor  # (t,) int64 — the sampled element of [0, n)
    ok: torch.Tensor  # (t,) bool — True => provably exact (given MIPS gap <= c)
    m: torch.Tensor  # (t,) int64 — tail candidates materialized
    max_val: torch.Tensor  # (t,) f32 — winning perturbed value
    bound: torch.Tensor  # (t,) f32 — S_min + c + B
    overflow: torch.Tensor  # (t,) bool — static tail buffer overflowed
    width: torch.Tensor | None = None  # (t,) int64 — effective probe width
    #   when the adaptive staged probe produced the top-k, -1 on fixed-width
    #   paths (the serving engine bins it into stats["probe_width_hist"])


class TailPlan(NamedTuple):
    """The data-independent part of the Poissonized tail draw: positions,
    heights and live count, decided before any tail score is computed. The
    fused tail kernel consumes it directly."""

    pos: torch.Tensor  # (t, m_cap) int64 tail positions (complement of S)
    heights: torch.Tensor  # (t, m_cap) f32 truncated-Gumbel heights B + Exp(1)
    m_used: torch.Tensor  # (t,) int64 materialized tail candidates (<= m_cap)
    overflow: torch.Tensor  # (t,) bool Poisson draw exceeded the buffer


def default_kl(n: int, delta: float = 1e-4, c: float = 0.0) -> int:
    """k = l satisfying Thm 3.3's ``k l >= n e^c ln(1/δ)``, rounded up to 64."""
    kl = math.sqrt(n * math.exp(c) * math.log(1.0 / delta))
    return max(64, int(math.ceil(kl / 64.0)) * 64)


def default_m_cap(l: int) -> int:
    """Static tail buffer ``l + 6 sqrt(l) + 8`` (overflow < 1e-8)."""
    return int(l + 6 * math.sqrt(l) + 8)


def _n_excluded(topk_ids: torch.Tensor, k_valid) -> torch.Tensor:
    t, k = topk_ids.shape
    if k_valid is None:
        return torch.full((t,), k, dtype=torch.int64, device=topk_ids.device)
    return torch.as_tensor(k_valid, device=topk_ids.device).long()


def plan_tail(keys, topk_ids: torch.Tensor, n, b: torch.Tensor, lam,
              m_cap: int, k_valid=None, draws: rng.Draws | None = None
              ) -> TailPlan:
    """Draw the Poissonized tail construction for cutoff ``b`` (t,) and atom
    rate ``lam``: atom count (Poisson), positions (iid uniform over the
    complement of the sorted S, with replacement), heights (B + Exp(1)).

    ``k_valid`` (t,) counts the live slots of S when the probe underfilled;
    the complement then has ``n - k_valid`` points. ``draws`` replaces the
    random numbers ``keys`` would give."""
    kv = _n_excluded(topk_ids, k_valid)
    if draws is None:
        hi = torch.clamp(n - kv, min=1)
        draws = rng.tail_draws(keys, k=topk_ids.shape[1], m_cap=m_cap, hi=hi,
                               lam=lam)
    m = draws.m.long()
    s_sorted = torch.sort(topk_ids.long(), dim=1).values
    pos = complement_map(draws.u.long(), s_sorted)
    heights = b.float()[:, None] + draws.exp.float()
    return TailPlan(pos, heights, torch.clamp(m, max=m_cap), m > m_cap)


def certificate(values: torch.Tensor, b: torch.Tensor, c: float,
                max_val: torch.Tensor, overflow: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Algorithm-2 exactness certificate per token -> (ok, bound).

    Dead S slots (value -inf) are not top-k members: S_min is the min over
    live slots only (all dead => +inf bound => ok False). A shard holding no
    points (s_min = +inf, b = -inf) gives bound -inf, not NaN."""
    vals = values.float()
    s_min = torch.where(torch.isneginf(vals), torch.full_like(vals, math.inf),
                        vals).amin(dim=-1)
    bound = s_min + c + b
    bound = torch.where(torch.isnan(bound), torch.full_like(bound, -math.inf),
                        bound)
    return (max_val >= bound) & ~overflow, bound


def gap_certificate(s_min: torch.Tensor, upper: torch.Tensor,
                    c: float = 0.0) -> torch.Tensor:
    """Adaptive-probe stopping rule, elementwise: the candidate pool is a
    certified c-approximate top-k (Def 3.1) iff every unprobed score is
    provably <= ``s_min + c``, where ``s_min`` is the k-th best candidate
    found and ``upper`` a sound bound on anything not yet probed
    (:func:`repro_torch.core.mips.adaptive.unprobed_bound_table`). An
    underfilled pool has ``s_min = -inf`` and passes only once nothing is
    left unprobed (``upper = -inf``)."""
    return upper <= s_min + c


def gumbel_max_dense(keys: torch.Tensor | None, y: torch.Tensor, *,
                     draws: torch.Tensor | None = None,
                     return_max: bool = False,
                     stream: int = rng.STREAM_DENSE):
    """Brute-force Gumbel-max oracle per token: ``argmax_i y_i + G_i`` over
    the last axis of ``y (t, n)`` (linear time) -> (t,) int64 indices, and
    with ``return_max`` the perturbed maxima (t,) f32 as well. The noise
    comes from ``keys`` ((t, 3) int64 rows, ``stream``: ``STREAM_DENSE``
    unless a caller needs an independent one) or is injected whole as
    ``draws`` ((t, n) f32). The first maximal index wins."""
    if draws is None:
        if keys is None:
            raise ValueError("gumbel_max_dense needs keys or draws")
        draws = rng.gumbel(keys, y.shape[-1], stream)
    mx, idx = torch.max(y.float() + draws, dim=-1)
    return (idx, mx) if return_max else idx


def _finish(topk: TopK, score_fn: Callable[[torch.Tensor], torch.Tensor],
            b: torch.Tensor, m_cap: int, c: float, pert_s: torch.Tensor,
            plan: TailPlan) -> SampleResult:
    """Tail scores + perturbed argmax over S ∪ tail given the plan."""
    y_tail = score_fn(plan.pos).float()  # (t, m_cap)
    live = (torch.arange(m_cap, device=y_tail.device)[None, :]
            < plan.m_used[:, None])
    pert_t = torch.where(live, y_tail + plan.heights,
                         torch.full_like(y_tail, -math.inf))
    pert = torch.cat([pert_s, pert_t], dim=1)
    ids = torch.cat([topk.ids.long(), plan.pos], dim=1)
    best = torch.argmax(pert, dim=1, keepdim=True)
    max_val = torch.gather(pert, 1, best)[:, 0]
    ok, bound = certificate(topk.values, b, c, max_val, plan.overflow)
    return SampleResult(torch.gather(ids, 1, best)[:, 0], ok, plan.m_used,
                        max_val, bound, plan.overflow,
                        torch.full_like(plan.m_used, -1))


def cutoff(n, k_valid: torch.Tensor, l: int) -> torch.Tensor:
    """Algorithm 2's fixed cutoff ``B = ln((n - k_valid) / l)``, float32."""
    return torch.log((torch.tensor(float(n), dtype=torch.float32,
                                   device=k_valid.device)
                      - k_valid.float()) / l)


def sample_adaptive_b(keys, topk: TopK, n, score_fn, *, m_cap: int,
                      c: float = 0.0, draws: rng.Draws | None = None
                      ) -> SampleResult:
    """Algorithm 1 (adaptive cutoff) per token. Exact whenever ``ok`` (no
    overflow).

    The cutoff is ``B = M - S_min - c`` with ``M`` the largest perturbed
    value of S, so the tail atom rate ``λ = (n - k) e^{-B}`` is per token.
    ``E[m] <= n e^c / k`` (Thm 3.2) but its tail is heavy: choose ``m_cap``
    a small multiple of ``n / k``; overflow probability decays like
    ``(n e^c / k) / m_cap``, and a count past ``m_cap`` sets ``overflow``
    and voids ``ok``. ``score_fn`` maps (t, m) ids to their (t, m)
    unnormalized log-probs. ``draws`` injects the raw random numbers (its
    ``m`` must then be the Poisson count at this λ)."""
    if keys is None and draws is None:
        raise ValueError("sample_adaptive_b needs keys or draws")
    k = topk.ids.shape[1]
    kv = _n_excluded(topk.ids, None)
    vals = topk.values.float()
    g_s = rng.gumbel(keys, k, rng.STREAM_GUMBEL_S) if draws is None \
        else draws.g_s
    pert_s = vals + g_s
    b = pert_s.amax(dim=1) - vals.amin(dim=1) - c  # the paper's B
    lam = (float(n) - k) * torch.exp(-b)  # per-token tail atom rate
    if draws is None:
        hi = torch.clamp(n - kv, min=1)
        draws = rng.Draws(
            g_s, rng.poisson_count(keys, lam, m_cap, rng.STREAM_POISSON),
            rng.uniform_int(keys, m_cap, hi, rng.STREAM_COMPLEMENT),
            rng.exponential(keys, m_cap, rng.STREAM_HEIGHTS).float())
    plan = plan_tail(None, topk.ids, n, b, lam, m_cap, k_valid=kv,
                     draws=draws)
    return _finish(topk, score_fn, b, m_cap, c, pert_s, plan)


def sample_fixed_b(keys, topk: TopK, n, score_fn, *, l: int,
                   m_cap: int | None = None, c: float = 0.0, k_valid=None,
                   draws: rng.Draws | None = None) -> SampleResult:
    """Algorithm 2 (fixed cutoff) per token: exact w.p. 1-δ for
    ``k l >= n e^c ln(1/δ)``.

    ``B = ln((n - k_valid)/l)`` so the tail atom count is Poisson(l).
    ``score_fn`` maps (t, m) ids to their (t, m) unnormalized log-probs.
    ``k_valid`` (t,) is the live slot count of an underfilled probe (dead
    slots hold value -inf and sanitized virtual ids >= n)."""
    k = topk.ids.shape[1]
    kv = _n_excluded(topk.ids, k_valid)
    if m_cap is None:
        m_cap = default_m_cap(l)
    if draws is None:
        draws = rng.tail_draws(keys, k=k, m_cap=m_cap,
                               hi=torch.clamp(n - kv, min=1), lam=l)
    pert_s = topk.values.float() + draws.g_s
    b = cutoff(n, kv, l)
    plan = plan_tail(None, topk.ids, n, b, l, m_cap, k_valid=kv, draws=draws)
    return _finish(topk, score_fn, b, m_cap, c, pert_s, plan)


class TopKSampleResult(NamedTuple):
    """Perturbed top-``num`` of one lazy-Gumbel draw per token, best first:
    the ``num`` largest values of ONE joint Gumbel perturbation, i.e.
    Gumbel top-k sampling without replacement (the first ``num`` atoms of
    the Plackett–Luce process). Dead slots (fewer than ``num`` live
    candidates) carry id -1 and value -inf."""

    ids: torch.Tensor  # (t, num) int64 perturbed top-num ids, -1 pads
    values: torch.Tensor  # (t, num) f32 perturbed values, descending
    scores: torch.Tensor  # (t, num) f32 the ids' unperturbed log-probs y
    ok: torch.Tensor  # (t,) bool top-num provably exact (given gap <= c)
    m: torch.Tensor  # (t,) int64 tail candidates materialized
    bound: torch.Tensor  # (t,) f32 S_min + c + B
    overflow: torch.Tensor  # (t,) bool static tail buffer overflowed


def _max_atom_per_position(pos: torch.Tensor, pert: torch.Tensor
                           ) -> torch.Tensor:
    """(t, m) mask keeping, for each tail position, its largest perturbed
    atom (the first of equal ones in atom order; live before dead): a
    stable sort by descending value, then a stable sort by position, marks
    the first atom of each position's run."""
    by_val = torch.argsort(-pert, dim=1, stable=True)
    by_pos = torch.argsort(torch.gather(pos, 1, by_val), dim=1, stable=True)
    order = torch.gather(by_val, 1, by_pos)
    sorted_pos = torch.gather(pos, 1, order)
    first = torch.ones_like(sorted_pos, dtype=torch.bool)
    first[:, 1:] = sorted_pos[:, 1:] != sorted_pos[:, :-1]
    return torch.zeros_like(first).scatter_(1, order, first)


def topk_fixed_b(keys, topk: TopK, n, score_fn, *, num: int, l: int,
                 m_cap: int | None = None, c: float = 0.0, k_valid=None,
                 draws: rng.Draws | None = None) -> TopKSampleResult:
    """Algorithm-2 lazy Gumbels per token, keeping the ``num`` largest
    perturbed values instead of the argmax: Gumbel top-k without
    replacement (Kool et al. 2019's primitive) over the same S ∪
    Poissonized-tail pool.

    Draws, cutoff, atom rate and tail plan are :func:`sample_fixed_b`'s
    (the same ``keys`` streams, or the same injected ``draws``), so with
    ``num=1`` the winner's id, value and ``ok`` are that function's bit for
    bit. Two differences from the argmax:

    * tail positions are drawn with replacement and a point's truncated
      Gumbel is the max over its atoms, so every smaller duplicate atom is
      masked to -inf (the largest kept in place, atom order untouched);
    * the certificate is taken at the ``num``-th kept value: the kept set
      is the true perturbed top-num iff it clears ``S_min + c + B`` (and the
      buffer did not overflow). When S covers the support (``k_valid ==
      n``) the cutoff is -inf and the certificate holds vacuously."""
    k = topk.ids.shape[1]
    kv = _n_excluded(topk.ids, k_valid)
    if m_cap is None:
        m_cap = default_m_cap(l)
    if draws is None:
        draws = rng.tail_draws(keys, k=k, m_cap=m_cap,
                               hi=torch.clamp(n - kv, min=1), lam=l)
    vals_s = topk.values.float()
    pert_s = vals_s + draws.g_s
    b = cutoff(n, kv, l)
    plan = plan_tail(None, topk.ids, n, b, l, m_cap, k_valid=kv, draws=draws)
    y_tail = score_fn(plan.pos).float()  # (t, m_cap)
    live = (torch.arange(m_cap, device=y_tail.device)[None, :]
            < plan.m_used[:, None])
    neg = torch.full_like(y_tail, -math.inf)
    pert_t = torch.where(live, y_tail + plan.heights, neg)
    pert_t = torch.where(_max_atom_per_position(plan.pos, pert_t), pert_t,
                         neg)
    pert = torch.cat([pert_s, pert_t], dim=1)
    ids = torch.cat([topk.ids.long(), plan.pos], dim=1)
    scores = torch.cat([vals_s, y_tail], dim=1)
    vals, at = torch.sort(pert, dim=1, descending=True, stable=True)
    vals, at = vals[:, :num], at[:, :num]
    dead = torch.isneginf(vals)
    out_ids = torch.where(dead, torch.full_like(at, -1),
                          torch.gather(ids, 1, at))
    out_scores = torch.where(dead, torch.full_like(vals, -math.inf),
                             torch.gather(scores, 1, at))
    ok, bound = certificate(topk.values, b, c, vals[:, num - 1],
                            plan.overflow)
    return TopKSampleResult(out_ids, vals, out_scores, ok, plan.m_used,
                            bound, plan.overflow)
