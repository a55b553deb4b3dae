"""Certificate-gated adaptive probe widening: a per-query ``n_probe``
(counterpart of ``repro/core/mips/adaptive.py``, where the stopping rule
and its soundness are set out).

A query probes its ``n_probe_init`` best clusters by centroid score, the
Def-3.1 gap certificate (:func:`repro_torch.core.gumbel.gap_certificate`)
is evaluated on the candidate pool, and only the queries whose certificate
fails widen, on a geometric schedule up to ``n_probe_max``. The bound on
what is still unprobed is Cauchy–Schwarz over each cluster's residual
radius: ``q·x <= q·c_j + ||q||·rad_j``. Overflow rows are in the pool at
every width; a build that dropped rows (``spill_count > 0``) voids the
certificate at every stage.

With ``n_probe_init == n_probe_max`` the schedule is one stage whose masks
are all true, so the adaptive query equals the fixed-width ``topk_batch``
bit for bit.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core.gumbel import gap_certificate

__all__ = [
    "AdaptiveTopK",
    "stage_widths",
    "unprobed_bound_table",
    "staged_widen",
]


class AdaptiveTopK(NamedTuple):
    """Adaptive-probe query result: the top-k plus per-query routing facts."""

    ids: torch.Tensor  # (b, k) int32 (-1 = dead slot)
    values: torch.Tensor  # (b, k) f32, descending (-inf = dead)
    width: torch.Tensor  # (b,) int64 — clusters probed (the stage the query
    #   stopped at)
    certified: torch.Tensor  # (b,) bool — gap certificate passed at
    #   ``width`` (False: widened to n_probe_max and still failed)


def stage_widths(init: int, maximum: int) -> tuple[int, ...]:
    """Static geometric widening schedule: init, 2·init, ... capped at
    ``maximum`` (always the final stage)."""
    init = max(1, min(init, maximum))
    widths = [init]
    while widths[-1] < maximum:
        widths.append(min(2 * widths[-1], maximum))
    return tuple(widths)


def unprobed_bound_table(c_scores: torch.Tensor, radii: torch.Tensor,
                         qf: torch.Tensor) -> torch.Tensor:
    """Suffix table of unprobed-cluster score bounds: (b, n_c + 1) with
    ``U[:, w]`` the max of ``c_scores + ||q|| · radii`` over the clusters
    ranked >= w by descending centroid score (what a width-w probe leaves
    untouched) and ``U[:, n_c] = -inf``. Empty clusters (radius -inf) bound
    nothing."""
    b = c_scores.shape[0]
    q_norm = torch.linalg.norm(qf, dim=1, keepdim=True)  # (b, 1)
    bounds = torch.where(torch.isneginf(radii)[None, :],
                         torch.full_like(c_scores, -math.inf),
                         c_scores + q_norm * radii[None, :])
    order = torch.argsort(-c_scores, dim=1, stable=True)
    ranked = torch.gather(bounds, 1, order)
    suffix = torch.cummax(ranked.flip(1), dim=1).values.flip(1)
    return torch.cat([suffix, suffix.new_full((b, 1), -math.inf)], dim=1)


def staged_widen(stage_fn, bound_table: torch.Tensor,
                 widths: tuple[int, ...], k: int, *, c: float = 0.0,
                 no_spill=True, init_stage: torch.Tensor | None = None
                 ) -> AdaptiveTopK:
    """The staged-widening loop over the static width schedule.

    ``stage_fn(width (b,) int64) -> (values (b, k) f32 descending, ids (b,
    k) int32)`` evaluates one stage at a per-row width (0: the overflow
    buffer alone — rows that already stopped, so a kernel stage skips their
    clusters). ``bound_table`` is :func:`unprobed_bound_table`'s output.
    Each row advances one stage per pass until its certificate passes or
    the schedule ends. ``init_stage`` ((b,) integers) starts rows further
    along the schedule (a router's prediction); the certificate still
    gates every stage."""
    n_stages = len(widths)
    dev = bound_table.device
    widths_t = torch.tensor(widths, dtype=torch.int64, device=dev)
    b = bound_table.shape[0]
    n_c = bound_table.shape[1] - 1
    st = (torch.zeros((b,), dtype=torch.int64, device=dev)
          if init_stage is None
          else torch.clamp(init_stage.to(dev).long(), 0, n_stages - 1))
    spill_ok = torch.as_tensor(no_spill, device=dev).bool().expand(b)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    cert = torch.zeros_like(done)
    vals = torch.full((b, k), -math.inf, device=dev)
    ids = torch.full((b, k), -1, dtype=torch.int32, device=dev)
    for _ in range(n_stages):
        w = torch.where(done, torch.zeros_like(st), widths_t[st])
        v_s, i_s = stage_fn(w)
        s_min = v_s[:, -1]  # k-th best so far (-inf while the pool underfills)
        upper = torch.gather(bound_table, 1,
                             torch.clamp(widths_t[st], max=n_c)[:, None])[:, 0]
        ok = gap_certificate(s_min, upper, c) & spill_ok
        newly = ~done
        vals = torch.where(newly[:, None], v_s, vals)
        ids = torch.where(newly[:, None], i_s.to(ids.dtype), ids)
        cert = cert | (newly & ok)
        done = done | ok | (st >= n_stages - 1)
        st = torch.where(done, st, st + 1)
        # the batch-level early exit: this read-back is the only host sync
        # the loop adds (one per stage run)
        if bool(done.all()):
            break
    return AdaptiveTopK(ids, vals, widths_t[st], cert)
