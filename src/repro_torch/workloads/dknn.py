"""Deep-kNN classification and attribution over trunk activation taps
(counterpart of ``repro/workloads/dknn.py``; Papernot & McDaniel's DkNN).

Each activation tap gets a :mod:`repro_torch.core.mips` index — any backend
(exact, IVF, IVF-PQ, LSH) — over the unit-normalized training
representations, so the inner-product probe ranks neighbours by cosine
similarity. Classification is batched: one ``topk_batch`` per tap for the
whole batch, label votes, conformal p-values; no loop over examples.

Conformal scores:

* nonconformity ``alpha(x, y)``: the number, over taps, of the k nearest
  training neighbours whose label differs from ``y``;
* p-value ``p_y = (|{a in cal : a >= alpha(x, y)}| + 1) / (|cal| + 1)``
  against the calibration scores (taken at the true labels);
* credibility ``max_y p_y`` (low: x conforms to no class), confidence
  ``1 - the second largest p_y``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.core import mips
from repro_torch.core.mips.base import top_k

__all__ = [
    "DKNNConfig",
    "DKNNState",
    "DKNNResult",
    "normalize_reps",
    "fit",
    "nonconformity",
    "classify",
]


@dataclasses.dataclass(frozen=True)
class DKNNConfig:
    """``index_cfg`` is any mips config dataclass (None -> ExactConfig):
    the config value selects the backend."""

    n_classes: int
    k: int = 8
    index_cfg: Any = None

    def resolved_index_cfg(self):
        return mips.ExactConfig() if self.index_cfg is None else self.index_cfg


class DKNNState(NamedTuple):
    indexes: tuple  # one mips Index per tap, over the train reps
    train_labels: torch.Tensor  # (n_train,) int64
    cal_sorted: torch.Tensor  # (n_cal,) f32 calibration nonconformity, asc


class DKNNResult(NamedTuple):
    pred: torch.Tensor  # (B,) int64 — the class of the largest p-value
    credibility: torch.Tensor  # (B,) f32 — the largest p-value
    confidence: torch.Tensor  # (B,) f32 — 1 - the second largest p-value
    p_values: torch.Tensor  # (B, C) f32
    alpha: torch.Tensor  # (B, C) f32 — per-class nonconformity
    neighbors: torch.Tensor  # (n_taps, B, k) int64 train ids, -1 dead


def normalize_reps(reps: torch.Tensor) -> torch.Tensor:
    """Unit-normalize (..., d) representations (cosine == inner product)."""
    reps = reps.float()
    return reps / torch.clamp(torch.linalg.norm(reps, dim=-1, keepdim=True),
                              min=1e-12)


def nonconformity(state: DKNNState, reps: torch.Tensor, cfg: DKNNConfig
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-class disagreement counts for (n_taps, B, d) reps -> (alpha (B,
    C), neighbors (n_taps, B, k)). Dead probe slots (id -1 or value -inf:
    sparse LSH buckets, underfilled IVF probes) count for no class."""
    reps = normalize_reps(reps)
    b = reps.shape[1]
    votes = torch.zeros((b, cfg.n_classes), dtype=torch.float32,
                        device=reps.device)
    total = torch.zeros((b,), dtype=torch.float32, device=reps.device)
    neigh = []
    for j, index in enumerate(state.indexes):
        tk = index.topk_batch(reps[j], cfg.k)
        ids = tk.ids.long()
        valid = (ids >= 0) & ~torch.isneginf(tk.values)
        neigh.append(torch.where(valid, ids, torch.full_like(ids, -1)))
        lab = state.train_labels[torch.clamp(ids, min=0)]
        votes.scatter_add_(1, lab, valid.float())
        total += valid.sum(1)
    alpha = total[:, None] - votes  # neighbours DISagreeing with class c
    return alpha, torch.stack(neigh)


def fit(train_reps: torch.Tensor, train_labels: torch.Tensor,
        cal_reps: torch.Tensor, cal_labels: torch.Tensor, cfg: DKNNConfig
        ) -> DKNNState:
    """One index per tap over the normalized train reps (n_taps, n_train,
    d), then the calibration scores of (n_taps, n_cal, d) at their
    labels."""
    train_reps = normalize_reps(train_reps)
    icfg = cfg.resolved_index_cfg()
    indexes = tuple(mips.build_index(icfg, train_reps[j])
                    for j in range(train_reps.shape[0]))
    dev = train_reps.device
    state = DKNNState(indexes, train_labels.to(dev).long(),
                      torch.zeros((0,), dtype=torch.float32, device=dev))
    alpha, _ = nonconformity(state, cal_reps, cfg)
    cal = torch.gather(alpha, 1, cal_labels.to(dev).long()[:, None])[:, 0]
    return state._replace(cal_sorted=torch.sort(cal).values)


def classify(state: DKNNState, reps: torch.Tensor, cfg: DKNNConfig
             ) -> DKNNResult:
    """Conformal DkNN prediction for (n_taps, B, d) reps."""
    alpha, neigh = nonconformity(state, reps, cfg)
    n_cal = state.cal_sorted.shape[0]
    # |{a in cal : a >= alpha}| by a search of the ascending scores
    ge = n_cal - torch.searchsorted(state.cal_sorted, alpha.contiguous(),
                                    side="left")
    p = (ge.float() + 1.0) / (n_cal + 1.0)  # (B, C)
    if p.shape[1] >= 2:
        top2, _ = top_k(p, 2)
    else:
        top2 = torch.cat([p, torch.zeros_like(p)], dim=1)
    _, pred = top_k(p, 1)  # the first largest p-value, as argmax
    return DKNNResult(pred=pred[:, 0], credibility=top2[:, 0],
                      confidence=1.0 - top2[:, 1], p_values=p, alpha=alpha,
                      neighbors=neigh)
