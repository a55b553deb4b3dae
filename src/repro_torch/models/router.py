"""Learned probe-width router for the certificate-gated adaptive probe
(counterpart of ``repro/models/router.py``).

The staged-widening query (:mod:`repro_torch.core.mips.adaptive`) starts
every query at stage 0 (``n_probe_init`` clusters) and pays one certificate
round per widening step. Most queries' final width is predictable from how
fast their centroid scores decay: a query whose top centroid towers over
the rest certifies at the narrowest width, a flat profile needs the
ceiling. This module learns that mapping.

* Features (:func:`stage_features`): the centroid-score gaps
  ``top1 - top_{w_s}`` at each stage-boundary width ``w_s`` of the static
  schedule, normalized by ``||q||``, plus ``log1p(||q||)`` — ``S + 1``
  numbers per query, from the ``(b, n_c)`` centroid scores the probe
  computes anyway.
* Model (:class:`ProbeRouter`): a tiny MLP ``(S+1) -> hidden -> S`` whose
  argmax picks the starting stage; a NamedTuple of tensors.
* Labels (:func:`certified_stage_labels`): the FIRST stage whose gap
  certificate passes, observed by running the single-stage probe at each
  schedule width; :func:`fit_router` / :func:`train_router` fit against
  them.

A misprediction costs bandwidth, never correctness: the certificate still
gates every widening step. ``staged_widen`` clips the predicted stage into
the schedule. Routers are saved as ``.npz`` files with the reference's
fields, so a router saved by either package loads in the other. On a
multi-rank mesh one rank fits and :func:`broadcast_router` hands its
weights to the others, so every shard routes with the same router.
"""
from __future__ import annotations

import os
from typing import NamedTuple, Sequence

import numpy as np
import torch

__all__ = [
    "ProbeRouter",
    "stage_features",
    "init_router",
    "fit_router",
    "certified_stage_labels",
    "train_router",
    "save_router",
    "load_router",
    "broadcast_router",
]

HIDDEN = 16


def stage_features(c_scores: torch.Tensor, qf: torch.Tensor,
                   widths: Sequence[int]) -> torch.Tensor:
    """(b, S+1) routing features: per-stage top-score gaps + query norm.

    ``gap_s = (top1 - top_{w_s}) / ||q||`` measures how much of the
    centroid-score mass the first ``w_s`` clusters capture — the quantity
    the unprobed-mass bound (``adaptive.unprobed_bound_table``) keys on."""
    n_c = c_scores.shape[1]
    w_hi = min(max(widths), n_c - 1) if n_c > 1 else 0
    top = torch.topk(c_scores.float(), w_hi + 1, dim=1).values
    qn = torch.linalg.norm(qf.float(), dim=-1)  # (b,)
    scale = torch.clamp(qn, min=1e-6)[:, None]
    idx = torch.tensor([min(int(w), top.shape[1] - 1) for w in widths],
                       dtype=torch.int64, device=top.device)
    gaps = (top[:, :1] - top[:, idx]) / scale  # (b, S)
    return torch.cat([gaps, torch.log1p(qn)[:, None]], dim=1)


class ProbeRouter(NamedTuple):
    """Tiny stage-prediction MLP, fp32 tensors on the index's device."""

    w1: torch.Tensor  # (S+1, hidden)
    b1: torch.Tensor  # (hidden,)
    w2: torch.Tensor  # (hidden, S)
    b2: torch.Tensor  # (S,)

    @property
    def n_stages(self) -> int:
        return self.w2.shape[1]

    def logits(self, c_scores: torch.Tensor, qf: torch.Tensor,
               widths: Sequence[int]) -> torch.Tensor:
        x = stage_features(c_scores, qf, widths)
        hid = torch.tanh(x @ self.w1 + self.b1)
        return hid @ self.w2 + self.b2  # (b, S)

    def init_stage(self, c_scores: torch.Tensor, qf: torch.Tensor,
                   widths: Sequence[int]) -> torch.Tensor:
        """(b,) int64 predicted starting stage (argmax over stage logits;
        the first maximal stage)."""
        return torch.argmax(self.logits(c_scores, qf, widths), dim=-1)


def init_router(seed: "int | torch.Generator", n_stages: int,
                hidden: int = HIDDEN) -> ProbeRouter:
    """He-scaled random init from a ``torch.Generator`` (given, or a CPU
    one seeded with ``seed``), on the generator's device."""
    gen = seed
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator().manual_seed(int(seed))
    dev = gen.device
    f = n_stages + 1
    s1 = (2.0 / f) ** 0.5
    s2 = (2.0 / hidden) ** 0.5
    return ProbeRouter(
        w1=torch.randn((f, hidden), generator=gen, device=dev) * s1,
        b1=torch.zeros((hidden,), device=dev),
        w2=torch.randn((hidden, n_stages), generator=gen, device=dev) * s2,
        b2=torch.zeros((n_stages,), device=dev),
    )


def certified_stage_labels(index, q: torch.Tensor, k: int,
                           widths: Sequence[int], *, c: float = 0.0
                           ) -> torch.Tensor:
    """(b,) int64 supervision: the first schedule stage whose gap
    certificate passes for each query (the last stage when none does).

    Each label probe runs the index's single-stage adaptive query
    (``n_probe_init == n_probe_max == w``): the fixed-width program whose
    certificate the staged search evaluates, so the labels are the stopping
    rule's own decisions."""
    cert = torch.stack([
        index.topk_adaptive(q, k, c=c, n_probe_init=int(w),
                            n_probe_max=int(w)).certified
        for w in widths], dim=1)  # (b, S)
    first = torch.argmax(cert.to(torch.uint8), dim=1)
    return torch.where(cert.any(dim=1), first,
                       torch.full_like(first, len(widths) - 1))


def fit_router(router: ProbeRouter, feats: torch.Tensor,
               labels: torch.Tensor, *, steps: int = 300, lr: float = 0.05
               ) -> ProbeRouter:
    """Full-batch softmax cross-entropy fit by plain SGD, ``steps`` steps of
    ``p -= lr * grad`` (the reference's loop, gradients from
    ``torch.autograd.grad``). Deterministic for a given trace."""
    feats = feats.float()
    labels = labels.long()
    params = [p.detach().float().clone() for p in router]
    for _ in range(steps):
        ps = [p.requires_grad_(True) for p in params]
        w1, b1, w2, b2 = ps
        logits = torch.tanh(feats @ w1 + b1) @ w2 + b2
        lse = torch.logsumexp(logits, dim=-1)
        picked = torch.gather(logits, 1, labels[:, None])[:, 0]
        grads = torch.autograd.grad((lse - picked).mean(), ps)
        with torch.no_grad():
            params = [p - lr * g for p, g in zip(ps, grads)]
    return ProbeRouter(*(p.detach() for p in params))


def train_router(index, q: torch.Tensor, k: int, *, c: float = 0.0,
                 n_probe_init: int | None = None,
                 n_probe_max: int | None = None, steps: int = 300,
                 lr: float = 0.05, seed: int = 0) -> ProbeRouter:
    """Supervised fit against the index's own certificate.

    Resolves the stage schedule as ``topk_adaptive`` does (config
    defaults, geometric doubling), labels each query with its first
    certificate-passing stage, and fits a fresh :class:`ProbeRouter` (drawn
    on the CPU from ``seed``, moved to the queries' device)."""
    from repro_torch.core.mips.adaptive import stage_widths

    cfg = index.config
    n_c = int(index.state.n_clusters)
    w_max = min(n_probe_max or cfg.n_probe_max or cfg.n_probe, n_c)
    init = min(n_probe_init or cfg.n_probe_init or cfg.n_probe, w_max)
    widths = stage_widths(init, w_max)
    qf = q.float()
    c_scores = qf @ index.state.centroids.T
    feats = stage_features(c_scores, qf, widths)
    labels = certified_stage_labels(index, qf, k, widths, c=c)
    router = ProbeRouter(*(p.to(qf.device)
                           for p in init_router(seed, len(widths))))
    return fit_router(router, feats, labels, steps=steps, lr=lr)


def save_router(path: str, router: ProbeRouter) -> None:
    """Persist to ``.npz``: the fields ``w1 b1 w2 b2`` as fp32 arrays, the
    reference's format."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **{f: v.detach().cpu().numpy()
                      for f, v in router._asdict().items()})


def load_router(path: str, device=None) -> ProbeRouter:
    """Load a router saved by :func:`save_router` (or by the reference's)
    onto ``device`` (the CPU unless named)."""
    with np.load(path) as data:
        return ProbeRouter(*(torch.from_numpy(np.array(data[f])).to(device)
                             for f in ProbeRouter._fields))


def broadcast_router(router: ProbeRouter | None, axis, device=None
                     ) -> ProbeRouter:
    """The axis' first rank's ``router`` on every rank of ``axis`` (the
    others pass None), onto ``device``: its fp32 weights cross as numpy
    arrays."""
    from repro_torch import collectives as coll

    arrs = (None if router is None else
            {f: v.detach().cpu().numpy() for f, v in router._asdict().items()})
    arrs = coll.broadcast_object(arrs, axis)
    return ProbeRouter(*(torch.from_numpy(arrs[f]).to(device)
                         for f in ProbeRouter._fields))
