"""Amortized log-linear head (counterpart of
``repro/core/amortized_head.py``).

The softmax head of a language model is a log-linear model: features are
the output-embedding rows ``E_i`` and parameters the final hidden state
``h``; ``y_i = h · E_i``. Decode samples the next token with the paper's
lazy-Gumbel sampler (Algorithm 2) behind a MIPS top-k probe, built over the
embedding (:func:`make_index`) — the amortization. Training takes the
per-token NLL ``log Ẑ - y_target`` (:func:`head_loss`) in one of three modes
(the paper's Table 2): ``exact`` (dense logsumexp), ``topk_only`` (S alone,
biased) and ``amortized`` (Algorithm 3 over S ∪ T); autodiff through the
amortized estimate is Algorithm 4's gradient. The head's arithmetic is fp32
under every precision policy (only ``score_dtype`` may be bf16).

Padded vocabularies: rows past the logical vocab ``n`` sit at the END of the
table and are sliced away up front.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch import resolve_device
from repro_torch.core import estimators as est
from repro_torch.core import mips, rng
from repro_torch.core.gumbel import SampleResult, default_kl

__all__ = ["HeadConfig", "HeadLossOut", "head_loss", "head_sample",
           "make_index", "uses_index"]

_MODES = ("exact", "topk_only", "amortized")
_MIPS = ("exact", "ivf", "ivfpq", "lsh")


@dataclasses.dataclass(frozen=True)
class HeadConfig:
    n: int  # logical vocab size (pad rows beyond n are never touched)
    k: int = 0  # |S|; 0 -> default_kl(n, delta)
    l: int = 0  # |T|; 0 -> same as k
    mode: str = "amortized"  # exact | topk_only | amortized
    mips: str = "exact"  # exact | ivf | ivfpq | lsh
    n_probe: int = 8
    adaptive_probe: bool = False  # certificate-gated staged widening: probe
    #   n_probe_init clusters per token, widen geometrically (up to
    #   n_probe_max) only for tokens whose gap certificate fails
    #   (core/mips/adaptive.py); requires mips in {ivf, ivfpq}
    n_probe_init: int = 0  # 0 -> n_probe (adaptive start width)
    n_probe_max: int = 0  # 0 -> n_probe (adaptive width ceiling)
    use_kernel: bool = False  # CPU: the IVF probe and the training loss
    #   through the kernels' plain versions (on CUDA the kernels always run;
    #   the IVF-PQ screen always takes pq_lut_score or its plain version)
    fused_decode: bool = False  # the index's fused screen (ivf_screen_select,
    #   or pq_screen_select + rerank_select) + tail_gather_argmax
    chunk: int = 256  # token chunk of the training loss
    delta: float = 1e-4
    c: float = 0.0  # assumed approximate-top-k gap (Def 3.1)
    min_amortized_n: int = 4096  # below this, amortization can't win: exact
    score_dtype: str = "f32"  # "bf16": candidate rows and scores in bf16
    #   (the logsumexp still accumulates in f32)

    def resolved(self) -> "HeadConfig":
        if self.mode not in _MODES:
            raise ValueError(
                f"unknown head mode {self.mode!r}; valid choices: {_MODES}")
        if self.mips not in _MIPS:
            raise ValueError(f"unknown head MIPS backend {self.mips!r}; "
                             f"valid choices: {_MIPS}")
        if self.adaptive_probe and self.mips not in ("ivf", "ivfpq"):
            raise ValueError("adaptive_probe requires a clustered MIPS backend "
                             f"(ivf | ivfpq), got {self.mips!r}")
        init = self.n_probe_init or self.n_probe
        maxp = self.n_probe_max or self.n_probe
        if self.adaptive_probe and init > maxp:
            raise ValueError(f"n_probe_init={init} exceeds n_probe_max={maxp}")
        k = self.k or default_kl(self.n, self.delta, self.c)
        l = self.l or k
        mode = self.mode
        if mode != "exact" and self.n < self.min_amortized_n:
            # √n savings are nil for tiny output spaces
            mode = "exact"
        k = min(k, self.n // 2)
        l = min(l, self.n // 2)
        return dataclasses.replace(self, k=k, l=l, mode=mode,
                                   n_probe_init=init, n_probe_max=maxp)

    @property
    def score_dt(self) -> torch.dtype:
        return torch.bfloat16 if self.score_dtype == "bf16" else torch.float32


class HeadLossOut(NamedTuple):
    loss: torch.Tensor  # (T,) per-token negative log-likelihood
    log_z: torch.Tensor  # (T,) partition estimates (diagnostics)


def uses_index(cfg: HeadConfig) -> bool:
    """Whether this head builds a MIPS index at all (exact mode or the exact
    backend, including resolved()'s small-vocab downgrade, run off emb)."""
    cfg = cfg.resolved()
    return cfg.mode != "exact" and cfg.mips != "exact"


def make_index(cfg: HeadConfig, emb: torch.Tensor, device=None, *,
               mesh=None, **build_kw) -> mips.Index | None:
    """Build the head's MIPS index over the embedding rows on ``device``
    (CUDA unless the caller names another), or None when the exact top-k
    path applies. ``emb`` must already live on that device; ``build_kw``
    go to the backend's ``build`` (IVF: ``init_cent``, ``iters``; IVF-PQ
    also ``init_codebooks``, ``pq_iters``; LSH takes none: its projections
    come from the config's seed, so a build over the same rows gives the
    same tables).

    The IVF-PQ index keeps ``emb`` itself as its re-rank rows: the resident
    table is passed unsliced when the vocabulary is unpadded, and a caller
    that updates ``emb`` in place must pass a frozen copy.

    With ``mesh``, ``emb`` is this rank's slice of the model-sharded table
    (pad rows included: each shard masks its own past ``n`` at probe time)
    and the index a :class:`repro_torch.core.mips.ShardedIndex` over the
    ``model`` axis."""
    cfg = cfg.resolved()
    dev = resolve_device(device)
    if emb.device.type != dev.type or (
            dev.index is not None and emb.device.index != dev.index):
        raise ValueError(f"emb lives on {emb.device}, the index on {dev}")
    if not uses_index(cfg):
        return None
    k_loc = max(8, cfg.k // (mesh.shape["model"] if mesh is not None else 1))
    if cfg.mips == "ivf":
        mips_cfg = mips.IVFConfig(n_probe=cfg.n_probe,
                                  n_probe_init=cfg.n_probe_init,
                                  n_probe_max=cfg.n_probe_max,
                                  use_kernel=cfg.use_kernel)
    elif cfg.mips == "ivfpq":
        # the exact re-rank covers the PROBED k (per shard when sharded)
        # with screening headroom
        mips_cfg = mips.PQConfig(n_probe=cfg.n_probe,
                                 n_probe_init=cfg.n_probe_init,
                                 n_probe_max=cfg.n_probe_max,
                                 rerank=2 * k_loc)
    else:  # lsh: buckets large enough that the tables' union can cover k
        base_cfg = mips.LSHConfig()
        n_loc = emb.shape[0] if mesh is not None else cfg.n
        cap_load = mips.default_bucket_cap(max(1, n_loc), base_cfg.n_bits)
        cap_k = max(8, math.ceil(2.0 * k_loc / base_cfg.n_tables
                                 / 8.0) * 8)
        mips_cfg = mips.LSHConfig(bucket_cap=max(cap_load, cap_k))
    if mesh is not None:
        return mips.build_index(mips_cfg, emb, mesh=mesh, **build_kw)
    db = emb if cfg.n == emb.shape[0] else emb[: cfg.n]
    return mips.build_index(mips_cfg, db, **build_kw)


def head_loss(emb: torch.Tensor, h: torch.Tensor, targets: torch.Tensor,
              cfg: HeadConfig, index: Any = None, *,
              keys: torch.Tensor | None = None,
              draws: torch.Tensor | None = None) -> HeadLossOut:
    """Per-token NLL ``log Ẑ - y_target``.

    Args:
      emb: (n_rows, d) output embedding (n_rows >= cfg.n; pads at the end).
      h: (T, d) final hidden states.
      targets: (T,) target ids in [0, cfg.n).
      keys: (T, 3) int64 per-token generator keys of the amortized tail
        draw; or ``draws`` (T, l), the draws themselves (tests).
    """
    cfg = cfg.resolved()
    embf = emb.float()[: cfg.n]
    h = h.float()

    def one_chunk(hc, tc, kc, dc):
        return est.loss_partials(
            embf, hc, tc, mode=cfg.mode, k=cfg.k, l=cfg.l, index=index,
            score_dtype=cfg.score_dt, use_kernel=cfg.use_kernel, keys=kc,
            draws=dc,
        )

    parts = est.chunked_map(one_chunk, cfg.chunk, h, targets.long(), keys,
                            draws)
    loss, log_z = est.combine_loss(parts, cfg.mode)
    return HeadLossOut(loss, log_z)


def head_sample(emb: torch.Tensor, h: torch.Tensor, cfg: HeadConfig,
                index: Any = None, *, keys: torch.Tensor | None = None,
                draws=None, strict: bool = False,
                strict_live: torch.Tensor | None = None,
                router: Any = None) -> SampleResult:
    """Sample next-token ids for queries ``h (T, d)`` -> SampleResult of
    (T,) fields. ``amortized``/``topk_only`` use the top-k probe and the
    lazy-Gumbel sampler; ``exact`` the dense Gumbel-max.

    ``keys`` ((T, 3) int64 (seed, request id, position) rows) makes each
    token's sample a function of its own key alone; ``draws`` injects the
    raw random numbers instead (:class:`repro_torch.core.rng.Draws`).

    ``strict`` re-samples the tokens whose exactness certificate failed
    (``ok`` False) with the exact dense sampler on a stream of their own
    (``rng.STREAM_STRICT``: the failed lazy draw is discarded, not reused).
    The reference runs the O(n d) fallback under a ``lax.cond`` that fires
    when any live row failed; here it is computed for the step's rows every
    time and selected with ``torch.where`` on a device-side flag, so strict
    serving adds no host sync. The selection is the reference's: when any
    row of ``strict_live`` ((T,) bool, default all) failed, every failed row
    takes its exact id; otherwise none does.

    With ``cfg.adaptive_probe`` the probe routes through the index's
    certificate-gated staged widening (``topk_adaptive``) and ``width``
    carries each token's effective probe width; ``router`` optionally
    predicts each token's starting stage
    (:class:`repro_torch.models.router.ProbeRouter`)."""
    cfg = cfg.resolved()
    embf = emb.float()[: cfg.n]
    h = h.float()
    t = h.shape[0]
    if cfg.mode == "exact":
        idx, mx = est.dense_gumbel_max(embf, h, keys=keys)
        return SampleResult(
            idx,
            torch.ones((t,), dtype=torch.bool, device=h.device),
            torch.zeros((t,), dtype=torch.int64, device=h.device),
            mx,
            torch.full((t,), float("-inf"), device=h.device),
            torch.zeros((t,), dtype=torch.bool, device=h.device),
            torch.full((t,), -1, dtype=torch.int64, device=h.device),
        )
    res = est.local_gumbel_max(
        embf, h, k=cfg.k, l=cfg.l, keys=keys, index=index, c=cfg.c,
        fused=cfg.fused_decode, draws=draws, adaptive=cfg.adaptive_probe,
        router=router,
    )
    if strict:
        if keys is None:
            raise ValueError("strict re-sampling needs keys")
        exact_ids, _ = est.dense_gumbel_max(embf, h, keys=keys,
                                            stream=rng.STREAM_STRICT)
        needs_fb = ~res.ok
        if strict_live is not None:
            needs_fb = needs_fb & strict_live.to(needs_fb.device)
        take = needs_fb.any() & ~res.ok  # the device-side flag, no read-back
        res = res._replace(index=torch.where(take, exact_ids, res.index))
    return res
