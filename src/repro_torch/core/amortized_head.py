"""Amortized log-linear head, sampling side (counterpart of
``repro/core/amortized_head.py``).

The softmax head of a language model is a log-linear model: features are
the output-embedding rows ``E_i`` and parameters the final hidden state
``h``; ``y_i = h · E_i``. Decode samples the next token with the paper's
lazy-Gumbel sampler (Algorithm 2) behind a MIPS top-k probe, built once over
the frozen embedding (:func:`make_index`) — the amortization. The head's
arithmetic is fp32 under every precision policy.

Padded vocabularies: rows past the logical vocab ``n`` sit at the END of the
table and are sliced away up front.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch import resolve_device
from repro_torch.core import estimators as est
from repro_torch.core import mips
from repro_torch.core.gumbel import SampleResult, default_kl

__all__ = ["HeadConfig", "head_sample", "make_index", "uses_index"]

_MODES = ("exact", "topk_only", "amortized")
_MIPS = ("exact", "ivf", "ivfpq", "lsh")
_PORTED_MIPS = ("exact", "ivf")


@dataclasses.dataclass(frozen=True)
class HeadConfig:
    n: int  # logical vocab size (pad rows beyond n are never touched)
    k: int = 0  # |S|; 0 -> default_kl(n, delta)
    l: int = 0  # |T|; 0 -> same as k
    mode: str = "amortized"  # exact | topk_only | amortized
    mips: str = "exact"  # exact | ivf  (ivfpq / lsh: not ported yet)
    n_probe: int = 8
    adaptive_probe: bool = False  # not ported yet
    n_probe_init: int = 0
    n_probe_max: int = 0
    use_kernel: bool = False  # ivf_gather_score kernel on the IVF probe
    fused_decode: bool = False  # ivf_screen_select + tail_gather_argmax
    delta: float = 1e-4
    c: float = 0.0  # assumed approximate-top-k gap (Def 3.1)
    min_amortized_n: int = 4096  # below this, amortization can't win: exact

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


def uses_index(cfg: HeadConfig) -> bool:
    """Whether this head builds a MIPS index at all (exact mode or the exact
    backend, including resolved()'s small-vocab downgrade, run off emb)."""
    cfg = cfg.resolved()
    return cfg.mode != "exact" and cfg.mips != "exact"


def make_index(cfg: HeadConfig, emb: torch.Tensor, device=None
               ) -> mips.Index | None:
    """Build the head's MIPS index over the embedding rows on ``device``
    (CUDA unless the caller names another), or None when the exact top-k
    path applies. ``emb`` must already live on that device."""
    cfg = cfg.resolved()
    dev = resolve_device(device)
    if emb.device.type != dev.type or (
            dev.index is not None and emb.device.index != dev.index):
        raise ValueError(f"emb lives on {emb.device}, the index on {dev}")
    if not uses_index(cfg):
        return None
    if cfg.mips not in _PORTED_MIPS:
        raise NotImplementedError(
            f"MIPS backend {cfg.mips!r} is not in the PyTorch port yet")
    if cfg.adaptive_probe:
        raise NotImplementedError("the adaptive probe is not in the port yet")
    mips_cfg = mips.IVFConfig(n_probe=cfg.n_probe, use_kernel=cfg.use_kernel)
    db = emb if cfg.n == emb.shape[0] else emb[: cfg.n]
    return mips.build_index(mips_cfg, db)


def head_sample(emb: torch.Tensor, h: torch.Tensor, cfg: HeadConfig,
                index: Any = None, *, keys: torch.Tensor | None = None,
                draws=None) -> SampleResult:
    """Sample next-token ids for queries ``h (T, d)`` -> SampleResult of
    (T,) fields. ``amortized``/``topk_only`` use the top-k probe and the
    lazy-Gumbel sampler; ``exact`` the dense Gumbel-max.

    ``keys`` ((T, 3) int64 (seed, request id, position) rows) makes each
    token's sample a function of its own key alone; ``draws`` injects the
    raw random numbers instead (:class:`repro_torch.core.rng.Draws`)."""
    cfg = cfg.resolved()
    if cfg.adaptive_probe:
        raise NotImplementedError("the adaptive probe is not in the port yet")
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
        )
    return est.local_gumbel_max(
        embf, h, k=cfg.k, l=cfg.l, keys=keys, index=index, c=cfg.c,
        fused=cfg.fused_decode, draws=draws,
    )
