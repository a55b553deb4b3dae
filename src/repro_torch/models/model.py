"""Public model API (counterpart of ``repro/models/model.py``): init, the
training loss, head index, the trunk taps, prefill (batched into cache slots, or with the
vision stub's image prefix), the decode step, the encoder's logits, and
parameter counts, over every family of ``configs/``.

The LM head is the paper's amortized log-linear head
(:mod:`repro_torch.core.amortized_head`). The modality frontends are stubs,
as in the reference: the audio stub takes precomputed frame embeddings
(``batch["frames"]``), the vision stub precomputed patch embeddings
(``batch["patches"]``) that it puts before the text tokens.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch import precision, resolve_device
from repro_torch.core import amortized_head as ah
from repro_torch.models import transformer
from repro_torch.models.config import ArchConfig

__all__ = ["Model", "head_config", "param_count", "active_param_count"]

_AUX_WEIGHT = 0.01  # MoE load-balance loss weight (the reference's)


def head_config(cfg: ArchConfig, policy: precision.Policy | None = None
                ) -> ah.HeadConfig:
    return ah.HeadConfig(
        n=cfg.vocab,
        k=cfg.head_k,
        l=cfg.head_l,
        mode=cfg.head_mode,
        mips=cfg.head_mips,
        delta=cfg.head_delta,
        n_probe=cfg.head_n_probe,
        adaptive_probe=cfg.head_adaptive_probe,
        n_probe_init=cfg.head_n_probe_init,
        n_probe_max=cfg.head_n_probe_max,
        use_kernel=cfg.head_use_kernel,
        fused_decode=cfg.head_fused_decode,
        score_dtype=precision.get_policy(policy).score_dtype,
    ).resolved()


class Model:
    """Stateless model bundle: methods take params explicitly.

    ``precision_policy`` (a :class:`repro_torch.precision.Policy` or its
    name; default ``bf16``) sets the trunk compute / KV-cache dtype; master
    params stay fp32 and the head computes in fp32. ``device`` defaults to
    CUDA and raises without it (pass ``device="cpu"`` for the CPU).
    """

    def __init__(self, cfg: ArchConfig, precision_policy=None, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.policy = precision.get_policy(precision_policy)
        self.compute_dtype = self.policy.compute_dtype
        self.head_cfg = head_config(cfg, self.policy)

    # ---------------------------------------------------------------- init
    def init(self, seed: "int | torch.Generator" = 0) -> dict:
        """fp32 master params on the model's device, drawn from a
        ``torch.Generator`` (given, or seeded with ``seed``)."""
        gen = seed
        if not isinstance(gen, torch.Generator):
            gen = torch.Generator(device=self.device)
            gen.manual_seed(int(seed))
        return transformer.init_params(gen, self.cfg, device=self.device)

    def compute_params(self, params: dict) -> dict:
        """``params`` with the trunk's matmul weights held in the compute
        dtype (see :func:`transformer.compute_params`); same numerics, no
        per-step weight casts."""
        return transformer.compute_params(params, self.compute_dtype)

    def _out_embed(self, params) -> torch.Tensor:
        return params["embed"] if self.cfg.tie_embeddings else params["out_embed"]

    # ---------------------------------------------------------------- embed
    def _embed_inputs(self, params, batch) -> tuple[torch.Tensor,
                                                    torch.Tensor, int]:
        """-> (x (B, L, d) compute dtype, positions (B, L), prefix): frame
        embeddings for the audio stub; patch embeddings then token
        embeddings for the vision stub (``prefix`` = its image tokens,
        attended bidirectionally); token embeddings otherwise."""
        cfg = self.cfg
        prefix = 0
        if cfg.frontend == "audio_stub":
            x = batch["frames"].to(self.compute_dtype)
        else:
            x = params["embed"][batch["tokens"].long()].to(self.compute_dtype)
            if cfg.frontend == "vision_stub":
                x = torch.cat([batch["patches"].to(self.compute_dtype), x],
                              dim=1)
                prefix = cfg.n_prefix_tokens
        b, l, _ = x.shape
        pos = torch.arange(l, device=x.device)[None].expand(b, l)
        return x, pos, prefix

    # ---------------------------------------------------------------- index
    @property
    def head_uses_index(self) -> bool:
        """Whether make_head_index returns an index (vs None for the exact
        mode or backend)."""
        return ah.uses_index(self.head_cfg)

    def make_head_index(self, params, db=None, **build_kw):
        """The head's MIPS index over the output embedding (or ``db``), or
        None when the exact path applies. Serving builds it once; training
        refreshes it as the embedding drifts (train/trainer.py).
        ``build_kw`` go to the index backend's ``build`` (``init_cent``,
        ``iters``; IVF-PQ also ``init_codebooks``, ``pq_iters``). An IVF-PQ
        index keeps the rows it was built over as its re-rank table."""
        emb = self._out_embed(params) if db is None else db
        return ah.make_index(self.head_cfg, emb, device=self.device,
                             **build_kw)

    def head_index_db(self, params) -> torch.Tensor:
        """The embedding rows backing the head index (refresh and drift
        tracking): the logical-vocab slice of the output embedding."""
        emb = self._out_embed(params)
        return emb if self.head_cfg.n == emb.shape[0] else emb[: self.head_cfg.n]

    # ---------------------------------------------------------------- loss
    def loss_fn(self, params, batch, index=None, *,
                keys: torch.Tensor | None = None, draws=None
                ) -> tuple[torch.Tensor, dict]:
        """Mean NLL over label positions (+ aux) -> (total, {"nll", "aux",
        "log_z"}).

        ``keys`` ((B·L, 3) int64, one row per label position in row-major
        order) keys the amortized head's tail draws; ``draws`` ((B·L, l))
        injects them instead."""
        cfg = self.cfg
        x, pos, prefix = self._embed_inputs(params, batch)
        h, aux = transformer.apply_trunk(params, cfg, x, pos, prefix=prefix)
        if cfg.frontend == "vision_stub":
            h = h[:, cfg.n_prefix_tokens:]  # the loss reads text positions
        b, l, d = h.shape
        out = ah.head_loss(self._out_embed(params), h.reshape(b * l, d),
                           batch["labels"].reshape(-1).long(), self.head_cfg,
                           index, keys=keys, draws=draws)
        nll = out.loss.mean()
        total = nll + _AUX_WEIGHT * aux
        return total, {"nll": nll, "aux": aux, "log_z": out.log_z.mean()}

    # ---------------------------------------------------------------- taps
    def trunk_taps(self, params, batch, lengths: torch.Tensor | None = None
                   ) -> torch.Tensor:
        """Mean-pooled trunk representations per tap for deep-kNN
        (:mod:`repro_torch.workloads.dknn`): (n_taps, B, d) fp32. Taps are
        the block-group step activations and the final normed output
        (``transformer.apply_trunk(return_taps=True)``), pooled over the
        positions below ``lengths`` ((B,), right-padded rows; None pools
        every position). Rows are not normalized."""
        x, pos, prefix = self._embed_inputs(params, batch)
        _, _, taps = transformer.apply_trunk(params, self.cfg, x, pos,
                                             prefix=prefix, return_taps=True)
        if lengths is None:
            return taps.mean(dim=2)
        lengths = lengths.to(taps.device)
        ok = (torch.arange(taps.shape[2], device=taps.device)[None, :]
              < lengths[:, None])  # (B, L)
        denom = torch.clamp(lengths.float(), min=1.0)[None, :, None]
        return (taps * ok[None, :, :, None]).sum(dim=2) / denom

    # ---------------------------------------------------------------- decode
    def init_cache(self, batch: int, max_seq: int, dtype=None,
                   paged: "transformer.PagedLayout | None" = None) -> list:
        """``paged`` swaps the KV leaves for the shared block pool
        (:func:`repro_torch.models.transformer.init_cache`)."""
        dtype = self.compute_dtype if dtype is None else dtype
        return transformer.init_cache(self.cfg, batch, max_seq, dtype,
                                      device=self.device, paged=paged)

    def _sample(self, params, hq, index, keys, draws, strict, strict_live,
                router) -> ah.SampleResult:
        return ah.head_sample(self._out_embed(params), hq, self.head_cfg,
                              index, keys=keys, draws=draws, strict=strict,
                              strict_live=strict_live, router=router)

    def decode_step(self, params, cache, ids: torch.Tensor, pos: torch.Tensor,
                    index=None, *, keys: torch.Tensor | None = None,
                    draws=None, strict: bool = False, strict_live=None,
                    router=None, pages: torch.Tensor | None = None,
                    write_mask: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor, Any, torch.Tensor]:
        """One serving step: (B,) last ids + (B,) positions -> (next ids
        (B,), ok (B,), cache updated in place, width (B,)).

        ``width`` is each slot's effective probe width under the head's
        certificate-gated adaptive probe, -1 on fixed-width paths; ``router``
        (:class:`repro_torch.models.router.ProbeRouter`) predicts each
        slot's starting stage. ``strict`` re-samples certificate-failed
        tokens exactly (:func:`repro_torch.core.amortized_head.head_sample`;
        ``strict_live`` marks the live rows).

        ``keys`` ((B, 3) int64, :func:`repro_torch.launch.steps.slot_keys`)
        makes each slot's sample a function of (request id, position)
        alone; ``draws`` injects the raw random numbers instead.

        ``pages`` ((B, n_pages) page table) switches the KV leaves to the
        paged pool; ``write_mask`` ((B,) bool, the engine's ``active``
        flags) sends retired slots' KV writes to the pool's sink block, so
        recycled blocks are never overwritten."""
        x = params["embed"][ids][:, None].to(self.compute_dtype)  # (B, 1, d)
        h, cache = transformer.apply_trunk_decode(
            params, self.cfg, x, cache, pos, pages=pages,
            write_mask=write_mask)
        res = self._sample(params, h[:, 0], index, keys, draws, strict,
                           strict_live, router)
        return res.index, res.ok, cache, res.width

    def prefill(self, params, batch: dict, keys: torch.Tensor | None,
                max_seq: int, index=None, *, draws=None
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, list]:
        """Prompt forward + cache build + first sampled token for a batch
        of equal-length prompts ``batch["tokens"]`` (B, L) (with the vision
        stub, ``batch["patches"]`` before them) -> (next ids (B,), ok (B,),
        pos (B,) = the prompt's full length, cache)."""
        x, pos, prefix = self._embed_inputs(params, batch)
        b, l, _ = x.shape
        h, cache = transformer.apply_trunk_prefill(params, self.cfg, x, pos,
                                                   max_seq=max_seq,
                                                   prefix=prefix)
        res = self._sample(params, h[:, -1], index, keys, draws, False, None,
                           None)
        return (res.index, res.ok,
                torch.full((b,), l, dtype=torch.int64, device=x.device), cache)

    def prefill_into_cache(self, params, cache, tokens: torch.Tensor,
                           lengths: torch.Tensor, slots: torch.Tensor,
                           keys: torch.Tensor | None, max_seq: int,
                           index=None, *, draws=None, strict: bool = False,
                           strict_live=None, pages: torch.Tensor | None = None
                           ) -> tuple[torch.Tensor, torch.Tensor, Any]:
        """Batched prefill written straight into serving-cache slots.

        Runs the prompt forward for a right-padded admission batch
        ``tokens`` (Bn, Lp), builds each row's KV ring as of its true
        ``lengths[b]``, writes it into ``cache`` at ``slots[b]`` (rows with
        slot >= B are admission padding and dropped) and samples the first
        output token from the last valid hidden state. ``pages`` ((Bn,
        n_pages) physical blocks per row, sentinel-filled for pad rows)
        routes each ring into the paged pool instead.

        Returns (next ids (Bn,), ok (Bn,), cache). Token-LM frontends only:
        a modality stub raises ``NotImplementedError``, as in the
        reference."""
        if self.cfg.frontend != "none":
            raise NotImplementedError(
                "prefill_into_cache serves token-LM frontends only")
        x = params["embed"][tokens].to(self.compute_dtype)  # (Bn, Lp, d)
        b, l, _ = x.shape
        pos = torch.arange(l, device=x.device)[None].expand(b, l)
        h, part = transformer.apply_trunk_prefill(
            params, self.cfg, x, pos, max_seq=max_seq, lengths=lengths)
        last = (lengths.to(x.device).long() - 1)
        hq = h[torch.arange(b, device=x.device), last]  # (Bn, d)
        res = self._sample(params, hq, index, keys, draws, strict,
                           strict_live, None)
        cache = transformer.insert_cache_slots(cache, part, slots,
                                               pages=pages)
        return res.index, res.ok, cache

    # ---------------------------------------------------------------- encoder
    def encode(self, params, batch) -> torch.Tensor:
        """Encoder-only archs (hubert): per-frame fp32 logits (B, L, vocab)
        over the output embedding."""
        x, pos, _ = self._embed_inputs(params, batch)
        h, _ = transformer.apply_trunk(params, self.cfg, x, pos)
        logits = h.float() @ self._out_embed(params).float().T
        return logits[..., : self.cfg.vocab]


# -------------------------------------------------------------------- counts
def _meta_params(cfg: ArchConfig) -> dict:
    """The parameter tree of ``cfg`` on the meta device: shapes, no
    storage."""
    return transformer.init_params(torch.Generator(), cfg, device="meta")


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    elif tree is not None:
        yield path, tree


def param_count(cfg: ArchConfig) -> int:
    """Number of parameters of ``cfg`` (nothing is allocated)."""
    return sum(t.numel() for _, t in _leaves(_meta_params(cfg)))


def active_param_count(cfg: ArchConfig) -> int:
    """Parameters touched per token (MoE: the routed experts' share only),
    the 6·N_active·D convention."""
    total = param_count(cfg)
    if not cfg.is_moe:
        return total
    frac = 1.0 - cfg.experts_per_token / cfg.n_experts
    inactive = sum(int(frac * t.numel())
                   for path, t in _leaves(_meta_params(cfg))
                   if t.dim() == 4 and path[-1] in ("w1", "w2", "w3"))
    return total - inactive
