"""Public model API (counterpart of ``repro/models/model.py``): init, the
training loss, head index, the trunk taps, prefill (batched into cache slots, or with the
vision stub's image prefix), the decode step, the encoder's logits, and
parameter counts, over every family of ``configs/``.

The LM head is the paper's amortized log-linear head
(:mod:`repro_torch.core.amortized_head`). The modality frontends are stubs,
as in the reference: the audio stub takes precomputed frame embeddings
(``batch["frames"]``), the vision stub precomputed patch embeddings
(``batch["patches"]``) that it puts before the text tokens.

On a mesh (:class:`repro_torch.launch.mesh.Mesh`, ``Model(cfg, mesh=)``)
each rank holds its block of every leaf as
:func:`repro_torch.launch.mesh.param_spec` places it — the input and
output embeddings' rows over the model axis, the trunk Megatron-split over
it and FSDP-split over the data axis (:mod:`repro_torch.models
.transformer`) — and this data rank's batch. The input lookup is
vocab-parallel: each rank embeds the ids of its row block, zero
elsewhere, and the rows are summed over the model axis; so tied
embeddings share the output embedding's layout. The head is the
distributed one (:mod:`repro_torch.models.head`) over a
:class:`repro_torch.core.mips.ShardedIndex`; ``encode`` gathers each
rank's vocab slice of the logits.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch import collectives as coll
from repro_torch import precision, resolve_device
from repro_torch.core import amortized_head as ah
from repro_torch.models import head as dist_head
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
    ``mesh``: params are this rank's slices and the head is distributed.
    """

    def __init__(self, cfg: ArchConfig, precision_policy=None, device=None,
                 mesh=None):
        self.cfg = cfg
        self.mesh = mesh
        self.device = resolve_device(device)
        self.policy = precision.get_policy(precision_policy)
        self.compute_dtype = self.policy.compute_dtype
        self.head_cfg = head_config(cfg, self.policy)

    # ---------------------------------------------------------------- init
    def init(self, seed: "int | torch.Generator" = 0) -> dict:
        """fp32 master params on the model's device, drawn from a
        ``torch.Generator`` (given, or seeded with ``seed``). On a mesh:
        the same draws, cut to this rank's slices (every rank draws the
        full tree, so a mesh run starts from the single-device params)."""
        gen = seed
        if not isinstance(gen, torch.Generator):
            gen = torch.Generator(device=self.device)
            gen.manual_seed(int(seed))
        params = transformer.init_params(gen, self.cfg, device=self.device)
        if self.mesh is not None:
            from repro_torch.launch import mesh as mesh_lib

            params = mesh_lib.shard_params(params, self.mesh, self.cfg)
        return params

    def compute_params(self, params: dict) -> dict:
        """``params`` with the trunk's matmul weights held in the compute
        dtype (see :func:`transformer.compute_params`); same numerics, no
        per-step weight casts."""
        return transformer.compute_params(params, self.compute_dtype)

    def _out_embed(self, params) -> torch.Tensor:
        return params["embed"] if self.cfg.tie_embeddings else params["out_embed"]

    # ---------------------------------------------------------------- embed
    def _lookup(self, params, ids: torch.Tensor) -> torch.Tensor:
        """Token embeddings of ``ids`` in the compute dtype. On a mesh the
        lookup is vocab-parallel: this rank's rows embed the ids they
        hold, zero for the others, and the rows are summed over the model
        axis (one nonzero term each: exact)."""
        emb = params["embed"]
        ids = ids.long()
        ax = None if self.mesh is None or self.mesh.tp == 1 else \
            self.mesh.model
        if ax is None:
            # an embedding lookup: its backward sums repeated tokens in a
            # fixed order (advanced indexing's uses atomics on the CPU)
            return torch.nn.functional.embedding(ids, emb).to(
                self.compute_dtype)
        v = emb.shape[0]
        loc = ids - ax.index * v
        hit = (loc >= 0) & (loc < v)
        x = torch.nn.functional.embedding(loc.clamp(0, v - 1), emb)
        x = torch.where(hit[..., None], x, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))
        return coll.reduce_from(x.to(self.compute_dtype), ax)

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
            x = self._lookup(params, batch["tokens"])
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

    def _head_mesh(self):
        """The mesh of the distributed head, or None (single device)."""
        return self.mesh

    def make_head_index(self, params, db=None, **build_kw):
        """The head's MIPS index over the output embedding (or ``db``), or
        None when the exact path applies. Serving builds it once; training
        refreshes it as the embedding drifts (train/trainer.py).
        ``build_kw`` go to the index backend's ``build`` (``init_cent``,
        ``iters``; IVF-PQ also ``init_codebooks``, ``pq_iters``). An IVF-PQ
        index keeps the rows it was built over as its re-rank table. On a
        mesh: a :class:`repro_torch.core.mips.ShardedIndex` over this
        rank's rows."""
        emb = self._out_embed(params) if db is None else db
        return ah.make_index(self.head_cfg, emb, device=self.device,
                             mesh=self._head_mesh(), **build_kw)

    def head_index_db(self, params) -> torch.Tensor:
        """The embedding rows backing the head index (refresh and drift
        tracking): the logical-vocab slice of the output embedding, or on a
        mesh this rank's whole slice of the padded table (each shard masks
        its own pad rows at probe time)."""
        emb = self._out_embed(params)
        if self._head_mesh() is not None or self.head_cfg.n == emb.shape[0]:
            return emb
        return emb[: self.head_cfg.n]

    # ---------------------------------------------------------------- loss
    def loss_fn(self, params, batch, index=None, *,
                keys: torch.Tensor | None = None, draws=None
                ) -> tuple[torch.Tensor, dict]:
        """Mean NLL over label positions (+ aux) -> (total, {"nll", "aux",
        "log_z"}).

        ``keys`` ((B·L, 3) int64, one row per label position in row-major
        order) keys the amortized head's tail draws; ``draws`` ((B·L, l))
        injects them instead (on a mesh: this shard's (B·L, l_loc)). The
        distributed head returns no ``log_z`` diagnostics (0, as in the
        reference)."""
        cfg = self.cfg
        x, pos, prefix = self._embed_inputs(params, batch)
        h, aux = transformer.apply_trunk(params, cfg, x, pos, prefix=prefix,
                                         mesh=self.mesh)
        if cfg.frontend == "vision_stub":
            h = h[:, cfg.n_prefix_tokens:]  # the loss reads text positions
        b, l, d = h.shape
        h2 = h.reshape(b * l, d)
        t2 = batch["labels"].reshape(-1).long()
        if self._head_mesh() is not None:
            loss = dist_head.dist_head_loss(
                self.mesh, self._out_embed(params), h2, t2, self.head_cfg,
                index, keys=keys, draws=draws)
            log_z = torch.zeros((), device=h.device)
        else:
            out = ah.head_loss(self._out_embed(params), h2, t2,
                               self.head_cfg, index, keys=keys, draws=draws)
            loss, log_z = out.loss, out.log_z.mean()
        nll = loss.mean()
        total = nll + _AUX_WEIGHT * aux
        return total, {"nll": nll, "aux": aux, "log_z": log_z}

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
                                             prefix=prefix, return_taps=True,
                                             mesh=self.mesh)
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
                                      device=self.device, paged=paged,
                                      mesh=self.mesh)

    def _sample(self, params, hq, index, keys, draws, strict, strict_live,
                router) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """-> (ids, ok, width) from the head (the distributed one on a
        mesh, where strict re-sampling is refused, as in the reference)."""
        if self._head_mesh() is not None:
            if strict:
                raise NotImplementedError(
                    "strict exact-fallback is not wired through the "
                    "distributed head; serve with strict=False on a TP mesh")
            return dist_head.dist_head_sample(
                self.mesh, self._out_embed(params), hq, self.head_cfg,
                index, keys=keys, draws=draws, router=router)
        res = ah.head_sample(self._out_embed(params), hq, self.head_cfg,
                             index, keys=keys, draws=draws, strict=strict,
                             strict_live=strict_live, router=router)
        return res.index, res.ok, res.width

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
        x = self._lookup(params, ids)[:, None]  # (B, 1, d)
        h, cache = transformer.apply_trunk_decode(
            params, self.cfg, x, cache, pos, pages=pages,
            write_mask=write_mask, mesh=self.mesh)
        nxt, ok, width = self._sample(params, h[:, 0], index, keys, draws,
                                      strict, strict_live, router)
        return nxt, ok, cache, width

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
                                                   prefix=prefix,
                                                   mesh=self.mesh)
        nxt, ok, _ = self._sample(params, h[:, -1], index, keys, draws, False,
                                  None, None)
        return (nxt, ok,
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
        x = self._lookup(params, tokens)  # (Bn, Lp, d)
        b, l, _ = x.shape
        pos = torch.arange(l, device=x.device)[None].expand(b, l)
        h, part = transformer.apply_trunk_prefill(
            params, self.cfg, x, pos, max_seq=max_seq, lengths=lengths,
            mesh=self.mesh)
        last = (lengths.to(x.device).long() - 1)
        hq = h[torch.arange(b, device=x.device), last]  # (Bn, d)
        nxt, ok, _ = self._sample(params, hq, index, keys, draws, strict,
                                  strict_live, None)
        cache = transformer.insert_cache_slots(cache, part, slots,
                                               pages=pages, mesh=self.mesh)
        return nxt, ok, cache

    # ---------------------------------------------------------------- encoder
    def encode(self, params, batch) -> torch.Tensor:
        """Encoder-only archs (hubert): per-frame fp32 logits (B, L, vocab)
        over the output embedding (on a mesh: each rank's vocab slice,
        gathered over the model axis)."""
        x, pos, _ = self._embed_inputs(params, batch)
        h, _ = transformer.apply_trunk(params, self.cfg, x, pos,
                                       mesh=self.mesh)
        logits = h.float() @ self._out_embed(params).float().T
        if self.mesh is not None and self.mesh.tp > 1:
            logits = coll.all_gather_dim(logits, self.mesh.model, -1)
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
