"""Trunk assembly for the attention family (counterpart of
``repro/models/transformer.py``).

Parameters keep the reference's stacked pytree structure: ``blocks`` is a
list of block groups, each a dict ``{"0": layer}`` whose leaves carry a
leading layer axis. Where the reference scans that axis with ``lax.scan``,
the port loops over it in Python and hands each layer a view of its slice.
The training forward (:func:`apply_trunk`) runs each layer under
non-reentrant ``torch.utils.checkpoint`` where the reference wraps each scan
step in ``jax.checkpoint`` (``REMAT``): only layer-boundary activations are
kept for the backward pass.
KV caches mirror the same structure, ``(layers, B, s_c, KV, hd)`` per leaf,
and decode updates them in place. The paged layout (:class:`PagedLayout`)
swaps each leaf for a shared block pool ``(layers, n_blocks + 1, block_len,
KV, hd)`` addressed through per-slot page tables; its last block is the
sink that takes the writes a page table does not map (see
:func:`repro_torch.models.attention.init_pool`).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import dense_init, mlp_init, rms_norm, swiglu

__all__ = [
    "check_supported",
    "init_params",
    "compute_params",
    "apply_trunk",
    "apply_trunk_prefill",
    "insert_cache_slots",
    "init_cache",
    "apply_trunk_decode",
    "PagedLayout",
    "ring_len",
]


REMAT = True  # recompute each layer in the backward pass (tests may disable)


def check_supported(cfg: ArchConfig) -> None:
    """The port runs the attention family only (no MoE, no modality stub);
    the other families come later."""
    if (cfg.layer_pattern != "attn" or cfg.is_moe or cfg.frontend != "none"
            or cfg.encoder_only):
        raise NotImplementedError(
            f"{cfg.name}: only attention-family decoder configs "
            "(layer_pattern='attn', no MoE, no frontend) are ported so far"
        )


def ring_len(cfg: ArchConfig, max_seq: int) -> int:
    """KV ring length s_c of the attention layers: what a slot's page table
    must cover (``n_pages * block_len == s_c``)."""
    return min(cfg.window, max_seq) if cfg.window else max_seq


@dataclasses.dataclass(frozen=True)
class PagedLayout:
    """Paged-pool geometry for the attention KV cache.

    ``n_blocks`` physical blocks of ``block_len`` positions are shared by
    all serving slots; a per-slot page table of ``ring_len(cfg, max_seq) //
    block_len`` entries maps ring pages onto physical blocks. Block id
    ``n_blocks`` is the sentinel for unallocated pages: the pool holds one
    more block there, the sink, which takes the writes of sentinel pages and
    of masked rows and is never read below a row's ``lengths``."""

    block_len: int
    n_blocks: int

    def n_pages(self, cfg: ArchConfig, max_seq: int) -> int:
        s_c = ring_len(cfg, max_seq)
        if s_c % self.block_len:
            raise ValueError(
                f"block_len={self.block_len} must divide the KV ring length "
                f"s_c={s_c} (window/max_seq geometry)")
        return s_c // self.block_len

    @property
    def sentinel(self) -> int:
        return self.n_blocks


def init_params(gen: torch.Generator, cfg: ArchConfig, device=None) -> dict:
    """fp32 master parameters from ``gen``, in the reference's structure."""
    check_supported(cfg)
    d, vp, n = cfg.d_model, cfg.vocab_padded, cfg.n_layers
    params: dict[str, Any] = {
        "embed": dense_init(gen, (vp, d), in_axis=-1, device=device),
        "out_embed": (None if cfg.tie_embeddings
                      else dense_init(gen, (vp, d), in_axis=-1, device=device)),
        "final_norm": torch.zeros((d,), device=device),
    }
    layer = {
        "norm1": torch.zeros((n, d), device=device),
        "mix": attention.init(gen, cfg, n, device=device),
        "norm2": torch.zeros((n, d), device=device),
        "mlp": mlp_init(gen, d, cfg.d_ff, n, device=device),
    }
    params["blocks"] = [{"0": layer}]
    return params


def compute_params(params: dict, dtype: torch.dtype) -> dict:
    """The parameters with every block matmul weight cast to ``dtype`` once.

    Layers cast weights at use (``w.to(x.dtype)``); handing them weights
    already in the compute dtype makes that a no-op instead of a full
    weight copy per step, with identical numerics. Norm scales and the
    embeddings stay fp32."""
    def cast(tree):
        if isinstance(tree, dict):
            return {k: cast(v) for k, v in tree.items()}
        return tree.to(dtype) if tree.dim() == 3 else tree

    return dict(params, blocks=[cast(g) for g in params["blocks"]])


def _layer(tree, i: int):
    """Layer ``i``'s view of a layer-stacked dict of tensors."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _mlp(p: dict, cfg: ArchConfig, h: torch.Tensor) -> torch.Tensor:
    x = rms_norm(h, p["norm2"], cfg.norm_eps)
    return h + swiglu(x, p["mlp"]["w1"], p["mlp"]["w2"], p["mlp"]["w3"])


def _unstack(tree) -> list:
    """Per-layer views of a layer-stacked dict of tensors, via one
    ``unbind`` per leaf: its backward stacks the layers' gradients once,
    where indexing each layer would build a full-size gradient per layer."""
    if isinstance(tree, dict):
        per = {k: _unstack(v) for k, v in tree.items()}
        n = len(next(iter(per.values())))
        return [{k: v[i] for k, v in per.items()} for i in range(n)]
    return list(torch.unbind(tree))


def _block(p: dict, cfg: ArchConfig, h: torch.Tensor, positions: torch.Tensor,
           prefix: int) -> torch.Tensor:
    """One attention-family layer of the training forward."""
    mix = attention.forward(p["mix"], cfg, rms_norm(h, p["norm1"], cfg.norm_eps),
                            positions, window=cfg.window, prefix=prefix)
    return _mlp(p, cfg, h + mix)


def apply_trunk(params: dict, cfg: ArchConfig, x: torch.Tensor,
                positions: torch.Tensor, *, prefix: int = 0
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Training forward: (B, L, d) embedded input -> (final-normed h (B, L,
    d), aux loss ()). The attention family has no auxiliary loss (the
    reference's MoE load-balance term), so aux is 0."""
    check_supported(cfg)
    (group,) = params["blocks"]
    h = x
    for p in _unstack(group["0"]):
        if REMAT:
            h = checkpoint(_block, p, cfg, h, positions, prefix,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            h = _block(p, cfg, h, positions, prefix)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return rms_norm(h, params["final_norm"], cfg.norm_eps), aux


def apply_trunk_prefill(params: dict, cfg: ArchConfig, x: torch.Tensor,
                        positions: torch.Tensor, *, max_seq: int,
                        lengths: torch.Tensor | None = None
                        ) -> tuple[torch.Tensor, list]:
    """(B, L, d) embedded prompt -> (final-normed h (B, L, d), caches)."""
    (group,) = params["blocks"]
    stack = group["0"]
    n = stack["norm1"].shape[0]
    ks, vs = [], []
    h = x
    for i in range(n):
        p = _layer(stack, i)
        mix, c = attention.prefill(
            p["mix"], cfg, rms_norm(h, p["norm1"], cfg.norm_eps), positions,
            max_seq, window=cfg.window, lengths=lengths,
        )
        h = _mlp(p, cfg, h + mix)
        ks.append(c["k"])
        vs.append(c["v"])
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return h, [{"0": {"k": torch.stack(ks), "v": torch.stack(vs)}}]


def insert_cache_slots(full: list, part: list, slots: torch.Tensor, *,
                       pages: torch.Tensor | None = None) -> list:
    """Write a prefill-built cache ``part`` (leaves (layers, Bn, ...)) into
    batch slots of the serving cache ``full`` (leaves (layers, B, ...)), in
    place. The slot's whole ring is replaced, so a recycled slot carries
    nothing over. Rows whose slot id is >= B (admission padding) are
    dropped, as the reference's out-of-range scatter drops them.

    Paged layout (``pages`` (Bn, n_pages) given): ``full``'s leaves are the
    shared pool (layers, n_blocks + 1, block_len, KV, hd); each row's ring
    (layers, Bn, s_c, KV, hd) is cut into pages and written to its physical
    blocks ``pages[b, i]``. Sentinel entries (``n_blocks``: unallocated
    pages, admission pad rows) land in the sink block, where the reference's
    scatter drops them, so no index is filtered on the host."""
    if pages is not None:
        pages = pages.long()
        for g_full, g_part in zip(full, part):
            for name, f in g_full["0"].items():
                p = g_part["0"][name]
                lyr, bn = p.shape[:2]
                block_len = f.shape[2]
                pr = p.reshape((lyr, bn, pages.shape[1], block_len)
                               + p.shape[3:])
                f[:, pages.to(f.device)] = pr.to(f.dtype)
        return full
    for g_full, g_part in zip(full, part):
        for name, f in g_full["0"].items():
            p = g_part["0"][name]
            keep = torch.nonzero(slots.to(p.device) < f.shape[1])[:, 0]
            f[:, slots.to(f.device)[keep].long()] = p[:, keep].to(f.dtype)
    return full


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, dtype,
               device=None, paged: PagedLayout | None = None) -> list:
    """Zeroed serving cache, ``[{"0": {"k", "v"}}]`` with leaves (layers,
    batch, s_c, KV, hd); with ``paged``, the shared block pool (layers,
    n_blocks + 1, block_len, KV, hd) instead, batch-free (the slot -> block
    map is the page table handed to decode and insert)."""
    check_supported(cfg)
    if paged is not None:
        paged.n_pages(cfg, max_seq)  # validate the geometry
        one = attention.init_pool(cfg, paged.n_blocks, paged.block_len,
                                  dtype, device="meta")
    else:
        one = attention.init_cache(cfg, batch, max_seq, dtype, device="meta")
    return [{"0": {k: torch.zeros((cfg.n_layers,) + v.shape, dtype=dtype,
                                  device=device) for k, v in one.items()}}]


def apply_trunk_decode(params: dict, cfg: ArchConfig, x: torch.Tensor,
                       caches: list, pos: torch.Tensor, *,
                       pages: torch.Tensor | None = None,
                       write_mask: torch.Tensor | None = None
                       ) -> tuple[torch.Tensor, list]:
    """(B, 1, d) embedded tokens at positions ``pos`` (B,) -> (final-normed
    h (B, 1, d), caches updated in place). ``pages`` / ``write_mask``: the
    paged layout (:func:`repro_torch.models.attention.decode`)."""
    (group,) = params["blocks"]
    stack = group["0"]
    cache = caches[0]["0"]
    h = x
    for i in range(stack["norm1"].shape[0]):
        p = _layer(stack, i)
        layer_cache = {"k": cache["k"][i], "v": cache["v"][i]}
        mix, _ = attention.decode(
            p["mix"], cfg, rms_norm(h, p["norm1"], cfg.norm_eps), layer_cache,
            pos, window=cfg.window, pages=pages, write_mask=write_mask,
        )
        h = _mlp(p, cfg, h + mix)
    return rms_norm(h, params["final_norm"], cfg.norm_eps), caches
