"""Trunk assembly over every layer family (counterpart of
``repro/models/transformer.py``): attention, MoE, Mamba-2 SSM and Griffin's
(rec, rec, attn) blocks.

Parameters keep the reference's stacked pytree structure: ``blocks`` is a
list of *block groups* (:func:`block_groups`), each a dict ``{"0": layer,
"1": ...}`` over the group's pattern whose leaves carry a leading layer
axis (Griffin: a (rec, rec, attn) period group and a remainder group; every
other family one group of one kind). Where the reference scans that axis
with ``lax.scan``, the port loops over it in Python and hands each group
step a view of its slice. The training forward (:func:`apply_trunk`) runs
each group step under non-reentrant ``torch.utils.checkpoint`` where the
reference wraps each scan step in ``jax.checkpoint`` (``REMAT``): only
step-boundary activations are kept for the backward pass.

Caches mirror the same structure: attention layers a KV ring ``(layers, B,
s_c, KV, hd)`` per leaf, SSM and RG-LRU layers their fixed-size recurrent
state and conv tail ``(layers, B, ...)``; decode updates them in place. The
paged layout (:class:`PagedLayout`) swaps each attention leaf for a shared
block pool ``(layers, n_blocks + 1, block_len, KV, hd)`` addressed through
per-slot page tables; its last block is the sink that takes the writes a
page table does not map (see :func:`repro_torch.models.attention
.init_pool`). Recurrent state stays slot-resident in both layouts.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention, moe, rglru, ssm
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import dense_init, mlp_init, rms_norm, swiglu

__all__ = [
    "block_groups",
    "init_params",
    "compute_params",
    "apply_trunk",
    "apply_trunk_prefill",
    "insert_cache_slots",
    "init_cache",
    "cache_bytes_per_slot",
    "apply_trunk_decode",
    "PagedLayout",
    "ring_len",
]


REMAT = True  # recompute each group step in the backward pass (tests may
#   disable)

# the block leaves the reference casts to the compute dtype at use
# (``.astype(dt)`` before a matmul): attention and SwiGLU / expert weights,
# the router, and the SSM and RG-LRU projections. Everything else (norms,
# conv taps, dt_bias, a_log, d_skip, lam, the block-diagonal gates w_a /
# w_i) is read in fp32 somewhere and stays fp32.
_CAST = frozenset({"wq", "wk", "wv", "wo", "w1", "w2", "w3", "router", "wx",
                   "wz", "wb", "wc", "wdt", "w_gate_branch", "w_in",
                   "w_out"})


def _layer_window(cfg: ArchConfig) -> int:
    """Attention window of this arch's attention layers; the one source for
    prefill, decode, training and cache sizing (Griffin's local attention
    takes ``local_window``)."""
    return cfg.local_window if cfg.layer_pattern == "griffin" else cfg.window


def ring_len(cfg: ArchConfig, max_seq: int) -> int:
    """KV ring length s_c of the attention layers: what a slot's page table
    must cover (``n_pages * block_len == s_c``)."""
    win = _layer_window(cfg)
    return min(win, max_seq) if win else max_seq


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


def block_groups(cfg: ArchConfig) -> list[tuple[tuple[str, ...], int]]:
    """[(pattern, repeat)] covering ``cfg.layer_kinds()``: Griffin's (rec,
    rec, attn) period repeated, plus the remainder as a group of one; every
    other family one group of its single kind."""
    kinds = cfg.layer_kinds()
    if cfg.layer_pattern == "griffin":
        period = ("rec", "rec", "attn")
        n_full = len(kinds) // 3
        groups = [(period, n_full)]
        if len(kinds) > 3 * n_full:
            groups.append((tuple(kinds[3 * n_full:]), 1))
        return groups
    return [((kinds[0],), len(kinds))]


# ----------------------------------------------------------------- init


def _init_layers(gen: torch.Generator, cfg: ArchConfig, kind: str,
                 count: int, device=None) -> dict:
    """``count`` stacked layers of one kind; SSM layers have no MLP, MoE
    archs get an MoE MLP."""
    d = cfg.d_model
    p: dict[str, Any] = {"norm1": torch.zeros((count, d), device=device)}
    if kind == "attn":
        p["mix"] = attention.init(gen, cfg, count, device=device)
    elif kind == "rec":
        p["mix"] = rglru.init(gen, cfg, count, device=device)
    elif kind == "ssm":
        p["mix"] = ssm.init(gen, cfg, count, device=device)
        return p  # mamba blocks: norm + mixer only
    else:
        raise ValueError(kind)
    p["norm2"] = torch.zeros((count, d), device=device)
    p["mlp"] = (moe.init(gen, cfg, count, device=device) if cfg.is_moe
                else mlp_init(gen, d, cfg.d_ff, count, device=device))
    return p


def init_params(gen: torch.Generator, cfg: ArchConfig, device=None) -> dict:
    """fp32 master parameters from ``gen``, in the reference's structure
    (no ``embed`` for the audio stub, which feeds frame embeddings)."""
    d, vp = cfg.d_model, cfg.vocab_padded
    params: dict[str, Any] = {}
    if cfg.frontend != "audio_stub":
        params["embed"] = dense_init(gen, (vp, d), in_axis=-1, device=device)
    params["out_embed"] = (
        None if cfg.tie_embeddings
        else dense_init(gen, (vp, d), in_axis=-1, device=device))
    params["final_norm"] = torch.zeros((d,), device=device)
    params["blocks"] = [
        {str(j): _init_layers(gen, cfg, kind, count, device=device)
         for j, kind in enumerate(pattern)}
        for pattern, count in block_groups(cfg)]
    return params


def compute_params(params: dict, dtype: torch.dtype) -> dict:
    """The parameters with every block leaf the reference casts at use
    (``_CAST``: the matmul weights) cast to ``dtype`` once.

    Layers cast weights at use (``w.to(x.dtype)``); handing them weights
    already in the compute dtype makes that a no-op instead of a full
    weight copy per step, with identical numerics. Leaves the reference
    reads in fp32 (norms, conv taps, the SSM's dt_bias / a_log / d_skip,
    the RG-LRU's lam and gates) and the embeddings stay fp32."""
    def cast(tree, name=None):
        if isinstance(tree, dict):
            return {k: cast(v, k) for k, v in tree.items()}
        return tree.to(dtype) if name in _CAST else tree

    return dict(params, blocks=[cast(g) for g in params["blocks"]])


def _layer(tree, i: int):
    """Layer ``i``'s view of a layer-stacked dict of tensors."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _count(tree) -> int:
    """Leading (layer) extent of a layer-stacked dict of tensors."""
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.shape[0]


def _unstack(tree) -> list:
    """Per-layer views of a layer-stacked dict of tensors, via one
    ``unbind`` per leaf: its backward stacks the layers' gradients once,
    where indexing each layer would build a full-size gradient per layer."""
    if isinstance(tree, dict):
        per = {k: _unstack(v) for k, v in tree.items()}
        n = len(next(iter(per.values())))
        return [{k: v[i] for k, v in per.items()} for i in range(n)]
    return list(torch.unbind(tree))


def _ffn(p: dict, cfg: ArchConfig, h: torch.Tensor, mesh=None
         ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The post-mixer sub-block: h + MLP(norm2(h)) (SwiGLU, or the MoE with
    its aux loss; None for SwiGLU). On a mesh the MoE runs with its experts
    split over the model axis (:func:`moe.forward_dist`)."""
    x = rms_norm(h, p["norm2"], cfg.norm_eps)
    if cfg.is_moe:
        b, l, d = x.shape
        if mesh is not None:
            out, aux = moe.forward_dist(p["mlp"], cfg, x.reshape(-1, d), mesh)
        else:
            out, aux = moe.forward(p["mlp"], cfg, x.reshape(-1, d))
        return h + out.reshape(b, l, d), aux
    return h + swiglu(x, p["mlp"]["w1"], p["mlp"]["w2"], p["mlp"]["w3"]), None


# ----------------------------------------------------------------- train


def _block(p: dict, cfg: ArchConfig, kind: str, h: torch.Tensor,
           positions: torch.Tensor, prefix: int, mesh=None
           ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """One layer of the training forward -> (h, aux or None)."""
    x = rms_norm(h, p["norm1"], cfg.norm_eps)
    if kind == "ssm":
        return h + ssm.forward(p["mix"], cfg, x), None
    if kind == "attn":
        mix = attention.forward(p["mix"], cfg, x, positions,
                                window=_layer_window(cfg), prefix=prefix)
    else:  # rec
        mix = rglru.forward(p["mix"], cfg, x)
    return _ffn(p, cfg, h + mix, mesh)


def _group_step(ps: dict, pattern: tuple, cfg: ArchConfig, h: torch.Tensor,
                positions: torch.Tensor, prefix: int, mesh=None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """One step of a block group (one layer of each pattern kind) -> (h,
    the step's summed aux loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for j, kind in enumerate(pattern):
        h, a = _block(ps[str(j)], cfg, kind, h, positions, prefix, mesh)
        if a is not None:
            aux = aux + a
    return h, aux


def apply_trunk(params: dict, cfg: ArchConfig, x: torch.Tensor,
                positions: torch.Tensor, *, prefix: int = 0,
                return_taps: bool = False, mesh=None):
    """Training forward: (B, L, d) embedded input -> (final-normed h (B, L,
    d), aux loss () fp32: the MoE load-balance terms summed over layers, 0
    for the other families).

    With ``return_taps``, also the taps (n_taps, B, L, d) fp32: the
    activation after each block-group step (a whole period for Griffin's
    (rec, rec, attn) group), then the final normed output — what deep-kNN
    (:mod:`repro_torch.workloads.dknn`) indexes, one index per tap.

    ``mesh`` (:class:`repro_torch.launch.mesh.Mesh`): MoE layers split their
    experts over its model axis; the rest of the trunk is replicated and
    the batch is this data rank's (so nothing here constrains it, where the
    reference pins activations to the batch axes)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = x
    taps = []
    for stack, (pattern, _) in zip(params["blocks"], block_groups(cfg)):
        for ps in _unstack(stack):
            if REMAT:
                h, a = checkpoint(_group_step, ps, pattern, cfg, h,
                                  positions, prefix, mesh,
                                  use_reentrant=False,
                                  preserve_rng_state=False)
            else:
                h, a = _group_step(ps, pattern, cfg, h, positions, prefix,
                                   mesh)
            aux = aux + a
            if return_taps:
                taps.append(h.float())
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    if return_taps:
        taps.append(h.float())
        return h, aux, torch.stack(taps)
    return h, aux


# ----------------------------------------------------------------- prefill


def _block_prefill(p: dict, cfg: ArchConfig, kind: str, h: torch.Tensor,
                   positions: torch.Tensor, max_seq: int, prefix: int,
                   lengths: torch.Tensor | None, mesh=None
                   ) -> tuple[torch.Tensor, dict]:
    x = rms_norm(h, p["norm1"], cfg.norm_eps)
    if kind == "ssm":
        mix, cache = ssm.forward(p["mix"], cfg, x, return_cache=True,
                                 lengths=lengths)
        return h + mix, cache
    if kind == "attn":
        mix, cache = attention.prefill(
            p["mix"], cfg, x, positions, max_seq, window=_layer_window(cfg),
            prefix=prefix, lengths=lengths)
    else:
        mix, cache = rglru.forward(p["mix"], cfg, x, return_cache=True,
                                   lengths=lengths)
    h, _ = _ffn(p, cfg, h + mix, mesh)
    return h, cache


def apply_trunk_prefill(params: dict, cfg: ArchConfig, x: torch.Tensor,
                        positions: torch.Tensor, *, max_seq: int,
                        prefix: int = 0,
                        lengths: torch.Tensor | None = None, mesh=None
                        ) -> tuple[torch.Tensor, list]:
    """(B, L, d) embedded prompt -> (final-normed h (B, L, d), caches in the
    block-group structure, leaves (layers, B, ...)). ``prefix``: the vision
    stub's bidirectional image tokens; ``lengths``: right-padded rows."""
    caches = []
    h = x
    for stack, (pattern, _) in zip(params["blocks"], block_groups(cfg)):
        per: dict[str, list] = {str(j): [] for j in range(len(pattern))}
        for i in range(_count(stack)):
            ps = _layer(stack, i)
            for j, kind in enumerate(pattern):
                h, c = _block_prefill(ps[str(j)], cfg, kind, h, positions,
                                      max_seq, prefix, lengths, mesh)
                per[str(j)].append(c)
        caches.append({j: {name: torch.stack([c[name] for c in cs])
                           for name in cs[0]} for j, cs in per.items()})
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return h, caches


def insert_cache_slots(full: list, part: list, slots: torch.Tensor, *,
                       pages: torch.Tensor | None = None) -> list:
    """Write a prefill-built cache ``part`` (leaves (layers, Bn, ...)) into
    batch slots of the serving cache ``full`` (leaves (layers, B, ...)), in
    place. A slot's whole state is replaced (KV ring, SSM / RG-LRU state,
    conv tails), so a recycled slot carries nothing over. Rows whose slot
    id is >= B (admission padding) are dropped, as the reference's
    out-of-range scatter drops them.

    Paged layout (``pages`` (Bn, n_pages) given): ``full``'s attention
    leaves are the shared pool (layers, n_blocks + 1, block_len, KV, hd);
    each row's ring (layers, Bn, s_c, KV, hd) is cut into pages and written
    to its physical blocks ``pages[b, i]``. Sentinel entries (``n_blocks``:
    unallocated pages, admission pad rows) land in the sink block, where the
    reference's scatter drops them. Recurrent leaves are slot-scattered in
    both layouts."""
    keep = None
    for g_full, g_part in zip(full, part):
        for j, f_layer in g_full.items():
            paged = pages is not None and "k" in f_layer  # attention pool
            for name, f in f_layer.items():
                p = g_part[j][name]
                if paged:
                    pg = pages.long().to(f.device)
                    lyr, bn = p.shape[:2]
                    pr = p.reshape((lyr, bn, pg.shape[1], f.shape[2])
                                   + p.shape[3:])
                    f[:, pg] = pr.to(f.dtype)
                    continue
                if keep is None:  # one host read for the whole cache
                    keep = torch.nonzero(slots.to(p.device) < f.shape[1])[:, 0]
                f[:, slots.to(f.device)[keep].long()] = p[:, keep].to(f.dtype)
    return full


# ----------------------------------------------------------------- decode


def _block_cache(cfg: ArchConfig, kind: str, batch: int, max_seq: int, dtype,
                 paged: PagedLayout | None) -> dict:
    """One layer's cache leaves, on the meta device (shapes and dtypes)."""
    if kind == "attn":
        if paged is not None:
            return attention.init_pool(cfg, paged.n_blocks, paged.block_len,
                                       dtype, device="meta")
        return attention.init_cache(cfg, batch, max_seq, dtype,
                                    window=_layer_window(cfg), device="meta")
    if kind == "ssm":
        return ssm.init_cache(cfg, batch, dtype, device="meta")
    if kind == "rec":
        return rglru.init_cache(cfg, batch, dtype, device="meta")
    raise ValueError(kind)


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, dtype,
               device=None, paged: PagedLayout | None = None) -> list:
    """Zeroed serving cache in the block-group structure: attention leaves
    (layers, batch, s_c, KV, hd); SSM / RG-LRU leaves (layers, batch, ...)
    (fp32 state, conv tail in ``dtype``). With ``paged``, the attention
    leaves are the shared block pool (layers, n_blocks + 1, block_len, KV,
    hd) instead, batch-free (the slot -> block map is the page table handed
    to decode and insert); an arch without attention layers raises
    ``ValueError``, as its decode state is already max_seq-free."""
    if paged is not None:
        if "attn" not in cfg.layer_kinds():
            raise ValueError(
                "paged cache layout requires attention layers; arch "
                f"{cfg.layer_pattern!r} has none (its decode state is "
                "already max_seq-free)")
        paged.n_pages(cfg, max_seq)  # validate the geometry
    caches = []
    for pattern, count in block_groups(cfg):
        group = {}
        for j, kind in enumerate(pattern):
            one = _block_cache(cfg, kind, batch, max_seq, dtype, paged)
            group[str(j)] = {k: torch.zeros((count,) + v.shape, dtype=v.dtype,
                                            device=device)
                             for k, v in one.items()}
        caches.append(group)
    return caches


def cache_bytes_per_slot(cfg: ArchConfig, max_seq: int, dtype) -> int:
    """Device bytes one dense serving slot holds over every layer: the KV
    rings (at the attention window, :func:`_layer_window`) and the
    recurrent state."""
    total = 0
    for kind in cfg.layer_kinds():
        if kind == "attn":
            total += attention.cache_bytes_per_slot(
                cfg, max_seq, dtype, window=_layer_window(cfg))
        elif kind == "ssm":
            total += ssm.cache_bytes_per_slot(cfg, dtype)
        else:
            total += rglru.cache_bytes_per_slot(cfg, dtype)
    return total


def apply_trunk_decode(params: dict, cfg: ArchConfig, x: torch.Tensor,
                       caches: list, pos: torch.Tensor, *,
                       pages: torch.Tensor | None = None,
                       write_mask: torch.Tensor | None = None, mesh=None
                       ) -> tuple[torch.Tensor, list]:
    """(B, 1, d) embedded tokens at positions ``pos`` (B,) -> (final-normed
    h (B, 1, d), caches updated in place). ``pages`` / ``write_mask``: the
    paged layout of the attention leaves
    (:func:`repro_torch.models.attention.decode`)."""
    h = x
    win = _layer_window(cfg)
    for stack, cache, (pattern, _) in zip(params["blocks"], caches,
                                          block_groups(cfg)):
        for i in range(_count(stack)):
            ps = _layer(stack, i)
            for j, kind in enumerate(pattern):
                p = ps[str(j)]
                lc = _layer(cache[str(j)], i)
                xn = rms_norm(h, p["norm1"], cfg.norm_eps)
                if kind == "attn":
                    mix, _ = attention.decode(p["mix"], cfg, xn, lc, pos,
                                              window=win, pages=pages,
                                              write_mask=write_mask)
                else:
                    mod = ssm if kind == "ssm" else rglru
                    mix, new = mod.decode(p["mix"], cfg, xn, lc)
                    for name, v in new.items():
                        lc[name].copy_(v)
                if kind == "ssm":
                    h = h + mix
                else:
                    h, _ = _ffn(p, cfg, h + mix, mesh)
    return rms_norm(h, params["final_norm"], cfg.norm_eps), caches
