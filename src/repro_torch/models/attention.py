"""GQA attention with a ring-buffer KV cache, dense per slot or paged in a
shared block pool (counterpart of ``repro/models/attention.py``, attention
family).

Prefill attention is plain PyTorch: fp32 scores with the causal (and
sliding-window) mask, fp32 softmax, output cast back to the compute dtype
— the reference computes it outside any Pallas kernel too. The training
forward (:func:`forward`) uses :func:`blockwise_attention`, the reference's
online softmax over KV blocks with each query block recomputed in the
backward pass, so the (L, L) score matrix never exists whole. Decode
attention goes through the ``flash_decode`` kernel
(:mod:`repro_torch.kernels.ops`), which walks the page table itself on the
paged layout.

**On a mesh** (``mesh=``, :mod:`repro_torch.models.tp`): with the query
heads dividing ``tp``, each rank computes its ``H / tp`` query heads
(``wq`` column-split, ``wo`` row-split, the output summed by
``reduce_from``) and, when the KV heads divide too, its ``KV / tp`` KV
heads, which its cache holds. Where the KV heads do not divide
(recurrentgemma's and paligemma's one KV head, tinyllama's four at tp 16),
``wk`` / ``wv`` are gathered over ``model``, every rank computes every KV
head and attends its query heads to the ones they read. Where the query
heads do not divide ``tp`` either (starcoder2's 24, paligemma's 8 at tp
16), every rank computes the whole layer (:func:`repro_torch.models.tp
.replicated`). A ``tp`` that leaves a rank's query heads reading unequal
shares of the KV heads is refused (no config meets it).

The dense KV ring follows the reference's placement
(:func:`repro_torch.launch.mesh.cache_shardings`): its KV heads over
``model`` where they divide, else its **positions**: rank ``r`` holds ring
slots ``[r s_c / tp, (r + 1) s_c / tp)`` of every KV head (a ring whose
length ``tp`` does not divide is refused by
:func:`repro_torch.models.transformer.init_cache`), and a prefill's ring
is cut to them as it enters the cache
(:func:`repro_torch.models.transformer.insert_cache_slots`). A decode
step writes the new token's K/V on the rank that owns slot ``pos % s_c``
only; each rank attends every query head (``q`` gathered over ``model``) over its own
positions, whose live slots are a prefix of its shard (the ring fills
from slot 0), with ``flash_decode(..., return_lse=True)``, and the ranks'
partial softmaxes combine exactly: ``m = pmax(lse)``, ``w = exp(lse -
m)``, ``o = psum(w o) / psum(w)`` (an empty shard has ``lse = -inf`` and
weighs nothing). Each rank then keeps its query heads for the row-split
``wo``. The paged pool is never split over positions (the reference's
``pool_leaf``): a pool whose KV heads do not divide is held whole on
every rank.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import collectives as coll
from repro_torch.kernels import ops
from repro_torch.models import tp as tp_lib
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import dense_init, rope

__all__ = ["init", "heads", "attention", "blockwise_attention", "forward",
           "prefill", "init_cache", "init_pool", "cache_bytes_per_slot",
           "decode"]

_NEG = -1e30

# Blockwise-attention tile sizes: the K/V stream is re-read once per query
# block, so traffic scales with L / Q_BLOCK.
Q_BLOCK = 512
KV_BLOCK = 512


def init(gen: torch.Generator, cfg: ArchConfig, count: int, device=None) -> dict:
    """``count`` stacked layers of q/k/v/o projections, (count, in, out)."""
    d = cfg.d_model
    return {
        "wq": dense_init(gen, (count, d, cfg.d_attn), device=device),
        "wk": dense_init(gen, (count, d, cfg.d_kv), device=device),
        "wv": dense_init(gen, (count, d, cfg.d_kv), device=device),
        "wo": dense_init(gen, (count, cfg.d_attn, d), device=device),
    }


@dataclasses.dataclass(frozen=True)
class Heads:
    """This rank's share of an attention layer: query heads ``[q0, q0 +
    hq)``; the KV heads it computes and caches, ``[kv_held0, kv_held0 +
    kv_held)``; of those, the ones its queries read, ``[kv0, kv1)``."""

    q0: int
    hq: int
    kv_held0: int
    kv_held: int
    kv0: int
    kv1: int
    rep: bool = False  # the whole layer on every rank (heads not dividing)


def heads(cfg: ArchConfig, mesh=None) -> Heads:
    """The head plan of this rank (the whole layer off a mesh)."""
    h, kvh = cfg.n_heads, cfg.n_kv_heads
    ax = tp_lib.model_axis(mesh)
    if ax is None:
        return Heads(0, h, 0, kvh, 0, kvh)
    tp, m = ax.size, ax.index
    if h % tp:  # a split would cut a head: the whole layer on every rank
        return Heads(0, h, 0, kvh, 0, kvh, rep=True)
    hq = h // tp
    q0 = m * hq
    if kvh % tp == 0:
        n = kvh // tp
        return Heads(q0, hq, m * n, n, 0, n)
    g = h // kvh
    kv0, kv1 = q0 // g, (q0 + hq - 1) // g + 1
    if hq % (kv1 - kv0) or any((q0 + j) // g - kv0 != j // (hq // (kv1 - kv0))
                               for j in range(hq)):
        raise NotImplementedError(
            f"attention on tp={tp}: {hq} query heads a rank read unequal "
            f"shares of {kvh} KV heads")
    return Heads(q0, hq, 0, kvh, kv0, kv1)


def _read_kv(t: torch.Tensor, hp: Heads) -> torch.Tensor:
    """The KV heads (dim 2) this rank's query heads read."""
    if hp.kv0 == 0 and hp.kv1 == t.shape[2]:
        return t
    return t[:, :, hp.kv0:hp.kv1]


def _proj(p: dict, cfg: ArchConfig, mesh, spec: dict | None, hp: Heads,
          dt):
    """(wq, wk, wv, wo) this rank multiplies by: its stored blocks, with
    the KV projections whole where their heads do not divide (all four
    whole where the query heads do not)."""
    if hp.rep:
        return [tp_lib.replicated(p[k], spec[k], mesh, dtype=dt)
                for k in ("wq", "wk", "wv", "wo")]
    out = [p["wq"], p["wk"], p["wv"], p["wo"]]
    if tp_lib.model_axis(mesh) is not None and hp.kv_held == cfg.n_kv_heads:
        out[1:3] = [tp_lib.whole(p[k], spec[k], mesh, dtype=dt)
                    for k in ("wk", "wv")]
    return out


def _qkv(w: list, cfg: ArchConfig, hp: Heads, x: torch.Tensor,
         positions: torch.Tensor):
    b, l, _ = x.shape
    dt = x.dtype
    wq, wk, wv = w[:3]
    q = (x @ wq.to(dt)).reshape(b, l, hp.hq, cfg.head_dim)
    k = (x @ wk.to(dt)).reshape(b, l, hp.kv_held, cfg.head_dim)
    v = (x @ wv.to(dt)).reshape(b, l, hp.kv_held, cfg.head_dim)
    if cfg.use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _enter(x: torch.Tensor, mesh, hp: Heads) -> torch.Tensor:
    ax = tp_lib.model_axis(mesh)
    return x if ax is None or hp.rep else coll.copy_to(x, ax)


def _leave(out: torch.Tensor, mesh, hp: Heads) -> torch.Tensor:
    ax = tp_lib.model_axis(mesh)
    return out if ax is None or hp.rep else coll.reduce_from(out, ax)


def ring_split(cfg: ArchConfig, mesh) -> coll.Axis | None:
    """The model axis the dense KV ring's positions are split over (the KV
    heads not dividing ``tp``), or None (a ring of whole positions)."""
    ax = tp_lib.model_axis(mesh)
    if ax is None or cfg.n_kv_heads % ax.size == 0:
        return None
    return ax


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool, window: int = 0, prefix: int = 0) -> torch.Tensor:
    """(B, L, H, hd) queries against (B, L, KV, hd) keys/values -> (B, L, H,
    hd) in q's dtype; fp32 scores and softmax, masked entries -1e30.
    ``prefix``: the first ``prefix`` positions are attended bidirectionally
    (prefix-LM)."""
    b, l, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qf = q.float().reshape(b, l, kvh, g, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float()) * (1.0 / hd ** 0.5)
    pos = torch.arange(l, device=q.device)
    ok = _mask(pos, pos, causal=causal, window=window, prefix=prefix)
    scores = torch.where(ok, scores, torch.full_like(scores, _NEG))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(b, l, h, hd).to(q.dtype)


def _mask(qpos: torch.Tensor, kpos: torch.Tensor, *, causal: bool,
          window: int, prefix: int) -> torch.Tensor:
    """(qb,), (kb,) -> (qb, kb) bool, True = attend."""
    q = qpos[:, None]
    k = kpos[None, :]
    ok = torch.ones((q.shape[0], k.shape[1]), dtype=torch.bool,
                    device=qpos.device)
    if causal:
        ok = k <= q
        if prefix > 0:  # prefix-LM: bidirectional over the first `prefix`
            ok = ok | (k < prefix)
    if window > 0:
        ok = ok & (k > q - window)
    return ok


def _online_block(carry, k_blk, v_blk, q, qpos, kpos, mask_kw, scale):
    """One KV block of the online softmax. q: (B, qb, KV, G, hd) fp32."""
    m, s, acc = carry
    scores = torch.einsum("bqkgd,bskd->bkgqs", q, k_blk) * scale
    ok = _mask(qpos, kpos, **mask_kw)
    scores = torch.where(ok[None, None, None], scores,
                         torch.full_like(scores, _NEG))
    m_new = torch.maximum(m, scores.amax(-1))
    corr = torch.exp(m - m_new)
    p = torch.exp(scores - m_new[..., None])
    s_new = s * corr + p.sum(-1)
    upd = torch.einsum("bkgqs,bskd->bkgqd", p, v_blk)
    return m_new, s_new, acc * corr[..., None] + upd


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool, window: int = 0, prefix: int = 0,
                        q_block: int | None = None,
                        kv_block: int | None = None) -> torch.Tensor:
    """(B, L, H, hd) queries against (B, L, KV, hd) keys/values -> (B, L, H,
    hd) in q's dtype: fp32 scores, an online softmax (running max, sum,
    accumulator) over KV blocks of ``kv_block``, one query block of
    ``q_block`` at a time, each under non-reentrant ``checkpoint`` so its
    softmax residuals are recomputed in the backward pass. Sliding-window
    layers read only the ``window + q_block`` KV span of a query block."""
    q_block = q_block or Q_BLOCK
    kv_block = kv_block or KV_BLOCK
    b, l, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qb = min(q_block, l)
    kb = min(kv_block, l)
    if l % qb or l % kb:
        raise ValueError(f"sequence length {l} is not a multiple of the "
                         f"attention blocks ({qb}, {kb})")
    scale = 1.0 / (hd ** 0.5)
    qg = q.float().reshape(b, l // qb, qb, kvh, g, hd)
    kf, vf = k.float(), v.float()
    mask_kw = dict(causal=causal, window=window, prefix=prefix)
    span = ((window + qb + kb - 1) // kb) * kb if window > 0 else l
    use_window = 0 < window and span < l
    dev = q.device

    def per_qblock(qi: int, q_blk: torch.Tensor) -> torch.Tensor:
        qpos = qi * qb + torch.arange(qb, device=dev)
        if use_window:
            start = min(max((qi + 1) * qb - span, 0), l - span)
            k_loc, v_loc = kf[:, start:start + span], vf[:, start:start + span]
            kpos0, nkb = start, span // kb
        else:
            k_loc, v_loc, kpos0, nkb = kf, vf, 0, l // kb
        carry = (torch.full((b, kvh, g, qb), _NEG, device=dev),
                 torch.zeros((b, kvh, g, qb), device=dev),
                 torch.zeros((b, kvh, g, qb, hd), device=dev))
        for ki in range(nkb):
            kpos = kpos0 + ki * kb + torch.arange(kb, device=dev)
            carry = _online_block(carry, k_loc[:, ki * kb:(ki + 1) * kb],
                                  v_loc[:, ki * kb:(ki + 1) * kb], q_blk,
                                  qpos, kpos, mask_kw, scale)
        _, s, acc = carry
        out = acc / torch.clamp(s, min=1e-30)[..., None]  # (B, KV, G, qb, hd)
        return out.permute(0, 3, 1, 2, 4)  # (B, qb, KV, G, hd)

    outs = [checkpoint(per_qblock, qi, qg[:, qi], use_reentrant=False,
                       preserve_rng_state=False) for qi in range(l // qb)]
    return torch.cat(outs, dim=1).reshape(b, l, h, hd).to(q.dtype)


def forward(p: dict, cfg: ArchConfig, x: torch.Tensor,
            positions: torch.Tensor, *, window: int | None = None,
            prefix: int = 0, mesh=None, spec: dict | None = None
            ) -> torch.Tensor:
    """Training attention (no cache): (B, L, d) -> (B, L, d). ``spec``:
    the layer's per-layer specs, on a mesh."""
    b, l, _ = x.shape
    win = cfg.window if window is None else window
    hp = heads(cfg, mesh)
    w = _proj(p, cfg, mesh, spec, hp, x.dtype)
    x = _enter(x, mesh, hp)
    q, k, v = _qkv(w, cfg, hp, x, positions)
    out = blockwise_attention(q, _read_kv(k, hp), _read_kv(v, hp),
                              causal=cfg.causal and not cfg.encoder_only,
                              window=win, prefix=prefix)
    out = out.reshape(b, l, hp.hq * cfg.head_dim) @ w[3].to(x.dtype)
    return _leave(out, mesh, hp)


def prefill(p: dict, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor,
            max_seq: int, *, window: int | None = None, prefix: int = 0,
            lengths: torch.Tensor | None = None, mesh=None,
            spec: dict | None = None) -> tuple[torch.Tensor, dict]:
    """Forward + KV-cache build -> (out (B, L, d), {"k", "v"} (B, s_c, KV,
    hd)).

    ``lengths`` (right-padded batched prefill): ring slot j holds the newest
    VALID position p ≡ j (mod s_c), p < lengths[b] — the state a
    token-by-token decode of the prompt would leave — and slots with no
    valid position stay zero. Pads sit after every valid position, so the
    causal mask keeps them out of the valid outputs.

    The ring returned is whole; on a ring split over positions
    (:func:`ring_split`) the serving cache keeps this rank's ``s_c / tp``
    slots of it (:func:`repro_torch.models.transformer.insert_cache_slots`).
    """
    b, l, _ = x.shape
    dt = x.dtype
    win = cfg.window if window is None else window
    hp = heads(cfg, mesh)
    w = _proj(p, cfg, mesh, spec, hp, dt)
    x = _enter(x, mesh, hp)
    q, k, v = _qkv(w, cfg, hp, x, positions)
    out = attention(q, _read_kv(k, hp), _read_kv(v, hp),
                    causal=cfg.causal and not cfg.encoder_only,
                    window=win, prefix=prefix)
    s_c = min(win, max_seq) if win else max_seq
    shape = (b, s_c, hp.kv_held, cfg.head_dim)
    if lengths is not None:
        j = torch.arange(s_c, device=x.device)
        last = lengths.to(x.device).long()[:, None] - 1
        pj = last - torch.remainder(last - j[None], s_c)  # (B, s_c)
        live = (pj >= 0)[..., None, None]
        rows = torch.arange(b, device=x.device)[:, None]
        pc = pj.clamp(0, l - 1)
        ck = torch.where(live, k[rows, pc], torch.zeros((), dtype=dt,
                                                        device=x.device))
        cv = torch.where(live, v[rows, pc], torch.zeros((), dtype=dt,
                                                        device=x.device))
    elif l <= s_c:
        ck = torch.zeros(shape, dtype=dt, device=x.device)
        cv = torch.zeros(shape, dtype=dt, device=x.device)
        ck[:, :l] = k
        cv[:, :l] = v
    else:  # ring buffer: keep the last s_c keys at their ring slots
        slots = torch.arange(l - s_c, l, device=x.device) % s_c
        ck = torch.zeros(shape, dtype=dt, device=x.device)
        cv = torch.zeros(shape, dtype=dt, device=x.device)
        ck[:, slots] = k[:, l - s_c:]
        cv[:, slots] = v[:, l - s_c:]
    out = out.reshape(b, l, hp.hq * cfg.head_dim) @ w[3].to(dt)
    return _leave(out, mesh, hp), {"k": ck.to(dt), "v": cv.to(dt)}


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, dtype,
               window: int | None = None, device=None) -> dict:
    """Zeroed dense KV ring, (batch, s_c, KV, hd) per leaf (the global
    shape: :func:`repro_torch.models.transformer.init_cache` cuts it to a
    rank's KV heads on a mesh)."""
    win = cfg.window if window is None else window
    s_c = min(win, max_seq) if win else max_seq
    shape = (batch, s_c, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_pool(cfg: ArchConfig, n_blocks: int, block_len: int, dtype,
              device=None) -> dict:
    """Zeroed shared paged KV pool: ``n_blocks`` blocks of ``block_len``
    positions, owned by no slot, plus one sink block at id ``n_blocks``
    (the page tables' sentinel), so ``(n_blocks + 1, block_len, KV, hd)``
    per leaf. The sink takes the writes the reference's out-of-range
    scatter drops (sentinel pages, rows whose ``write_mask`` is False)
    without a host-side filter; nothing reads it below a row's
    ``lengths``."""
    shape = (n_blocks + 1, block_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def cache_bytes_per_slot(cfg: ArchConfig, max_seq: int, dtype,
                         window: int | None = None) -> int:
    """Device bytes ONE dense slot reserves for this layer's KV ring: what
    the paged pool frees serving from."""
    win = cfg.window if window is None else window
    s_c = min(win, max_seq) if win else max_seq
    itemsize = torch.empty((), dtype=dtype, device="meta").element_size()
    return 2 * s_c * cfg.n_kv_heads * cfg.head_dim * itemsize


def decode(p: dict, cfg: ArchConfig, x: torch.Tensor, cache: dict,
           pos: torch.Tensor, *, window: int | None = None,
           pages: torch.Tensor | None = None,
           write_mask: torch.Tensor | None = None, mesh=None,
           spec: dict | None = None) -> tuple[torch.Tensor, dict]:
    """Single-token decode against a per-slot KV ring OR a paged pool.

    Dense (``pages=None``): ``cache`` leaves are ``(B, s_c, KV, hd)`` rings
    owned by their slot; the new token's K/V are written IN PLACE at ring
    slot ``pos % s_c`` (the reference returns an updated copy; overwriting
    saves a full cache copy per layer and step).

    Paged: ``cache`` leaves are the shared ``(n_blocks + 1, block_len, KV,
    hd)`` pool and ``pages[b, i]`` names the physical block behind slot
    ``b``'s i-th ring page (``s_c = n_pages * block_len``): the write goes
    to block ``pages[b, (pos % s_c) // block_len]`` at offset ``(pos % s_c)
    % block_len``, or to the sink block ``n_blocks`` for rows whose
    ``write_mask`` is False (retired slots, whose blocks may already belong
    to another request). ``flash_decode`` then attends over the first
    ``min(pos + 1, s_c)`` ring rows through the page table, reading the
    pool in place (no gathered view).

    On a mesh the cache holds this rank's KV heads (:func:`heads`) and
    ``flash_decode`` runs on its query heads; a dense ring split over
    positions (:func:`ring_split`) takes the cross-rank combine (module
    docstring).
    """
    b = x.shape[0]
    dt = x.dtype
    hp = heads(cfg, mesh)
    w = _proj(p, cfg, mesh, spec, hp, dt)
    x = _enter(x, mesh, hp)
    q, k, v = _qkv(w, cfg, hp, x, pos[:, None])
    ar = torch.arange(b, device=x.device)
    ax = ring_split(cfg, mesh) if pages is None else None
    if ax is not None:
        o = _decode_split(cache, q[:, 0], k[:, 0], v[:, 0], pos, ax, hp)
    else:
        if pages is None:
            s_c = cache["k"].shape[1]
            slot = torch.remainder(pos.long(), s_c)
            cache["k"][ar, slot] = k[:, 0].to(cache["k"].dtype)
            cache["v"][ar, slot] = v[:, 0].to(cache["v"].dtype)
        else:
            sink, block_len = cache["k"].shape[0] - 1, cache["k"].shape[1]
            s_c = pages.shape[1] * block_len
            slot = torch.remainder(pos.long(), s_c)
            phys = pages.long()[ar, slot // block_len]
            if write_mask is not None:  # retired slot: blocks may be reowned
                phys = torch.where(write_mask, phys,
                                   torch.full_like(phys, sink))
            off = slot % block_len
            cache["k"][phys, off] = k[:, 0].to(cache["k"].dtype)
            cache["v"][phys, off] = v[:, 0].to(cache["v"].dtype)
        lengths = torch.clamp(pos + 1, max=s_c).to(torch.int32)
        o = ops.flash_decode(q[:, 0], _read_kv(cache["k"], hp),
                             _read_kv(cache["v"], hp), lengths, pages=pages)
    out = o.to(dt).reshape(b, 1, hp.hq * cfg.head_dim) @ w[3].to(dt)
    return _leave(out, mesh, hp), cache


def _decode_split(cache: dict, q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor, pos: torch.Tensor, ax: coll.Axis,
                  hp: Heads) -> torch.Tensor:
    """One decode step on a ring whose positions are split over ``ax``:
    ``q`` (B, hq, hd) this rank's query heads, ``k`` / ``v`` (B, KV, hd)
    the new token's; -> this rank's heads' output (B, hq, hd) fp32."""
    b = q.shape[0]
    s_loc = cache["k"].shape[1]
    r0 = ax.index * s_loc  # this rank's first ring slot
    s_c = s_loc * ax.size
    ar = torch.arange(b, device=q.device)
    slot = torch.remainder(pos.long(), s_c) - r0
    mine = (slot >= 0) & (slot < s_loc)  # the owner writes, the rest keep
    at = slot.clamp(0, s_loc - 1)
    for name, new in (("k", k), ("v", v)):
        c = cache[name]
        c[ar, at] = torch.where(mine[:, None, None], new.to(c.dtype),
                                c[ar, at])
    # the live slots are a prefix of the ring, so a prefix of each shard
    live = torch.clamp(pos + 1, max=s_c) - r0
    lengths = live.clamp(0, s_loc).to(torch.int32)
    q_all = q if hp.rep else torch.cat(coll.all_gather(q, ax).unbind(0), 1)
    o, lse = ops.flash_decode(q_all, cache["k"], cache["v"], lengths,
                              return_lse=True)
    m = coll.pmax(lse, ax)  # finite: slot 0 is live on the first rank
    wgt = torch.exp(lse - m)  # an empty shard: exp(-inf) = 0
    tot = coll.psum(torch.cat([o * wgt[..., None], wgt[..., None]], -1), ax)
    o = tot[..., :-1] / tot[..., -1:]
    return o if hp.rep else o[:, hp.q0:hp.q0 + hp.hq]
