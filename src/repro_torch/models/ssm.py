"""Mamba-2 block: state-space duality (SSD), chunked (counterpart of
``repro/models/ssm.py``).

Training and prefill run the chunked SSD algorithm (Dao & Gu 2024): within
each chunk of Q tokens the output is a masked quadratic form; across chunks
the (H, hd, N) state is carried with a per-chunk exponential decay, by a
Python loop over the chunks where the reference runs ``lax.scan``. Decode is
the O(1) recurrent update. A causal depthwise conv (width 4) precedes the SSM
over the [x, B, C] projections; its (width-1)-deep tail is cached for
decode. The SSD sums run in fp32 (TF32 stays off, ``repro_torch/__init__``).

Prefill convolves in the compute dtype (``conv`` cast at use), decode in
fp32 against the fp32 ``conv``: that asymmetry is the reference's.

**On a mesh** (``mesh=``), with the SSM heads dividing ``tp``: each rank
runs its ``H / tp`` heads — ``wx`` / ``wz`` / ``wdt`` column-split,
``dt_bias`` / ``a_log`` / ``d_skip`` / ``norm`` and the ``u`` channels of
``conv`` sliced to them, ``wb`` / ``wc`` gathered whole (B and C are
shared by every head), the gated RMSNorm's sum of squares summed over
``model`` (it normalises the whole ``d_inner``), ``wo`` row-split — and
its decode ``state`` is its heads'. The conv tail stays whole on every
rank (the reference's cache placement), so prefill and decode gather
the tail's ``u`` channels. A ``tp`` the SSM heads do not divide is
refused (no config meets it at tp ≤ 4).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import collectives as coll
from repro_torch.models import tp as tp_lib
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import dense_init, masked_conv_tail, rms_norm

__all__ = ["init", "forward", "init_cache", "cache_bytes_per_slot", "decode",
           "softplus"]


def init(gen: torch.Generator, cfg: ArchConfig, count: int,
         device=None) -> dict:
    """``count`` stacked SSM mixers, fp32, in the reference's structure."""
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_dim = di + 2 * n
    return {
        "wx": dense_init(gen, (count, d, di), device=device),
        "wz": dense_init(gen, (count, d, di), device=device),
        "wb": dense_init(gen, (count, d, n), device=device),
        "wc": dense_init(gen, (count, d, n), device=device),
        "wdt": dense_init(gen, (count, d, h), device=device),
        "dt_bias": torch.zeros((count, h), device=device),
        "conv": dense_init(gen, (count, cfg.conv_width, conv_dim), in_axis=1,
                           device=device),
        "a_log": torch.zeros((count, h), device=device),  # A = -exp(0) = -1
        "d_skip": torch.ones((count, h), device=device),
        "norm": torch.zeros((count, di), device=device),
        "wo": dense_init(gen, (count, di, d), device=device),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) as logaddexp(x, 0), no threshold."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _causal_conv(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv in ``u``'s dtype. u: (B, L, C), w: (width, C)."""
    width, l = w.shape[0], u.shape[1]
    pad = F.pad(u, (0, 0, width - 1, 0))
    out = torch.zeros_like(u)
    for i in range(width):
        out = out + pad[:, i:i + l] * w[i][None, None, :]
    return out


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """(..., Q) per-step log-decays -> (..., Q, Q) lower-triangular
    cumulative sums, -inf above the diagonal."""
    q = x.shape[-1]
    cs = torch.cumsum(x, -1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    return torch.where(mask, seg, torch.full((), float("-inf"),
                                             device=x.device))


class _Split:
    """This rank's SSM heads ``[h0, h0 + h)`` and ``d_inner`` channels
    ``[u0, u0 + di)``; ``ax`` is None off a mesh."""

    def __init__(self, cfg: ArchConfig, mesh):
        ax = tp_lib.model_axis(mesh)
        tp, m = (1, 0) if ax is None else (ax.size, ax.index)
        if cfg.ssm_heads % tp:
            raise NotImplementedError(
                f"SSM on tp={tp}: {cfg.ssm_heads} heads do not divide")
        self.ax = ax
        self.h = cfg.ssm_heads // tp
        self.h0 = m * self.h
        self.di = self.h * cfg.ssm_head_dim
        self.u0 = m * self.di


def _leaves(p: dict, cfg: ArchConfig, spec: dict | None, mesh, sp: _Split,
            dt) -> dict:
    """The leaves this rank computes with (see the module doc): its
    heads', with B and C's projections whole."""
    if sp.ax is None:
        return p
    ax, di = sp.ax, cfg.d_inner
    out = dict(p)
    for k in ("wb", "wc"):
        out[k] = tp_lib.whole(p[k], spec[k], mesh, dtype=dt)
    for k in ("dt_bias", "a_log", "d_skip"):
        out[k] = tp_lib.local(p[k], ax, 0, sp.h0, sp.h)
    out["norm"] = tp_lib.local(p["norm"], ax, 0, sp.u0, sp.di)
    conv = coll.copy_to(p["conv"], ax)
    out["conv"] = torch.cat([conv[:, sp.u0:sp.u0 + sp.di], conv[:, di:]],
                            dim=1)
    return out


def _project(p: dict, x: torch.Tensor):
    """Shared projections. x: (B, L, d) -> (ubc (B, L, conv_dim), z, dt fp32
    (B, L, H)) (this rank's ``u`` channels and heads on a mesh)."""
    dt_ = x.dtype
    u = x @ p["wx"].to(dt_)
    z = x @ p["wz"].to(dt_)
    bb = x @ p["wb"].to(dt_)
    cc = x @ p["wc"].to(dt_)
    dt = softplus((x @ p["wdt"].to(dt_)).float() + p["dt_bias"])
    return torch.cat([u, bb, cc], dim=-1), z, dt


def _split_conv_out(cfg: ArchConfig, conv_out: torch.Tensor, di: int):
    n = cfg.ssm_state
    return (F.silu(conv_out[..., :di]), F.silu(conv_out[..., di:di + n]),
            F.silu(conv_out[..., di + n:]))


def _out(p: dict, cfg: ArchConfig, y: torch.Tensor, z: torch.Tensor,
         dtype, sp: _Split) -> torch.Tensor:
    """Gated norm and output projection of the (B, L, d_inner) SSM output
    (this rank's channels on the Megatron route: the norm's sum of squares
    and the projection's partials summed over the model axis)."""
    y = y.to(dtype) * F.silu(z)
    if sp.ax is None:
        return rms_norm(y, p["norm"], cfg.norm_eps) @ p["wo"].to(dtype)
    yf = y.float()
    ss = coll.all_reduce((yf * yf).sum(dim=-1, keepdim=True), sp.ax)
    yn = (yf * torch.rsqrt(ss / cfg.d_inner + cfg.norm_eps)
          * (1.0 + p["norm"].float())).to(dtype)
    return coll.reduce_from(yn @ p["wo"].to(dtype), sp.ax)


def _full_tail(tail: torch.Tensor, sp: _Split) -> torch.Tensor:
    """A conv tail of this rank's ``u`` channels plus B, C -> the whole
    tail every rank caches (the ``u`` channels gathered over the axis)."""
    if sp.ax is None:
        return tail
    u = coll.all_gather(tail[..., :sp.di], sp.ax).unbind(0)
    return torch.cat(list(u) + [tail[..., sp.di:]], dim=-1)


def forward(p: dict, cfg: ArchConfig, x: torch.Tensor, chunk: int = 128,
            return_cache: bool = False,
            lengths: torch.Tensor | None = None, mesh=None,
            spec: dict | None = None):
    """(B, L, d) -> (B, L, d) [, cache {"state" (B, H, hd, N) fp32, "conv"
    (B, width-1, conv_dim)}]. ``spec``: the layer's per-layer specs, on a
    mesh.

    ``lengths`` ((B,) valid prefix lengths, right-padded batched prefill):
    pads get dt masked to 0, so their decay is 1 and their state
    contribution 0; the state passes through them unchanged and the
    returned cache is the state after each row's last valid token.
    L must be a multiple of ``min(chunk, L)``, as in the reference."""
    b, l, _ = x.shape
    sp = _Split(cfg, mesh)
    p = _leaves(p, cfg, spec, mesh, sp, x.dtype)
    if sp.ax is not None:
        x = coll.copy_to(x, sp.ax)
    h, hd, n = sp.h, cfg.ssm_head_dim, cfg.ssm_state
    q = min(chunk, l)
    assert l % q == 0, (l, q)
    nc = l // q

    ubc, z, dt = _project(p, x)
    if lengths is not None:
        valid = (torch.arange(l, device=x.device)[None, :]
                 < lengths.to(x.device)[:, None])
        dt = torch.where(valid[..., None], dt, torch.zeros((), device=x.device))
    u, bb, cc = _split_conv_out(cfg, _causal_conv(ubc, p["conv"].to(x.dtype)),
                                sp.di)

    a = -torch.exp(p["a_log"])  # (H,)
    da = (dt * a).reshape(b, nc, q, h)  # log-decay per step
    xh = u.reshape(b, nc, q, h, hd).float()
    dtx = xh * dt.reshape(b, nc, q, h)[..., None]  # (B, nc, Q, H, hd)
    bc_ = bb.reshape(b, nc, q, n).float()
    cc_ = cc.reshape(b, nc, q, n).float()

    da_h = da.permute(0, 1, 3, 2)  # (B, nc, H, Q)
    cs = torch.cumsum(da_h, -1)
    # intra-chunk (diagonal) term
    decay = torch.exp(_segsum(da_h))  # (B, nc, H, Q, Q)
    g = torch.einsum("bcqn,bcsn->bcqs", cc_, bc_)
    y_diag = torch.einsum("bchqs,bcshp->bcqhp", decay * g[:, :, None], dtx)
    # chunk-final states
    decay_out = torch.exp(cs[..., -1:] - cs)  # (B, nc, H, Q)
    states = torch.einsum("bcshp,bcsn->bchpn",
                          dtx * decay_out.permute(0, 1, 3, 2)[..., None], bc_)
    # inter-chunk recurrence: the state entering each chunk
    chunk_decay = torch.exp(cs[..., -1])  # (B, nc, H)
    st = torch.zeros((b, h, hd, n), dtype=torch.float32, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(st)
        st = st * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)  # (B, nc, H, hd, N)
    decay_in = torch.exp(cs)  # (B, nc, H, Q)
    y_off = (torch.einsum("bcqn,bchpn->bcqhp", cc_, prev_states)
             * decay_in.permute(0, 1, 3, 2)[..., None])

    y = (y_diag + y_off).reshape(b, l, h, hd)
    y = y + xh.reshape(b, l, h, hd) * p["d_skip"][None, None, :, None]
    out = _out(p, cfg, y.reshape(b, l, sp.di), z, x.dtype, sp)
    if not return_cache:
        return out
    w1 = cfg.conv_width - 1
    tail = (ubc[:, -w1:] if lengths is None
            else masked_conv_tail(ubc, lengths, w1))
    return out, {"state": st, "conv": _full_tail(tail, sp)}


def init_cache(cfg: ArchConfig, batch: int, dtype, device=None) -> dict:
    """Per-slot decode state, fixed-size in the sequence (an (H, hd, N) fp32
    state and a (width-1)-deep conv tail): it stays slot-resident in the
    paged layout, where only attention KV is pooled."""
    conv_dim = cfg.d_inner + 2 * cfg.ssm_state
    return {
        "state": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim,
                              cfg.ssm_state), dtype=torch.float32,
                             device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, conv_dim),
                            dtype=dtype, device=device),
    }


def cache_bytes_per_slot(cfg: ArchConfig, dtype) -> int:
    """Device bytes one serving slot's SSM state costs (max_seq-free)."""
    conv_dim = cfg.d_inner + 2 * cfg.ssm_state
    itemsize = torch.empty((), dtype=dtype, device="meta").element_size()
    state = 4 * cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state  # fp32
    return state + (cfg.conv_width - 1) * conv_dim * itemsize


def decode(p: dict, cfg: ArchConfig, x: torch.Tensor, cache: dict,
           mesh=None, spec: dict | None = None
           ) -> tuple[torch.Tensor, dict]:
    """x: (B, 1, d) -> ((B, 1, d), new cache): the O(1) state update, the
    conv taken in fp32 against the fp32 ``conv``."""
    b = x.shape[0]
    sp = _Split(cfg, mesh)
    p = _leaves(p, cfg, spec, mesh, sp, x.dtype)
    if sp.ax is not None:
        x = coll.copy_to(x, sp.ax)
    h, hd, di = sp.h, cfg.ssm_head_dim, cfg.d_inner
    ubc, z, dt = _project(p, x)  # ubc: (B, 1, this rank's conv channels)
    tail = cache["conv"]  # (B, width-1, conv_dim): every channel
    if sp.ax is not None:
        tail = torch.cat([tail[..., sp.u0:sp.u0 + sp.di], tail[..., di:]],
                         dim=-1)
    window = torch.cat([tail, ubc], dim=1)  # (B, width, C)
    conv_out = torch.einsum("bwc,wc->bc", window.float(),
                            p["conv"].float()).to(x.dtype)[:, None]
    u, bb, cc = _split_conv_out(cfg, conv_out, sp.di)

    a = -torch.exp(p["a_log"])
    dt0 = dt[:, 0]  # (B, H)
    dec = torch.exp(dt0 * a)
    xh = u.reshape(b, h, hd).float()
    dtx = xh * dt0[..., None]
    st = cache["state"] * dec[..., None, None] + torch.einsum(
        "bhp,bn->bhpn", dtx, bb[:, 0].float())
    y = torch.einsum("bhpn,bn->bhp", st, cc[:, 0].float())
    y = y + xh * p["d_skip"][None, :, None]
    out = _out(p, cfg, y.reshape(b, 1, sp.di), z, x.dtype, sp)
    new_tail = torch.cat([cache["conv"], _full_tail(ubc, sp)], dim=1)[:, 1:]
    return out, {"state": st, "conv": new_tail}
