"""Perturb-and-MAP structured inference (counterpart of
``repro/workloads/structured.py``): sequence MAP and stochastic beam search
on the amortized estimator core.

Both modes run one certificate-gated beam recursion, a Python loop over
``horizon`` steps on the trunk's prefill and decode; each expansion draws
the candidate children through the head index (any backend):

* **MAP** (``mode="map"``): beams expand through
  :func:`repro_torch.core.estimators.topk_probe`; the pooled top-W prefixes
  by total log-prob are a certified exact beam step when every live
  parent's ``num``-th candidate clears ``S_min + c`` (Def 3.1's gap bound).
* **Stochastic beam search** (``mode="sbs"``, Kool et al. 2019): Gumbel
  top-k sampling without replacement over whole sequences. Each expansion
  is one :func:`repro_torch.core.estimators.local_gumbel_topk` call; the
  children are conditioned on the parent's perturbed value by the stable
  max-shift (:func:`shift_gumbel`), so a beam of width W keeps the W
  largest conditioned perturbed prefixes, and the surviving leaves are W
  sequences sampled without replacement.

Keys: every tree node owns a key row of the counter generator
(:mod:`repro_torch.core.rng`): the root's is ``(seed, 0, 0)``, a child's
is ``rng.fold_in(parent's, token)``. A node's draws are a function of its
path, never of which beams share the batch, so the search at beam width
``|V|^horizon`` is brute-force enumeration and the width-W search returns
its top W leaves. (The reference folds tokens into threefry keys; the
property is the same, the streams differ.) The amortized per-step log Z
of a beam is keyed by ``fold_in(its key, vocab + 1)``, its own, where the
reference draws every beam's tail from beam 0's key.

Each step reorders every cache leaf along its batch axis by ``parent`` and
reads nothing back to the host. A beam's ``exact`` flag is the AND along
its path of its parent expansion's certificate (Algorithm 2's, or the MAP
gap certificate) and every live parent's certificate at each pooled step;
with ``logz="amortized"`` the flags are conditional on the Algorithm-3
estimate of the per-step log Z.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.core import estimators as est
from repro_torch.core import rng
from repro_torch.core.mips.base import top_k
from repro_torch.models import transformer

__all__ = [
    "BeamConfig",
    "Beams",
    "shift_gumbel",
    "root_key",
    "make_search_fn",
    "search",
]


@dataclasses.dataclass(frozen=True)
class BeamConfig:
    n_beams: int = 4
    horizon: int = 8
    expand_k: int = 64  # probe width per expansion (candidate pool size)
    l: int = 64  # lazy-Gumbel tail atom rate per expansion (sbs)
    c: float = 0.0  # MIPS gap slack (Def 3.1) for the certificates
    mode: str = "sbs"  # "sbs" | "map"
    logz: str = "exact"  # "exact" | "amortized" per-step log Z
    logz_l: int = 64  # tail draws for the amortized log Z


class Beams(NamedTuple):
    tokens: torch.Tensor  # (W, horizon) int64 generated tokens, best first
    logp: torch.Tensor  # (W,) f32 sequence log-prob (given the log Z path)
    gumbel: torch.Tensor  # (W,) f32 conditioned perturbed log-prob (sbs;
    #   == logp for map)
    exact: torch.Tensor  # (W,) bool certificate-gated exactness flags
    live: torch.Tensor  # (W,) bool — False: fewer than W sequences exist
    ok_rate: torch.Tensor  # () f32 share of expansion certificates passed


def shift_gumbel(g_parent: torch.Tensor, z: torch.Tensor,
                 g_tilde: torch.Tensor) -> torch.Tensor:
    """Condition the children's perturbed values so that their max equals
    the parent's (Kool et al. 2019, eq. 11, stable form): ``G = -log(
    exp(-g_parent) - exp(-z) + exp(-g_tilde))`` with ``z = max g_tilde``,
    through a softplus, so the argmax child maps exactly to ``g_parent``
    and -inf children stay -inf."""
    v = g_parent - g_tilde + torch.log1p(
        -torch.exp(torch.clamp(g_tilde - z, max=0.0)))
    return (g_parent - torch.clamp(v, min=0.0)
            - torch.log1p(torch.exp(-torch.abs(v))))


def _certificate_map(values: torch.Tensor, num: int, c: float
                     ) -> torch.Tensor:
    """MAP gap certificate per beam: the kept top-``num`` is provably exact
    iff the num-th value clears ``S_min + c``. ``values`` (W, k) descending
    probe values."""
    vals = values.float()
    s_min = torch.where(torch.isneginf(vals),
                        torch.full_like(vals, math.inf), vals).amin(dim=1)
    return vals[:, num - 1] >= s_min + c


def _reorder(cache: list, parent: torch.Tensor) -> None:
    """Every cache leaf (layers, W, ...) reordered by ``parent`` along its
    batch axis, in place."""
    for group in cache:
        for layer in group.values():
            for leaf in layer.values():
                leaf.copy_(leaf[:, parent])


def root_key(seed: int, device=None) -> torch.Tensor:
    """The root node's key row ``(seed, 0, 0)``."""
    return torch.tensor([seed, 0, 0], dtype=torch.int64, device=device)


def make_search_fn(model, bcfg: BeamConfig, prompt_len: int):
    """The beam search ``fn(params, prompt (P,) ints, key, index=None) ->
    Beams`` for this model, config and prompt length; ``key`` is the root
    key row (:func:`root_key`) or an int seed."""
    cfg = model.cfg
    w = bcfg.n_beams
    vocab = cfg.vocab
    kk = min(bcfg.expand_k, vocab)
    num = min(w, kk)
    # pooled top-W completeness holds statically only when each parent
    # contributes its full top-W (num == w) or all its children
    exact_static = (num == w) or (num >= vocab)
    max_seq = prompt_len + bcfg.horizon + 1
    p_len = prompt_len
    if bcfg.mode not in ("sbs", "map"):
        raise ValueError(f"unknown beam mode {bcfg.mode!r}")
    if bcfg.logz not in ("exact", "amortized"):
        raise ValueError(f"unknown log Z mode {bcfg.logz!r}")

    @torch.no_grad()
    def run(params, prompt, key, index=None) -> Beams:
        dev = model.device
        if not isinstance(key, torch.Tensor):
            key = root_key(int(key), dev)
        emb = model._out_embed(params)[:vocab].float()
        trunk = model.compute_params(params)
        prompt = torch.as_tensor(prompt, device=dev).long()
        x = params["embed"][prompt][None].expand(w, p_len, -1)
        x = x.to(model.compute_dtype)
        pos = torch.arange(p_len, device=dev)[None].expand(w, p_len)
        h, cache = transformer.apply_trunk_prefill(trunk, cfg, x, pos,
                                                   max_seq=max_seq)
        hq = h[:, -1].float()  # (W, d)

        def logz_fn(hh, nkeys):
            if bcfg.logz == "exact":
                return est.exact_logz(emb, hh)
            zkeys = rng.fold_in(nkeys, torch.full_like(nkeys[:, 0],
                                                       vocab + 1))
            topk = est.topk_probe(emb, hh, kk, index=index)
            ids, log_w = est.amortized_candidates(topk, vocab, bcfg.logz_l,
                                                  keys=zkeys)
            return est.stratified_logz(emb, hh, ids, log_w)

        live = torch.arange(w, device=dev) == 0  # one root: beam 0 is real
        neg = torch.full((w,), -math.inf, device=dev)
        logp = torch.where(live, torch.zeros_like(neg), neg)
        g_cond = logp.clone()  # the root's perturbed value := 0
        exact = torch.ones((w,), dtype=torch.bool, device=dev)
        toks = torch.zeros((w, bcfg.horizon), dtype=torch.int64, device=dev)
        nkeys = key.long().to(dev)[None].expand(w, 3)
        okc = torch.zeros((), dtype=torch.int64, device=dev)
        expc = torch.zeros((), dtype=torch.int64, device=dev)
        for t in range(bcfg.horizon):
            base = logp - logz_fn(hq, nkeys)  # per-parent additive constant
            if bcfg.mode == "sbs":
                res = est.local_gumbel_topk(emb, hq, num=num, k=kk, l=bcfg.l,
                                            index=index, c=bcfg.c, keys=nkeys)
                cand_ids = res.ids  # (W, num)
                phi = base[:, None] + res.scores
                g_tilde = base[:, None] + res.values
                z = g_tilde.amax(dim=1, keepdim=True)
                metric = shift_gumbel(g_cond[:, None], z, g_tilde)
                ok_b = res.ok
            else:  # map
                tk = est.topk_probe(emb, hq, kk, index=index)
                cand_ids = tk.ids[:, :num].long()
                phi = base[:, None] + tk.values[:, :num]
                metric = phi
                ok_b = _certificate_map(tk.values, num, bcfg.c)
            msk = live[:, None] & (cand_ids >= 0)
            pool = torch.where(msk, metric, torch.full_like(metric,
                                                            -math.inf))
            top_v, top_i = top_k(pool.reshape(-1), w)
            parent = top_i // num
            new_live = ~torch.isneginf(top_v)
            token = torch.where(new_live, cand_ids.reshape(-1)[top_i],
                                torch.zeros_like(top_i))
            all_ok = (ok_b | ~live).all()
            exact = exact[parent] & all_ok & new_live & exact_static
            logp = torch.where(new_live, phi.reshape(-1)[top_i], neg)
            g_cond = torch.where(new_live, top_v, neg)
            toks = toks[parent]
            toks[:, t] = token
            _reorder(cache, parent)
            nkeys = rng.fold_in(nkeys[parent], token)
            okc = okc + (ok_b & live).sum()
            expc = expc + live.sum()
            live = new_live
            xt = params["embed"][token][:, None].to(model.compute_dtype)
            hh, cache = transformer.apply_trunk_decode(
                trunk, cfg, xt, cache,
                torch.full((w,), p_len + t, dtype=torch.int64, device=dev))
            hq = hh[:, 0].float()
        return Beams(tokens=toks, logp=logp,
                     gumbel=g_cond if bcfg.mode == "sbs" else logp,
                     exact=exact & live, live=live,
                     ok_rate=okc.float() / torch.clamp(expc, min=1).float())

    return run


def search(model, params, prompt, key, bcfg: BeamConfig, index: Any = None
           ) -> Beams:
    """One beam search of ``prompt`` ((P,) token ids) from the root ``key``
    (an int seed or a key row)."""
    fn = make_search_fn(model, bcfg, int(len(prompt)))
    return fn(params, prompt, key, index)

