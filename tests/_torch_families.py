"""Shared helpers of the port's family decode tests
(``test_torch_families_decode.py``, ``test_torch_families_dense.py``): configs, batches, the reference's random numbers
for a head sample, cache comparison, and :func:`decode_like_jax`, which
holds prefill + three decode steps of one arch against the JAX package's
trunk and head.

Tolerances: f32 policy; hidden states and caches rtol=atol=1e-4; sampled
ids exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_smoke as jget_smoke
from repro.core import amortized_head as jah
from repro.core import estimators as jest
from repro.launch.steps import slot_keys as jslot_keys
from repro.models import transformer as jtr
from repro.models.model import Model as JModel
from repro_torch.configs import get_smoke
from repro_torch.convert import params_from_jax
from repro_torch.core import rng
from repro_torch.core.gumbel import default_m_cap
from repro_torch.models.model import Model

TOL = dict(rtol=1e-4, atol=1e-4)


def t(x):
    return torch.from_numpy(np.array(x))


def cfgs(arch, **kw):
    return jget_smoke(arch).scaled(**kw), get_smoke(arch).scaled(**kw)


def batch_for(cfg, b, l, seed=0):
    r = np.random.default_rng(seed)
    if cfg.frontend == "audio_stub":
        return {"frames": r.standard_normal((b, l, cfg.d_model)).astype(
            np.float32)}
    out = {"tokens": r.integers(0, cfg.vocab, (b, l)).astype(np.int32)}
    if cfg.frontend == "vision_stub":
        out["patches"] = r.standard_normal(
            (b, cfg.n_prefix_tokens, cfg.d_model)).astype(np.float32)
    return out


def jax_draws(keys, k, l, m_cap, n, kv):
    """The raw numbers JAX's sample_fixed_b draws from each token's key."""

    def one(key, kvi):
        k_s, k_t = jax.random.split(key)
        g_s = jax.random.gumbel(k_s, (k,), dtype=jnp.float32)
        k_m, k_pos, k_h = jax.random.split(k_t, 3)
        m = jax.random.poisson(k_m, jnp.float32(l), dtype=jnp.int32)
        hi = jnp.maximum(jnp.asarray(n, jnp.int32) - kvi, 1)
        u = jax.random.randint(k_pos, (m_cap,), 0, hi, dtype=jnp.int32)
        e = jax.random.exponential(k_h, (m_cap,), dtype=jnp.float32)
        return g_s, m, u, e

    g_s, m, u, e = jax.vmap(one)(keys, kv)
    return rng.Draws(t(g_s), t(m).long(), t(u).long(), t(e))


def draws_for(jm, jp, hq, keys):
    hc = jm.head_cfg
    emb = jm._out_embed(jp)[: hc.n].astype(jnp.float32)
    topk = jest.topk_probe(emb, hq.astype(jnp.float32), hc.k)
    _, kv = jest.sanitize_topk(topk, hc.n)
    return jax_draws(keys, hc.k, hc.l, default_m_cap(hc.l), hc.n, kv)


def decode_like_jax(arch):
    """The port's Model.prefill (with the vision prefix for paligemma) and
    three decode_steps pick the ids the reference's trunk and head pick
    (its ``Model.prefill`` / ``decode_step``, unrolled to reuse the hidden
    state for the draws) from the reference's random numbers; the caches
    agree along the way."""
    jcfg, tcfg = cfgs(arch, vocab=4096)
    jm = JModel(jcfg, precision_policy="f32")
    jp = jm.init(jax.random.key(2))
    tp = params_from_jax(jax.device_get(jp), tcfg)
    tm = Model(tcfg, "f32", device="cpu")
    emb = jm._out_embed(jp)
    b, lp, max_seq = 2, 8, 48
    batch = batch_for(tcfg, b, lp, seed=2)
    x, pos, prefix = jm._embed_inputs(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    jh, jc = jtr.apply_trunk_prefill(jp, jcfg, x, pos, max_seq=max_seq,
                                     prefix=prefix)
    # Model.prefill's head call: one key, per-token keys fold_in(key, row)
    key = jax.random.key(7)
    jnxt = jah.head_sample(emb, jh[:, -1], key, jm.head_cfg).index
    keys = jax.vmap(jax.random.fold_in, (None, 0))(
        key, jnp.arange(b, dtype=jnp.uint32))
    draws = draws_for(jm, jp, jh[:, -1], keys)
    tnxt, _, tpos, tc = tm.prefill(tp, {k: t(v) for k, v in batch.items()},
                                   None, max_seq, draws=draws)
    np.testing.assert_array_equal(tnxt.numpy(), np.asarray(jnxt))
    assert (tpos.numpy() == x.shape[1]).all()
    caches_close(tc, jc)

    ids, p = np.asarray(jnxt), np.full(b, x.shape[1], np.int32)
    rids = jnp.arange(b, dtype=jnp.int32)
    for _ in range(3):
        keys = jslot_keys(jax.random.key(9), rids, jnp.asarray(p))
        xe = jp["embed"][ids][:, None].astype(jnp.float32)
        jh, jc = jtr.apply_trunk_decode(jp, jcfg, xe, jc, jnp.asarray(p))
        jnxt = jah.head_sample(emb, jh[:, 0], None, jm.head_cfg,
                               keys=keys).index
        draws = draws_for(jm, jp, jh[:, 0], keys)
        tnxt, _, tc, _ = tm.decode_step(tp, tc, t(ids), t(p), None,
                                        draws=draws)
        np.testing.assert_array_equal(tnxt.numpy(), np.asarray(jnxt))
        caches_close(tc, jc)
        ids, p = np.asarray(jnxt), p + 1


def caches_close(tc, jc):
    jl = jax.device_get(jc)
    assert len(tc) == len(jl)
    for tg, jg in zip(tc, jl):
        assert sorted(tg) == sorted(jg)
        for j in tg:
            assert sorted(tg[j]) == sorted(jg[j])
            for name in tg[j]:
                np.testing.assert_allclose(tg[j][name].float().numpy(),
                                           np.asarray(jg[j][name],
                                                      np.float32), **TOL)
