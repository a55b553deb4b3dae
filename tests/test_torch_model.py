"""The port's trunk and model against the JAX package, on the same weights
(carried across with ``repro_torch.convert``), under the f32 policy at the
smoke tinyllama width with vocab 4096 (below 4096 the head silently falls
back to the exact sampler).

Tolerances: hidden states and KV caches fp32 rtol=atol=1e-4 (two layers of
matmuls reduced in different orders by XLA-CPU and PyTorch); sampled ids
exact, with the reference's own random numbers injected as ``draws``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.core import estimators as jest
from repro.launch.steps import slot_keys as jslot_keys
from repro.models import layers as jlayers
from repro.models import transformer as jtr
from repro.models.model import Model as JModel
from repro_torch.configs import get_smoke
from repro_torch.convert import ivf_state_from_jax, params_from_jax, tree_from_numpy
from repro_torch.core import rng
from repro_torch.core.gumbel import default_m_cap
from repro_torch.core.mips import IVFConfig, IVFIndex
from repro_torch.models import layers, transformer
from repro_torch.models.model import Model

# one intra-op thread: the suite runs six workers on the same cores, and
# torch's default thread pool per worker oversubscribes them
torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "tinyllama-1.1b"


def _t(x):
    return torch.from_numpy(np.array(x))


def _cfgs(**kw):
    return (jget_smoke(ARCH).scaled(vocab=4096, **kw),
            get_smoke(ARCH).scaled(vocab=4096, **kw))


def _params(jcfg, tcfg, seed=0):
    jp = JModel(jcfg, precision_policy="f32").init(jax.random.key(seed))
    return jp, params_from_jax(jax.device_get(jp), tcfg)


# ------------------------------------------------------------------ layers
def test_layers_match_jax():
    r = np.random.default_rng(0)
    x = r.standard_normal((2, 5, 4, 16)).astype(np.float32)
    scale = r.standard_normal(16).astype(np.float32)
    pos = np.tile(np.arange(5), (2, 1)).astype(np.int32) + 3
    np.testing.assert_allclose(
        layers.rms_norm(_t(x), _t(scale), 1e-6).numpy(),
        np.asarray(jlayers.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6)),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        layers.rope(_t(x), _t(pos), 10000.0).numpy(),
        np.asarray(jlayers.rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)),
        rtol=1e-5, atol=1e-5)
    h = r.standard_normal((3, 8)).astype(np.float32)
    w1, w3 = (r.standard_normal((8, 12)).astype(np.float32) for _ in range(2))
    w2 = r.standard_normal((12, 8)).astype(np.float32)
    np.testing.assert_allclose(
        layers.swiglu(*map(_t, (h, w1, w2, w3))).numpy(),
        np.asarray(jlayers.swiglu(*map(jnp.asarray, (h, w1, w2, w3)))),
        rtol=1e-5, atol=1e-5)


def test_params_from_jax_round_trip_and_structure():
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, tcfg)
    flat_j = jax.tree_util.tree_leaves_with_path(jax.device_get(jp))
    for path, leaf in flat_j:
        node = tp
        for p in path:
            node = node[getattr(p, "key", getattr(p, "idx", None))]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    # the port's own init has the reference's structure and shapes
    own = transformer.init_params(torch.Generator().manual_seed(0), tcfg)
    shapes = jax.tree.map(lambda a: tuple(a.shape), jax.device_get(jp))
    assert shapes == jax.tree.map(lambda a: tuple(a.shape), own,
                                  is_leaf=lambda a: isinstance(a, torch.Tensor))


def test_trunk_prefill_and_decode_match_jax():
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, tcfg, seed=1)
    r = np.random.default_rng(1)
    b, lp, max_seq = 3, 8, 16
    tokens = r.integers(0, 4096, (b, lp)).astype(np.int32)
    lengths = np.asarray([3, 8, 5], np.int32)
    x = np.asarray(jp["embed"])[tokens]
    pos = np.tile(np.arange(lp), (b, 1)).astype(np.int32)
    jh, jc = jtr.apply_trunk_prefill(jp, jcfg, jnp.asarray(x), pos,
                                     max_seq=max_seq,
                                     lengths=jnp.asarray(lengths))
    th, tc = transformer.apply_trunk_prefill(tp, tcfg, _t(x), _t(pos),
                                             max_seq=max_seq,
                                             lengths=_t(lengths))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[0]["0"][name].numpy(),
                                   np.asarray(jc[0]["0"][name]), **TOL)
    step_pos = lengths.copy()
    for step in range(3):
        ids = r.integers(0, 4096, (b,)).astype(np.int32)
        xe = np.asarray(jp["embed"])[ids][:, None]
        jh, jc = jtr.apply_trunk_decode(jp, jcfg, jnp.asarray(xe), jc,
                                        jnp.asarray(step_pos))
        th, tc = transformer.apply_trunk_decode(tp, tcfg, _t(xe), tc,
                                                _t(step_pos))
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
        for name in ("k", "v"):
            np.testing.assert_allclose(tc[0]["0"][name].numpy(),
                                       np.asarray(jc[0]["0"][name]), **TOL)
        step_pos += 1


def _jax_draws(keys, k, l, m_cap, n, kv):
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
    return rng.Draws(_t(g_s), _t(m).long(), _t(u).long(), _t(e))


def _draws_for(jmodel, jp, hq, index, keys):
    """Draws for the head sample at hidden states ``hq`` — the live slot
    count k_valid of each token's probe sets the complement's size."""
    hc = jmodel.head_cfg
    emb = jp["out_embed"][: hc.n].astype(jnp.float32)
    topk = jest.topk_probe(emb, hq.astype(jnp.float32), hc.k, index=index)
    _, kv = jest.sanitize_topk(topk, hc.n)
    return _jax_draws(keys, hc.k, hc.l, default_m_cap(hc.l), hc.n, kv)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_prefill_and_decode_step_sample_like_jax(fused):
    """Same weights, same IVF index state, the reference's random numbers:
    the port's prefill_into_cache and decode_step pick the ids JAX picks.
    JAX runs its unfused XLA head (its fused Pallas family does not trace
    on the installed jax); the port runs both of its head paths."""
    jcfg, tcfg = _cfgs(head_mips="ivf")
    jmodel = JModel(jcfg, precision_policy="f32")
    jp = jmodel.init(jax.random.key(2))
    tp = params_from_jax(jax.device_get(jp), tcfg)
    jindex = jmodel.make_head_index(jp)
    tmodel = Model(tcfg.scaled(head_fused_decode=fused), "f32", device="cpu")
    hc = tmodel.head_cfg
    tindex = IVFIndex(IVFConfig(n_probe=hc.n_probe),
                      ivf_state_from_jax(jax.device_get(jindex.state)))
    base = jax.random.key(9)
    r = np.random.default_rng(2)
    nslots, lp, max_seq = 3, 8, 32
    tokens = r.integers(0, 4096, (nslots, lp)).astype(np.int32)
    lengths = np.asarray([5, 8, 3], np.int32)
    slots = np.asarray([2, 0, 1], np.int32)
    rids = np.asarray([4, 7, 1], np.int32)

    jcache = jmodel.init_cache(nslots, max_seq)
    keys = jslot_keys(base, jnp.asarray(rids), jnp.asarray(lengths - 1))
    jnxt, _, jcache = jmodel.prefill_into_cache(
        jp, jcache, jnp.asarray(tokens), jnp.asarray(lengths),
        jnp.asarray(slots), keys, max_seq, index=jindex)
    x = jp["embed"][tokens].astype(jnp.float32)
    pos = jnp.broadcast_to(jnp.arange(lp), (nslots, lp))
    jh, _ = jtr.apply_trunk_prefill(jp, jcfg, x, pos, max_seq=max_seq,
                                    lengths=jnp.asarray(lengths))
    hq = jh[jnp.arange(nslots), lengths - 1]
    draws = _draws_for(jmodel, jp, hq, jindex, keys)
    tcache = tmodel.init_cache(nslots, max_seq)
    tnxt, _, tcache = tmodel.prefill_into_cache(
        tp, tcache, _t(tokens), _t(lengths), _t(slots), None, max_seq,
        tindex, draws=draws)
    np.testing.assert_array_equal(tnxt.numpy(), np.asarray(jnxt))
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[0]["0"][name].numpy(),
                                   np.asarray(jcache[0]["0"][name]), **TOL)

    # one decode step from the slots' state
    ids = np.zeros(nslots, np.int32)
    ids[slots] = np.asarray(jnxt)
    dpos = np.zeros(nslots, np.int32)
    dpos[slots] = lengths
    drid = np.zeros(nslots, np.int32)
    drid[slots] = rids
    keys = jslot_keys(base, jnp.asarray(drid), jnp.asarray(dpos))
    jnxt2, _, _, _ = jmodel.decode_step(jp, jcache, jnp.asarray(ids),
                                        jnp.asarray(dpos), None, index=jindex,
                                        keys=keys)
    xe = jp["embed"][ids][:, None].astype(jnp.float32)
    jh2, _ = jtr.apply_trunk_decode(jp, jcfg, xe, jcache, jnp.asarray(dpos))
    draws = _draws_for(jmodel, jp, jh2[:, 0], jindex, keys)
    tnxt2, _, _, _ = tmodel.decode_step(tp, tcache, _t(ids), _t(dpos), tindex,
                                     draws=draws)
    np.testing.assert_array_equal(tnxt2.numpy(), np.asarray(jnxt2))


def test_tree_from_numpy_keeps_structure():
    tree = {"a": [np.ones(2), None], "b": (np.zeros((1, 3)),)}
    out = tree_from_numpy(tree)
    assert out["a"][1] is None and out["b"][0].shape == (1, 3)
