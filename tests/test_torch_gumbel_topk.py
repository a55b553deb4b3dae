"""Gumbel top-k without replacement in the port against the JAX package:
``gumbel.topk_fixed_b`` and ``estimators.local_gumbel_topk`` (exact and IVF
probes) fed the reference's own random numbers, drawn with its key splits;
``topk_fixed_b`` with ``num=1`` bit for bit the port's ``sample_fixed_b``
on the same draws (the reference's contract); the vacuous certificate when
S covers the support.

Tolerances: ids, counts and flags exact; fp32 values rtol=atol=1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_families import jax_draws

from repro.core import estimators as jest
from repro.core import gumbel as jgumbel
from repro.core.mips import ivf as jivf
from repro_torch.convert import ivf_state_from_jax
from repro_torch.core import estimators as est
from repro_torch.core import gumbel, mips

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.array(x))


# ------------------------------------------------------ gumbel top-k WOR
def _result_eq(got, want):
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_allclose(got.values.numpy(), np.asarray(want.values),
                               **TOL)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               **TOL)
    for f in ("ok", "m", "overflow"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))
    np.testing.assert_allclose(got.bound.numpy(), np.asarray(want.bound),
                               **TOL)


@pytest.mark.parametrize("k_live", [48, 30], ids=["full", "underfilled"])
def test_topk_fixed_b_with_jax_draws_matches_jax(k_live):
    """Per token, the JAX function under vmap against the port's batched
    one on the same draws; an underfilled probe (dead slots, sanitized ids
    >= n) included. l is small so that tail atoms collide and the
    per-position dedup is exercised."""
    r = np.random.default_rng(0)
    n, k, l, t, num = 300, 48, 40, 16, 6
    scores = (r.standard_normal((t, n)) * 2.0).astype(np.float32)
    order = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    vals = np.take_along_axis(scores, order, 1)
    ids = order.astype(np.int32)
    vals[:, k_live:] = -np.inf
    ids[:, k_live:] = n + np.arange(k - k_live)  # sanitized virtual ids
    kv = np.full((t,), k_live, np.int32)
    keys = jax.random.split(jax.random.key(4), t)
    m_cap = gumbel.default_m_cap(l)

    def one(key, tid, tv, sc, kvi):
        return jgumbel.topk_fixed_b(
            key, jgumbel.TopK(tid, tv), n,
            lambda i: sc[jnp.minimum(i, n - 1)], num=num, l=l, k_valid=kvi)

    want = jax.vmap(one)(keys, jnp.asarray(ids), jnp.asarray(vals),
                         jnp.asarray(scores), jnp.asarray(kv))
    draws = jax_draws(keys, k, l, m_cap, n, jnp.asarray(kv))
    sc = _t(scores)
    got = gumbel.topk_fixed_b(
        None, gumbel.TopK(_t(ids).long(), _t(vals)), n,
        lambda i: torch.gather(sc, 1, torch.clamp(i, max=n - 1)), num=num,
        l=l, k_valid=_t(kv).long(), draws=draws)
    _result_eq(got, want)
    assert (got.m.numpy() > 0).all()
    for row in got.ids.numpy():  # without replacement
        live = row[row >= 0]
        assert len(set(live.tolist())) == len(live)


def test_topk_fixed_b_num1_is_sample_fixed_b_bitwise():
    """num=1 reproduces the port's Algorithm-2 sampler bit for bit on the
    same draws (the reference's contract, on the port)."""
    r = np.random.default_rng(1)
    n, k, l, t = 512, 48, 64, 20
    scores = _t((r.standard_normal((t, n)) * 3.0).astype(np.float32))
    vals, ids = torch.sort(scores, dim=1, descending=True, stable=True)
    topk = gumbel.TopK(ids[:, :k], vals[:, :k])
    keys = torch.stack([torch.full((t,), 3), torch.arange(t),
                        torch.zeros(t, dtype=torch.int64)], dim=1)

    def score_fn(i):
        return torch.gather(scores, 1, torch.clamp(i, max=n - 1))

    one = gumbel.sample_fixed_b(keys, topk, n, score_fn, l=l)
    many = gumbel.topk_fixed_b(keys, topk, n, score_fn, num=4, l=l)
    assert torch.equal(many.ids[:, 0], one.index)
    assert torch.equal(many.values[:, 0], one.max_val)
    assert torch.equal(many.ok, one.ok)
    single = gumbel.topk_fixed_b(keys, topk, n, score_fn, num=1, l=l)
    assert torch.equal(single.ids[:, 0], one.index)
    assert torch.equal(single.bound, one.bound)
    assert torch.equal(single.ok, one.ok)
    assert (torch.diff(many.values, dim=1) <= 0).all()
    torch.testing.assert_close(many.scores, torch.gather(scores, 1,
                                                         many.ids))


def test_topk_fixed_b_full_s_certificate_vacuous():
    """S covers the support: the tail is empty (B = -inf), the certificate
    holds vacuously, and the kept set is the exact perturbed top-num."""
    n, num = 32, 8
    scores = _t(np.random.default_rng(5).standard_normal((1, n))
                .astype(np.float32))
    vals, ids = torch.sort(scores, dim=1, descending=True, stable=True)
    keys = torch.tensor([[7, 0, 0]])
    res = gumbel.topk_fixed_b(keys, gumbel.TopK(ids, vals), n,
                              lambda i: torch.gather(
                                  scores, 1, torch.clamp(i, max=n - 1)),
                              num=num, l=16)
    assert bool(res.ok[0])
    row = res.ids[0].tolist()
    assert min(row) >= 0 and len(set(row)) == num
    assert (torch.diff(res.values[0]) <= 0).all()


def _ivf_pair(emb):
    jcfg = jivf.IVFConfig(n_clusters=16, n_probe=4, kmeans_iters=3)
    n_c, cap, o_cap = jivf._geometry(emb.shape[0], jcfg)
    state = jax.device_get(jivf._device_build(
        jnp.asarray(emb), None, n_c=n_c, cap=cap, o_cap=o_cap,
        iters=jcfg.kmeans_iters, seed=jcfg.seed))
    return (jivf.IVFIndex(jcfg, jax.tree.map(jnp.asarray, state)),
            mips.IVFIndex(mips.IVFConfig(n_probe=4),
                          ivf_state_from_jax(state)))


@pytest.mark.parametrize("probe", ["exact", "ivf"])
def test_local_gumbel_topk_with_jax_draws_matches_jax(probe):
    r = np.random.default_rng(3)
    n, d, t, k, l, num = 512, 16, 12, 64, 48, 4
    emb = (r.standard_normal((n, d)) / np.sqrt(d)).astype(np.float32)
    h = (r.standard_normal((t, d)) * 2.0).astype(np.float32)
    jidx, pidx = _ivf_pair(emb) if probe == "ivf" else (None, None)
    keys = jax.random.split(jax.random.key(8), t)
    want = jest.local_gumbel_topk(None, jnp.asarray(emb), jnp.asarray(h),
                                  num=num, k=k, l=l, index=jidx, keys=keys)
    topk = jest.topk_probe(jnp.asarray(emb), jnp.asarray(h), k, index=jidx)
    _, kv = jest.sanitize_topk(topk, n)
    draws = jax_draws(keys, k, l, gumbel.default_m_cap(l), n, kv)
    got = est.local_gumbel_topk(_t(emb), _t(h), num=num, k=k, l=l,
                                index=pidx, draws=draws)
    _result_eq(got, want)
    with pytest.raises(ValueError, match="keys or draws"):
        est.local_gumbel_topk(_t(emb), _t(h), num=num, k=k, l=l)
