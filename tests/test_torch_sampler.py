"""The port's sampler against the JAX package: the complement map and the
certificate exactly; Algorithm 2 (unfused ``sample_fixed_b`` and the fused
``_fused_tail_argmax`` finish) fed the reference's own random numbers,
drawn with JAX's key splits (``gumbel.py:259-260``, ``gumbel.py:127-135``,
``complement.py:53``, ``estimators.py:550-557``); the port's own
counter-based RNG by chi-square goodness of fit against the exact softmax,
as tests/test_sampling_stats.py does for the reference.

Tolerances: indices, counts and flags exact; max_val / bound fp32
rtol=atol=1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from repro.core import complement as jcomplement
from repro.core import estimators as jest
from repro.core import gumbel as jgumbel
from repro_torch.core import complement, estimators, gumbel, rng
from repro_torch.launch.steps import slot_keys

# one intra-op thread: the suite runs six workers on the same cores, and
# torch's default thread pool per worker oversubscribes them
torch.set_num_threads(1)

ALPHA = 1e-3  # per-assertion significance, as tests/test_sampling_stats.py
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.array(x))


# -------------------------------------------------------------- complement
def test_complement_map_matches_jax():
    r = np.random.default_rng(0)
    n, k = 500, 40
    s = np.sort(r.choice(n, k, replace=False)).astype(np.int32)
    u = r.integers(0, n - k, (7, 30)).astype(np.int32)
    want = np.asarray(jcomplement.complement_map(u, s))
    got = complement.complement_map(_t(u), _t(s))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not np.isin(want, s).any()


def test_complement_map_batched_rows():
    """One excluded set per row: each row equals the 1-D map of its set."""
    r = np.random.default_rng(1)
    n, k, t = 300, 20, 5
    s = np.stack([np.sort(r.choice(n, k, replace=False))
                  for _ in range(t)]).astype(np.int64)
    u = r.integers(0, n - k, (t, 50)).astype(np.int64)
    got = complement.complement_map(_t(u), _t(s))
    for i in range(t):
        want = np.asarray(jcomplement.complement_map(u[i].astype(np.int32),
                                                     s[i].astype(np.int32)))
        np.testing.assert_array_equal(got[i].numpy(), want)


# ------------------------------------------------------------- certificate
def test_certificate_matches_jax():
    r = np.random.default_rng(2)
    t, k = 9, 12
    vals = r.standard_normal((t, k)).astype(np.float32)
    vals[r.random((t, k)) < 0.3] = -np.inf
    vals[0] = -np.inf  # all dead: +inf bound, never ok
    b = r.standard_normal(t).astype(np.float32)
    b[1] = -np.inf
    vals[2] = -np.inf
    b[2] = -np.inf  # zero-row shard: bound -inf, not NaN
    max_val = r.standard_normal(t).astype(np.float32) + 1.0
    overflow = r.random(t) < 0.2
    c = 0.25
    want_ok, want_b = jax.vmap(
        lambda v, bb, mv, ov: jgumbel.certificate(v, bb, c, mv, ov)
    )(vals, b, max_val, overflow)
    ok, bound = gumbel.certificate(_t(vals), _t(b), c, _t(max_val),
                                   _t(overflow))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(want_ok))
    np.testing.assert_array_equal(bound.numpy(), np.asarray(want_b))


# ------------------------------------------------- Algorithm 2, JAX draws
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


@pytest.mark.parametrize("n_valid", [None, 300, 50],
                         ids=["full", "padded_vocab", "underfilled"])
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_local_gumbel_max_with_jax_draws_matches_jax(n_valid, fused):
    r = np.random.default_rng(3)
    n, d, t, k, l = 512, 16, 24, 64, 64
    emb = (r.standard_normal((n, d)) / np.sqrt(d)).astype(np.float32)
    h = (r.standard_normal((t, d)) * 2.0).astype(np.float32)
    keys = jax.random.split(jax.random.key(11), t)
    m_cap = gumbel.default_m_cap(l)
    want = jest.local_gumbel_max(None, jnp.asarray(emb), jnp.asarray(h), k=k,
                                 l=l, keys=keys, n_valid=n_valid)
    nv = n if n_valid is None else n_valid
    topk = jest.topk_probe(jnp.asarray(emb), jnp.asarray(h), k,
                           n_valid=n_valid)
    _, kv = jest.sanitize_topk(topk, nv)
    draws = _jax_draws(keys, k, l, m_cap, nv, kv)
    got = estimators.local_gumbel_max(_t(emb), _t(h), k=k, l=l,
                                      n_valid=n_valid, draws=draws,
                                      fused=fused)
    np.testing.assert_array_equal(got.index.numpy(), np.asarray(want.index))
    np.testing.assert_array_equal(got.m.numpy(), np.asarray(want.m))
    np.testing.assert_array_equal(got.overflow.numpy(),
                                  np.asarray(want.overflow))
    np.testing.assert_array_equal(got.ok.numpy(), np.asarray(want.ok))
    np.testing.assert_allclose(got.max_val.numpy(), np.asarray(want.max_val),
                               **TOL)
    np.testing.assert_allclose(got.bound.numpy(), np.asarray(want.bound),
                               **TOL)


def test_sample_fixed_b_overflow_flag():
    """A Poisson count past m_cap flags overflow and never certifies."""
    t, k, m_cap, n = 3, 4, 6, 100
    ids = torch.arange(k).repeat(t, 1)
    vals = torch.zeros(t, k)
    draws = rng.Draws(torch.zeros(t, k), torch.tensor([2, 6, 7]),
                      torch.zeros(t, m_cap, dtype=torch.long),
                      torch.ones(t, m_cap))
    res = gumbel.sample_fixed_b(None, gumbel.TopK(ids, vals), n,
                                lambda p: torch.full(p.shape, 50.0), l=4,
                                m_cap=m_cap, draws=draws)
    assert res.m.tolist() == [2, 6, 6]
    assert res.overflow.tolist() == [False, False, True]
    assert res.ok.tolist() == [True, True, False]
    assert (res.index >= k).all()  # the tail (score 50) wins every token


# --------------------------------------------------------- the port's RNG
def test_philox_known_answers():
    """Random123's Philox-4x32-10 known-answer vectors."""
    got = rng.philox4x32(0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344,
                         0xa4093822, 0x299f31d0)
    assert [int(x) for x in got] == [0xd16cfe09, 0x94fdcceb, 0x5001e420,
                                     0x24126ea1]
    got = rng.philox4x32(*(torch.tensor([0, 0xFFFFFFFF]),) * 6)
    assert [int(x[1]) for x in got] == [0x408f276d, 0x41c83b0e, 0xa20bc7c6,
                                        0x6d5451fd]
    assert [int(x[0]) for x in got] == [0x6627e8d5, 0xe169c58d, 0xbc57ac4c,
                                        0x9b00dbd8]


def test_rng_draw_ranges_and_moments():
    keys = slot_keys(7, torch.arange(4000), torch.zeros(4000))
    hi = torch.tensor([1, 3, 1000, 2 ** 31 - 1]).repeat(1000)
    u = rng.uniform_int(keys, 5, hi, rng.STREAM_COMPLEMENT)
    assert (u >= 0).all() and (u < hi[:, None]).all()
    assert (u[hi == 1] == 0).all()
    m = rng.poisson_count(keys, 64.0, 200, rng.STREAM_POISSON)
    assert abs(m.double().mean().item() - 64.0) < 0.5  # sd of mean 0.13
    assert (rng.poisson_count(keys[:10], 500.0, 200, rng.STREAM_POISSON)
            == 201).all()  # capped count = m_cap + 1 marks the overflow
    e = rng.exponential(keys, 3, rng.STREAM_HEIGHTS)
    assert (e > 0).all() and abs(e.mean().item() - 1.0) < 0.02
    g = rng.gumbel(keys, 3, rng.STREAM_GUMBEL_S)
    assert abs(g.double().mean().item() - 0.5772) < 0.03  # Euler–Mascheroni


def test_slot_keys_make_draws_batch_and_window_invariant():
    """A token's draws depend on (seed, request id, position) only: the
    same row drawn alone, inside a batch, or as one step of a longer window
    (positions listed one after another) gives the same numbers."""
    rids = torch.tensor([5, 9, 2, 7])
    pos = torch.tensor([3, 0, 11, 4])
    hi = torch.tensor([100, 50, 3000, 7])
    batch = rng.tail_draws(slot_keys(1, rids, pos), k=8, m_cap=10, hi=hi,
                           lam=4.0)
    for i in range(4):
        one = rng.tail_draws(slot_keys(1, rids[i:i + 1], pos[i:i + 1]), k=8,
                             m_cap=10, hi=hi[i:i + 1], lam=4.0)
        for a, b in zip(batch, one):
            assert torch.equal(a[i], b[0])
    # a window of T steps for request 5 = T single steps
    steps = torch.arange(3, 7)
    window = rng.gumbel(slot_keys(1, torch.full((4,), 5), steps), 8, 0)
    for j, p in enumerate(steps):
        single = rng.gumbel(slot_keys(1, torch.tensor([5]), p[None]), 8, 0)
        assert torch.equal(window[j], single[0])
    other_seed = rng.tail_draws(slot_keys(2, rids, pos), k=8, m_cap=10,
                                hi=hi, lam=4.0)
    assert not torch.equal(batch.g_s, other_seed.g_s)


# ------------------------------------------------------------- chi-square
def _softmax_np(y):
    y = np.asarray(y, np.float64)
    p = np.exp(y - y.max())
    return p / p.sum()


def _chi2_pvalue(counts: np.ndarray, p: np.ndarray) -> float:
    """Chi-square GOF p-value with the tail merged so every expected count
    is >= 5 (tests/test_sampling_stats.py)."""
    n = counts.sum()
    order = np.argsort(p)[::-1]
    counts, p = counts[order], p[order]
    exp = n * p
    keep = np.where(exp >= 5)[0]
    cut = len(keep) if len(keep) == len(exp) else max(1, keep[-1] + 1)
    obs = np.concatenate([counts[:cut], [counts[cut:].sum()]])
    ex = np.concatenate([exp[:cut], [exp[cut:].sum()]])
    obs, ex = obs[ex > 0], ex[ex > 0]
    stat = ((obs - ex) ** 2 / ex).sum()
    return float(stats.chi2.sf(stat, df=len(ex) - 1))


@pytest.mark.parametrize("seed", (0, 1, 2))
@pytest.mark.parametrize("sampler", ["lazy", "dense"])
def test_port_sampler_matches_softmax(sampler, seed):
    """The port's RNG-driven samplers against the exact softmax: k=l=96 at
    n=512 puts the lazy sampler within TV 1e-4 of softmax (k·l >= n
    ln(1/δ), δ=1e-4), and virtually every draw certifies."""
    n, d, k, l, draws = 512, 16, 96, 96, 10_000
    r = np.random.default_rng(seed)
    emb = torch.from_numpy((r.standard_normal((n, d)) / np.sqrt(d))
                           .astype(np.float32))
    h = torch.from_numpy(r.standard_normal(d).astype(np.float32))
    p = _softmax_np((emb @ h).numpy())
    ids, oks = [], []
    for c in range(draws // 2500):
        rids = torch.arange(c * 2500, (c + 1) * 2500)
        keys = slot_keys(seed + 200, rids, torch.zeros_like(rids))
        hh = h[None].expand(2500, d)
        if sampler == "lazy":
            res = estimators.local_gumbel_max(emb, hh, k=k, l=l, keys=keys)
            ids.append(res.index.numpy())
            oks.append(res.ok.numpy())
        else:
            idx, _ = estimators.dense_gumbel_max(emb, hh, keys=keys)
            ids.append(idx.numpy())
    if oks:
        assert np.concatenate(oks).mean() > 0.999
    pv = _chi2_pvalue(np.bincount(np.concatenate(ids), minlength=n), p)
    assert pv > ALPHA, f"{sampler} sampler deviates from softmax: p={pv:.2e}"
