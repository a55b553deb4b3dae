"""The port's Algorithms 3 and 4 (``core/partition.py``,
``core/expectation.py``) against the JAX package, fed the reference's own
tail draw: ``u`` recomputed with ``jax.random.randint`` on the key the
reference's ``sample_complement`` takes (``partition.py:50``,
``expectation.py:61``, ``complement.py:53``). Then the estimators on the
port's own keys: unbiasedness and Theorem 3.4's concentration, as
tests/test_partition.py holds the reference; Algorithm 4 with f = φ
against autograd's gradient of log Ẑ; and the Algorithm-3 interval
calibration and shrinking bias of tests/test_estimator_stats.py for the
exact and IVF probes (LSH is not in the port yet).

Tolerances: ids exact; log Ẑ, tail values and expectations fp32 rtol=1e-5
(atol=1e-6 for values near 0); the gradient identity rtol=2e-4,
atol=2e-5, as tests/test_partition.py.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import expectation as jexpectation
from repro.core import partition as jpartition
from repro.core.gumbel import TopK as JTopK
from repro_torch.core import estimators, mips
from repro_torch.core.expectation import (expectation_estimate,
                                          stratified_softmax)
from repro_torch.core.gumbel import TopK
from repro_torch.core.mips import base
from repro_torch.core.partition import (partition_estimate,
                                        stratified_logsumexp)
from repro_torch.launch.steps import slot_keys

# one intra-op thread: the suite runs six workers on the same cores
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)


def _t(x):
    return torch.from_numpy(np.array(x))


def _score_fn(emb: torch.Tensor, theta: torch.Tensor):
    return lambda ids: torch.einsum("tmd,td->tm", emb[ids], theta)


def _problem(n, d, t, k, seed, scale=3.0):
    """(emb (n, d), thetas (t, d), exact top-k (t, k)) as tensors."""
    r = np.random.default_rng(seed)
    emb = _t((r.standard_normal((n, d)) / math.sqrt(d)).astype(np.float32))
    theta = _t((r.standard_normal((t, d)) * scale).astype(np.float32))
    vals, ids = base.top_k(theta @ emb.T, k)
    return emb, theta, TopK(ids, vals)


def _jax_u(keys, n, k, l):
    """The uniforms the reference's sample_complement draws from each key."""
    return _t(jax.vmap(lambda key: jax.random.randint(
        key, (l,), 0, max(n - k, 1), dtype=jnp.int32))(keys)).long()


# ------------------------------------------------------- log-space sums
def test_stratified_sums_match_jax():
    r = np.random.default_rng(0)
    y_s = (r.standard_normal((5, 7)) * 4).astype(np.float32)
    y_t = (r.standard_normal((5, 9)) * 4).astype(np.float32)
    y_s[1, :3] = -np.inf  # dead S slots
    lw = np.float32(2.5)
    for log_w_tail in (lw, np.linspace(-1, 3, 5).astype(np.float32)):
        def ref_one(a, b, w):
            return (jpartition.stratified_logsumexp(a, b, w),
                    *jexpectation.stratified_softmax(a, b, w))
        w = np.broadcast_to(log_w_tail, (5,))
        want_lz, want_p, want_lz2 = jax.vmap(ref_one)(
            jnp.asarray(y_s), jnp.asarray(y_t), jnp.asarray(w))
        got_w = (float(log_w_tail) if np.ndim(log_w_tail) == 0
                 else _t(log_w_tail))
        np.testing.assert_allclose(
            stratified_logsumexp(_t(y_s), _t(y_t), got_w).numpy(),
            np.asarray(want_lz), **TOL)
        p, lz = stratified_softmax(_t(y_s), _t(y_t), got_w)
        np.testing.assert_allclose(p.numpy(), np.asarray(want_p), **TOL)
        np.testing.assert_allclose(lz.numpy(), np.asarray(want_lz2), **TOL)
        np.testing.assert_allclose(p.sum(-1).numpy(), 1.0, rtol=1e-6)


# --------------------------------------------- Algorithms 3, 4, JAX draws
@pytest.mark.parametrize("scale", [0.5, 3.0])
def test_partition_estimate_with_jax_draws_matches_jax(scale):
    n, d, t, k, l = 1500, 16, 24, 96, 80
    emb, theta, topk = _problem(n, d, t, k, seed=1, scale=scale)
    keys = jax.random.split(jax.random.key(3), t)
    jemb = jnp.asarray(emb.numpy())

    def ref_one(key, th, i, v):
        return jpartition.partition_estimate(
            key, JTopK(i, v), n, lambda x: jemb[x] @ th, l=l)

    want = jax.vmap(ref_one)(keys, jnp.asarray(theta.numpy()),
                             jnp.asarray(topk.ids.int().numpy()),
                             jnp.asarray(topk.values.numpy()))
    got = partition_estimate(None, topk, n, _score_fn(emb, theta), l=l,
                             u=_jax_u(keys, n, k, l))
    np.testing.assert_array_equal(got.tail_ids.numpy(),
                                  np.asarray(want.tail_ids))
    np.testing.assert_allclose(got.tail_values.numpy(),
                               np.asarray(want.tail_values), **TOL)
    np.testing.assert_allclose(got.log_z.numpy(), np.asarray(want.log_z),
                               **TOL)


@pytest.mark.parametrize("f", ["features", "bounded_scalar"])
def test_expectation_estimate_with_jax_draws_matches_jax(f):
    n, d, t, k, l = 1500, 16, 24, 96, 80
    emb, theta, topk = _problem(n, d, t, k, seed=2)
    keys = jax.random.split(jax.random.key(4), t)
    jemb = jnp.asarray(emb.numpy())
    fvec = np.tanh(np.arange(n, dtype=np.float32) / n * 4 - 2)
    jf = jnp.asarray(fvec)
    j_f_fn = (lambda x: jemb[x]) if f == "features" else (lambda x: jf[x])
    f_fn = ((lambda ids: emb[ids]) if f == "features"
            else (lambda ids: _t(fvec)[ids]))

    def ref_one(key, th, i, v):
        return jexpectation.expectation_estimate(
            key, JTopK(i, v), n, lambda x: jemb[x] @ th, j_f_fn, l=l)

    want = jax.vmap(ref_one)(keys, jnp.asarray(theta.numpy()),
                             jnp.asarray(topk.ids.int().numpy()),
                             jnp.asarray(topk.values.numpy()))
    u = _jax_u(keys, n, k, l)
    got = expectation_estimate(None, topk, n, _score_fn(emb, theta), f_fn,
                               l=l, u=u)
    np.testing.assert_allclose(got.value.numpy(), np.asarray(want.value),
                               **TOL)
    np.testing.assert_allclose(got.log_z.numpy(), np.asarray(want.log_z),
                               **TOL)
    # the same draws give Algorithm 3's log Ẑ
    pe = partition_estimate(None, topk, n, _score_fn(emb, theta), l=l, u=u)
    assert torch.equal(pe.log_z, got.log_z)


def test_dead_s_slots_weigh_nothing_and_exclude_nothing():
    """An underfilled probe (dead slots at -inf, id -1) estimates as the
    live slots alone would, with the tail over n - live count."""
    n, d, k, l = 400, 8, 32, 48
    emb, theta, topk = _problem(n, d, 2, k, seed=6)
    dead = topk.values.clone()
    dead[:, 20:] = -math.inf
    ids = torch.where(torch.isinf(dead), torch.full_like(topk.ids, -1),
                      topk.ids)
    keys = slot_keys(1, torch.arange(2), torch.zeros(2))
    got = partition_estimate(keys, TopK(ids, dead), n, _score_fn(emb, theta),
                             l=l)
    live = TopK(topk.ids[:, :20], topk.values[:, :20])
    want = partition_estimate(keys, live, n, _score_fn(emb, theta), l=l)
    assert torch.equal(got.tail_ids, want.tail_ids)
    torch.testing.assert_close(got.log_z, want.log_z, rtol=1e-6, atol=0)


# ------------------------------------------------ the port's own draws
N, D = 4096, 16


def _setup(seed=0, scale=3.0, k=128):
    """tests/test_partition.py's problem, one θ."""
    emb, theta, topk = _problem(N, D, 1, k, seed=seed, scale=scale)
    return emb, theta, topk


def _tiled(topk: TopK, theta, reps):
    k = topk.ids.shape[1]
    return (TopK(topk.ids.expand(reps, k), topk.values.expand(reps, k)),
            theta.expand(reps, theta.shape[1]))


def _keys(seed, reps):
    rows = torch.arange(reps)
    return slot_keys(seed, rows, torch.zeros_like(rows))


def test_partition_unbiased():
    emb, theta, topk = _setup()
    reps = 4000
    tk, th = _tiled(topk, theta, reps)
    lz = partition_estimate(_keys(2, reps), tk, N, _score_fn(emb, th),
                            l=128).log_z
    z_true = torch.logsumexp((emb @ theta[0]).double(), 0).exp().item()
    z_hat = np.exp(lz.double().numpy())
    rel_err_of_mean = abs(z_hat.mean() - z_true) / z_true
    sem = z_hat.std() / math.sqrt(len(z_hat)) / z_true
    assert rel_err_of_mean < 4 * sem + 1e-3, (rel_err_of_mean, sem)


def test_partition_concentration_thm34():
    """kl >= (2/3) eps^-2 n ln(1/δ) => P(rel err > eps) <= δ."""
    k, delta = 256, 0.05
    emb, theta, topk = _setup(k=k)
    l_req = int((2 / 3) / (0.25 ** 2) * N * math.log(1 / delta) / k) + 1
    reps = 500
    tk, th = _tiled(topk, theta, reps)
    lz = partition_estimate(_keys(3, reps), tk, N, _score_fn(emb, th),
                            l=l_req).log_z
    z_true = torch.logsumexp((emb @ theta[0]).double(), 0).item()
    rel = np.abs(np.exp(lz.double().numpy() - z_true) - 1.0)
    assert (rel > 0.25).mean() <= delta * 2 + 0.01


def test_expectation_additive_error():
    emb, theta, topk = _setup(k=256)
    f = torch.tanh(torch.arange(N, dtype=torch.float32) / N * 4 - 2)
    true_f = (torch.softmax(emb @ theta[0], 0) * f).sum().item()
    reps = 400
    tk, th = _tiled(topk, theta, reps)
    vals = expectation_estimate(_keys(4, reps), tk, N, _score_fn(emb, th),
                                lambda ids: f[ids], l=512).value
    err = (vals - true_f).abs().numpy()
    assert np.quantile(err, 0.95) < 0.15


def test_expectation_of_features_is_the_gradient_of_log_z():
    """Algorithm 4 with f = φ equals ∇_θ log Ẑ of Algorithm 3 on the same
    S ∪ T (the identity the amortized head's loss relies on)."""
    emb, theta, topk = _setup(k=128)
    reps = 6
    tk, th = _tiled(topk, theta, reps)
    keys = _keys(7, reps)
    th = th.clone().requires_grad_(True)
    lz = partition_estimate(keys, tk, N, _score_fn(emb, th), l=128).log_z
    (grad,) = torch.autograd.grad(lz.sum(), th)
    ee = expectation_estimate(keys, tk, N, _score_fn(emb, th.detach()),
                              lambda ids: emb[ids], l=128)
    np.testing.assert_allclose(grad.numpy(), ee.value.numpy(), rtol=2e-4,
                               atol=2e-5)
    assert torch.equal(ee.log_z, lz.detach())


# ------------------------- Algorithm-3 calibration (test_estimator_stats)
SEEDS = (0, 1, 2)
SN, SD, DRAWS = 1024, 16, 400


def _stats_problem(seed):
    """tests/test_estimator_stats.py's problem: clustered unit rows, one
    spread-out θ (the tail stratum carries mass)."""
    r = np.random.default_rng(seed)
    centers = r.standard_normal((32, SD))
    db = centers[r.integers(0, 32, SN)] + 0.5 * r.standard_normal((SN, SD))
    db = _t((db / np.linalg.norm(db, axis=1, keepdims=True))
            .astype(np.float32))
    return db, db[7] * 4.0


def _probe(backend, db, h, k):
    index = None
    if backend == "ivf":
        index = mips.build_index(
            mips.IVFConfig(n_clusters=32, n_probe=8, kmeans_iters=4), db)
    return estimators.topk_probe(db, h[None], k, index=index)


def _draw_logz(db, h, topk, l, seed):
    tk, hh = _tiled(topk, h[None], DRAWS)
    return partition_estimate(_keys(seed, DRAWS), tk, SN, _score_fn(db, hh),
                              l=l).log_z.double().numpy()


def _stats(db, h, topk):
    """Exact (Z, tail variance, |C|) given the probed S."""
    y = (db @ h).double().numpy()
    vals = topk.values[0].numpy()
    mask = np.zeros(SN, bool)
    mask[topk.ids[0].numpy()[np.isfinite(vals)]] = True
    e = np.exp(y)
    return e.sum(), e[~mask].var(), int((~mask).sum())


@pytest.mark.parametrize("backend", ["exact", "ivf"])
@pytest.mark.parametrize("seed", SEEDS)
def test_logz_interval_calibration(backend, seed):
    k = l = 128
    db, h = _stats_problem(seed)
    topk = _probe(backend, db, h, k)
    z, tail_var, csize = _stats(db, h, topk)
    sigma = np.sqrt(csize ** 2 * tail_var / l)
    assert sigma > 0  # the problem must exercise the tail
    z_hat = np.exp(_draw_logz(db, h, topk, l, seed + 400))
    sem = sigma / np.sqrt(DRAWS)
    assert abs(z_hat.mean() - z) < 5 * sem, (z_hat.mean(), z, sem)
    err = np.abs(z_hat - z)
    slack = 3 * np.sqrt(0.05 * 0.95 / DRAWS)
    assert (err <= 1.96 * sigma).mean() >= 0.95 - slack - 0.02
    assert (err <= sigma / np.sqrt(0.05)).mean() >= 0.95 - slack


@pytest.mark.parametrize("backend", ["exact", "ivf"])
@pytest.mark.parametrize("seed", SEEDS)
def test_logz_bias_shrinks_with_k(backend, seed):
    db, h = _stats_problem(seed)
    log_z = torch.logsumexp((db @ h).double(), 0).item()
    bias = {}
    for k in (16, 256):
        topk = _probe(backend, db, h, k)
        bias[k] = abs(_draw_logz(db, h, topk, k, seed + 500).mean() - log_z)
    assert bias[256] < 0.5 * bias[16], bias
    assert bias[256] < 0.05, bias
