"""The port's anisotropic (score-aware) codebook training against the JAX
package: ``anisotropic_lloyd`` and its subspace form, the batched
per-cluster Σ u uᵀ against the per-row products, the codebooks of an
``anisotropic_eta`` IVF-PQ build and refresh from the same initial state;
and the reference's three anisotropic tests (``tests/test_adaptive.py``)
on the port.

Tolerances: fp32 centroids and codebooks rtol=0, atol=1e-5 (each update
solves a (k, d, d) system, LAPACK against XLA's solver); the data keep
every assignment clear of ties, and the ids and codes are compared
exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.mips import pq as jpq
from repro.core.quant import kmeans as jkmeans
from repro.core.quant import pq as jquant
from repro_torch.core import mips
from repro_torch.core.mips.pq import IVFPQIndex, PQConfig
from repro_torch.core.quant import kmeans
from repro_torch.core.quant import pq as quant

torch.set_num_threads(1)

TOL = dict(rtol=0, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.array(x))


def _clustered(n, d, seed, centers=16, noise=0.3):
    r = np.random.default_rng(seed)
    c = r.standard_normal((centers, d)) * 2.0
    x = c[r.integers(0, centers, n)] + noise * r.standard_normal((n, d))
    return x.astype(np.float32)


def _dirs(x):
    return (x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True),
                           1e-9)).astype(np.float32)


@pytest.mark.parametrize("eta", [4.0, 0.5])
def test_anisotropic_lloyd_matches_jax(eta):
    x = _clustered(1024, 8, seed=1)
    u = _dirs(_clustered(1024, 8, seed=2))
    cent0 = x[:: 1024 // 16][:16].copy()
    want = np.asarray(jkmeans.anisotropic_lloyd(
        jnp.asarray(x), jnp.asarray(u), jnp.asarray(cent0), 5, eta))
    got = kmeans.anisotropic_lloyd(_t(x), _t(u), _t(cent0), 5, eta)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_anisotropic_subspace_kmeans_matches_jax():
    x = np.stack([_clustered(512, 4, seed=s) for s in (3, 4)])
    u = np.stack([_dirs(_clustered(512, 4, seed=s)) for s in (5, 6)]) * 0.7
    init = x[:, :8].copy()
    want = np.asarray(jkmeans.anisotropic_subspace_kmeans(
        jnp.asarray(x), jnp.asarray(u), jnp.asarray(init), 4, 3.0))
    got = kmeans.anisotropic_subspace_kmeans(_t(x), _t(u), _t(init), 4, 3.0)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("k", [1, 7, 64])
def test_cluster_outer_equals_per_row_sum(k):
    """The batched Gram matrices equal the sum of the per-row u uᵀ over
    each cluster's rows; empty clusters give 0."""
    r = np.random.default_rng(k)
    u = _t(r.standard_normal((300, 6)).astype(np.float32))
    assign = _t(r.integers(0, max(1, k - 2), 300))  # some clusters empty
    want = torch.zeros((k, 6, 6)).index_add_(
        0, assign, u[:, :, None] * u[:, None, :])
    got = kmeans.cluster_outer(u, assign, k)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_train_codebooks_anisotropic_matches_jax():
    x = _clustered(1024, 16, seed=7)
    anchors = x + _clustered(1024, 16, seed=8)
    init = np.stack([x[:12, i * 4:(i + 1) * 4] for i in range(4)])
    want = np.asarray(jquant.train_codebooks(
        jnp.asarray(x), 4, 12, 3, init=jnp.asarray(init),
        anisotropic_eta=4.0, anchors=jnp.asarray(anchors)))
    got = quant.train_codebooks(_t(x), 4, 12, 3, init=_t(init),
                                anisotropic_eta=4.0, anchors=_t(anchors))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # eta 0 (or no anchors) is the standard objective
    plain = quant.train_codebooks(_t(x), 4, 12, 3, init=_t(init))
    assert torch.equal(plain, quant.train_codebooks(
        _t(x), 4, 12, 3, init=_t(init), anisotropic_eta=0.0,
        anchors=_t(anchors)))


CFG = dict(n_clusters=12, kmeans_iters=3, m_sub=4, ksub=16, pq_iters=3,
           rerank=64, n_probe=4, anisotropic_eta=4.0)


def test_pq_build_and_refresh_anisotropic_match_jax():
    """An ``anisotropic_eta`` IVF-PQ build from the reference's initial
    centroids and codebooks, and a refresh, give the reference's
    structures."""
    r = np.random.default_rng(9)
    db = _clustered(2048, 16, seed=10)
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    jcfg = jpq.PQConfig(**CFG)
    n_c, cap, o_cap, ksub = jpq._pq_geometry(*db.shape, jcfg)
    init_cent = db[r.permutation(db.shape[0])[:n_c]]
    init_cb = (r.standard_normal((4, ksub, 4)) * 0.2).astype(np.float32)
    kw = dict(n_c=n_c, cap=cap, o_cap=o_cap, m_sub=4, ksub=ksub,
              anisotropic_eta=4.0, seed=0)
    parts = jpq._device_build(jnp.asarray(db), jnp.asarray(init_cent),
                              jnp.asarray(init_cb), iters=3, pq_iters=3, **kw)
    got = IVFPQIndex.build(_t(db), PQConfig(**CFG), init_cent=_t(init_cent),
                           init_codebooks=_t(init_cb))
    names = ("centroids", "codebooks", "member_ids", "member_codes")
    for name, w in zip(names, parts[:4]):
        g = getattr(got.state, name).numpy()
        if g.dtype.kind == "f":
            np.testing.assert_allclose(g, np.asarray(w), **TOL, err_msg=name)
        else:
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)
    db2 = db + 0.05 * _clustered(2048, 16, seed=11)
    parts2 = jpq._device_build(jnp.asarray(db2), parts[0], parts[1],
                               iters=jcfg.refresh_iters,
                               pq_iters=jcfg.pq_refresh_iters, **kw)
    ref = got.refresh(_t(db2)).state
    np.testing.assert_allclose(ref.codebooks.numpy(), np.asarray(parts2[1]),
                               **TOL)
    np.testing.assert_array_equal(ref.member_codes.numpy(),
                                  np.asarray(parts2[3]))


# ---------------------------------- the reference's tests, on the port
def _db(n=2048, d=32, seed=0):
    r = np.random.default_rng(seed)
    c = r.standard_normal((32, d))
    db = c[r.integers(0, 32, n)] + 0.3 * r.standard_normal((n, d))
    return _t((db / np.linalg.norm(db, axis=1, keepdims=True)).astype(
        np.float32))


def test_anisotropic_eta1_matches_standard_lloyd():
    x = _db(n=512, d=16, seed=19)
    u = x / torch.clamp(torch.linalg.norm(x, dim=1, keepdim=True), min=1e-9)
    cent0 = x[:8].clone()
    std = kmeans.lloyd(x, cent0, 5)
    ani = kmeans.anisotropic_lloyd(x, u, cent0, 5, eta=1.0)
    torch.testing.assert_close(ani, std, rtol=0, atol=1e-3)


def test_anisotropic_eta_reduces_parallel_loss():
    """eta > 1 trades total residual for the query-parallel residual, the
    part that moves inner-product scores."""
    x = _t(np.random.default_rng(20).standard_normal((2048, 16)).astype(
        np.float32))
    u = x / torch.clamp(torch.linalg.norm(x, dim=1, keepdim=True), min=1e-9)
    cent0 = x[:16].clone()

    def parallel_loss(cent):
        a = kmeans.assign_clusters(x, cent)
        r = x - cent[a]
        return float((((r * u).sum(-1)) ** 2).mean())

    iso = kmeans.anisotropic_lloyd(x, u, cent0, 6, eta=1.0)
    ani = kmeans.anisotropic_lloyd(x, u, cent0, 6, eta=4.0)
    assert parallel_loss(ani) < parallel_loss(iso)


def test_pq_anisotropic_build_queries_fine():
    """An eta > 0 IVF-PQ build is a drop-in: same shapes, sane recall."""
    db = _db(seed=21)
    r = np.random.default_rng(22)
    q = db[_t(r.integers(0, db.shape[0], 16))] / 0.05
    k = 64
    exact = mips.build_index(mips.ExactConfig(), db)
    cfg = dict(n_clusters=32, kmeans_iters=4, m_sub=4, pq_iters=4,
               rerank=2 * k, n_probe=8)
    pq = mips.build_index(mips.PQConfig(anisotropic_eta=4.0, **cfg), db)
    iso = mips.build_index(mips.PQConfig(**cfg), db)
    got = pq.topk_batch(q, k).ids.numpy()
    want = exact.topk_batch(q, k).ids.numpy()
    rec = np.mean([len(set(g) & set(w)) / k for g, w in zip(got, want)])
    assert rec >= 0.8, rec
    for a, b in zip(pq.state, iso.state):
        assert a.shape == b.shape and a.dtype == b.dtype
