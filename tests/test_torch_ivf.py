"""The port's IVF index against the JAX package: Lloyd k-means and the
build from the same initial centroids, ``topk_batch`` on a carried-across
state against JAX's unfused XLA probe, and the port's internal contract
that the fused ``screen_select`` equals ``topk_batch`` bit for bit.

Not copied here: tests/test_head.py::test_head_with_ivf_index compares the
amortized IVF loss with the exact loss at rtol=atol=0.1, and that
comparison fails on the reference itself (up to 1.81 nats apart). The port
is held to the reference on the same index state instead.

Tolerances: ids exact; fp32 values rtol=atol=1e-5. The build tests allow no
near-tie excuse: with the data below, every assignment agrees exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.mips import ivf as jivf
from repro.core.quant import kmeans as jkmeans
from repro_torch.convert import ivf_state_from_jax
from repro_torch.core.mips import IVFConfig, IVFIndex, build_index
from repro_torch.core.mips.ivf import _geometry
from repro_torch.core.quant import kmeans

# one intra-op thread: the suite runs six workers on the same cores, and
# torch's default thread pool per worker oversubscribes them
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.array(x))


def _clustered_db(n=4096, d=16, seed=0):
    r = np.random.default_rng(seed)
    centers = r.standard_normal((32, d))
    db = centers[r.integers(0, 32, n)] + 0.5 * r.standard_normal((n, d))
    return (db / np.linalg.norm(db, axis=1, keepdims=True)).astype(np.float32)


def _jax_state(db, cfg):
    n_c, cap, o_cap = jivf._geometry(db.shape[0], cfg)
    return jivf._device_build(jnp.asarray(db), None, n_c=n_c, cap=cap,
                              o_cap=o_cap, iters=cfg.kmeans_iters,
                              seed=cfg.seed)


def test_lloyd_matches_jax():
    db = _clustered_db(1024, 8, seed=1)
    init = db[:20]
    want = np.asarray(jkmeans.lloyd(jnp.asarray(db), jnp.asarray(init), 5))
    got = kmeans.lloyd(_t(db), _t(init), 5)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_array_equal(
        kmeans.assign_clusters(_t(db), got).numpy(),
        np.asarray(jkmeans.assign_clusters(jnp.asarray(db), jnp.asarray(want))))


def test_build_from_jax_initial_centroids_matches_jax():
    db = _clustered_db()
    jcfg = jivf.IVFConfig()
    n_c, cap, o_cap = jivf._geometry(db.shape[0], jcfg)
    assert _geometry(db.shape[0], IVFConfig()) == (n_c, cap, o_cap)
    init = np.asarray(db)[np.asarray(
        jax.random.permutation(jax.random.key(jcfg.seed), db.shape[0])[:n_c])]
    want = _jax_state(db, jcfg)
    got = IVFIndex.build(_t(db), IVFConfig(), init_cent=_t(init)).state
    np.testing.assert_allclose(got.centroids.numpy(),
                               np.asarray(want.centroids), **TOL)
    np.testing.assert_array_equal(got.member_ids.numpy(),
                                  np.asarray(want.member_ids))
    np.testing.assert_array_equal(got.overflow_ids.numpy(),
                                  np.asarray(want.overflow_ids))
    assert int(got.spill_count) == int(want.spill_count)
    np.testing.assert_array_equal(got.member_vecs.numpy(),
                                  np.asarray(want.member_vecs))
    np.testing.assert_allclose(got.radii.numpy(), np.asarray(want.radii),
                               **TOL)


@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["plain_probe", "kernel_probe"])
def test_topk_batch_on_jax_state_matches_jax(use_kernel):
    db = _clustered_db(seed=2)
    jcfg = jivf.IVFConfig(n_probe=4)
    state = jax.device_get(_jax_state(db, jcfg))
    q = np.random.default_rng(3).standard_normal((6, 16)).astype(np.float32)
    want = jivf.IVFIndex(jcfg, jax.tree.map(jnp.asarray, state)).topk_batch(
        jnp.asarray(q), 64)
    index = IVFIndex(IVFConfig(n_probe=4, use_kernel=use_kernel),
                     ivf_state_from_jax(state))
    got = index.topk_batch(_t(q), 64)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_allclose(got.values.numpy(), np.asarray(want.values),
                               **TOL)
    assert index.memory_bytes() == jivf.IVFIndex(jcfg, state).memory_bytes()


@pytest.mark.parametrize("k", [64, 2000], ids=["k64", "k_past_pool"])
def test_screen_select_equals_topk_batch_bitwise(k):
    """DESIGN.md §10 inside the port: the fused screen and the kernel probe
    give the same ids and the same values, bit for bit — also when k
    exceeds the live pool (dead picks are id -1 either way)."""
    db = _clustered_db(seed=4)
    index = build_index(IVFConfig(n_probe=3, use_kernel=True), _t(db))
    q = _t(np.random.default_rng(5).standard_normal((5, 16))
           .astype(np.float32))
    a = index.topk_batch(q, k)
    b = index.screen_select(q, k)
    assert torch.equal(a.ids.long(), b.ids.long())
    assert torch.equal(a.values, b.values)


def test_refresh_keeps_shapes_and_coverage():
    db = _clustered_db(seed=6)
    index = IVFIndex.build(_t(db))
    drifted = _t(db + 0.05 * np.random.default_rng(7).standard_normal(
        db.shape).astype(np.float32))
    new = index.refresh(drifted)
    for a, b in zip(index.state, new.state):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert int(new.state.spill_count) == 0
    ids = torch.cat([new.state.member_ids.flatten(), new.state.overflow_ids])
    assert torch.equal(torch.sort(ids[ids >= 0]).values,
                       torch.arange(db.shape[0], dtype=ids.dtype))
