"""The port's IVF-PQ index against the JAX package: subspace k-means and the
quantization primitives, the build from the same initial centroids and
codebooks, ``topk_batch`` on a carried-across state against JAX's (with
the Pallas ``pq_lut_score`` in interpret mode, or the XLA gather), the
plain versions of the three PQ kernels against the JAX oracles, and the
sampler through the index against JAX's ``local_gumbel_max``; plus the
port's own contracts: ``screen_select`` equals ``topk_batch`` bit for bit,
``refresh`` keeps every shape, ``state.db`` is the caller's tensor and
stays out of ``memory_bytes``, and ``rerank_spill`` is counted.

The fused Pallas kernels (``pq_screen_select``, ``rerank_select``) do not
trace on jax 0.9.0 (``pl.store`` is gone), so their plain versions are held
against ``repro/kernels/ref.py``'s oracles and against JAX's unfused
``topk_batch``.

Tolerances: ids and codes exact; fp32 values rtol=atol=1e-5 (XLA-CPU and
PyTorch reduce in different orders); built centroids and codebooks
atol=1e-6. On small-integer data every sum is exact, so ids and values
are compared exactly there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import estimators as jest
from repro.core.mips import pq as jpq
from repro.core.quant import kmeans as jkmeans
from repro.core.quant import pq as jquant
from repro.kernels import ref as jref
from repro.kernels.pq_lut_score import pq_lut_score as jax_pq_lut_score
from repro_torch.convert import pq_state_from_jax
from repro_torch.core import amortized_head as ah
from repro_torch.core import estimators
from repro_torch.core import gumbel
from repro_torch.core.mips import IVFPQIndex, PQConfig, build_index
from repro_torch.core.mips import index_spill, index_spill_parts
from repro_torch.core.mips.pq import _pq_geometry
from repro_torch.core.quant import kmeans, pq
from repro_torch.kernels import ops, ref
from test_torch_sampler import _jax_draws

# one intra-op thread: the suite runs six workers on the same cores
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
CFG = dict(m_sub=4, ksub=16)  # d 16: subspaces of 4 dims, ksub < 256


def _t(x):
    return torch.from_numpy(np.array(x))


def _clustered_db(n=4096, d=16, seed=0):
    r = np.random.default_rng(seed)
    centers = r.standard_normal((32, d))
    db = centers[r.integers(0, 32, n)] + 0.5 * r.standard_normal((n, d))
    return (db / np.linalg.norm(db, axis=1, keepdims=True)).astype(np.float32)


def _jax_build(db, jcfg, init_cent=None, init_codebooks=None):
    """JAX's _device_build -> (its parts, (n_c, cap, o_cap, ksub))."""
    geo = jpq._pq_geometry(db.shape[0], db.shape[1], jcfg)
    n_c, cap, o_cap, ksub = geo
    parts = jpq._device_build(
        jnp.asarray(db), None if init_cent is None else jnp.asarray(init_cent),
        None if init_codebooks is None else jnp.asarray(init_codebooks),
        n_c=n_c, cap=cap, o_cap=o_cap, m_sub=jcfg.m_sub, ksub=ksub,
        iters=jcfg.kmeans_iters, pq_iters=jcfg.pq_iters, seed=jcfg.seed)
    return parts, geo


def _jax_index(db, jcfg):
    parts, _ = _jax_build(db, jcfg)
    return jpq.IVFPQIndex(jcfg, jpq.IVFPQIndex._assemble(
        jcfg, parts, jnp.asarray(db)))


def _port_index(jindex, cfg, db: torch.Tensor) -> IVFPQIndex:
    return IVFPQIndex(cfg, pq_state_from_jax(jax.device_get(jindex.state),
                                             db))


# ------------------------------------------------------------ quantization
def test_subspace_kmeans_matches_jax():
    r = np.random.default_rng(1)
    x = r.standard_normal((4, 600, 3)).astype(np.float32)
    init = x[:, :10]
    want = np.asarray(jkmeans.subspace_kmeans(jnp.asarray(x),
                                              jnp.asarray(init), 5))
    got = kmeans.subspace_kmeans(_t(x), _t(init), 5)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    for i in range(4):  # subspace i is lloyd on x[i]
        torch.testing.assert_close(got[i], kmeans.lloyd(_t(x[i]),
                                                        _t(init[i]), 5),
                                   rtol=0, atol=0)


def test_codebooks_encode_decode_lut_match_jax():
    r = np.random.default_rng(2)
    x = r.standard_normal((500, 16)).astype(np.float32)
    q = r.standard_normal((3, 16)).astype(np.float32)
    init = x[r.permutation(500)[:16]].reshape(16, 4, 4).transpose(1, 0, 2)
    want_cb = jquant.train_codebooks(jnp.asarray(x), 4, 16, 6,
                                     init=jnp.asarray(init))
    cb = pq.train_codebooks(_t(x), 4, 16, 6, init=_t(init))
    np.testing.assert_allclose(cb.numpy(), np.asarray(want_cb), rtol=0,
                               atol=1e-6)
    codes = pq.encode(cb, _t(x))
    assert codes.dtype == torch.uint8
    np.testing.assert_array_equal(codes.numpy(), np.asarray(
        jquant.encode(want_cb, jnp.asarray(x))))
    np.testing.assert_allclose(
        pq.decode(cb, codes).numpy(),
        np.asarray(jquant.decode(want_cb, jnp.asarray(codes.numpy()))),
        **TOL)
    lut = pq.build_lut(cb, _t(q))
    want_lut = jquant.build_lut(want_cb, jnp.asarray(q))
    np.testing.assert_allclose(lut.numpy(), np.asarray(want_lut), **TOL)
    c3 = codes[:60].reshape(3, 20, 4)
    np.testing.assert_allclose(
        pq.lut_scores(lut, c3).numpy(),
        np.asarray(jquant.lut_scores(want_lut, jnp.asarray(c3.numpy()))),
        **TOL)


def test_train_codebooks_cold_start_and_small_n():
    """A cold start samples one row set for every subspace (repeated
    cyclically when n < ksub) and is a function of the seed."""
    x = _t(np.random.default_rng(3).standard_normal((5, 8))
           .astype(np.float32))
    cb = pq.train_codebooks(x, 2, 12, 0, seed=4)
    assert cb.shape == (2, 12, 4)
    rows = [int(torch.nonzero((x[:, :4] == cb[0, j]).all(1))[0])
            for j in range(12)]
    assert sorted(set(rows)) == list(range(5)) and rows[:7] == rows[5:]
    for j, row in enumerate(rows):
        assert torch.equal(cb[1, j], x[row, 4:])
    assert torch.equal(cb, pq.train_codebooks(x, 2, 12, 0, seed=4))


# ------------------------------------------------------------------ build
def test_build_from_jax_initial_state_matches_jax():
    db = _clustered_db(seed=5)
    jcfg = jpq.PQConfig(**CFG)
    n_c, cap, o_cap, ksub = jpq._pq_geometry(*db.shape, jcfg)
    assert _pq_geometry(*db.shape, PQConfig(**CFG)) == (n_c, cap, o_cap, ksub)
    r = np.random.default_rng(6)
    init_cent = db[r.permutation(db.shape[0])[:n_c]]
    init_cb = r.standard_normal((4, ksub, 4)).astype(np.float32) * 0.2
    parts, _ = _jax_build(db, jcfg, init_cent, init_cb)
    want = jpq.IVFPQIndex._assemble(jcfg, parts, jnp.asarray(db))
    tdb = _t(db)
    got = IVFPQIndex.build(tdb, PQConfig(**CFG), init_cent=_t(init_cent),
                           init_codebooks=_t(init_cb)).state
    for name in ("centroids", "codebooks", "radii"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), rtol=0,
                                   atol=1e-6, err_msg=name)
    for name in ("member_ids", "member_codes", "overflow_ids", "spill_count",
                 "rerank_spill"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert got.member_codes.dtype == torch.uint8
    assert got.db is tdb


# ---------------------------------------------------------------- queries
def _int_state(seed=7, n=1500, d=16, n_c=10, cap=48, o_cap=40):
    """A JAX PQState of small integers: centroids, codebooks, rows and (in
    the caller) queries, so every LUT sum and dot product is exact."""
    r = np.random.default_rng(seed)
    m, ksub = CFG["m_sub"], CFG["ksub"]
    ids = r.permutation(n)[:n_c * cap + o_cap].astype(np.int32)
    member_ids = ids[:n_c * cap].reshape(n_c, cap)
    member_ids[r.random((n_c, cap)) < 0.2] = -1
    overflow_ids = ids[n_c * cap:].copy()
    overflow_ids[::5] = -1
    codes = r.integers(0, ksub, (n_c, cap, m)).astype(np.uint8)
    codes[member_ids < 0] = 0
    return jpq.PQState(
        centroids=jnp.asarray(r.integers(-2, 3, (n_c, d)), jnp.float32),
        codebooks=jnp.asarray(r.integers(-2, 3, (m, ksub, d // m)),
                              jnp.float32),
        member_ids=jnp.asarray(member_ids), member_codes=jnp.asarray(codes),
        overflow_ids=jnp.asarray(overflow_ids),
        spill_count=jnp.zeros((), jnp.int32),
        rerank_spill=jnp.zeros((), jnp.int32),
        radii=jnp.ones((n_c,), jnp.float32),
        db=jnp.asarray(r.integers(-2, 3, (n, d)), jnp.float32))


@pytest.mark.parametrize("data", ["small_int", "random"])
@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["plain_screen", "kernel_screen"])
def test_topk_batch_on_jax_state_matches_jax(data, use_kernel):
    """The port's one screen (``pq_lut_score``'s plain version on the CPU)
    against each of JAX's: its XLA gather (``use_kernel=False``) and its
    Pallas kernel in interpret mode."""
    r = np.random.default_rng(8)
    if data == "small_int":
        jstate = _int_state()
        q = r.integers(-2, 3, (6, 16)).astype(np.float32)
        jcfg = jpq.PQConfig(n_probe=3, use_kernel=use_kernel, **CFG)
        jindex = jpq.IVFPQIndex(jcfg, jstate)
    else:
        db = _clustered_db(seed=9)
        jcfg = jpq.PQConfig(n_probe=4, use_kernel=use_kernel, **CFG)
        jindex = _jax_index(db, jcfg)
        q = r.standard_normal((6, 16)).astype(np.float32)
    want = jindex.topk_batch(jnp.asarray(q), 64)
    db_t = _t(jindex.state.db)
    index = _port_index(jindex, PQConfig(n_probe=jcfg.n_probe, **CFG), db_t)
    got = index.topk_batch(_t(q), 64)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    if data == "small_int":
        np.testing.assert_array_equal(got.values.numpy(),
                                      np.asarray(want.values))
    else:
        np.testing.assert_allclose(got.values.numpy(),
                                   np.asarray(want.values), **TOL)
    assert index.memory_bytes() == jindex.memory_bytes()


@pytest.mark.parametrize("k", [64, 600], ids=["k64", "k_past_pool"])
@pytest.mark.parametrize("n_probe", [1, 3], ids=["probe1", "probe3"])
def test_screen_select_equals_topk_batch_bitwise(k, n_probe):
    """The fused screen and the unfused probe give the same ids and the
    same values, bit for bit — also when k exceeds the live pool (dead
    picks are (-inf, -1) either way). On the CPU both run the kernels'
    plain versions."""
    db = _clustered_db(n=2048, seed=10)
    cfg = PQConfig(n_probe=n_probe, **CFG)
    index = build_index(cfg, _t(db))
    assert (index.state.cap * n_probe + index.state.overflow_ids.shape[0]
            < 600)
    q = _t(np.random.default_rng(11).standard_normal((5, 16))
           .astype(np.float32))
    a = index.topk_batch(q, k)
    b = index.screen_select(q, k)
    assert torch.equal(a.ids, b.ids) and torch.equal(a.values, b.values)
    if k == 600:
        assert (a.ids == -1).any() and torch.isneginf(a.values).any()


# --------------------------------------------------- plain kernel versions
def _screen_case(kind: str):
    r = np.random.default_rng({"random": 12, "small_pool": 13, "dead_row": 14,
                               "ties": 15}[kind])
    n_c, cap, m, ksub, b, n_probe, o_cap, rr = 12, 8, 4, 16, 4, 3, 16, 24
    if kind == "small_pool":  # pool (np*cap + o_cap) narrower than r
        n_c, cap, n_probe, o_cap, rr = 4, 4, 2, 4, 16
    if kind == "ties":  # small integers: exact, heavily tied scores
        lut = r.integers(-1, 2, (b, m, ksub)).astype(np.float32)
        coarse = r.integers(-1, 2, (b, n_probe)).astype(np.float32)
        osc = r.integers(-3, 4, (b, o_cap)).astype(np.float32)
    else:
        lut = r.standard_normal((b, m, ksub), dtype=np.float32)
        coarse = r.standard_normal((b, n_probe), dtype=np.float32)
        osc = r.standard_normal((b, o_cap), dtype=np.float32)
    codes = r.integers(0, ksub, (n_c, cap, m)).astype(np.uint8)
    mids = r.integers(0, 1000, (n_c, cap)).astype(np.int32)
    mids[r.random((n_c, cap)) < 0.3] = -1
    oids = r.integers(0, 1000, (o_cap,)).astype(np.int32)
    oids[r.random(o_cap) < 0.3] = -1
    probe = np.stack([r.permutation(n_c)[:n_probe] for _ in range(b)])
    probe = probe.astype(np.int32)
    if kind == "dead_row":  # row 0 probes only dead clusters, no overflow
        mids[probe[0]] = -1
        oids[:] = -1
    return codes, mids, coarse, osc, oids, probe, lut, rr


def test_pq_lut_score_ref_matches_interpret_kernel():
    codes, _, _, _, _, probe, lut, _ = _screen_case("random")
    want = jax_pq_lut_score(jnp.asarray(codes), jnp.asarray(probe),
                            jnp.asarray(lut), interpret=True)
    got = ref.pq_lut_score_ref(_t(codes), _t(probe), _t(lut))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jref.pq_lut_score_ref(codes, probe, lut)), **TOL)
    # ops on CPU tensors = the plain version; no launch counted
    ops.reset_launch_counts()
    assert torch.equal(ops.pq_lut_score(_t(codes), _t(probe), _t(lut)), got)
    assert ops.launch_counts()["pq_lut_score"] == 0


@pytest.mark.parametrize("kind", ["random", "small_pool", "dead_row", "ties"])
def test_pq_screen_select_ref_matches_jax_oracle(kind):
    args = _screen_case(kind)
    rr = args[-1]
    want_v, want_i = jref.pq_screen_select_ref(*args)
    got_v, got_i = ref.pq_screen_select_ref(*(_t(a) for a in args[:-1]), rr)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), **TOL)
    gv, gi = ops.pq_screen_select(*(_t(a) for a in args[:-1]), r=rr)
    assert torch.equal(gv, got_v) and torch.equal(gi, got_i)
    if kind == "dead_row":
        assert (got_i[0] == -1).all() and torch.isneginf(got_v[0]).all()


def test_pq_screen_select_ref_probe_width():
    """Stages at or past a row's probe_width are dead: each row equals the
    oracle run on its probe prefix alone."""
    codes, mids, coarse, osc, oids, probe, lut, rr = _screen_case("random")
    width = np.asarray([3, 1, 0, 2], np.int32)
    got_v, got_i = ref.pq_screen_select_ref(
        _t(codes), _t(mids), _t(coarse), _t(osc), _t(oids), _t(probe),
        _t(lut), rr, probe_width=_t(width))
    for i, w in enumerate(width):
        want_v, want_i = jref.pq_screen_select_ref(
            codes, mids, coarse[i:i + 1, :w], osc[i:i + 1], oids,
            probe[i:i + 1, :w], lut[i:i + 1], rr)
        np.testing.assert_array_equal(got_i[i].numpy(), np.asarray(want_i)[0])
        np.testing.assert_allclose(got_v[i].numpy(), np.asarray(want_v)[0],
                                   **TOL)


@pytest.mark.parametrize("kind", ["random", "ties"])
def test_rerank_select_ref_matches_jax_oracle(kind):
    r = np.random.default_rng({"random": 16, "ties": 17}[kind])
    n, d, b, rr, k = 300, 16, 5, 40, 24
    if kind == "ties":
        db = r.integers(-1, 2, (n, d)).astype(np.float32)
        q = r.integers(-1, 2, (b, d)).astype(np.float32)
    else:
        db = r.standard_normal((n, d), dtype=np.float32)
        q = r.standard_normal((b, d), dtype=np.float32)
    cand = r.integers(0, n, (b, rr)).astype(np.int32)
    lut_vals = r.standard_normal((b, rr), dtype=np.float32)
    cand[:, ::7] = -1  # dead ids
    lut_vals[:, 3::9] = -np.inf  # dead screening values
    cand[2] = -1  # an all-dead query
    want_v, want_i = jref.rerank_select_ref(db, cand, lut_vals, q, k)
    got_v, got_i = ref.rerank_select_ref(_t(db), _t(cand), _t(lut_vals),
                                         _t(q), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), **TOL)
    assert (got_i[2] == -1).all() and torch.isneginf(got_v[2]).all()
    gv, gi = ops.rerank_select(_t(db), _t(cand), _t(lut_vals), _t(q), k=k)
    assert torch.equal(gv, got_v) and torch.equal(gi, got_i)


# --------------------------------------------------------- index contracts
def test_refresh_keeps_shapes_and_coverage():
    db = _clustered_db(seed=18)
    index = IVFPQIndex.build(_t(db), PQConfig(**CFG))
    drifted = _t(db + 0.05 * np.random.default_rng(19).standard_normal(
        db.shape).astype(np.float32))
    new = index.refresh(drifted)
    for a, b in zip(index.state, new.state):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert new.state.db is drifted
    assert int(new.state.spill_count) == 0
    ids = torch.cat([new.state.member_ids.flatten(), new.state.overflow_ids])
    assert torch.equal(torch.sort(ids[ids >= 0]).values,
                       torch.arange(db.shape[0], dtype=ids.dtype))
    # warm start: the refresh moved the codebooks, from the old ones
    assert not torch.equal(new.state.codebooks, index.state.codebooks)


def test_db_is_the_callers_tensor_and_not_counted():
    db = _t(_clustered_db(seed=20))
    index = IVFPQIndex.build(db, PQConfig(**CFG))
    st = index.state
    assert st.db.data_ptr() == db.data_ptr()
    owned = sum(t.numel() * t.element_size() for t in st[:-1])
    assert index.memory_bytes() == owned < db.numel() * db.element_size()
    conv = pq_state_from_jax(jax.device_get(_jax_index(
        db.numpy(), jpq.PQConfig(**CFG)).state), db)
    assert conv.db is db
    # the head passes the resident table itself when the vocab is unpadded
    hc = ah.HeadConfig(n=db.shape[0], mips="ivfpq", k=32)
    assert ah.make_index(hc, db, device="cpu").state.db is db
    assert ah.make_index(hc, db, device="cpu").config.rerank == 64


def test_rerank_spill_is_counted():
    db = _clustered_db(n=2048, seed=21)
    jcfg = jpq.PQConfig(n_probe=2, rerank=5000, **CFG)
    jindex = _jax_index(db, jcfg)
    index = _port_index(jindex, PQConfig(n_probe=2, rerank=5000, **CFG),
                        _t(db))
    st = index.state
    short = 5000 - (2 * st.cap + st.overflow_ids.shape[0])
    assert int(st.rerank_spill) == int(jindex.state.rerank_spill) == short > 0
    assert index_spill_parts(index) == (0, short)
    assert index_spill(index) == short
    built = IVFPQIndex.build(_t(db), PQConfig(n_probe=2, rerank=5000, **CFG))
    assert int(built.state.rerank_spill) == short
    assert index_spill_parts(None) == (0, 0)


# ---------------------------------------------------------------- sampler
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_sampler_through_pq_index_matches_jax(fused):
    """Algorithm 2 behind the IVF-PQ probe, fed JAX's own draws: the port
    (fused: pq_screen_select + rerank_select + the tail kernel's plain
    versions) against JAX's unfused sampler on the same index state."""
    r = np.random.default_rng(22)
    db = _clustered_db(n=2048, seed=23)
    t, k, l = 12, 32, 32
    h = (r.standard_normal((t, 16)) * 3.0).astype(np.float32)
    jcfg = jpq.PQConfig(n_probe=4, **CFG)
    jindex = _jax_index(db, jcfg)
    keys = jax.random.split(jax.random.key(24), t)
    m_cap = gumbel.default_m_cap(l)
    want = jest.local_gumbel_max(None, jnp.asarray(db), jnp.asarray(h), k=k,
                                 l=l, keys=keys, index=jindex)
    topk = jest.topk_probe(jnp.asarray(db), jnp.asarray(h), k, index=jindex)
    _, kv = jest.sanitize_topk(topk, db.shape[0])
    draws = _jax_draws(keys, k, l, m_cap, db.shape[0], kv)
    emb = _t(db)
    index = _port_index(jindex, PQConfig(n_probe=4, **CFG), emb)
    got = estimators.local_gumbel_max(emb, _t(h), k=k, l=l, index=index,
                                      draws=draws, fused=fused)
    np.testing.assert_array_equal(got.index.numpy(), np.asarray(want.index))
    np.testing.assert_array_equal(got.m.numpy(), np.asarray(want.m))
    np.testing.assert_array_equal(got.ok.numpy(), np.asarray(want.ok))
    np.testing.assert_array_equal(got.overflow.numpy(),
                                  np.asarray(want.overflow))
    np.testing.assert_allclose(got.max_val.numpy(), np.asarray(want.max_val),
                               **TOL)
    np.testing.assert_allclose(got.bound.numpy(), np.asarray(want.bound),
                               **TOL)
