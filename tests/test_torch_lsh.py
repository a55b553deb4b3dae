"""The port's SRP-LSH index and LSH sampler against the JAX package.

* The build: the port draws the reference's projections (numpy, same
  seed), so ``table_ids``, ``counts`` and ``db_aug`` equal the reference's.
  The inputs are chosen so that every projection of a row (and of a query)
  lies farther than 1e-4 from 0, which the tests assert: the two packages
  sum the projections in different orders, and only a value that close to
  0 could change sign.
* ``topk_batch`` against the reference's probe; the reference's five LSH
  tests (``tests/test_mips.py``) run on the port.
* ``lsh_sampler_logz`` on a converted JAX state, fp32 rtol = atol = 1e-5,
  with ``per_table``, on both of its paths (every row scored when the
  tables hold at least n slots, else only the live candidates); and the reference's statistical test
  (``tests/test_estimator_stats.py::test_lsh_sampler_unbiased_and_calibrated``)
  on the port.
* The head's bucket sizing and the LSH head's launchers (serve, and train
  with a resume that equals the uninterrupted run bit for bit).
"""
import contextlib
import io
import json
import math
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hyp import given, settings, strategies as st

from repro.core import estimators as jest
from repro.core import mips as jmips
from repro.core.amortized_head import HeadConfig as JHeadConfig
from repro.core.amortized_head import make_index as jmake_index
from repro_torch.convert import lsh_state_from_jax
from repro_torch.core import estimators as est
from repro_torch.core import mips
from repro_torch.core.amortized_head import HeadConfig, make_index
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import train as train_launcher

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
MARGIN = 1e-4  # every row's and query's |projection| exceeds this


def _t(x):
    return torch.from_numpy(np.array(x))


def _db(n=2048, d=32, seed=0, noise=0.3, centers=32):
    """Unit-norm clustered rows (numpy)."""
    r = np.random.default_rng(seed)
    c = r.standard_normal((centers, d))
    db = c[r.integers(0, centers, n)] + noise * r.standard_normal((n, d))
    return (db / np.linalg.norm(db, axis=1, keepdims=True)).astype(np.float32)


def _proj(cfg, d):
    return np.random.default_rng(cfg.seed).standard_normal(
        (cfg.n_tables, d + 1, cfg.n_bits)).astype(np.float32)


def _margin(x_aug, proj):
    """Smallest |projection| (float64) of rows ``x_aug`` over all tables."""
    v = np.einsum("nd,tdb->tnb", np.asarray(x_aug, np.float64),
                  np.asarray(proj, np.float64))
    return np.abs(v).min(axis=(0, 2))  # per row


def _clear_db(cfg, n=2048, d=32, seed=0):
    """Rows whose projections stay clear of 0: drop the rows that come
    within 2·MARGIN (the augmented coordinate barely moves when rows are
    dropped: every row has norm 1 up to rounding)."""
    db = _db(n, d, seed)
    norms = np.linalg.norm(db, axis=1)
    aug = np.sqrt(np.maximum((norms.max() + 1e-6) ** 2 - norms**2, 0.0))
    x_aug = np.concatenate([db, aug[:, None]], axis=1)
    return db[_margin(x_aug, _proj(cfg, d)) > 2 * MARGIN]


def _clear_queries(cfg, db, t, seed, scale=4.0):
    r = np.random.default_rng(seed)
    q = db[r.integers(0, db.shape[0], 4 * t)] + 0.2 * r.standard_normal(
        (4 * t, db.shape[1])).astype(np.float32)
    q = (scale * q).astype(np.float32)
    q_aug = np.concatenate([q, np.zeros((q.shape[0], 1), np.float32)], 1)
    keep = _margin(q_aug, _proj(cfg, db.shape[1])) > 2 * MARGIN
    return q[keep][:t]


def _both(cfg, db):
    j = jmips.build_index(jmips.LSHConfig(**vars(cfg)), jnp.asarray(db))
    p = mips.build_index(cfg, _t(db))
    return j, p


# ------------------------------------------------------------------ build
@pytest.mark.parametrize("cap", [None, 24])
def test_build_equals_reference(cap):
    cfg = mips.LSHConfig(n_tables=6, n_bits=7, bucket_cap=cap, seed=3)
    db = _clear_db(cfg)
    j, p = _both(cfg, db)
    assert _margin(np.asarray(j.db_aug), np.asarray(j.proj)).min() > MARGIN
    np.testing.assert_array_equal(p.proj.numpy(), np.asarray(j.proj))
    np.testing.assert_array_equal(p.db_aug.numpy(), np.asarray(j.db_aug))
    np.testing.assert_array_equal(p.counts.numpy(), np.asarray(j.counts))
    np.testing.assert_array_equal(p.table_ids.numpy(),
                                  np.asarray(j.table_ids))
    assert p.dropped_count == j.dropped_count
    if cap == 24:
        assert p.dropped_count > 0  # the cap bites: lowest ids kept
    assert p.memory_bytes() == j.memory_bytes()
    # refresh: same projections and cap, tables over the new rows
    db2 = _clear_db(cfg, seed=5)[: db.shape[0] // 2]
    jr, pr = j.refresh(jnp.asarray(db2)), p.refresh(_t(db2))
    np.testing.assert_array_equal(pr.table_ids.numpy(),
                                  np.asarray(jr.table_ids))
    np.testing.assert_array_equal(pr.counts.numpy(), np.asarray(jr.counts))


def test_topk_and_log_probs_match_reference():
    cfg = mips.LSHConfig(n_tables=8, n_bits=6, seed=1)
    db = _clear_db(cfg, n=1024)
    q = _clear_queries(cfg, db, 12, seed=4)
    j, p = _both(cfg, db)
    for k in (4, 32, 1000):  # 1000 > the 8 buckets' union: dead slots
        want = j.topk_batch(jnp.asarray(q), k)
        got = p.topk_batch(_t(q), k)
        wv, gv = np.asarray(want.values), got.values.numpy()
        np.testing.assert_array_equal(np.isneginf(gv), np.isneginf(wv))
        live = ~np.isneginf(wv)
        np.testing.assert_array_equal(got.ids.numpy()[live],
                                      np.asarray(want.ids)[live])
        np.testing.assert_allclose(gv[live], wv[live], **TOL)
        assert (got.ids.numpy()[~live] == -1).all()
    np.testing.assert_allclose(p.bucket_log_probs(_t(q)).numpy(),
                               np.asarray(j.bucket_log_probs(jnp.asarray(q))),
                               **TOL)


# ----------------------------------------- the reference's tests, ported
def test_lsh_recall_at_one():
    db = _t(_db(n=1024, d=32))
    index = mips.build_index(mips.LSHConfig(n_tables=12, n_bits=6), db)
    exact = mips.build_index(mips.ExactConfig(), db)
    r = np.random.default_rng(0)
    hits = 0
    for _ in range(30):
        q = db[int(r.integers(0, 1024))] + 0.2 * _t(
            r.standard_normal(32).astype(np.float32))
        got = set(index.topk(q, 4).ids.tolist())
        hits += int(exact.topk(q, 1).ids[0]) in got
    assert hits >= 24, hits  # >= 80 % recall@1-in-top-4


def test_lsh_no_duplicate_candidates():
    index = mips.build_index(mips.LSHConfig(n_tables=8, n_bits=6),
                             _t(_db(n=512, d=16)))
    q = _t(np.random.default_rng(14).standard_normal(16).astype(np.float32))
    ids = index.topk(q, 32).ids.numpy()
    valid = ids[ids >= 0]
    assert len(valid) == len(set(valid.tolist()))


def test_lsh_refresh_preserves_structure():
    db = _t(_db(n=512, d=16))
    index = mips.build_index(mips.LSHConfig(n_tables=4, n_bits=5), db)
    db2 = db + 0.1 * torch.randn(db.shape, generator=torch.Generator()
                                 .manual_seed(21))
    refreshed = index.refresh(db2)
    for a, b in zip(index.state, refreshed.state):
        assert a.shape == b.shape and a.dtype == b.dtype
    torch.testing.assert_close(refreshed.proj, index.proj, rtol=0, atol=0)


def _union_bruteforce(index, q):
    """The query's colliding buckets, uncapped (host numpy)."""
    db_aug, proj = index.db_aug.numpy(), index.proj.numpy()
    q_aug = np.concatenate([q, [0.0]]).astype(np.float32)
    pows = 1 << np.arange(index.n_bits)
    union: set[int] = set()
    for t in range(index.n_tables):
        q_code = int(((q_aug @ proj[t] >= 0) * pows).sum())
        codes = ((db_aug @ proj[t] >= 0) * pows).sum(axis=1)
        union |= set(np.flatnonzero(codes == q_code).tolist())
    return union


@settings(max_examples=15, deadline=None)
@given(n=st.integers(64, 256), n_bits=st.integers(2, 5),
       n_tables=st.integers(2, 6), seed=st.integers(0, 10_000))
def test_lsh_counts_are_true_bucket_loads(n, n_bits, n_tables, seed):
    """``counts`` are the uncapped loads whatever the cap, and
    ``dropped_count`` the overflow past it."""
    cap = max(1, n // (2 ** (n_bits + 1)))  # deliberately lossy
    index = mips.build_index(
        mips.LSHConfig(n_tables=n_tables, n_bits=n_bits, bucket_cap=cap,
                       seed=seed), _t(_db(n=n, d=8, seed=seed % 7)))
    counts = index.counts.numpy()
    assert counts.shape == (n_tables, 2**n_bits)
    assert (counts.sum(axis=1) == n).all()
    db_aug, proj = index.db_aug.numpy(), index.proj.numpy()
    pows = 1 << np.arange(n_bits)
    for t in range(n_tables):
        codes = ((db_aug @ proj[t] >= 0) * pows).sum(axis=1)
        np.testing.assert_array_equal(counts[t],
                                      np.bincount(codes, minlength=2**n_bits))
    kept = index.table_ids.numpy()
    assert int((kept >= 0).sum()) == int(np.minimum(counts, cap).sum())
    assert index.dropped_count == int(np.maximum(counts - cap, 0).sum())
    assert mips.index_spill_parts(index) == (index.dropped_count, 0)


@settings(max_examples=15, deadline=None)
@given(n=st.integers(64, 256), n_bits=st.integers(2, 5),
       n_tables=st.integers(2, 6), seed=st.integers(0, 10_000))
def test_lsh_lossless_cap_candidates_unbiased(n, n_bits, n_tables, seed):
    """With a lossless cap the padded ``topk_batch`` returns exactly the
    top-k of the uncapped bucket union."""
    db = _db(n=n, d=8, seed=seed % 7)
    index = mips.build_index(
        mips.LSHConfig(n_tables=n_tables, n_bits=n_bits, bucket_cap=n,
                       seed=seed), _t(db))
    assert index.dropped_count == 0
    q = np.random.default_rng(seed + 1).standard_normal(8).astype(np.float32)
    union = _union_bruteforce(index, q)
    k = 16
    tk = index.topk(_t(q), k)
    ids, vals = tk.ids.numpy(), tk.values.numpy()
    scores = db @ q
    want = set(sorted(union, key=lambda i: -scores[i])[: min(k, len(union))])
    assert set(ids[ids >= 0].tolist()) == want
    assert int((ids >= 0).sum()) == min(k, len(union))
    assert np.isneginf(vals[ids < 0]).all()


# ------------------------------------------------------------ the sampler
def _sampler_pair(cfg, db):
    jidx = jmips.build_index(cfg, jnp.asarray(db))
    state = lsh_state_from_jax(jax.device_get(jax.tree.leaves(jidx)))
    return jidx, mips.LSHIndex(mips.LSHConfig(**vars(cfg)), state)


@pytest.mark.parametrize("per_table", [False, True])
def test_lsh_sampler_matches_reference(per_table, monkeypatch):
    """``bucket_cap = n``: the dense path (every row scored once)."""
    cfg = jmips.LSHConfig(n_tables=8, n_bits=4, bucket_cap=1024, seed=2)
    db = _db(n=1024, d=16, seed=9)
    h = (db[[3, 100, 700]] * 4.0).astype(np.float32)
    jidx, pidx = _sampler_pair(cfg, db)
    want = np.asarray(jest.lsh_sampler_logz(jidx, jnp.asarray(h),
                                            per_table=per_table))
    got = est.lsh_sampler_logz(pidx, _t(h), per_table=per_table)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the table chunking does not change the estimate: one table a chunk
    monkeypatch.setattr(est, "_LSH_CHUNK_BYTES", len(h) * 1024 * 16)
    one = est.lsh_sampler_logz(pidx, _t(h), per_table=per_table)
    torch.testing.assert_close(one, got, rtol=0, atol=0)


@pytest.mark.parametrize("per_table", [False, True])
def test_lsh_sampler_candidate_path_matches_reference(per_table):
    """``L·cap < n``: only the live candidates are scored, each once, and
    every table's repeat of a row takes that one weight."""
    cfg = jmips.LSHConfig(n_tables=8, n_bits=4, bucket_cap=96, seed=2)
    db = _db(n=1024, d=16, seed=9)
    h = (db[[3, 100, 700, 5]] * 4.0).astype(np.float32)
    jidx, pidx = _sampler_pair(cfg, db)
    assert pidx.n_tables * pidx.bucket_cap < db.shape[0]
    want = np.asarray(jest.lsh_sampler_logz(jidx, jnp.asarray(h),
                                            per_table=per_table))
    got = est.lsh_sampler_logz(pidx, _t(h), per_table=per_table)
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_first_slots_points_each_slot_at_its_ids_first_slot():
    from repro_torch.core.mips.lsh import first_slots

    cand = np.random.default_rng(3).integers(-1, 12, size=(5, 40))
    got = first_slots(torch.from_numpy(cand)).numpy()
    for row, g in zip(cand, got):
        want = [list(row).index(v) for v in row]
        np.testing.assert_array_equal(g, want)


def test_lsh_sampler_min_bit_prob_and_empty_buckets():
    """A lossy cap leaves some buckets without members (-inf per-table
    estimates); ``min_bit_prob`` floors the per-bit probability exactly as
    the reference floors it."""
    cfg = jmips.LSHConfig(n_tables=6, n_bits=5, bucket_cap=2, seed=4)
    db = _db(n=256, d=8, seed=2)
    h = -(db[:5] * 6.0)
    jidx, pidx = _sampler_pair(cfg, db)
    for mbp in (1e-7, 0.3):
        want = np.asarray(jest.lsh_sampler_logz(
            jidx, jnp.asarray(h), per_table=True, min_bit_prob=mbp))
        got = est.lsh_sampler_logz(pidx, _t(h), per_table=True,
                                   min_bit_prob=mbp).numpy()
        np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
        fin = np.isfinite(want)
        np.testing.assert_allclose(got[fin], want[fin], **TOL)


LSH_TABLES, LSH_BITS, LSH_REPS = 64, 4, 120
N, D = 1024, 16


def _problem(seed):
    """The reference's problem: a clustered table made by JAX, h = row 7
    times 4."""
    k1, k2, k3 = jax.random.split(jax.random.key(seed), 3)
    centers = jax.random.normal(k1, (32, D))
    assign = jax.random.randint(k2, (N,), 0, 32)
    db = centers[assign] + 0.5 * jax.random.normal(k3, (N, D))
    db = np.asarray(db / jnp.linalg.norm(db, axis=1, keepdims=True))
    return db, db[7] * 4.0


def _lsh_exact_moments(db_aug, h, w):
    """Exact (Z, Var Z_t) for one SRP table (the triple-orthant identity,
    as in tests/test_estimator_stats.py)."""
    x = np.asarray(db_aug, np.float64)
    xn = x / np.linalg.norm(x, axis=1, keepdims=True)
    q = np.concatenate([np.asarray(h, np.float64), [0.0]])
    qn = q / np.linalg.norm(q)
    t_q = np.arccos(np.clip(xn @ qn, -1, 1))
    q1 = (1 - t_q / np.pi) ** LSH_BITS
    t_xx = np.arccos(np.clip(xn @ xn.T, -1, 1))
    p3 = np.clip(1 - (t_q[:, None] + t_q[None, :] + t_xx) / (2 * np.pi), 0, 1)
    ww = w / q1
    ez2 = (ww[:, None] * ww[None, :] * p3**LSH_BITS).sum()
    z = w.sum()
    return z, ez2 - z * z


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_lsh_sampler_unbiased_and_calibrated(seed):
    """The reference's statistical test on the port: unbiased in Z, and
    CLT / Chebyshev intervals from the EXACT per-table variance cover."""
    db, h = _problem(seed)
    w = np.exp(np.asarray(db @ h, np.float64))
    z_hat = []
    for r in range(LSH_REPS):
        index = mips.build_index(mips.LSHConfig(
            n_tables=LSH_TABLES, n_bits=LSH_BITS, bucket_cap=N,
            seed=1000 + r), _t(db))
        assert index.dropped_count == 0
        lz = est.lsh_sampler_logz(index, _t(h)[None])
        z_hat.append(float(np.exp(lz.double().numpy()[0])))
    z_hat = np.array(z_hat)
    z, var_t = _lsh_exact_moments(index.db_aug.numpy(), h, w)
    sigma = np.sqrt(var_t / LSH_TABLES)
    sem = sigma / np.sqrt(LSH_REPS)
    assert abs(z_hat.mean() - z) < 5 * sem, (z_hat.mean(), z, sem)
    ratio = z_hat.var(ddof=1) / sigma**2
    assert 0.4 < ratio < 2.2, ratio
    err = np.abs(z_hat - z)
    slack = 3 * np.sqrt(0.05 * 0.95 / LSH_REPS)
    assert (err <= 1.96 * sigma).mean() >= 0.95 - slack - 0.02
    assert (err <= sigma / np.sqrt(0.05)).mean() >= 0.95 - slack


# ------------------------------------------------------------ the head
def test_head_bucket_sizing_matches_reference():
    """The head sizes its buckets as the reference does: max(the load
    default, enough for the tables' union to cover k); 144 at
    tinyllama's head (n 32,000, k 576)."""
    for n, k in ((32000, 576), (4096, 0), (6000, 64)):
        db = np.zeros((n, 4), np.float32)
        db[:, 0] = 1.0
        jcfg = JHeadConfig(n=n, k=k, mode="amortized", mips="lsh")
        want = jmake_index(jcfg, jnp.asarray(db)).bucket_cap
        got = make_index(HeadConfig(n=n, k=k, mode="amortized", mips="lsh"),
                         _t(db), device="cpu")
        assert got.bucket_cap == want
        if (n, k) == (32000, 576):
            assert want == 144


ARCH = "tinyllama-1.1b"


def test_serve_launcher_lsh(capsys):
    """``--mips lsh`` serves on the CPU with the reference launcher's
    report, fused and unfused giving the same tokens' count; the index is
    reported."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve_launcher.main(
            ["--arch", ARCH, "--smoke", "--vocab", "4096", "--mips", "lsh",
             "--device", "cpu", "--requests", "3", "--slots", "2",
             "--new-tokens", "4", "--max-seq", "64", "--fused-decode"])
    rep = json.loads(out.getvalue())
    assert rep["requests"] == 3 and rep["decoded_tokens"] == 12
    assert rep["index_mb"] > 0 and 0.0 <= rep["ok_rate"] <= 1.0


def _train(tmp_path, capsys, steps):
    train_launcher.main(
        ["--arch", ARCH, "--smoke", "--vocab", "4096", "--mips", "lsh",
         "--steps", str(steps), "--batch", "2", "--seq", "16",
         "--index-refresh-every", "2", "--ckpt-every", "2",
         "--device", "cpu", "--workdir", str(tmp_path)])
    return json.loads(capsys.readouterr().out)


def test_train_launcher_lsh_resume_is_bitwise(tmp_path, capsys):
    """``--mips lsh`` trains and refreshes; the checkpoint carries the
    drift snapshot alone, and a resume from step 2 rebuilds the very tables
    (same projections, same rows): its step-3 loss equals the
    uninterrupted run's bit for bit."""
    from repro_torch.checkpoint import manager

    full = _train(tmp_path, capsys, 3)
    assert full["index_refreshes"] == 1 and math.isfinite(full["loss"])
    st_, _, _ = manager.restore(str(tmp_path), step=2)
    assert set(st_["index"]) == {"db"}
    shutil.rmtree(tmp_path / "ckpt_00000003")
    resumed = _train(tmp_path, capsys, 3)
    assert resumed["step"] == 3 and resumed["loss"] == full["loss"]
