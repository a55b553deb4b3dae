"""The port's certificate-gated adaptive probe (``core/mips/adaptive.py``,
``IVFIndex.topk_adaptive``, ``IVFPQIndex.topk_adaptive``) against the JAX
package, and the index-level invariants of tests/test_adaptive.py (without
the router and the anisotropic codebooks, which are not in the port yet):

* the schedule, the unprobed-bound table and the staged loop against
  JAX's, the loop on a synthetic stage function;
* the unfused ``topk_adaptive`` on a JAX-built index carried across
  (``convert.ivf_state_from_jax`` / ``pq_state_from_jax``): ids, width and
  certificate exactly;
* the degenerate schedule (init == max) equals ``topk_batch`` bit for bit;
  the fused route (the screens' plain versions here) equals the unfused;
* widening never lowers the certificate's pass rate; the bound dominates
  every unprobed score; a spill voids the certificate.

Also: the single-query ``Index.topk`` of the three backends against JAX's,
``LogLinearConfig`` against the reference's, and the package's import
order (``repro_torch.core`` exports the reference's names, and a fresh
``import repro_torch.core.mips`` works).

Tolerances: ids, widths and flags exact; fp32 values rtol=atol=1e-5.
"""
import dataclasses
import math
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import paper_loglinear as jpaper
from repro.core import mips as jmips
from repro.core.mips import adaptive as jadaptive
from repro_torch.configs import paper_loglinear
from repro_torch.convert import ivf_state_from_jax, pq_state_from_jax
from repro_torch.core import mips
from repro_torch.core.mips import adaptive, base
from repro_torch.core.mips.adaptive import stage_widths
from repro_torch.core.quant.kmeans import assign_clusters

# one intra-op thread: the suite runs six workers on the same cores
torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
N, D, T, K = 4096, 32, 16, 64
N_PROBE = 8
SRC = Path(__file__).resolve().parents[1] / "src"


def _t(x):
    return torch.from_numpy(np.array(x))


def _db(n=N, d=D, seed=0):
    """Unit rows around 32 centres (tests/test_adaptive.py's problem)."""
    r = np.random.default_rng(seed)
    centers = r.standard_normal((32, d))
    db = centers[r.integers(0, 32, n)] + 0.3 * r.standard_normal((n, d))
    return (db / np.linalg.norm(db, axis=1, keepdims=True)).astype(np.float32)


def _queries(db, t=T, temp=0.05, seed=1):
    """θ = dataset rows / τ (paper §4.1.2)."""
    r = np.random.default_rng(seed)
    return (db[r.integers(0, db.shape[0], t)] / temp).astype(np.float32)


def _cfgs(kind, **over):
    """(JAX config, port config) of one index."""
    if kind == "ivf":
        kw = dict(n_clusters=32, kmeans_iters=4, n_probe=N_PROBE, **over)
        return jmips.IVFConfig(**kw), mips.IVFConfig(**kw)
    kw = dict(n_clusters=32, kmeans_iters=4, m_sub=4, pq_iters=4,
              rerank=2 * K, n_probe=N_PROBE, **over)
    return jmips.PQConfig(**kw), mips.PQConfig(**kw)


def _pair(db, kind, **over):
    """A JAX-built index and the port's index on its state."""
    jcfg, cfg = _cfgs(kind, **over)
    jindex = jmips.build_index(jcfg, jnp.asarray(db))
    state = jax.device_get(jindex.state)
    if kind == "ivf":
        return jindex, mips.IVFIndex(cfg, ivf_state_from_jax(state))
    return jindex, mips.IVFPQIndex(cfg, pq_state_from_jax(state, _t(db)))


@pytest.fixture(scope="module")
def pairs():
    db = _db()
    return db, {kind: _pair(db, kind) for kind in ("ivf", "ivfpq")}


# ------------------------------------------------ schedule, bound, loop
def test_stage_widths_match_jax():
    for init, top in [(2, 32), (1, 1), (3, 20), (8, 8), (0, 5), (9, 4),
                      (5, 64)]:
        assert stage_widths(init, top) == jadaptive.stage_widths(init, top)
    assert stage_widths(2, 32) == (2, 4, 8, 16, 32)


def test_unprobed_bound_table_matches_jax():
    r = np.random.default_rng(2)
    b, n_c = 6, 20
    c_scores = r.standard_normal((b, n_c)).astype(np.float32) * 3
    radii = np.abs(r.standard_normal(n_c)).astype(np.float32)
    radii[[3, 11]] = -np.inf  # empty clusters bound nothing
    qf = r.standard_normal((b, 8)).astype(np.float32)
    want = np.asarray(jadaptive.unprobed_bound_table(
        jnp.asarray(c_scores), jnp.asarray(radii), jnp.asarray(qf)))
    got = adaptive.unprobed_bound_table(_t(c_scores), _t(radii), _t(qf))
    assert got.shape == (b, n_c + 1)
    np.testing.assert_array_equal(np.isneginf(got.numpy()), np.isneginf(want))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    g = got.numpy()
    assert np.all(g[:, :-1] >= g[:, 1:])  # a suffix max


def _synthetic(b, k, n_c, cap, seed):
    """A pool of b rows x n_c·cap scores, a bound table that falls with the
    width, and the two frameworks' stage functions over them: the top-k of
    each row's first ``w · cap`` slots."""
    r = np.random.default_rng(seed)
    pool = r.standard_normal((b, n_c * cap)).astype(np.float32)
    table = np.sort(r.standard_normal((b, n_c + 1)) * 0.3
                    + np.linspace(2.0, -2.0, n_c + 1), axis=1
                    )[:, ::-1].astype(np.float32).copy()
    table[:, -1] = -np.inf
    slot = np.arange(n_c * cap)
    jpool = jnp.asarray(pool)

    def j_stage(w):
        live = jnp.asarray(slot)[None, :] < (w * cap)[:, None]
        vals, pos = jax.lax.top_k(jnp.where(live, jpool, -jnp.inf), k)
        return vals, pos.astype(jnp.int32)

    def t_stage(w):
        live = torch.arange(n_c * cap)[None, :] < (w * cap)[:, None]
        vals, pos = base.top_k(torch.where(live, _t(pool),
                                           torch.tensor(-math.inf)), k)
        return vals, pos.int()

    return table, j_stage, t_stage


@pytest.mark.parametrize("c", [0.0, 0.5])
@pytest.mark.parametrize("no_spill", [True, False])
@pytest.mark.parametrize("routed", [False, True])
def test_staged_widen_matches_jax(c, no_spill, routed):
    b, k, n_c, cap = 12, 5, 16, 4
    table, j_stage, t_stage = _synthetic(b, k, n_c, cap, seed=3)
    widths = stage_widths(1, n_c)
    init = (np.random.default_rng(4).integers(-1, len(widths) + 1, b)
            if routed else None)
    want = jadaptive.staged_widen(
        j_stage, jnp.asarray(table), widths, k, c=c, no_spill=no_spill,
        init_stage=None if init is None else jnp.asarray(init))
    got = adaptive.staged_widen(
        t_stage, _t(table), widths, k, c=c, no_spill=no_spill,
        init_stage=None if init is None else _t(init))
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    np.testing.assert_array_equal(got.width.numpy(), np.asarray(want.width))
    np.testing.assert_array_equal(got.certified.numpy(),
                                  np.asarray(want.certified))
    if not no_spill:
        assert not got.certified.any()
    else:  # the problem mixes stopping stages
        assert len(set(got.width.tolist())) > 1


# ------------------------------------------------- topk_adaptive vs JAX
@pytest.mark.parametrize("kind", ["ivf", "ivfpq"])
@pytest.mark.parametrize("c", [0.0, 1.0])
def test_topk_adaptive_on_jax_state_matches_jax(pairs, kind, c):
    db, by_kind = pairs
    jindex, index = by_kind[kind]
    q = _queries(db, t=32, seed=5)
    want = jindex.topk_adaptive(jnp.asarray(q), K, c=c, n_probe_init=2,
                                n_probe_max=32)
    got = index.topk_adaptive(_t(q), K, c=c, n_probe_init=2, n_probe_max=32)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_allclose(got.values.numpy(), np.asarray(want.values),
                               **TOL)
    np.testing.assert_array_equal(got.width.numpy(), np.asarray(want.width))
    np.testing.assert_array_equal(got.certified.numpy(),
                                  np.asarray(want.certified))
    assert len(set(got.width.tolist())) > 1  # mixed stopping widths


@pytest.mark.parametrize("kind", ["ivf", "ivfpq"])
def test_degenerate_schedule_equals_topk_batch_bitwise(pairs, kind):
    db, by_kind = pairs
    _, index = by_kind[kind]
    q = _t(_queries(db, seed=6))
    fixed = index.topk_batch(q, K)
    for fused in (False, True):
        atk = index.topk_adaptive(q, K, n_probe_init=N_PROBE,
                                  n_probe_max=N_PROBE, fused=fused)
        assert torch.equal(atk.ids, fixed.ids) and torch.equal(
            atk.values, fixed.values), f"fused={fused}"
        assert (atk.width == N_PROBE).all()


def test_degenerate_schedule_on_the_kernel_route_equals_topk_batch():
    """IVF with ``use_kernel``: the pool through ``ivf_gather_score``'s
    plain version on both sides."""
    db = _db(seed=7)
    _, index = _pair(db, "ivf", use_kernel=True)
    q = _t(_queries(db, seed=8))
    fixed = index.topk_batch(q, K)
    atk = index.topk_adaptive(q, K, n_probe_init=N_PROBE, n_probe_max=N_PROBE)
    assert torch.equal(atk.ids, fixed.ids)
    assert torch.equal(atk.values, fixed.values)


@pytest.mark.parametrize("kind", ["ivf", "ivfpq"])
@pytest.mark.parametrize("c", [0.0, 1.0])
def test_fused_route_equals_unfused(pairs, kind, c):
    """Each fused stage is one screen call at the rows' widths (0 for rows
    already done); on the CPU the screens' plain versions."""
    db, by_kind = pairs
    _, index = by_kind[kind]
    q = _t(_queries(db, t=32, seed=9))
    un = index.topk_adaptive(q, K, c=c, n_probe_init=2, n_probe_max=32)
    fu = index.topk_adaptive(q, K, c=c, n_probe_init=2, n_probe_max=32,
                             fused=True)
    for f in un._fields:
        assert torch.equal(getattr(un, f), getattr(fu, f)), f


def test_fused_route_equals_unfused_when_pools_underfill():
    """A pool narrower than k: -inf picks carry id -1 on both routes."""
    db = _db(n=600, seed=10)
    _, index = _pair(db, "ivf")
    q = _t(_queries(db, seed=11))
    k = 400  # two clusters' members and the overflow hold fewer
    un = index.topk_adaptive(q, k, n_probe_init=1, n_probe_max=16)
    fu = index.topk_adaptive(q, k, n_probe_init=1, n_probe_max=16, fused=True)
    assert torch.isneginf(un.values).any()
    assert (un.ids[torch.isneginf(un.values)] == -1).all()
    for f in un._fields:
        assert torch.equal(getattr(un, f), getattr(fu, f)), f


# ----------------------------------- widening and certificate semantics
@pytest.mark.parametrize("kind", ["ivf", "ivfpq"])
def test_certificate_pass_rate_monotone_in_width(kind):
    db = _db(seed=12)
    _, index = _pair(db, kind)
    q = _t(_queries(db, t=32, seed=13))
    rates = [index.topk_adaptive(q, K, c=1.0, n_probe_init=w,
                                 n_probe_max=w).certified.float().mean().item()
             for w in stage_widths(2, 32)]
    assert all(b >= a for a, b in zip(rates, rates[1:])), rates
    assert rates[-1] > rates[0], rates


def test_staged_widen_stops_at_certified_width():
    """Widths land on schedule stages, and a staged query returns the ids
    of probing at its width directly."""
    db = _db(seed=14)
    _, index = _pair(db, "ivf", n_probe_init=2, n_probe_max=32)
    q = _t(_queries(db, t=32, seed=15))
    atk = index.topk_adaptive(q, K, c=1.0)
    assert set(atk.width.tolist()) <= set(stage_widths(2, 32))
    for w in sorted(set(atk.width.tolist())):
        sel = atk.width == w
        single = index.topk_adaptive(q, K, c=1.0, n_probe_init=w,
                                     n_probe_max=w)
        assert torch.equal(atk.ids[sel], single.ids[sel])


def test_unprobed_bound_dominates_unprobed_scores():
    db = _db(seed=16)
    _, index = _pair(db, "ivf")
    st = index.state
    qf = _t(_queries(db, t=8, seed=17))
    c_scores = qf @ st.centroids.T
    table = adaptive.unprobed_bound_table(c_scores, st.radii, qf)
    order = torch.argsort(-c_scores, dim=1, stable=True)
    assign = assign_clusters(_t(db), st.centroids)
    scores = qf @ _t(db).T
    for t in range(qf.shape[0]):
        for w in (1, 4, 16):
            mask = torch.isin(assign, order[t, w:])
            if mask.any():
                assert table[t, w] >= scores[t, mask].max() - 1e-4
    assert torch.isneginf(table[:, st.n_clusters]).all()


@pytest.mark.parametrize("fused", [False, True])
def test_spill_voids_certificate(fused):
    """A build that dropped rows never certifies: the bound cannot see
    them."""
    db = _db(seed=18)
    index = mips.build_index(mips.IVFConfig(
        n_clusters=32, kmeans_iters=4, n_probe=N_PROBE, cap_factor=0.25,
        overflow_frac=1.0 / 1024), _t(db))
    assert int(index.state.spill_count) > 0
    atk = index.topk_adaptive(_t(_queries(db, t=8, seed=19)), K, c=100.0,
                              n_probe_init=2, n_probe_max=32, fused=fused)
    assert not atk.certified.any()
    assert (atk.width == 32).all()


# ----------------------------------------- single query, config, imports
@pytest.mark.parametrize("kind", ["exact", "ivf", "ivfpq"])
def test_single_query_topk_matches_jax(pairs, kind):
    db, by_kind = pairs
    q = _queries(db, t=1, seed=20)[0]
    if kind == "exact":
        jindex = jmips.build_index(jmips.ExactConfig(), jnp.asarray(db))
        index = mips.build_index(mips.ExactConfig(), _t(db))
    else:
        jindex, index = by_kind[kind]
    want = jindex.topk(jnp.asarray(q), K)
    got = index.topk(_t(q), K)
    assert got.ids.shape == (K,)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_allclose(got.values.numpy(), np.asarray(want.values),
                               **TOL)
    batch = index.topk_batch(_t(q)[None], K)
    assert torch.equal(got.ids, batch.ids[0])


def test_log_linear_config_matches_reference():
    for name in ("IMAGENET", "WORD_EMBEDDINGS", "IMAGENET_BENCH",
                 "WORDS_BENCH", "CONFIG"):
        got = getattr(paper_loglinear, name)
        want = getattr(jpaper, name)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), name
    assert ([f.name for f in dataclasses.fields(paper_loglinear
                                                .LogLinearConfig)]
            == [f.name for f in dataclasses.fields(jpaper.LogLinearConfig)])


@pytest.mark.parametrize("module", ["repro_torch.core.mips",
                                    "repro_torch.core.mips.adaptive",
                                    "repro_torch.core"])
def test_fresh_import_and_exports(module):
    """Each module imports first in a fresh interpreter (the package's
    ``__init__`` pulls the head, which pulls the indexes), without JAX, and
    the package exports the reference's names."""
    code = (f"import sys, {module}; import repro_torch.core as c; "
            "from repro_torch.core import mips; "
            "assert mips.IVFIndex.topk_adaptive; "
            "assert 'jax' not in sys.modules and 'repro' not in sys.modules; "
            "print(' '.join(sorted(c.__all__)))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": str(SRC)}, timeout=120)
    assert out.returncode == 0, out.stderr
    from repro import core as jcore
    assert out.stdout.split() == sorted(jcore.__all__)
