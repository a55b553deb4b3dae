"""The port's ``ShardedIndex`` (``repro_torch.core.mips.sharded``) on
spawned gloo ranks against the reference's, over the exact, IVF, IVF-PQ
and LSH backends at mp 2 and 4.

The reference's ShardedIndex builds each shard as its backend over that
shard's contiguous slice; the test does the same in JAX, slice by slice,
from the same initial centroids (and codebooks), and holds each rank's
shard to it. The global queries run on a ShardedIndex carried across from
the reference's stacked state (``convert.sharded_index_from_jax``) and are
held to the per-slice reference results merged in the reference's order
(shard-major within a query, then ``lax.top_k``): ids exact, values fp32
allclose; ``topk_adaptive``'s width the max and certified the AND over
shards. ``memory_bytes`` equals the reference's (mp times one shard's),
``refresh`` keeps every state shape and ``n % mp != 0`` raises.

Tolerances: ids, member tables and codes exact; centroids, codebooks and
radii atol 1e-5 (as in the single-device build tests); values rtol=atol
1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist as td
from repro.core import mips as jmips
from repro.core.mips import ivf as jivf
from repro.core.mips import pq as jpq
from repro_torch.core import mips

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
N_LOC, D, K = 512, 16, 32  # rows a shard: one shape, so JAX compiles once
ADAPT = dict(c=0.0, n_probe_init=1, n_probe_max=8)
BACKENDS = ("exact", "ivf", "ivfpq", "lsh")


def _db(n, seed=0):
    r = np.random.default_rng(seed)
    centers = r.standard_normal((32, D))
    db = centers[r.integers(0, 32, n)] + 0.5 * r.standard_normal((n, D))
    return (db / np.linalg.norm(db, axis=1, keepdims=True)).astype(np.float32)


def _jax_shard(backend, sl, s):
    """The reference backend over one slice -> (stacked-state children of
    this shard, port config, jax index, per-shard port init kwargs)."""
    if backend == "exact":
        return (sl,), mips.ExactConfig(), jmips.ExactIndex(
            jmips.ExactConfig(), jnp.asarray(sl)), {}
    if backend == "ivf":
        jcfg = jivf.IVFConfig(n_probe=4)
        n_c, cap, o_cap = jivf._geometry(sl.shape[0], jcfg)
        init = sl[np.asarray(jax.random.permutation(
            jax.random.key(jcfg.seed), sl.shape[0])[:n_c])]
        st = jivf._device_build(jnp.asarray(sl), jnp.asarray(init), n_c=n_c,
                                cap=cap, o_cap=o_cap,
                                iters=jcfg.kmeans_iters, seed=jcfg.seed)
        st = jax.device_get(st)
        return ((st,), mips.IVFConfig(n_probe=4),
                jivf.IVFIndex(jcfg, jax.tree.map(jnp.asarray, st)),
                {"init_cent": init})
    if backend == "ivfpq":
        jcfg = jpq.PQConfig(m_sub=4, ksub=16, n_probe=4)
        n_c, cap, o_cap, ksub = jpq._pq_geometry(*sl.shape, jcfg)
        r = np.random.default_rng(10 + s)
        init = sl[r.permutation(sl.shape[0])[:n_c]]
        cb = (r.standard_normal((4, ksub, D // 4)) * 0.2).astype(np.float32)
        parts = jpq._device_build(
            jnp.asarray(sl), jnp.asarray(init), jnp.asarray(cb), n_c=n_c,
            cap=cap, o_cap=o_cap, m_sub=4, ksub=ksub,
            iters=jcfg.kmeans_iters, pq_iters=jcfg.pq_iters, seed=jcfg.seed)
        st = jpq.IVFPQIndex._assemble(jcfg, parts, jnp.asarray(sl))
        return ((jax.device_get(st),),
                mips.PQConfig(m_sub=4, ksub=16, n_probe=4),
                jpq.IVFPQIndex(jcfg, st),
                {"init_cent": init, "init_codebooks": cb})
    cfg = mips.LSHConfig(n_tables=6, n_bits=5, seed=3)
    j = jmips.build_index(jmips.LSHConfig(**vars(cfg)), jnp.asarray(sl))
    return (tuple(np.asarray(x) for x in (j.proj, j.table_ids, j.db_aug,
                                           j.counts)), cfg, j, {})


def _stack(parts):
    """Per-shard children -> the reference's stacked ShardedIndex state."""
    return jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]),
                        *parts)


def _merge(vals, gids, k):
    """The reference's cross-shard merge (sharded.py topk_batch)."""
    b = vals.shape[1]
    av = jnp.moveaxis(jnp.asarray(vals), 0, 1).reshape(b, -1)
    ag = jnp.moveaxis(jnp.asarray(gids), 0, 1).reshape(b, -1)
    v, pos = jax.lax.top_k(av, k)
    return np.asarray(jnp.take_along_axis(ag, pos, axis=1)), np.asarray(v)


def _reference(backend, mp, db, q):
    n_loc = N_LOC
    parts, jidx, inits = [], [], []
    for s in range(mp):
        ch, cfg, j, init = _jax_shard(backend, db[s * n_loc:(s + 1) * n_loc],
                                      s)
        parts.append(ch)
        jidx.append(j)
        inits.append(init)
    vals, gids, ws, cs = [], [], [], []
    for s, j in enumerate(jidx):
        res = (j.topk_adaptive(jnp.asarray(q), K, **ADAPT)
               if backend in ("ivf", "ivfpq") else None)
        tk = j.topk_batch(jnp.asarray(q), K)
        ids = np.asarray(tk.ids)
        gids.append(np.where(ids >= 0, ids + s * n_loc, -1))
        vals.append(np.where(ids >= 0, np.asarray(tk.values), -np.inf))
        if res is not None:
            ws.append(res)
    want = {"topk": _merge(np.stack(vals), np.stack(gids), K),
            "memory_bytes": mp * jidx[0].memory_bytes(), "parts": parts}
    if ws:
        av = np.stack([np.where(np.asarray(a.ids) >= 0, np.asarray(a.values),
                                -np.inf) for a in ws])
        ag = np.stack([np.where(np.asarray(a.ids) >= 0,
                                np.asarray(a.ids) + s * n_loc, -1)
                       for s, a in enumerate(ws)])
        ids, v = _merge(av, ag, K)
        want["adaptive"] = (ids, v,
                            np.stack([np.asarray(a.width) for a in ws]).max(0),
                            np.stack([np.asarray(a.certified)
                                      for a in ws]).all(0))
    init = {k: np.stack([i[k] for i in inits]) for k in inits[0]}
    case = {"config": cfg, "db": db, "init": init, "jax_state": _stack(parts),
            "q": q, "k": K, "adaptive": ADAPT if ws else None}
    return case, want


@pytest.fixture(scope="module", params=[2, 4])
def run(request, tmp_path_factory):
    mp = request.param
    db = _db(N_LOC * mp, mp)
    q = (np.random.default_rng(mp + 1).standard_normal((6, D)) * 3).astype(
        np.float32)
    cases, wants = zip(*(_reference(b, mp, db, q) for b in BACKENDS))
    outs = td.spawn(td.sharded_index_cases, tmp_path_factory.mktemp("shix"),
                    1, mp, list(cases))
    return mp, dict(zip(BACKENDS, wants)), outs


def _state_close(got, want_children, backend):
    if backend == "exact":
        np.testing.assert_array_equal(got, want_children[0])
        return
    if backend == "lsh":
        for g, w in zip(got, want_children):
            np.testing.assert_array_equal(g, w)
        return
    st = want_children[0]
    for name in st._fields:
        g, w = np.asarray(getattr(got, name)), np.asarray(getattr(st, name))
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("backend", BACKENDS)
def test_shard_state_equals_reference_slice(run, backend):
    mp, wants, outs = run
    for m, o in enumerate(outs):
        res = o[BACKENDS.index(backend)]
        assert res["offset"] == m * N_LOC
        _state_close(res["state"], wants[backend]["parts"][m], backend)


@pytest.mark.parametrize("backend", BACKENDS)
def test_topk_batch_merges_in_reference_order(run, backend):
    mp, wants, outs = run
    ids, vals = wants[backend]["topk"]
    for o in outs:
        res = o[BACKENDS.index(backend)]
        np.testing.assert_array_equal(res["topk"][0], ids)
        np.testing.assert_allclose(res["topk"][1], vals, **TOL)
        np.testing.assert_array_equal(res["topk_one"][0], ids[0])


@pytest.mark.parametrize("backend", ["ivf", "ivfpq"])
def test_topk_adaptive_width_max_certified_and(run, backend):
    mp, wants, outs = run
    ids, vals, width, cert = wants[backend]["adaptive"]
    for o in outs:
        got = o[BACKENDS.index(backend)]["adaptive"]
        np.testing.assert_array_equal(got[0], ids)
        np.testing.assert_allclose(got[1], vals, **TOL)
        np.testing.assert_array_equal(got[2], width)
        np.testing.assert_array_equal(got[3], cert)


@pytest.mark.parametrize("backend", BACKENDS)
def test_memory_refresh_and_divisibility(run, backend):
    mp, wants, outs = run
    for o in outs:
        res = o[BACKENDS.index(backend)]
        assert res["memory_bytes"] == wants[backend]["memory_bytes"]
        assert res["refresh_same_shapes"]
        assert res["raises"]
