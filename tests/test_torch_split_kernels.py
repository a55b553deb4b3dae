"""The inputs the split ``flash_decode``, the cluster-major
``ivf_gather_score``, the split ``ivf_screen_select``, ``pq_screen_select``,
``rerank_select`` and ``tail_gather_argmax`` and the ``fused_estimator``
kernels have to get right, held on the CPU: the
plain versions (what the CPU runs in place of the kernels) against the JAX
package at lengths around the kernel's split of the sequence, at probe sets
with repeated and piled-up clusters, at screen pools at and past a power of
two and as wide as k, at survivor counts around the re-rank's chunk of
survivors (dead, duplicate and out-of-range ids among them), at tail
lengths around the tail's chunk of slots (ties across chunks, signed zeros
and all -inf tokens among them), and at the estimator's candidate sets that
share, repeat or clamp rows; and the
wrappers' workspace sizes against a brute-force listing of what the kernels
write there.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``).

Tolerances: ids exact; fp32 values rtol=atol=1e-5 (XLA-CPU and PyTorch
reduce in different orders).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_decode import flash_decode as jax_flash_decode
from repro.kernels.fused_estimator import fused_estimator as jax_fused_estimator
from repro.kernels.ivf_gather_score import ivf_gather_score as jax_ivf_gather_score
from repro_torch.kernels import decode_fused, flash_decode, ivf_gather_score
from repro_torch.kernels import ref

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
SPLIT = flash_decode.SPLIT_ROWS


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("hq,hkv", [(2, 2), (8, 1)], ids=["G1", "G8"])
def test_flash_decode_ref_at_split_edges_matches_jax(hq, hkv):
    """Lengths 0 (uniform over all S rows), 1, split - 1, split, split + 1
    and S, with S not a multiple of the split."""
    rng = np.random.default_rng(3)
    s, hd = 2 * SPLIT + 11, 16
    lens = np.asarray([0, 1, SPLIT - 1, SPLIT, SPLIT + 1, s], np.int32)
    b = lens.size
    q = rng.standard_normal((b, hq, hd), dtype=np.float32)
    k = rng.standard_normal((b, s, hkv, hd), dtype=np.float32)
    v = rng.standard_normal((b, s, hkv, hd), dtype=np.float32)
    want = np.asarray(jref.flash_decode_ref(q, k, v, lens))
    got = ref.flash_decode_ref(_t(q), _t(k), _t(v), _t(lens))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got[0].numpy(), v[0].mean(0).repeat(
        hq // hkv, axis=0), **TOL)


def test_flash_decode_ref_rows_depend_on_their_sequence_only():
    """A sequence computed alone equals its row of a batch (the kernel's
    contract, which the plain version it is held to also keeps), and the
    interpret-mode Pallas kernel agrees with both."""
    rng = np.random.default_rng(4)
    b, s, hq, hkv, hd = 4, 2 * SPLIT, 4, 2, 16
    q = rng.standard_normal((b, hq, hd), dtype=np.float32)
    k = rng.standard_normal((b, s, hkv, hd), dtype=np.float32)
    v = rng.standard_normal((b, s, hkv, hd), dtype=np.float32)
    lens = np.asarray([s, 3, SPLIT + 1, SPLIT], np.int32)
    batch = ref.flash_decode_ref(_t(q), _t(k), _t(v), _t(lens))
    want = jax_flash_decode(q, k, v, lens, s_block=SPLIT, interpret=True)
    np.testing.assert_allclose(batch.numpy(), np.asarray(want), **TOL)
    for i in range(b):
        alone = ref.flash_decode_ref(_t(q[i:i + 1]), _t(k[i:i + 1]),
                                     _t(v[i:i + 1]), _t(lens[i:i + 1]))
        np.testing.assert_allclose(alone[0].numpy(), batch[i].numpy(), **TOL)


@pytest.mark.parametrize("case", ["duplicates", "one_cluster"])
def test_ivf_gather_score_ref_probe_sets_match_jax(case):
    """A query naming a cluster twice gets both slots; every query probing
    one cluster (the pile-up the kernel spreads over several blocks)."""
    rng = np.random.default_rng(5)
    n_c, cap, d, b, n_probe = 6, 8, 128, 20, 3
    mv = rng.standard_normal((n_c, cap, d), dtype=np.float32)
    mids = rng.integers(-1, n_c * cap, (n_c, cap)).astype(np.int32)
    probe = rng.integers(0, n_c, (b, n_probe)).astype(np.int32)
    if case == "duplicates":
        probe[:, 1] = probe[:, 0]
    else:
        probe[:, 2] = 4
    q = rng.standard_normal((b, d), dtype=np.float32)
    want_s, want_i = jax_ivf_gather_score(mv, mids, probe, q, d_block=128,
                                          interpret=True)
    got_s, got_i = ref.ivf_gather_score_ref(_t(mv), _t(mids), _t(probe), _t(q))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **TOL)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    if case == "duplicates":
        np.testing.assert_array_equal(got_s[:, 0].numpy(), got_s[:, 1].numpy())


def _plan_listing(probe: np.ndarray, n_c: int, qc: int):
    """Brute force: the (query, probe slot) pairs of each cluster, in
    increasing pair index, cut into items of at most qc pairs."""
    flat = np.clip(probe.reshape(-1), 0, n_c - 1)
    items = []
    for c in range(n_c):
        pairs = np.flatnonzero(flat == c)
        for i in range(0, pairs.size, qc):
            items.append((c, pairs[i:i + qc]))
    return items


@pytest.mark.parametrize("seed", range(4))
def test_ivf_gather_score_workspace_covers_every_plan(seed):
    """The wrapper's workspace holds the counts, every pair and one record
    per item for any probe set and any queries-per-item from 1 to 16 (the
    kernel's plan), skewed and out-of-range probes included."""
    rng = np.random.default_rng(seed)
    n_c = int(rng.integers(1, 40))
    b = int(rng.integers(1, 300))
    n_probe = int(rng.integers(1, 9))
    weights = 1.0 / np.arange(1, n_c + 1) ** rng.uniform(0, 3)
    probe = rng.choice(n_c, size=(b, n_probe), p=weights / weights.sum())
    probe[rng.random(probe.shape) < 0.05] = n_c + 7
    probe[rng.random(probe.shape) < 0.05] = -3
    ws = ivf_gather_score.workspace_ints(n_c, b, n_probe)
    for qc in range(1, 17):
        items = _plan_listing(probe, n_c, qc)
        assert sum(p.size for _, p in items) == b * n_probe
        assert all(0 < p.size <= qc for _, p in items)
        assert n_c + b * n_probe + 3 * len(items) + 1 <= ws


@pytest.mark.parametrize("s", [1, SPLIT - 1, SPLIT, SPLIT + 1, 2048])
def test_flash_decode_workspace_holds_one_record_per_split(s):
    """One (acc[hd], m, l) record per (sequence, query head, split) of the
    longest possible sequence, S rows."""
    b, hq, hd = 3, 8, 64
    splits = len(range(0, s, SPLIT))
    assert flash_decode.workspace_floats(b, s, hq, hd) == b * hq * splits * (hd + 2)


def _screen_inputs(rng, n_c, cap, d, b, n_probe, o_cap):
    """IVF tables (30 % of the members dead), random probes, queries and an
    overflow a third dead, random fp32."""
    mv = rng.standard_normal((n_c, cap, d), dtype=np.float32)
    mids = rng.integers(0, 1000, (n_c, cap)).astype(np.int32)
    mids[rng.random((n_c, cap)) < 0.3] = -1
    probe = np.stack([rng.permutation(n_c)[:n_probe]
                      for _ in range(b)]).astype(np.int32)
    q = rng.standard_normal((b, d), dtype=np.float32)
    osc = rng.standard_normal((b, o_cap), dtype=np.float32)
    oids = rng.integers(0, 1000, (o_cap,)).astype(np.int32)
    oids[::3] = -1
    return mv, mids, osc, oids, probe, q


@pytest.mark.parametrize("case", ["duplicates", "pool_is_k", "pool_pow2",
                                  "pool_pow2_plus1", "width0"])
def test_ivf_screen_select_ref_pool_edges_match_jax(case):
    """The screen's plain version against the JAX oracle where the split
    kernel's select has edges: each query naming a cluster two and three
    times (both slots filled, ties broken by pool index), k equal to the
    pool, a pool of exactly 2^7 slots and one of 2^7 + 1 (the kernel pads
    to the next power of two), and every query's probe width 0 (the
    overflow alone, against the oracle on an empty probe)."""
    rng = np.random.default_rng(["duplicates", "pool_is_k", "pool_pow2",
                                 "pool_pow2_plus1", "width0"].index(case))
    n_c, cap, d, b, n_probe, o_cap, k = 10, 24, 36, 5, 4, 32, 40
    if case in ("pool_pow2", "pool_pow2_plus1"):
        o_cap = 128 - n_probe * cap + (case == "pool_pow2_plus1")
    mv, mids, osc, oids, probe, q = _screen_inputs(rng, n_c, cap, d, b,
                                                   n_probe, o_cap)
    if case == "duplicates":
        probe[:, 1] = probe[:, 0]
        probe[2, :3] = probe[2, 3]
        osc[2] = -100.0  # query 2: one cluster in all four slots
    if case == "pool_is_k":
        k = n_probe * cap + o_cap
    width = None
    want_probe = probe
    if case == "width0":
        width = np.zeros(b, np.int32)
        want_probe = probe[:, :0]
    want_v, want_i = jref.ivf_screen_select_ref(mv, mids, osc, oids,
                                                want_probe, q, k)
    got_v, got_i = ref.ivf_screen_select_ref(
        _t(mv), _t(mids), _t(osc), _t(oids), _t(probe), _t(q), k,
        probe_width=None if width is None else _t(width))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), **TOL)
    if case == "duplicates":  # a member in four slots: picked four times
        assert (got_i[2, :4] == got_i[2, 0]).all() and got_i[2, 0] >= 0
        assert (got_v[2, :4] == got_v[2, 0]).all()
    if case == "width0":
        assert set(got_i.numpy().ravel()) <= set(oids.tolist()) | {-1}


@pytest.mark.parametrize("b,n_probe,cap,k", [(1, 1, 8, 1), (4, 8, 544, 576),
                                             (5, 8, 544, 576),
                                             (256, 8, 544, 576),
                                             (3, 2, 33, 7)])
def test_ivf_screen_select_workspace_holds_one_key_per_member_slot(
        b, n_probe, cap, k):
    """The score pass writes one 64-bit key per (query, probed member
    slot) at word offset 2 ((query * n_probe + stage) * cap + row), after
    the 2 b k words of the values and ids, which keeps the keys 8-byte
    aligned; the plan's ints follow the keys."""
    words = {2 * ((i * n_probe + j) * cap + r) + w for i in range(b)
             for j in range(n_probe) for r in range(cap) for w in (0, 1)}
    assert words == set(range(decode_fused.screen_workspace_ints(
        b, n_probe, cap)))
    assert (4 * 2 * b * k) % 8 == 0
    assert decode_fused.screen_workspace_ints(b, n_probe, cap) % 2 == 0


CHUNK = decode_fused.RERANK_ROWS


@pytest.mark.parametrize("r", [1, CHUNK - 1, CHUNK, CHUNK + 1, 3 * CHUNK + 5])
@pytest.mark.parametrize("values", ["ints", "random"])
def test_rerank_select_ref_at_chunk_edges_matches_jax(r, values):
    """Survivor counts around the score kernel's chunk, k = 1 and k = r,
    with dead survivors (id -1, a -inf screening value), ids past the table
    (clamped, as both gathers do) and an all-dead query; small integers
    also with duplicate ids (exact sums, ties broken by survivor position).
    On random values the ids are distinct, since two frameworks may round
    one row's score differently at two positions."""
    rng = np.random.default_rng(6 + r)
    b = 5
    if values == "ints":
        n, d = 40, 30
        db = rng.integers(-2, 3, (n, d)).astype(np.float32)
        q = rng.integers(-2, 3, (b, d)).astype(np.float32)
        cand = rng.integers(0, n, (b, r)).astype(np.int32)
        cand[1, ::2] = n + 3
        cand[2, r // 2:] = cand[2, :r - r // 2]
    else:
        n, d = 400, 30
        db = rng.standard_normal((n, d), dtype=np.float32)
        q = rng.standard_normal((b, d), dtype=np.float32)
        cand = np.stack([rng.permutation(n - 1)[:r]
                         for _ in range(b)]).astype(np.int32)
        cand[1, 0] = n + 3  # the only survivor on the last row
    lut_vals = rng.standard_normal((b, r)).astype(np.float32)
    cand[rng.random((b, r)) < 0.1] = -1
    lut_vals[rng.random((b, r)) < 0.1] = -np.inf
    cand[4] = -1
    for k in sorted({1, r}):
        want_v, want_i = jref.rerank_select_ref(jnp.asarray(db), cand,
                                                lut_vals, q, k)
        got_v, got_i = ref.rerank_select_ref(_t(db), _t(cand), _t(lut_vals),
                                             _t(q), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), **TOL)
        assert (got_i[4] == -1).all() and torch.isneginf(got_v[4]).all()


@pytest.mark.parametrize("b,r,k", [(1, 1, 1), (4, 1152, 576), (256, 1152, 576),
                                   (3, CHUNK + 1, 2)])
def test_rerank_select_workspace_holds_one_key_per_survivor(b, r, k):
    """The score kernel writes one 64-bit key per (query, survivor) at word
    offset 2 (query * r + survivor), after the 2 b k words of the values and
    ids, which keeps the keys 8-byte aligned."""
    words = {2 * (i * r + c) + w for i in range(b) for c in range(r)
             for w in (0, 1)}
    assert words == set(range(decode_fused.rerank_workspace_ints(b, r)))
    assert (4 * 2 * b * k) % 8 == 0


@pytest.mark.parametrize("case", ["shared_row", "duplicates", "clamped",
                                  "zero_queries", "d36"])
def test_fused_estimator_ref_edge_cases_match_pallas(case):
    """The estimator's plain version against the Pallas kernel (interpret
    mode) where candidate sets share, repeat or clamp rows: every slot of
    every token naming one row; each token naming rows twice and thrice;
    ids below 0 and past the table (both packages' ``stratified_logz``
    raise a -1 pad to 0 before the kernel, as done here; an id past the
    table the Pallas gather clamps to the last row, and the port's kernel
    clamps to [0, n)); zero query rows (the padded last head chunk: y =
    log_w); d = 36. Dead slots throughout and an all-dead token (log_z
    -inf, expv NaN in both)."""
    rng = np.random.default_rng(["shared_row", "duplicates", "clamped",
                                 "zero_queries", "d36"].index(case))
    n, d, t, m = 50, 36 if case == "d36" else 64, 6, 24
    emb = 0.3 * rng.standard_normal((n, d), dtype=np.float32)
    h = 0.3 * rng.standard_normal((t, d), dtype=np.float32)
    ids = rng.integers(0, n, (t, m)).astype(np.int32)
    log_w = rng.standard_normal((t, m)).astype(np.float32)
    log_w[:, ::5] = -np.inf
    log_w[3] = -np.inf
    if case == "shared_row":
        ids[:] = 7
    elif case == "duplicates":
        ids[:, 1::2] = ids[:, ::2]
        ids[:, 2::6] = ids[:, ::6]
    elif case == "clamped":
        ids[:, :4] = -3
        ids[:, 4:8] = n + 9
    elif case == "zero_queries":
        h[-2:] = 0.0
    ids = np.maximum(ids, 0)  # the callers' clamp of -1 pads
    want_z, want_v = jax_fused_estimator(emb, ids, h, log_w, interpret=True)
    got_z, got_v = ref.fused_estimator_ref(_t(emb), _t(np.clip(ids, 0, n - 1)),
                                           _t(h), _t(log_w))
    np.testing.assert_allclose(got_z.numpy(), np.asarray(want_z), **TOL)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), **TOL)
    assert np.isneginf(got_z[3].item()) and np.isnan(got_v[3].numpy()).all()
    if case == "zero_queries":
        lw = torch.from_numpy(log_w[-2:])
        np.testing.assert_allclose(got_z[-2:].numpy(),
                                   torch.logsumexp(lw, 1).numpy(), **TOL)


def _pq_inputs(rng, n_c, cap, b, n_probe, o_cap, m_sub=8, ksub=16,
               values="ints"):
    """IVF-PQ screen inputs: codes, member ids (30 % dead), coarse scores,
    overflow scores and ids (a third dead), probes, LUTs; small integers
    (every sum exact, ties among them) or random fp32."""
    codes = rng.integers(0, ksub, (n_c, cap, m_sub)).astype(np.uint8)
    mids = rng.integers(0, 1000, (n_c, cap)).astype(np.int32)
    mids[rng.random((n_c, cap)) < 0.3] = -1
    probe = np.stack([rng.permutation(n_c)[:n_probe]
                      for _ in range(b)]).astype(np.int32)
    oids = rng.integers(0, 1000, (o_cap,)).astype(np.int32)
    oids[::3] = -1
    if values == "ints":
        lut = rng.integers(-3, 4, (b, m_sub, ksub)).astype(np.float32)
        coarse = rng.integers(-5, 6, (b, n_probe)).astype(np.float32)
        osc = rng.integers(-20, 20, (b, o_cap)).astype(np.float32)
    else:
        lut = rng.standard_normal((b, m_sub, ksub), dtype=np.float32)
        coarse = rng.standard_normal((b, n_probe), dtype=np.float32)
        osc = 3 * rng.standard_normal((b, o_cap), dtype=np.float32)
    return codes, mids, coarse, osc, oids, probe, lut


@pytest.mark.parametrize("values", ["ints", "random"])
@pytest.mark.parametrize("case", ["pool_pow2_minus1", "pool_pow2",
                                  "pool_pow2_plus1", "r_pool", "width"])
def test_pq_screen_select_ref_pool_edges_match_jax(case, values):
    """The IVF-PQ screen's plain version against the JAX oracle where the
    select pads the pool to a power of two: pools of 2^8 - 1, 2^8 and 2^8 +
    1 slots, r equal to the pool, and probe widths 0 to n_probe (against
    the oracle on each query's probe prefix). Small integers (exact, ties
    broken by pool index) and random fp32."""
    rng = np.random.default_rng(["pool_pow2_minus1", "pool_pow2",
                                 "pool_pow2_plus1", "r_pool",
                                 "width"].index(case))
    n_c, cap, b, n_probe, r = 10, 48, 5, 4, 60
    o_cap = {"pool_pow2_minus1": 63, "pool_pow2": 64,
             "pool_pow2_plus1": 65}.get(case, 24)
    if case == "r_pool":
        r = n_probe * cap + o_cap
    call = _pq_inputs(rng, n_c, cap, b, n_probe, o_cap, values=values)
    codes, mids, coarse, osc, oids, probe, lut = call
    width = None
    if case == "width":
        width = np.asarray([0, 1, n_probe, 2, 3], np.int32)
    got_v, got_i = ref.pq_screen_select_ref(
        *(_t(x) for x in call), r,
        probe_width=None if width is None else _t(width))
    for j in range(b):
        w = n_probe if width is None else width[j]
        want_v, want_i = jref.pq_screen_select_ref(
            codes, mids, coarse[j:j + 1, :w], osc[j:j + 1], oids,
            probe[j:j + 1, :w], lut[j:j + 1], r)
        np.testing.assert_array_equal(got_i[j].numpy(), np.asarray(want_i)[0])
        np.testing.assert_allclose(got_v[j].numpy(), np.asarray(want_v)[0],
                                   **TOL)
    if case == "r_pool":  # every live slot picked, then the dead ones
        n_live = (got_i >= 0).sum(1)
        assert torch.isneginf(got_v[torch.arange(r)[None] >= n_live[:, None]]
                              ).all()


@pytest.mark.parametrize("b,n_probe,cap", [(1, 1, 8), (4, 8, 544),
                                           (256, 8, 544), (3, 2, 600)])
def test_pq_screen_select_workspace_holds_one_key_per_member_slot(
        b, n_probe, cap):
    """Every split of a stage into parts (1 up to one per PQ_ROWS members)
    has the score kernel's threads write each member slot of the stage
    once, at key (query * n_probe + stage) * cap + row: exactly the
    workspace's words, the keys after the 2 b r words of the values and
    ids."""
    rows = decode_fused.PQ_ROWS
    words = set(range(decode_fused.screen_workspace_ints(b, n_probe, cap)))
    for parts in range(1, -(-cap // rows) + 1):
        seen = []
        for part in range(parts):
            for tid in range(rows):
                seen += range(part * rows + tid, cap, parts * rows)
        assert sorted(seen) == list(range(cap))
    keys = {2 * ((i * n_probe + j) * cap + row) + w for i in range(b)
            for j in range(n_probe) for row in range(cap) for w in (0, 1)}
    assert keys == words


TAIL = decode_fused.TAIL_ROWS


def _tail_inputs(rng, t, m_cap, k, d=24, n=80, values="ints"):
    """Tail inputs: rows, tail positions, S values (a quarter -inf), S ids,
    heights and h; small integers (exact sums, ties among them) or random
    fp32."""
    if values == "ints":
        emb = rng.integers(-2, 3, (n, d)).astype(np.float32)
        h = rng.integers(-2, 3, (t, d)).astype(np.float32)
        pert_s = rng.integers(-10, 10, (t, k)).astype(np.float32)
        heights = 0.5 * rng.integers(0, 4, (t, m_cap)).astype(np.float32)
    else:
        emb = rng.standard_normal((n, d), dtype=np.float32)
        h = rng.standard_normal((t, d), dtype=np.float32)
        pert_s = 4 * rng.standard_normal((t, k), dtype=np.float32)
        heights = 8 * rng.random((t, m_cap), dtype=np.float32)
    pert_s[:, ::4] = -np.inf
    pos = rng.integers(0, n, (t, m_cap)).astype(np.int32)
    s_ids = rng.integers(0, n, (t, k)).astype(np.int32)
    m_used = np.full(t, m_cap, np.int32)
    return emb, pos, m_used, pert_s, s_ids, heights, h


def _tail_matches_jax(args):
    """The plain version against the JAX oracle, index exact, value within
    TOL; returns the plain version's (index, value)."""
    want_i, want_v = jref.tail_gather_argmax_ref(*(jnp.asarray(a)
                                                   for a in args))
    got_i, got_v = ref.tail_gather_argmax_ref(*(_t(a) for a in args))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), **TOL)
    return got_i, got_v


@pytest.mark.parametrize("k", [1, 20])
@pytest.mark.parametrize("values", ["ints", "random"])
def test_tail_gather_argmax_ref_at_chunk_edges_matches_jax(values, k):
    """Tail lengths around the score kernel's chunk of slots (0, 1, chunk -
    1, chunk, chunk + 1, m_cap), m_cap not a multiple of the chunk, k = 1
    and 20: the plain version equals the JAX oracle."""
    m_cap = 3 * TAIL + 5
    used = [0, 1, TAIL - 1, TAIL, TAIL + 1, m_cap]
    rng = np.random.default_rng(10 + k + (values == "ints"))
    args = list(_tail_inputs(rng, len(used), m_cap, k, values=values))
    args[2] = np.asarray(used, np.int32)
    got_i, _ = _tail_matches_jax(args)
    assert int(got_i[0]) in set(args[4][0].tolist())  # no live tail: an S id


def test_tail_gather_argmax_ref_ties_and_dead_tokens_match_jax():
    """An exact tie between tail slots in two chunks (the lower slot wins),
    an S value -0.0 against tail values +0.0 (equal: the S slot, the lower
    index, wins and keeps its -0.0), and a token whose every value is -inf
    (index 0, s_ids[0], value -inf), also with k = 1."""
    m_cap, k = 3 * TAIL + 2, 6
    rng = np.random.default_rng(30)
    emb, pos, m_used, pert_s, s_ids, heights, h = _tail_inputs(
        rng, 3, m_cap, k)
    pert_s[:] = -np.inf
    heights[:] = 0.0
    h[:2] = 0.0
    heights[0, 1] = heights[0, TAIL + 3] = 2.5  # token 0: a tie
    pert_s[1, 2] = -0.0  # token 1: -0.0 against the tail's +0.0
    m_used[2] = 0  # token 2: every value -inf
    args = (emb, pos, m_used, pert_s, s_ids, heights, h)
    got_i, got_v = _tail_matches_jax(args)
    assert got_i[0] == pos[0, 1] and got_v[0] == 2.5
    assert got_i[1] == s_ids[1, 2] and torch.signbit(got_v[1])
    assert got_i[2] == s_ids[2, 0] and torch.isneginf(got_v[2])
    one = (emb, pos, m_used, pert_s[:, :1], s_ids[:, :1], heights, h)
    got_i, got_v = _tail_matches_jax(one)
    assert got_i[2] == s_ids[2, 0] and torch.isneginf(got_v[2])


@pytest.mark.parametrize("t,m_cap", [(1, 1), (4, 728), (600, 728),
                                     (300, 70), (2, 0), (4, TAIL - 1),
                                     (4, TAIL), (4, TAIL + 1), (3, 2 * TAIL),
                                     (3, 2 * TAIL + 1), (1, 1000), (5, 33),
                                     (132, 728), (2000, 100), (7, 3 * TAIL)])
def test_tail_gather_argmax_workspace_holds_one_pair_per_chunk(t, m_cap):
    """For every grid the launcher may pick (1 up to one block per chunk of
    TAIL_ROWS slots a token), the score blocks' warps visit each tail slot
    of a token once, and block (token, c) writes its pair at words 2 (token
    * g + c) and + 1: all inside the wrapper's workspace, which holds the
    widest grid exactly, after the 2 t words of the index and value."""
    rows = TAIL
    chunks = max(1, -(-m_cap // rows))
    ws = decode_fused.tail_workspace_ints(t, m_cap)
    for g in range(1, chunks + 1):
        seen = []
        for c in range(g):
            for warp in range(rows):
                seen += range(c * rows + warp, m_cap, g * rows)
        assert sorted(seen) == list(range(m_cap))
        words = {2 * (i * g + c) + w for i in range(t) for c in range(g)
                 for w in (0, 1)}
        assert words <= set(range(ws))
    assert ws == 2 * t * chunks and (4 * 2 * t) % 8 == 0
