"""The routes of ``fused_estimator``'s forward, on the CPU: the shape rule
that picks one (``kernels.fused_estimator.route``), also on meta tensors;
the plain version of its popular-row plan (``ref.popular_rows_ref``) against
a brute-force listing; and the port's op at each route's inputs against the
Pallas kernel in interpret mode. The CUDA kernels themselves run only on the
card (``tests/test_torch_cuda.py``, against these plain versions).

Tolerances: ids, columns and counts exact; values rtol=1e-5, atol=1e-6
(the same terms summed in other orders).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import fused_estimator as kfe
from repro_torch.kernels import ops, ref

torch.set_num_threads(1)

R = kfe.POPULAR_USES
TOL = dict(rtol=1e-5, atol=1e-6)


def _inputs(case, seed=0):
    """(emb, ids, h, log_w) of numpy arrays: t tokens x m slots over an
    (n, d) table; rows 0..19 popular where the case says, row 5 named
    exactly R-1 / R / R+1 times, an all-dead token 7 where t > 7."""
    rng = np.random.default_rng(seed)
    n, d, t, m = 400, 24, 2 * R, 50
    if case == "split":
        t = 6
    emb = (rng.standard_normal((n, d)) * 0.3).astype(np.float32)
    h = (rng.standard_normal((t, d)) * 0.4).astype(np.float32)
    ids = rng.integers(20, n, (t, m)).astype(np.int32)
    log_w = rng.standard_normal((t, m)).astype(np.float32)
    log_w[rng.random((t, m)) < 0.1] = -np.inf
    if case in ("popular", "split"):
        ids[:, :16] = rng.integers(0, 20, (t, 16))
        ids[3, 12:30] = 9  # one token naming a popular row many times
    if t > 7:
        log_w[7] = -np.inf
    if case.startswith("uses"):
        uses = R + {"uses_r_minus_1": -1, "uses_r": 0, "uses_r_plus_1": 1}[case]
        free = np.flatnonzero(np.isfinite(log_w))
        ids.reshape(-1)[rng.choice(free, uses, replace=False)] = 5
    if case == "out_of_range":  # ids past the table clamp to its rows
        ids[:, :20] = n + 3
        ids[:, 20:25] = -7
    return emb, ids, h, log_w


def _listing(ids, log_w, n, uses, cap):
    """Every row's live uses counted one slot at a time; the popular rows
    in row order, the first ``cap`` of them numbered."""
    counts = [0] * n
    for i, lw in zip(ids.reshape(-1).tolist(), log_w.reshape(-1).tolist()):
        if lw != -np.inf:
            counts[min(max(i, 0), n - 1)] += 1
    colmap, rows = [-1] * n, []
    for r in range(n):
        if counts[r] >= uses and len(rows) < cap:
            colmap[r] = len(rows)
            rows.append(r)
    return colmap, rows


@pytest.mark.parametrize("case,cap", [
    ("uses_r_minus_1", 8192), ("uses_r", 8192), ("uses_r_plus_1", 8192),
    ("popular", 8192), ("popular", 7), ("out_of_range", 8192)])
def test_popular_rows_ref_matches_a_listing(case, cap):
    emb, ids, h, log_w = _inputs(case)
    n = emb.shape[0]
    colmap, rows, n_u = ref.popular_rows_ref(torch.from_numpy(ids),
                                             torch.from_numpy(log_w), n, R, cap)
    want_map, want_rows = _listing(ids, log_w, n, R, cap)
    assert colmap.dtype == rows.dtype == n_u.dtype == torch.int32
    assert colmap.tolist() == want_map and rows.tolist() == want_rows
    assert n_u.tolist() == [len(want_rows)]
    if case.startswith("uses"):
        assert (colmap[5] >= 0) == (case != "uses_r_minus_1")
    if cap == 7:
        assert rows.numel() == 7


@pytest.mark.parametrize("n,d,t,m,popular,ranges,bands", [
    (32000, 2048, 256, 1152, True, 1, 16),  # the training head chunk
    (50280, 1536, 256, 1408, True, 1, 19),  # mamba2-780m's chunk
    (16000, 2048, 256, 576, True, 1, 8),  # one tp-2 shard's chunk
    (12000, 36, 64, 6144, True, 13, 0),  # past the band walk's 4,096 slots
    (1281167, 256, 64, 6912, False, 13, 0),  # the paper's ImageNet table
    (2000126, 300, 32, 8704, False, 17, 0),  # its word embeddings
    (160000, 256, 64, 2432, False, 13, 0),  # Algorithm 3, the bench table
    (32000, 2048, 4, 128, False, 4, 0),  # structured search
    (32000, 2048, 1, 1, False, 1, 0),
    (3000, 64, 64, 1, False, 1, 0),  # t·m / R rows too few for a column tile
])
def test_route_rule(n, d, t, m, popular, ranges, bands):
    r = kfe.route(n, d, t, m)
    assert r["popular"] == popular and r["ranges"] == ranges
    assert r["bands"] == bands
    if popular:
        assert 0 < r["cap"] <= kfe.POPULAR_CAP and r["cap"] % 64 == 0
        assert r["cap"] <= min(n, t * m // R)
    else:
        assert r["cap"] == 0
    if bands:  # a band of fp32 rows fits in L2 with room to spare
        assert 4 * d * -(-n // bands) <= 16 << 20 or bands == 32
    # the ranges cover every slot, none of them empty
    span = -(-m // r["ranges"])
    assert (r["ranges"] - 1) * span < m <= r["ranges"] * span


def test_route_on_meta_tensors():
    """The rule reads shapes only: a meta trace of the op (the cost model's
    dry run) runs it and gets the kernel's output shapes."""
    n, d, t, m = 32000, 2048, 256, 1152
    emb = torch.empty((n, d), device="meta")
    ids = torch.empty((t, m), dtype=torch.int32, device="meta")
    h = torch.empty((t, d), device="meta")
    log_w = torch.empty((t, m), device="meta")
    assert kfe.route(*emb.shape, *ids.shape)["popular"]
    log_z, expv, y = ops.fused_estimator(emb, ids, h, log_w, return_y=True)
    assert [x.shape for x in (log_z, expv, y)] == [(t,), (t, d), (t, m)]
    assert all(x.is_meta for x in (log_z, expv, y))


@pytest.mark.parametrize("case", ["popular", "split", "uses_r", "bands"])
def test_route_inputs_match_pallas(case, monkeypatch):
    """At each route's inputs (popular rows, repeats, a row named exactly R
    times, several row bands, the split walk) the port's op on the CPU
    equals the Pallas kernel, y is -inf on exactly the dead slots, and the
    all-dead token keeps the -1e30 sentinel's -inf and NaN."""
    if case == "bands":  # tiny bands, so that the 400-row table has seven
        monkeypatch.setattr(kfe, "_BAND_BYTES", 4 * 24 * 60)
    emb, ids, h, log_w = _inputs("popular" if case == "bands" else case,
                                 seed=3)
    n, t = emb.shape[0], ids.shape[0]
    args = [torch.from_numpy(x) for x in (emb, ids, h, log_w)]
    r = kfe.route(n, emb.shape[1], t, ids.shape[1])
    assert r["popular"] == (case != "split")
    assert r["bands"] == {"split": 0, "bands": 7}.get(case, 1)
    if r["popular"]:  # the dense route takes the popular rows' slots
        _, rows, _ = ref.popular_rows_ref(args[1], args[3], n, R, r["cap"])
        assert rows.numel() > 0
    log_z, expv, y = ops.fused_estimator(*args, return_y=True)
    want_z, want_v = jops.fused_estimator(*map(jnp.asarray,
                                               (emb, ids, h, log_w)))
    live = torch.isfinite(log_z)
    assert torch.equal(live, torch.from_numpy(np.isfinite(np.asarray(want_z))))
    np.testing.assert_allclose(log_z.numpy(), np.asarray(want_z), **TOL)
    np.testing.assert_allclose(expv[live].numpy(),
                               np.asarray(want_v)[live.numpy()], **TOL)
    assert torch.equal(torch.isneginf(y), torch.isneginf(args[3]))
    if t > 7:  # the all-dead token: the -1e30 sentinel's -inf and NaN
        assert torch.isneginf(log_z[7]) and torch.isnan(expv[7]).all()
