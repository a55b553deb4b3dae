"""The port's index-backed lazy-Gumbel sampler held by the total-variation
bound of ``tests/test_sampling_stats.py`` (``test_ivf_backed_sampling_tv_bound``
and ``test_pq_backed_sampling_tv_bound``), at the reference's sizes, recall
floor and slack, with the port's ``IVFIndex`` and ``IVFPQIndex`` and its
counter-based (Philox) keys.

With an approximate probe the certificate can fail, and the sampler's law q
then satisfies TV(q, softmax) <= P(certificate fails). The test checks the
empirical version, TV(q_hat, p) <= fail_rate + slack, where the slack bounds
the finite-sample TV of q_hat around q (sqrt(n / M)) plus 3 sigma of the
measured fail rate, at a measured and asserted probe recall@k >= 0.7 (the
fixed-recall regime, not a lucky easy index). The IVF-PQ probe's exact
re-rank returns true inner products, so the same accounting holds and
quantization error shows only in the measured recall.

The database is the reference's kind (32 Gaussian centers, 0.5 noise,
rows unit-normalized), drawn with numpy from the seed; the seeds are the
reference's (0, 1, 2), each test's assertion at its per-seed budget.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import estimators
from repro_torch.core.mips import IVFConfig, IVFIndex, IVFPQIndex, PQConfig
from repro_torch.core.mips import index_spill
from repro_torch.launch.steps import slot_keys

# two intra-op threads: the suite runs six workers on the same cores, and
# the file stays well under a minute alone
torch.set_num_threads(2)

SEEDS = (0, 1, 2)
N, D, K, L, DRAWS = 1024, 16, 128, 128, 40_000
CHUNK = 5000  # tokens drawn per call
RECALL_FLOOR = 0.7


def _softmax_np(y):
    y = np.asarray(y, np.float64)
    p = np.exp(y - y.max())
    return p / p.sum()


def _clustered_db(seed: int) -> np.ndarray:
    r = np.random.default_rng(seed)
    centers = r.standard_normal((32, D))
    db = centers[r.integers(0, 32, N)] + 0.5 * r.standard_normal((N, D))
    return (db / np.linalg.norm(db, axis=1, keepdims=True)).astype(np.float32)


def _index(kind: str, db: torch.Tensor):
    if kind == "ivf":
        return IVFIndex.build(db, IVFConfig(n_clusters=32, n_probe=8,
                                            kmeans_iters=4))
    index = IVFPQIndex.build(db, PQConfig(
        n_clusters=32, n_probe=8, kmeans_iters=4, m_sub=8, ksub=64,
        pq_iters=4, rerank=2 * K))
    assert index_spill(index) == 0
    return index


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind", ["ivf", "pq"])
def test_index_backed_sampling_tv_bound(kind, seed):
    db_np = _clustered_db(seed)
    db = torch.from_numpy(db_np)
    h_np = db_np[3] * 8.0  # a peaked-but-spread softmax over the db
    h = torch.from_numpy(h_np)
    p = _softmax_np(db_np @ h_np)
    index = _index(kind, db)
    # fixed-recall regime: measure and pin the probe's recall@k
    exact_ids = set(np.argsort(-(db_np @ h_np))[:K].tolist())
    got = set(index.topk_batch(h[None], K).ids[0].tolist())
    recall = len(got & exact_ids) / K
    assert recall >= RECALL_FLOOR, f"probe recall collapsed: {recall}"

    stream = seed + (300 if kind == "ivf" else 400)
    ids, oks = [], []
    for c in range(DRAWS // CHUNK):
        rids = torch.arange(c * CHUNK, (c + 1) * CHUNK)
        keys = slot_keys(stream, rids, torch.zeros_like(rids))
        res = estimators.local_gumbel_max(db, h[None].expand(CHUNK, D), k=K,
                                          l=L, keys=keys, index=index)
        ids.append(res.index.numpy())
        oks.append(res.ok.numpy())
    ids, oks = np.concatenate(ids), np.concatenate(oks)
    fail = 1.0 - oks.mean()
    q_hat = np.bincount(ids, minlength=N) / DRAWS
    tv = 0.5 * np.abs(q_hat - p).sum()
    # slack: sqrt(n/M) for the empirical TV + 3-sigma on the fail rate
    slack = np.sqrt(N / DRAWS) + 3 * np.sqrt(max(fail, 1e-4) / DRAWS)
    assert tv <= fail + slack, (
        f"TV {tv:.4f} exceeds certificate-failure bound {fail:.4f} "
        f"+ slack {slack:.4f} (recall {recall:.2f})")
