"""The port's async double-buffered index refresh
(``repro_torch.train.refresh.AsyncIndexRefresher``, the reference's
``repro/train/refresh.py``): ``kick`` / ``swap`` / ``abandon`` and
``in_flight``, an error in the rebuild re-raised at ``swap``, the
reference's stale-buffer statistical check run on the refresher, and two
async training runs bit for bit equal (the swap point is a function of the
window schedule alone).

The stale-buffer check is tests/test_sampling_stats.py's
test_stale_buffer_sampling_tv_bound at the reference's sizes, seeds and
accounting: while the rebuild over the drifted rows is in flight, the
trainer samples against the index built over the SNAPSHOT; the sampler is
then exact for the mixed score vector (stale on the probed set S, fresh
elsewhere), within eps = max_{i in S} |(emb_stale - emb_fresh)[i] · h| of
the fresh logits, so TV(q_hat, softmax_fresh) <= fail + slack +
(e^{2 eps} - 1) / 2, with eps measured over the probed ids and the stale
probe's recall pinned at >= 0.5.
"""
import os

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.core import estimators
from repro_torch.core.mips import IVFConfig, IVFIndex
from repro_torch.launch.steps import TrainConfig, slot_keys
from repro_torch.optim.adamw import OptConfig
from repro_torch.train.refresh import AsyncIndexRefresher
from repro_torch.train.trainer import RunConfig, Trainer
from test_torch_sampling_tv import _clustered_db, _softmax_np

torch.set_num_threads(1)

SEEDS = (0, 1, 2)
N, D, K, L, DRAWS, CHUNK = 1024, 16, 128, 128, 40_000, 5000


class _Failing:
    def refresh(self, db):
        raise RuntimeError("rebuild failed")


def test_kick_swap_and_flags():
    db = torch.from_numpy(_clustered_db(0))
    index = IVFIndex.build(db, IVFConfig(n_clusters=32, kmeans_iters=2))
    r = AsyncIndexRefresher()
    assert not r.in_flight
    with pytest.raises(RuntimeError, match="no rebuild in flight"):
        r.swap()
    snap = db.clone()
    r.kick(index, db.clone(), snap, 8)
    assert r.in_flight and r.kick_step == 8
    with pytest.raises(RuntimeError, match="one rebuild in flight"):
        r.kick(index, db, snap, 9)
    new, got_snap, kicked = r.swap()
    assert not r.in_flight and kicked == 8 and got_snap is snap
    assert new is not index
    for a, b in zip(new.state, index.state):
        assert a.shape == b.shape and a.dtype == b.dtype


def test_abandon_and_error_reraised_at_swap():
    db = torch.from_numpy(_clustered_db(1))
    index = IVFIndex.build(db, IVFConfig(n_clusters=32, kmeans_iters=2))
    r = AsyncIndexRefresher()
    r.kick(index, db.clone(), None, 1)
    r.abandon()
    assert not r.in_flight and r.kick_step is None
    r.abandon()  # idle: no-op
    r.kick(_Failing(), db, None, 2)
    with pytest.raises(RuntimeError, match="rebuild failed"):
        r.swap()
    assert not r.in_flight  # reset after the error: a new kick may follow


@pytest.mark.parametrize("seed", SEEDS)
def test_stale_buffer_sampling_tv_bound(seed):
    db0_np = _clustered_db(seed)  # the snapshot the stale index serves
    db0 = torch.from_numpy(db0_np)
    index = IVFIndex.build(db0, IVFConfig(n_clusters=32, n_probe=8,
                                          kmeans_iters=4))
    # drift the rows like one window of optimizer steps (unit norm kept)
    r = np.random.default_rng(seed + 400)
    db_np = db0_np + 0.01 * r.standard_normal(db0_np.shape).astype(np.float32)
    db_np = (db_np / np.linalg.norm(db_np, axis=1, keepdims=True)).astype(
        np.float32)
    db = torch.from_numpy(db_np)
    refresher = AsyncIndexRefresher()
    refresher.kick(index, db.clone(), db.clone(), 0)  # rebuild in flight

    h_np = db_np[3] * 8.0
    h = torch.from_numpy(h_np)
    p = _softmax_np(db_np @ h_np)
    exact_ids = set(np.argsort(-(db_np @ h_np))[:K].tolist())
    probed = index.topk_batch(h[None], K).ids[0].numpy()
    recall = len(set(probed.tolist()) & exact_ids) / K
    assert recall >= 0.5, f"stale probe recall collapsed: {recall}"
    eps = float(np.abs((db0_np - db_np)[probed] @ h_np).max())
    assert eps > 0.0, "buffer is not actually stale"

    ids, oks = [], []
    for c in range(DRAWS // CHUNK):
        rids = torch.arange(c * CHUNK, (c + 1) * CHUNK)
        keys = slot_keys(seed + 400, rids, torch.zeros_like(rids))
        res = estimators.local_gumbel_max(db, h[None].expand(CHUNK, D), k=K,
                                          l=L, keys=keys, index=index)
        ids.append(res.index.numpy())
        oks.append(res.ok.numpy())
    ids, oks = np.concatenate(ids), np.concatenate(oks)
    fail = 1.0 - oks.mean()
    q_hat = np.bincount(ids, minlength=N) / DRAWS
    tv = 0.5 * np.abs(q_hat - p).sum()
    slack = np.sqrt(N / DRAWS) + 3 * np.sqrt(max(fail, 1e-4) / DRAWS)
    stale_slack = 0.5 * (np.exp(2.0 * eps) - 1.0)
    assert stale_slack < 0.5, "drift too large for a meaningful bound"
    assert tv <= fail + slack + stale_slack, (
        f"TV {tv:.4f} exceeds staleness bound: fail {fail:.4f} + slack "
        f"{slack:.4f} + stale {stale_slack:.4f} (eps {eps:.3f}, "
        f"stale recall {recall:.2f})")
    fresh, _, kicked = refresher.swap()
    assert kicked == 0
    got = set(fresh.topk_batch(h[None], K).ids[0].tolist())
    assert len(got & exact_ids) / K >= 0.5


def _async_run(workdir):
    cfg = get_smoke("tinyllama-1.1b").scaled(vocab=4096, head_mips="ivf")
    run = RunConfig(num_steps=6, ckpt_every=100, log_every=100, batch=2,
                    seq=16, fuse_steps=2, index_refresh_every=2,
                    async_refresh=True,
                    train=TrainConfig(opt=OptConfig(lr=1e-2, warmup_steps=2,
                                                    total_steps=6),
                                      precision="f32"))
    tr = Trainer(cfg, run, str(workdir), device="cpu")
    out = tr.train()
    return tr, out


@pytest.mark.parametrize("threads", [1, max(2, os.cpu_count() or 1)])
def test_two_async_runs_bitwise(tmp_path, threads):
    """The reference's schedule (kick at a refresh boundary, swap at the
    next window boundary, no kick at the last), and two runs bit for bit:
    the rebuild's wall time never enters the numbers. Also at the intra-op
    thread count a one-rank launcher run has (every core), where the side
    thread's rebuild shares the thread pool with the train step."""
    prev = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        runs = [_async_run(tmp_path / f"r{i}") for i in range(2)]
    finally:
        torch.set_num_threads(prev)
    for tr, out in runs:
        assert out["status"] == "done"
        assert [(e["kick"], e["swap"]) for e in tr.refresh_events] == [
            (2, 4), (4, 6)]
        assert tr.index_swaps == 2 == tr.index_refreshes
    (a, _), (b, _) = runs
    assert [m["loss"] for m in a.metrics_log] == [
        m["loss"] for m in b.metrics_log]
    for x, y in zip(a.head_index.state, b.head_index.state):
        assert torch.equal(x, y)
    assert os.path.isdir(tmp_path / "r0")


def test_probe_trace_and_router_fit_at_refresh(tmp_path):
    """The adaptive probe's telemetry at each refresh boundary: the width
    histogram fills (one entry a query of the 256-row trace), and with
    ``fit_probe_router`` the fitted router is saved to workdir/router.npz
    in the reference's format."""
    from repro_torch.models import router as router_lib

    cfg = get_smoke("tinyllama-1.1b").scaled(
        vocab=4096, head_mips="ivf", head_adaptive_probe=True,
        head_n_probe_init=1, head_n_probe_max=8)
    run = RunConfig(num_steps=2, ckpt_every=100, log_every=100, batch=2,
                    seq=16, index_refresh_every=1, fit_probe_router=True,
                    train=TrainConfig(precision="f32"))
    tr = Trainer(cfg, run, str(tmp_path), device="cpu")
    assert tr.train()["status"] == "done"
    assert sum(tr.probe_width_hist.values()) == 2 * 256
    assert all(1 <= w <= 8 for w in tr.probe_width_hist)
    r = router_lib.load_router(str(tmp_path / "router.npz"))
    assert r.w2.shape[1] == 4  # stages 1, 2, 4, 8
