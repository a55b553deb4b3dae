"""The sharding slice as a whole, on spawned gloo CPU ranks, at the
reference test's small tinyllama (d 64, vocab 4096;
tests/test_dist.py::test_dp_tp_trainer_sharded_ckpt_async_refresh_resume):

* a dp 2 × tp 2 train step with the exact head against the reference's
  single-device ``make_train_step`` on the same global batch, params
  carried across by ``convert.shard_params_from_jax``: the loss and every
  rank's updated params (its slice of the output embedding) at fp32
  allclose (rtol 1e-4, atol 2e-5, the single-device step test's) wherever
  the reference's gradient is above 100 AdamW eps; below that, Adam's
  first step ``lr · g / (|g| + eps)`` turns the last bits of a gradient
  that cancels to ~eps (summed over two data halves instead of one batch)
  into a visible share of ``lr``, and those elements are held to within
  ``lr`` of the reference;
* the DP×TP ``Trainer`` with the IVF head, ``async_refresh`` and
  ``sharded_ckpt``: 4 steps, then a resume to 12 with the reference test's
  own schedule — kick at 8, swap at 10, one swap — and a manifest that
  reads ``sharded`` and ``complete``;
* the step-4 checkpoint restored on a dp-1 mesh (and on one rank, whole)
  equal to what the dp-2 ranks restore;
* a tp-2 ``Server`` over a ``ShardedIndex``: fused T=4 ≡ unfused T=1
  token for token, twice bitwise, the same tokens on both ranks;
* sharded saves over the unpublished directories of a crashed attempt at
  the same steps: each publishes what its ranks saved, and nothing stale
  is left.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

import _torch_dist as td
import repro.models.transformer as jtr
from repro.configs import get_smoke as jget_smoke
from repro.data.synthetic import DataConfig as JDataConfig
from repro.data.synthetic import make_batch as jmake_batch
from repro.launch import steps as jsteps
from repro.models.model import Model as JModel
from repro.optim import adamw as jadamw
from repro_torch.checkpoint import manager

torch.set_num_threads(1)

OPT = dict(lr=1e-3, warmup_steps=1, total_steps=3)
B, L = 4, 32


def _jcfg(**kw):
    return jget_smoke("tinyllama-1.1b").scaled(
        d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, vocab=4096, **kw)


@pytest.fixture(scope="module")
def reference_step():
    saved = jtr.REMAT
    jtr.REMAT = False
    try:
        jcfg = _jcfg(head_mode="exact")
        jm = JModel(jcfg, precision_policy="f32")
        params = jm.init(jax.random.key(0))
        np_params = jax.device_get(params)
        batch = jmake_batch(jcfg, JDataConfig(batch=B, seq=L), 0)
        step = jax.jit(jsteps.make_train_step(
            jm, jsteps.TrainConfig(opt=jadamw.OptConfig(**OPT),
                                   precision="f32")))
        p1, _, m = step(params, jadamw.init(params), batch,
                        jax.random.key(1))
        grads = jax.grad(lambda p: jm.loss_fn(p, batch,
                                              jax.random.key(1))[0])(params)
    finally:
        jtr.REMAT = saved
    return (np_params, {k: np.asarray(v) for k, v in batch.items()},
            list(zip(jax.tree.leaves(jax.device_get(p1)),
                     jax.tree.leaves(jax.device_get(grads)))),
            float(m["loss"]))


@pytest.fixture(scope="module")
def dp_tp(tmp_path_factory, reference_step):
    np_params, batch, _, _ = reference_step
    wd = tmp_path_factory.mktemp("dptp")
    outs = td.spawn(td.dist_train_all, wd, 2, 2,
                    {"params": np_params, "batch": batch, "opt": OPT,
                     "workdir": str(wd / "run")})
    return wd, outs


@pytest.fixture(scope="module")
def tp_serve(tmp_path_factory, dp_tp):
    wd, _ = dp_tp
    r = np.random.default_rng(0)
    prompts = [r.integers(0, 4096, n).tolist() for n in (5, 9, 3)]
    return td.spawn(td.dist_serve_case, tmp_path_factory.mktemp("tps"), 1, 2,
                    {"prompts": prompts, "workdir": str(wd / "run")})


def test_dp_tp_step_matches_single_device(dp_tp, reference_step):
    _, outs = dp_tp
    _, _, want, loss = reference_step
    eps, lr = 1e-8, OPT["lr"]
    for rank, o in enumerate(outs):
        m = rank % 2
        st = o["step"]
        assert st["step"] == 1
        np.testing.assert_allclose(st["loss"], loss, rtol=1e-5)
        assert len(st["params"]) == len(want)
        for got, (w, g) in zip(st["params"], want):
            w, g = np.asarray(w), np.asarray(g)
            if got.shape != w.shape:  # out_embed: this rank's rows
                v = got.shape[0]
                w, g = w[m * v:(m + 1) * v], g[m * v:(m + 1) * v]
            well = np.abs(g) > 100 * eps
            np.testing.assert_allclose(got[well], w[well], rtol=1e-4,
                                       atol=2e-5)
            assert np.all(np.abs(got - w)[~well] <= lr)


def test_trainer_async_schedule_and_sharded_manifest(dp_tp):
    _, outs = dp_tp
    for o in outs:
        t = o["trainer"]
        assert t["status"] == ("done", "done", 12)
        assert t["manifest"] == (True, True)
        # the restore at 4 rebuilds the index; the async schedule re-arms:
        # kick at 8, swap at 10, none at the last boundary (12)
        assert t["events"] == [(8, 10)]
        assert t["swaps"] == 1 and t["sharded_index"]
        assert all(np.isfinite(t["losses"]))
        assert t["losses"] == outs[0]["trainer"]["losses"]


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_restore_on_dp1_equals_dp2(dp_tp, tp_serve):
    wd, outs = dp_tp
    for rank, o in enumerate(outs):
        got = tp_serve[rank % 2]["restored4"]
        want = o["trainer"]["restored4"]
        for key in ("params", "m", "index"):
            _equal(got[key], want[key])
        assert got["meta"]["step"] == 4
    # one rank, no mesh: whole tensors, the model shards side by side
    full, _, _ = manager.restore(str(wd / "run"), step=4)
    # the snapshot rows come back whole; the per-shard centroids need two
    # model shards and are dropped
    assert set(full["index"]) == {"db"}
    emb = full["params"]["out_embed"].numpy()
    v = emb.shape[0] // 2
    for m in range(2):
        np.testing.assert_array_equal(
            emb[m * v:(m + 1) * v], outs[m]["trainer"]["restored4"]["params"][-1])


def test_tp_server_fused_equals_unfused(tp_serve):
    for o in tp_serve:
        assert o["sharded_index"]
        assert o["fused"][0] == o["fused"][1] == o["unfused"]
        assert o["fused"][0] == tp_serve[0]["fused"][0]
        assert all(len(t) == 6 for t in o["unfused"])
        assert o["index_bytes"] == 2 * o["local_bytes"]


def _stale_dir(path, rank, tag=None):
    """A crashed save's leftovers: rank ``rank``'s manifest of this step
    and a piece file of the wrong shape."""
    os.makedirs(path)
    torch.save({"params||out_embed": torch.full((1, 3), -1.0)},
               os.path.join(path, f"shards_p{rank:05d}.pt"))
    step = int(os.path.basename(path)[5:13])
    with open(os.path.join(path, f"shard_manifest_p{rank:05d}.json"),
              "w") as f:
        json.dump({"step": step, "tag": tag, "process": rank, "bytes": 1,
                   "leaves": {"params||out_embed": {
                       "shape": [2, 3], "dtype": "float32",
                       "layout": ["dim", 0], "index": [[1, 2], [0, 3]]}}}, f)


def test_sharded_save_over_stale_tmp(tmp_path):
    wd = tmp_path / "wd"
    for step in (2, 4):
        _stale_dir(str(wd / f"ckpt_{step:08d}.tmp"), 1)
        _stale_dir(str(wd / f"ckpt_{step:08d}.tmp.0123abcd.1"), 1,
                   tag="0123abcd.1")
    outs = td.spawn(td.stale_tmp_save_case, tmp_path, 1, 2,
                    {"workdir": str(wd), "rows": 8})
    for o in outs:
        assert o["entries"] == ["ckpt_00000002", "ckpt_00000004"]
        for step in (2, 4):
            got, want = o[step]["got"]["params"], o[step]["want"]["params"]
            assert o[step]["meta"] == {"step": step}
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])
