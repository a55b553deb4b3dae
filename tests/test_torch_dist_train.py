"""The sharding slice as a whole, on spawned gloo CPU ranks, at the
reference test's small tinyllama (d 64, vocab 4096;
tests/test_dist.py::test_dp_tp_trainer_sharded_ckpt_async_refresh_resume):

* a dp 2 × tp 2 train step with the exact head against the reference's
  single-device ``make_train_step`` on the same global batch, params
  carried across by ``convert.shard_params_from_jax``: the loss and every
  rank's block of every updated leaf (the trunk Megatron-split over
  ``model`` and FSDP-split over ``data``, the embeddings' rows) at fp32
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
  equal to the dp-2 ranks' restored blocks put together;
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
from _torch_trunk import _block
from repro.configs import get_smoke as jget_smoke
from repro.data.synthetic import DataConfig as JDataConfig
from repro.data.synthetic import make_batch as jmake_batch
from repro.launch import steps as jsteps
from repro.models.model import Model as JModel
from repro.optim import adamw as jadamw
from repro_torch.checkpoint import manager
from repro_torch.configs import get_smoke
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import transformer as ttr

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


def _dims(path, dp=2, tp=2, **kw):
    """{axis: dim} of a leaf of the test's model on a (dp, tp) mesh."""
    cfg = get_smoke("tinyllama-1.1b").scaled(
        d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, vocab=4096, **kw)
    return mesh_lib.spec_dims(ttr.spec_of(
        path, mesh_lib.Mesh(dp, tp, 0, None, None, None), cfg))


def test_dp_tp_step_matches_single_device(dp_tp, reference_step):
    _, outs = dp_tp
    _, _, want, loss = reference_step
    eps, lr = 1e-8, OPT["lr"]
    split = set()
    for rank, o in enumerate(outs):
        coords = {"data": rank // 2, "model": rank % 2}
        st = o["step"]
        assert st["step"] == 1
        np.testing.assert_allclose(st["loss"], loss, rtol=1e-5)
        assert len(st["params"]) == len(want)
        for path, got, (w, g) in zip(st["paths"], st["params"], want):
            dims = _dims(path, head_mode="exact")
            split.update(dims)
            w = _block(np.asarray(w), dims, coords, got.shape)
            g = _block(np.asarray(g), dims, coords, got.shape)
            well = np.abs(g) > 100 * eps
            np.testing.assert_allclose(got[well], w[well], rtol=1e-4,
                                       atol=2e-5)
            assert np.all(np.abs(got - w)[~well] <= lr)
    assert split == {"data", "model"}  # the trunk is split both ways


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
    """The dp-1 restore of each model rank equals the dp-2 ranks' blocks
    of that model rank put together along each leaf's data dim."""
    wd, outs = dp_tp
    kw = dict(head_mode="amortized", head_mips="ivf", head_k=96, head_l=96)
    for m in range(2):
        got = tp_serve[m]["restored4"]
        halves = [outs[d * 2 + m]["trainer"]["restored4"] for d in range(2)]
        for h in halves:
            _equal(got["index"], h["index"])
        assert got["meta"]["step"] == 4
        for key in ("params", "m"):
            for i, path in enumerate(got["paths"]):
                d = _dims(path, **kw).get("data")
                parts = [h[key][i] for h in halves]
                if d is None:
                    _equal([parts[0]], [parts[1]])
                    want = parts[0]
                else:
                    want = np.concatenate(parts, axis=d)
                np.testing.assert_array_equal(got[key][i], want)
    # one rank, no mesh: whole tensors, the model shards side by side
    full, _, _ = manager.restore(str(wd / "run"), step=4)
    only, _, _ = manager.restore(str(wd / "run"), step=4, keys=("params",))
    assert set(only) == {"params"}
    _equal(td._host(only["params"]), td._host(full["params"]))
    for i, path in enumerate(outs[0]["trainer"]["restored4"]["paths"]):
        t = full["params"]
        for k in path:
            t = t[int(k)] if isinstance(t, list) else t[k]
        parts = {(d, m): outs[d * 2 + m]["trainer"]["restored4"]["params"][i]
                 for d in range(2) for m in range(2)}
        dims = _dims(path, **kw)
        for (d, m), blk in parts.items():
            np.testing.assert_array_equal(
                blk, _block(t.numpy(), dims, {"data": d, "model": m},
                            blk.shape))
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
