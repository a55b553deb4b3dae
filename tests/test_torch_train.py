"""The port's training slice: parity with the JAX package (blockwise
attention, the synthetic data, one AdamW update, the model's loss gradients,
one full train step and a 3-step loss trajectory from converted params and
the reference's own head draws), and the port's own contracts, held
bitwise on the CPU: a fused T-window equals T single steps and does not
depend on how the run is chunked; ``accum`` equals a host loop of
microbatches; a resume from a mid-run checkpoint equals the uninterrupted
run (head index included); plus preemption, the index-refresh schedule, the
checkpoint store and the launcher.

Smoke width: tinyllama-1.1b's smoke config (2 layers, d 64) at vocab 4096,
so the amortized head is live, f32 policy.

Tolerances: attention fp32 rtol=atol=1e-5; data byte-equal; AdamW fp32
rtol=1e-6, atol=1e-7 (elementwise, the same formula); loss gradients
rtol=1e-4, atol=1e-6 (two layers of matmuls and the head reduced in
different orders); losses rtol=1e-5; params after one AdamW step rtol=1e-4,
atol=2e-5 — the step normalizes each gradient element, so an element whose
gradient is within rounding of zero can move its weight by a small
fraction of lr (1e-3) differently in the two frameworks. The in-port
contracts are exact (``torch.equal``).
"""
import functools
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.transformer as jtr
from repro.configs import get_smoke as jget_smoke
from repro.data.synthetic import DataConfig as JDataConfig
from repro.data.synthetic import make_batch as jmake_batch
from repro.launch import steps as jsteps
from repro.models import attention as jattn
from repro.models.model import Model as JModel
from repro.optim import adamw as jadamw
from repro_torch.checkpoint import manager
from repro_torch.configs import get_smoke
from repro_torch.convert import opt_state_from_jax, params_from_jax
from repro_torch.data.synthetic import DataConfig, SyntheticStream, make_batch
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps, train as train_launcher
from repro_torch.models import attention
from repro_torch.models.model import Model
from repro_torch.optim import adamw
from repro_torch.train.trainer import RunConfig, Trainer

# one intra-op thread: the suite runs six workers on the same cores
torch.set_num_threads(1)

ARCH = "tinyllama-1.1b"
B, L = 2, 32
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=3)


def _t(x):
    return torch.from_numpy(np.array(x))


def _cfgs(**kw):
    return (jget_smoke(ARCH).scaled(vocab=4096, **kw),
            get_smoke(ARCH).scaled(vocab=4096, **kw))


def _tbatch(b):
    return {k: _t(v) for k, v in b.items()}


def _equal_trees(a, b) -> bool:
    la, lb = adamw.tree_leaves(a), adamw.tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def _clone(tree):
    return adamw.tree_map(lambda x: x.clone(), tree)


# ------------------------------------------------------------- attention
@pytest.mark.parametrize("causal,window,prefix", [
    (True, 0, 0), (True, 20, 0), (True, 0, 10), (False, 0, 0)])
def test_blockwise_attention_matches_jax(causal, window, prefix):
    r = np.random.default_rng(0)
    q = r.standard_normal((2, 64, 4, 8)).astype(np.float32)
    k = r.standard_normal((2, 64, 2, 8)).astype(np.float32)
    v = r.standard_normal((2, 64, 2, 8)).astype(np.float32)
    kw = dict(causal=causal, window=window, prefix=prefix, q_block=16,
              kv_block=16)
    want = jattn.blockwise_attention(*map(jnp.asarray, (q, k, v)), **kw)
    got = attention.blockwise_attention(*map(_t, (q, k, v)), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_blockwise_attention_equals_dense_within_one_block():
    """L <= the block: one query block, one KV block — the online softmax
    of the port's dense ``attention()``."""
    r = np.random.default_rng(1)
    q, k, v = (_t(r.standard_normal((2, 48, h, 16)).astype(np.float32))
               for h in (8, 2, 2))
    got = attention.blockwise_attention(q, k, v, causal=True)
    want = attention.attention(q, k, v, causal=True)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------------ data
def test_make_batch_byte_equal_to_reference():
    jcfg, tcfg = _cfgs()
    for step in (0, 1, 7):
        want = jmake_batch(jcfg, JDataConfig(batch=3, seq=16, seed=5), step)
        got = make_batch(tcfg, DataConfig(batch=3, seq=16, seed=5), step)
        assert want.keys() == got.keys()
        for key in want:
            assert want[key].dtype == got[key].dtype
            assert np.array_equal(want[key], got[key])
    s = SyntheticStream(tcfg, DataConfig(batch=1, seq=4, seed=2))
    next(s), next(s)
    s2 = SyntheticStream(tcfg, DataConfig(batch=1, seq=4, seed=2))
    s2.restore(s.state())
    assert np.array_equal(next(s)["tokens"], next(s2)["tokens"])
    with pytest.raises(ValueError, match="seed"):
        SyntheticStream(tcfg, DataConfig(batch=1, seq=4, seed=3)).restore(
            s.state())


# ----------------------------------------------------------------- adamw
def test_adamw_update_matches_jax():
    r = np.random.default_rng(2)
    shapes = {"a": (5, 7), "b": (3,), "c": {"d": (2, 3, 4)}}

    def make(scale):
        return jax.tree.map(lambda s: (scale * r.standard_normal(s)
                                       ).astype(np.float32), shapes,
                            is_leaf=lambda x: isinstance(x, tuple))

    params, g1, g2 = make(1.0), make(3.0), make(0.1)
    cfg = jadamw.OptConfig(lr=1e-2, warmup_steps=2, total_steps=5,
                           clip_norm=1.0)
    jp, jo = params, jadamw.init(jax.tree.map(jnp.asarray, params))
    tp = adamw.tree_map(_t, params)
    to = adamw.init(tp)
    tcfg = adamw.OptConfig(**vars(cfg))
    for g in (g1, g2):  # the first clips (norm > 1), the second does not
        jp, jo, jm = jadamw.update(jax.tree.map(jnp.asarray, g), jo,
                                   jax.tree.map(jnp.asarray, jp), cfg)
        tp, to, tm = adamw.update(adamw.tree_map(_t, g), to, tp, tcfg)
        for a, b in zip(adamw.tree_leaves(tp) + adamw.tree_leaves(to["m"])
                        + adamw.tree_leaves(to["v"]),
                        jax.tree.leaves(jp) + jax.tree.leaves(jo["m"])
                        + jax.tree.leaves(jo["v"])):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)
        for name in ("grad_norm", "lr"):
            np.testing.assert_allclose(tm[name].item(), float(jm[name]),
                                       rtol=1e-6)
    assert int(to["step"]) == int(jo["step"]) == 2
    with pytest.raises(ValueError, match="non-fp32"):
        adamw.check_master_params({"w": torch.zeros(2, dtype=torch.bfloat16)})


# ---------------------------------------------- model loss and train step
def _jax_head_draws(key, jm: JModel, t: int) -> torch.Tensor:
    """The reference's tail uniforms of one loss_fn call with ``key``
    (dense exact probe: every S slot is live, so hi = n - k)."""
    from test_torch_estimator import jax_tail_draws

    hc = jm.head_cfg
    return _t(jax_tail_draws(key, t, hc.chunk, hc.l, np.full(t, hc.n - hc.k)))


@pytest.fixture(scope="module")
def reference_run():
    """A 3-step JAX run (no remat: same numerics, faster compile) from
    seeded params, and everything the port needs to replay it."""
    jcfg, tcfg = _cfgs()
    saved = jtr.REMAT
    jtr.REMAT = False
    try:
        jm = JModel(jcfg, precision_policy="f32")
        params = jm.init(jax.random.key(0))
        np_params = jax.device_get(params)
        tconf = jsteps.TrainConfig(opt=jadamw.OptConfig(**OPT),
                                   precision="f32")
        step = jax.jit(jsteps.make_train_step(jm, tconf))
        gfn = jax.jit(jax.grad(lambda p, b, k: jm.loss_fn(p, b, k)[0]))
        batches = [jmake_batch(jcfg, JDataConfig(batch=B, seq=L), i)
                   for i in range(3)]
        keys = [jax.random.fold_in(jax.random.key(21), i) for i in range(3)]
        grads0 = jax.device_get(gfn(params, batches[0], keys[0]))
        opt = jadamw.init(params)
        traj = []
        for i in range(3):
            params, opt, m = step(params, opt, batches[i], keys[i])
            traj.append((jax.device_get(params), jax.device_get(opt),
                         float(m["loss"])))
    finally:
        jtr.REMAT = saved
    draws = [_jax_head_draws(k, jm, B * L) for k in keys]
    return dict(tcfg=tcfg, np_params=np_params, batches=batches,
                grads0=grads0, traj=traj, draws=draws)


def test_loss_gradients_match_jax(reference_run):
    rr = reference_run
    model = Model(rr["tcfg"], "f32", device="cpu")
    params = params_from_jax(rr["np_params"], rr["tcfg"])
    diff = adamw.tree_map(lambda p: p.requires_grad_(True), params)
    loss, _ = model.loss_fn(diff, _tbatch(rr["batches"][0]),
                            draws=rr["draws"][0])
    grads = torch.autograd.grad(loss, adamw.tree_leaves(diff))
    want = jax.tree.leaves(rr["grads0"])
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-6)


def test_train_step_and_trajectory_match_jax(reference_run):
    """One full train step (loss, updated params and moments) and the
    losses of three, from the converted params and the reference's
    draws."""
    rr = reference_run
    model = Model(rr["tcfg"], "f32", device="cpu")
    params = params_from_jax(rr["np_params"], rr["tcfg"])
    opt = adamw.init(params)
    step = steps.make_train_step(
        model, steps.TrainConfig(opt=adamw.OptConfig(**OPT), precision="f32"))
    losses = []
    for i in range(3):
        params, opt, m = step(params, opt, _tbatch(rr["batches"][i]), (0, i),
                              draws=rr["draws"][i])
        losses.append(m["loss"].item())
        if i == 0:
            want_p, want_o, _ = rr["traj"][0]
            for a, b in zip(adamw.tree_leaves(params),
                            jax.tree.leaves(want_p)):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1e-4, atol=2e-5)
            conv = opt_state_from_jax(want_o, rr["tcfg"])
            assert int(conv["step"]) == int(opt["step"]) == 1
    np.testing.assert_allclose(losses, [x[2] for x in rr["traj"]], rtol=1e-5)


# --------------------------------------------- the port's own contracts
def _setup(mips="ivf", accum=1, precision="f32"):
    _, tcfg = _cfgs(head_mips=mips)
    model = Model(tcfg, precision, device="cpu")
    params = model.init(0)
    index = model.make_head_index(params) if mips == "ivf" else None
    tconf = steps.TrainConfig(opt=adamw.OptConfig(**OPT), accum=accum,
                              precision=precision)
    return tcfg, model, params, index, tconf


def _stacked(tcfg, n, batch=B):
    bs = [make_batch(tcfg, DataConfig(batch=batch, seq=L), i)
          for i in range(n)]
    return {k: _t(np.stack([b[k] for b in bs])) for k in bs[0]}


def test_fused_window_equals_single_steps_and_chunking_bitwise():
    tcfg, model, params, index, tconf = _setup()
    batches = _stacked(tcfg, 3)
    loop = steps.make_train_loop_step(model, tconf)
    single = steps.make_train_step(model, tconf)
    runs = []
    for windows in ([3], [1, 1, 1], [1, 2], [2, 1]):
        state = {"params": _clone(params), "opt": adamw.init(params)}
        losses, s0 = [], 0
        for t in windows:
            if t == 1 and windows == [1, 1, 1]:  # the plain single step
                p, o, m = single(state["params"], state["opt"],
                                 {k: v[s0] for k, v in batches.items()},
                                 (0, s0), index)
                state, m = {"params": p, "opt": o}, {"loss": m["loss"][None]}
            else:
                state, m = loop(state, {k: v[s0:s0 + t]
                                        for k, v in batches.items()},
                                range(s0, s0 + t), 0, index)
            losses += m["loss"].tolist()
            s0 += t
        runs.append((state, losses))
    for state, losses in runs[1:]:
        assert losses == runs[0][1]
        assert _equal_trees(state, runs[0][0])


def test_accum_equals_host_loop_bitwise():
    """accum=2 inside the step == a host loop over the same microbatches
    with the same token keys, fp32 sums in the same order, one update."""
    tcfg, model, params, index, tconf = _setup(accum=2)
    batch = {k: v[0] for k, v in _stacked(tcfg, 1, batch=4).items()}
    p_step, _, _ = steps.make_train_step(model, tconf)(
        _clone(params), adamw.init(params), batch, (0, 0), index)

    grads = adamw.tree_map(torch.zeros_like, params)
    mb_tok = batch["labels"].numel() // 2
    for i in range(2):
        mb = {k: v.reshape((2, -1) + v.shape[1:])[i] for k, v in batch.items()}
        diff = adamw.tree_map(lambda p: p.detach().requires_grad_(True),
                              params)
        loss, _ = model.loss_fn(diff, mb, index, keys=steps.token_keys(
            0, 0, i * mb_tok, mb_tok))
        gi = torch.autograd.grad(loss, adamw.tree_leaves(diff))
        for a, b in zip(adamw.tree_leaves(grads), gi):
            a.add_(b.float())
    grads = adamw.tree_map(lambda g: g / 2, grads)
    p_loop, _, _ = adamw.update(grads, adamw.init(params), _clone(params),
                                tconf.opt)
    assert _equal_trees(p_step, p_loop)


def _run(tcfg, workdir, steps_, **kw):
    kw.setdefault("train", steps.TrainConfig(opt=adamw.OptConfig(**OPT),
                                             precision="f32"))
    run = RunConfig(num_steps=steps_, batch=B, seq=L, log_every=1, **kw)
    tr = Trainer(tcfg, run, str(workdir), device="cpu")
    return tr, tr.train()


def test_resume_equals_uninterrupted_bitwise(tmp_path):
    """Checkpoint at step 2 (a window boundary the trainer clamps to, with
    fuse 3), resume, finish: losses and final params bitwise the
    uninterrupted run's — the head index included, which the checkpoint
    carries as (rows, centroids) and the resume re-packs."""
    _, tcfg = _cfgs(head_mips="ivf")
    kw = dict(ckpt_every=2, fuse_steps=3, index_refresh_every=2)
    full, _ = _run(tcfg, tmp_path / "a", 4, **kw)
    first, _ = _run(tcfg, tmp_path / "b", 3, **kw)
    shutil.rmtree(tmp_path / "b" / "ckpt_00000003")
    second, res = _run(tcfg, tmp_path / "b", 4, **kw)
    assert res["status"] == "done"
    losses = [e["loss"] for e in first.metrics_log[:2] + second.metrics_log]
    assert losses == [e["loss"] for e in full.metrics_log]
    st_a, _, _ = manager.restore(str(tmp_path / "a"), step=4)
    st_b, _, _ = manager.restore(str(tmp_path / "b"), step=4)
    assert _equal_trees(st_a, st_b)


def test_preempt_flag_checkpoints_and_exits(tmp_path):
    _, tcfg = _cfgs()

    open(tmp_path / "PREEMPT", "w").close()
    tr, res = _run(tcfg, tmp_path, 5, ckpt_every=50)
    assert res["status"] == "preempted" and res["step"] == 1
    assert manager.latest_step(str(tmp_path)) == 1
    os.remove(tmp_path / "PREEMPT")
    tr, res = _run(tcfg, tmp_path, 2, ckpt_every=50)
    assert res["status"] == "done" and len(tr.metrics_log) == 1


def test_index_refresh_every_r_and_on_drift(tmp_path):
    _, tcfg = _cfgs(head_mips="ivf")
    tr, res = _run(tcfg, tmp_path / "r", 5, index_refresh_every=2,
                   ckpt_every=0)
    assert tr.index_refreshes == 2 and res["status"] == "done"
    tr, _ = _run(tcfg, tmp_path / "d", 3, index_drift_threshold=1e-6,
                 ckpt_every=0,
                 train=steps.TrainConfig(opt=adamw.OptConfig(lr=1e-2),
                                         precision="f32"))
    assert tr.index_refreshes == 3  # every boundary drifted past 1e-6
    assert all(e["index_drift"] > 1e-6 for e in tr.metrics_log)


def test_checkpoint_roundtrip_keep_n_and_skips_broken(tmp_path):
    d = str(tmp_path)
    state = {"w": torch.arange(6.0).reshape(2, 3),
             "n": [torch.ones(2, dtype=torch.bfloat16),
                   torch.tensor(3, dtype=torch.int32)],
             "meta": {"step": 1, "data": {"step": 4, "seed": 0}}}
    for s in (1, 2, 3):
        manager.save(d, s, state, keep=2)
    assert sorted(manager._list_steps(d)) == [2, 3]
    got, meta, step = manager.restore(d, target=state)
    assert step == 3 and meta == state["meta"]
    assert torch.equal(got["w"], state["w"]) and got["n"][0].dtype == \
        torch.bfloat16 and torch.equal(got["n"][0], state["n"][0])
    with pytest.raises(ValueError, match="does not match"):
        manager.restore(d, target={"w": torch.zeros(3), "n": state["n"]})
    # a truncated tensor file, a garbage manifest and an unpublished .tmp
    # directory are all skipped
    with open(os.path.join(d, "ckpt_00000003", "state.pt"), "r+b") as f:
        f.truncate(10)
    assert manager.latest_step(d) == 2
    with open(os.path.join(d, "ckpt_00000002", "manifest.json"), "w") as f:
        f.write("{not json")
    os.makedirs(os.path.join(d, "ckpt_00000009.tmp"))
    assert manager.latest_step(d) is None
    with pytest.raises(FileNotFoundError):
        manager.restore(d)
    cm = manager.CheckpointManager(d, keep=1)
    live = {"w": torch.zeros(3), "meta": {"step": 5}}
    cm.save_async(5, live)
    live["w"] += 1  # the snapshot was taken before this in-place update
    cm.wait()
    got, _, _ = cm.restore()
    assert torch.equal(got["w"], torch.zeros(3))


def _launch_train(workdir, capsys, mips: str, steps_: int) -> dict:
    train_launcher.main([
        "--arch", ARCH, "--smoke", "--vocab", "4096", "--mips", mips,
        "--steps", str(steps_), "--batch", "2", "--seq", "16", "--device",
        "cpu", "--index-refresh-every", "1", "--ckpt-every", "2",
        "--workdir", str(workdir)])
    out = json.loads(capsys.readouterr().out)
    assert out["status"] == "done" and out["step"] == steps_
    assert out["index_swaps"] == 0
    for key in ("loss", "nll", "aux", "log_z", "grad_norm", "lr"):
        assert np.isfinite(out[key])
    return out


def test_launcher_cpu_prints_reference_json(tmp_path, capsys):
    out = _launch_train(tmp_path, capsys, "ivf", 2)
    assert out["index_refreshes"] == 2


def test_launcher_cpu_ivfpq_runs_and_resumes(tmp_path, capsys, caplog):
    """``--mips ivfpq``: the IVF-PQ head trains, checkpoints its index
    (rows, centroids, codebooks) and resumes from it."""
    out = _launch_train(tmp_path, capsys, "ivfpq", 2)
    assert out["index_refreshes"] == 2
    st, _, _ = manager.restore(str(tmp_path), step=2)
    assert set(st["index"]) == {"db", "centroids", "codebooks"}
    caplog.set_level("INFO", logger="repro_torch.train")
    out = _launch_train(tmp_path, capsys, "ivfpq", 4)
    assert "resumed from step 2" in caplog.text
    assert out["index_refreshes"] == 2  # steps 3 and 4, after the resume


@pytest.mark.parametrize("flag", [["--dp", "2"], ["--tp", "2"],
                                  ["--sharded-ckpt"], ["--async-refresh"],
                                  ["--adaptive-probe"], ["--probe-router"],
                                  ["--n-probe-max", "4"],
                                  ["--n-probe-init", "2"]])
def test_launcher_refuses_unported_flags(flag, tmp_path, capsys,
                                         monkeypatch):
    """Every one of these reference-launcher flags is taken: ``--dp`` /
    ``--tp`` run one step on 2 spawned CPU ranks under gloo; every other
    flag sets its config field (the adaptive widths with
    ``--adaptive-probe``, as in the reference)."""
    base = ["--arch", ARCH, "--smoke", "--device", "cpu", "--workdir",
            str(tmp_path), "--steps", "1", "--batch", "2", "--seq", "16",
            "--vocab", "4096", "--mips", "ivf"]
    if flag[0] in ("--dp", "--tp"):
        # the launcher waits for its ranks with no deadline; this test
        # bounds its own run
        run_ranks = mesh_lib.run_ranks
        monkeypatch.setattr(mesh_lib, "run_ranks", functools.partial(
            run_ranks, timeout_s=50.0))
        train_launcher.main(base + flag)
        out = json.loads(capsys.readouterr().out)
        assert out["status"] == "done" and out["step"] == 1
        assert np.isfinite(out["loss"])
        return
    seen = {}

    def fake_train(cfg, run, workdir, device, mesh=None):
        seen.update(cfg=cfg, run=run)
        return {"status": "done"}

    monkeypatch.setattr(train_launcher, "_train", fake_train)
    extra = (["--adaptive-probe"] if flag[0].startswith("--n-probe")
             else [])
    train_launcher.main(base + extra + flag)
    cfg, run = seen["cfg"], seen["run"]
    want = {"--sharded-ckpt": run.sharded_ckpt is True,
            "--async-refresh": run.async_refresh,
            "--adaptive-probe": cfg.head_adaptive_probe,
            "--probe-router": run.fit_probe_router,
            "--n-probe-max": cfg.head_n_probe_max == 4,
            "--n-probe-init": cfg.head_n_probe_init == 2}
    assert want[flag[0]]


def test_launcher_refuses_nccl_without_a_card_per_rank(tmp_path, capsys,
                                                       monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit):
        train_launcher.main(["--arch", ARCH, "--smoke", "--dp", "2", "--tp",
                             "2", "--dist-backend", "nccl", "--workdir",
                             str(tmp_path)])
    assert "nccl needs one card per rank" in capsys.readouterr().err


def test_launcher_needs_cuda_without_device(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_launcher.main(["--arch", ARCH, "--smoke", "--steps", "1",
                             "--workdir", str(tmp_path)])
