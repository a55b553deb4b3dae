"""Helpers of the port's multi-rank tests: spawn ``world`` CPU ranks under
gloo (a ``file://`` rendezvous in the test's tmp dir, never a fixed port),
one thread each, run a module-level function on every rank and collect
what each rank saved. Nothing here imports JAX: the spawned ranks import
only torch and the port, so they start in a second or two; the tests
compare the ranks' results with the JAX package in the parent process.
"""
import os

import torch

from repro_torch.launch import mesh as mesh_lib

JOIN_TIMEOUT_S = 50.0  # every spawn joins within this, or the test fails
GROUP_TIMEOUT_S = 40.0  # a collective a peer never issues fails after this


def setup_rank(rank: int, world: int, init: str, dp: int, tp: int,
               device: str | None = "cpu"):
    """Join the gloo group with one thread, on the CPU (``device=None``:
    the card, every rank on ``cuda:<rank % cards>``) -> the (dp, tp)
    mesh."""
    torch.set_num_threads(1)
    mesh_lib.init_rank(rank, world, init, backend="gloo", device=device,
                       timeout_s=GROUP_TIMEOUT_S)
    return mesh_lib.make_train_mesh(dp, tp, timeout_s=GROUP_TIMEOUT_S)


def _worker(rank: int, fn, world: int, init: str, out_dir: str, dp: int,
            tp: int, args: tuple, device: str | None) -> None:
    mesh = setup_rank(rank, world, init, dp, tp, device)
    out = fn(mesh, *args)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


def spawn(fn, tmp_path, dp: int, tp: int, *args,
          timeout_s: float = JOIN_TIMEOUT_S, device: str | None = "cpu"
          ) -> list:
    """Run ``fn(mesh, *args)`` on every rank of a CPU ``(dp, tp)`` mesh ->
    each rank's return value (``torch.save``-able), in rank order. ``fn``
    must be a module-level function of a module that does not import JAX
    (the ranks import it by name)."""
    world = dp * tp
    out_dir = str(tmp_path / f"ranks_{fn.__name__}_{dp}x{tp}")
    os.makedirs(out_dir, exist_ok=True)
    init = mesh_lib.file_init_method(out_dir)
    mesh_lib.run_ranks(_worker, world,
                       (fn, world, init, out_dir, dp, tp, args, device),
                       timeout_s=timeout_s)
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


# ------------------------------------------------------------ rank programs
def mesh_layout(mesh):
    """The mesh as this rank sees it, and its groups exercised: the sums
    of the global ranks over each axis."""
    from repro_torch import collectives as coll

    r = torch.tensor([float(mesh.rank)])
    return {"rank": mesh.rank, "coords": mesh.coords,
            "model_ranks": mesh.model.ranks, "data_ranks": mesh.data.ranks,
            "model_sum": float(coll.psum(r, mesh.model)[0]),
            "data_sum": float(coll.psum(r, mesh.data)[0]),
            "world_max": float(coll.pmax(r, mesh.world)[0]),
            "gather": coll.all_gather(r, mesh.model)[:, 0].tolist(),
            "ring": float(coll.ppermute(r, mesh.model)[0]),
            "rows8": mesh_lib.data_rows(8, mesh),
            "rows3": mesh_lib.data_rows(3, mesh)}


def combine_cases(mesh, cases):
    """The cross-shard combines on this shard's slice of each case's
    stacked (mp, T) inputs: sample cases -> (ids, ok); loss cases -> (loss,
    d(loss · w)/d(log_z, y_t) of this shard)."""
    from repro_torch.core import estimators as est

    m = mesh.model.index
    out = []
    for c in cases:
        if c["kind"] == "sample":
            gid, ok = est.combine_sample_pmax(
                torch.from_numpy(c["gid"][m]), torch.from_numpy(c["val"][m]),
                torch.from_numpy(c["bound"][m]), torch.from_numpy(c["ok"][m]),
                mesh.model)
            out.append({"ids": gid.numpy(), "ok": ok.numpy()})
            continue
        lz = torch.from_numpy(c["log_z"][m]).requires_grad_(True)
        yt = torch.from_numpy(c["y_t"][m]).requires_grad_(True)
        loss = est.combine_loss_psum(est.LossPartials(lz, yt), c["mode"],
                                     mesh.model)
        (loss * torch.from_numpy(c["w"])).sum().backward()
        out.append({"loss": loss.detach().numpy(), "d_log_z": lz.grad.numpy(),
                    "d_y_t": yt.grad.numpy()})
    return out


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, tuple):
        return type(x)(*(_np(v) for v in x)) if hasattr(x, "_fields") \
            else tuple(_np(v) for v in x)
    return x


def sharded_index_cases(mesh, cases):
    """Per case: this shard's state as the port builds it (from the given
    per-shard initial values), and the GLOBAL queries of a ShardedIndex
    carried across from the reference's stacked state; ``memory_bytes``,
    ``refresh``'s shapes and the ``n % mp`` refusal."""
    from repro_torch.convert import sharded_index_from_jax
    from repro_torch.core import mips

    out = []
    for c in cases:
        cfg = c["config"]
        db = torch.from_numpy(c["db"])
        init = {k: torch.from_numpy(v) for k, v in c["init"].items()}
        built = mips.ShardedIndex.build(cfg, db, mesh, **init)
        n_loc = db.shape[0] // mesh.tp
        m = mesh.model.index
        db_loc = db[m * n_loc:(m + 1) * n_loc].clone()
        conv = sharded_index_from_jax(c["jax_state"], cfg, mesh, n_loc,
                                      db_loc=db_loc)
        q = torch.from_numpy(c["q"])
        res = {"state": _np(built.state), "offset": built.offset,
               "memory_bytes": conv.memory_bytes()}
        tk = conv.topk_batch(q, c["k"])
        res["topk"] = (_np(tk.ids), _np(tk.values))
        one = conv.topk(q[0], c["k"])
        res["topk_one"] = (_np(one.ids), _np(one.values))
        if c.get("adaptive"):
            atk = conv.topk_adaptive(q, c["k"], **c["adaptive"])
            res["adaptive"] = tuple(_np(x) for x in atk)
        fresh = built.refresh(db_loc + 0.01)
        res["refresh_same_shapes"] = all(
            a.shape == b.shape for a, b in zip(
                _leaves_of(built.state), _leaves_of(fresh.state)))
        try:
            mips.ShardedIndex.build(cfg, db[:-1], mesh)
            res["raises"] = False
        except ValueError:
            res["raises"] = True
        out.append(res)
    return out


def _leaves_of(state):
    if isinstance(state, torch.Tensor):
        return [state]
    return [x for x in state if isinstance(x, torch.Tensor)]


def _slice_rows(x, mesh):
    n = x.shape[0] // mesh.tp
    m = mesh.model.index
    return x[m * n:(m + 1) * n]


def dist_head_cases(mesh, spec):
    """The distributed head on this rank's rows: the losses (with d_emb of
    this shard and d_h) of each loss case, and the sampling runs."""
    import dataclasses

    from repro_torch import collectives as coll
    from repro_torch.core import mips
    from repro_torch.core.amortized_head import HeadConfig
    from repro_torch.launch.steps import slot_keys
    from repro_torch.models import head as dh

    m = mesh.model.index
    emb = torch.from_numpy(spec["emb"])
    out = {"loss": [], "sample": {}}
    for c in spec["loss"]:
        cfg = HeadConfig(**c["cfg"])
        e = _slice_rows(emb, mesh).clone().requires_grad_(True)
        h = torch.from_numpy(c["h"]).requires_grad_(True)
        draws = (None if c.get("draws") is None
                 else torch.from_numpy(c["draws"][m]))
        loss = dh.dist_head_loss(mesh, e, h, torch.from_numpy(c["tgt"]), cfg,
                                 draws=draws)
        (loss * torch.from_numpy(c["w"])).sum().backward()
        out["loss"].append({"loss": loss.detach().numpy(),
                            "d_emb": e.grad.numpy(), "d_h": h.grad.numpy()})
    s = spec.get("sample")
    if s is None:
        return out
    emb = torch.from_numpy(s["emb"])
    e = _slice_rows(emb, mesh)
    cfg = HeadConfig(**s["cfg"])
    h = torch.from_numpy(s["h"])
    for seed in s["seeds"]:
        rids = torch.arange(s["draws"])
        keys = slot_keys(seed + 200, rids, torch.zeros_like(rids))
        ids, ok, _ = dh.dist_head_sample(mesh, e, h[None].expand(
            s["draws"], -1), cfg, keys=keys)
        out["sample"][seed] = (ids.numpy(), ok.numpy())
    # fused vs unfused over an IVF shard, and the adaptive width
    icfg = HeadConfig(**s["ivf_cfg"])
    index = mips.build_index(mips.IVFConfig(n_probe=4, use_kernel=True), e,
                             mesh=mesh)
    q = torch.from_numpy(s["q"])
    rids = torch.arange(q.shape[0])
    keys = slot_keys(7, rids, rids)
    res = {}
    for fused in (False, True):
        c = dataclasses.replace(icfg, fused_decode=fused)
        res[fused] = dh.dist_head_sample(mesh, e, q, c, index, keys=keys)
    acfg = dataclasses.replace(icfg, adaptive_probe=True, n_probe_init=1,
                               n_probe_max=8)
    aind = mips.build_index(mips.IVFConfig(n_probe=4, n_probe_init=1,
                                           n_probe_max=8), e, mesh=mesh)
    a_ids, a_ok, a_w = dh.dist_head_sample(mesh, e, q, acfg, aind, keys=keys)
    k_loc = dh.shard_geometry(acfg.resolved(), emb.shape[0], mesh.tp)[1]
    local_w = aind.local.topk_adaptive(q, k_loc).width
    out["ivf"] = {"unfused": [x.numpy() for x in res[False]],
                  "fused": [x.numpy() for x in res[True]],
                  "adaptive_width": a_w.numpy(),
                  "local_widths": coll.all_gather(local_w,
                                                  mesh.model).numpy()}
    return out


def moe_dist_cases(mesh, spec):
    """``forward_dist`` for each case of ``spec["cases"]`` (an expert count
    and its full params), on this rank's experts ("ep") or hidden slice
    ("tp"), as ``launch.mesh.moe_mode`` places them: the mode, output, aux
    and the gradients of ``sum(out · w) + 3 aux``."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import moe

    tp, m = mesh.tp, mesh.model.index
    out = {}
    for name, c in spec["cases"].items():
        cfg = get_smoke(spec["arch"]).scaled(n_experts=c["n_experts"])
        mode = mesh_lib.moe_mode(cfg, tp)
        full = {k: torch.from_numpy(v) for k, v in c["params"].items()}
        if mode == "ep":
            e = cfg.n_experts // tp
            loc = {k: (v if k == "router" else v[m * e:(m + 1) * e])
                   for k, v in full.items()}
        else:
            f = cfg.expert_d_ff // tp
            loc = {"router": full["router"],
                   "w1": full["w1"][:, :, m * f:(m + 1) * f],
                   "w3": full["w3"][:, :, m * f:(m + 1) * f],
                   "w2": full["w2"][:, m * f:(m + 1) * f]}
        loc = {k: v.clone().requires_grad_(True) for k, v in loc.items()}
        x = torch.from_numpy(spec["x"]).requires_grad_(True)
        y, aux = moe.forward_dist(loc, cfg, x, mesh)
        ((y * torch.from_numpy(spec["w"])).sum() + 3.0 * aux).backward()
        out[name] = {"mode": mode, "out": y.detach().numpy(),
                     "aux": float(aux), "dx": x.grad.numpy(),
                     **{f"d_{k}": v.grad.numpy() for k, v in loc.items()}}
    return out


def ring_int8_cases(mesh, spec):
    """``ring_allreduce_int8`` of this rank's row over the data axis, for
    each seed, beside the exact sum."""
    from repro_torch import collectives as coll
    from repro_torch.optim.compress import ring_allreduce_int8

    x = torch.from_numpy(spec["x"][mesh.data.index])
    return {"exact": coll.psum(x, mesh.data).numpy(),
            "approx": [ring_allreduce_int8(x, mesh.data, s).numpy()
                       for s in spec["seeds"]]}


def _small_cfg(**kw):
    """The reference test's DP×TP model: smoke tinyllama at d 64, vocab
    4096."""
    from repro_torch.configs import get_smoke

    return get_smoke("tinyllama-1.1b").scaled(
        d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, vocab=4096, **kw)


def _host(tree):
    from repro_torch.optim import adamw

    return [t.detach().cpu().numpy() for t in adamw.tree_leaves(tree)]


def dist_step_case(mesh, spec):
    """One DP×TP train step from the reference's params on this rank's
    slices and data rows -> (loss, this rank's updated params, leaf
    paths)."""
    from repro_torch.convert import shard_params_from_jax
    from repro_torch.launch import steps
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw

    cfg = _small_cfg(head_mode="exact")
    model = Model(cfg, "f32", device="cpu", mesh=mesh)
    params = shard_params_from_jax(spec["params"], cfg, mesh)
    opt = adamw.init(params)
    batch = mesh_lib.data_shardings(
        {k: torch.from_numpy(v) for k, v in spec["batch"].items()}, mesh)
    step = steps.make_train_step(model, steps.TrainConfig(
        opt=adamw.OptConfig(**spec["opt"]), precision="f32"))
    params, opt, m = step(params, opt, batch, (0, 0))
    return {"loss": float(m["loss"]), "params": _host(params),
            "step": int(opt["step"])}


def _run_cfg(steps_):
    from repro_torch.launch.steps import TrainConfig
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train.trainer import RunConfig

    return RunConfig(num_steps=steps_, ckpt_every=4, log_every=100, batch=8,
                     seq=32, fuse_steps=2, index_refresh_every=4,
                     async_refresh=True, sharded_ckpt=True,
                     train=TrainConfig(opt=OptConfig(lr=1e-2, warmup_steps=2,
                                                     total_steps=12),
                                       precision="f32"))


def _restored(tr, step):
    st, meta, _ = tr.ckpt.restore(step=step, device="cpu")
    return {"params": _host(st["params"]), "m": _host(st["opt"]["m"]),
            "index": _host(st["index"]), "meta": meta}


def dist_trainer_case(mesh, spec):
    """The reference test's DP×TP Trainer run: 4 steps, then a resume to
    12, IVF head, async refresh, sharded checkpoints."""
    import json

    from repro_torch.core import mips
    from repro_torch.train.trainer import Trainer

    cfg = _small_cfg(head_mode="amortized", head_mips="ivf", head_k=96,
                     head_l=96)
    wd = spec["workdir"]
    tr = Trainer(cfg, _run_cfg(4), wd, device="cpu", mesh=mesh)
    out1 = tr.train()
    with open(f"{wd}/ckpt_00000004/manifest.json") as f:
        man = json.load(f)
    tr2 = Trainer(cfg, _run_cfg(12), wd, device="cpu", mesh=mesh)
    out2 = tr2.train()
    return {"status": (out1["status"], out2["status"], out2["step"]),
            "manifest": (man["sharded"], man["complete"]),
            "events": [(e["kick"], e["swap"]) for e in tr2.refresh_events],
            "swaps": tr2.index_swaps,
            "sharded_index": isinstance(tr2.head_index, mips.ShardedIndex),
            "losses": [m["loss"] for m in tr2.metrics_log],
            "restored4": _restored(tr2, 4)}


def dist_serve_case(mesh, spec):
    """A tp Server, fused T=4 against unfused T=1 over one ShardedIndex;
    and (dp 1) the step-4 checkpoint of the DP×TP run restored here."""
    import dataclasses

    from repro_torch.core import mips
    from repro_torch.models.model import Model
    from repro_torch.serve.server import ServeConfig, Server
    from repro_torch.train.trainer import Trainer

    out = {}
    if spec.get("workdir"):
        cfg = _small_cfg(head_mode="amortized", head_mips="ivf", head_k=96,
                         head_l=96)
        tr = Trainer(cfg, _run_cfg(12), spec["workdir"], device="cpu",
                     mesh=mesh)
        out["restored4"] = _restored(tr, 4)
    cfg = _small_cfg(head_mips="ivf")
    params = Model(cfg, "f32", device="cpu", mesh=mesh).init(0)
    toks = {}
    index = None
    for fused, window in ((True, 4), (False, 1), (True, 4)):
        c = dataclasses.replace(cfg, head_fused_decode=fused)
        srv = Server(c, params, ServeConfig(
            batch_slots=2, max_seq=48, max_new_tokens=6, decode_window=window),
            precision_policy="f32", device="cpu", index=index, mesh=mesh)
        index = srv.index
        res = srv.run(spec["prompts"])
        toks.setdefault(fused, []).append([r.tokens for r in res])
    out["fused"], out["unfused"] = toks[True], toks[False][0]
    out["sharded_index"] = isinstance(index, mips.ShardedIndex)
    out["index_bytes"] = srv.stats["index_bytes"]
    out["local_bytes"] = index.local.memory_bytes()
    return out


def _ckpt_layout(path, t):
    return ("dim", 0) if path[-1] == "out_embed" else ("rep", None)


def stale_tmp_save_case(mesh, spec):
    """Sharded saves into a workdir where crashed attempts left unpublished
    directories of the same steps, holding a manifest and a piece file of
    rank 1: ``save_sharded`` at step 2, then a ``CheckpointManager`` save
    at step 4. Rank 1 starts each save late, so a rank 0 that merged a
    stale manifest would publish before rank 1 wrote. -> what this rank
    restores at each step, and the workdir's entries after the saves."""
    import time

    from repro_torch.checkpoint import manager

    wd = spec["workdir"]
    rows = spec["rows"] // mesh.tp
    m = mesh.model.index
    out = {}
    for step in (2, 4):
        state = {"params": {
            "out_embed": torch.arange(rows * 3, dtype=torch.float32).reshape(
                rows, 3) + 100.0 * m + step,
            "w": torch.full((2,), float(step))}, "meta": {"step": step}}
        if step == 2:
            if mesh.rank == 1:
                time.sleep(1.0)
            manager.save_sharded(wd, step, state, mesh, _ckpt_layout)
        else:
            cm = manager.CheckpointManager(wd, sharded=True, mesh=mesh,
                                           layout=_ckpt_layout)
            if mesh.rank == 1:
                time.sleep(1.0)
            cm.save_async(step, state)
            cm.wait()
        torch.distributed.barrier()
        got, meta, _ = manager.restore(wd, step=step, mesh=mesh)
        out[step] = {"got": _np_tree(got), "want": _np_tree(
            {k: v for k, v in state.items() if k != "meta"}), "meta": meta}
    torch.distributed.barrier()
    out["entries"] = sorted(os.listdir(wd))
    return out


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def dist_train_all(mesh, spec):
    """The DP×TP step parity and the Trainer run, in one spawn."""
    return {"step": dist_step_case(mesh, spec),
            "trainer": dist_trainer_case(mesh, spec)}


def cuda_sharded_cases(mesh, spec):
    """On the card (ranks sharing it under gloo) and on the CPU, in one
    rank: a ShardedIndex's global top-k over the same per-shard state, and
    the distributed head's exact loss and fused IVF samples."""
    from repro_torch.core import mips
    from repro_torch.core.amortized_head import HeadConfig
    from repro_torch.launch.steps import slot_keys
    from repro_torch.models import head as dh

    emb = torch.from_numpy(spec["emb"])
    cpu_ix = mips.ShardedIndex.build(
        mips.IVFConfig(n_probe=4, use_kernel=True), emb, mesh,
        init_cent=torch.from_numpy(spec["init_cent"]))
    gpu_ix = mips.ShardedIndex(
        cpu_ix.config, mesh, "model", cpu_ix.n_local,
        mips.IVFIndex(cpu_ix.config, type(cpu_ix.state)(
            *(x.cuda() for x in cpu_ix.state))))
    q = torch.from_numpy(spec["q"])
    out = {}
    for dev, ix in (("cpu", cpu_ix), ("cuda", gpu_ix)):
        tk = ix.topk_batch(q.to(dev), 32)
        e = emb[ix.offset:ix.offset + ix.n_local].to(dev)
        h = q.to(dev)
        tgt = torch.from_numpy(spec["tgt"]).to(dev)
        loss = dh.dist_head_loss(mesh, e, h, tgt,
                                 HeadConfig(n=emb.shape[0], mode="exact"))
        rids = torch.arange(q.shape[0], device=dev)
        cfg = HeadConfig(n=emb.shape[0], k=32, l=32, mips="ivf",
                         fused_decode=True, min_amortized_n=0)
        ids, ok, _ = dh.dist_head_sample(mesh, e, h, cfg, ix,
                                         keys=slot_keys(5, rids, rids))
        out[dev] = {"ids": tk.ids.cpu().numpy(),
                    "values": tk.values.cpu().numpy(),
                    "loss": loss.cpu().numpy(), "sample": ids.cpu().numpy(),
                    "ok": ok.cpu().numpy()}
    return out
