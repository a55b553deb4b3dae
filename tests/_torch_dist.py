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


def _paths(tree):
    """Leaf paths in :func:`_host`'s order."""
    from repro_torch.launch.steps import _sorted_leaves

    return [p for p, _ in _sorted_leaves(tree)]


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
            "paths": _paths(params), "step": int(opt["step"])}


def cost_train_case(mesh, spec):
    """One DP×TP train step of the small model (exact head, fp32) under the
    cost model on this rank -> its collective bytes by "kind@axis" and
    its collective counts by kind."""
    from repro_torch.launch import steps
    from repro_torch.launch.cost_model import CostMode
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw

    cfg = _small_cfg(head_mode="exact")
    model = Model(cfg, "f32", device="cpu", mesh=mesh)
    params = model.init(0)
    opt = adamw.init(params)
    batch = mesh_lib.data_shardings(
        {k: torch.from_numpy(v) for k, v in spec["batch"].items()}, mesh)
    step = steps.make_train_step(model, steps.TrainConfig(precision="f32"))
    with CostMode() as mode:
        step(params, opt, batch, (0, 0))
    c = mode.cost
    return {"by_axis": {f"{k}@{a}": b for (k, a), b in c.coll_by_axis.items()},
            "counts": dict(c.coll_counts)}


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
            "paths": _paths(st["params"]), "index": _host(st["index"]),
            "meta": meta}


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


def ring_serve_case(mesh, spec):
    """A tp Server of recurrentgemma's smoke config (its one KV head: the
    dense ring split over positions) with the IVF head: fused T=4 against
    unfused T=1 over one ShardedIndex -> both runs' tokens and the ring's
    positions on this rank."""
    import dataclasses

    from repro_torch.configs import get_smoke
    from repro_torch.models.model import Model
    from repro_torch.serve.server import ServeConfig, Server

    cfg = get_smoke("recurrentgemma-9b").scaled(
        vocab=4096, head_mips="ivf", local_window=spec["window"])
    params = Model(cfg, "f32", device="cpu", mesh=mesh).init(0)
    toks, index, ring = {}, None, None
    for fused, window in ((True, 4), (False, 1)):
        c = dataclasses.replace(cfg, head_fused_decode=fused)
        srv = Server(c, params, ServeConfig(
            batch_slots=2, max_seq=spec["max_seq"],
            max_new_tokens=spec["new_tokens"], decode_window=window),
            precision_policy="f32", device="cpu", index=index, mesh=mesh)
        index = srv.index
        toks[fused] = [r.tokens for r in srv.run(spec["prompts"])]
        ring = next(lay["k"].shape[2] for g in srv.cache for lay in g.values()
                    if "k" in lay)
    return {"fused": toks[True], "unfused": toks[False], "ring": ring}


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


# ------------------------------------------------------------- the trunk
def _path_grads(tree, path=()):
    """{"a/b/c": grad as numpy} of a params tree whose leaves carry
    ``.grad``."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_path_grads(v, path + (str(k),)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_path_grads(v, path + (str(i),)))
    elif tree is not None:
        out["/".join(path)] = tree.grad.detach().numpy()
    return out


def trunk_loss_case(mesh, cfg, np_params, batch):
    """The exact-head loss of ``batch`` through the vocab-parallel lookup,
    the trunk and the distributed head on this rank's blocks of the full
    ``np_params`` (numpy, the reference's) -> (total, d(total)/d(embedded
    input), {path: this rank's gradient block}). ``mesh`` None: one
    device."""
    from repro_torch.convert import params_from_jax
    from repro_torch.core import amortized_head as ah
    from repro_torch.models import head as dh
    from repro_torch.models import transformer
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw

    model = Model(cfg, "f32", device="cpu", mesh=mesh)
    params = params_from_jax(np_params, cfg)
    if mesh is not None:
        params = mesh_lib.shard_params(params, mesh, cfg)
    diff = adamw.tree_map(lambda p: p.detach().requires_grad_(True), params)
    if cfg.frontend == "audio_stub":
        x = torch.from_numpy(batch["frames"]).requires_grad_(True)
    else:
        x = model._lookup(diff, torch.from_numpy(batch["tokens"]))
        x.retain_grad()
    b, l, _ = x.shape
    pos = torch.arange(l)[None].expand(b, l)
    h, aux = transformer.apply_trunk(diff, cfg, x, pos, mesh=mesh)
    h2 = h.reshape(b * l, -1)
    t2 = torch.from_numpy(batch["labels"]).reshape(-1).long()
    emb = model._out_embed(diff)
    if mesh is None:
        loss = ah.head_loss(emb, h2, t2, model.head_cfg).loss
    else:
        loss = dh.dist_head_loss(mesh, emb, h2, t2, model.head_cfg)
    total = loss.mean() + 0.01 * aux
    total.backward()
    return {"loss": float(total.detach()), "d_x": x.grad.numpy(),
            "grads": _path_grads(diff)}


def trunk_decode_case(mesh, cfg, np_params, spec, paged: bool):
    """Prefill two right-padded prompts into the serving cache, then three
    decode steps, through the trunk on this rank's blocks -> the hidden
    states of each step and the final cache (this rank's blocks)."""
    from repro_torch.convert import params_from_jax
    from repro_torch.models import transformer
    from repro_torch.models.model import Model

    model = Model(cfg, "f32", device="cpu", mesh=mesh)
    params = params_from_jax(np_params, cfg)
    if mesh is not None:
        params = mesh_lib.shard_params(params, mesh, cfg)
    max_seq, bl = spec["max_seq"], spec["block_len"]
    layout = (transformer.PagedLayout(block_len=bl, n_blocks=spec["n_blocks"])
              if paged else None)
    b = spec["tokens"].shape[0]
    cache = model.init_cache(b, max_seq, paged=layout)
    pages = torch.from_numpy(spec["pages"]) if paged else None
    tokens = torch.from_numpy(spec["tokens"])
    lengths = torch.from_numpy(spec["lengths"])
    hs = []
    with torch.no_grad():
        x = model._lookup(params, tokens)
        l = x.shape[1]
        pos = torch.arange(l)[None].expand(b, l)
        h, part = transformer.apply_trunk_prefill(
            params, cfg, x, pos, max_seq=max_seq, lengths=lengths, mesh=mesh)
        hs.append(h[torch.arange(b), lengths.long() - 1].numpy())
        cache = transformer.insert_cache_slots(cache, part, torch.arange(b),
                                               pages=pages, mesh=mesh)
        ids = torch.from_numpy(spec["next_ids"])
        p = lengths.long()
        for i in range(ids.shape[0]):
            x = model._lookup(params, ids[i])[:, None]
            h, cache = transformer.apply_trunk_decode(
                params, cfg, x, cache, p, pages=pages,
                write_mask=torch.ones(b, dtype=torch.bool) if paged else None,
                mesh=mesh)
            hs.append(h[:, 0].numpy())
            p = p + 1
    return {"h": hs, "cache": [{j: {k: v.numpy() for k, v in lay.items()}
                                for j, lay in g.items()} for g in cache]}


def ring_decode_cases(mesh, spec):
    """:func:`trunk_decode_case` (dense) for each case of ``spec``, its
    smoke config scaled by the case's ``kw`` (a short window, so the ring
    wraps) -> {name: its hidden states and final cache}."""
    from repro_torch.configs import get_smoke

    return {name: trunk_decode_case(
        mesh, get_smoke(c["arch"]).scaled(**dict(c["kw"], head_mode="exact")),
        c["params"], c, False) for name, c in spec.items()}


def rglru_rep_case(mesh, spec):
    """One RG-LRU layer on this rank's blocks of ``spec["params"]`` (numpy,
    stacked over one layer) where ``tp`` does not divide the 8 gate blocks
    (the whole block on every rank): the forward of ``spec["x"]``, the
    gradients of ``sum(out * w)`` with respect to x and to this rank's
    leaves, then a prefill cache and two decode steps (``mesh`` None: one
    device)."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import rglru

    cfg = get_smoke("recurrentgemma-9b").scaled(**spec["kw"])
    specs, leaves = {}, {}
    for k, v in spec["params"].items():
        t = torch.from_numpy(v)
        if mesh is not None:
            sp = mesh_lib.param_spec([k], tuple(t.shape), mesh, cfg)
            d = mesh_lib.shard_dim(sp)
            t = mesh_lib.local_slice(t, d, mesh.tp, mesh.model.index)
            specs[k] = sp[1:]
        leaves[k] = t[0].clone().requires_grad_(True)
    x = torch.from_numpy(spec["x"]).requires_grad_(True)
    kw = dict(mesh=mesh, spec=specs if mesh is not None else None)
    out, cache = rglru.forward(leaves, cfg, x, return_cache=True, **kw)
    (out * torch.from_numpy(spec["w"])).sum().backward()
    res = {"out": out.detach().numpy(), "d_x": x.grad.numpy(),
           "grads": {k: v.grad.numpy() for k, v in leaves.items()}}
    steps_ = []
    with torch.no_grad():
        for xd in spec["x_dec"]:
            o, cache = rglru.decode(leaves, cfg, torch.from_numpy(xd), cache,
                                    **kw)
            steps_.append(o.numpy())
    res["dec"] = steps_
    res["cache"] = {k: v.numpy() for k, v in cache.items()}
    return res


def trunk_cases(mesh, spec):
    """Every case of ``spec`` on this rank: the families' loss and
    gradients, tied embeddings, ``encode`` and the decode runs."""
    import dataclasses

    from repro_torch.configs import get_smoke
    from repro_torch.convert import params_from_jax
    from repro_torch.models.model import Model

    out = {"loss": {}, "decode": {}}
    for name, c in spec.get("loss", {}).items():
        cfg = dataclasses.replace(get_smoke(c["arch"]), **c.get("kw", {}))
        out["loss"][name] = trunk_loss_case(mesh, cfg, c["params"], c["batch"])
    for name, c in spec.get("decode", {}).items():
        cfg = get_smoke(c["arch"]).scaled(head_mode="exact")
        out["decode"][name] = trunk_decode_case(mesh, cfg, c["params"], c,
                                                c["paged"])
    if "encode" in spec:
        c = spec["encode"]
        cfg = get_smoke(c["arch"]).scaled(head_mode="exact")
        model = Model(cfg, "f32", device="cpu", mesh=mesh)
        params = mesh_lib.shard_params(params_from_jax(c["params"], cfg),
                                       mesh, cfg)
        out["encode"] = model.encode(
            params, {"frames": torch.from_numpy(c["frames"])}).numpy()
    return out


def serve_tier_case(mesh, spec):
    """The serving tier on this rank of a tp mesh (the trunk sharded):
    fifo and slo (a 1 ms TTFT target, so slo shrinks its windows) under
    staggered arrivals, paged (block_len 8) against dense, and the
    adaptive probe with ``probe_router="fit"`` (its weights), then the
    router rank 0 saved, reloaded from its ``.npz``."""
    import dataclasses

    from repro_torch.models import router as router_lib
    from repro_torch.models.model import Model
    from repro_torch.serve.server import ServeConfig, Server

    cfg = _small_cfg(head_mips="ivf")
    params = Model(cfg, "f32", device="cpu", mesh=mesh).init(0)
    prompts, arrivals = spec["prompts"], spec["arrivals"]
    kw = dict(batch_slots=2, max_seq=48, max_new_tokens=6, seed=3,
              decode_window=4)
    out, index = {}, None

    def serve(c, scfg, **run_kw):
        nonlocal index
        srv = Server(c, params, scfg, precision_policy="f32", device="cpu",
                     index=index, mesh=mesh)
        index = srv.index
        return srv, [r.tokens for r in srv.run(prompts, **run_kw)]

    fifo, out["fifo"] = serve(cfg, ServeConfig(**kw), arrivals=arrivals)
    out["fifo_dispatches"] = fifo.stats["decode_dispatches"]
    slo, out["slo"] = serve(cfg, ServeConfig(sched="slo", ttft_slo_s=1e-3,
                                             **kw),
                            arrivals=arrivals, priorities=spec["priorities"])
    out["slo_dispatches"] = slo.stats["decode_dispatches"]
    _, out["paged"] = serve(cfg, ServeConfig(block_len=8, **kw))
    _, out["dense"] = serve(cfg, ServeConfig(**kw))
    acfg = dataclasses.replace(cfg, head_adaptive_probe=True,
                               head_n_probe_init=1, head_n_probe_max=8,
                               head_fused_decode=True)
    index = None
    fit, out["fit"] = serve(acfg, ServeConfig(probe_router="fit", **kw))
    out["router"] = {f: v.numpy() for f, v in fit.router._asdict().items()}
    path = os.path.join(spec["dir"], "router.npz")
    if mesh.rank == 0:
        router_lib.save_router(path, fit.router)
    torch.distributed.barrier()
    _, out["loaded"] = serve(acfg, ServeConfig(probe_router=path, **kw))
    return out
