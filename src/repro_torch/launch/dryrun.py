"""Multi-pod dry run: trace every (arch x shape x mesh) cell on meta tensors
and record its cost (counterpart of ``repro/launch/dryrun.py``).

For each cell this builds the model on the meta device over rank 0's view
of the production mesh (:func:`repro_torch.launch.mesh
.make_production_mesh`, virtual axes: no ranks, no process group), takes
rank 0's block of every parameter as ``param_spec`` places it and rank 0's
rows of the batch, and runs the cell's step once — ``make_train_step``,
``make_prefill_step`` / ``make_encode_step`` or ``make_serve_step`` —
under :class:`repro_torch.launch.cost_model.CostMode`. Nothing is
allocated and nothing is computed, so it runs on the CPU; the flops,
HBM bytes and collective bytes it records are per device, and
:mod:`repro_torch.launch.roofline` turns them into the three terms at the
H100's data-sheet peaks.

Memory (``mem``): ``args_gb`` the step's inputs (params, optimizer state,
batch, cache), ``temp_gb`` the high-water mark of the tensors the step
creates, ``out_gb`` its outputs that are new tensors, ``alias_gb`` the
input leaves it updates in place and returns (params and moments in
training, the cache in serving).

A data-dependent op on meta (``.item()``, ``torch.nonzero``) fails the cell,
naming the op; nothing guesses a value.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun             # all cells
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b
  PYTHONPATH=src python -m repro_torch.launch.dryrun --shape train_4k --multi-pod both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --json out.json
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback

import torch

from repro_torch.configs import ARCHS, get
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import roofline, specs, steps
from repro_torch.launch.cost_model import CostMode
from repro_torch.models.model import Model, _leaves, _meta_params, \
    active_param_count
from repro_torch.optim import adamw

__all__ = ["trace_cell", "run_cell", "main", "DEFAULT_ACCUM"]

# per-arch default accumulation: the reference's, which keeps the biggest
# models' activation and MoE dispatch buffers inside device memory
DEFAULT_ACCUM = {"mixtral-8x22b": 8, "qwen3-moe-30b-a3b": 4,
                 "granite-8b": 2, "recurrentgemma-9b": 2}


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for _, t in _leaves(tree)
               if isinstance(t, torch.Tensor))


def _mem(inputs, outputs) -> dict:
    """The step's memory figures in GB: inputs, outputs that are new
    tensors, and outputs that are input leaves updated in place."""
    ins = {id(t) for _, t in _leaves(inputs) if isinstance(t, torch.Tensor)}
    outs = [t for _, t in _leaves(outputs) if isinstance(t, torch.Tensor)]
    alias = sum(t.numel() * t.element_size() for t in outs if id(t) in ins)
    new = sum(t.numel() * t.element_size() for t in outs if id(t) not in ins)
    return {"args_gb": _bytes(inputs) / 2**30, "out_gb": new / 2**30,
            "alias_gb": alias / 2**30}


def trace_cell(arch: str, shape: str, mesh, tcfg: steps.TrainConfig,
               cfg=None):
    """Run the cell's step once on meta tensors under ``CostMode`` over
    ``mesh`` (rank 0's view) -> (cost record, mem dict, n_tokens, kind).
    The counterpart of the reference's ``lower_cell``."""
    cfg = cfg or get(arch)
    model = Model(cfg, precision_policy=tcfg.precision, device="meta",
                  mesh=mesh)
    kind = specs.SHAPES[shape]["kind"]
    data = specs.batch_specs(cfg, shape)
    seq = specs.SHAPES[shape]["seq"]
    batch = specs.SHAPES[shape]["batch"]
    params = meshlib.shard_params(_meta_params(cfg), mesh, cfg)

    if kind == "train":
        opt = adamw.init(params)
        b = meshlib.data_shardings(data["batch"], mesh)
        step = steps.make_train_step(model, tcfg)
        inputs = (params, opt, b)
        with CostMode() as mode:
            out = step(params, opt, b, (0, 0))
        n_tokens = batch * seq
    elif kind == "prefill":
        b = meshlib.data_shardings(data["batch"], mesh)
        inputs = (params, b)
        if cfg.encoder_only:
            step = steps.make_encode_step(model)
            with CostMode() as mode:
                out = step(params, b)
        else:
            rows = next(iter(b.values())).shape[0]
            keys = steps.slot_keys(
                0, torch.arange(rows, device="meta"),
                torch.full((rows,), seq - 1, device="meta"))
            step = steps.make_prefill_step(model, max_seq=seq)
            with CostMode() as mode:
                out = step(params, b, keys)
        n_tokens = batch * seq
    else:  # decode: serve_step over a seq-long cache, one new token
        sp = model.compute_params(params)
        d = meshlib.data_shardings({"ids": data["ids"], "pos": data["pos"]},
                                   mesh)
        cache = model.init_cache(d["ids"].shape[0], seq)
        keys = steps.slot_keys(0, d["ids"], d["pos"])
        step = steps.make_serve_step(model)
        inputs = (sp, cache, d)
        with CostMode() as mode:
            out = step(sp, cache, d["ids"], d["pos"], keys)
        n_tokens = batch
    mem = _mem(inputs, out)
    mem["temp_gb"] = mode.cost.peak_bytes / 2**30
    return mode.cost, mem, n_tokens, kind


def run_cell(arch: str, shape: str, multi_pod: bool, tcfg, verbose=True,
             cfg=None) -> dict:
    mesh = meshlib.make_production_mesh(multi_pod=multi_pod)
    mesh_name = mesh.name
    n_dev = mesh.size
    cfg = cfg or get(arch)
    reason = specs.skip_reason(cfg, shape)
    if reason:
        return {"arch": arch, "shape": shape, "mesh": mesh_name,
                "status": "skip", "reason": reason}
    t0 = time.time()
    try:
        cost, mem, n_tokens, kind = trace_cell(arch, shape, mesh, tcfg,
                                               cfg=cfg)
        t_trace = time.time() - t0
        n_active = active_param_count(cfg)
        model_flops = (6 if kind == "train" else 2) * n_active * n_tokens
        rep = roofline.analyze(arch, shape, mesh_name, n_dev, cost,
                               model_flops, mem)
        out = {
            "arch": arch, "shape": shape, "mesh": mesh_name, "kind": kind,
            "status": "ok",
            "flops_per_device": rep.flops_per_device,
            "flops_by_dtype": rep.flops_by_dtype,
            "bytes_per_device": rep.bytes_per_device,
            "coll_bytes_per_device": rep.coll_bytes_per_device,
            "coll_detail": rep.coll_detail,
            "t_compute_ms": rep.t_compute * 1e3,
            "t_memory_ms": rep.t_memory * 1e3,
            "t_collective_ms": rep.t_collective * 1e3,
            "bottleneck": rep.bottleneck,
            "model_flops": model_flops,
            "useful_frac": rep.useful_frac,
            "mem": mem,
            "hbm_top": rep.hbm_top,
            "coll_top": rep.coll_top,
            "kernels": cost.kernels,
            "trace_s": round(t_trace, 1),
        }
        if verbose:
            hbm = mem["args_gb"] + mem["temp_gb"]
            print(
                f"[ok] {arch:>18s} {shape:>11s} {mesh_name:>8s} "
                f"comp={out['t_compute_ms']:8.2f}ms "
                f"mem={out['t_memory_ms']:8.2f}ms "
                f"coll={out['t_collective_ms']:8.2f}ms "
                f"bn={rep.bottleneck:<10s} hbm/dev={hbm:6.2f}GB "
                f"useful={rep.useful_frac * 100:5.1f}% "
                f"(trace {t_trace:.0f}s)",
                flush=True,
            )
        return out
    except Exception as e:  # noqa: BLE001 — report, don't abort the sweep
        if verbose:
            print(f"[FAIL] {arch} {shape} {mesh_name}: {e}", flush=True)
            traceback.print_exc()
        return {"arch": arch, "shape": shape, "mesh": mesh_name,
                "status": "fail", "error": str(e)[:2000]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all",
                    choices=["all", *specs.SHAPES])
    ap.add_argument("--multi-pod", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--accum", type=int, default=0,
                    help="grad-accum microbatches (0 = per-arch default)")
    ap.add_argument("--json", default="", help="write results to this file")
    args = ap.parse_args()

    archs = list(ARCHS) if args.arch == "all" else [args.arch]
    shapes = list(specs.SHAPES) if args.shape == "all" else [args.shape]
    pods = {"single": [False], "multi": [True], "both": [False, True]}[
        args.multi_pod
    ]

    results = []
    fails = 0
    for arch in archs:
        accum = args.accum or DEFAULT_ACCUM.get(arch, 1)
        tcfg = steps.TrainConfig(accum=accum)
        for shape in shapes:
            for mp in pods:
                r = run_cell(arch, shape, mp, tcfg)
                results.append(r)
                fails += r["status"] == "fail"
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
    ok = sum(r["status"] == "ok" for r in results)
    skip = sum(r["status"] == "skip" for r in results)
    print(f"\ndry-run: {ok} ok / {skip} skip / {fails} FAIL "
          f"(of {len(results)} cells)")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
