"""Training launcher for the PyTorch port (counterpart of
``repro/launch/train.py``), on CUDA unless ``--device`` says otherwise.

  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
      --smoke --vocab 4096 --mips ivf --steps 12 --workdir build/run1

``--smoke`` uses the arch's reduced config; without it the full config.
``--head`` selects the softmax mode (the paper's Table-2 comparison).
Resume is automatic from the latest complete checkpoint in ``--workdir``
(default: ``build/train`` in the checkout; give each run its own);
drop a PREEMPT file there (or send SIGTERM) for a clean
preempt-checkpoint-exit. Weights are random, drawn from seed 0; data is the
synthetic Zipf stream. Prints the reference launcher's final JSON.

``--dp D --tp T`` trains on a ``(D, T)`` mesh: the launcher spawns ``D·T``
rank processes (``torch.multiprocessing``), each joins the process group
through a ``file://`` rendezvous in the workdir under ``--dist-backend``
(``gloo``, the default, or ``nccl``, which needs a card per rank and is
refused otherwise) and runs on ``cuda:<rank % cards>``, or on the CPU with
``--device cpu``. Every leaf is a rank's block as
``launch.mesh.param_spec`` places it: the trunk Megatron-split over the
model axis and FSDP-split over the data axis, the embeddings' rows over
the model axis. Rank 0's result is printed. On a multi-rank mesh the
checkpoints are sharded; ``--sharded-ckpt`` asks for that layout on one
rank too.
"""
from __future__ import annotations

import argparse
import json
import os

import torch

from repro_torch.configs import ARCHS, get, get_smoke
from repro_torch.kernels.build import build_dir
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.steps import TrainConfig
from repro_torch.optim.adamw import OptConfig
from repro_torch.train.trainer import RunConfig, Trainer

_RESULT = "result.json"  # rank 0's final JSON, read back by the launcher


def _train(cfg, run: RunConfig, workdir: str, device, mesh=None) -> dict:
    trainer = Trainer(cfg, run, workdir, device=device, mesh=mesh)
    result = trainer.train()
    result["index_refreshes"] = trainer.index_refreshes
    result["index_swaps"] = trainer.index_swaps
    return result


def _rank_main(rank: int, world: int, init_method: str, backend: str,
               device, dp: int, tp: int, cfg, run: RunConfig,
               workdir: str) -> None:
    """One rank of a ``(dp, tp)`` run (spawned by :func:`main`)."""
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dev = mesh_lib.init_rank(rank, world, init_method, backend=backend,
                             device=device)
    mesh = mesh_lib.make_train_mesh(dp, tp)
    result = _train(cfg, run, workdir, dev, mesh)
    if rank == 0:
        with open(os.path.join(workdir, _RESULT), "w") as f:
            json.dump(result, f)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(ARCHS))
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum-steps", "--accum", dest="accum_steps", type=int,
                    default=1, help="gradient-accumulation microbatches per "
                                    "optimizer step (grads summed in fp32)")
    ap.add_argument("--fuse-steps", type=int, default=1,
                    help="T: optimizer steps per window between host syncs")
    ap.add_argument("--precision", default="bf16", choices=["f32", "bf16"])
    ap.add_argument("--head", default=None,
                    choices=[None, "exact", "topk_only", "amortized"])
    ap.add_argument("--mips", default=None,
                    choices=[None, "exact", "ivf", "ivfpq", "lsh"],
                    help="head top-k backend (ivf / ivfpq: stateful, "
                         "refreshed index; lsh: SRP-LSH, rehashed on "
                         "refresh)")
    ap.add_argument("--vocab", type=int, default=0,
                    help="override vocab size (e.g. to exercise the "
                         "amortized head on a smoke config)")
    ap.add_argument("--index-refresh-every", type=int, default=0,
                    help="R > 0: refresh the head MIPS index every R steps")
    ap.add_argument("--index-drift-threshold", type=float, default=0.0,
                    help="> 0: refresh when relative embedding drift exceeds")
    ap.add_argument("--head-use-kernel", action="store_true",
                    help="on the CPU, run the head through the plain "
                         "versions of its kernels (ivf_gather_score, "
                         "fused_estimator and its backward; the IVF-PQ "
                         "screen always takes pq_lut_score's); on CUDA the "
                         "kernels always run")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, which must exist)")
    ap.add_argument("--workdir", default=str(build_dir().parent / "train"),
                    help="checkpoints, resumed from automatically (default: "
                         "build/train in the checkout)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--async-refresh", action="store_true",
                    help="double-buffered index refresh: rebuild on a side "
                         "thread while stepping against the stale index; "
                         "swap at the next window boundary")
    ap.add_argument("--dp", type=int, default=1,
                    help="data-parallel mesh axis size (ranks: dp*tp)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel (model) mesh axis size: the "
                         "trunk (Megatron), both embeddings, the head index "
                         "and the MoE experts shard over it; the trunk's "
                         "other dim shards over dp (FSDP)")
    ap.add_argument("--dist-backend", default="gloo",
                    choices=["gloo", "nccl"],
                    help="torch.distributed backend of a dp*tp > 1 run "
                         "(nccl: one card per rank)")
    ap.add_argument("--sharded-ckpt", action="store_true",
                    help="sharded checkpoint layout (automatic on a "
                         "multi-rank mesh)")
    ap.add_argument("--adaptive-probe", action="store_true",
                    help="certificate-gated staged probe widening in the "
                         "head's MIPS queries (ivf/ivfpq)")
    ap.add_argument("--n-probe-init", type=int, default=0,
                    help="adaptive probe start width (0: head n_probe)")
    ap.add_argument("--n-probe-max", type=int, default=0,
                    help="adaptive probe width ceiling (0: head n_probe)")
    ap.add_argument("--probe-router", action="store_true",
                    help="fit the adaptive stage router on probe traces at "
                         "index-refresh boundaries; saved to "
                         "workdir/router.npz")
    args = ap.parse_args(argv)
    world = args.dp * args.tp
    if args.dp < 1 or args.tp < 1:
        ap.error("--dp and --tp must be >= 1")
    if args.dist_backend == "nccl" and world > 1:
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if args.device not in (None, "cuda") or world > cards:
            ap.error(f"--dist-backend nccl needs one card per rank: {world} "
                     f"ranks, {cards} cards (ranks that share a card run "
                     "under gloo)")

    cfg = get_smoke(args.arch) if args.smoke else get(args.arch)
    if args.head:
        cfg = cfg.scaled(head_mode=args.head)
    if args.mips:
        cfg = cfg.scaled(head_mips=args.mips)
    if args.vocab:
        cfg = cfg.scaled(vocab=args.vocab)
    if args.head_use_kernel:
        cfg = cfg.scaled(head_use_kernel=True)
    if args.adaptive_probe:
        cfg = cfg.scaled(head_adaptive_probe=True,
                         head_n_probe_init=args.n_probe_init,
                         head_n_probe_max=args.n_probe_max)
    run = RunConfig(
        num_steps=args.steps,
        batch=args.batch,
        seq=args.seq,
        ckpt_every=args.ckpt_every,
        fuse_steps=args.fuse_steps,
        index_refresh_every=args.index_refresh_every,
        index_drift_threshold=args.index_drift_threshold,
        async_refresh=args.async_refresh,
        sharded_ckpt=True if args.sharded_ckpt else None,
        fit_probe_router=args.probe_router,
        train=TrainConfig(
            opt=OptConfig(lr=args.lr, total_steps=args.steps),
            accum=args.accum_steps,
            precision=args.precision,
        ),
    )
    if world == 1:
        result = _train(cfg, run, args.workdir, args.device)
    else:
        os.makedirs(args.workdir, exist_ok=True)
        res_path = os.path.join(args.workdir, _RESULT)
        if os.path.exists(res_path):
            os.remove(res_path)
        mesh_lib.run_ranks(
            _rank_main, world,
            (world, mesh_lib.file_init_method(args.workdir),
             args.dist_backend, args.device, args.dp, args.tp, cfg, run,
             args.workdir))
        with open(res_path) as f:
            result = json.load(f)
    print(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
