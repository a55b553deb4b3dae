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
"""
from __future__ import annotations

import argparse
import json

from repro_torch.configs import ARCHS, get, get_smoke
from repro_torch.kernels.build import build_dir
from repro_torch.launch.steps import TrainConfig
from repro_torch.optim.adamw import OptConfig
from repro_torch.train.trainer import RunConfig, Trainer

# reference-launcher flags whose machinery is not in the port yet
_NOT_PORTED = {
    "dp": (1, "data parallelism (the mesh)"),
    "tp": (1, "tensor parallelism (the mesh)"),
    "sharded_ckpt": (False, "sharded checkpoints"),
    "async_refresh": (False, "the async double-buffered index refresh"),
    "adaptive_probe": (False, "the adaptive probe"),
    "n_probe_init": (0, "the adaptive probe"),
    "n_probe_max": (0, "the adaptive probe"),
    "probe_router": (False, "the probe router"),
}


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
    # accepted so that reference command lines fail with a clear message
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--sharded-ckpt", action="store_true")
    ap.add_argument("--async-refresh", action="store_true")
    ap.add_argument("--adaptive-probe", action="store_true")
    ap.add_argument("--n-probe-init", type=int, default=0)
    ap.add_argument("--n-probe-max", type=int, default=0)
    ap.add_argument("--probe-router", action="store_true")
    args = ap.parse_args(argv)
    for name, (default, what) in _NOT_PORTED.items():
        if getattr(args, name) != default:
            ap.error(f"--{name.replace('_', '-')}: {what} is not in the "
                     "PyTorch port yet")

    cfg = get_smoke(args.arch) if args.smoke else get(args.arch)
    if args.head:
        cfg = cfg.scaled(head_mode=args.head)
    if args.mips:
        cfg = cfg.scaled(head_mips=args.mips)
    if args.vocab:
        cfg = cfg.scaled(vocab=args.vocab)
    if args.head_use_kernel:
        cfg = cfg.scaled(head_use_kernel=True)
    run = RunConfig(
        num_steps=args.steps,
        batch=args.batch,
        seq=args.seq,
        ckpt_every=args.ckpt_every,
        fuse_steps=args.fuse_steps,
        index_refresh_every=args.index_refresh_every,
        index_drift_threshold=args.index_drift_threshold,
        train=TrainConfig(
            opt=OptConfig(lr=args.lr, total_steps=args.steps),
            accum=args.accum_steps,
            precision=args.precision,
        ),
    )
    trainer = Trainer(cfg, run, args.workdir, device=args.device)
    result = trainer.train()
    result["index_refreshes"] = trainer.index_refreshes
    result["index_swaps"] = 0  # no async refresh in the port: no swaps
    print(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
