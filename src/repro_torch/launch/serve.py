"""Serving launcher for the PyTorch port (counterpart of
``repro/launch/serve.py``): the pipelined batched-decode engine over the
amortized lazy-Gumbel sampler, on CUDA unless ``--device`` says otherwise.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
      --mips ivf --fused-decode --requests 8 --new-tokens 32

Weights are random, drawn from seed 0; prompts are random token ids. Every
flag of the reference launcher is taken; encoder-only archs (no decode) are
refused, as in the reference. The launcher serves on one device; a TP
mesh serves through ``Server(mesh=)`` (:mod:`repro_torch.serve.server`),
the trunk sharded.
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch.configs import ARCHS, get, get_smoke
from repro_torch.models.model import Model
from repro_torch.serve.server import ServeConfig, Server


def report(results, server: Server) -> dict:
    """The JSON report of a serving run (the reference launcher's fields)."""
    toks = sum(len(r.tokens) for r in results)
    st = server.stats
    done = [r for r in results if r.status == "ok"]
    return {
        "requests": len(results),
        "decoded_tokens": toks,
        "tokens_per_s": round(toks / st["wall_s"], 1),
        "prefill_tokens": st["prefill_tokens"],
        "prefill_dispatches": st["prefill_dispatches"],
        "decode_dispatches": st["decode_dispatches"],
        "ok_rate": round(st["ok"] / max(st["tokens"], 1), 4),
        "fallbacks": st["fallbacks"],
        "rejected": st["rejected"],
        "steps": st["steps"],
        "ttft_p50_ms": round(1e3 * float(np.median(
            [r.ttft_s for r in done] or [0.0])), 2),
        "itl_p50_ms": round(float(np.median(
            [r.itl_ms for r in done] or [0.0])), 3),
        "queue_p50_ms": round(1e3 * float(np.median(
            [r.queue_time_s for r in done] or [0.0])), 2),
        "queue_depth_peak": st["queue_depth_peak"],
        "slot_occupancy_peak": st["slot_occupancy_peak"],
        "block_util_peak": round(st["block_util_peak"], 4),
        "block_stalls": st["block_stalls"],
        "cache_mb": round(st["cache_bytes"] / 1e6, 3),
        "index_mb": round(st["index_bytes"] / 1e6, 2),
        "probe_width_hist": {
            str(k): v for k, v in sorted(st["probe_width_hist"].items())},
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(ARCHS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--head", default=None,
                    choices=[None, "exact", "topk_only", "amortized"])
    ap.add_argument("--mips", default=None,
                    choices=[None, "exact", "ivf", "ivfpq", "lsh"],
                    help="head top-k backend (ivf: stateful IVF index; "
                         "ivfpq: IVF with uint8 PQ codes and an exact "
                         "re-rank; lsh: SRP-LSH, the theory index)")
    ap.add_argument("--vocab", type=int, default=0,
                    help="override vocab size (e.g. to exercise the "
                         "amortized head on a smoke config)")
    ap.add_argument("--engine", default="pipelined",
                    choices=["pipelined", "reference"],
                    help="pipelined: batched prefill + decode windows; "
                         "reference: one step per token (comparator)")
    ap.add_argument("--decode-window", type=int, default=8,
                    help="tokens decoded per window (pipelined engine)")
    ap.add_argument("--prefill-chunk", type=int, default=32,
                    help="prompt-length padding bucket for batched prefill")
    ap.add_argument("--overlength", default="truncate",
                    choices=["truncate", "reject"],
                    help="admission policy for prompts longer than "
                         "max_seq - new_tokens")
    ap.add_argument("--block-len", type=int, default=0,
                    help="paged KV cache: block size in positions (0: dense "
                         "slot-reserved rings). Must divide the attention "
                         "ring length min(window or max-seq, max-seq)")
    ap.add_argument("--n-blocks", type=int, default=0,
                    help="paged KV cache: shared pool size in blocks "
                         "(0: auto — slots * pages per slot, the dense "
                         "layout's coverage)")
    ap.add_argument("--sched", default="fifo", choices=["fifo", "slo"],
                    help="admission scheduler: fifo (arrival order, fixed "
                         "window) or slo (priority + TTFT-deadline order, "
                         "adaptive decode window)")
    ap.add_argument("--ttft-slo", type=float, default=0.5,
                    help="slo scheduler: per-request TTFT target (seconds)")
    ap.add_argument("--strict", action="store_true",
                    help="re-sample certificate-failed tokens exactly")
    ap.add_argument("--head-use-kernel", action="store_true",
                    help="on the CPU, run the unfused IVF probe "
                         "through ivf_gather_score's plain version (the "
                         "IVF-PQ screen always takes pq_lut_score's); on "
                         "CUDA the kernels always run")
    ap.add_argument("--fused-decode", action="store_true",
                    help="fused decode head: the index's fused screen "
                         "(ivf_screen_select, or pq_screen_select + "
                         "rerank_select) + tail_gather_argmax")
    ap.add_argument("--adaptive-probe", action="store_true",
                    help="certificate-gated staged probe widening: probe "
                         "n-probe-init clusters per token, widen only for "
                         "tokens whose gap certificate fails (ivf/ivfpq)")
    ap.add_argument("--n-probe-init", type=int, default=0,
                    help="adaptive probe start width (0: head n_probe)")
    ap.add_argument("--n-probe-max", type=int, default=0,
                    help="adaptive probe width ceiling (0: head n_probe)")
    ap.add_argument("--probe-router", default="",
                    help="adaptive stage router: 'fit' trains at start-up, "
                         "else a router .npz path "
                         "(repro_torch.models.router)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, which must exist)")
    args = ap.parse_args(argv)

    cfg = get_smoke(args.arch) if args.smoke else get(args.arch)
    if not cfg.has_decode:
        raise SystemExit(f"{cfg.name} is encoder-only: no decode serving")
    if args.head:
        cfg = cfg.scaled(head_mode=args.head)
    if args.mips:
        cfg = cfg.scaled(head_mips=args.mips)
    if args.vocab:
        cfg = cfg.scaled(vocab=args.vocab)
    if args.head_use_kernel:
        cfg = cfg.scaled(head_use_kernel=True)
    if args.fused_decode:
        cfg = cfg.scaled(head_fused_decode=True)
    if args.adaptive_probe:
        cfg = cfg.scaled(head_adaptive_probe=True,
                         head_n_probe_init=args.n_probe_init,
                         head_n_probe_max=args.n_probe_max)
    model = Model(cfg, device=args.device)
    params = model.init(0)
    rng = np.random.default_rng(0)
    prompts = [
        list(rng.integers(0, cfg.vocab, size=rng.integers(4, 12)))
        for _ in range(args.requests)
    ]
    server = Server(cfg, params, ServeConfig(
        batch_slots=args.slots, max_seq=args.max_seq,
        max_new_tokens=args.new_tokens, engine=args.engine,
        decode_window=args.decode_window, prefill_chunk=args.prefill_chunk,
        overlength=args.overlength, strict=args.strict,
        probe_router=args.probe_router, block_len=args.block_len,
        n_blocks=args.n_blocks, sched=args.sched, ttft_slo_s=args.ttft_slo,
    ), device=model.device)
    results = server.run(prompts)
    print(json.dumps(report(results, server), indent=1))


if __name__ == "__main__":
    main()
