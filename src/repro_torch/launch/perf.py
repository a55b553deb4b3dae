"""Perf hill-climb tool: trace one cell with knob overrides and record its
roofline terms (counterpart of ``repro/launch/perf.py``).

  PYTHONPATH=src python -m repro_torch.launch.perf --arch stablelm-3b \\
      --shape prefill_32k --q-block 1024 --kv-block 1024

Knobs, each mapped to the port's counterpart: the blockwise-attention tile
sizes (``models.attention.Q_BLOCK`` / ``KV_BLOCK``), the grad-accumulation
factor, the MoE placement (``launch.mesh.MOE_SHARDING``, tp | ep), the head
mode (exact | topk_only | amortized), the head's score dtype and its token
chunk (``HeadConfig.score_dtype`` / ``chunk``). The reference's
``--scores-dtype`` (the attention probability blocks' dtype) has no
counterpart: the port's attention keeps its scores in fp32, and the knob
raises. Every override is undone when the cell returns. Results append to
``--log`` (JSON lines).
"""
from __future__ import annotations

import argparse
import dataclasses
import json

from repro_torch.configs import get
from repro_torch.core import amortized_head as ah
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import steps
from repro_torch.launch.dryrun import DEFAULT_ACCUM, run_cell
from repro_torch.models import attention

__all__ = ["run_with", "main"]


def run_with(
    arch: str,
    shape: str,
    *,
    multi_pod: bool = False,
    accum: int = 0,
    q_block: int = 0,
    kv_block: int = 0,
    moe: str = "",
    head_mode: str = "",
    score_dtype: str = "",
    scores_dtype: str = "",  # attention probability blocks: no counterpart
    chunk: int = 0,
    tag: str = "",
    verbose: bool = True,
) -> dict:
    if scores_dtype:
        raise ValueError(
            "scores_dtype (the attention probability blocks' dtype) has no "
            "counterpart in the port: its attention scores are fp32")
    saved = (attention.Q_BLOCK, attention.KV_BLOCK, meshlib.MOE_SHARDING,
             ah.HeadConfig.resolved)
    try:
        if q_block:
            attention.Q_BLOCK = q_block
        if kv_block:
            attention.KV_BLOCK = kv_block
        if moe:
            meshlib.MOE_SHARDING = moe
        cfg = get(arch)
        if head_mode:
            cfg = cfg.scaled(head_mode=head_mode)
        if score_dtype or chunk:
            orig = saved[3]
            repl = {}
            if score_dtype:
                repl["score_dtype"] = score_dtype
            if chunk:
                repl["chunk"] = chunk

            def patched(self):
                return dataclasses.replace(orig(self), **repl)

            ah.HeadConfig.resolved = patched
        tcfg = steps.TrainConfig(accum=accum or DEFAULT_ACCUM.get(arch, 1))
        out = run_cell(arch, shape, multi_pod, tcfg, verbose=verbose,
                       cfg=cfg)
        out["knobs"] = dict(
            accum=tcfg.accum, q_block=attention.Q_BLOCK,
            kv_block=attention.KV_BLOCK, moe=meshlib.MOE_SHARDING,
            head_mode=cfg.head_mode, score_dtype=score_dtype or "f32",
            chunk=chunk or ah.HeadConfig.chunk, tag=tag,
        )
        return out
    finally:
        (attention.Q_BLOCK, attention.KV_BLOCK, meshlib.MOE_SHARDING,
         ah.HeadConfig.resolved) = saved


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--accum", type=int, default=0)
    ap.add_argument("--q-block", type=int, default=0)
    ap.add_argument("--kv-block", type=int, default=0)
    ap.add_argument("--moe", default="", choices=["", "tp", "ep"])
    ap.add_argument("--head-mode", default="")
    ap.add_argument("--score-dtype", default="", choices=["", "f32", "bf16"])
    ap.add_argument("--scores-dtype", default="", choices=["", "f32", "bf16"])
    ap.add_argument("--chunk", type=int, default=0)
    ap.add_argument("--tag", default="")
    ap.add_argument("--log", default="perf_log.jsonl")
    args = ap.parse_args()
    out = run_with(
        args.arch, args.shape, multi_pod=args.multi_pod, accum=args.accum,
        q_block=args.q_block, kv_block=args.kv_block, moe=args.moe,
        head_mode=args.head_mode, score_dtype=args.score_dtype,
        scores_dtype=args.scores_dtype,
        chunk=args.chunk, tag=args.tag,
    )
    with open(args.log, "a") as f:
        f.write(json.dumps(out) + "\n")


if __name__ == "__main__":
    main()
