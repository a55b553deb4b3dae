#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA
GPU: builds the CUDA kernels from ``src/repro_torch/csrc``, holds each one
against its plain PyTorch version at the shapes of the paths that run it
(``flash_decode`` also at tinyllama's 2,048-position context,
``ivf_gather_score`` and ``ivf_screen_select`` also at 256 queries with
skewed probes) and times it
by device time alone (:class:`Timer`), beside its host issue time, then,
for each head index (IVF, then IVF-PQ)

* serves a full-width tinyllama-1.1b (random weights from ``--seed``) with
  the fused head and again with the unfused kernel probe at decode window
  1, over one shared index, and checks that both give the same tokens;
* trains the full-width tinyllama-1.1b for 6 steps (bf16 trunk, fp32
  masters, amortized head on the kernels, index refresh every 3 steps, a
  checkpoint at step 3), checks a finite and falling loss, and resumes
  from the step-3 checkpoint to check that the resumed steps match;

after serving with both indexes, it times warm serving repeats of the two,
interleaved (wall, decode-dispatch and index-query host time, syncs per
token). The paged ``flash_decode`` is held against its plain version
(gather + the dense plain version) and against the dense kernel over the
gathered view, at block_len 64 and 16 over permuted blocks with sentinel
pages, at 4 x 512 and 4 x 2,048 positions, and timed beside the dense
kernel, the plain version and gather + SDPA. Then the ``[serve-tier]``
phase, on the serving phase's weights and prompts: the paged pool (IVF and
IVF-PQ; block_len 64 on an auto pool, then 16 on a pool of 8 blocks, so
admission stalls) must serve the dense run's tokens; the slo scheduler
must serve fifo's streams under staggered arrivals (the windows it picks
are printed); strict re-sampling at the default head and at |T| = 8 (its
fallbacks, ITL, warm wall and syncs per token beside the lazy run's; every
request whose certificates all held keeps its tokens); the single-step
reference engine (4 requests x 8 tokens) must equal the pipelined one;
the adaptive probe (2 -> 16 clusters) fused T=8 must equal unfused T=1 for
both indexes, and a fitted, saved and reloaded probe router must leave
the tokens as they were; a ``refresh_index`` with the same params over an
index whose clustering has converged must keep its member tables and the
tokens (the default index's drift under one refresh is printed). At the
end it runs six more steps with each top-k probe (exact,
IVF, IVF-PQ) reading the amortized loss beside the exact NLL, and profiles
one training step with each index. The profiled serving and training runs
give each kernel's device time per call on its path (``path_us``).

Then the ``[paper]`` phase: the paper's own setting
(``configs/paper_loglinear.py``) at ImageNet width (n 1,281,167, d 256, 64
queries) and word-embedding width (n 2,000,126, d 300, 32 queries) over a
seeded clustered table made on the card, queries θ = row / τ, an IVF index
of √n clusters (4 Lloyd iterations, 16 probes). ``ivf_gather_score`` is
held against its plain version at the path's shapes (16 and 64 probes);
the path runs once with the launch counts at 0 (``topk_batch``,
``sample_fixed_b``, ``sample_adaptive_b``, ``partition_estimate``,
``expectation_estimate`` with f = φ, ``topk_adaptive`` widening 4 … 64 and
``gumbel_max_dense``); the gates: no NaN, every certified top-k equal to
the exact top-k up to ties at the k-th value, init == max equal to ``topk_batch``
bit for bit, log Ẑ of Algorithm 3 within rtol 1e-5 of ``fused_estimator``
on the same S ∪ T (and Algorithm 4's E[φ] within rtol 1e-4, atol 1e-5 of
its expectation). Reported: recall@k, each sampler's ok rate and m
against n/k, |log Ẑ − log Z|, the certified share and widths, and
device-event ms a query of each stage. Last, at the LM head's geometry
(32,000 rows of d 2048, k 576), the fused adaptive probe must equal the
unfused bit for bit for IVF and IVF-PQ, and the stage kernels
(``ivf_screen_select``, ``pq_screen_select``, ``rerank_select``) their
plain versions at mixed per-row widths.

Last, the ``[families]`` phase: the other trunk families at full width
(random weights from ``--seed``, bf16 compute, fp32 masters, the IVF
head), each cut in depth only, with the cut printed. The kernels first,
at the shapes these families give them, each against its plain version:
``flash_decode`` at recurrentgemma-9b's heads (16 query heads on one KV
head of 256) and qwen3-moe's (32 on 4, 128) over a 2,048-position ring,
``ivf_gather_score`` and ``ivf_screen_select`` at mamba2-780m's head (d
1,536, k 704; the screen bit for bit the gather plus a top-k),
``fused_estimator`` and its backward at mamba2-780m's training chunk.
Then mamba2-780m at 24 of its 48 layers served (8 requests x 32
tokens, fused T=8 ≡ unfused T=1) and trained (6 steps, refresh and
checkpoint every 3, the resume from step 3 within rtol 1e-3);
recurrentgemma-9b at 8 layers served with the unfused head (its 28,224-slot
pool is past the fused screens' 16,384), paged at block_len 64 ≡ dense;
qwen3-moe-30b-a3b at 2 layers served twice with bitwise equal tokens and
trained 3 steps (aux, the dropped-assignment share at prefill and in
training, the experts' load); paligemma-3b and hubert-xlarge at 2 layers
trained 2 steps each, and hubert's encode step once. Each model's line
gives tokens/s, TTFT and ITL p50, step time, peak device memory, index MB
and its seconds beside the card's name and power limit.

Last, the ``[index-side]`` phase, at tinyllama-1.1b's full width (random
weights from ``--seed``, the ``[serve]`` prompts): the SRP-LSH head (8
tables × 10 bits, bucket cap 144 by the head's sizing) served fused T=8
and unfused T=1 over one index (same tokens; ``dropped_count``, tokens/s,
ITL p50, ``ok_rate``, index MB) and trained through ``Trainer`` at 8 of
the 22 layers (2 × 1,024 tokens, 3 steps, refresh and checkpoint every
2; the resume from
step 2, which rebuilds the index from the saved rows, must give the
uninterrupted run's loss bit for bit); structured search through the
head's IVF index with the amortized log Z (4 beams × 8 steps, expand_k
64): stochastic beam search twice (bitwise equal, distinct beams), MAP
against greedy decoding (beam width 1: top beam's logp ≥ greedy's, within
1e-3 relative, batch 4 against batch 1); deep-kNN over the 23 taps on the
launcher's band classification with an exact and an IVF index per tap
(the exact index's neighbours = the fp64 brute-force cosine kNN up to ties
at the k-th value, same nonconformity where no tie); the LSH sampler (32
tables × 6 bits, cap = n, no row dropped) against Algorithm 3 on the
paper's 160,000 × 256 ImageNet table (RMSE against the exact log Z,
device-event ms a query); IVF-PQ at the head's geometry built with
anisotropic η 4 and 0 (build seconds, recall@576). Each kernel record
gains ``launches_index_side``.

Last, the ``[sharded]`` phase: ranks spawned on the one card and joined
under gloo (NCCL refuses two ranks on one card), every collective on a
CUDA tensor crossing the host (counted). Every leaf is a rank's block
as ``launch.mesh.param_spec`` places it (the trunk Megatron-split over
``model``, FSDP-split over ``data``; the embeddings' rows over
``model``). The kernels first, at one model shard's shapes: of
tinyllama's head (16,000 rows: ``ivf_gather_score`` and
``ivf_screen_select`` bit for bit, ``tail_gather_argmax``,
``fused_estimator``) and of its trunk (``flash_decode``, dense and paged
at block_len 64, on 16 query heads over 2 KV heads), each against its
plain version as ``shard_*`` keys; then on tp 2: the int8 ring
all-reduce (relative error below 0.04 of the exact sum), tinyllama-1.1b
at full depth, the trunk sharded, served over an IVF ``ShardedIndex``
(8 requests × 16 new tokens, the traffic cut printed):
fused T=8 ≡ unfused T=1, twice bitwise (the second run under staggered
arrivals), paged (block_len 64) ≡ dense, slo ≡ fifo under the arrivals
(rank 0's clock decides), with ITL,
tokens/s, index MB a shard and in all, host-staged bytes a token, and
the KV and trunk MB a rank; the exact-mode distributed head at full
width equal to the single-device one (rtol 1e-5); qwen3-moe at 2 of 48
layers with 64 of 128 experts a rank (``forward_dist`` ≡ ``forward``,
served once, trained 2 steps); then dp 2 × tp 2: tinyllama-1.1b at full
width and depth through ``Trainer`` (IVF head, async refresh and
sharded checkpoints every 2 steps, 4 steps of 2 × 1,024 tokens; the loss
falls, the swap lands at 4 after the kick at 2, the manifest reads
sharded and complete, every replicated leaf (the norms) equal on the
four ranks, the step-4 checkpoint restored whole on one process equal to
the four ranks' blocks put together; the peak memory a rank) and a
resume from step 2 whose losses equal the uninterrupted run's bit for
bit. Also on tp 2: the IVF-PQ and SRP-LSH heads over their own
``ShardedIndex`` (4 requests × 16 tokens, fused T=8 ≡ unfused T=1), and
recurrentgemma-9b at full width, 8 of 38 layers, with the IVF head: its
one KV head does not divide, so each rank holds 1,024 of the 2,048-row
window's positions and the ranks combine ``flash_decode``'s log-sum-exp
(4 requests of 1,000–2,040 prompt tokens × 32 new tokens at max_seq
4,096, crossing the shard boundary and wrapping the ring; decode window 8
≡ 1 and a bitwise repeat; fp32 teacher-forced logits within 1e-4 of one
device at every step; KV MB a rank half of one device's), after the
``flash_decode_lse`` kernel at that shard's shape. Each kernel record
gains ``launches_sharded`` (summed over the ranks).

After ``[train]``, the ``[cost]`` phase: one serving decode step (4
slots, the 512-position ring, the fused IVF head) and one training step
(2 × 1,024 tokens) of full-width tinyllama-1.1b traced under the cost
model's ``CostMode`` on the card and as a meta trace: their flops, HBM
bytes and per-kernel counts must be equal; printed beside the step's
device time, the modelled ``t_compute`` / ``t_memory`` / bound at the
H100's data-sheet peaks, and the traced ``temp_gb`` beside
``max_memory_allocated``.

    python3 chip_smoke.py            # from the repository root

Output, in order: the GPU line of nvidia-smi, build and check lines, the
serve, ``[serve-tier]``, train, ``[paper]``, ``[families]``,
``[index-side]`` and ``[sharded]`` reports,
one ``{"kernels": [...]}`` line, the card's name and power limit, and last
``{"ok": true, "device": {...}}``. Any failed
phase exits non-zero before the last line. Without CUDA, or without the
repository beside it, the script exits non-zero and prints no result.

Tolerances (the ``[families]`` phase's too): ids and indices exact; fp32 values rtol=1e-5, atol=1e-5;
on small-integer inputs the IVF and IVF-PQ kernels' values bit for bit;
rerank_select and ivf_gather_score on random fp32 rows rtol=1e-5 and an
atol of 1e-5 times the largest magnitude (2048-term dot products summed in
different orders: a score that cancels to near 0 keeps the rounding of its
terms);
flash_decode, dense and paged (bf16 inputs, fp32 output), atol=2e-3 (the paged
one bit for bit the dense kernel over the gathered view); fused_estimator and its
backward at training shapes rtol=1e-4 and an atol of 1e-5 times the largest
magnitude of the tensor compared (2048-term dot products and sums of up to
thousands of p·h terms, taken in different orders; the values span many
orders of magnitude, so a fixed atol would hide whole strata), with the S
stratum's share of p held on its own, NaN where the plain version has
NaN; the resumed losses rtol=1e-3 of the
uninterrupted run's (the trunk's backward on the card is not bitwise run
to run: the embedding-gather backward and some cuBLAS kernels accumulate in
a varying order); with the exact top-k probe, the amortized loss within
0.05 nats of the exact NLL of the same batch.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet, dense): the least time of a kernel is
# the larger of bytes / HBM rate and flops / the rate of their type
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12

# the serving run: 8 requests of 4-12 prompt tokens, 32 new tokens each, on
# 4 slots of a 512-position KV ring, fused decode window 8
REQUESTS, NEW_TOKENS, SLOTS, MAX_SEQ, WINDOW = 8, 32, 4, 512, 8
ITERS = 20  # timed launches per kernel
LONG_CONTEXT = 2048  # tinyllama-1.1b's context: flash_decode's second shape

# the training run: batch 2 x seq 1024 = 2048 tokens a step (8 head chunks of
# 256, two attention query blocks), 6 steps, index refresh every 3, a
# checkpoint every 3
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_EVERY = 2, 1024, 6, 3
TRAIN_OPT = dict(lr=1e-4, warmup_steps=2, total_steps=TRAIN_STEPS)
RESUME_RTOL = 1e-3
EXACT_PROBE_GAP = 0.05  # nats: amortized loss vs exact NLL, exact probe
HEAD_CHUNK = 256  # HeadConfig.chunk: tokens per fused_estimator launch

TPU_KERNEL = {
    "flash_decode": "src/repro/kernels/flash_decode.py:82",
    # the same Pallas kernel, reading the paged KV pool through page tables
    # (the reference gathers the ring view in XLA first)
    "flash_decode_paged": "src/repro/kernels/flash_decode.py:82",
    "ivf_gather_score": "src/repro/kernels/ivf_gather_score.py:65",
    "ivf_screen_select": "src/repro/kernels/decode_fused.py:190",
    "tail_gather_argmax": "src/repro/kernels/decode_fused.py:471",
    "fused_estimator": "src/repro/kernels/fused_estimator.py:76",
    # the backward of fused_estimator's custom VJP (_fused_logz_bwd)
    "fused_estimator_bwd": "src/repro/core/estimators.py:229",
    "pq_lut_score": "src/repro/kernels/pq_lut_score.py:74",
    "pq_screen_select": "src/repro/kernels/decode_fused.py:299",
    "rerank_select": "src/repro/kernels/decode_fused.py:389",
}
SOURCE = {
    "flash_decode": "src/repro_torch/csrc/flash_decode.cu",
    "flash_decode_paged": "src/repro_torch/csrc/flash_decode.cu",
    "ivf_gather_score": "src/repro_torch/csrc/ivf_gather_score.cu",
    "ivf_screen_select": "src/repro_torch/csrc/decode_fused.cu",
    "tail_gather_argmax": "src/repro_torch/csrc/decode_fused.cu",
    "fused_estimator": "src/repro_torch/csrc/fused_estimator.cu",
    "fused_estimator_bwd": "src/repro_torch/csrc/fused_estimator.cu",
    "pq_lut_score": "src/repro_torch/csrc/pq_lut_score.cu",
    "pq_screen_select": "src/repro_torch/csrc/decode_fused.cu",
    "rerank_select": "src/repro_torch/csrc/decode_fused.cu",
}
MIPS = ("ivf", "ivfpq")  # the head indexes served and trained


class Failed(RuntimeError):
    """A phase's check did not hold."""


def check(cond: bool, what: str) -> None:
    if not cond:
        raise Failed(what)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- timing
class Timer:
    """Median per-launch device time of a call, with CUDA events around its
    device work alone. L2 (50 MB) is flushed before every timed launch, as
    the serving path finds it cold. The stream is then held busy
    (``torch.cuda._sleep``) for longer than the host takes to issue the
    call, so the call's kernels are already queued when the first event
    fires, and the host's issue time (wrapper, allocation, binding, launch)
    falls outside the pair. The hold is sized from the call's own host time
    (:meth:`host_us`) with a margin, and doubled and re-timed if the host
    outlasted it in any launch; a call that still outlasts it (one that
    waits on the device itself) is listed in ``uncovered``."""

    def __init__(self, torch, iters: int):
        self.torch = torch
        self.iters = iters
        self.flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
        self.uncovered: list[str] = []
        torch.cuda._sleep(1000)  # first-use costs
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        torch.cuda._sleep(1 << 21)
        b.record()
        b.synchronize()
        self.cycles_per_us = (1 << 21) / (1e3 * a.elapsed_time(b))

    def host_us(self, fn) -> float:
        """Median host time to issue ``fn()``: host clock around the call,
        no sync inside it (one after it, outside the clock)."""
        torch = self.torch
        times = []
        for _ in range(self.iters):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times.append(1e6 * (time.perf_counter() - t0))
        torch.cuda.synchronize()
        return statistics.median(times)

    def both(self, fn, label: str = "") -> tuple[float, float]:
        """(median device ms per call, median host issue us per call)."""
        torch = self.torch
        fn()  # warm-up (and first-use costs)
        host = self.host_us(fn)
        hold_us = 2.0 * host + 50.0
        for _ in range(4):
            times, late = [], 0
            for _ in range(self.iters):
                self.flush.zero_()
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                t0 = time.perf_counter()
                torch.cuda._sleep(int(hold_us * self.cycles_per_us))
                a.record()
                fn()
                late += 1e6 * (time.perf_counter() - t0) >= hold_us
                b.record()
                b.synchronize()
                times.append(a.elapsed_time(b))
            if not late:
                break
            hold_us *= 2
        else:
            self.uncovered.append(label)
        return statistics.median(times), host

    def __call__(self, fn, label: str = "") -> float:
        return self.both(fn, label)[0]


def bound_ms(nbytes: float, flops: float, peak: float) -> tuple[float, str]:
    t_b = nbytes / HBM_BYTES_PER_S
    t_o = flops / peak
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def kcost():
    """``repro_torch.kernels.cost``: each kernel's bytes and operations,
    the one count of a bound here and of a launch in the cost model."""
    from repro_torch.kernels import cost

    return cost


# ---------------------------------------------------------------- kernels
def close(torch, got, want, rel: float = 1e-5) -> bool:
    """allclose at rtol 1e-4 and an atol of ``rel`` times the largest
    finite magnitude of ``want`` (NaN where ``want`` has NaN)."""
    fin = want[torch.isfinite(want)]
    scale = fin.abs().max().item() if fin.numel() else 0.0
    return torch.allclose(got, want, rtol=1e-4, atol=rel * scale,
                          equal_nan=True)


def make_record(name, err, timed, plain_ms, lib_ms, nb, flops, peak) -> dict:
    """One entry of the ``{"kernels": [...]}`` line (launches and path_us
    filled in from the main path's runs later), printed as a check line;
    ``timed`` is :meth:`Timer.both` of the kernel's call."""
    ms, host = timed
    b_ms, b_by = bound_ms(nb, flops, peak)
    print(f"[kernel] {name}: ok max_abs_err={err:.3g} ms={ms:.4f} "
          f"host_us={host:.1f} plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} "
          f"({b_by}) library_ms={lib_ms}", flush=True)
    return {"name": name, "route": "cuda", "source": SOURCE[name],
            "replaces": TPU_KERNEL[name], "launches": 0, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms, "host_us": host,
            "path_us": None}


@dataclasses.dataclass
class Geometry:
    """The serving path's kernel shapes at tinyllama-1.1b width."""

    slots: int
    max_seq: int
    hq: int
    hkv: int
    hd: int
    n: int
    d: int
    n_c: int
    cap: int
    o_cap: int
    n_probe: int
    k: int
    m_cap: int
    m_sub: int  # IVF-PQ: subspaces, codewords, re-rank pool
    ksub: int
    r: int


def geometry(cfg, scfg) -> Geometry:
    from repro_torch.core.gumbel import default_m_cap
    from repro_torch.core.mips.ivf import IVFConfig, _geometry
    from repro_torch.core.mips.pq import PQConfig
    from repro_torch.models.model import head_config

    hc = head_config(cfg)
    n_c, cap, o_cap = _geometry(cfg.vocab, IVFConfig(n_probe=hc.n_probe))
    pq = PQConfig()
    return Geometry(scfg.batch_slots, scfg.max_seq, cfg.n_heads,
                    cfg.n_kv_heads, cfg.head_dim, cfg.vocab, cfg.d_model,
                    n_c, cap, o_cap, hc.n_probe, hc.k, default_m_cap(hc.l),
                    pq.m_sub, pq.ksub, 2 * max(8, hc.k))


def int_valued(torch, gen, shape, lo=-2, hi=3):
    """fp32 tensor of small integers: every dot product over d <= 2^20 is
    exact in fp32 in any summation order, so kernel and plain version must
    agree bit for bit — ids and tie-breaks included."""
    return torch.randint(lo, hi, shape, generator=gen, device="cuda",
                         dtype=torch.int32).float()


def flash_decode_case(torch, gen, g: Geometry, timer: Timer, S: int,
                      lengths) -> dict:
    """flash_decode on a bf16 KV ring of ``g.slots`` sequences x ``S``
    positions at tinyllama's heads: checked against its plain version
    (atol 2e-3), each sequence computed alone equal bit for bit to the
    batch's row, two launches equal; timed beside the plain version and
    SDPA (GQA, masked), with the bytes and flops of its bound."""
    from repro_torch.kernels import flash_decode as kfd
    from repro_torch.kernels import ref

    B = g.slots
    q = torch.randn((B, g.hq, g.hd), generator=gen, device="cuda").bfloat16()
    kc = torch.randn((B, S, g.hkv, g.hd), generator=gen,
                     device="cuda").bfloat16()
    vc = torch.randn((B, S, g.hkv, g.hd), generator=gen,
                     device="cuda").bfloat16()
    got = kfd.flash_decode(q, kc, vc, lengths)
    again = kfd.flash_decode(q, kc, vc, lengths)
    alone = [kfd.flash_decode(q[i:i + 1], kc[i:i + 1], vc[i:i + 1],
                              lengths[i:i + 1]) for i in range(B)]
    want = ref.flash_decode_ref(q, kc, vc, lengths)
    torch.cuda.synchronize()
    check(got.shape == want.shape and bool(torch.isfinite(got).all()),
          f"flash_decode S={S}: shape / finiteness")
    err = (got - want).abs().max().item()
    check(torch.allclose(got, want, rtol=0, atol=2e-3),
          f"flash_decode S={S} disagrees with its plain version: {err}")
    check(torch.equal(got, again), f"flash_decode S={S}: two launches differ")
    check(all(torch.equal(a[0], got[i]) for i, a in enumerate(alone)),
          f"flash_decode S={S}: a sequence alone differs from the batch")
    mask = (torch.arange(S, device="cuda")[None] < lengths[:, None])
    mask = mask[:, None, None, :]
    qs, ks, vs = q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2)
    try:
        sdpa = torch.nn.functional.scaled_dot_product_attention
        sdpa(qs, ks, vs, attn_mask=mask, enable_gqa=True)
        lib = timer(lambda: sdpa(qs, ks, vs, attn_mask=mask, enable_gqa=True),
                    "sdpa")
    except TypeError:  # a PyTorch without GQA in SDPA: no one-call yardstick
        lib = None
    c = kcost().flash_decode(q, kc, lengths,
                             live=int(lengths.clamp(1, S).sum().item()))
    return {"err": err,
            "timed": timer.both(lambda: kfd.flash_decode(q, kc, vc, lengths),
                                "flash_decode"),
            "plain_ms": timer(lambda: ref.flash_decode_ref(q, kc, vc, lengths),
                              "flash_decode plain"),
            "lib_ms": lib, "nb": c.bytes, "flops": c.flops}


def flash_decode_paged_case(torch, gen, g: Geometry, timer: Timer, S: int,
                            lengths, block_len: int) -> dict:
    """The paged flash_decode on a bf16 pool of permuted blocks: each of
    ``g.slots`` sequences owns S / block_len pages, the pages past its
    length hold the sentinel (the sink block's id). Checked against its
    plain version (gather + the dense plain version, atol 2e-3), bit for bit
    against the dense kernel over the gathered view and against itself,
    and with NaN in every row no sequence may read (the sink, the unowned
    blocks, each last block past its length): a read would poison the
    output. Timed beside the dense kernel at the same lengths, the plain
    version and gather + SDPA (GQA, masked)."""
    from repro_torch.kernels import flash_decode as kfd
    from repro_torch.kernels import ref

    B = g.slots
    n_pages = S // block_len
    n_blocks = B * n_pages + 7
    shape = (n_blocks + 1, block_len, g.hkv, g.hd)
    q = torch.randn((B, g.hq, g.hd), generator=gen, device="cuda").bfloat16()
    kp = torch.randn(shape, generator=gen, device="cuda").bfloat16()
    vp = torch.randn(shape, generator=gen, device="cuda").bfloat16()
    perm = torch.randperm(n_blocks, generator=gen, device="cuda")
    used = (lengths.long() + block_len - 1) // block_len
    pages = torch.where(torch.arange(n_pages, device="cuda")[None]
                        < used[:, None], perm[: B * n_pages].view(B, n_pages),
                        n_blocks).int()
    got = kfd.flash_decode(q, kp, vp, lengths, pages=pages)
    again = kfd.flash_decode(q, kp, vp, lengths, pages=pages)
    want = ref.flash_decode_paged_ref(q, kp, vp, lengths, pages)
    idx = pages.long().clamp(max=n_blocks)
    view = (B, S, g.hkv, g.hd)
    kv, vv = kp[idx].reshape(view), vp[idx].reshape(view)
    dense = kfd.flash_decode(q, kv, vv, lengths)
    torch.cuda.synchronize()
    tag = f"flash_decode_paged S={S} block_len={block_len}"
    check(got.shape == want.shape and bool(torch.isfinite(got).all()),
          f"{tag}: shape / finiteness")
    err = (got - want).abs().max().item()
    check(torch.allclose(got, want, rtol=0, atol=2e-3),
          f"{tag} disagrees with its plain version: {err}")
    check(torch.equal(got, again), f"{tag}: two launches differ")
    check(torch.equal(got, dense), f"{tag} != the dense kernel over the "
          "gathered view")
    kn, vn = kp.clone(), vp.clone()
    owned = torch.zeros(n_blocks + 1, dtype=torch.bool, device="cuda")
    owned[idx.flatten()] = True
    owned[n_blocks] = False
    kn[~owned], vn[~owned] = float("nan"), float("nan")
    for i in range(B):
        last = (int(lengths[i]) - 1) // block_len
        tail = int(lengths[i]) - last * block_len
        kn[int(pages[i, last]), tail:] = float("nan")
        vn[int(pages[i, last]), tail:] = float("nan")
    check(torch.equal(kfd.flash_decode(q, kn, vn, lengths, pages=pages), got),
          f"{tag}: a row past a sequence's length was read")
    del kn, vn
    mask = (torch.arange(S, device="cuda")[None] < lengths[:, None])
    mask = mask[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def library():
        ks = kp[idx].reshape(view).transpose(1, 2)
        vs = vp[idx].reshape(view).transpose(1, 2)
        return sdpa(q[:, :, None], ks, vs, attn_mask=mask, enable_gqa=True)

    c = kcost().flash_decode(q, kp, lengths, pages=pages,
                             live=int(lengths.clamp(1, S).sum().item()))
    return {"err": err,
            "timed": timer.both(lambda: kfd.flash_decode(q, kp, vp, lengths,
                                                         pages=pages), tag),
            "dense_ms": timer(lambda: kfd.flash_decode(q, kv, vv, lengths),
                              "flash_decode dense, same lengths"),
            "plain_ms": timer(lambda: ref.flash_decode_paged_ref(
                q, kp, vp, lengths, pages), f"{tag} plain"),
            "lib_ms": timer(library, "gather + sdpa"),
            "nb": c.bytes, "flops": c.flops}


def paged_kernel_checks(torch, g: Geometry, timer: Timer) -> dict:
    """``flash_decode_paged``'s record: block_len 64 at 4 x 512 positions
    (the serving path's first paged run), then block_len 16, and both at
    4 x 2,048 (tinyllama's context), each with its own keys."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4321)
    B = g.slots
    rec = None
    for S in (g.max_seq, LONG_CONTEXT):
        lengths = torch.randint(1, S + 1, (B,), generator=gen, device="cuda",
                                dtype=torch.int32)
        lengths[0], lengths[-1] = 1, S
        for block_len in (64, 16):
            c = flash_decode_paged_case(torch, gen, g, timer, S, lengths,
                                        block_len)
            b_ms, b_by = bound_ms(c["nb"], c["flops"], BF16_FLOPS)
            if rec is None:
                rec = make_record("flash_decode_paged", c["err"], c["timed"],
                                  c["plain_ms"], c["lib_ms"], c["nb"],
                                  c["flops"], BF16_FLOPS)
                rec.update(positions=S, block_len=block_len,
                           dense_ms=c["dense_ms"])
                continue
            key = f"S{S}_bl{block_len}_"
            rec.update({key + "max_abs_err": c["err"],
                        key + "ms": c["timed"][0],
                        key + "host_us": c["timed"][1],
                        key + "dense_ms": c["dense_ms"],
                        key + "plain_ms": c["plain_ms"],
                        key + "library_ms": c["lib_ms"],
                        key + "bound_ms": b_ms})
            print(f"[kernel] flash_decode_paged S={S} block_len={block_len}: "
                  f"ok max_abs_err={c['err']:.3g} ms={c['timed'][0]:.4f} "
                  f"host_us={c['timed'][1]:.1f} dense_ms={c['dense_ms']:.4f} "
                  f"plain_ms={c['plain_ms']:.4f} bound_ms={b_ms:.4f} ({b_by}) "
                  f"library_ms={c['lib_ms']:.4f}", flush=True)
    print(f"[kernel] flash_decode_paged S={g.max_seq} block_len=64: "
          f"dense_ms={rec['dense_ms']:.4f}", flush=True)
    return rec


def kernel_checks(torch, g: Geometry, timer: Timer) -> list[dict]:
    from repro_torch.kernels import decode_fused as kdf
    from repro_torch.kernels import ivf_gather_score as kigs
    from repro_torch.kernels import ref

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    out = []

    def record(*args):
        out.append(make_record(*args))

    # ---- flash_decode: bf16 KV ring of every slot, lengths 1 .. max_seq;
    # then tinyllama-1.1b's full 2,048-position context (keys ``long_*``)
    B, S = g.slots, g.max_seq
    lengths = torch.randint(1, S + 1, (B,), generator=gen, device="cuda",
                            dtype=torch.int32)
    lengths[0], lengths[-1] = 1, S
    rec = flash_decode_case(torch, gen, g, timer, S, lengths)
    record("flash_decode", rec["err"], rec["timed"], rec["plain_ms"],
           rec["lib_ms"], rec["nb"], rec["flops"], BF16_FLOPS)
    S = LONG_CONTEXT
    lengths = torch.full((B,), S, device="cuda", dtype=torch.int32)
    rec = flash_decode_case(torch, gen, g, timer, S, lengths)
    b_ms, b_by = bound_ms(rec["nb"], rec["flops"], BF16_FLOPS)
    out[-1].update(long_positions=S, long_max_abs_err=rec["err"],
                   long_ms=rec["timed"][0], long_host_us=rec["timed"][1],
                   long_plain_ms=rec["plain_ms"],
                   long_library_ms=rec["lib_ms"], long_bound_ms=b_ms,
                   long_bound_by=b_by)
    print(f"[kernel] flash_decode S={S}: ok max_abs_err={rec['err']:.3g} "
          f"ms={rec['timed'][0]:.4f} host_us={rec['timed'][1]:.1f} "
          f"plain_ms={rec['plain_ms']:.4f} bound_ms={b_ms:.4f} ({b_by}) "
          f"library_ms={rec['lib_ms']}", flush=True)

    # ---- IVF tables at the index geometry, small-integer values
    b = g.slots
    mv = int_valued(torch, gen, (g.n_c, g.cap, g.d))
    fill = torch.rand((g.n_c, g.cap), generator=gen, device="cuda")
    mids = torch.randint(0, g.n, (g.n_c, g.cap), generator=gen,
                         device="cuda", dtype=torch.int32)
    mids = torch.where(fill < g.n / (g.n_c * g.cap), mids,
                       torch.full_like(mids, -1))
    probe = torch.stack([torch.randperm(g.n_c, generator=gen,
                                        device="cuda")[: g.n_probe]
                         for _ in range(b)]).int()
    qv = int_valued(torch, gen, (b, g.d))
    uniq = torch.unique(probe)
    got_s, got_i = kigs.ivf_gather_score(mv, mids, probe, qv)
    want_s, want_i = ref.ivf_gather_score_ref(mv, mids, probe, qv)
    torch.cuda.synchronize()
    err = (got_s - want_s).abs().max().item()
    check(torch.allclose(got_s, want_s, rtol=1e-5, atol=1e-5),
          f"ivf_gather_score scores disagree: {err}")
    check(torch.equal(got_i, want_i), "ivf_gather_score ids disagree")
    record("ivf_gather_score", err,
           timer.both(lambda: kigs.ivf_gather_score(mv, mids, probe, qv),
                      "ivf_gather_score"),
           timer(lambda: ref.ivf_gather_score_ref(mv, mids, probe, qv),
                 "ivf_gather_score plain"), None,
           *kcost().ivf_gather_score(mv, mids, probe, qv,
                                     n_unique=uniq.numel())[:2], FP32_FLOPS)

    # ---- ivf_screen_select on the same tables + overflow
    o_ids = torch.randint(0, g.n, (g.o_cap,), generator=gen, device="cuda",
                          dtype=torch.int32)
    o_ids[torch.rand((g.o_cap,), generator=gen, device="cuda") < 0.5] = -1
    o_sc = int_valued(torch, gen, (b, g.o_cap), -200, 200)
    args = (mv, mids, o_sc, o_ids, probe, qv)
    got_v, got_i = kdf.ivf_screen_select(*args, k=g.k)
    again_v, again_i = kdf.ivf_screen_select(*args, k=g.k)
    want_v, want_i = ref.ivf_screen_select_ref(*args, g.k)
    torch.cuda.synchronize()
    check(torch.equal(got_v, again_v) and torch.equal(got_i, again_i),
          "ivf_screen_select: two launches differ")
    err = (got_v - want_v).abs().nan_to_num(0.0).max().item()
    check(torch.equal(torch.isneginf(got_v), torch.isneginf(want_v))
          and torch.allclose(got_v.nan_to_num(neginf=0.0),
                             want_v.nan_to_num(neginf=0.0),
                             rtol=1e-5, atol=1e-5),
          f"ivf_screen_select values disagree: {err}")
    check(torch.equal(got_i, want_i), "ivf_screen_select ids disagree")
    # the fused screen equals the unfused kernel probe bit for bit
    s2, i2 = kigs.ivf_gather_score(mv, mids, probe, qv)
    pool_s = torch.cat([s2.reshape(b, -1), o_sc], 1)
    pool_i = torch.cat([i2.reshape(b, -1), o_ids[None].expand(b, -1)], 1)
    pool_s = torch.where(pool_i >= 0, pool_s, float("-inf"))
    v3, i3 = ref.topk_select_ref(pool_s, pool_i, g.k)
    check(torch.equal(v3, got_v) and torch.equal(i3, got_i),
          "ivf_screen_select != ivf_gather_score + top-k")
    live_rows = mids[probe.long()] >= 0  # (b, np, cap)
    live_uniq = int((mids[uniq.long()] >= 0).sum().item())
    record("ivf_screen_select", err,
           timer.both(lambda: kdf.ivf_screen_select(*args, k=g.k),
                      "ivf_screen_select"),
           timer(lambda: ref.ivf_screen_select_ref(*args, g.k),
                 "ivf_screen_select plain"), None,
           *kcost().ivf_screen_select(
               *args, g.k, n_unique=uniq.numel(), live_unique=live_uniq,
               live_rows=int(live_rows.sum().item()))[:2], FP32_FLOPS)
    del mv

    # ---- tail_gather_argmax over the output-embedding table
    t = g.slots
    emb = int_valued(torch, gen, (g.n, g.d))
    h = int_valued(torch, gen, (t, g.d))
    pos = torch.randint(0, g.n, (t, g.m_cap), generator=gen, device="cuda",
                        dtype=torch.int32)
    m_used = torch.randint(0, g.m_cap + 1, (t,), generator=gen,
                           device="cuda", dtype=torch.int32)
    m_used[0], m_used[-1] = 0, g.m_cap
    pert_s = int_valued(torch, gen, (t, g.k), -300, 300)
    pert_s[:, ::7] = float("-inf")
    s_ids = torch.randint(0, g.n, (t, g.k), generator=gen, device="cuda",
                          dtype=torch.int32)
    heights = int_valued(torch, gen, (t, g.m_cap), 0, 40) * 0.25
    targs = (emb, pos, m_used, pert_s, s_ids, heights, h)
    got_i, got_v = kdf.tail_gather_argmax(*targs)
    want_i, want_v = ref.tail_gather_argmax_ref(*targs)
    torch.cuda.synchronize()
    err = (got_v - want_v).abs().max().item()
    check(torch.allclose(got_v, want_v, rtol=1e-5, atol=1e-5),
          f"tail_gather_argmax max_val disagrees: {err}")
    check(torch.equal(got_i, want_i), "tail_gather_argmax index disagrees")
    # random fp32 rows: two launches, and each token alone, bit for bit
    emb_r = torch.randn((g.n, g.d), generator=gen, device="cuda")
    h_r = torch.randn((t, g.d), generator=gen, device="cuda")
    rargs = (emb_r, pos, m_used, pert_s * 0.15, s_ids, heights * 4, h_r)
    ri, rv = kdf.tail_gather_argmax(*rargs)
    again_i, again_v = kdf.tail_gather_argmax(*rargs)
    alone = [kdf.tail_gather_argmax(emb_r, *(a[j:j + 1] for a in rargs[1:]))
             for j in range(t)]
    wri, wrv = ref.tail_gather_argmax_ref(*rargs)
    torch.cuda.synchronize()
    check(torch.equal(ri, again_i) and torch.equal(rv, again_v),
          "tail_gather_argmax: two launches differ")
    check(all(torch.equal(a[0][0], ri[j]) and torch.equal(a[1][0], rv[j])
              for j, a in enumerate(alone)),
          "tail_gather_argmax: a token alone differs from the batch")
    check(torch.equal(ri, wri) and values_close(torch, rv, wrv, scaled=True),
          f"tail_gather_argmax disagrees on random rows: {max_err(rv, wrv)}")
    del emb_r, alone
    live = torch.arange(g.m_cap, device="cuda")[None] < m_used[:, None]
    rows = int(torch.unique(pos[live]).numel())
    record("tail_gather_argmax", err,
           timer.both(lambda: kdf.tail_gather_argmax(*targs),
                      "tail_gather_argmax"),
           timer(lambda: ref.tail_gather_argmax_ref(*targs),
                 "tail_gather_argmax plain"), None,
           *kcost().tail_gather_argmax(
               *targs, rows=rows, m_total=int(m_used.sum().item()))[:2],
           FP32_FLOPS)
    return out


def estimator_inputs(torch, gen, n: int, d: int, t: int, k: int,
                     s_ids: str = "popular"):
    """One head chunk's ``fused_estimator`` inputs (emb, ids, h, log_w):
    fp32 rows, m = 2k slots a token. S, the first k slots: ids from a
    popular head of 2,000 rows, shared across tokens as top-k sets are
    ("popular"), uniform over the table ("uniform"), or one set of k ids
    for every token ("shared"); T: uniform tail draws of weight
    log((n - k) / k). ~10 % of S slots dead, and token 7 all dead (log_z
    -inf, expv NaN, as the Pallas kernel gives) where t > 7."""
    emb = torch.randn((n, d), generator=gen, device="cuda") * 0.02
    h = torch.randn((t, d), generator=gen, device="cuda")
    if s_ids == "popular":
        s = torch.randint(0, 2000, (t, k), generator=gen, device="cuda")
    elif s_ids == "uniform":
        s = torch.randint(0, n, (t, k), generator=gen, device="cuda")
    else:
        s = torch.randint(0, n, (1, k), generator=gen,
                          device="cuda").expand(t, k)
    ids = torch.cat([s, torch.randint(0, n, (t, k), generator=gen,
                                      device="cuda")], dim=1).int()
    log_w = torch.cat([torch.zeros((t, k), device="cuda"),
                       torch.full((t, k), math.log((n - k) / k),
                                  device="cuda")], dim=1)
    log_w[:, :k][torch.rand((t, k), generator=gen, device="cuda") < 0.1] = \
        float("-inf")
    if t > 7:
        log_w[7] = float("-inf")
    return emb, ids, h, log_w


def train_kernel_checks(torch, g: Geometry, timer: Timer,
                        records: list[dict]) -> None:
    """The training path's kernels at its shapes: ``fused_estimator`` (with
    the scores y the backward takes) and ``fused_estimator_bwd`` from those
    scores, as the path runs them, over one head chunk (256 tokens, k + l =
    1152 candidates, the 32000 x 2048 output embedding), and
    ``ivf_gather_score`` at the training probe's 256 queries (extra keys
    ``train_*`` of its record), then at 256 queries whose probes pile onto
    popular clusters, over random fp32 rows (keys ``skew_*``), where the
    fused IVF screen must also equal it plus a top-k bit for bit, two
    launches agree, and the screen is timed at that batch (keys ``skew_*``
    of its record)."""
    from repro_torch.kernels import decode_fused as kdf
    from repro_torch.kernels import fused_estimator as kfe
    from repro_torch.kernels import ivf_gather_score as kigs
    from repro_torch.kernels import ref

    gen = torch.Generator(device="cuda")
    gen.manual_seed(4321)
    t, k = HEAD_CHUNK, g.k
    m = 2 * k
    emb, ids, h, log_w = estimator_inputs(torch, gen, g.n, g.d, t, k)
    args = (emb, ids, h, log_w)
    # as the training path calls it: the scores y written for the backward
    got_z, got_v, got_y = kfe.fused_estimator(*args, return_y=True)
    again_z, again_v, again_y = kfe.fused_estimator(*args, return_y=True)
    want_z, want_v, want_y = ref.fused_estimator_ref(*args, return_y=True)
    torch.cuda.synchronize()
    live = torch.isfinite(log_w)
    check(close(torch, got_z, want_z) and close(torch, got_v, want_v)
          and close(torch, got_y[live], want_y[live]),
          "fused_estimator disagrees with its plain version")
    check(torch.equal(torch.isneginf(got_y), ~live),
          "fused_estimator: y is not -inf on exactly the dead slots")
    check(bool(torch.isneginf(got_z[7])) and bool(torch.isnan(got_v[7]).all()),
          "fused_estimator: the all-dead token lost the -1e30 sentinel")
    check(torch.equal(got_z.nan_to_num(7.0), again_z.nan_to_num(7.0))
          and torch.equal(got_v.nan_to_num(7.0), again_v.nan_to_num(7.0))
          and torch.equal(got_y, again_y),
          "fused_estimator is not bitwise repeatable")
    err = max((got_z - want_z)[live.any(1)].abs().max().item(),
              (got_v - want_v)[live.any(1)].abs().max().item(),
              (got_y - want_y)[live].abs().max().item())
    rows_live = int(torch.unique(ids[live]).numel())
    n_live = int(live.sum().item())
    # bytes: each live distinct row once, ids / log_w / h in, log_z / expv
    # / y out; operations: a 2d dot and a 2d weighted sum per live candidate
    records.append(make_record(
        "fused_estimator", err,
        timer.both(lambda: kfe.fused_estimator(*args, return_y=True),
                   "fused_estimator"),
        timer(lambda: ref.fused_estimator_ref(*args, return_y=True),
              "fused_estimator plain"),
        None,
        *kcost().fused_estimator(*args, return_y=True, rows=rows_live,
                                 n_live=n_live)[:2], FP32_FLOPS))
    # the kernel family's route at the chunk (shape rule), and the popular
    # rows the plan found there
    froute = kfe.route(*emb.shape, *ids.shape)
    froute["popular_rows"] = int(kfe.popular_rows(
        ids, log_w, g.n, cap=froute["cap"])[2].item()) if froute["popular"] else 0
    records[-1].update(froute)
    print(f"[kernel] fused_estimator route: {json.dumps(froute)}", flush=True)
    del want_y, again_y

    # an O(1) cotangent, so that p and d_emb are far above rounding
    gvec = 0.5 + torch.rand((t,), generator=gen, device="cuda")
    live_tok = torch.ones(t, dtype=torch.bool, device="cuda")
    live_tok[7] = False  # keep the all-dead token's NaNs out of d_emb
    bargs = (emb, ids[live_tok], h[live_tok], log_w[live_tok],
             want_z[live_tok], gvec[live_tok])
    yb = got_y[live_tok]  # the forward's scores, as the path passes them
    got_d, got_p = kfe.fused_estimator_bwd(*bargs, y=yb)
    again_d, again_p = kfe.fused_estimator_bwd(*bargs, y=yb)
    # held against the plain version that re-scores the rows itself
    want_d, want_p = ref.fused_estimator_bwd_ref(*bargs)
    torch.cuda.synchronize()
    check(close(torch, got_d, want_d) and close(torch, got_p, want_p),
          "fused_estimator_bwd disagrees with its plain version")
    # the S slots' p is ~50x below the tail's: held at its own scale
    check(close(torch, got_p[:, :k], want_p[:, :k]),
          "fused_estimator_bwd: the S stratum's p disagrees")
    check(torch.equal(got_d, again_d) and torch.equal(got_p, again_p),
          "fused_estimator_bwd is not bitwise repeatable")
    err = max((got_d - want_d).abs().max().item(),
              (got_p - want_p).abs().max().item())
    bl = torch.isfinite(bargs[3])
    tb = int(live_tok.sum().item())
    # bytes: ids / y / h / log_z / g in once, the dense (n, d) d_emb and p
    # out; operations: p · h, a 2d fma per live candidate
    records.append(make_record(
        "fused_estimator_bwd", err,
        timer.both(lambda: kfe.fused_estimator_bwd(*bargs, y=yb),
                   "fused_estimator_bwd"),
        timer(lambda: ref.fused_estimator_bwd_ref(*bargs, y=yb),
              "fused_estimator_bwd plain"), None,
        *kcost().fused_estimator_bwd(*bargs, y=yb,
                                     n_live=int(bl.sum().item()))[:2],
        FP32_FLOPS))
    del emb, args, bargs, want_d, got_d, again_d, got_y, yb

    # ---- ivf_gather_score at the training probe's 256 queries: uniform
    # probes over small-integer rows (keys ``train_*``), then skewed probes
    # over random fp32 rows (keys ``skew_*``)
    b = HEAD_CHUNK
    rec = next(r for r in records if r["name"] == "ivf_gather_score")
    mv = int_valued(torch, gen, (g.n_c, g.cap, g.d))
    mids = torch.randint(0, g.n, (g.n_c, g.cap), generator=gen,
                         device="cuda", dtype=torch.int32)
    probe = torch.stack([torch.randperm(g.n_c, generator=gen,
                                        device="cuda")[: g.n_probe]
                         for _ in range(b)]).int()
    qv = int_valued(torch, gen, (b, g.d))
    got_s, got_i = kigs.ivf_gather_score(mv, mids, probe, qv)
    want_s, want_i = ref.ivf_gather_score_ref(mv, mids, probe, qv)
    torch.cuda.synchronize()
    check(torch.equal(got_s, want_s) and torch.equal(got_i, want_i),
          "ivf_gather_score at b=256 disagrees with its plain version")
    del want_s, want_i
    gather_record(torch, g, timer, rec, "train_", mv, mids, probe, qv)

    # skewed: cluster popularity ~ 1 / rank, each query probing n_probe
    # distinct clusters drawn by it, so the first clusters are probed by
    # most of the batch (as trained hidden states favour popular clusters)
    mv.normal_(generator=gen)
    qv = torch.randn((b, g.d), generator=gen, device="cuda")
    pop = 1.0 / torch.arange(1, g.n_c + 1, device="cuda", dtype=torch.float32)
    perm = torch.randperm(g.n_c, generator=gen, device="cuda")
    probe = perm[torch.multinomial(pop.expand(b, -1), g.n_probe,
                                   generator=gen)].int()
    got_s, got_i = kigs.ivf_gather_score(mv, mids, probe, qv)
    again_s, again_i = kigs.ivf_gather_score(mv, mids, probe, qv)
    want_s, want_i = ref.ivf_gather_score_ref(mv, mids, probe, qv)
    torch.cuda.synchronize()
    err = (got_s - want_s).abs().max().item()
    check(values_close(torch, got_s, want_s, scaled=True)
          and torch.equal(got_i, want_i),
          f"ivf_gather_score, skewed b=256 on random rows, disagrees: {err}")
    check(torch.equal(got_s, again_s) and torch.equal(got_i, again_i),
          "ivf_gather_score: two launches differ")
    del want_s, want_i, again_s, again_i
    # the fused screen equals the unfused kernel probe + top-k bit for bit
    # on random fp32 rows at full width, where the order of the sums matters
    o_ids = torch.randint(0, g.n, (g.o_cap,), generator=gen, device="cuda",
                          dtype=torch.int32)
    o_sc = torch.randn((b, g.o_cap), generator=gen, device="cuda") * 30
    sargs = (mv, mids, o_sc, o_ids, probe, qv)
    v, i = kdf.ivf_screen_select(*sargs, k=g.k)
    v2, i2 = kdf.ivf_screen_select(*sargs, k=g.k)
    pool_s = torch.cat([got_s.reshape(b, -1), o_sc], 1)
    pool_i = torch.cat([got_i.reshape(b, -1), o_ids[None].expand(b, -1)], 1)
    pool_s = torch.where(pool_i >= 0, pool_s, float("-inf"))
    wv, wi = ref.topk_select_ref(pool_s, pool_i, g.k)
    check(torch.equal(v, wv) and torch.equal(i, wi),
          "ivf_screen_select != ivf_gather_score + top-k on random fp32 "
          "rows, skewed probes, b=256")
    check(torch.equal(v, v2) and torch.equal(i, i2),
          "ivf_screen_select, skewed b=256: two launches differ")
    del pool_s, pool_i, got_s, got_i, v2, i2
    hot = torch.bincount(probe.flatten().long(), minlength=g.n_c).max().item()
    rec["skew_max_err"] = err
    rec["skew_hottest_cluster_queries"] = hot
    gather_record(torch, g, timer, rec, "skew_", mv, mids, probe, qv)
    screen_record(torch, g, timer,
                  next(r for r in records if r["name"] == "ivf_screen_select"),
                  "skew_", sargs)


def gather_record(torch, g: Geometry, timer: Timer, rec: dict, tag: str,
                  mv, mids, probe, qv) -> None:
    """``ivf_gather_score``'s keys ``<tag>*`` at ``probe``'s batch: device
    and host time, the plain version's time, and the bound (each distinct
    probed tile and its ids once, probe and q in, scores and ids out; a 2d
    dot per (query, probe, member))."""
    from repro_torch.kernels import ivf_gather_score as kigs
    from repro_torch.kernels import ref

    b = probe.shape[0]
    uniq = torch.unique(probe)
    b_ms, b_by = bound_ms(
        *kcost().ivf_gather_score(mv, mids, probe, qv,
                                  n_unique=uniq.numel())[:2], FP32_FLOPS)
    ms, host = timer.both(lambda: kigs.ivf_gather_score(mv, mids, probe, qv),
                          f"ivf_gather_score {tag}")
    plain = timer(lambda: ref.ivf_gather_score_ref(mv, mids, probe, qv),
                  f"ivf_gather_score {tag}plain")
    rec.update({f"{tag}queries": b, f"{tag}ms": ms, f"{tag}host_us": host,
                f"{tag}plain_ms": plain, f"{tag}bound_ms": b_ms,
                f"{tag}bound_by": b_by,
                f"{tag}distinct_clusters": uniq.numel()})
    print(f"[kernel] ivf_gather_score {tag}b={b}: ok ms={ms:.4f} "
          f"host_us={host:.1f} plain_ms={plain:.4f} bound_ms={b_ms:.4f} "
          f"({b_by}) distinct clusters {uniq.numel()}", flush=True)


def screen_record(torch, g: Geometry, timer: Timer, rec: dict, tag: str,
                  sargs) -> None:
    """``ivf_screen_select``'s keys ``<tag>*`` at ``sargs``' batch: device
    and host time, the plain version's time, and the bound (each distinct
    probed tile's live rows and ids once, overflow scores and ids, probe
    and q in, values and ids out; a 2d dot per live probed member)."""
    from repro_torch.kernels import decode_fused as kdf
    from repro_torch.kernels import ref

    mv, mids, o_sc, o_ids, probe, qv = sargs
    b = probe.shape[0]
    uniq = torch.unique(probe)
    live_rows = int((mids[probe.long()] >= 0).sum().item())
    live_uniq = int((mids[uniq.long()] >= 0).sum().item())
    b_ms, b_by = bound_ms(
        *kcost().ivf_screen_select(*sargs, g.k, n_unique=uniq.numel(),
                                   live_unique=live_uniq,
                                   live_rows=live_rows)[:2], FP32_FLOPS)
    ms, host = timer.both(lambda: kdf.ivf_screen_select(*sargs, k=g.k),
                          f"ivf_screen_select {tag}")
    plain = timer(lambda: ref.ivf_screen_select_ref(*sargs, g.k),
                  f"ivf_screen_select {tag}plain")
    rec.update({f"{tag}queries": b, f"{tag}ms": ms, f"{tag}host_us": host,
                f"{tag}plain_ms": plain, f"{tag}bound_ms": b_ms,
                f"{tag}bound_by": b_by,
                f"{tag}distinct_clusters": uniq.numel()})
    print(f"[kernel] ivf_screen_select {tag}b={b}: ok ms={ms:.4f} "
          f"host_us={host:.1f} plain_ms={plain:.4f} bound_ms={b_ms:.4f} "
          f"({b_by}) distinct clusters {uniq.numel()}", flush=True)


def pq_inputs(torch, gen, g: Geometry, b: int, ints: bool):
    """IVF-PQ screen inputs at the index geometry for ``b`` queries: uint8
    codes, member ids as dense as the real index's (dead slots -1), probes,
    LUTs, coarse scores, and an overflow half dead. Small integers when
    ``ints`` (every sum exact), else random fp32."""
    codes = torch.randint(0, g.ksub, (g.n_c, g.cap, g.m_sub), generator=gen,
                          device="cuda", dtype=torch.int32).to(torch.uint8)
    fill = torch.rand((g.n_c, g.cap), generator=gen, device="cuda")
    mids = torch.randint(0, g.n, (g.n_c, g.cap), generator=gen,
                         device="cuda", dtype=torch.int32)
    mids = torch.where(fill < g.n / (g.n_c * g.cap), mids,
                       torch.full_like(mids, -1))
    probe = torch.stack([torch.randperm(g.n_c, generator=gen,
                                        device="cuda")[: g.n_probe]
                         for _ in range(b)]).int()
    o_ids = torch.randint(0, g.n, (g.o_cap,), generator=gen, device="cuda",
                          dtype=torch.int32)
    o_ids[torch.rand((g.o_cap,), generator=gen, device="cuda") < 0.5] = -1
    if ints:
        lut = int_valued(torch, gen, (b, g.m_sub, g.ksub), -3, 4)
        coarse = int_valued(torch, gen, (b, g.n_probe), -8, 9)
        o_sc = int_valued(torch, gen, (b, g.o_cap), -40, 40)
    else:
        lut = torch.randn((b, g.m_sub, g.ksub), generator=gen, device="cuda")
        coarse = torch.randn((b, g.n_probe), generator=gen, device="cuda") * 2
        o_sc = torch.randn((b, g.o_cap), generator=gen, device="cuda") * 3
    return codes, mids, coarse, o_sc, o_ids, probe, lut


def values_close(torch, got, want, scaled: bool = False) -> bool:
    """-inf at the same places, the finite values within rtol=1e-5 and an
    atol of 1e-5 — or, ``scaled``, of 1e-5 times the largest finite
    magnitude of ``want`` (for d-term dot products, whose rounding error
    scales with the terms, not with a sum that may cancel to ~0)."""
    fin = want[torch.isfinite(want)]
    atol = 1e-5 * (fin.abs().max().item() if scaled and fin.numel() else 1.0)
    return (torch.equal(torch.isneginf(got), torch.isneginf(want))
            and torch.allclose(got.nan_to_num(neginf=0.0),
                               want.nan_to_num(neginf=0.0), rtol=1e-5,
                               atol=atol))


def max_err(got, want) -> float:
    return (got - want).abs().nan_to_num(0.0).max().item()


def pq_kernel_checks(torch, g: Geometry, timer: Timer,
                     records: list[dict]) -> None:
    """The IVF-PQ kernels at the serving path's 4 queries (their records)
    and at the training probe's 256 (extra keys ``train_*``), with the
    reference's PQConfig defaults and r = 2k: ``pq_lut_score`` and
    ``pq_screen_select`` over random codes at the index geometry, bitwise
    on small-integer LUTs and within rtol 1e-5 on random ones, probe widths
    below n_probe (0 included) and an all-dead query (and, on random LUTs,
    two launches and the last query screened alone bitwise equal to the
    batch's outputs); ``rerank_select``
    over the screen's survivors against a 32000 x 2048 table of small
    integers (and one of random fp32 for the second check, where two
    launches and the last query re-ranked alone must equal the batch's
    outputs bit for bit). Times and
    bounds are taken at the main path's full probe width, over its
    survivors."""
    from repro_torch.kernels import decode_fused as kdf
    from repro_torch.kernels import pq_lut_score as kpls
    from repro_torch.kernels import ref

    gen = torch.Generator(device="cuda")
    gen.manual_seed(2468)
    emb = int_valued(torch, gen, (g.n, g.d))
    emb_rand = torch.randn((g.n, g.d), generator=gen, device="cuda")
    for b in (g.slots, HEAD_CHUNK):
        tag = "" if b == g.slots else "train_"
        ints = pq_inputs(torch, gen, g, b, True)
        rand = pq_inputs(torch, gen, g, b, False)
        codes, mids, coarse, o_sc, o_ids, probe, lut = ints
        width = torch.full((b,), g.n_probe, dtype=torch.int32, device="cuda")
        width[1], width[2] = 3, 0  # a narrower probe, and overflow alone

        # ---- pq_lut_score
        got = kpls.pq_lut_score(codes, probe, lut)
        want = ref.pq_lut_score_ref(codes, probe, lut)
        got_r = kpls.pq_lut_score(rand[0], rand[5], rand[6])
        want_r = ref.pq_lut_score_ref(rand[0], rand[5], rand[6])
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"pq_lut_score b={b}: small-integer "
              "sums differ from the plain version")
        check(values_close(torch, got_r, want_r),
              f"pq_lut_score b={b} disagrees on random LUTs: "
              f"{max_err(got_r, want_r)}")
        uniq = torch.unique(probe)
        # codes of the distinct probed tiles, probe and LUTs in; the
        # (b, np, cap) f32 sums out; m_sub adds per member
        c = kcost().pq_lut_score(codes, probe, lut, n_unique=uniq.numel())
        rec = {"max_abs_err": max_err(got_r, want_r),
               "timed": timer.both(lambda: kpls.pq_lut_score(codes, probe,
                                                              lut),
                                   f"pq_lut_score b={b}"),
               "plain_ms": timer(lambda: ref.pq_lut_score_ref(codes, probe,
                                                               lut),
                                 f"pq_lut_score b={b} plain"),
               "nb": c.bytes, "flops": c.flops,
               "bitwise_random": torch.equal(got_r, want_r)}
        pq_record(records, "pq_lut_score", tag, b, rec)

        # ---- pq_screen_select, probe widths (0 included)
        sargs = (codes, mids, coarse, o_sc, o_ids, probe, lut)
        got_v, got_i = kdf.pq_screen_select(*sargs, r=g.r, probe_width=width)
        want_v, want_i = ref.pq_screen_select_ref(*sargs, g.r,
                                                  probe_width=width)
        rv, ri = kdf.pq_screen_select(*rand, r=g.r)
        again_v, again_i = kdf.pq_screen_select(*rand, r=g.r)
        j = b - 1  # the last query, screened alone
        alone_v, alone_i = kdf.pq_screen_select(
            rand[0], rand[1], rand[2][j:], rand[3][j:], rand[4],
            rand[5][j:], rand[6][j:], r=g.r)
        wrv, wri = ref.pq_screen_select_ref(*rand, g.r)
        # the fused screen == pq_lut_score + coarse + pool top-r, bit for bit
        s2 = (kpls.pq_lut_score(rand[0], rand[5], rand[6])
              + rand[2][..., None]).reshape(b, -1)
        pool_i = torch.cat([rand[1][rand[5].long()].reshape(b, -1),
                            rand[4][None].expand(b, -1)], 1)
        pool_s = torch.where(pool_i >= 0, torch.cat([s2, rand[3]], 1),
                             float("-inf"))
        v3, i3 = ref.topk_select_ref(pool_s, pool_i, g.r)
        # an all-dead query: no probe stage and no live overflow
        dead_ids = torch.full_like(o_ids, -1)
        dargs = (codes, mids, coarse, o_sc, dead_ids, probe, lut)
        dv, di = kdf.pq_screen_select(*dargs, r=g.r, probe_width=width)
        wdv, wdi = ref.pq_screen_select_ref(*dargs, g.r, probe_width=width)
        torch.cuda.synchronize()
        check(torch.equal(got_i, want_i) and torch.equal(got_v, want_v),
              f"pq_screen_select b={b}: small-integer screen differs")
        check(values_close(torch, rv, wrv),
              f"pq_screen_select b={b} disagrees on random LUTs: "
              f"{max_err(rv, wrv)}")
        check(torch.equal(rv, v3) and torch.equal(ri, i3),
              f"pq_screen_select b={b} != pq_lut_score + top-r")
        check(torch.equal(rv, again_v) and torch.equal(ri, again_i),
              f"pq_screen_select b={b}: two launches differ")
        check(torch.equal(alone_v[0], rv[j])
              and torch.equal(alone_i[0], ri[j]),
              f"pq_screen_select b={b}: a query alone differs from the batch")
        check(torch.equal(di, wdi) and torch.equal(dv, wdv)
              and bool((di[2] == -1).all()),
              f"pq_screen_select b={b}: the all-dead query differs")
        # timed at the main path's full probe width (no probe_width)
        full_v, full_i = kdf.pq_screen_select(*sargs, r=g.r)
        live = mids[probe.long()] >= 0
        live_slots = torch.unique(
            (probe.long()[:, :, None] * g.cap
             + torch.arange(g.cap, device="cuda")[None, None, :])[live])
        tiles = torch.unique(probe)
        # ids of the probed tiles, codes of their live members, LUTs,
        # coarse, probe, overflow pair in; top-r (values, ids) out
        c = kcost().pq_screen_select(*sargs, g.r, tiles=tiles.numel(),
                                     live_slots=live_slots.numel(),
                                     live=int(live.sum().item()))
        rec = {"max_abs_err": max_err(rv, wrv),
               "timed": timer.both(lambda: kdf.pq_screen_select(*sargs,
                                                                 r=g.r),
                                   f"pq_screen_select b={b}"),
               "plain_ms": timer(lambda: ref.pq_screen_select_ref(*sargs,
                                                                  g.r),
                                 f"pq_screen_select b={b} plain"),
               "nb": c.bytes, "flops": c.flops,
               "bitwise_random": torch.equal(rv, wrv)}
        pq_record(records, "pq_screen_select", tag, b, rec)

        # ---- rerank_select over the narrow screen's survivors, some dead
        # (checks); timed over the full-width screen's survivors
        cand, lut_vals = got_i, got_v.clone()
        lut_vals[:, 5::17] = float("-inf")  # dead screening values
        q = int_valued(torch, gen, (b, g.d))
        rargs = (emb, cand, lut_vals, q)
        got_v, got_i = kdf.rerank_select(*rargs, k=g.k)
        want_v, want_i = ref.rerank_select_ref(*rargs, g.k)
        qr = torch.randn((b, g.d), generator=gen, device="cuda")
        rv, ri = kdf.rerank_select(emb_rand, cand, lut_vals, qr, k=g.k)
        again_v, again_i = kdf.rerank_select(emb_rand, cand, lut_vals, qr,
                                             k=g.k)
        j = b - 1  # the last query, re-ranked alone
        alone_v, alone_i = kdf.rerank_select(emb_rand, cand[j:], lut_vals[j:],
                                             qr[j:], k=g.k)
        wrv, wri = ref.rerank_select_ref(emb_rand, cand, lut_vals, qr, g.k)
        torch.cuda.synchronize()
        check(torch.equal(got_i, want_i) and torch.equal(got_v, want_v),
              f"rerank_select b={b}: small-integer re-rank differs")
        check(values_close(torch, rv, wrv, scaled=True),
              f"rerank_select b={b} disagrees on random rows: "
              f"{max_err(rv, wrv)}")
        check(torch.equal(rv, again_v) and torch.equal(ri, again_i),
              f"rerank_select b={b}: two launches differ")
        check(torch.equal(alone_v[0], rv[j])
              and torch.equal(alone_i[0], ri[j]),
              f"rerank_select b={b}: a query alone differs from the batch")
        targs = (emb, full_i, full_v, q)
        alive = (full_i >= 0) & ~torch.isneginf(full_v)
        rows = torch.unique(full_i[alive]).numel()
        # each distinct live survivor row once, candidates, screening values
        # and q in; the top-k (values, ids) out; a 2d dot per live survivor
        c = kcost().rerank_select(*targs, g.k, rows=rows,
                                  alive=int(alive.sum().item()))
        rec = {"max_abs_err": max_err(rv, wrv),
               "timed": timer.both(lambda: kdf.rerank_select(*targs, k=g.k),
                                   f"rerank_select b={b}"),
               "plain_ms": timer(lambda: ref.rerank_select_ref(*targs, g.k),
                                 f"rerank_select b={b} plain"),
               "nb": c.bytes, "flops": c.flops,
               "bitwise_random": torch.equal(rv, wrv)}
        pq_record(records, "rerank_select", tag, b, rec)
    del emb, emb_rand


def pq_record(records: list[dict], name: str, tag: str, b: int,
              rec: dict) -> None:
    """A PQ kernel's record at the serving shape (``tag`` "") or its
    ``train_*`` keys at the training probe's (``tag`` "train_")."""
    if not tag:
        out = make_record(name, rec["max_abs_err"], rec["timed"],
                          rec["plain_ms"], None, rec["nb"], rec["flops"],
                          FP32_FLOPS)
        out.update(queries=b, bitwise_random=rec["bitwise_random"])
        records.append(out)
        return
    b_ms, b_by = bound_ms(rec["nb"], rec["flops"], FP32_FLOPS)
    out = next(x for x in records if x["name"] == name)
    ms, host = rec["timed"]
    out.update(train_queries=b, train_ms=ms, train_host_us=host,
               train_plain_ms=rec["plain_ms"], train_bound_ms=b_ms,
               train_bound_by=b_by, train_max_abs_err=rec["max_abs_err"],
               train_bitwise_random=rec["bitwise_random"])
    print(f"[kernel] {name} b={b}: ok max_abs_err={rec['max_abs_err']:.3g} "
          f"ms={ms:.4f} host_us={host:.1f} plain_ms={rec['plain_ms']:.4f} "
          f"bound_ms={b_ms:.4f} ({b_by})", flush=True)


# ---------------------------------------------------------------- serving
# the kernels each serving path must launch, by head index
FUSED_KERNELS = {
    "ivf": ("flash_decode", "ivf_screen_select", "tail_gather_argmax"),
    "ivfpq": ("flash_decode", "pq_screen_select", "rerank_select",
              "tail_gather_argmax"),
}
UNFUSED_KERNELS = {"ivf": ("ivf_gather_score",),
                   "ivfpq": ("pq_lut_score", "rerank_select")}


def serve(torch, seed: int, cfg, scfg_kw) -> tuple[dict, dict, dict, dict]:
    """The serving phase: one set of weights, served with each head index
    (:func:`serve_one`). Returns (launch counts: each kernel's count on the
    first run that launches it, the fused one first; per-index stats; each
    kernel's device us per call on the first profiled run that launches
    it, in the same order; what ``[serve-tier]`` reuses: the params, the
    prompts and, per index, the fused server and its first run's tokens)."""
    from repro_torch.models.model import Model

    import numpy as np

    model = Model(cfg, "bf16", device="cuda")
    t0 = time.perf_counter()
    params = model.init(seed)
    torch.cuda.synchronize()
    print(f"[serve] init {time.perf_counter() - t0:.2f} s", flush=True)
    rng = np.random.default_rng(seed)
    prompts = [list(rng.integers(0, cfg.vocab, size=rng.integers(4, 13)))
               for _ in range(REQUESTS)]
    counts, stats, servers, path_us, tokens = {}, {}, {}, {}, {}
    for mips in MIPS:
        runs, stats[mips], servers[mips], profs, tokens[mips] = serve_one(
            torch, cfg, mips, params, prompts, scfg_kw)
        for run in runs:
            for name, n in run.items():
                if n and name not in counts:
                    counts[name] = n
        for kern in profs:
            for name, v in kern.items():
                path_us.setdefault(name, v["us_per_call"])
        torch.cuda.empty_cache()
    # warm repeats, the indexes in the order A B B A, so that a drift of the
    # host's speed during the call falls on both
    for mips in MIPS + MIPS[::-1]:
        for kind, srv in zip(("fused", "unfused"), servers[mips]):
            for key, v in warm_repeat(torch, srv, prompts[:SLOTS]).items():
                stats[mips].setdefault(f"warm_{kind}_{key}", []).append(v)
    for mips in MIPS:
        for kind, srv in zip(("fused", "unfused"), servers[mips]):
            stats[mips][f"warm_{kind}_syncs_per_token"] = syncs_per_token(
                torch, srv, prompts[:SLOTS])
        print(f"[serve] {mips} warm, per token: " + json.dumps(
            {k: v for k, v in stats[mips].items()
             if k.startswith(("warm_", "device_"))}), flush=True)
    print("[serve] index_mb " + json.dumps(
        {m: stats[m]["index_mb"] for m in MIPS}), flush=True)
    ctx = {"params": params, "prompts": prompts, "tokens": tokens,
           "servers": {m: servers[m][0] for m in MIPS}}
    return counts, stats, path_us, ctx


def serve_one(torch, cfg, mips: str, params, prompts, scfg_kw):
    """Serve ``prompts`` with the ``mips`` head fused at window T=8, then
    unfused at T=1 over the same index, and require the same tokens; then
    profile a repeat of each over ``SLOTS`` prompts. Returns ((fused
    counts, unfused counts), stats, (fused server, unfused server), (fused
    profile's, unfused profile's kernels), the fused run's tokens)."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import report
    from repro_torch.serve.server import ServeConfig, Server

    mcfg = cfg.scaled(head_mips=mips)
    t0 = time.perf_counter()
    srv = Server(mcfg.scaled(head_fused_decode=True), params,
                 ServeConfig(decode_window=WINDOW, **scfg_kw),
                 precision_policy="bf16", device="cuda")
    torch.cuda.synchronize()
    print(f"[serve] {mips} index build {time.perf_counter() - t0:.2f} s "
          f"({srv.stats['index_bytes'] / 1e6:.1f} MB)", flush=True)
    ops.reset_launch_counts()
    res = srv.run(prompts)
    torch.cuda.synchronize()
    fused_counts = ops.launch_counts()
    rep = report(res, srv)
    print("[serve] %s fused T=%d %s" % (mips, WINDOW, json.dumps(rep)),
          flush=True)
    print(f"[serve] launches {json.dumps(fused_counts)}", flush=True)
    check(len(res) == len(prompts)
          and all(r.status == "ok" and len(r.tokens) == scfg_kw["max_new_tokens"]
                  for r in res), f"{mips} fused serve: a request lost tokens")
    check(all(0 <= tok < cfg.vocab for r in res for tok in r.tokens),
          f"{mips} fused serve: a token id out of range")
    check(rep["ok_rate"] >= 0.95,
          f"{mips} fused serve: ok_rate {rep['ok_rate']}")
    for name in FUSED_KERNELS[mips]:
        check(fused_counts[name] > 0, f"{mips} fused serve never launched "
              f"{name}")

    # same weights and the same index state, unfused kernel probe, T=1
    srv1 = Server(mcfg, params, ServeConfig(decode_window=1, **scfg_kw),
                  precision_policy="bf16", device="cuda", index=srv.index)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    res1 = srv1.run(prompts)
    torch.cuda.synchronize()
    unfused_counts = ops.launch_counts()
    rep1 = report(res1, srv1)
    print("[serve] %s unfused T=1 %s" % (mips, json.dumps(rep1)), flush=True)
    print(f"[serve] launches {json.dumps(unfused_counts)}", flush=True)
    for name in UNFUSED_KERNELS[mips]:
        check(unfused_counts[name] > 0, f"{mips} unfused serve never "
              f"launched {name}")
    same = [a.tokens == b.tokens for a, b in zip(res, res1)]
    print(f"[serve] {mips} fused T={WINDOW} == unfused T=1 tokens: "
          f"{sum(same)}/{len(same)} requests", flush=True)
    check(all(same), f"{mips}: fused T=8 and unfused T=1 served different "
          "tokens")
    stats = {"fused_decode_steps": rep["decode_dispatches"] * WINDOW,
             "unfused_decode_steps": rep1["decode_dispatches"],
             "index_mb": rep["index_mb"],
             "fused_tokens_per_s": rep["tokens_per_s"],
             "unfused_tokens_per_s": rep1["tokens_per_s"]}
    prof = profile(torch, f"serve {mips} fused T=8",
                   lambda: sum(len(r.tokens)
                               for r in srv.run(prompts[:SLOTS])))
    stats.update(device_ms_per_token=prof["device_ms"] / prof["tokens"],
                 device_events_per_token=prof["device_events"]
                 / prof["tokens"])
    prof1 = profile(torch, f"serve {mips} unfused T=1",
                    lambda: sum(len(r.tokens)
                                for r in srv1.run(prompts[:SLOTS])))
    return ((fused_counts, unfused_counts), stats, (srv, srv1),
            (prof["kernels"], prof1["kernels"]), [r.tokens for r in res])


def warm_repeat(torch, srv, prompts) -> dict:
    """A warm, unprofiled repeat of ``srv.run(prompts)``, per decoded token:
    the wall time, the host time spent in the server's decode dispatches
    (``decode_fn``) and, inside them, in the head index's queries
    (``screen_select`` / ``topk_batch``, the one stage that differs between
    the indexes)."""
    host = {"decode": 0.0, "index": 0.0}

    def timed(fn, key):
        def call(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            host[key] += time.perf_counter() - t0
            return out
        return call

    decode_fn, index = srv.decode_fn, srv.index
    srv.decode_fn = timed(decode_fn, "decode")
    for name in ("screen_select", "topk_batch"):  # instance over class
        setattr(index, name, timed(getattr(index, name), "index"))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tokens = sum(len(r.tokens) for r in srv.run(prompts))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        srv.decode_fn = decode_fn
        for name in ("screen_select", "topk_batch"):
            delattr(index, name)
    return {"wall_ms_per_token": 1e3 * wall / tokens,
            "decode_host_ms_per_token": 1e3 * host["decode"] / tokens,
            "index_host_ms_per_token": 1e3 * host["index"] / tokens}


def syncs_per_token(torch, srv, prompts) -> float:
    """Host-device syncs per decoded token of ``srv.run(prompts)``, counted
    under CUDA's sync debug mode."""
    import warnings

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            tokens = sum(len(r.tokens) for r in srv.run(prompts))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught) / tokens


def covered_us(spans) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, -math.inf
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def profile(torch, label: str, fn) -> dict:
    """Where a run's time goes: torch.profiler over ``fn()`` (which returns
    the number of tokens it processed); prints and returns wall time, the
    summed duration of the device's own events (kernels, copies), the
    device's idle share, the device events that took the most time, and
    each of our kernels' device us per call: the time its kernels were on
    the device, overlaps counted once (a programmatic dependent launch is
    on the device, waiting, while its predecessor runs). Profiling slows
    the host, so the idle share is an upper estimate of the unprofiled
    run's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from repro_torch.kernels import ops

    symbols = ops.kernel_symbols()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tokens = fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_name: dict[str, list] = {}
    calls_of = dict.fromkeys(symbols, 0)
    spans: dict[str, list] = {name: [] for name in symbols}
    matches: dict[str, list] = {}  # event name -> [(kernel, is a call)]

    def match(event_name: str) -> list:
        return [(name, sym in calls)
                for name, (calls, others) in symbols.items()
                for sym in calls + others
                if re.search(rf"(^|[\s:]){sym}[<(]", event_name)]

    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            acc = by_name.setdefault(e.name[:60], [0, 0.0])
            acc[0] += 1
            acc[1] += us / 1e3
            if e.name not in matches:
                matches[e.name] = match(e.name)
            for name, is_call in matches[e.name]:
                calls_of[name] += is_call
                spans[name].append((e.time_range.start, e.time_range.end))
    busy_ms = sum(ms for _, ms in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    out = {"tokens": tokens, "wall_ms": wall_ms, "device_ms": busy_ms,
           "device_idle_share": 1.0 - busy_ms / wall_ms,
           "device_events": sum(n for n, _ in by_name.values()),
           "top": [[name, n, ms] for name, (n, ms) in top],
           "kernels": {k: {"calls": n,
                           "us_per_call": covered_us(spans[k]) / n}
                       for k, n in calls_of.items() if n}}
    print(f"[profile] {label} " + json.dumps(out), flush=True)
    return out


# ---------------------------------------------------------------- cost
COST_TAG = "[cost]"
COST_REPEATS = 3  # timed repeats of each step (events; the median)


def cost_phase(torch, seed: int, records: list[dict], smi: str) -> dict:
    """The ``[cost]`` phase: the cost model (:mod:`repro_torch.launch
    .cost_model`) on the card. At tinyllama-1.1b's full width (random
    weights from ``seed``, the IVF head), one serving decode step at the
    serving shape (4 slots, a 512-position ring, fused head) and one
    training step at the chip's training configuration (2 x 1,024 tokens)
    each run once under ``CostMode`` on CUDA tensors and once as a meta
    trace of the same step; the flops, HBM bytes and per-kernel counts of
    the two must be equal. Printed beside them: the step's device time
    (profiled busy time and CUDA-event time, unprofiled), the model's
    ``t_compute``, ``t_memory`` and bound at the H100 SXM data-sheet peaks,
    the bound's share of the busy time, and the traced ``temp_gb`` beside
    ``torch.cuda.max_memory_allocated`` over the step (their ratio is
    recorded, not gated). The counts charge ``flash_decode`` every ring
    row, an upper bound; the serving step's record adds ``bound_ms_live``,
    its bound with this step's live rows. Each record gains
    ``launches_cost``: the
    kernel's launches (``ops.launch_counts``) in the two card steps under
    ``CostMode``, which must equal the calls the cost model charged."""
    import statistics

    from repro_torch.configs import get
    from repro_torch.launch import roofline, steps
    from repro_torch.kernels import cost as kcost
    from repro_torch.kernels import ops
    from repro_torch.launch.cost_model import CostMode, to_meta
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw

    cfg = get("tinyllama-1.1b").scaled(head_mips="ivf",
                                       head_fused_decode=True)
    model = Model(cfg, "bf16", device="cuda")
    meta_model = Model(cfg, "bf16", device="meta")
    params = model.init(seed)
    index = model.make_head_index(params)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    sp = model.compute_params(params)
    cache = model.init_cache(SLOTS, MAX_SEQ)
    ids = torch.randint(0, cfg.vocab, (SLOTS,), generator=gen, device="cuda")
    pos = torch.tensor([7, 130, 300, MAX_SEQ - 1], device="cuda")
    keys = steps.slot_keys(seed, torch.arange(SLOTS, device="cuda"), pos)
    batch = {k: torch.randint(0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ),
                              generator=gen, device="cuda",
                              dtype=torch.int32)
             for k in ("tokens", "labels")}
    opt = adamw.init(params)
    tcfg = steps.TrainConfig(opt=adamw.OptConfig(**TRAIN_OPT))
    cases = {
        "serve": (steps.make_serve_step(model),
                  steps.make_serve_step(meta_model),
                  (sp, cache, ids, pos, keys, index), SLOTS),
        "train": (steps.make_train_step(model, tcfg),
                  steps.make_train_step(meta_model, tcfg),
                  (params, opt, batch, (seed, 0), index),
                  TRAIN_BATCH * TRAIN_SEQ)}
    out, launches = {}, {}
    for name, (step, meta_step, args, tokens) in cases.items():
        step(*args)  # warm-up: first-use costs out of the figures
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        with CostMode() as mode:
            step(*args)
        torch.cuda.synchronize()
        card = mode.cost
        run = {k: n for k, n in ops.launch_counts().items() if n}
        peak = torch.cuda.max_memory_allocated() - base
        margs = to_meta(args)  # made outside the trace: inputs, not temps
        with CostMode() as mode:
            meta_step(*margs)
        meta = mode.cost
        del margs
        same = {"flops": card.flops == meta.flops,
                "hbm_bytes": card.hbm_bytes == meta.hbm_bytes,
                "kernels": card.kernels == meta.kernels}
        times = []
        for _ in range(COST_REPEATS):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            a.record()
            step(*args)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        prof = profile(torch, f"{COST_TAG} {name} step",
                       lambda: (step(*args), tokens)[1])
        t_c = roofline.t_compute(card.flops_by_dtype)
        t_m = card.hbm_bytes / roofline.HW["hbm_bw"]
        bound_ms = 1e3 * max(t_c, t_m)
        rec = {"tokens": tokens, "flops": card.flops,
               "flops_by_dtype": card.flops_by_dtype,
               "hbm_bytes": card.hbm_bytes, "kernels": card.kernels,
               "launches": run,
               "aten_ops": card.op_count, "card_equals_meta": same,
               "meta_flops": meta.flops, "meta_hbm_bytes": meta.hbm_bytes,
               "t_compute_ms": 1e3 * t_c, "t_memory_ms": 1e3 * t_m,
               "bound_ms": bound_ms,
               "bound_by": "operations" if t_c >= t_m else "bytes",
               "device_busy_ms": prof["device_ms"],
               "device_idle_share": prof["device_idle_share"],
               "event_ms": statistics.median(times),
               "bound_share_of_busy": bound_ms / prof["device_ms"],
               "temp_gb": card.peak_bytes / 2**30,
               "meta_temp_gb": meta.peak_bytes / 2**30,
               "max_memory_allocated_gb": peak / 2**30,
               "temp_over_allocated": card.peak_bytes / peak if peak else None}
        if name == "serve":
            # flash_decode is charged every ring row (the op reads no
            # device value); this step's live rows are known here
            ring = next(lay["k"] for g in cache for lay in g.values()
                        if "k" in lay)[0]
            qm = torch.empty(SLOTS, cfg.n_heads, ring.shape[-1],
                             dtype=ring.dtype, device="meta")
            lens = torch.empty(SLOTS, dtype=torch.int32, device="meta")
            live = int((pos.cpu() + 1).clamp(max=ring.shape[1]).sum())
            n = card.kernels["flash_decode"]["charges"]
            top = kcost.flash_decode(qm, ring, lens)
            at = kcost.flash_decode(qm, ring, lens, live=live)
            f_live = dict(card.flops_by_dtype)
            f_live[top.dtype] -= n * (top.flops - at.flops)
            b_live = card.hbm_bytes - n * (top.bytes - at.bytes)
            rec["ring_rows_live"] = [live, SLOTS * ring.shape[1]]
            rec["bound_ms_live"] = 1e3 * max(
                roofline.t_compute(f_live), b_live / roofline.HW["hbm_bw"])
            rec["bound_live_share_of_busy"] = (rec["bound_ms_live"]
                                               / prof["device_ms"])
        print(f"{COST_TAG} {name} step ({smi}) " + json.dumps(rec),
              flush=True)
        check(all(same.values()), f"{COST_TAG} {name}: the card's counts "
              f"differ from the meta trace's: {json.dumps(same)} "
              f"(flops {card.flops} / {meta.flops}, bytes {card.hbm_bytes} "
              f"/ {meta.hbm_bytes}, kernels {json.dumps(card.kernels)} / "
              f"{json.dumps(meta.kernels)})")
        charges = {k: v["charges"] for k, v in card.kernels.items()}
        check(run == charges, f"{COST_TAG} {name}: kernels launched "
              f"{json.dumps(run)} differ from those charged "
              f"{json.dumps(charges)}")
        for k, n in run.items():
            launches[k] = launches.get(k, 0) + n
        out[name] = rec
    for rec in records:
        rec["launches_cost"] = launches.get(rec["name"], 0)
    del params, sp, cache, opt, index
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- serve-tier
TIER_NEW = 8  # the reference engine's run: 4 requests x 8 new tokens
TIER_BLOCKS = 8  # the tight pool: 8 blocks of 16 positions, a 128-position
#   ring (a maximal admissible request must fit the pool); at 36-44
#   positions a request holds 3 blocks, so at most two are resident
TIER_ARRIVAL_S = 0.05  # staggered arrivals: request i enqueues at i x this
TIER_TTFT_SLO_S = 0.2  # the slo run's TTFT target (seconds)
TIER_STRICT_L = 8  # strict's second run: |T| = 8 makes certificates fail
ADAPTIVE = (2, 16)  # n_probe_init -> n_probe_max of the adaptive runs
REFRESH_ITERS = 300  # Lloyd iterations of the refresh run's converged index


def serve_tier(torch, cfg, scfg_kw, ctx) -> tuple[dict, dict]:
    """The ``[serve-tier]`` phase, on the ``[serve]`` phase's weights and
    prompts at full width: the paged pool (block_len 64, auto pool; then
    block_len 16 on a pool of 8 blocks, so admission stalls), the slo
    scheduler against fifo under staggered arrivals, strict re-sampling,
    the single-step reference engine, the adaptive probe (fused T=8 against
    unfused T=1, then a fitted, saved and reloaded router) and
    ``refresh_index``. Every run must give the tokens its contract says.
    Returns (launch counts of the paged run, a summary)."""
    import dataclasses as dc
    import tempfile

    import numpy as np

    from repro_torch.core import mips as mips_lib
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import report
    from repro_torch.models import router as router_lib
    from repro_torch.serve.server import ServeConfig, Server

    params, prompts, dense = ctx["params"], ctx["prompts"], ctx["tokens"]
    out: dict = {}

    def server(mcfg, index=None, **kw):
        return Server(mcfg, params, ServeConfig(**dict(scfg_kw, **kw)),
                      precision_policy="bf16", device="cuda", index=index)

    def serve_run(mcfg, index=None, run_prompts=None, **kw):
        srv = server(mcfg, index, **kw)
        res = srv.run(prompts if run_prompts is None else run_prompts)
        torch.cuda.synchronize()
        return srv, res, report(res, srv)

    def show(tag, rep):
        print(f"[serve-tier] {tag} {json.dumps(rep)}", flush=True)

    # 1) the paged pool, both indexes: tokens bit for bit the dense run's
    counts = None
    for mips in MIPS:
        mcfg = cfg.scaled(head_mips=mips, head_fused_decode=True)
        index = ctx["servers"][mips].index
        for block_len, n_blocks, max_seq in ((64, 0, scfg_kw["max_seq"]),
                                             (16, TIER_BLOCKS, 128)):
            ops.reset_launch_counts()
            srv, res, rep = serve_run(mcfg, index, decode_window=WINDOW,
                                      block_len=block_len, n_blocks=n_blocks,
                                      max_seq=max_seq)
            run_counts = ops.launch_counts()
            tag = f"{mips} paged block_len={block_len} n_blocks={n_blocks}"
            show(tag, rep)
            same = sum(r.tokens == t for r, t in zip(res, dense[mips]))
            print(f"[serve-tier] {tag} == dense tokens: {same}/{len(res)} "
                  f"requests; launches {json.dumps(run_counts)}", flush=True)
            check(same == len(prompts), f"{tag}: tokens differ from the "
                  "dense layout's")
            check(srv.alloc.n_used == 0, f"{tag}: blocks leaked")
            check(run_counts["flash_decode_paged"] > 0
                  and run_counts["flash_decode"] == 0,
                  f"{tag}: decode did not walk the page table")
            if n_blocks:
                check(rep["block_stalls"] > 0, f"{tag}: no admission stall")
            if counts is None:
                counts = run_counts
                out["paged_cache_mb"] = rep["cache_mb"]
                out["paged_path"] = profile(
                    torch, "serve-tier ivf paged block_len=64",
                    lambda: sum(len(r.tokens)
                                for r in srv.run(prompts[:SLOTS])))
            out[f"{mips}_paged_bl{block_len}"] = rep
            del srv
    ivf_cfg = cfg.scaled(head_mips="ivf", head_fused_decode=True)
    ivf_index = ctx["servers"]["ivf"].index

    # 2) slo against fifo, staggered arrivals: the same streams
    arrivals = [TIER_ARRIVAL_S * i for i in range(len(prompts))]
    picked: list[int] = []
    streams = {}
    for sched in ("fifo", "slo"):
        srv = server(ivf_cfg, ivf_index, decode_window=WINDOW, sched=sched,
                     ttft_slo_s=TIER_TTFT_SLO_S)
        if sched == "slo":
            pick = srv.sched.pick_window

            def spy(*a, pick=pick):
                picked.append(pick(*a))
                return picked[-1]

            srv.sched.pick_window = spy
        res = srv.run(prompts, arrivals=arrivals,
                      priorities=[i % 2 for i in range(len(prompts))])
        torch.cuda.synchronize()
        rep = report(res, srv)
        show(f"ivf {sched} arrivals every {TIER_ARRIVAL_S} s", rep)
        out[f"{sched}_arrivals"] = rep
        streams[sched] = [r.tokens for r in res]
    windows = {str(w): picked.count(w) for w in sorted(set(picked))}
    print(f"[serve-tier] slo windows picked {json.dumps(windows)}; "
          f"slo == fifo: {streams['slo'] == streams['fifo']}", flush=True)
    out["slo_windows"] = windows
    check(streams["slo"] == streams["fifo"] == dense["ivf"],
          "slo and fifo served different streams")

    # 3) strict: the default head, then |T| = 8 so certificates fail
    for l in (0, TIER_STRICT_L):
        mcfg = ivf_cfg.scaled(head_l=l) if l else ivf_cfg
        runs = {}
        for strict in (False, True):
            srv, res, rep = serve_run(mcfg, ivf_index, decode_window=WINDOW,
                                      strict=strict)
            runs[strict] = (srv, res, rep)
        (lazy, r_l, rep_l), (strc, r_s, rep_s) = runs[False], runs[True]
        check(rep_s["fallbacks"] == round(
            rep_s["decoded_tokens"] * (1 - rep_s["ok_rate"])),
            "strict: fallbacks != failed certificates")
        kept = [i for i, r in enumerate(r_s) if r.ok_rate == 1.0]
        same = sum(r_s[i].tokens == r_l[i].tokens for i in kept)
        check(same == len(kept), "strict changed a request whose every "
              "certificate held")
        check(all(0 <= t < cfg.vocab for r in r_s for t in r.tokens),
              "strict: a token id out of range")
        stat = {"l": mcfg.head_l or "default", "fallbacks":
                rep_s["fallbacks"], "ok_rate": rep_s["ok_rate"],
                "itl_p50_ms": {"lazy": rep_l["itl_p50_ms"],
                               "strict": rep_s["itl_p50_ms"]},
                "certified_requests_equal": f"{same}/{len(kept)}"}
        if not l:  # what strict costs a token: warm repeats, A B B A
            warm = {}
            for kind, srv in (("lazy", lazy), ("strict", strc),
                              ("strict", strc), ("lazy", lazy)):
                warm.setdefault(kind, []).append(warm_repeat(
                    torch, srv, prompts[:SLOTS])["wall_ms_per_token"])
            stat.update(warm_wall_ms_per_token=warm, syncs_per_token={
                "lazy": syncs_per_token(torch, lazy, prompts[:SLOTS]),
                "strict": syncs_per_token(torch, strc, prompts[:SLOTS])})
        print(f"[serve-tier] ivf strict {json.dumps(stat)}", flush=True)
        out[f"strict_l{l}"] = stat
        del lazy, strc, runs

    # 4) the single-step reference engine: 4 requests x 8 tokens, against
    # the pipelined engine on the same requests. Both at the f32 policy:
    # in bf16 the pipelined prefill's batched projections and the
    # reference's one-token decode steps round K, V and h differently
    # (other GEMM shapes, other kernels), which moves the samples
    streams = {}
    for engine in ("pipelined", "reference"):
        srv = Server(ivf_cfg, params, ServeConfig(**dict(
            scfg_kw, engine=engine, max_new_tokens=TIER_NEW,
            decode_window=WINDOW)), precision_policy="f32", device="cuda",
            index=ivf_index)
        res = srv.run(prompts[:SLOTS])
        torch.cuda.synchronize()
        rep = report(res, srv)
        show(f"ivf {engine} engine f32, {SLOTS} x {TIER_NEW} tokens", rep)
        streams[engine] = [r.tokens for r in res]
        out[engine] = rep
        del srv
    same = sum(a == b for a, b in zip(streams["reference"],
                                      streams["pipelined"]))
    bf16 = sum(a[:TIER_NEW] == b[:TIER_NEW] for a, b in zip(
        streams["reference"], dense["ivf"]))
    print(f"[serve-tier] reference engine == pipelined (f32): {same}/"
          f"{SLOTS} requests; == the bf16 pipelined run's first {TIER_NEW} "
          f"tokens: {bf16}/{SLOTS}", flush=True)
    check(same == SLOTS, "the reference engine and the pipelined one "
          "served different tokens")

    # 5) the adaptive probe: fused T=8 == unfused T=1, then a router
    init, top = ADAPTIVE
    for mips in MIPS:
        acfg = cfg.scaled(head_mips=mips, head_adaptive_probe=True,
                          head_n_probe_init=init, head_n_probe_max=top)
        fsrv, r_f, rep_f = serve_run(acfg.scaled(head_fused_decode=True),
                                     decode_window=WINDOW)
        _, r_u, rep_u = serve_run(acfg, fsrv.index, decode_window=1)
        show(f"{mips} adaptive {init}->{top} fused T={WINDOW}", rep_f)
        show(f"{mips} adaptive {init}->{top} unfused T=1", rep_u)
        check([r.tokens for r in r_f] == [r.tokens for r in r_u],
              f"{mips} adaptive: fused T=8 != unfused T=1")
        check(rep_f["probe_width_hist"] == rep_u["probe_width_hist"]
              and rep_f["probe_width_hist"],
              f"{mips} adaptive: width histograms differ or are empty")
        out[f"{mips}_adaptive"] = {"fused": rep_f, "unfused": rep_u}
        if mips != "ivf":
            continue
        t0 = time.perf_counter()
        rsrv = server(acfg.scaled(head_fused_decode=True), fsrv.index,
                      decode_window=WINDOW, probe_router="fit")
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        r_r = rsrv.run(prompts)
        rep_r = report(r_r, rsrv)
        with tempfile.TemporaryDirectory() as tmp:
            path = str(Path(tmp) / "router.npz")
            router_lib.save_router(path, rsrv.router)
            lsrv, r_l, rep_l = serve_run(acfg.scaled(head_fused_decode=True),
                                         fsrv.index, decode_window=WINDOW,
                                         probe_router=path)
        check(all(torch.equal(a, b) for a, b in zip(lsrv.router,
                                                    rsrv.router)),
              "a reloaded router differs from the saved one")
        show(f"ivf adaptive router=fit (server and fit {fit_s:.2f} s)",
             rep_r)
        show("ivf adaptive router=reloaded", rep_l)
        check([r.tokens for r in r_r] == [r.tokens for r in r_l]
              == [r.tokens for r in r_f],
              "a routed adaptive probe changed the tokens")
        out["ivf_router"] = {"fit": rep_r, "reloaded": rep_l}
        del fsrv, rsrv, lsrv

    # 6) refresh_index with unchanged params
    srv0 = ctx["servers"]["ivf"]
    db = srv0.model.head_index_db(params)
    conv = mips_lib.build_index(dc.replace(srv0.index.config,
                                           kmeans_iters=REFRESH_ITERS), db)
    srv, r_a, _ = serve_run(ivf_cfg, conv, decode_window=WINDOW)
    health = {"build": {k: srv.stats[k] for k in ("index_bytes",
                                                  "index_spill")}}
    srv = server(ivf_cfg, conv, decode_window=WINDOW)
    srv.refresh_index(params)  # a push of the same params, then the run
    torch.cuda.synchronize()
    health["refresh"] = {k: srv.stats[k] for k in ("index_bytes",
                                                   "index_spill")}
    members = torch.equal(conv.state.member_ids, srv.index.state.member_ids)
    r_b = srv.run(prompts)
    same = sum(a.tokens == b.tokens for a, b in zip(r_a, r_b))
    # the default (10-iteration) index: how far one refresh moves it
    default = srv0.index.refresh(db)
    moved = int((default.state.member_ids
                 != srv0.index.state.member_ids).sum().item())
    ref = {"converged_index": f"{REFRESH_ITERS} Lloyd iterations",
           "health": health, "member_tables_equal": members,
           "tokens_equal": f"{same}/{len(r_a)}",
           "default_index_member_slots_moved": moved}
    print(f"[serve-tier] ivf refresh_index {json.dumps(ref)}", flush=True)
    check(members and same == len(r_a) and health["refresh"]
          == health["build"], "refresh_index with unchanged params changed "
          "the index or the tokens")
    out["refresh"] = ref
    del srv, conv, default
    torch.cuda.empty_cache()
    return counts, out


# ---------------------------------------------------------------- training
def train_config(seed: int):
    from repro_torch.launch.steps import TrainConfig
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train.trainer import RunConfig

    return RunConfig(num_steps=TRAIN_STEPS, ckpt_every=TRAIN_EVERY,
                     log_every=1, keep_ckpts=2, seed=seed, batch=TRAIN_BATCH,
                     seq=TRAIN_SEQ, index_refresh_every=TRAIN_EVERY,
                     train=TrainConfig(opt=OptConfig(**TRAIN_OPT),
                                       precision="bf16"))


# the kernels each training path must launch, by head index
TRAIN_KERNELS = {
    "ivf": ("fused_estimator", "fused_estimator_bwd", "ivf_gather_score"),
    "ivfpq": ("fused_estimator", "fused_estimator_bwd", "pq_lut_score",
              "rerank_select"),
}


def train(torch, seed: int, cfg, mips: str, label: str = "[train]"
          ) -> tuple[dict, dict]:
    """The training phase of one head index: 6 full-width steps through
    ``Trainer`` with the amortized head on the kernels, then a resume from
    the step-3 checkpoint; its lines start with ``label``. Returns (launch
    counts of the 6-step run, stats)."""
    from repro_torch.kernels import ops
    from repro_torch.train.trainer import Trainer

    tcfg = cfg.scaled(head_mips=mips)
    workdir = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(workdir, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    tr = Trainer(tcfg, train_config(seed), str(workdir), device="cuda")
    res = tr.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    log = tr.metrics_log
    for e in log:
        print(f"{label} {mips} step {e['step']} loss={e['loss']:.5f} "
              f"nll={e['nll']:.5f} log_z={e['log_z']:.4f} "
              f"grad_norm={e['grad_norm']:.4f} dt={e['dt'] * 1e3:.1f} ms",
              flush=True)
    losses = [e["loss"] for e in log]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    step_ms = statistics.median(e["dt"] for e in log[1:]) * 1e3
    stats = {"steps": len(log), "tokens_per_step": tokens,
             "step_ms_median": step_ms,
             "tokens_per_s": tokens / (step_ms / 1e3),
             "first_step_ms": log[0]["dt"] * 1e3 if log else None,
             "run_wall_s": wall, "index_refreshes": tr.index_refreshes,
             "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
             "index_mb": tr.head_index.memory_bytes() / 1e6}
    print(f"{label} {mips} {json.dumps(stats)}", flush=True)
    print(f"{label} launches {json.dumps(counts)}", flush=True)
    check(res["status"] == "done" and len(losses) == TRAIN_STEPS,
          f"train {mips}: the run did not take its 6 steps")
    check(all(math.isfinite(x) for x in losses),
          f"train {mips}: a non-finite loss")
    check(losses[-1] < losses[0],
          f"train {mips}: loss did not fall ({losses[0]} -> {losses[-1]})")
    check(tr.index_refreshes == TRAIN_STEPS // TRAIN_EVERY,
          f"train {mips}: the head index was not refreshed every 3 steps")
    for name in TRAIN_KERNELS[mips]:
        check(counts[name] > 0, f"train {mips} never launched {name}")
    del tr
    torch.cuda.empty_cache()

    # resume: drop the final checkpoint, restart from the step-3 one
    shutil.rmtree(workdir / f"ckpt_{TRAIN_STEPS:08d}")
    t0 = time.perf_counter()
    tr2 = Trainer(tcfg, train_config(seed), str(workdir), device="cuda")
    tr2.train()
    torch.cuda.synchronize()
    resumed = [e["loss"] for e in tr2.metrics_log]
    want = losses[TRAIN_EVERY:]
    rel = max(abs(a - b) / abs(b) for a, b in zip(resumed, want))
    print(f"{label} {mips} resume from step {TRAIN_EVERY}: losses {resumed} vs "
          f"{want}, max rel diff {rel:.3g}, bitwise {resumed == want}, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    check(len(resumed) == len(want) and rel <= RESUME_RTOL,
          f"train {mips}: the resumed run does not match the uninterrupted "
          "one")
    del tr2
    shutil.rmtree(workdir, ignore_errors=True)
    torch.cuda.empty_cache()
    stats["resume_max_rel_diff"] = rel
    return counts, stats


def probe_diagnostics(torch, seed: int, cfg) -> dict:
    """Six full-width steps outside the trainer for each top-k probe of the
    amortized head (the exact dense probe, and the IVF and IVF-PQ indexes,
    built and refreshed every 3 steps over a copy of the rows as the
    trainer does), reading before each update both the amortized loss the
    step optimizes and the exact NLL of the same batch (a dense logsumexp
    over all 32000 rows); then torch.profiler over one more step of the IVF
    and the IVF-PQ runs. Returns ({probe: {"amortized": [...], "exact":
    [...]}}, each head kernel's device us per call in the first profiled
    step that launches it, IVF first)."""
    import numpy as np

    from repro_torch.core import amortized_head as ah
    from repro_torch.data.synthetic import DataConfig, make_batch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw

    run = train_config(seed)
    dcfg = DataConfig(batch=TRAIN_BATCH, seq=TRAIN_SEQ, seed=seed)
    out, path_us = {}, {}
    for mips in ("exact",) + MIPS:
        tcfg = cfg.scaled(head_mips=mips)
        model = Model(tcfg, "bf16", device="cuda")
        exact_head = dataclasses.replace(model.head_cfg, mode="exact")
        params = model.init(seed)
        opt = adamw.init(params)
        index = model.make_head_index(
            params, db=model.head_index_db(params).clone())
        step = make_train_step(model, run.train)
        amortized, exact = [], []

        def one(i: int, diagnose: bool = True) -> int:
            batch = {k: torch.from_numpy(np.asarray(v)).cuda()
                     for k, v in make_batch(tcfg, dcfg, i).items()}
            if diagnose:
                with torch.no_grad():
                    x, pos, _ = model._embed_inputs(params, batch)
                    h, _ = transformer.apply_trunk(params, tcfg, x, pos)
                    exact.append(ah.head_loss(
                        params["out_embed"], h.reshape(-1, h.shape[-1]),
                        batch["labels"].reshape(-1), exact_head
                    ).loss.mean().item())
            _, _, m = step(params, opt, batch, (seed, i), index)
            if diagnose:
                amortized.append(m["loss"].item())
            return TRAIN_BATCH * TRAIN_SEQ

        for i in range(TRAIN_STEPS):
            one(i)
            if index is not None and (i + 1) % TRAIN_EVERY == 0:
                index = index.refresh(model.head_index_db(params).clone())
        gap = max(abs(a - e) for a, e in zip(amortized, exact))
        print(f"[train] probe={mips}: amortized loss {amortized}, exact NLL "
              f"{exact}, max gap {gap:.4g}", flush=True)
        check(all(math.isfinite(x) for x in amortized + exact),
              f"probe={mips}: a non-finite loss")
        if mips == "exact":
            # with the exact top-576 the uniform tail holds little mass, so
            # the stratified estimate sits within hundredths of log Z
            check(gap <= EXACT_PROBE_GAP,
                  f"probe=exact: amortized loss {gap} nats off the exact NLL")
        out[mips] = {"amortized": amortized, "exact": exact}
        if mips != "exact":
            prof = profile(torch, f"train step {mips}",
                           lambda: one(TRAIN_STEPS, False))
            for name, v in prof["kernels"].items():
                path_us.setdefault(name, v["us_per_call"])
        del params, opt, index
        torch.cuda.empty_cache()
    return out, path_us


# ---------------------------------------------------------------- the paper
# the paper's own setting (configs/paper_loglinear.py): a fixed clustered
# feature table, a stream of θ = row / τ, the index and the estimators of
# repro_torch.core. Query counts per configuration; cut from the paper's
# query stream to what the script's time allows.
PAPER_RUNS = (("IMAGENET", 64), ("WORD_EMBEDDINGS", 32))
PAPER_CENTERS, PAPER_NOISE = 256, 0.5  # the clustered table's centres, noise
PAPER_N_PROBE = 16  # build_ivf's fixed probe: sqrt(n) clusters, 4 Lloyd its
PAPER_ADAPTIVE = (4, 64)  # topk_adaptive's n_probe_init, n_probe_max
PAPER_M_CAP_X = 8  # Algorithm 1's buffer: this many times ceil(n / k)
PAPER_ITERS = 5  # event-timed repeats of each stage
# the fused adaptive probe at the LM head's geometry (tinyllama's vocab and
# width, n_probe 8, k 576), where the screens' select holds the pool
HEAD_ADAPTIVE = (2, 16)


def paper_table(torch, gen, n: int, d: int):
    """Unit-norm rows around ``PAPER_CENTERS`` Gaussian centres with noise
    ``PAPER_NOISE`` (the reference benchmarks' clustered table), made on the
    card from ``gen``."""
    centers = torch.randn((PAPER_CENTERS, d), generator=gen, device="cuda")
    assign = torch.randint(0, PAPER_CENTERS, (n,), generator=gen,
                           device="cuda")
    db = centers[assign]
    db += PAPER_NOISE * torch.randn((n, d), generator=gen, device="cuda")
    return db / torch.linalg.norm(db, dim=1, keepdim=True)


def paper_queries(torch, gen, db, b: int, tau: float):
    """θ drawn uniformly from the table's rows, scaled by 1/τ (paper
    §4.1.2)."""
    rows = torch.randint(0, db.shape[0], (b,), generator=gen, device="cuda")
    return db[rows] / tau


def event_ms(torch, fn, iters: int = PAPER_ITERS) -> float:
    """Median device-event time of ``fn()`` between two events on the
    stream, synchronized before each call: the call's kernels and any gap
    the host leaves between them (these stages sync the host)."""
    fn()
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def topk_ties_ok(torch, ids, exact, y, rows) -> bool:
    """On each row of ``rows``, ``ids`` is the exact top-k up to ties at the
    k-th value: every id in one set and not the other scores within 1e-5
    times the row's largest score of the exact k-th value."""
    for i in rows.tolist():
        got = set(ids[i].tolist())
        want = set(exact.ids[i].tolist())
        diff = torch.tensor(sorted(got ^ want), dtype=torch.long,
                            device="cuda")
        if not diff.numel():
            continue
        if (diff < 0).any():
            return False
        kth = exact.values[i, -1]
        tol = 1e-5 * y[i].abs().max()
        if ((y[i, diff] - kth).abs() > tol).any():
            return False
    return True


def recall(ids, exact) -> list[float]:
    k = ids.shape[1]
    return [len(set(a.tolist()) & set(b.tolist())) / k
            for a, b in zip(ids, exact.ids)]


def paper_one(torch, seed: int, name: str, b: int, timer: Timer,
              records: dict, smi: str) -> dict:
    """One configuration of the paper's setting at full width: table,
    queries and index; ``ivf_gather_score`` against its plain version at
    the path's shapes; the main path once with the launch counts set to 0
    (the probe, both samplers, Algorithms 3 and 4, the adaptive probe and
    the dense oracle, through the ``repro_torch.core`` API); the gates;
    then the report and the event-timed stages."""
    from repro_torch.configs import paper_loglinear
    from repro_torch.core import (default_kl, expectation_estimate,
                                  gumbel_max_dense, mips, partition_estimate,
                                  sample_adaptive_b, sample_fixed_b)
    from repro_torch.kernels import fused_estimator as kfe
    from repro_torch.kernels import ivf_gather_score as kigs
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.steps import slot_keys

    cfg = getattr(paper_loglinear, name)
    n, d = cfg.n, cfg.d
    tag = "paper_" if name == "IMAGENET" else "words_"
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 7)
    t0 = time.perf_counter()
    db = paper_table(torch, gen, n, d)
    theta = paper_queries(torch, gen, db, b, cfg.temperature)
    index = mips.build_index(mips.IVFConfig(
        n_clusters=max(16, int(math.sqrt(n))), kmeans_iters=4,
        n_probe=PAPER_N_PROBE), db)
    st = index.state
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    k = l = default_kl(n, cfg.delta)
    m_cap = PAPER_M_CAP_X * -(-n // k)
    init, top = PAPER_ADAPTIVE
    geo = {"n": n, "d": d, "queries": b, "k": k, "l": l, "m_cap": m_cap,
           "n_clusters": st.n_clusters, "cap": st.cap,
           "o_cap": st.overflow_ids.shape[0],
           "spill": int(st.spill_count), "index_gb":
           index.memory_bytes() / 1e9, "build_s": build_s, "card": smi}
    print(f"[paper] {cfg.name} " + json.dumps(geo), flush=True)

    # ---- ivf_gather_score at the path's shapes against its plain version:
    # topk_batch's 16 probes (timed), the adaptive pool's 64 (in chunks)
    qf = theta.float()
    c_scores = qf @ st.centroids.T
    rec = records["ivf_gather_score"]
    for n_probe in (PAPER_N_PROBE, top):
        _, probe = mips.top_k(c_scores, n_probe)
        s, i = kigs.ivf_gather_score(st.member_vecs, st.member_ids, probe, qf)
        err = 0.0
        for c0 in range(0, b, 8):
            ws, wi = ref.ivf_gather_score_ref(st.member_vecs, st.member_ids,
                                              probe[c0:c0 + 8], qf[c0:c0 + 8])
            check(torch.equal(i[c0:c0 + 8], wi),
                  f"[paper] ivf_gather_score ids disagree, {n_probe} probes")
            check(values_close(torch, s[c0:c0 + 8], ws, scaled=True),
                  f"[paper] ivf_gather_score scores disagree, {n_probe} "
                  f"probes: {max_err(s[c0:c0 + 8], ws)}")
            err = max(err, max_err(s[c0:c0 + 8], ws))
        del s, i, ws, wi
        rec[f"{tag}max_abs_err_{n_probe}probes"] = err
        if n_probe == PAPER_N_PROBE:
            g = Geometry(0, 0, 0, 0, 0, n, d, st.n_clusters, st.cap,
                         st.overflow_ids.shape[0], n_probe, k, m_cap, 0, 0, 0)
            gather_record(torch, g, timer, rec, tag, st.member_vecs,
                          st.member_ids, probe, qf)
    torch.cuda.empty_cache()

    # ---- the main path, once, counted
    keys = [slot_keys(seed, torch.arange(b, device="cuda"),
                      torch.full((b,), p, device="cuda")) for p in range(4)]

    def score_fn(ids):
        return torch.bmm(db[ids], theta[:, :, None])[..., 0]

    def f_fn(ids):
        return db[ids]

    def run():
        topk = index.topk_batch(theta, k)
        return (topk,
                sample_fixed_b(keys[0], topk, n, score_fn, l=l),
                sample_adaptive_b(keys[1], topk, n, score_fn, m_cap=m_cap),
                partition_estimate(keys[2], topk, n, score_fn, l=l),
                expectation_estimate(keys[2], topk, n, score_fn, f_fn, l=l),
                index.topk_adaptive(theta, k, c=0.0, n_probe_init=init,
                                    n_probe_max=top),
                gumbel_max_dense(keys[3], theta @ db.T, return_max=True))

    ops.reset_launch_counts()
    topk, fixed, adap, pe, ee, atk, (dense_i, dense_v) = run()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    print(f"[paper] {cfg.name} launches {json.dumps(counts)}", flush=True)

    # ---- the references: exact top-k and log Z by dense scoring
    y = theta @ db.T  # (b, n)
    exact = mips.build_index(mips.ExactConfig(), db).topk_batch(theta, k)
    log_z = torch.logsumexp(y, dim=1)

    # ---- gates
    outs = [topk.values, fixed.max_val, fixed.bound, adap.max_val,
            adap.bound, pe.log_z, pe.tail_values, ee.value, ee.log_z,
            atk.values, dense_v]
    check(not any(torch.isnan(x).any().item() for x in outs),
          f"[paper] {cfg.name}: a NaN in the outputs")
    cert = atk.certified.nonzero()[:, 0]
    check(topk_ties_ok(torch, atk.ids, exact, y, cert),
          f"[paper] {cfg.name}: a certified top-k differs from the exact "
          "top-k beyond ties at the k-th value")
    degen = index.topk_adaptive(theta, k, n_probe_init=PAPER_N_PROBE,
                                n_probe_max=PAPER_N_PROBE)
    check(torch.equal(degen.ids, topk.ids)
          and torch.equal(degen.values, topk.values)
          and bool((degen.width == PAPER_N_PROBE).all()),
          f"[paper] {cfg.name}: init == max differs from topk_batch")
    ids_all = torch.cat([topk.ids.long(), pe.tail_ids], dim=1)
    log_w = torch.cat([torch.zeros_like(topk.values),
                       torch.full_like(pe.tail_values,
                                       math.log((n - k) / l))], dim=1)
    kz, kexp = ops.fused_estimator(db, ids_all, theta, log_w)
    pz, pexp = ref.fused_estimator_ref(db, ids_all, theta, log_w)
    check(torch.allclose(pe.log_z, kz, rtol=1e-5, atol=0.0),
          f"[paper] {cfg.name}: Algorithm 3 != fused_estimator: "
          f"{max_err(pe.log_z, kz)}")
    check(torch.allclose(ee.value, kexp, rtol=1e-4, atol=1e-5),
          f"[paper] {cfg.name}: Algorithm 4 (f = φ) != fused_estimator: "
          f"{max_err(ee.value, kexp)}")
    check(close(torch, kz, pz) and close(torch, kexp, pexp),
          f"[paper] {cfg.name}: fused_estimator != its plain version")
    frec = records["fused_estimator"]
    flive = torch.isfinite(log_w)
    b_ms, b_by = bound_ms(*kcost().fused_estimator(
        db, ids_all, theta, log_w,
        rows=int(torch.unique(ids_all.clamp(0, n - 1)[flive]).numel()),
        n_live=int(flive.sum().item()))[:2], FP32_FLOPS)
    frec.update({f"{tag}max_abs_err": max(max_err(kz, pz),
                                          max_err(kexp, pexp)),
                 f"{tag}ms": timer(lambda: ops.fused_estimator(
                     db, ids_all, theta, log_w), f"fused_estimator {tag}"),
                 f"{tag}plain_ms": timer(lambda: ref.fused_estimator_ref(
                     db, ids_all, theta, log_w),
                     f"fused_estimator {tag}plain"),
                 f"{tag}bound_ms": b_ms, f"{tag}bound_by": b_by,
                 **{f"{tag}{k}": v for k, v in kfe.route(
                     *db.shape, *ids_all.shape).items()}})
    print(f"[paper] {cfg.name} kernel fused_estimator " + json.dumps(
        {k: v for k, v in frec.items() if k.startswith(tag)}), flush=True)

    # ---- report
    # the gap c the IVF top-k really has: the best score outside it minus
    # its k-th value (<= 0: an exact top-k, Algorithm 2's c = 0 holds)
    outside = y.scatter(1, topk.ids.long().clamp(min=0),
                        float("-inf")).amax(dim=1)
    gap = outside - topk.values[:, -1]
    widths = {int(w): int(c) for w, c in
              zip(*torch.unique(atk.width, return_counts=True))}
    dz = (pe.log_z - log_z).abs()
    rec_batch = recall(topk.ids, exact)
    report = {
        "card": smi,
        "recall_topk_batch": statistics.mean(rec_batch),
        "recall_topk_batch_min": min(rec_batch),
        "recall_topk_adaptive": statistics.mean(recall(atk.ids, exact)),
        "exact_topk_share": (gap <= 0).float().mean().item(),
        "gap_c_median": gap.median().item(), "gap_c_max": gap.max().item(),
        "ok_fixed": fixed.ok.float().mean().item(),
        # Algorithm 2's certificate at the top-k's true gap c
        "ok_fixed_true_gap": ((fixed.max_val >= fixed.bound
                               + gap.clamp(min=0)) & ~fixed.overflow
                              ).float().mean().item(),
        "ok_adaptive": adap.ok.float().mean().item(),
        "overflow_adaptive": adap.overflow.float().mean().item(),
        "m_fixed_mean": fixed.m.double().mean().item(),
        "m_adaptive_mean": adap.m.double().mean().item(),
        "n_over_k": n / k,
        "logz_abs_err_median": dz.median().item(),
        "logz_abs_err_max": dz.max().item(),
        "certified_share": atk.certified.float().mean().item(),
        "width_hist": widths,
        "dense_in_topk_share": torch.isin(
            dense_i, topk.ids.long()).float().mean().item()}
    print(f"[paper] {cfg.name} report " + json.dumps(report), flush=True)

    stages = {
        "probe_topk_batch": lambda: index.topk_batch(theta, k),
        "probe_topk_adaptive": lambda: index.topk_adaptive(
            theta, k, c=0.0, n_probe_init=init, n_probe_max=top),
        "sample_fixed_b": lambda: sample_fixed_b(keys[0], topk, n, score_fn,
                                                 l=l),
        "sample_adaptive_b": lambda: sample_adaptive_b(
            keys[1], topk, n, score_fn, m_cap=m_cap),
        "partition_estimate": lambda: partition_estimate(
            keys[2], topk, n, score_fn, l=l),
        "expectation_estimate": lambda: expectation_estimate(
            keys[2], topk, n, score_fn, f_fn, l=l),
        "gumbel_max_dense": lambda: gumbel_max_dense(keys[3], theta @ db.T),
    }
    ms = {s: event_ms(torch, fn) for s, fn in stages.items()}
    per_query = {s: v / b for s, v in ms.items()}
    print(f"[paper] {cfg.name} event ms per query " + json.dumps(
        {"card": smi, **per_query}), flush=True)
    prof = None
    if name == "IMAGENET":
        prof = profile(torch, f"paper {cfg.name} main path",
                       lambda: (run(), b)[1])
    del db, theta, index, st, y, exact, topk, fixed, adap, pe, ee, atk
    torch.cuda.empty_cache()
    return {"geometry": geo, "launches": counts, "report": report,
            "ms_per_query": per_query,
            "profile": None if prof is None else {
                k2: prof[k2] for k2 in ("wall_ms", "device_ms",
                                        "device_idle_share", "top")}}


def head_adaptive(torch, seed: int, timer: Timer, records: dict,
                  smi: str) -> dict:
    """The fused adaptive probe at the LM head's geometry (tinyllama-1.1b's
    32,000 rows of d 2048, IVF: 178 clusters × 544 and 2,000 overflow rows;
    n_probe 8, k 576), where the screens' select holds the pool: the fused
    and unfused ``topk_adaptive`` must agree bit for bit, for IVF and
    IVF-PQ, and each stage kernel equals its plain version at mixed
    per-row widths (0 to past n_probe_max). Launch counts over the four
    adaptive runs."""
    from repro_torch.core import mips
    from repro_torch.core.mips.adaptive import stage_widths
    from repro_torch.core.mips.ivf import IVFConfig
    from repro_torch.core.mips.pq import PQConfig
    from repro_torch.kernels import decode_fused as kdf
    from repro_torch.kernels import ivf_gather_score as kigs
    from repro_torch.kernels import ops, ref

    n, d, k, b = 32000, 2048, 576, 64
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 11)
    db = paper_table(torch, gen, n, d)
    theta = paper_queries(torch, gen, db, b, 0.05)
    init, top = HEAD_ADAPTIVE
    ivf = mips.build_index(IVFConfig(n_probe=8), db)
    pq = mips.build_index(PQConfig(n_probe=8, rerank=2 * k), db)
    out = {"card": smi}
    indexes = {"ivf": ivf, "ivfpq": pq}
    # rows started at stages 0 .. 3 in turn (the router's interface): each
    # pass then probes mixed widths, 0 for the rows already done
    n_stages = len(stage_widths(init, top))
    routes = {"natural": None,
              "routed": torch.arange(b, device="cuda") % n_stages}
    ops.reset_launch_counts()
    runs = {(kind, route, fused): index.topk_adaptive(
        theta, k, c=0.0, n_probe_init=init, n_probe_max=top, fused=fused,
        init_stage=st0)
        for kind, index in indexes.items() for route, st0 in routes.items()
        for fused in (False, True)}
    torch.cuda.synchronize()
    out["launches"] = ops.launch_counts()
    for kind, index in indexes.items():
        out[kind] = {}
        for route in routes:
            un, fu = runs[kind, route, False], runs[kind, route, True]
            check(all(torch.equal(getattr(un, f), getattr(fu, f))
                      for f in un._fields),
                  f"[paper] head {kind} {route}: fused adaptive probe != "
                  "unfused")
            out[kind][route] = {
                "width_hist": {int(w): int(n_) for w, n_ in zip(
                    *torch.unique(un.width, return_counts=True))},
                "certified_share": un.certified.float().mean().item()}
        for fused in (False, True):
            out[kind]["ms_fused" if fused else "ms_unfused"] = event_ms(
                torch, lambda: index.topk_adaptive(
                    theta, k, c=0.0, n_probe_init=init, n_probe_max=top,
                    fused=fused))

    # each stage kernel against its plain version at mixed widths
    width = (torch.arange(b, device="cuda") % (top + 3)).int()
    st = ivf.state
    qf = theta.float()
    _, probe = mips.top_k(qf @ st.centroids.T, top)
    o_sc = (st.overflow_vecs.float() @ qf.T).T
    iargs = (st.member_vecs, st.member_ids, o_sc, st.overflow_ids, probe, qf)
    v, i = kdf.ivf_screen_select(*iargs, k=k, probe_width=width)
    wv, wi = ref.ivf_screen_select_ref(*iargs, k, probe_width=width)
    # random fp32 rows: the values within rounding of the plain version's
    # (whose near-equal scores may order otherwise), and the screen bit for
    # bit the ivf_gather_score kernel's pool masked to the widths + top-k
    check(values_close(torch, v, wv, scaled=True),
          f"[paper] ivf_screen_select at mixed widths: {max_err(v, wv)}")
    s2, i2 = kigs.ivf_gather_score(st.member_vecs, st.member_ids, probe, qf)
    live = (torch.arange(top, device="cuda")[None, :, None]
            < width[:, None, None])
    pool_s = torch.cat([torch.where(live, s2, float("-inf")).reshape(b, -1),
                        o_sc], dim=1)
    pool_i = torch.cat([torch.where(live, i2, -1).reshape(b, -1),
                        st.overflow_ids[None].expand(b, -1)], dim=1)
    v3, i3 = ref.topk_select_ref(
        torch.where(pool_i >= 0, pool_s, float("-inf")), pool_i, k)
    check(torch.equal(v3, v) and torch.equal(i3, i),
          "[paper] ivf_screen_select at mixed widths != ivf_gather_score "
          "+ top-k")
    del s2, i2, pool_s, pool_i
    records["ivf_screen_select"].update(
        adaptive_max_abs_err=max_err(v, wv),
        adaptive_ms=timer(lambda: kdf.ivf_screen_select(
            *iargs, k=k, probe_width=width), "ivf_screen_select adaptive"),
        adaptive_plain_ms=timer(lambda: ref.ivf_screen_select_ref(
            *iargs, k, probe_width=width),
            "ivf_screen_select adaptive plain"))
    _, probe, coarse, lut, o_sc = pq._screen_inputs(qf, top)
    pargs = (pq.state.member_codes, pq.state.member_ids, coarse, o_sc,
             pq.state.overflow_ids, probe, lut)
    r = 2 * k
    lv, cand = kdf.pq_screen_select(*pargs, r=r, probe_width=width)
    wlv, wcand = ref.pq_screen_select_ref(*pargs, r, probe_width=width)
    check(torch.equal(cand, wcand) and values_close(torch, lv, wlv),
          f"[paper] pq_screen_select at mixed widths: {max_err(lv, wlv)}")
    rv, ri = kdf.rerank_select(db, cand, lv, qf, k=k)
    wrv, wri = ref.rerank_select_ref(db, cand, lv, qf, k)
    check(values_close(torch, rv, wrv, scaled=True),
          f"[paper] rerank_select after mixed widths: {max_err(rv, wrv)}")
    records["pq_screen_select"].update(
        adaptive_max_abs_err=max_err(lv, wlv),
        adaptive_ms=timer(lambda: kdf.pq_screen_select(
            *pargs, r=r, probe_width=width), "pq_screen_select adaptive"),
        adaptive_plain_ms=timer(lambda: ref.pq_screen_select_ref(
            *pargs, r, probe_width=width), "pq_screen_select adaptive plain"))
    records["rerank_select"].update(
        adaptive_max_abs_err=max_err(rv, wrv),
        adaptive_ms=timer(lambda: kdf.rerank_select(db, cand, lv, qf, k=k),
                          "rerank_select adaptive"),
        adaptive_plain_ms=timer(lambda: ref.rerank_select_ref(
            db, cand, lv, qf, k), "rerank_select adaptive plain"))
    print("[paper] head geometry adaptive probe " + json.dumps(out),
          flush=True)
    del db, theta, ivf, pq, runs
    torch.cuda.empty_cache()
    return out


def paper_phase(torch, seed: int, records: list[dict], smi: str) -> dict:
    """The ``[paper]`` phase: each configuration of ``PAPER_RUNS``, then the
    fused adaptive probe at the LM head's geometry. Adds each kernel's
    launches on these paths (``launches_paper``: the paper's main path at
    every configuration; ``launches_adaptive``: the four adaptive probes at
    the head's geometry) and the tagged checks and times to ``records``."""
    by_name = {r["name"]: r for r in records}
    timer = Timer(torch, ITERS)
    out = {}
    for name, b in PAPER_RUNS:
        out[name] = paper_one(torch, seed, name, b, timer, by_name, smi)
    out["head_adaptive"] = head_adaptive(torch, seed, timer, by_name, smi)
    for rec in records:
        rec["launches_paper"] = sum(out[name]["launches"].get(rec["name"], 0)
                                    for name, _ in PAPER_RUNS)
        rec["launches_adaptive"] = out["head_adaptive"]["launches"].get(
            rec["name"], 0)
    print(f"[timer] [paper] calls whose host issue outlasted the hold: "
          f"{json.dumps(timer.uncovered)}", flush=True)
    del timer
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- families
# the other trunk families at full width, each cut in depth only (its
# n_layers), to fit the phase's time and the card (mamba2-780m ran its 48
# layers until the [sharded] phase's trunk went to full depth)
FAMILY_CUTS = {
    "mamba2-780m": 24,
    "recurrentgemma-9b": 8,  # two (rec, rec, attn) periods + (rec, rec)
    "qwen3-moe-30b-a3b": 2,
    "paligemma-3b": 2,
    "hubert-xlarge": 2,
}
FAMILY_TRAIN_STEPS = {"qwen3-moe-30b-a3b": 3, "paligemma-3b": 2,
                      "hubert-xlarge": 2}
FAMILY_RING = 2048  # flash_decode's ring at the new head geometries
FAMILY_OPT = dict(lr=1e-4, warmup_steps=2, total_steps=TRAIN_STEPS)


def family_cfg(name: str):
    """The configuration ``name`` as the phase runs it (IVF head, cut in
    depth by ``FAMILY_CUTS``), with its cut printed on a line of its own."""
    from repro_torch.configs import get

    full = get(name)
    depth = FAMILY_CUTS[name]
    cfg = full.scaled(head_mips="ivf")
    if depth is None:
        print(f"[families] cut {name}: none ({full.n_layers} layers, "
              f"d {full.d_model}, vocab {full.vocab})", flush=True)
        return cfg
    print(f"[families] cut {name}: n_layers {full.n_layers} -> {depth} "
          f"(width unchanged: d {full.d_model}, vocab {full.vocab})",
          flush=True)
    return cfg.scaled(n_layers=depth)


def tag_record(rec: dict, tag: str, err: float, timed, plain_ms: float,
               lib_ms, nb: float, flops: float, peak: float,
               label: str = "[families]", shown: str | None = None,
               **extra) -> None:
    """A kernel's check and times at another path's shape, as keys
    ``<tag>_*`` of its record (the record's own keys stay the main path's),
    printed on a ``<label> kernel`` line."""
    ms, host = timed
    b_ms, b_by = bound_ms(nb, flops, peak)
    rec.update({f"{tag}_max_abs_err": err, f"{tag}_ms": ms,
                f"{tag}_host_us": host, f"{tag}_plain_ms": plain_ms,
                f"{tag}_bound_ms": b_ms, f"{tag}_bound_by": b_by,
                f"{tag}_library_ms": lib_ms},
               **{f"{tag}_{k}": v for k, v in extra.items()})
    print(f"{label} kernel {shown or rec['name']} {tag}: ok "
          f"max_abs_err={err:.3g} "
          f"ms={ms:.4f} host_us={host:.1f} plain_ms={plain_ms:.4f} "
          f"bound_ms={b_ms:.4f} ({b_by}) library_ms={lib_ms} "
          + json.dumps(extra), flush=True)


def estimator_check(torch, gen, timer: Timer, rec: dict, tag: str, n: int,
                    d: int, t: int, k: int, label: str = "[families]"):
    """``fused_estimator`` at (t tokens, m = 2k slots, an n x d table)
    against its plain version (rtol 1e-5, as :func:`kernel_checks`), its
    check and times as keys ``<tag>_*`` of ``rec``. Returns (emb, ids, h,
    log_w, y, log_z) for a backward check on the same inputs."""
    from repro_torch.kernels import fused_estimator as kfe
    from repro_torch.kernels import ref

    emb, ids, h, log_w = estimator_inputs(torch, gen, n, d, t, k)
    args = (emb, ids, h, log_w)
    got_z, got_v, got_y = kfe.fused_estimator(*args, return_y=True)
    want_z, want_v, want_y = ref.fused_estimator_ref(*args, return_y=True)
    torch.cuda.synchronize()
    live = torch.isfinite(log_w)
    check(close(torch, got_z, want_z) and close(torch, got_v, want_v)
          and close(torch, got_y[live], want_y[live]),
          f"fused_estimator at {tag} ({t} x {2 * k}, d {d}) disagrees with "
          f"its plain version")
    err = max((got_z - want_z)[live.any(1)].abs().max().item(),
              (got_v - want_v)[live.any(1)].abs().max().item())
    rows_live = int(torch.unique(ids[live]).numel())
    tag_record(rec, tag, err,
               timer.both(lambda: kfe.fused_estimator(*args, return_y=True),
                          f"fused_estimator {tag}"),
               timer(lambda: ref.fused_estimator_ref(*args, return_y=True),
                     f"fused_estimator {tag} plain"), None,
               *kcost().fused_estimator(
                   *args, return_y=True, rows=rows_live,
                   n_live=int(live.sum().item()))[:2], FP32_FLOPS, label=label,
               d=d, k=k, tokens=t, **kfe.route(*emb.shape, *ids.shape))
    return emb, ids, h, log_w, got_y, want_z


def family_kernel_checks(torch, records: list[dict]) -> None:
    """The kernels at the geometries the new families give them, each held
    against its plain version as :func:`kernel_checks` holds it:
    ``flash_decode`` at recurrentgemma's heads (16 query heads on one KV
    head of 256) and qwen3-moe's (32 on 4, 128) over a 2,048-position ring,
    two sequences at the full ring; ``ivf_gather_score`` and
    ``ivf_screen_select`` at mamba2-780m's head (d 1,536, its IVF geometry
    and k); ``fused_estimator`` and its backward at mamba2-780m's training
    chunk (256 tokens of k + l candidates over the 50,280 x 1,536 table)."""
    from repro_torch.configs import get
    from repro_torch.kernels import decode_fused as kdf
    from repro_torch.kernels import fused_estimator as kfe
    from repro_torch.kernels import ivf_gather_score as kigs
    from repro_torch.kernels import ref
    from repro_torch.serve.server import ServeConfig

    by_name = {r["name"]: r for r in records}
    timer = Timer(torch, ITERS)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2323)
    scfg = ServeConfig(batch_slots=SLOTS, max_seq=MAX_SEQ,
                       max_new_tokens=NEW_TOKENS)
    for name, tag in (("recurrentgemma-9b", "griffin"),
                      ("qwen3-moe-30b-a3b", "qwen3")):
        g = geometry(get(name), scfg)
        lengths = torch.randint(1, FAMILY_RING + 1, (g.slots,), generator=gen,
                                device="cuda", dtype=torch.int32)
        lengths[0] = lengths[1] = FAMILY_RING
        lengths[-1] = 1
        rec = flash_decode_case(torch, gen, g, timer, FAMILY_RING, lengths)
        tag_record(by_name["flash_decode"], tag, rec["err"], rec["timed"],
                   rec["plain_ms"], rec["lib_ms"], rec["nb"], rec["flops"],
                   BF16_FLOPS, positions=FAMILY_RING, heads=[g.hq, g.hkv, g.hd])

    g = geometry(get("mamba2-780m"), scfg)
    print(f"[families] mamba2-780m head geometry "
          f"{json.dumps(dataclasses.asdict(g))}", flush=True)
    b = g.slots
    mv = int_valued(torch, gen, (g.n_c, g.cap, g.d))
    fill = torch.rand((g.n_c, g.cap), generator=gen, device="cuda")
    mids = torch.randint(0, g.n, (g.n_c, g.cap), generator=gen,
                         device="cuda", dtype=torch.int32)
    mids = torch.where(fill < g.n / (g.n_c * g.cap), mids,
                       torch.full_like(mids, -1))
    probe = torch.stack([torch.randperm(g.n_c, generator=gen,
                                        device="cuda")[: g.n_probe]
                         for _ in range(b)]).int()
    qv = int_valued(torch, gen, (b, g.d))
    gs, gi = kigs.ivf_gather_score(mv, mids, probe, qv)
    want_s, want_i = ref.ivf_gather_score_ref(mv, mids, probe, qv)
    torch.cuda.synchronize()
    check(torch.equal(gs, want_s) and torch.equal(gi, want_i),
          "ivf_gather_score at d 1536 disagrees with its plain version")
    uniq = torch.unique(probe)
    tag_record(by_name["ivf_gather_score"], "mamba2", 0.0,
               timer.both(lambda: kigs.ivf_gather_score(mv, mids, probe, qv),
                          "ivf_gather_score mamba2"),
               timer(lambda: ref.ivf_gather_score_ref(mv, mids, probe, qv),
                     "ivf_gather_score mamba2 plain"), None,
               *kcost().ivf_gather_score(mv, mids, probe, qv,
                                         n_unique=uniq.numel())[:2],
               FP32_FLOPS,
               d=g.d, queries=b)
    o_ids = torch.randint(0, g.n, (g.o_cap,), generator=gen, device="cuda",
                          dtype=torch.int32)
    o_ids[torch.rand((g.o_cap,), generator=gen, device="cuda") < 0.5] = -1
    o_sc = int_valued(torch, gen, (b, g.o_cap), -200, 200)
    sargs = (mv, mids, o_sc, o_ids, probe, qv)
    got_v, got_i = kdf.ivf_screen_select(*sargs, k=g.k)
    want_v, want_i = ref.ivf_screen_select_ref(*sargs, g.k)
    # the fused screen equals the unfused kernel probe + top-k bit for bit
    pool_s = torch.cat([gs.reshape(b, -1), o_sc], 1)
    pool_i = torch.cat([gi.reshape(b, -1), o_ids[None].expand(b, -1)], 1)
    pool_s = torch.where(pool_i >= 0, pool_s, float("-inf"))
    v3, i3 = ref.topk_select_ref(pool_s, pool_i, g.k)
    torch.cuda.synchronize()
    check(torch.equal(got_v, want_v) and torch.equal(got_i, want_i),
          "ivf_screen_select at d 1536 disagrees with its plain version")
    check(torch.equal(v3, got_v) and torch.equal(i3, got_i),
          "ivf_screen_select != ivf_gather_score + top-k at d 1536")
    live_rows = int((mids[probe.long()] >= 0).sum().item())
    live_uniq = int((mids[uniq.long()] >= 0).sum().item())
    tag_record(by_name["ivf_screen_select"], "mamba2", 0.0,
               timer.both(lambda: kdf.ivf_screen_select(*sargs, k=g.k),
                          "ivf_screen_select mamba2"),
               timer(lambda: ref.ivf_screen_select_ref(*sargs, g.k),
                     "ivf_screen_select mamba2 plain"), None,
               *kcost().ivf_screen_select(
                   *sargs, g.k, n_unique=uniq.numel(), live_unique=live_uniq,
                   live_rows=live_rows)[:2], FP32_FLOPS, d=g.d, k=g.k,
               pool=g.n_probe * g.cap + g.o_cap)
    del mv, mids, sargs, pool_s, pool_i

    # fused_estimator and its backward at mamba2's training chunk
    t, k = HEAD_CHUNK, g.k
    m = 2 * k
    emb, ids, h, log_w, got_y, want_z = estimator_check(
        torch, gen, timer, by_name["fused_estimator"], "mamba2", g.n, g.d, t,
        k)
    gvec = 0.5 + torch.rand((t,), generator=gen, device="cuda")
    live_tok = torch.ones(t, dtype=torch.bool, device="cuda")
    live_tok[7] = False
    bargs = (emb, ids[live_tok], h[live_tok], log_w[live_tok],
             want_z[live_tok], gvec[live_tok])
    yb = got_y[live_tok]
    got_d, got_p = kfe.fused_estimator_bwd(*bargs, y=yb)
    want_d, want_p = ref.fused_estimator_bwd_ref(*bargs)
    torch.cuda.synchronize()
    check(close(torch, got_d, want_d) and close(torch, got_p, want_p)
          and close(torch, got_p[:, :k], want_p[:, :k]),
          "fused_estimator_bwd at d 1536 disagrees with its plain version")
    err = max((got_d - want_d).abs().max().item(),
              (got_p - want_p).abs().max().item())
    tag_record(by_name["fused_estimator_bwd"], "mamba2", err,
               timer.both(lambda: kfe.fused_estimator_bwd(*bargs, y=yb),
                          "fused_estimator_bwd mamba2"),
               timer(lambda: ref.fused_estimator_bwd_ref(*bargs, y=yb),
                     "fused_estimator_bwd mamba2 plain"), None,
               *kcost().fused_estimator_bwd(
                   *bargs, y=yb,
                   n_live=int(torch.isfinite(bargs[3]).sum().item()))[:2],
               FP32_FLOPS, d=g.d, k=k, tokens=int(live_tok.sum().item()))
    print(f"[timer] [families] calls whose host issue outlasted the hold: "
          f"{json.dumps(timer.uncovered)}", flush=True)
    del timer, emb, bargs
    torch.cuda.empty_cache()


def family_serve(torch, name: str, label: str, cfg, params, prompts,
                 counts: dict, index=None, tag: str = "[families]",
                 **scfg_kw):
    """One serving run of ``prompts`` (8 requests x 32 new tokens on 4
    slots of a 512-position cache): launch counts at 0 just before it, read
    just after and added to ``counts``; every request must get all its
    tokens, ids in range. Lines start with ``tag``. Returns (server,
    results, report, the run's launch counts)."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import report
    from repro_torch.serve.server import ServeConfig, Server

    kw = dict(batch_slots=SLOTS, max_seq=MAX_SEQ, max_new_tokens=NEW_TOKENS,
              decode_window=WINDOW)
    kw.update(scfg_kw)
    srv = Server(cfg, params, ServeConfig(**kw), precision_policy="bf16",
                 device="cuda", index=index)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    res = srv.run(prompts)
    torch.cuda.synchronize()
    run = ops.launch_counts()
    for k, n in run.items():
        counts[k] = counts.get(k, 0) + n
    rep = report(res, srv)
    print(f"{tag} {name} serve {label} {json.dumps(rep)}", flush=True)
    print(f"{tag} {name} serve {label} launches {json.dumps(run)}",
          flush=True)
    check(len(res) == len(prompts)
          and all(r.status == "ok" and len(r.tokens) == kw["max_new_tokens"]
                  for r in res), f"{name} {label}: a request lost tokens")
    check(all(0 <= tok < cfg.vocab for r in res for tok in r.tokens),
          f"{name} {label}: a token id out of range")
    return srv, res, rep, run


def family_train(torch, name: str, cfg, seed: int, steps: int, counts: dict,
                 encode: bool = False) -> dict:
    """``steps`` training steps of ``cfg`` (batch 2 x 1,024 positions, the
    synthetic stream with its frontend's inputs, bf16 compute, fp32 masters,
    the IVF head index built over a copy of the output embedding, or the
    exact head where the config sets it) through
    ``launch.steps.make_train_step``, the trainer's step function, without
    the trainer's checkpoints. Counts at 0 before the steps, read after,
    added to ``counts``. Checks finite losses and aux; for an MoE, prints
    aux, the dropped-assignment share and the experts' load; with
    ``encode``, one ``make_encode_step`` call on the first batch."""
    import numpy as np

    from repro_torch.data.synthetic import DataConfig, SyntheticStream
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import moe
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import OptConfig

    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg, "bf16", device="cuda")
    params = model.init(seed)
    opt = adamw.init(params)
    index = None
    if model.head_uses_index:
        index = model.make_head_index(
            params, db=model.head_index_db(params).clone())
    step_fn = steps_lib.make_train_step(model, steps_lib.TrainConfig(
        opt=OptConfig(**FAMILY_OPT), precision="bf16"))
    data = SyntheticStream(cfg, DataConfig(batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                                           seed=seed))
    batches = [{k: torch.from_numpy(np.asarray(v)).cuda()
                for k, v in next(data).items()} for _ in range(steps)]
    if cfg.is_moe:
        moe.TRACE = []
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    log, times = [], []
    try:
        for i, batch in enumerate(batches):
            t0 = time.perf_counter()
            params, opt, m = step_fn(params, opt, batch, (seed, i), index)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            log.append({k: float(v) for k, v in m.items()})
        run = ops.launch_counts()
        trace = moe.TRACE
    finally:
        moe.TRACE = None
    for k, n in run.items():
        counts[k] = counts.get(k, 0) + n
    for i, e in enumerate(log):
        print(f"[families] {name} train step {i} loss={e['loss']:.5f} "
              f"nll={e['nll']:.5f} aux={e['aux']:.5f} "
              f"grad_norm={e['grad_norm']:.4f} dt={times[i] * 1e3:.1f} ms",
              flush=True)
    tokens = batches[0]["labels"].numel()
    stats = {"steps": steps, "label_tokens_per_step": tokens,
             "step_ms_median": 1e3 * statistics.median(times[1:] or times),
             "first_step_ms": 1e3 * times[0],
             "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
             "index_mb": index.memory_bytes() / 1e6 if index else 0.0}
    stats["tokens_per_s"] = tokens / (stats["step_ms_median"] / 1e3)
    check(all(math.isfinite(e["loss"]) and math.isfinite(e["aux"])
              for e in log), f"{name} train: a non-finite loss or aux")
    if cfg.is_moe:
        dropped = sum(int(r["dropped"]) for r in trace)
        assigned = sum(r["assigned"] for r in trace)
        load = torch.stack([r["load"] for r in trace]).sum(0).float()
        stats.update(
            aux=[e["aux"] for e in log], dropped_share=dropped / assigned,
            expert_load={"min": int(load.min()), "max": int(load.max()),
                         "mean": float(load.mean()),
                         "max_over_mean": float(load.max() / load.mean())})
        check(all(e["aux"] > 0 for e in log), f"{name} train: aux is 0")
    if encode:
        enc = steps_lib.make_encode_step(model)
        logits = enc(model.compute_params(params), batches[0])
        torch.cuda.synchronize()
        stats["encode_logits_shape"] = list(logits.shape)
        check(tuple(logits.shape) == (TRAIN_BATCH, TRAIN_SEQ, cfg.vocab)
              and bool(torch.isfinite(logits).all()),
              f"{name} encode: logits of the wrong shape or not finite")
    print(f"[families] {name} train {json.dumps(stats)}", flush=True)
    print(f"[families] {name} train launches {json.dumps(run)}", flush=True)
    del params, opt, index, batches, model
    torch.cuda.empty_cache()
    return stats


def family_prompts(cfg, seed: int) -> list:
    import numpy as np

    rng = np.random.default_rng(seed)
    return [list(rng.integers(0, cfg.vocab, size=rng.integers(4, 13)))
            for _ in range(REQUESTS)]


def families_phase(torch, seed: int, records: list[dict], smi: str) -> dict:
    """The ``[families]`` phase: the kernels at the new geometries
    (:func:`family_kernel_checks`), then the other trunk families at full
    width through the entry points a user calls (``Model``, ``Server``,
    ``Trainer``, the train and encode steps):

    * mamba2-780m, 24 of 48 layers: fused T=8 ≡ unfused T=1 tokens on one
      index; 6 training steps through ``Trainer`` (refresh and
      checkpoint every 3) and the resume from step 3 within rtol 1e-3;
    * recurrentgemma-9b, 8 layers: the unfused head (its 8-probe pool of
      28,224 slots is past the fused screens' 16,384, so the config asks
      for the unfused probe); paged at block_len 64 ≡ dense;
    * qwen3-moe-30b-a3b, 2 layers: unfused serving twice, bitwise equal
      tokens; 3 training steps with aux, drops and expert load;
    * paligemma-3b and hubert-xlarge, 2 layers: 2 training steps each (256
      patch embeddings; frames), and one encode step for hubert.

    Adds each kernel's launches on these paths (``launches_families``) to
    ``records``."""
    import gc

    from repro_torch.configs import get
    from repro_torch.kernels.decode_fused import SCREEN_POOL_MAX
    from repro_torch.models import moe
    from repro_torch.models.model import Model
    from repro_torch.serve.server import ServeConfig

    out: dict = {"card": smi}
    counts: dict = {}
    t0 = time.perf_counter()
    family_kernel_checks(torch, records)
    print(f"[families] kernel checks done in {time.perf_counter() - t0:.1f} "
          "s", flush=True)

    def begin(name):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        return time.perf_counter(), family_cfg(name)

    def end(name, t_start, stats):
        stats["phase_s"] = time.perf_counter() - t_start
        stats["peak_mem_gb"] = max(stats.get("peak_mem_gb", 0.0),
                                   torch.cuda.max_memory_allocated() / 1e9)
        print(f"[families] {name} summary ({smi}) {json.dumps(stats)}",
              flush=True)
        out[name] = stats

    def serve_stats(rep):
        return {k: rep[k] for k in ("tokens_per_s", "ttft_p50_ms",
                                    "itl_p50_ms", "ok_rate", "index_mb",
                                    "cache_mb")}

    # ---- mamba2-780m: full width, cut in depth, served and trained
    name = "mamba2-780m"
    t_start, cfg = begin(name)
    params = Model(cfg, "bf16", device="cuda").init(seed)
    prompts = family_prompts(cfg, seed)
    srv, res_f, rep_f, run_f = family_serve(
        torch, name, f"fused T={WINDOW}", cfg.scaled(head_fused_decode=True),
        params, prompts, counts)
    _, res_u, rep_u, run_u = family_serve(
        torch, name, "unfused T=1", cfg, params, prompts, counts,
        index=srv.index, decode_window=1)
    same = sum(a.tokens == b.tokens for a, b in zip(res_f, res_u))
    print(f"[families] {name} fused T={WINDOW} == unfused T=1 tokens: "
          f"{same}/{len(prompts)} requests", flush=True)
    check(same == len(prompts), f"{name}: fused T=8 and unfused T=1 served "
          "different tokens")
    for k in ("ivf_screen_select", "tail_gather_argmax"):
        check(run_f[k] > 0, f"{name} fused serve never launched {k}")
    check(run_u["ivf_gather_score"] > 0,
          f"{name} unfused serve never launched ivf_gather_score")
    stats = {"serve_fused": serve_stats(rep_f),
             "serve_unfused": serve_stats(rep_u)}
    del srv, params
    gc.collect()
    torch.cuda.empty_cache()
    run_counts, tstats = train(torch, seed, cfg, "ivf",
                               label=f"[families] {name}")
    for k, n in run_counts.items():
        counts[k] = counts.get(k, 0) + n
    stats["train"] = tstats
    end(name, t_start, stats)

    # ---- recurrentgemma-9b: unfused head by config, paged == dense
    name = "recurrentgemma-9b"
    t_start, cfg = begin(name)
    g = geometry(cfg, ServeConfig(batch_slots=SLOTS, max_seq=MAX_SEQ,
                                  max_new_tokens=NEW_TOKENS))
    pool = g.n_probe * g.cap + g.o_cap
    print(f"[families] {name} head pool {pool} slots (n_probe {g.n_probe} x "
          f"cap {g.cap} + overflow {g.o_cap}) > SCREEN_POOL_MAX "
          f"{SCREEN_POOL_MAX}: served with the unfused probe", flush=True)
    check(pool > SCREEN_POOL_MAX and not cfg.head_fused_decode,
          f"{name}: the unfused head is not the config's choice")
    params = Model(cfg, "bf16", device="cuda").init(seed)
    prompts = family_prompts(cfg, seed)
    srv, res_d, rep_d, run_d = family_serve(torch, name, "dense", cfg,
                                            params, prompts, counts)
    _, res_p, rep_p, run_p = family_serve(torch, name, "paged block_len=64",
                                          cfg, params, prompts, counts,
                                          index=srv.index, block_len=64)
    same = sum(a.tokens == b.tokens for a, b in zip(res_d, res_p))
    print(f"[families] {name} paged block_len=64 == dense tokens: "
          f"{same}/{len(prompts)} requests", flush=True)
    check(same == len(prompts), f"{name}: paged and dense served different "
          "tokens")
    check(run_d["flash_decode"] > 0 and run_p["flash_decode_paged"] > 0
          and run_d["ivf_gather_score"] > 0,
          f"{name}: a kernel of its path was never launched")
    stats = {"serve_dense": serve_stats(rep_d),
             "serve_paged": serve_stats(rep_p), "head_pool_slots": pool}
    del srv, params
    end(name, t_start, stats)

    # ---- qwen3-moe-30b-a3b: repeatable serving, training with aux
    name = "qwen3-moe-30b-a3b"
    t_start, cfg = begin(name)
    params = Model(cfg, "bf16", device="cuda").init(seed)
    prompts = family_prompts(cfg, seed)
    moe.TRACE = []
    try:
        srv, res_a, rep_a, run_a = family_serve(torch, name, "unfused run 1",
                                                cfg, params, prompts, counts)
        trace = moe.TRACE
    finally:
        moe.TRACE = None
    _, res_b, _, _ = family_serve(torch, name, "unfused run 2", cfg, params,
                                  prompts, counts, index=srv.index)
    same = sum(a.tokens == b.tokens for a, b in zip(res_a, res_b))
    print(f"[families] {name} two decode runs, bitwise equal tokens: "
          f"{same}/{len(prompts)} requests", flush=True)
    check(same == len(prompts), f"{name}: two runs served different tokens")
    check(run_a["flash_decode"] > 0 and run_a["ivf_gather_score"] > 0,
          f"{name}: a kernel of its serving path was never launched")
    decode_t = SLOTS * cfg.experts_per_token
    pre = [r for r in trace if r["assigned"] != decode_t]
    dec = [r for r in trace if r["assigned"] == decode_t]
    share = {k: (sum(int(r["dropped"]) for r in v)
                 / max(sum(r["assigned"] for r in v), 1))
             for k, v in (("prefill", pre), ("decode", dec))}
    print(f"[families] {name} dropped-assignment share while serving "
          f"(pad tokens take capacity): {json.dumps(share)}", flush=True)
    stats = {"serve": serve_stats(rep_a), "serve_dropped_share": share}
    del srv, params, trace
    stats["train"] = family_train(torch, name, cfg, seed,
                                  FAMILY_TRAIN_STEPS[name], counts)
    end(name, t_start, stats)

    # ---- paligemma-3b and hubert-xlarge: training (and hubert's encode)
    for name in ("paligemma-3b", "hubert-xlarge"):
        t_start, cfg = begin(name)
        stats = {"train": family_train(torch, name, cfg, seed,
                                       FAMILY_TRAIN_STEPS[name], counts,
                                       encode=cfg.encoder_only)}
        end(name, t_start, stats)

    for rec in records:
        rec["launches_families"] = counts.get(rec["name"], 0)
    print(f"[families] launches {json.dumps(counts)}", flush=True)
    return out


# ---------------------------------------------------------------- index side
# the index side at tinyllama-1.1b's full width (22 layers, d 2048, vocab
# 32,000, seed-drawn weights): the LSH head served and trained, structured
# search and deep-kNN on the trunk, the LSH sampler against Algorithm 3 on
# the paper's 160,000-row ImageNet table, the anisotropic IVF-PQ build
INDEX_TAG = "[index-side]"
INDEX_TRAIN_STEPS, INDEX_TRAIN_EVERY = 3, 2  # a resume from step 2
INDEX_TRAIN_LAYERS = 8  # the LSH head's training run, of tinyllama's 22
BEAMS = dict(n_beams=4, horizon=8, expand_k=64, logz="amortized")
BEAM_PROMPT = 4  # prompt tokens of the structured search
DKNN = dict(classes=4, train=256, cal=64, test=64, seq=16, k=8)
LSH_SAMPLER = dict(tables=32, bits=6, queries=64)
ANISO_ETA = 4.0  # the anisotropic build's eta, beside the standard one (0)


def index_gather_check(torch, timer: Timer, rec: dict, tag: str, index,
                       q) -> None:
    """``ivf_gather_score`` over an IVF index's members at its own probe of
    queries ``q`` against its plain version (ids equal, scores as
    :func:`values_close` ``scaled``), its check and times as keys
    ``<tag>_*`` of ``rec``."""
    from repro_torch.core import mips
    from repro_torch.kernels import ivf_gather_score as kigs
    from repro_torch.kernels import ref

    st = index.state
    n_probe = min(index.config.n_probe, st.n_clusters)
    qf = q.float()
    _, probe = mips.top_k(qf @ st.centroids.T, n_probe)
    args = (st.member_vecs, st.member_ids, probe, qf)
    gs, gi = kigs.ivf_gather_score(*args)
    ws, wi = ref.ivf_gather_score_ref(*args)
    torch.cuda.synchronize()
    check(torch.equal(gi, wi) and values_close(torch, gs, ws, scaled=True),
          f"ivf_gather_score at {tag} disagrees with its plain version: "
          f"{max_err(gs, ws)}")
    b, d = qf.shape
    uniq = torch.unique(probe)
    tag_record(rec, tag, max_err(gs, ws),
               timer.both(lambda: kigs.ivf_gather_score(*args),
                          f"ivf_gather_score {tag}"),
               timer(lambda: ref.ivf_gather_score_ref(*args),
                     f"ivf_gather_score {tag} plain"), None,
               *kcost().ivf_gather_score(*args, n_unique=uniq.numel())[:2],
               FP32_FLOPS, label=INDEX_TAG,
               d=d, queries=b, n_probe=n_probe, clusters=st.n_clusters,
               cap=st.cap)


def index_kernel_checks(torch, cfg, records: list[dict]) -> None:
    """The kernels at the geometries this phase gives them and no earlier
    phase checks, each against its plain version: ``fused_estimator`` at
    structured search's amortized log Z (the beams' queries, expand_k + l
    slots over the head's table) and at Algorithm 3 on the ImageNet bench
    table (64 queries, k + l slots, d 256); ``ivf_gather_score`` over
    deep-kNN's per-tap IVF index (the training reps' count, d_model, its
    probe of the calibration batch). Algorithm 3's IVF probe is checked
    where its index is built (:func:`index_lsh_sampler`)."""
    from repro_torch.configs.paper_loglinear import IMAGENET_BENCH as pc
    from repro_torch.core import mips
    from repro_torch.core.gumbel import default_kl
    from repro_torch.launch.workloads import index_cfg
    from repro_torch.workloads import dknn

    by_name = {r["name"]: r for r in records}
    timer = Timer(torch, ITERS)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2424)
    rec = by_name["fused_estimator"]
    estimator_check(torch, gen, timer, rec, "index_structured", cfg.vocab,
                    cfg.d_model, BEAMS["n_beams"], BEAMS["expand_k"],
                    label=INDEX_TAG)
    torch.cuda.empty_cache()
    k = default_kl(pc.n, pc.delta)
    estimator_check(torch, gen, timer, rec, "index_alg3", pc.n, pc.d,
                    LSH_SAMPLER["queries"], k, label=INDEX_TAG)
    torch.cuda.empty_cache()
    reps = dknn.normalize_reps(torch.randn(
        (DKNN["train"] + DKNN["cal"], cfg.d_model), generator=gen,
        device="cuda"))
    index = mips.build_index(index_cfg("ivf"), reps[:DKNN["train"]])
    index_gather_check(torch, timer, by_name["ivf_gather_score"],
                       "index_dknn", index, reps[DKNN["train"]:])
    print(f"[timer] {INDEX_TAG} calls whose host issue outlasted the hold: "
          f"{json.dumps(timer.uncovered)}", flush=True)
    del timer, index, reps
    torch.cuda.empty_cache()


def index_lsh_serve(torch, cfg, params, prompts, counts: dict, smi: str
                    ) -> dict:
    """The LSH head (8 tables x 10 bits, the head's bucket sizing) served
    fused at T=8 and unfused at T=1 over one index: same tokens."""
    lcfg = cfg.scaled(head_mips="lsh")
    t0 = time.perf_counter()
    srv, res_f, rep_f, run_f = family_serve(
        torch, "lsh head", f"fused T={WINDOW}",
        lcfg.scaled(head_fused_decode=True), params, prompts, counts,
        tag=INDEX_TAG)
    _, res_u, rep_u, run_u = family_serve(
        torch, "lsh head", "unfused T=1", lcfg, params, prompts, counts,
        index=srv.index, decode_window=1, tag=INDEX_TAG)
    same = sum(a.tokens == b.tokens for a, b in zip(res_f, res_u))
    idx = srv.index
    out = {"fused_tokens_per_s": rep_f["tokens_per_s"],
           "fused_itl_p50_ms": rep_f["itl_p50_ms"],
           "unfused_tokens_per_s": rep_u["tokens_per_s"],
           "unfused_itl_p50_ms": rep_u["itl_p50_ms"],
           "ok_rate": rep_f["ok_rate"], "index_mb": rep_f["index_mb"],
           "tables": idx.n_tables, "bits": idx.n_bits,
           "bucket_cap": idx.bucket_cap, "dropped_count": idx.dropped_count,
           "seconds": time.perf_counter() - t0}
    print(f"{INDEX_TAG} lsh head fused T={WINDOW} == unfused T=1 tokens: "
          f"{same}/{len(prompts)} requests", flush=True)
    print(f"{INDEX_TAG} lsh head serve ({smi}) {json.dumps(out)}",
          flush=True)
    check(same == len(prompts), "lsh head: fused T=8 and unfused T=1 served "
          "different tokens")
    check(run_f["flash_decode"] > 0 and run_f["tail_gather_argmax"] > 0
          and run_u["flash_decode"] > 0,
          "lsh head: a kernel of its serving path was never launched")
    return out


def index_lsh_train(torch, seed: int, cfg, counts: dict, smi: str) -> dict:
    """The LSH head trained through ``Trainer`` at ``INDEX_TRAIN_LAYERS``
    layers (the cut printed): 3 steps of 2 x 1,024 tokens, refresh and
    checkpoint every 2, then a resume from the step-2
    checkpoint (the LSH index is rebuilt from the saved rows alone): its
    loss must equal the uninterrupted run's bit for bit."""
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import TrainConfig
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train.trainer import RunConfig, Trainer

    tcfg = cfg.scaled(head_mips="lsh", n_layers=INDEX_TRAIN_LAYERS)
    print(f"{INDEX_TAG} cut lsh head train: n_layers {cfg.n_layers} -> "
          f"{INDEX_TRAIN_LAYERS} (width unchanged: d {cfg.d_model}, vocab "
          f"{cfg.vocab}; the head is what it checks)", flush=True)
    run = RunConfig(num_steps=INDEX_TRAIN_STEPS, ckpt_every=INDEX_TRAIN_EVERY,
                    log_every=1, keep_ckpts=2, seed=seed, batch=TRAIN_BATCH,
                    seq=TRAIN_SEQ, index_refresh_every=INDEX_TRAIN_EVERY,
                    train=TrainConfig(opt=OptConfig(
                        lr=1e-4, warmup_steps=2,
                        total_steps=INDEX_TRAIN_STEPS), precision="bf16"))
    workdir = ROOT / "build" / "chip_smoke_index"
    shutil.rmtree(workdir, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    tr = Trainer(tcfg, run, str(workdir), device="cuda")
    res = tr.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    run_counts = ops.launch_counts()
    for k, n in run_counts.items():
        counts[k] = counts.get(k, 0) + n
    log = tr.metrics_log
    for e in log:
        print(f"{INDEX_TAG} lsh head train step {e['step']} "
              f"loss={e['loss']:.5f} nll={e['nll']:.5f} "
              f"dt={e['dt'] * 1e3:.1f} ms", flush=True)
    losses = [e["loss"] for e in log]
    stats = {"steps": len(log),
             "step_ms_median": 1e3 * statistics.median(
                 e["dt"] for e in log[1:]),
             "run_wall_s": wall, "index_refreshes": tr.index_refreshes,
             "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
             "index_mb": tr.head_index.memory_bytes() / 1e6}
    print(f"{INDEX_TAG} lsh head train launches {json.dumps(run_counts)}",
          flush=True)
    check(res["status"] == "done" and len(losses) == INDEX_TRAIN_STEPS,
          "lsh train: the run did not take its steps")
    check(all(math.isfinite(x) for x in losses), "lsh train: a non-finite "
          "loss")
    check(tr.index_refreshes == INDEX_TRAIN_STEPS // INDEX_TRAIN_EVERY,
          "lsh train: the head index was not refreshed")
    for name in ("fused_estimator", "fused_estimator_bwd"):
        check(run_counts[name] > 0, f"lsh train never launched {name}")
    del tr
    torch.cuda.empty_cache()
    shutil.rmtree(workdir / f"ckpt_{INDEX_TRAIN_STEPS:08d}")
    tr2 = Trainer(tcfg, run, str(workdir), device="cuda")
    tr2.train()
    torch.cuda.synchronize()
    resumed = [e["loss"] for e in tr2.metrics_log]
    want = losses[INDEX_TRAIN_EVERY:]
    stats["resume_bitwise"] = resumed == want
    print(f"{INDEX_TAG} lsh head resume from step {INDEX_TRAIN_EVERY}: "
          f"losses {resumed} vs {want}, bitwise {resumed == want}",
          flush=True)
    print(f"{INDEX_TAG} lsh head train ({smi}) {json.dumps(stats)}",
          flush=True)
    check(resumed == want, "lsh train: the resumed run is not bitwise the "
          "uninterrupted one")
    del tr2
    shutil.rmtree(workdir, ignore_errors=True)
    torch.cuda.empty_cache()
    return stats


def index_structured(torch, seed: int, cfg, params, counts: dict,
                     smi: str) -> dict:
    """Structured search at full width through the head's IVF index with
    the amortized per-step log Z: stochastic beam search twice (bitwise
    equal, distinct beams) and MAP against greedy decoding (beam width 1,
    the same node keys and log Z draws)."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.models.model import Model
    from repro_torch.workloads import structured

    model = Model(cfg.scaled(head_mips="ivf"), "bf16", device="cuda")
    index = model.make_head_index(params)
    prompt = np.random.default_rng(seed).integers(0, cfg.vocab,
                                                  size=BEAM_PROMPT)
    out: dict = {}

    def run(tag, **kw):
        bcfg = structured.BeamConfig(**{**BEAMS, **kw})
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        beams = structured.search(model, params, prompt, seed, bcfg, index)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        run_counts = ops.launch_counts()
        for k, n in run_counts.items():
            counts[k] = counts.get(k, 0) + n
        rep = {"seconds": dt, "ok_rate": float(beams.ok_rate),
               "tokens": beams.tokens.tolist(),
               "logp": beams.logp.tolist(),
               "exact": beams.exact.tolist()}
        print(f"{INDEX_TAG} structured {tag} {json.dumps(rep)}", flush=True)
        print(f"{INDEX_TAG} structured {tag} launches "
              f"{json.dumps(run_counts)}", flush=True)
        return beams, run_counts

    a, run_a = run("sbs run 1")
    b, _ = run("sbs run 2")
    same = (torch.equal(a.tokens, b.tokens) and torch.equal(a.logp, b.logp)
            and torch.equal(a.gumbel, b.gumbel))
    distinct = len({tuple(r) for r in a.tokens.tolist()})
    m, run_m = run("map", mode="map")
    g, _ = run("greedy", mode="map", n_beams=1)
    top, greedy = float(m.logp[0]), float(g.logp[0])
    out = {"sbs_ok_rate": float(a.ok_rate), "map_ok_rate": float(m.ok_rate),
           "sbs_bitwise_repeat": same, "sbs_distinct": distinct,
           "map_top_logp": top, "greedy_logp": greedy}
    print(f"{INDEX_TAG} structured ({smi}) {json.dumps(out)}", flush=True)
    check(same, "structured sbs: two runs differ")
    check(distinct == BEAMS["n_beams"] and bool(a.live.all()),
          "structured sbs: the beams are not distinct")
    # batch 4 against batch 1: the trunk's products may round differently
    check(top >= greedy - 1e-3 * max(1.0, abs(greedy)),
          f"structured map: top beam {top} below greedy {greedy}")
    for name in ("flash_decode", "ivf_gather_score", "fused_estimator"):
        check(run_a[name] > 0 and run_m[name] > 0,
              f"structured never launched {name}")
    del index
    torch.cuda.empty_cache()
    return out


def index_dknn(torch, seed: int, cfg, params, counts: dict, smi: str
               ) -> dict:
    """Deep-kNN over tinyllama's 23 taps (22 block steps and the final
    norm) on the launcher's band classification, an exact and an IVF index
    per tap. Gate: the exact index's neighbours are the brute-force fp64
    cosine kNN up to ties at the k-th value, and where they agree exactly
    the p-values and predictions are the same."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.launch.workloads import band_batches, index_cfg, taps
    from repro_torch.models.model import Model
    from repro_torch.workloads import dknn

    model = Model(cfg, "bf16", device="cuda")
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()

    def reps(n):
        toks, labels = band_batches(cfg, n, DKNN["classes"], DKNN["seq"],
                                    rng)
        return taps(model, params, toks), torch.from_numpy(labels)

    (tr, tl), (ca, cl), (te, wl) = (reps(DKNN["train"]), reps(DKNN["cal"]),
                                    reps(DKNN["test"]))
    torch.cuda.synchronize()
    taps_s = time.perf_counter() - t0
    n_taps = tr.shape[0]
    check(n_taps == cfg.n_layers + 1, f"dknn: {n_taps} taps")
    out: dict = {"n_taps": n_taps, "taps_s": taps_s}
    results = {}
    for name in ("exact", "ivf"):
        dcfg = dknn.DKNNConfig(n_classes=DKNN["classes"], k=DKNN["k"],
                               index_cfg=index_cfg(name))
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t1 = time.perf_counter()
        state = dknn.fit(tr, tl, ca, cl, dcfg)
        res = dknn.classify(state, dknn.normalize_reps(te), dcfg)
        torch.cuda.synchronize()
        run_counts = ops.launch_counts()
        for k, n in run_counts.items():
            counts[k] = counts.get(k, 0) + n
        results[name] = res
        out[name] = {
            "accuracy": float((res.pred.cpu() == wl).float().mean()),
            "credibility_mean": float(res.credibility.mean()),
            "confidence_mean": float(res.confidence.mean()),
            "seconds": time.perf_counter() - t1}
        print(f"{INDEX_TAG} dknn {name} launches {json.dumps(run_counts)}",
              flush=True)
        if name == "ivf":
            check(run_counts["ivf_gather_score"] > 0,
                  "dknn ivf never launched ivf_gather_score")
    # brute force: fp64 cosine over the same taps
    res = results["exact"]
    a = tr.double() / torch.linalg.norm(tr.double(), dim=-1, keepdim=True)
    b = te.double() / torch.linalg.norm(te.double(), dim=-1, keepdim=True)
    cos = torch.einsum("jbd,jnd->jbn", b, a)  # (taps, test, train)
    kth = torch.topk(cos, DKNN["k"], dim=2).values[..., -1:]
    neigh = res.neighbors
    got_cos = torch.gather(cos, 2, neigh)
    inside = cos >= kth - 1e-6  # the brute-force top-k, ties included
    tie_ok = bool((neigh >= 0).all()) and bool(
        (got_cos >= kth - 1e-6).all()) and bool(
        (inside.sum(2) >= DKNN["k"]).all())
    exact_rows = (inside.sum(2) == DKNN["k"]).all(0)  # no tie at the k-th
    labels = tl.cuda()
    votes = torch.zeros((te.shape[1], DKNN["classes"]), device="cuda",
                        dtype=torch.float64)
    for j in range(n_taps):
        top = torch.topk(cos[j], DKNN["k"], dim=1).indices
        votes.scatter_add_(1, labels[top], torch.ones_like(top,
                                                           dtype=votes.dtype))
    alpha = n_taps * DKNN["k"] - votes
    same_alpha = bool((alpha.float()[exact_rows]
                       == res.alpha[exact_rows]).all())
    out["brute_force"] = {"tie_ok": tie_ok,
                          "rows_without_ties": int(exact_rows.sum()),
                          "alpha_equal": same_alpha}
    print(f"{INDEX_TAG} dknn ({smi}) {json.dumps(out)}", flush=True)
    check(tie_ok and same_alpha, "dknn: the exact index's neighbours are "
          "not the brute-force cosine kNN")
    return out


def index_lsh_sampler(torch, seed: int, counts: dict, records: list[dict],
                      smi: str) -> dict:
    """The LSH sampler (32 tables x 6 bits, bucket_cap = n, so lossless)
    against Algorithm 3 (k = l = default_kl(n)) on the paper's ImageNet
    benchmark table (160,000 x 256, clustered, made on the card), 64
    queries θ = row / 0.05: RMSE against the exact log Z and device-event
    ms a query of each. Algorithm 3 runs with the exact top-k probe (the
    launcher's head-to-head) and through the [paper] phase's IVF probe
    (sqrt(n) clusters, 16 probed), whose ``ivf_gather_score`` is checked
    against its plain version here. At bucket_cap = n the sampler scores
    every row (L·cap >= n), so it and the exact-probe Algorithm 3 do the
    dense exact log Z's product and more."""
    from repro_torch.configs.paper_loglinear import IMAGENET_BENCH as pc
    from repro_torch.core import estimators as est
    from repro_torch.core import mips
    from repro_torch.core.gumbel import default_kl
    from repro_torch.kernels import ops
    from repro_torch.launch.workloads import (clustered_db,
                                              estimator_head_to_head,
                                              random_queries)

    b = LSH_SAMPLER["queries"]
    db = clustered_db(pc.n, pc.d, seed=seed, device="cuda")
    h = random_queries(db, b, temperature=pc.temperature, seed=seed + 1)
    k = default_kl(pc.n, pc.delta)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = estimator_head_to_head(db, h, k=k, l=k, tables=LSH_SAMPLER["tables"],
                                 bits=LSH_SAMPLER["bits"], seed=seed)
    torch.cuda.synchronize()
    run_counts = ops.launch_counts()
    for name, n in run_counts.items():
        counts[name] = counts.get(name, 0) + n
    lidx = res["index"]
    exact = res["exact"]

    def rmse(x):
        return float(torch.sqrt(torch.mean((x.double() - exact.double())
                                           ** 2)))

    ivf = mips.build_index(mips.IVFConfig(
        n_clusters=max(16, int(math.sqrt(pc.n))), kmeans_iters=4,
        n_probe=PAPER_N_PROBE), db)
    timer = Timer(torch, ITERS)
    index_gather_check(torch, timer, {r["name"]: r for r in records}
                       ["ivf_gather_score"], "index_alg3_ivf", ivf, h)
    del timer

    def alg3(index=None):
        topk = est.topk_probe(db, h, k, index=index)
        keys = torch.stack([torch.full((b,), seed), torch.arange(b),
                            torch.zeros(b, dtype=torch.int64)], 1).cuda()
        ids, log_w = est.amortized_candidates(topk, pc.n, k, keys=keys)
        return est.stratified_logz(db, h, ids, log_w)

    ops.reset_launch_counts()
    alg3_ivf = alg3(ivf)
    torch.cuda.synchronize()
    for name, n in ops.launch_counts().items():
        counts[name] = counts.get(name, 0) + n

    out = {"n": pc.n, "d": pc.d, "queries": b, "k": k, "l": k,
           "tables": lidx.n_tables, "bits": lidx.n_bits,
           "bucket_cap": lidx.bucket_cap, "dropped": lidx.dropped_count,
           "index_mb": lidx.memory_bytes() / 1e6,
           "lsh_rmse": rmse(res["lsh"]), "alg3_rmse": rmse(res["alg3"]),
           "alg3_ivf_rmse": rmse(alg3_ivf),
           "first_pass_s": time.perf_counter() - t0,
           "lsh_ms_per_query": event_ms(
               torch, lambda: est.lsh_sampler_logz(lidx, h)) / b,
           "alg3_ms_per_query": event_ms(torch, alg3) / b,
           "alg3_ivf_ms_per_query": event_ms(torch, lambda: alg3(ivf)) / b,
           "exact_ms_per_query": event_ms(
               torch, lambda: est.exact_logz(db, h)) / b}
    print(f"{INDEX_TAG} lsh sampler vs algorithm 3 launches "
          f"{json.dumps(run_counts)}", flush=True)
    print(f"{INDEX_TAG} lsh sampler vs algorithm 3 ({smi}) "
          f"{json.dumps(out)}", flush=True)
    check(out["dropped"] == 0, "lsh sampler: the buckets dropped rows")
    check(all(math.isfinite(out[x])
              for x in ("lsh_rmse", "alg3_rmse", "alg3_ivf_rmse")),
          "lsh sampler: a non-finite estimate")
    check(run_counts["fused_estimator"] > 0,
          "algorithm 3 never launched fused_estimator")
    del lidx, res, db, h, ivf
    torch.cuda.empty_cache()
    return out


def index_anisotropic(torch, seed: int, cfg, params, prompts, counts: dict,
                      smi: str) -> dict:
    """IVF-PQ at the head's geometry (32,000 rows of d 2048; 8 x 256
    codewords, n_probe 8, r 1,152) built with anisotropic eta 4 and with
    the standard objective (0), same seed: build seconds and recall@576
    against the exact top-k, queried unfused (``pq_lut_score``,
    ``rerank_select``) by the hidden states of the serving prompts. The
    re-rank of 2k covers most of the probed pool, so the codebooks decide
    little of that recall; the screen's own recall (the LUT's top 576
    alone, re-ranked with r = k) is the number the codebooks move."""
    from repro_torch.core import mips
    from repro_torch.kernels import ops
    from repro_torch.models import transformer
    from repro_torch.models.model import Model

    model = Model(cfg, "bf16", device="cuda")
    emb = model._out_embed(params)[: cfg.vocab].float()
    trunk = model.compute_params(params)
    hs = []
    with torch.no_grad():
        for p in prompts:
            tok = torch.tensor(p, device="cuda").long()[None]
            x = params["embed"][tok].to(model.compute_dtype)
            pos = torch.arange(tok.shape[1], device="cuda")[None]
            h, _ = transformer.apply_trunk_prefill(trunk, cfg, x, pos,
                                                   max_seq=tok.shape[1])
            hs.append(h[0].float())
    q = torch.cat(hs)  # every prompt position's hidden state
    k = model.head_cfg.k
    exact = mips.build_index(mips.ExactConfig(), emb).topk_batch(q, k)
    out: dict = {"queries": int(q.shape[0]), "k": k}
    for eta in (ANISO_ETA, 0.0):
        pcfg = mips.PQConfig(n_probe=cfg.head_n_probe, rerank=2 * k,
                             anisotropic_eta=eta, seed=seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        idx = mips.build_index(pcfg, emb)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        ops.reset_launch_counts()
        tk = idx.topk_batch(q, k)
        torch.cuda.synchronize()
        run_counts = ops.launch_counts()
        for name, n in run_counts.items():
            counts[name] = counts.get(name, 0) + n
        rec = statistics.mean(recall(tk.ids, exact))
        screen = type(idx)(dataclasses.replace(idx.config, rerank=k),
                           idx.state).topk_batch(q, k)
        out[f"eta_{eta:g}"] = {
            "build_s": build_s, "recall_at_k": rec,
            "screen_recall_at_k": statistics.mean(recall(screen.ids, exact)),
            "index_mb": idx.memory_bytes() / 1e6}
        check(run_counts["pq_lut_score"] > 0 and run_counts["rerank_select"]
              > 0, f"anisotropic eta {eta}: a PQ kernel was never launched")
        del idx
    print(f"{INDEX_TAG} anisotropic ivfpq ({smi}) {json.dumps(out)}",
          flush=True)
    torch.cuda.empty_cache()
    return out


def index_side_phase(torch, seed: int, records: list[dict], smi: str
                     ) -> dict:
    """The ``[index-side]`` phase at tinyllama-1.1b's full width: the LSH
    head served (fused T=8 ≡ unfused T=1) and trained (resume bitwise),
    structured search (sbs repeatable and distinct, MAP ≥ greedy), deep-kNN
    (exact = brute force), the LSH sampler against Algorithm 3 (no row
    dropped), the anisotropic IVF-PQ build. Adds each kernel's launches on
    these paths (``launches_index_side``) to ``records``, and the checks
    of the kernels at this phase's own geometries
    (:func:`index_kernel_checks`)."""
    import gc

    from repro_torch.configs import get
    from repro_torch.models.model import Model

    cfg = get("tinyllama-1.1b")
    params = Model(cfg, "bf16", device="cuda").init(seed)
    prompts = family_prompts(cfg, seed)  # the [serve] phase's prompts
    counts: dict = {}
    out: dict = {"card": smi}
    t0 = time.perf_counter()
    index_kernel_checks(torch, cfg, records)
    print(f"{INDEX_TAG} kernel checks done in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    steps = (("lsh_serve", lambda: index_lsh_serve(torch, cfg, params,
                                                   prompts, counts, smi)),
             ("structured", lambda: index_structured(torch, seed, cfg,
                                                     params, counts, smi)),
             ("dknn", lambda: index_dknn(torch, seed, cfg, params, counts,
                                         smi)),
             ("anisotropic", lambda: index_anisotropic(
                 torch, seed, cfg, params, prompts, counts, smi)))
    for name, fn in steps:
        t0 = time.perf_counter()
        out[name] = fn()
        print(f"{INDEX_TAG} {name} done in {time.perf_counter() - t0:.1f} s",
              flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    for name, fn in (("lsh_train", lambda: index_lsh_train(
            torch, seed, cfg, counts, smi)),
            ("lsh_sampler", lambda: index_lsh_sampler(torch, seed, counts,
                                                      records, smi))):
        t0 = time.perf_counter()
        out[name] = fn()
        print(f"{INDEX_TAG} {name} done in {time.perf_counter() - t0:.1f} s",
              flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    for rec in records:
        rec["launches_index_side"] = counts.get(rec["name"], 0)
    print(f"{INDEX_TAG} launches {json.dumps(counts)}", flush=True)
    return out


# ----------------------------------------------------------------- [sharded]
SHARD_TAG = "[sharded]"
SHARD_TP = 2  # model shards: 16,000 of tinyllama's 32,000 rows a rank
SHARD_TRAIN_LAYERS = 22  # DP×TP training depth: tinyllama's full 22
SHARD_NEW_TOKENS = 16  # new tokens a request of the tp-2 serving runs (the
#   serving phase's 32 cut: every gate compares runs of this group, and a
#   decoded step costs 45 host-staged all-reduces)
SHARD_TRAIN_STEPS, SHARD_TRAIN_EVERY = 4, 2
SHARD_EXACT_TOKENS = 256  # tokens of the exact-mode equality check
SHARD_MOE_TOKENS = 256  # tokens of the forward_dist == forward check
SHARD_RING_N = 1 << 22  # elements a rank of the int8 ring all-reduce
SHARD_RING_REL = 0.04  # the ring's relative error bound (the reference's)
SHARD_TIMEOUT_S = 600.0  # a spawned group's limit
# recurrentgemma-9b on tp 2: its one KV head does not divide, so the dense
# ring (the 2,048-row window at max_seq 4,096) is split over positions,
# 1,024 a rank; prompts of 900-2,100 tokens and 32 new tokens cross the
# shard boundary, and the longest wraps the ring
SHARD_RG_PROMPTS = (1000, 1400, 1800, 2040)
SHARD_RG_MAX_SEQ, SHARD_RG_NEW = 4096, 32
SHARD_RG_RTOL = 1e-4  # tp-2 logits against one device, fp32, every step
SHARD_HEADS = ("ivfpq", "lsh")  # the other heads served on tp 2


def shard_kernel_checks(torch, records: list[dict]) -> None:
    """The kernels at ONE model shard's shapes of tinyllama's head (16,000
    rows of d 2,048; the shard's IVF geometry; k, l = max(8, k / tp)), each
    against its plain version as :func:`kernel_checks` holds it, stored as
    ``shard_*`` keys: ``ivf_gather_score`` and ``ivf_screen_select`` on
    small-integer rows (bit for bit; the screen equal to the gather plus a
    top-k), ``tail_gather_argmax`` and ``fused_estimator`` at the head's
    training chunk; and ``flash_decode``, dense and paged (block_len 64),
    at one model shard's heads of the trunk (16 query heads on 2 KV heads
    of 64 over the serving ring), as :func:`flash_decode_case` and
    :func:`flash_decode_paged_case` hold them."""
    from repro_torch.configs import get
    from repro_torch.core.gumbel import default_m_cap
    from repro_torch.core.mips.ivf import IVFConfig, _geometry
    from repro_torch.kernels import decode_fused as kdf
    from repro_torch.kernels import ivf_gather_score as kigs
    from repro_torch.kernels import ref
    from repro_torch.models import head as dh
    from repro_torch.models.model import head_config
    from repro_torch.serve.server import ServeConfig

    cfg = get("tinyllama-1.1b")
    hc = head_config(cfg)
    by_name = {r["name"]: r for r in records}
    timer = Timer(torch, ITERS)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2525)
    g = dataclasses.replace(
        geometry(cfg, ServeConfig(batch_slots=SLOTS, max_seq=MAX_SEQ,
                                  max_new_tokens=NEW_TOKENS)),
        hq=cfg.n_heads // SHARD_TP, hkv=cfg.n_kv_heads // SHARD_TP)
    lengths = torch.randint(1, MAX_SEQ + 1, (g.slots,), generator=gen,
                            device="cuda", dtype=torch.int32)
    lengths[0], lengths[-1] = 1, MAX_SEQ
    heads = [g.hq, g.hkv, g.hd]
    c = flash_decode_case(torch, gen, g, timer, MAX_SEQ, lengths)
    tag_record(by_name["flash_decode"], "shard", c["err"], c["timed"],
               c["plain_ms"], c["lib_ms"], c["nb"], c["flops"], BF16_FLOPS,
               label=SHARD_TAG, positions=MAX_SEQ, heads=heads)
    c = flash_decode_paged_case(torch, gen, g, timer, MAX_SEQ, lengths, 64)
    tag_record(by_name["flash_decode_paged"], "shard", c["err"], c["timed"],
               c["plain_ms"], c["lib_ms"], c["nb"], c["flops"], BF16_FLOPS,
               label=SHARD_TAG, positions=MAX_SEQ, block_len=64, heads=heads,
               dense_ms=c["dense_ms"])
    flash_decode_lse_case(torch, gen, timer, by_name["flash_decode"])
    n, k, l = dh.shard_geometry(hc, cfg.vocab_padded, SHARD_TP)
    n = min(n, cfg.vocab)
    d = cfg.d_model
    n_c, cap, o_cap = _geometry(n, IVFConfig(n_probe=hc.n_probe))
    n_probe, b, m_cap = hc.n_probe, SLOTS, default_m_cap(l)
    print(f"{SHARD_TAG} shard geometry " + json.dumps(
        {"rows": n, "d": d, "n_clusters": n_c, "cap": cap, "o_cap": o_cap,
         "n_probe": n_probe, "k": k, "l": l, "m_cap": m_cap}), flush=True)
    mv = int_valued(torch, gen, (n_c, cap, d))
    fill = torch.rand((n_c, cap), generator=gen, device="cuda")
    mids = torch.randint(0, n, (n_c, cap), generator=gen, device="cuda",
                         dtype=torch.int32)
    mids = torch.where(fill < n / (n_c * cap), mids, torch.full_like(mids, -1))
    probe = torch.stack([torch.randperm(n_c, generator=gen,
                                        device="cuda")[:n_probe]
                         for _ in range(b)]).int()
    qv = int_valued(torch, gen, (b, d))
    gs, gi = kigs.ivf_gather_score(mv, mids, probe, qv)
    want_s, want_i = ref.ivf_gather_score_ref(mv, mids, probe, qv)
    torch.cuda.synchronize()
    check(torch.equal(gs, want_s) and torch.equal(gi, want_i),
          "ivf_gather_score at a shard's shapes disagrees with its plain "
          "version")
    uniq = torch.unique(probe)
    tag_record(by_name["ivf_gather_score"], "shard", 0.0,
               timer.both(lambda: kigs.ivf_gather_score(mv, mids, probe, qv),
                          "ivf_gather_score shard"),
               timer(lambda: ref.ivf_gather_score_ref(mv, mids, probe, qv),
                     "ivf_gather_score shard plain"), None,
               *kcost().ivf_gather_score(mv, mids, probe, qv,
                                         n_unique=uniq.numel())[:2],
               FP32_FLOPS, label=SHARD_TAG,
               rows=n, queries=b)
    o_ids = torch.randint(0, n, (o_cap,), generator=gen, device="cuda",
                          dtype=torch.int32)
    o_ids[torch.rand((o_cap,), generator=gen, device="cuda") < 0.5] = -1
    o_sc = int_valued(torch, gen, (b, o_cap), -200, 200)
    sargs = (mv, mids, o_sc, o_ids, probe, qv)
    got_v, got_i = kdf.ivf_screen_select(*sargs, k=k)
    want_v, want_i = ref.ivf_screen_select_ref(*sargs, k)
    pool_s = torch.cat([gs.reshape(b, -1), o_sc], 1)
    pool_i = torch.cat([gi.reshape(b, -1), o_ids[None].expand(b, -1)], 1)
    pool_s = torch.where(pool_i >= 0, pool_s, float("-inf"))
    v3, i3 = ref.topk_select_ref(pool_s, pool_i, k)
    torch.cuda.synchronize()
    check(torch.equal(got_v, want_v) and torch.equal(got_i, want_i),
          "ivf_screen_select at a shard's shapes disagrees with its plain "
          "version")
    check(torch.equal(v3, got_v) and torch.equal(i3, got_i),
          "ivf_screen_select != ivf_gather_score + top-k at a shard's shapes")
    live_rows = int((mids[probe.long()] >= 0).sum().item())
    live_uniq = int((mids[uniq.long()] >= 0).sum().item())
    tag_record(by_name["ivf_screen_select"], "shard", 0.0,
               timer.both(lambda: kdf.ivf_screen_select(*sargs, k=k),
                          "ivf_screen_select shard"),
               timer(lambda: ref.ivf_screen_select_ref(*sargs, k),
                     "ivf_screen_select shard plain"), None,
               *kcost().ivf_screen_select(
                   *sargs, k, n_unique=uniq.numel(), live_unique=live_uniq,
                   live_rows=live_rows)[:2], FP32_FLOPS, label=SHARD_TAG,
               k=k,
               pool=n_probe * cap + o_cap)
    del mv, mids, sargs, pool_s, pool_i

    emb = int_valued(torch, gen, (n, d))
    h = int_valued(torch, gen, (b, d))
    pos = torch.randint(0, n, (b, m_cap), generator=gen, device="cuda",
                        dtype=torch.int32)
    m_used = torch.randint(0, m_cap + 1, (b,), generator=gen, device="cuda",
                           dtype=torch.int32)
    m_used[0], m_used[-1] = 0, m_cap
    pert_s = int_valued(torch, gen, (b, k), -300, 300)
    pert_s[:, ::7] = float("-inf")
    s_ids = torch.randint(0, n, (b, k), generator=gen, device="cuda",
                          dtype=torch.int32)
    heights = int_valued(torch, gen, (b, m_cap), 0, 40) * 0.25
    targs = (emb, pos, m_used, pert_s, s_ids, heights, h)
    got_i, got_v = kdf.tail_gather_argmax(*targs)
    want_i, want_v = ref.tail_gather_argmax_ref(*targs)
    torch.cuda.synchronize()
    err = (got_v - want_v).abs().max().item()
    check(torch.equal(got_i, want_i)
          and torch.allclose(got_v, want_v, rtol=1e-5, atol=1e-5),
          f"tail_gather_argmax at a shard's shapes disagrees: {err}")
    live = torch.arange(m_cap, device="cuda")[None] < m_used[:, None]
    tag_record(by_name["tail_gather_argmax"], "shard", err,
               timer.both(lambda: kdf.tail_gather_argmax(*targs),
                          "tail_gather_argmax shard"),
               timer(lambda: ref.tail_gather_argmax_ref(*targs),
                     "tail_gather_argmax shard plain"), None,
               *kcost().tail_gather_argmax(
                   *targs, rows=int(torch.unique(pos[live]).numel()),
                   m_total=int(m_used.sum().item()))[:2], FP32_FLOPS,
               label=SHARD_TAG, k=k, m_cap=m_cap)
    del emb, targs
    estimator_check(torch, gen, timer, by_name["fused_estimator"], "shard",
                    n, d, HEAD_CHUNK, k, label=SHARD_TAG)
    print(f"[timer] {SHARD_TAG} calls whose host issue outlasted the hold: "
          f"{json.dumps(timer.uncovered)}", flush=True)
    del timer
    torch.cuda.empty_cache()


def flash_decode_lse_case(torch, gen, timer: Timer, rec: dict) -> None:
    """``flash_decode(..., return_lse=True)`` at one shard of
    recurrentgemma-9b's split ring (4 x 1,024 positions, 16 query heads on
    one KV head of 256, bf16), one row empty: held against
    ``flash_decode_lse_ref`` (the output at atol 2e-3, the log-sum-exp
    where it is finite at rtol 1e-5 / atol 1e-4; the empty row 0 and -inf
    on both), timed beside its plain version and SDPA (masked, GQA), as
    keys ``lse_shard_*`` of the ``flash_decode`` record."""
    from repro_torch.kernels import flash_decode as kfd
    from repro_torch.kernels import ref

    b, s, hq, hkv, hd = SLOTS, SHARD_RG_MAX_SEQ // 2 // SHARD_TP, 16, 1, 256
    q = torch.randn((b, hq, hd), generator=gen, device="cuda").bfloat16()
    kc = torch.randn((b, s, hkv, hd), generator=gen, device="cuda").bfloat16()
    vc = torch.randn((b, s, hkv, hd), generator=gen, device="cuda").bfloat16()
    lengths = torch.tensor([0, 1, s // 2 + 3, s], device="cuda",
                           dtype=torch.int32)
    o, lse = kfd.flash_decode(q, kc, vc, lengths, return_lse=True)
    wo, wl = ref.flash_decode_lse_ref(q, kc, vc, lengths)
    torch.cuda.synchronize()
    fin = torch.isfinite(wl)
    err = max((o - wo).abs().max().item(),
              (lse[fin] - wl[fin]).abs().max().item())
    check(torch.equal(torch.isfinite(lse), fin) and not bool(fin[0].any())
          and bool((o[0] == 0).all()),
          "flash_decode_lse: the empty row is not 0 / -inf")
    check(torch.allclose(o, wo, rtol=0, atol=2e-3)
          and torch.allclose(lse[fin], wl[fin], rtol=1e-5, atol=1e-4),
          f"flash_decode_lse disagrees with its plain version: {err}")
    mask = (torch.arange(s, device="cuda")[None] < lengths[:, None])
    qs, ks, vs = q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    try:
        sdpa(qs, ks, vs, attn_mask=mask[:, None, None, :], enable_gqa=True)
        lib = timer(lambda: sdpa(qs, ks, vs, attn_mask=mask[:, None, None, :],
                                 enable_gqa=True), "sdpa lse shard")
    except TypeError:  # no GQA in this PyTorch's SDPA
        lib = None
    c = kcost().flash_decode(q, kc, lengths, lse=True,
                             live=int(lengths.clamp(0, s).sum().item()))
    tag_record(rec, "lse_shard", err,
               timer.both(lambda: kfd.flash_decode(q, kc, vc, lengths,
                                                   return_lse=True),
                          "flash_decode lse shard"),
               timer(lambda: ref.flash_decode_lse_ref(q, kc, vc, lengths),
                     "flash_decode lse shard plain"), lib, c.bytes, c.flops,
               BF16_FLOPS, label=SHARD_TAG, shown="flash_decode_lse",
               positions=s, heads=[hq, hkv, hd], empty_rows=1)


def _shard_out(out_dir: str, rank: int, obj) -> None:
    with open(Path(out_dir) / f"rank{rank}.json", "w") as f:
        json.dump(obj, f)


def _rank_serve(torch, mesh, seed: int, counts: dict) -> dict:
    """TP serving of full-depth tinyllama-1.1b on this rank's shard, the
    trunk sharded (this rank's query and KV heads, SwiGLU hidden and
    embedding rows): after an untimed warm-up, fused T=8, unfused T=1
    over one ShardedIndex; the
    paged pool (block_len 64); fused T=8 again under staggered arrivals
    (fifo: tokens are a function of request and position alone, so it
    must repeat the first run bit for bit) and slo under the same
    arrivals (rank 0's clock decides)."""
    from repro_torch import collectives as coll
    from repro_torch.configs import get
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import report
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw
    from repro_torch.serve.server import ServeConfig, Server

    cfg = get("tinyllama-1.1b").scaled(head_mips="ivf")
    prompts = family_prompts(cfg, seed)
    arrivals = [TIER_ARRIVAL_S * i for i in range(len(prompts))]
    if mesh.rank == 0:
        print(f"{SHARD_TAG} cut tp{SHARD_TP} serving traffic: {len(prompts)} "
              f"requests x {SHARD_NEW_TOKENS} new tokens (the [serve] "
              f"phase's {NEW_TOKENS})", flush=True)
    params = Model(cfg, "bf16", device="cuda", mesh=mesh).init(seed)
    # one short untimed run first (one admission, one window), so that the
    # first-use costs (allocator, gloo connections, kernel loads) stay out
    # of the timed runs
    warm = Server(cfg.scaled(head_fused_decode=True), params, ServeConfig(
        batch_slots=SLOTS, max_seq=MAX_SEQ, max_new_tokens=WINDOW,
        decode_window=WINDOW, seed=seed),
        precision_policy="bf16", device="cuda", mesh=mesh)
    t0 = time.perf_counter()
    warm.run(prompts[:SLOTS])
    torch.cuda.synchronize()
    if mesh.rank == 0:
        print(f"{SHARD_TAG} tp{SHARD_TP} serve warm-up (untimed, {SLOTS} "
              f"requests x {WINDOW} new tokens): "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    runs, index, out, picked = {}, warm.index, {}, []
    del warm
    for label, fused, window, extra, run_kw in (
            ("fused T=8", True, WINDOW, {}, {}),
            ("unfused T=1", False, 1, {}, {}),
            ("paged block_len=64", True, WINDOW, {"block_len": 64}, {}),
            ("fifo arrivals", True, WINDOW, {}, {"arrivals": arrivals}),
            ("slo arrivals", True, WINDOW,
             {"sched": "slo", "ttft_slo_s": TIER_TTFT_SLO_S},
             {"arrivals": arrivals,
              "priorities": [i % 2 for i in range(len(prompts))]})):
        srv = Server(cfg.scaled(head_fused_decode=fused), params, ServeConfig(
            batch_slots=SLOTS, max_seq=MAX_SEQ,
            max_new_tokens=SHARD_NEW_TOKENS, decode_window=window, seed=seed,
            **extra),
            precision_policy="bf16", device="cuda", index=index, mesh=mesh)
        index = srv.index
        if extra.get("sched") == "slo":
            pick = srv.sched.pick_window

            def spy(*a, pick=pick):
                picked.append(pick(*a))
                return picked[-1]

            srv.sched.pick_window = spy
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        coll.reset_host_bytes()
        res = srv.run(prompts, **run_kw)
        torch.cuda.synchronize()
        run = ops.launch_counts()
        for k, n in run.items():
            counts[k] = counts.get(k, 0) + n
        rep = report(res, srv)
        toks = sum(len(r.tokens) for r in res)
        rep["host_staged_bytes_per_token"] = sum(coll.HOST_BYTES.values()) / toks
        rep["host_staged_bytes"] = dict(coll.HOST_BYTES)
        rep["launches"] = run
        runs[label] = [r.tokens for r in res]
        out[label] = rep
        if label == "fused T=8":
            out["trunk_mb_rank"] = sum(
                t.numel() * t.element_size()
                for t in adamw.tree_leaves(srv.run_params["blocks"])) / 1e6
            out["kv_mb_rank"] = rep["cache_mb"]
        if mesh.rank == 0:
            print(f"{SHARD_TAG} tp{SHARD_TP} serve {label} "
                  + json.dumps(rep), flush=True)
        del srv
    first = runs["fused T=8"]
    out["index_mb_shard"] = index.local.memory_bytes() / 1e6
    out["index_mb_total"] = index.memory_bytes() / 1e6
    out["fused_eq_unfused"] = sum(
        a == b for a, b in zip(first, runs["unfused T=1"]))
    out["repeat_bitwise"] = sum(
        a == b for a, b in zip(first, runs["fifo arrivals"]))
    out["paged_eq_dense"] = sum(
        a == b for a, b in zip(first, runs["paged block_len=64"]))
    out["slo_eq_fifo"] = sum(
        a == b for a, b in zip(runs["fifo arrivals"], runs["slo arrivals"]))
    out["slo_windows"] = {str(w): picked.count(w) for w in sorted(set(picked))}
    out["requests"] = len(prompts)
    out["tokens"] = first
    return out


def _kv_bytes(cache) -> int:
    """Bytes of a serving cache's attention K / V leaves."""
    return sum(t.numel() * t.element_size() for g in cache
               for lay in g.values() for name, t in lay.items()
               if name in ("k", "v"))


def _rank_rg(torch, mesh, seed: int, counts: dict) -> dict:
    """recurrentgemma-9b on tp 2 at full width, 8 of 38 layers, the IVF
    ShardedIndex head, dense serving: its one KV head does not divide, so
    each rank holds 1,024 of the window's 2,048 ring positions. Served at
    decode window 8, 1 and 8 again over one index (the unfused head: a
    shard's 8-probe pool is 16,640 slots, past the fused screen's 16,384);
    then, in fp32, the logits of the 1,000- and the 2,040-token prompts
    and 32 teacher-forced steps each (past the shard boundary; past the
    ring's end, so it wraps) against one device."""
    import numpy as np

    from repro_torch.configs import get
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import report
    from repro_torch.models import transformer
    from repro_torch.models.model import Model
    from repro_torch.serve.server import ServeConfig, Server

    full = get("recurrentgemma-9b")
    depth = FAMILY_CUTS["recurrentgemma-9b"]
    cfg = full.scaled(n_layers=depth, head_mips="ivf")
    rng = np.random.default_rng(seed)
    prompts = [list(map(int, rng.integers(0, cfg.vocab, n)))
               for n in SHARD_RG_PROMPTS]
    if mesh.rank == 0:
        print(f"{SHARD_TAG} cut recurrentgemma-9b tp{SHARD_TP}: n_layers "
              f"{full.n_layers} -> {depth} (d {full.d_model}, vocab "
              f"{full.vocab}); traffic {len(prompts)} requests of "
              f"{list(SHARD_RG_PROMPTS)} prompt tokens x {SHARD_RG_NEW} new "
              f"tokens at max_seq {SHARD_RG_MAX_SEQ} (ring {full.local_window}"
              f", {full.local_window // SHARD_TP} a rank)", flush=True)
    out: dict = {}
    # teacher-forced logits, fp32: tp 2 against one device, from the
    # shortest prompt (decode crosses the shard boundary) and the longest
    # (decode wraps the ring: the owner's write of slot 0, full shards)
    tokens = list(map(int, rng.integers(0, cfg.vocab, SHARD_RG_NEW)))
    teach = (prompts[0], prompts[-1])
    rels = []
    with torch.no_grad():
        logits = {}
        for label, m in (("tp", mesh), ("one", None)):
            model = Model(cfg, "f32", device="cuda", mesh=m)
            params = model.init(seed)
            emb = model._out_embed(params)
            v = emb.shape[0]
            rows = slice(0, v) if m is not None else slice(
                mesh.model.index * v // SHARD_TP,
                (mesh.model.index + 1) * v // SHARD_TP)
            steps_ = []
            for prompt in teach:
                cache = model.init_cache(1, SHARD_RG_MAX_SEQ)
                x = model._lookup(params, torch.tensor([prompt],
                                                       device="cuda"))
                l = x.shape[1]
                pos = torch.arange(l, device="cuda")[None]
                h, part = transformer.apply_trunk_prefill(
                    params, cfg, x, pos, max_seq=SHARD_RG_MAX_SEQ, mesh=m)
                cache = transformer.insert_cache_slots(
                    cache, part, torch.arange(1, device="cuda"), mesh=m)
                steps_.append(h[:, -1].float() @ emb[rows].float().T)
                p = torch.tensor([l], device="cuda")
                for t in tokens:
                    x = model._lookup(params, torch.tensor([t],
                                                           device="cuda"))
                    h, cache = transformer.apply_trunk_decode(
                        params, cfg, x[:, None], cache, p, mesh=m)
                    steps_.append(h[:, 0].float() @ emb[rows].float().T)
                    p = p + 1
                del cache, part
            logits[label] = steps_
            del model, params, emb
            torch.cuda.empty_cache()
        for a, b in zip(logits["tp"], logits["one"]):
            rels.append(((a - b).abs().max() / b.abs().max()).item())
        del logits
    torch.cuda.empty_cache()
    out["teacher_rel_err_max"] = max(rels)
    out["teacher_steps"] = len(rels)
    # serving, bf16
    params = Model(cfg, "bf16", device="cuda", mesh=mesh).init(seed)
    runs, index = {}, None
    for label, window in (("T=8", WINDOW), ("T=1", 1), ("T=8 again",
                                                        WINDOW)):
        srv = Server(cfg, params, ServeConfig(
            batch_slots=SLOTS, max_seq=SHARD_RG_MAX_SEQ,
            max_new_tokens=SHARD_RG_NEW, decode_window=window, seed=seed),
            precision_policy="bf16", device="cuda", index=index, mesh=mesh)
        index = srv.index
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        res = srv.run(prompts)
        torch.cuda.synchronize()
        run = ops.launch_counts()
        for k, n in run.items():
            counts[k] = counts.get(k, 0) + n
        rep = report(res, srv)
        rep["launches"] = run
        if label == "T=8":
            rep["kv_mb_rank"] = _kv_bytes(srv.cache) / 1e6
            rep["kv_mb_one_device"] = _kv_bytes(transformer.init_cache(
                cfg, SLOTS, SHARD_RG_MAX_SEQ, torch.bfloat16,
                device="meta")) / 1e6
            rep["ring_rows_rank"] = next(
                lay["k"].shape[2] for g in srv.cache for lay in g.values()
                if "k" in lay)
            out.update({k: rep[k] for k in ("kv_mb_rank", "kv_mb_one_device",
                                            "ring_rows_rank")})
        if mesh.rank == 0:
            print(f"{SHARD_TAG} recurrentgemma-9b tp{SHARD_TP} serve {label} "
                  + json.dumps(rep), flush=True)
        runs[label] = [r.tokens for r in res]
        out[label] = rep
        del srv
    out["window_eq"] = sum(a == b for a, b in zip(runs["T=8"], runs["T=1"]))
    out["repeat_bitwise"] = sum(a == b for a, b in zip(runs["T=8"],
                                                       runs["T=8 again"]))
    out["complete"] = all(len(t) == SHARD_RG_NEW for t in runs["T=8"])
    out["requests"] = len(prompts)
    out["tokens"] = runs["T=8"]
    return out


def _rank_heads(torch, mesh, seed: int, counts: dict) -> dict:
    """The IVF-PQ and the SRP-LSH heads on tp 2 (full-depth tinyllama-1.1b,
    the trunk sharded, a ShardedIndex of each kind): 4 requests x 16 new
    tokens, fused T=8 against unfused T=1 over one index each."""
    from repro_torch.configs import get
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import report
    from repro_torch.models.model import Model
    from repro_torch.serve.server import ServeConfig, Server

    base = get("tinyllama-1.1b")
    prompts = family_prompts(base, seed)[:SLOTS]
    params = Model(base, "bf16", device="cuda", mesh=mesh).init(seed)
    out = {}
    for mips in SHARD_HEADS:
        cfg = base.scaled(head_mips=mips)
        toks, index, reps = {}, None, {}
        for fused, window in ((True, WINDOW), (False, 1)):
            srv = Server(cfg.scaled(head_fused_decode=fused), params,
                         ServeConfig(batch_slots=SLOTS, max_seq=MAX_SEQ,
                                     max_new_tokens=SHARD_NEW_TOKENS,
                                     decode_window=window, seed=seed),
                         precision_policy="bf16", device="cuda", index=index,
                         mesh=mesh)
            index = srv.index
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            res = srv.run(prompts)
            torch.cuda.synchronize()
            run = ops.launch_counts()
            for k, n in run.items():
                counts[k] = counts.get(k, 0) + n
            toks[fused] = [r.tokens for r in res]
            reps["fused" if fused else "unfused"] = dict(
                report(res, srv), launches=run)
            del srv
        out[mips] = {"fused_eq_unfused": sum(
            a == b for a, b in zip(toks[True], toks[False])),
            "requests": len(prompts), "tokens": toks[True],
            "index_mb_shard": index.local.memory_bytes() / 1e6, **reps}
        if mesh.rank == 0:
            print(f"{SHARD_TAG} tp{SHARD_TP} {mips} head serve " + json.dumps(
                {k: v for k, v in out[mips].items() if k != "tokens"}),
                flush=True)
        del index
    return out


def _rank_exact(torch, mesh, seed: int) -> dict:
    """One tp-2 exact-mode head loss and its (d_emb, d_h) at full width
    against the single-device head on the same rows (every rank gathers
    the table for the single-device side)."""
    from repro_torch import collectives as coll
    from repro_torch.configs import get
    from repro_torch.core import amortized_head as ah
    from repro_torch.models import head as dh

    cfg = get("tinyllama-1.1b")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 77)
    vp, d, t = cfg.vocab_padded, cfg.d_model, SHARD_EXACT_TOKENS
    full = torch.randn((vp, d), generator=gen, device="cuda") * 0.02
    h0 = torch.randn((t, d), generator=gen, device="cuda")
    tgt = torch.randint(0, cfg.vocab, (t,), generator=gen, device="cuda")
    hc = ah.HeadConfig(n=cfg.vocab, mode="exact")
    v = vp // mesh.tp
    emb_loc = full[mesh.model.index * v:(mesh.model.index + 1) * v].clone()
    e = emb_loc.requires_grad_(True)
    h = h0.clone().requires_grad_(True)
    loss = dh.dist_head_loss(mesh, e, h, tgt, hc)
    loss.sum().backward()
    fe = full.clone().requires_grad_(True)
    h1 = h0.clone().requires_grad_(True)
    ref_loss = ah.head_loss(fe, h1, tgt, hc).loss
    ref_loss.sum().backward()
    d_emb_ref = fe.grad[mesh.model.index * v:(mesh.model.index + 1) * v]
    gathered = coll.all_gather(e.grad, mesh.model).reshape(vp, d)
    def close5(a, b):  # rtol 1e-5; atol 1e-5 of the largest magnitude
        return torch.allclose(a, b, rtol=1e-5,
                              atol=1e-5 * b.abs().max().item())

    ok = (torch.allclose(loss, ref_loss, rtol=1e-5, atol=0)
          and close5(e.grad, d_emb_ref) and close5(h.grad, h1.grad)
          and close5(gathered, fe.grad))
    return {"ok": bool(ok),
            "loss_max_rel": float(((loss - ref_loss).abs()
                                   / ref_loss.abs()).max()),
            "d_emb_max_abs": float((e.grad - d_emb_ref).abs().max()),
            "d_h_max_abs": float((h.grad - h1.grad).abs().max())}


def _rank_ring(torch, mesh, seed: int) -> dict:
    from repro_torch import collectives as coll
    from repro_torch.optim.compress import ring_allreduce_int8

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 100 + mesh.rank)
    x = torch.randn((SHARD_RING_N,), generator=gen, device="cuda")
    exact = coll.psum(x, mesh.model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    approx = ring_allreduce_int8(x, mesh.model, seed)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    rel = float(torch.linalg.norm(approx - exact) / torch.linalg.norm(exact))
    return {"rel_err": rel, "elements": SHARD_RING_N, "wall_s": dt,
            "on": str(approx.device)}


def _rank_moe(torch, mesh, seed: int, counts: dict) -> dict:
    """qwen3-moe at 2 of 48 layers on tp 2 (64 of 128 experts a rank):
    ``forward_dist`` against ``forward`` on one layer, then one serving run
    and 2 training steps on the mesh."""
    import numpy as np

    from repro_torch.data.synthetic import DataConfig, SyntheticStream
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch.serve import report
    from repro_torch.models import moe
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.serve.server import ServeConfig, Server

    from repro_torch.configs import get

    cfg = get("qwen3-moe-30b-a3b").scaled(
        head_mips="ivf", n_layers=FAMILY_CUTS["qwen3-moe-30b-a3b"])
    full = Model(cfg, "bf16", device="cuda").init(seed)
    layer = {k: v[0] for k, v in full["blocks"][0]["0"]["mlp"].items()}
    params = mesh_lib.shard_params(full, mesh, cfg)
    del full
    e = cfg.n_experts // mesh.tp
    loc = {k: v[0] for k, v in params["blocks"][0]["0"]["mlp"].items()}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 5)
    x = torch.randn((SHARD_MOE_TOKENS, cfg.d_model), generator=gen,
                    device="cuda")
    want, want_aux = moe.forward(layer, cfg, x)
    got, got_aux = moe.forward_dist(loc, cfg, x, mesh)
    out = {"experts_per_rank": e, "mode": mesh_lib.moe_mode(cfg, mesh.tp),
           "max_abs": float((got - want).abs().max()),
           "aux": [float(got_aux), float(want_aux)],
           "ok": bool(torch.allclose(got, want, rtol=1e-4, atol=1e-4)
                      and abs(float(got_aux) - float(want_aux))
                      <= 1e-4 * abs(float(want_aux)) + 1e-6)}
    del layer, loc
    prompts = family_prompts(cfg, seed)
    srv = Server(cfg.scaled(head_fused_decode=True), params, ServeConfig(
        batch_slots=SLOTS, max_seq=MAX_SEQ, max_new_tokens=NEW_TOKENS,
        decode_window=WINDOW, seed=seed), precision_policy="bf16",
        device="cuda", mesh=mesh)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    res = srv.run(prompts)
    torch.cuda.synchronize()
    for k, n in ops.launch_counts().items():
        counts[k] = counts.get(k, 0) + n
    out["serve"] = report(res, srv)
    out["serve_complete"] = all(len(r.tokens) == NEW_TOKENS for r in res)
    index = srv.index
    del srv
    model = Model(cfg, "bf16", device="cuda", mesh=mesh)
    opt = adamw.init(params)
    step_fn = steps_lib.make_train_step(model, steps_lib.TrainConfig(
        opt=OptConfig(**FAMILY_OPT), precision="bf16"))
    data = SyntheticStream(cfg, DataConfig(batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                                           seed=seed))
    index = model.make_head_index(params,
                                  db=model.head_index_db(params).clone())
    losses = []
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for i in range(2):
        batch = {k: torch.from_numpy(np.asarray(v)).cuda()
                 for k, v in next(data).items()}
        params, opt, m = step_fn(params, opt, batch, (seed, i), index)
        losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    out["train_s_per_step"] = (time.perf_counter() - t0) / 2
    for k, n in ops.launch_counts().items():
        counts[k] = counts.get(k, 0) + n
    out["train_losses"] = losses
    out["train_ok"] = all(math.isfinite(v) for v in losses)
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def sharded_tp_rank(rank: int, world: int, init: str, out_dir: str,
                    seed: int) -> None:
    """One rank of the tp-2 group on the card (gloo): the int8 ring, TP
    serving, the exact-mode equality, the MoE."""
    import torch

    from repro_torch.launch import mesh as mesh_lib

    mesh_lib.init_rank(rank, world, init, backend="gloo", device="cuda:0",
                       timeout_s=SHARD_TIMEOUT_S)
    mesh = mesh_lib.make_train_mesh(1, world, timeout_s=SHARD_TIMEOUT_S)
    out, counts = {}, {}
    for name, fn in (("ring", lambda: _rank_ring(torch, mesh, seed)),
                     ("serve", lambda: _rank_serve(torch, mesh, seed,
                                                   counts)),
                     ("heads", lambda: _rank_heads(torch, mesh, seed,
                                                   counts)),
                     ("rg", lambda: _rank_rg(torch, mesh, seed, counts)),
                     ("exact", lambda: _rank_exact(torch, mesh, seed)),
                     ("moe", lambda: _rank_moe(torch, mesh, seed, counts))):
        t0 = time.perf_counter()
        out[name] = fn()
        out[name + "_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        if rank == 0:
            print(f"{SHARD_TAG} tp{world} {name} done in "
                  f"{out[name + '_s']:.1f} s", flush=True)
    out["launches"] = counts
    _shard_out(out_dir, rank, out)


def _train_cfg():
    from repro_torch.configs import get

    return get("tinyllama-1.1b").scaled(n_layers=SHARD_TRAIN_LAYERS,
                                        head_mips="ivf")


def _leaf_digest(t) -> str:
    return hashlib.sha256(t.detach().float().cpu().numpy().tobytes()
                          ).hexdigest()[:16]


def sharded_dp_tp_rank(rank: int, world: int, init: str, out_dir: str,
                       seed: int, workdir: str, whole: str) -> None:
    """One rank of the dp 2 × tp 2 group on the card (gloo): Trainer with
    the IVF head on a ShardedIndex, async refresh and sharded checkpoints,
    every leaf this rank's block (the trunk Megatron-split over ``model``
    and FSDP-split over ``data``); 4 steps uninterrupted (the digest of
    each of this rank's param blocks kept, the step-4 checkpoint moved to
    ``whole`` for the parent's whole restore), then a resume from the
    step-2 checkpoint."""
    import gc

    import torch
    import torch.distributed as dist

    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.steps import TrainConfig, _sorted_leaves
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train.trainer import RunConfig, Trainer

    mesh_lib.init_rank(rank, world, init, backend="gloo", device="cuda:0",
                       timeout_s=SHARD_TIMEOUT_S)
    mesh = mesh_lib.make_train_mesh(2, world // 2, timeout_s=SHARD_TIMEOUT_S)
    cfg = _train_cfg()
    run = RunConfig(num_steps=SHARD_TRAIN_STEPS, ckpt_every=SHARD_TRAIN_EVERY,
                    log_every=1, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                    fuse_steps=SHARD_TRAIN_EVERY, seed=seed,
                    index_refresh_every=SHARD_TRAIN_EVERY,
                    async_refresh=True, sharded_ckpt=True,
                    train=TrainConfig(opt=OptConfig(
                        lr=1e-4, warmup_steps=2,
                        total_steps=SHARD_TRAIN_STEPS), precision="bf16"))
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    tr = Trainer(cfg, run, workdir, device="cuda:0", mesh=mesh)
    first = tr.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    # this rank's block of every param leaf at step 4 (the checkpoint's)
    digests = {"/".join(p): _leaf_digest(t)
               for p, t in _sorted_leaves(tr.state["params"])}
    with open(Path(workdir) / f"ckpt_{SHARD_TRAIN_EVERY:08d}"
              / "manifest.json") as f:
        man = json.load(f)
    out = {"losses": [m["loss"] for m in tr.metrics_log],
           "dt": [m["dt"] for m in tr.metrics_log],
           "events": [(e["kick"], e["swap"]) for e in tr.refresh_events],
           "status": first["status"], "wall_s": wall,
           "manifest": [bool(man.get("sharded")), bool(man.get("complete"))],
           "digests": digests, "launches": counts,
           "index_mb_shard": tr.head_index.local.memory_bytes() / 1e6,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    del tr  # four ranks' training state: free it before the resume's
    gc.collect()
    torch.cuda.empty_cache()
    if rank == 0:  # the resume starts from step 2: the later one moves aside
        Path(whole).mkdir(parents=True, exist_ok=True)
        shutil.move(str(Path(workdir) / f"ckpt_{SHARD_TRAIN_STEPS:08d}"),
                    str(Path(whole) / f"ckpt_{SHARD_TRAIN_STEPS:08d}"))
    dist.barrier()
    tr2 = Trainer(cfg, run, workdir, device="cuda:0", mesh=mesh)
    tr2.train()
    out["resumed"] = [m["loss"] for m in tr2.metrics_log]
    out["resumed_events"] = [(e["kick"], e["swap"])
                             for e in tr2.refresh_events]
    _shard_out(out_dir, rank, out)


def sharded_phase(torch, seed: int, records: list[dict], smi: str) -> dict:
    """The ``[sharded]`` phase: the kernels at one shard's shapes
    (:func:`shard_kernel_checks`), then groups of ranks spawned on the one
    card under gloo (NCCL refuses two ranks on one card; collectives on
    CUDA tensors cross the host, counted): tp 2 — the int8 ring all-reduce on
    CUDA tensors, full-depth tinyllama-1.1b served
    fused T=8 ≡ unfused T=1, repeatable, paged ≡ dense and slo ≡ fifo
    under arrivals, the trunk sharded; the exact-mode distributed
    head equal to the single-device one at full width, and qwen3-moe (2
    of 48 layers, 64 of 128 experts a rank) with ``forward_dist`` ≡
    ``forward``, one serving run and 2 training steps; then dp 2 × tp 2 —
    tinyllama-1.1b at full width and depth (each rank a quarter of the
    trunk), ``Trainer`` with the IVF head, async refresh and sharded
    checkpoints every 2 steps, 4 steps, then a resume from step 2 that
    must give the uninterrupted losses bit for bit; the step-4 checkpoint
    restored whole here against the ranks' blocks. Rank 0 prints; each
    record gains
    ``launches_sharded``: the launches summed over the ranks of both
    groups, counted from 0 just before each path and read just after."""
    import shutil

    from repro_torch.launch import mesh as mesh_lib

    t0 = time.perf_counter()
    shard_kernel_checks(torch, records)
    print(f"{SHARD_TAG} kernel checks done in {time.perf_counter() - t0:.1f} "
          f"s", flush=True)
    print(f"{SHARD_TAG} ranks share cuda:0 under gloo (nccl refuses two "
          f"ranks on one card)", flush=True)
    base = ROOT / "build" / "chip_smoke_sharded"
    shutil.rmtree(base, ignore_errors=True)
    out: dict = {"card": smi}
    counts: dict = {}
    for label, fn, world, extra in (
            ("tp", sharded_tp_rank, SHARD_TP, ()),
            ("dp_tp", sharded_dp_tp_rank, 2 * SHARD_TP,
             (str(base / "train"), str(base / "whole")))):
        d = base / label
        d.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        mesh_lib.run_ranks(fn, world, (world, mesh_lib.file_init_method(
            str(d)), str(d), seed, *extra), timeout_s=SHARD_TIMEOUT_S)
        ranks = [json.loads((d / f"rank{r}.json").read_text())
                 for r in range(world)]
        for r in ranks:
            for k, n in r["launches"].items():
                counts[k] = counts.get(k, 0) + n
        out[label] = ranks[0]
        out[label + "_ranks"] = ranks
        out[label + "_s"] = time.perf_counter() - t0
        print(f"{SHARD_TAG} {label} group done in {out[label + '_s']:.1f} s",
              flush=True)
    out["whole"] = _whole_restore_check(base / "whole", out["dp_tp_ranks"])
    shutil.rmtree(base, ignore_errors=True)
    _sharded_gates(out, smi)
    for rec in records:
        rec["launches_sharded"] = counts.get(rec["name"], 0)
    print(f"{SHARD_TAG} launches {json.dumps(counts)}", flush=True)
    return out


def _whole_restore_check(whole: Path, ranks: list[dict]) -> dict:
    """The DP×TP run's step-4 checkpoint restored whole on one process (no
    mesh): every param leaf cut into the four ranks' blocks by its spec
    must have the digest that rank kept of its own block."""
    from repro_torch.checkpoint import manager
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.steps import _sorted_leaves
    from repro_torch.models import transformer

    t0 = time.perf_counter()
    cfg = _train_cfg()
    mesh = mesh_lib.Mesh(2, SHARD_TP, 0, None, None, None)
    state, _, _ = manager.restore(str(whole), step=SHARD_TRAIN_STEPS,
                                  device="cpu", keys=("params",))
    leaves = bad = 0
    for path, t in _sorted_leaves(state["params"]):
        dims = mesh_lib.spec_dims(transformer.spec_of(path, mesh, cfg))
        for r, o in enumerate(ranks):
            coords = {"data": r // SHARD_TP, "model": r % SHARD_TP}
            blk = t
            for a, d in dims.items():
                n = t.shape[d] // mesh.shape[a]
                blk = blk.narrow(d, coords[a] * n, n)
            bad += _leaf_digest(blk) != o["digests"]["/".join(path)]
        leaves += 1
    del state
    return {"leaves": leaves, "mismatched_blocks": bad,
            "s": time.perf_counter() - t0}


def _sharded_gates(out: dict, smi: str) -> None:
    tp, dptp = out["tp"], out["dp_tp"]
    sv = tp["serve"]
    n_req = sv["requests"]
    print(f"{SHARD_TAG} int8 ring all-reduce ({smi}) "
          + json.dumps(tp["ring"]), flush=True)
    check(tp["ring"]["rel_err"] < SHARD_RING_REL,
          f"int8 ring all-reduce relative error {tp['ring']['rel_err']}")
    print(f"{SHARD_TAG} tp{SHARD_TP} fused T={WINDOW} == unfused T=1 tokens: "
          f"{sv['fused_eq_unfused']}/{n_req}; two fused runs (the second "
          f"under arrivals) bitwise: {sv['repeat_bitwise']}/{n_req}; paged "
          f"block_len=64 == dense "
          f"tokens: {sv['paged_eq_dense']}/{n_req}; slo == fifo under "
          f"arrivals every {TIER_ARRIVAL_S} s: {sv['slo_eq_fifo']}/{n_req} "
          f"(slo windows picked {json.dumps(sv['slo_windows'])})",
          flush=True)
    check(sv["fused_eq_unfused"] == n_req,
          "TP serving: fused T=8 and unfused T=1 served different tokens")
    check(sv["repeat_bitwise"] == n_req,
          "TP serving: two fused runs served different tokens")
    check(sv["paged_eq_dense"] == n_req,
          "TP serving: the paged pool served different tokens")
    check(sv["slo_eq_fifo"] == n_req,
          "TP serving: slo / fifo under arrivals served different tokens")
    check(all(r["serve"]["tokens"] == sv["tokens"]
              for r in out["tp_ranks"]), "TP serving: ranks disagree")
    fused = sv["fused T=8"]
    summary = {"itl_p50_ms": fused["itl_p50_ms"],
               "tokens_per_s": fused["tokens_per_s"],
               "unfused_itl_p50_ms": sv["unfused T=1"]["itl_p50_ms"],
               "unfused_tokens_per_s": sv["unfused T=1"]["tokens_per_s"],
               "ok_rate": fused["ok_rate"],
               "index_mb_shard": sv["index_mb_shard"],
               "index_mb_total": sv["index_mb_total"],
               "host_staged_bytes_per_token":
                   fused["host_staged_bytes_per_token"],
               "unfused_host_staged_bytes_per_token":
                   sv["unfused T=1"]["host_staged_bytes_per_token"],
               "paged_itl_p50_ms": sv["paged block_len=64"]["itl_p50_ms"],
               "slo_itl_p50_ms": sv["slo arrivals"]["itl_p50_ms"],
               "kv_mb_rank": sv["kv_mb_rank"],
               "trunk_mb_rank": sv["trunk_mb_rank"]}
    print(f"{SHARD_TAG} tp{SHARD_TP} serve summary ({smi}) "
          + json.dumps(summary), flush=True)
    check(fused["ok_rate"] > 0.9, f"TP serving ok_rate {fused['ok_rate']}")
    for mips in SHARD_HEADS:
        h = tp["heads"][mips]
        print(f"{SHARD_TAG} tp{SHARD_TP} {mips} head fused T={WINDOW} == "
              f"unfused T=1 tokens: {h['fused_eq_unfused']}/{h['requests']}",
              flush=True)
        check(h["fused_eq_unfused"] == h["requests"],
              f"TP serving, {mips} head: fused and unfused served different "
              "tokens")
        check(all(r["heads"][mips]["tokens"] == h["tokens"]
                  for r in out["tp_ranks"]), f"{mips} head: ranks disagree")
    rg = tp["rg"]
    rg_sum = {k: rg[k] for k in ("teacher_rel_err_max", "teacher_steps",
                                 "kv_mb_rank", "kv_mb_one_device",
                                 "ring_rows_rank", "window_eq",
                                 "repeat_bitwise", "complete")}
    rg_sum.update(itl_p50_ms=rg["T=8"]["itl_p50_ms"],
                  tokens_per_s=rg["T=8"]["tokens_per_s"],
                  ttft_p50_ms=rg["T=8"].get("ttft_p50_ms"),
                  cache_mb_rank=rg["T=8"]["cache_mb"])
    print(f"{SHARD_TAG} recurrentgemma-9b tp{SHARD_TP} split ring ({smi}) "
          + json.dumps(rg_sum), flush=True)
    print(f"{SHARD_TAG} recurrentgemma-9b tp{SHARD_TP} decode window "
          f"{WINDOW} == 1 tokens: {rg['window_eq']}/{rg['requests']}; two "
          f"T={WINDOW} runs bitwise: {rg['repeat_bitwise']}/{rg['requests']};"
          f" fp32 teacher-forced logits vs one device, max rel err "
          f"{rg['teacher_rel_err_max']:.3g} over {rg['teacher_steps']} "
          f"steps; KV MB a rank {rg['kv_mb_rank']:.3f} vs one device "
          f"{rg['kv_mb_one_device']:.3f}", flush=True)
    check(rg["window_eq"] == rg["requests"] and rg["complete"],
          "recurrentgemma tp2: window 8 and window 1 served different tokens")
    check(rg["repeat_bitwise"] == rg["requests"],
          "recurrentgemma tp2: two runs served different tokens")
    check(all(r["rg"]["teacher_rel_err_max"] <= SHARD_RG_RTOL
              for r in out["tp_ranks"]),
          f"recurrentgemma tp2 logits differ from one device: "
          f"{[r['rg']['teacher_rel_err_max'] for r in out['tp_ranks']]}")
    check(abs(rg["kv_mb_rank"] * SHARD_TP - rg["kv_mb_one_device"]) < 1e-6
          and rg["ring_rows_rank"] == 2048 // SHARD_TP,
          "recurrentgemma tp2: a rank does not hold half the KV ring")
    check(all(r["rg"]["tokens"] == rg["tokens"] for r in out["tp_ranks"]),
          "recurrentgemma tp2: ranks disagree")
    print(f"{SHARD_TAG} exact-mode tp{SHARD_TP} head == single device: "
          + json.dumps(tp["exact"]), flush=True)
    check(all(r["exact"]["ok"] for r in out["tp_ranks"]),
          "exact-mode distributed head differs from the single-device head")
    moe_ = tp["moe"]
    print(f"{SHARD_TAG} qwen3-moe ep ({smi}) " + json.dumps(
        {k: v for k, v in moe_.items() if k != "serve"}), flush=True)
    print(f"{SHARD_TAG} qwen3-moe serve " + json.dumps(moe_["serve"]),
          flush=True)
    check(all(r["moe"]["ok"] for r in out["tp_ranks"]),
          "MoE forward_dist differs from forward")
    check(moe_["serve_complete"] and moe_["train_ok"],
          "MoE on the mesh: lost tokens or a non-finite loss")
    print(f"{SHARD_TAG} dp2 x tp{SHARD_TP} tinyllama-1.1b at full depth "
          f"({SHARD_TRAIN_LAYERS} layers, d 2048, vocab 32000): every leaf "
          f"this rank's block", flush=True)
    losses, resumed = dptp["losses"], dptp["resumed"]
    train = {"losses": losses, "resumed": resumed,
             "step_s": dptp["dt"], "events": dptp["events"],
             "resumed_events": dptp["resumed_events"],
             "manifest_sharded_complete": dptp["manifest"],
             "index_mb_shard": dptp["index_mb_shard"],
             "peak_gb_ranks": [r["peak_gb"] for r in out["dp_tp_ranks"]],
             "wall_s": dptp["wall_s"], "whole_restore": out["whole"]}
    print(f"{SHARD_TAG} dp2 x tp{SHARD_TP} train ({smi}) "
          + json.dumps(train), flush=True)
    check(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
          f"DP×TP training: loss not finite or not falling: {losses}")
    check(resumed == losses[SHARD_TRAIN_EVERY:],
          f"DP×TP resume from step {SHARD_TRAIN_EVERY} differs from the "
          f"uninterrupted run: {resumed} vs {losses[SHARD_TRAIN_EVERY:]}")
    check(dptp["events"] == [[SHARD_TRAIN_EVERY, 2 * SHARD_TRAIN_EVERY]],
          f"async refresh off schedule: {dptp['events']}")
    check(dptp["manifest"] == [True, True],
          f"sharded checkpoint manifest {dptp['manifest']}")
    ranks = out["dp_tp_ranks"]
    rep = [p for p, d in ranks[0]["digests"].items()
           if all(r["digests"][p] == d for r in ranks)]
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import transformer
    mesh = mesh_lib.Mesh(2, SHARD_TP, 0, None, None, None)
    paths = list(ranks[0]["digests"])  # every param leaf
    want_rep = [p for p in paths if not mesh_lib.spec_dims(
        transformer.spec_of(p.split("/"), mesh, _train_cfg()))]
    print(f"{SHARD_TAG} dp2 x tp{SHARD_TP} replicated leaves equal on the "
          f"four ranks: {len(set(want_rep) & set(rep))}/{len(want_rep)}; "
          f"step-{SHARD_TRAIN_STEPS} checkpoint restored whole == the four "
          f"ranks' blocks: {json.dumps(out['whole'])}", flush=True)
    check(set(want_rep) <= set(rep),
          "DP×TP: a replicated leaf (a norm) differs between the ranks")
    check(out["whole"]["mismatched_blocks"] == 0 and out["whole"]["leaves"]
          == len(paths), "DP×TP: the whole restore differs from the ranks' "
          "blocks")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the weights, the prompts and the sampler")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))

    from repro_torch.configs import get
    from repro_torch.kernels import build
    from repro_torch.serve.server import ServeConfig

    smi = gpu_line()
    print(f"[setup] {smi}", flush=True)
    print(f"[setup] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    build.build_all()
    print(f"[setup] kernels built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    print(build.ptxas_report(), flush=True)

    cfg = get("tinyllama-1.1b")
    scfg_kw = dict(batch_slots=SLOTS, max_seq=MAX_SEQ,
                   max_new_tokens=NEW_TOKENS, seed=args.seed)
    g = geometry(cfg, ServeConfig(**scfg_kw))
    print(f"[setup] geometry {json.dumps(dataclasses.asdict(g))}", flush=True)
    timer = Timer(torch, ITERS)
    records = kernel_checks(torch, g, timer)
    torch.cuda.empty_cache()
    records.insert(1, paged_kernel_checks(torch, g, timer))
    torch.cuda.empty_cache()
    train_kernel_checks(torch, g, timer, records)
    torch.cuda.empty_cache()
    pq_kernel_checks(torch, g, timer, records)
    print(f"[timer] calls whose host issue outlasted the hold (timed with "
          f"host time in them): {json.dumps(timer.uncovered)}", flush=True)
    del timer
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    counts, serve_stats, serve_us, ctx = serve(torch, args.seed, cfg, scfg_kw)
    print(f"[serve] {json.dumps(serve_stats)} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    tier_counts, tier = serve_tier(torch, cfg, scfg_kw, ctx)
    print(f"[serve-tier] phase done in {time.perf_counter() - t0:.1f} s",
          flush=True)
    # the paged kernel's launches are its paged run's (read just after it),
    # and its path time that run's profiled repeat
    counts["flash_decode_paged"] = tier_counts["flash_decode_paged"]
    serve_us["flash_decode_paged"] = (tier["paged_path"]["kernels"]
                                      ["flash_decode"]["us_per_call"])
    del ctx, tier
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    train_counts = {}
    for mips in MIPS:
        run_counts, _ = train(torch, args.seed, cfg, mips)
        for name in TRAIN_KERNELS[mips]:
            train_counts.setdefault(name, run_counts[name])
    _, train_us = probe_diagnostics(torch, args.seed, cfg)
    print(f"[train] phase done in {time.perf_counter() - t0:.1f} s",
          flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cost_phase(torch, args.seed, records, smi)
    print(f"{COST_TAG} phase done in {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    paper_phase(torch, args.seed, records, smi)
    print(f"[paper] phase done in {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    families_phase(torch, args.seed, records, smi)
    print(f"[families] phase done in {time.perf_counter() - t0:.1f} s",
          flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    index_side_phase(torch, args.seed, records, smi)
    print(f"[index-side] phase done in {time.perf_counter() - t0:.1f} s",
          flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    sharded_phase(torch, args.seed, records, smi)
    print(f"{SHARD_TAG} phase done in {time.perf_counter() - t0:.1f} s",
          flush=True)
    # launches: each path's count, read just after its own run — serving
    # (each kernel's count on the first serving run that launches it, the
    # fused run before the unfused one, IVF before IVF-PQ; the paged kernel
    # on the first paged run of [serve-tier]) and the 6-step
    # training runs (IVF, then IVF-PQ for the PQ kernels); "launches" is
    # the count on the newest path that runs the kernel (training where it
    # ran there, else serving); the [paper] and [families] paths' counts
    # stand beside it (launches_paper, launches_adaptive, launches_families,
    # launches_index_side, launches_sharded)
    # path_us: device us per call of the kernel on the same path, from the
    # profiled repeats of it (serving: 4 prompts; training: one step)
    for rec in records:
        serve_n = counts.get(rec["name"], 0)
        train_n = train_counts.get(rec["name"], 0)
        rec.update(launches=train_n or serve_n, launches_serve=serve_n,
                   launches_train=train_n,
                   path_us_serve=serve_us.get(rec["name"]),
                   path_us_train=train_us.get(rec["name"]))
        rec["path_us"] = (rec["path_us_train"] if train_n
                          else rec["path_us_serve"])
        # the device time each path loses to the kernel's distance from its
        # bound: launches x (ms - bound), at each path's shape
        rec["excess_ms"] = serve_n * (rec["ms"] - rec["bound_ms"]) + train_n * (
            rec.get("train_ms", rec["ms"])
            - rec.get("train_bound_ms", rec["bound_ms"]))
    print("[rank] launches x (ms - bound): " + json.dumps(
        {r["name"]: round(r["excess_ms"], 2) for r in
         sorted(records, key=lambda r: -r["excess_ms"])}), flush=True)
    check(len(records) == len(TPU_KERNEL)
          and all(r["launches"] > 0 for r in records),
          "a kernel was never launched on its path: "
          + json.dumps({r["name"]: r["launches"] for r in records}))
    print(json.dumps({"kernels": records}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
