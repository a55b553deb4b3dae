#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA
GPU: builds the CUDA kernels from ``src/repro_torch/csrc``, holds each one
against its plain PyTorch version at the serving path's shapes, then serves
a full-width tinyllama-1.1b (random weights from ``--seed``) with the fused
IVF head and again with the unfused kernel probe at decode window 1, and
checks that both give the same tokens.

    python3 chip_smoke.py            # from the repository root

Output, in order: the GPU line of nvidia-smi, build and check lines, the
serve reports, one ``{"kernels": [...]}`` line, the card's name and power
limit, and last ``{"ok": true, "device": {...}}``. Any failed phase exits
non-zero before the last line. Without CUDA, or without the repository
beside it, the script exits non-zero and prints no result.

Tolerances: ids and indices exact; fp32 values rtol=1e-5, atol=1e-5;
flash_decode (bf16 inputs, fp32 output) atol=2e-3.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
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

TPU_KERNEL = {
    "flash_decode": "src/repro/kernels/flash_decode.py:82",
    "ivf_gather_score": "src/repro/kernels/ivf_gather_score.py:65",
    "ivf_screen_select": "src/repro/kernels/decode_fused.py:190",
    "tail_gather_argmax": "src/repro/kernels/decode_fused.py:471",
}
SOURCE = {
    "flash_decode": "src/repro_torch/csrc/flash_decode.cu",
    "ivf_gather_score": "src/repro_torch/csrc/ivf_gather_score.cu",
    "ivf_screen_select": "src/repro_torch/csrc/decode_fused.cu",
    "tail_gather_argmax": "src/repro_torch/csrc/decode_fused.cu",
}


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
    """Median per-launch device time with CUDA events; L2 (50 MB) is
    flushed before every timed launch, as the serving path finds it cold."""

    def __init__(self, torch, iters: int):
        self.torch = torch
        self.iters = iters
        self.flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn) -> float:
        torch = self.torch
        fn()  # warm-up (and first-use costs)
        times = []
        for _ in range(self.iters):
            self.flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)


def bound_ms(nbytes: float, flops: float, peak: float) -> tuple[float, str]:
    t_b = nbytes / HBM_BYTES_PER_S
    t_o = flops / peak
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# ---------------------------------------------------------------- kernels
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


def geometry(cfg, scfg) -> Geometry:
    from repro_torch.core.gumbel import default_m_cap
    from repro_torch.core.mips.ivf import IVFConfig, _geometry
    from repro_torch.models.model import head_config

    hc = head_config(cfg)
    n_c, cap, o_cap = _geometry(cfg.vocab, IVFConfig(n_probe=hc.n_probe))
    return Geometry(scfg.batch_slots, scfg.max_seq, cfg.n_heads,
                    cfg.n_kv_heads, cfg.head_dim, cfg.vocab, cfg.d_model,
                    n_c, cap, o_cap, hc.n_probe, hc.k, default_m_cap(hc.l))


def int_valued(torch, gen, shape, lo=-2, hi=3):
    """fp32 tensor of small integers: every dot product over d <= 2^20 is
    exact in fp32 in any summation order, so kernel and plain version must
    agree bit for bit — ids and tie-breaks included."""
    return torch.randint(lo, hi, shape, generator=gen, device="cuda",
                         dtype=torch.int32).float()


def kernel_checks(torch, g: Geometry, timer: Timer) -> list[dict]:
    from repro_torch.kernels import decode_fused as kdf
    from repro_torch.kernels import flash_decode as kfd
    from repro_torch.kernels import ivf_gather_score as kigs
    from repro_torch.kernels import ref

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1234)
    out = []

    def record(name, err, ms, plain_ms, lib_ms, nb, flops, peak):
        b_ms, b_by = bound_ms(nb, flops, peak)
        rec = {"name": name, "route": "cuda", "source": SOURCE[name],
               "replaces": TPU_KERNEL[name], "launches": 0,
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}
        print(f"[kernel] {name}: ok max_abs_err={err:.3g} ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) "
              f"library_ms={lib_ms}", flush=True)
        out.append(rec)

    # ---- flash_decode: bf16 KV ring of every slot, lengths 1 .. max_seq
    B, S = g.slots, g.max_seq
    q = torch.randn((B, g.hq, g.hd), generator=gen, device="cuda").bfloat16()
    kc = torch.randn((B, S, g.hkv, g.hd), generator=gen,
                     device="cuda").bfloat16()
    vc = torch.randn((B, S, g.hkv, g.hd), generator=gen,
                     device="cuda").bfloat16()
    lengths = torch.randint(1, S + 1, (B,), generator=gen, device="cuda",
                            dtype=torch.int32)
    lengths[0], lengths[-1] = 1, S
    got = kfd.flash_decode(q, kc, vc, lengths)
    want = ref.flash_decode_ref(q, kc, vc, lengths)
    torch.cuda.synchronize()
    check(got.shape == want.shape and bool(torch.isfinite(got).all()),
          "flash_decode: shape / finiteness")
    err = (got - want).abs().max().item()
    check(torch.allclose(got, want, rtol=0, atol=2e-3),
          f"flash_decode disagrees with its plain version: {err}")
    mask = (torch.arange(S, device="cuda")[None] < lengths[:, None])
    mask = mask[:, None, None, :]
    qs, ks, vs = q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2)
    try:
        sdpa = torch.nn.functional.scaled_dot_product_attention
        sdpa(qs, ks, vs, attn_mask=mask, enable_gqa=True)
        lib = timer(lambda: sdpa(qs, ks, vs, attn_mask=mask, enable_gqa=True))
    except TypeError:  # a PyTorch without GQA in SDPA: no one-call yardstick
        lib = None
    live = int(lengths.sum().item())
    record("flash_decode", err,
           timer(lambda: kfd.flash_decode(q, kc, vc, lengths)),
           timer(lambda: ref.flash_decode_ref(q, kc, vc, lengths)), lib,
           nbytes(q, lengths) + 2 * live * g.hkv * g.hd * 2 + B * g.hq * g.hd * 4,
           4 * live * g.hq * g.hd, BF16_FLOPS)

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
           timer(lambda: kigs.ivf_gather_score(mv, mids, probe, qv)),
           timer(lambda: ref.ivf_gather_score_ref(mv, mids, probe, qv)), None,
           uniq.numel() * g.cap * (g.d + 1) * 4 + nbytes(probe, qv)
           + b * g.n_probe * g.cap * 8,
           2.0 * b * g.n_probe * g.cap * g.d, FP32_FLOPS)

    # ---- ivf_screen_select on the same tables + overflow
    o_ids = torch.randint(0, g.n, (g.o_cap,), generator=gen, device="cuda",
                          dtype=torch.int32)
    o_ids[torch.rand((g.o_cap,), generator=gen, device="cuda") < 0.5] = -1
    o_sc = int_valued(torch, gen, (b, g.o_cap), -200, 200)
    args = (mv, mids, o_sc, o_ids, probe, qv)
    got_v, got_i = kdf.ivf_screen_select(*args, k=g.k)
    want_v, want_i = ref.ivf_screen_select_ref(*args, g.k)
    torch.cuda.synchronize()
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
           timer(lambda: kdf.ivf_screen_select(*args, k=g.k)),
           timer(lambda: ref.ivf_screen_select_ref(*args, g.k)), None,
           live_uniq * g.d * 4 + uniq.numel() * g.cap * 4
           + nbytes(o_sc, o_ids, probe, qv) + b * g.k * 8,
           2.0 * g.d * int(live_rows.sum().item()), FP32_FLOPS)
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
    live = torch.arange(g.m_cap, device="cuda")[None] < m_used[:, None]
    rows = int(torch.unique(pos[live]).numel())
    record("tail_gather_argmax", err,
           timer(lambda: kdf.tail_gather_argmax(*targs)),
           timer(lambda: ref.tail_gather_argmax_ref(*targs)), None,
           rows * g.d * 4 + nbytes(pos, m_used, pert_s, s_ids, heights, h)
           + t * 8,
           2.0 * g.d * int(m_used.sum().item()), FP32_FLOPS)
    return out


# ---------------------------------------------------------------- serving
def serve(torch, seed: int, cfg, scfg_kw):
    from repro_torch.core.mips.ivf import IVFIndex
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import report
    from repro_torch.models.model import Model
    from repro_torch.serve.server import ServeConfig, Server

    import numpy as np

    fused_cfg = cfg.scaled(head_mips="ivf", head_fused_decode=True)
    model = Model(fused_cfg, "bf16", device="cuda")
    t0 = time.perf_counter()
    params = model.init(seed)
    torch.cuda.synchronize()
    print(f"[serve] init {time.perf_counter() - t0:.2f} s", flush=True)
    rng = np.random.default_rng(seed)
    prompts = [list(rng.integers(0, cfg.vocab, size=rng.integers(4, 13)))
               for _ in range(REQUESTS)]

    t0 = time.perf_counter()
    srv = Server(fused_cfg, params,
                 ServeConfig(decode_window=WINDOW, **scfg_kw),
                 precision_policy="bf16", device="cuda")
    torch.cuda.synchronize()
    print(f"[serve] index build {time.perf_counter() - t0:.2f} s "
          f"({srv.stats['index_bytes'] / 1e6:.1f} MB)", flush=True)
    ops.reset_launch_counts()
    res = srv.run(prompts)
    torch.cuda.synchronize()
    fused_counts = ops.launch_counts()
    rep = report(res, srv)
    print("[serve] fused T=%d %s" % (WINDOW, json.dumps(rep)), flush=True)
    print(f"[serve] launches {json.dumps(fused_counts)}", flush=True)
    check(len(res) == len(prompts)
          and all(r.status == "ok" and len(r.tokens) == scfg_kw["max_new_tokens"]
                  for r in res), "fused serve: a request lost its tokens")
    check(all(0 <= tok < cfg.vocab for r in res for tok in r.tokens),
          "fused serve: a token id out of range")
    for name in ("flash_decode", "ivf_screen_select", "tail_gather_argmax"):
        check(fused_counts[name] > 0, f"fused serve never launched {name}")

    # same weights and the same index state, unfused kernel probe, T=1
    unfused_cfg = cfg.scaled(head_mips="ivf", head_use_kernel=True)
    index = IVFIndex(dataclasses.replace(srv.index.config, use_kernel=True),
                     srv.index.state)
    srv1 = Server(unfused_cfg, params,
                  ServeConfig(decode_window=1, **scfg_kw),
                  precision_policy="bf16", device="cuda", index=index)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    res1 = srv1.run(prompts)
    torch.cuda.synchronize()
    unfused_counts = ops.launch_counts()
    rep1 = report(res1, srv1)
    print("[serve] unfused T=1 %s" % json.dumps(rep1), flush=True)
    print(f"[serve] launches {json.dumps(unfused_counts)}", flush=True)
    check(unfused_counts["ivf_gather_score"] > 0,
          "unfused serve never launched ivf_gather_score")
    same = [a.tokens == b.tokens for a, b in zip(res, res1)]
    print(f"[serve] fused T={WINDOW} == unfused T=1 tokens: "
          f"{sum(same)}/{len(same)} requests", flush=True)
    check(all(same), "fused T=8 and unfused T=1 served different tokens")
    counts = dict(fused_counts)
    counts["ivf_gather_score"] = unfused_counts["ivf_gather_score"]
    steps = {"fused_decode_steps": rep["decode_dispatches"] * WINDOW,
             "unfused_decode_steps": rep1["decode_dispatches"]}
    profile(torch, srv, prompts[:SLOTS])
    return counts, steps


def profile(torch, srv, prompts) -> None:
    """Where a fused serving run's time goes: torch.profiler over one run
    of ``prompts``; prints wall time, the summed duration of the device's
    own events (kernels, copies), the device's idle share, and the device
    events that took the most time. Profiling slows the host, so the
    idle share is an upper estimate of the unprofiled run's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = srv.run(prompts)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            acc = by_name.setdefault(e.name[:60], [0, 0.0])
            acc[0] += 1
            acc[1] += e.time_range.elapsed_us() / 1e3
    busy_ms = sum(ms for _, ms in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    print("[profile] " + json.dumps({
        "tokens": sum(len(r.tokens) for r in res), "wall_ms": wall_ms,
        "device_ms": busy_ms, "device_idle_share": 1.0 - busy_ms / wall_ms,
        "device_events": sum(n for n, _ in by_name.values()),
        "top": [[name, n, ms] for name, (n, ms) in top]}), flush=True)


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
    del timer
    torch.cuda.empty_cache()

    counts, steps = serve(torch, args.seed, cfg, scfg_kw)
    for rec in records:
        rec["launches"] = counts[rec["name"]]
    print(f"[serve] {json.dumps(steps)}", flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
