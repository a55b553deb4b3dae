#!/usr/bin/env python3
"""Times the ``flash_decode`` and ``ivf_gather_score`` kernels of one source
tree on one NVIDIA GPU, at the shapes ``chip_smoke.py`` checks them at, with
``chip_smoke.py``'s device-time :class:`Timer` — so two trees (a change and
its parent) can be compared on the same card, in turns:

    git archive <parent> | tar -x -C build/parent   # build/ is git-ignored
    for t in build/parent . . build/parent; do python3 kernel_ab.py --tree $t; done

Each run builds the tree's two kernel libraries (in ``<tree>/build/kernels``),
checks each kernel against the tree's plain version on the same inputs
(flash_decode atol 2e-3; ivf_gather_score rtol 1e-5 and an atol of 1e-5
times the largest |score|, ids exact), and
prints one JSON line: per shape, the median device ms per call (L2 flushed,
host issue outside the events), the median host issue time in us, and the
bound ms from the shape's bytes; ``sdpa_ms`` is one
``scaled_dot_product_attention`` call (GQA, masked) on the same inputs.
Inputs come from ``--seed``, so every tree sees the same data. Exits non-zero
without CUDA.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def kernel_breakdown(torch, timer, fn, calls: int = 10) -> dict:
    """Mean device us per call of each kernel ``fn`` launches, from
    torch.profiler over ``calls`` calls, L2 flushed before each (the
    flush's own kernel left out)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            timer.flush.zero_()
            fn()
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    for e in prof.events():
        m = re.search(r"::(\w+_kernel)\b", e.name)
        if e.device_type == DeviceType.CUDA and m and "at::" not in e.name:
            out[m.group(1)] = (out.get(m.group(1), 0.0)
                               + e.time_range.elapsed_us() / calls)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=".", help="source tree to time")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--iters", type=int, default=30)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(1, str(HERE))
    from chip_smoke import BF16_FLOPS, FP32_FLOPS, Timer, bound_ms, nbytes
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import flash_decode as kfd
    from repro_torch.kernels import ivf_gather_score as kigs

    build.build_all(("flash_decode", "ivf_gather_score"))
    timer = Timer(torch, args.iters)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    out = {"tree": str(tree), "card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()}

    # flash_decode: tinyllama's heads, 4 slots, bf16 ring
    B, hq, hkv, hd = 4, 32, 4, 64
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for S, full in ((512, False), (2048, True)):
        q = torch.randn((B, hq, hd), generator=gen, device="cuda").bfloat16()
        kc = torch.randn((B, S, hkv, hd), generator=gen, device="cuda").bfloat16()
        vc = torch.randn((B, S, hkv, hd), generator=gen, device="cuda").bfloat16()
        if full:
            lengths = torch.full((B,), S, device="cuda", dtype=torch.int32)
        else:
            lengths = torch.randint(1, S + 1, (B,), generator=gen,
                                    device="cuda", dtype=torch.int32)
            lengths[0], lengths[-1] = 1, S
        got = kfd.flash_decode(q, kc, vc, lengths)
        want = ref.flash_decode_ref(q, kc, vc, lengths)
        torch.cuda.synchronize()
        if not torch.allclose(got, want, rtol=0, atol=2e-3):
            raise SystemExit(f"flash_decode S={S} disagrees with its plain "
                             f"version: {(got - want).abs().max().item()}")
        mask = (torch.arange(S, device="cuda")[None] < lengths[:, None])
        mask = mask[:, None, None, :]
        qs, ks, vs = q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2)
        live = int(lengths.sum().item())
        ms, host = timer.both(lambda: kfd.flash_decode(q, kc, vc, lengths),
                              f"flash_decode S={S}")
        out[f"flash_decode_S{S}"] = {
            "ms": ms, "host_us": host,
            "kernels_us": kernel_breakdown(
                torch, timer, lambda: kfd.flash_decode(q, kc, vc, lengths)),
            "sdpa_ms": timer(lambda: sdpa(qs, ks, vs, attn_mask=mask,
                                          enable_gqa=True), "sdpa"),
            "bound_ms": bound_ms(nbytes(q, lengths) + 4 * live * hkv * hd
                                 + B * hq * hd * 4, 4 * live * hq * hd,
                                 BF16_FLOPS)[0]}

    # ivf_gather_score: tinyllama's IVF geometry (178 x 544 x 2048), 8 probes
    n_c, cap, d, n_probe = 178, 544, 2048, 8
    mv = torch.randn((n_c, cap, d), generator=gen, device="cuda")
    mids = torch.randint(0, 32000, (n_c, cap), generator=gen, device="cuda",
                         dtype=torch.int32)
    pop = 1.0 / torch.arange(1, n_c + 1, device="cuda", dtype=torch.float32)
    for name, b, skew in (("b4", 4, False), ("b256", 256, False),
                          ("b256_skewed", 256, True)):
        if skew:
            probe = torch.multinomial(pop.expand(b, -1), n_probe,
                                      generator=gen).int()
        else:
            probe = torch.stack([torch.randperm(n_c, generator=gen,
                                                device="cuda")[:n_probe]
                                 for _ in range(b)]).int()
        qv = torch.randn((b, d), generator=gen, device="cuda")
        got_s, got_i = kigs.ivf_gather_score(mv, mids, probe, qv)
        want_s, want_i = ref.ivf_gather_score_ref(mv, mids, probe, qv)
        torch.cuda.synchronize()
        atol = 1e-5 * want_s.abs().max().item()  # 2048-term dots, any order
        if not (torch.allclose(got_s, want_s, rtol=1e-5, atol=atol)
                and torch.equal(got_i, want_i)):
            raise SystemExit(f"ivf_gather_score {name} disagrees with its "
                             "plain version")
        del want_s, want_i
        uniq = torch.unique(probe).numel()
        ms, host = timer.both(
            lambda: kigs.ivf_gather_score(mv, mids, probe, qv),
            f"ivf_gather_score {name}")
        out[f"ivf_gather_score_{name}"] = {
            "ms": ms, "host_us": host, "distinct_clusters": uniq,
            "kernels_us": kernel_breakdown(
                torch, timer,
                lambda: kigs.ivf_gather_score(mv, mids, probe, qv)),
            "bound_ms": bound_ms(uniq * cap * (d + 1) * 4 + nbytes(probe, qv)
                                 + b * n_probe * cap * 8,
                                 2.0 * b * n_probe * cap * d, FP32_FLOPS)[0]}
    out["uncovered"] = timer.uncovered
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
