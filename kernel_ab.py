#!/usr/bin/env python3
"""Times the ``flash_decode``, ``ivf_gather_score``, ``ivf_screen_select``,
``rerank_select``, ``fused_estimator``, ``fused_estimator_bwd``,
``tail_gather_argmax``, ``pq_screen_select`` and ``pq_lut_score`` kernels
of one source tree on one NVIDIA GPU, at the shapes ``chip_smoke.py``
checks them at, with ``chip_smoke.py``'s device-time :class:`Timer` — so
two trees (a change and its parent) can be compared on the same card, in
turns:

    git archive <parent> | tar -x -C build/parent   # build/ is git-ignored
    for t in build/parent . . build/parent; do python3 kernel_ab.py --tree $t; done

Each run builds the tree's kernel libraries (in ``<tree>/build/kernels``),
checks each kernel against the tree's plain version on the same inputs
(flash_decode atol 2e-3; ivf_gather_score and rerank_select rtol 1e-5 and an
atol of 1e-5 times the largest |score|, ivf_gather_score's ids exact), and
prints one JSON line: per shape, the median device ms per call (L2 flushed,
host issue outside the events), the median host issue time in us, the
device us of each kernel a call launches (profiler; a kernel from the end
of the one before it), and the bound ms from
the shape's bytes; ``--iters`` sets the calls each median takes. ``sdpa_ms`` is one ``scaled_dot_product_attention`` call
(GQA, masked) on the same inputs. ``flash_decode``'s and
``ivf_gather_score``'s shapes print ``digest`` too (the SHA-256 of their
outputs; ``flash_decode`` also ``repeatable``): a tree that only adds the
paged layout must print the parent's ``flash_decode`` digests.

``rerank_select`` runs at the serving path's 4 queries and the training
probe's 256, over one fixed set of 1,152 survivors a query against a
32,000 x 2,048 table of random fp32 rows: uniform survivors (as
``chip_smoke.py``'s random probes give); at 256 queries also survivors
piled onto popular rows (popularity ~ 1 / rank, as trained hidden states
pile onto popular clusters) and near-identical queries sharing most of
their survivors in a similar order (as a training batch's hidden states
from one model can). Each of its shapes also prints ``digest``, the SHA-256 of the
output values' and ids' bytes: two trees whose kernels agree bit for bit
print the same digests.

``ivf_screen_select`` runs at tinyllama's IVF geometry (178 clusters x
544 slots x d 2,048, 8 probes, 2,000 overflow slots, k 576): at the
serving path's 4 queries on ``chip_smoke.py``'s inputs (small-integer
rows, members as sparse as the index's, half the overflow dead; exact
against the plain version), and at 256 queries over random fp32 rows with
uniform probes, probes piled onto popular clusters (popularity ~ 1 /
rank) and near-identical probes (one shared set of 8, the last slot each
query's own), each bitwise equal to the tree's ``ivf_gather_score`` plus a
top-k. ``*_sort_only`` runs the 4- and 256-query calls at probe width 0, so
no member row is read: what is left is the keys' fill and the select. Each
shape prints ``digest`` and ``repeatable``.

``fused_estimator`` runs at one training head chunk (t 256 tokens x m =
1,152 candidates, d 2,048, a 32,000-row fp32 table) on five input sets
(``chip_smoke.estimator_inputs``): S from a popular head of 2,000 rows
(``chip_smoke.py``'s inputs), S uniform over the table, one S for every
token (near-identical tokens), and the popular set with every S slot dead
(``t_only``: the tail draws alone) or every T slot dead (``s_only``: the
popular rows alone); then at the other paths' shapes: the paper's
ImageNet table (``imagenet``: 64 x 6,912, d 256, 1,281,167 rows) and
word embeddings (``word``: 32 x 8,704, d 300, 2,000,126 rows), S uniform
over the table there, Algorithm 3's (``alg3``: 64 x 2,432, d 256,
160,000 rows) and structured search's (``structured``: 4 x 128, d 2,048,
32,000 rows), S from the popular head there. Each prints the route the
tree's shape rule takes (``route``: popular-row plan or not, slot ranges a
token; null in a tree without the rule), ``max_abs_err`` against the
tree's plain version (over tokens with a live slot), ``digest`` of its
outputs and ``repeatable``, whether two launches agree bit for bit: trees
that sum in another order print other digests; ``y_ms`` is the call that
also writes the scores y, as the training path's.

``fused_estimator_bwd`` runs on the same three input sets, the all-dead
token left out, for an upstream gradient in [0.5, 1.5). A tree whose
backward takes the forward's scores (``y=``) gets them from its forward
(``return_y=True``), as the training path does; an older tree's backward
re-scores the rows. Each prints ``ms`` of the backward alone, ``path_ms``
of the forward recomputed plus the backward (the training path's cost per
head chunk), ``digest`` of (``d_emb``, ``p``) and ``repeatable``,
``max_abs_err`` against the plain version that re-scores,
``kernels_us`` with PyTorch's own kernels of the call (the id sort and the
segment search), ``plain_ms`` of the tree's plain version of the same call
and ``bound_ms`` of its bytes (the dense ``d_emb`` write among them).

``tail_gather_argmax`` runs at tinyllama's head (32,000 x 2,048 rows, k
576, m_cap 728): 4 tokens on ``chip_smoke.py``'s inputs (small-integer
rows, m_used from 0 to m_cap; exact against the plain version), 4 tokens
with every m_used near l = 576 over random fp32 rows (the serving path's
shape), and 600 tokens, a batch that fills the card on its own. Each prints
``digest`` (index and value) and ``repeatable``.

``pq_screen_select`` runs at tinyllama's IVF-PQ geometry (178 clusters x
544 slots, 8 x 256 codewords, 2,000 overflow slots, r 1,152) over random
fp32 LUTs (``chip_smoke.pq_inputs``) at 4 and 256 queries, each bitwise
equal to the tree's ``pq_lut_score`` + coarse + top-r, and at probe width
0 (``*_sort_only``: the select alone). Each prints ``digest`` and
``repeatable``. ``pq_lut_score`` runs on the same inputs at 4 and 256
queries, bitwise against the tree's plain version, with ``digest`` and
``repeatable``. These three kernels' shapes also print ``host_burst_us``,
the host's issue cost per call over bursts of back-to-back calls.

``--train-steps N`` then times N training steps of the tree at
``chip_smoke.py``'s training configuration (tinyllama-1.1b at full width,
random weights from ``--seed``, the IVF head on the kernels, 2 x 1,024
tokens, bf16), each after two untimed ones: ``train_step`` prints each
step's wall ms (host clock, the card synchronised after it), its
CUDA-event ms, their medians and the kernels' launches a step — the host
cost of a kernel's calls shows in the wall, not in its device time.

Inputs come from ``--seed``, so every tree sees the same data. Exits
non-zero without CUDA.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import re
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
KERNELS = ("flash_decode", "ivf_gather_score", "ivf_screen_select",
           "rerank_select", "fused_estimator", "fused_estimator_bwd",
           "tail_gather_argmax", "pq_screen_select", "pq_lut_score")


def kernel_breakdown(torch, timer, fn, calls: int = 10,
                     library: bool = False) -> dict:
    """Device us per call of each kernel ``fn`` launches, from
    torch.profiler over ``calls`` calls, L2 flushed before each (the
    flush's own fill left out; PyTorch's own kernels too unless
    ``library``, keyed then by the first 40 characters of their names). A
    kernel is charged from the later of its start and the end of the
    kernel before it: a dependent launch is on the device, waiting, while
    its predecessor runs, and its own duration would count that time
    twice."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a trace now and then comes back without its kernels
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                timer.flush.zero_()
                fn()
            torch.cuda.synchronize()
        if any(e.device_type == DeviceType.CUDA and "FillFunctor" not in e.name
               for e in prof.events()):
            break
    spans = []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        m = re.search(r"::(\w+_kernel)\b", e.name)
        if m and "at::" not in e.name:
            spans.append((e.time_range.start, e.time_range.end, m.group(1)))
        elif library:  # the L2 flush's fill keeps its full name
            name = e.name if "FillFunctor" in e.name else e.name[:40]
            spans.append((e.time_range.start, e.time_range.end, name))
    out: dict[str, float] = {}
    last = float("-inf")
    for start, end, name in sorted(spans):
        own = max(0.0, end - max(start, last))
        if "FillFunctor" not in name:  # the L2 flush
            out[name] = out.get(name, 0.0) + own / calls
        last = max(last, end)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=".", help="source tree to time")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--kernels", nargs="+", default=list(KERNELS),
                    choices=KERNELS, help="kernels to time (default: all)")
    ap.add_argument("--rerank-batches", nargs="+", type=int,
                    default=[4, 256],
                    help="rerank_select's query counts (uniform survivors; "
                    "256 also piled-up ones)")
    ap.add_argument("--train-steps", type=int, default=0,
                    help="training steps to time after the kernels")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(1, str(HERE))
    from chip_smoke import Timer
    from repro_torch.kernels import build

    sources = {"flash_decode": "flash_decode",
               "ivf_gather_score": "ivf_gather_score",
               "ivf_screen_select": "decode_fused",
               "rerank_select": "decode_fused",
               "fused_estimator": "fused_estimator",
               "fused_estimator_bwd": "fused_estimator",
               "tail_gather_argmax": "decode_fused",
               "pq_screen_select": "decode_fused",
               "pq_lut_score": "pq_lut_score"}
    build.build_all(build.SOURCES if args.train_steps
                    else tuple(sources[k] for k in args.kernels))
    timer = Timer(torch, args.iters)
    out = {"tree": str(tree), "card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()}
    for name in args.kernels:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(args.seed)
        CASES[name](torch, timer, gen, out, args)
        torch.cuda.empty_cache()
    if args.train_steps:
        out["train_step"] = train_steps(torch, args.seed, args.train_steps)
    out["uncovered"] = timer.uncovered
    print(json.dumps(out), flush=True)
    return 0


def flash_decode_case(torch, timer, gen, out: dict, args) -> None:
    from chip_smoke import BF16_FLOPS, bound_ms, nbytes
    from repro_torch.kernels import flash_decode as kfd
    from repro_torch.kernels import ref

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
        first = digest(got)
        ms, host = timer.both(lambda: kfd.flash_decode(q, kc, vc, lengths),
                              f"flash_decode S={S}")
        out[f"flash_decode_S{S}"] = {
            "ms": ms, "host_us": host, "digest": first,
            "repeatable": first == digest(kfd.flash_decode(q, kc, vc,
                                                          lengths)),
            "kernels_us": kernel_breakdown(
                torch, timer, lambda: kfd.flash_decode(q, kc, vc, lengths)),
            "sdpa_ms": timer(lambda: sdpa(qs, ks, vs, attn_mask=mask,
                                          enable_gqa=True), "sdpa"),
            "bound_ms": bound_ms(nbytes(q, lengths) + 4 * live * hkv * hd
                                 + B * hq * hd * 4, 4 * live * hq * hd,
                                 BF16_FLOPS)[0]}



def ivf_gather_score_case(torch, timer, gen, out: dict, args) -> None:
    from chip_smoke import FP32_FLOPS, bound_ms, nbytes
    from repro_torch.kernels import ivf_gather_score as kigs
    from repro_torch.kernels import ref

    # tinyllama's IVF geometry (178 x 544 x 2048), 8 probes
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
            "digest": digest(got_s, got_i),
            "kernels_us": kernel_breakdown(
                torch, timer,
                lambda: kigs.ivf_gather_score(mv, mids, probe, qv)),
            "bound_ms": bound_ms(uniq * cap * (d + 1) * 4 + nbytes(probe, qv)
                                 + b * n_probe * cap * 8,
                                 2.0 * b * n_probe * cap * d, FP32_FLOPS)[0]}


def host_burst_us(torch, timer, fn, calls: int = 50, bursts: int = 7
                  ) -> float:
    """Least mean host time to issue ``fn()`` over ``calls`` back-to-back
    calls, of ``bursts`` bursts, the stream held busy meanwhile so no call
    waits on the device: the issue cost, with less of a shared host's noise
    than the median of single calls (``host_us``)."""
    best = float("inf")
    for _ in range(bursts):
        torch.cuda.synchronize()
        torch.cuda._sleep(int(calls * 300 * timer.cycles_per_us))
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, 1e6 * (time.perf_counter() - t0) / calls)
    torch.cuda.synchronize()
    return best


def digest(*ts) -> str:
    """SHA-256 of the tensors' bytes, in order."""
    h = hashlib.sha256()
    for t in ts:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def ivf_screen_select_case(torch, timer, gen, out: dict, args) -> None:
    from chip_smoke import FP32_FLOPS, bound_ms, int_valued, nbytes, values_close
    from repro_torch.kernels import decode_fused as kdf
    from repro_torch.kernels import ivf_gather_score as kigs
    from repro_torch.kernels import ref

    n, n_c, cap, d, n_probe, o_cap, k = 32000, 178, 544, 2048, 8, 2000, 576
    mv = int_valued(torch, gen, (n_c, cap, d))
    fill = torch.rand((n_c, cap), generator=gen, device="cuda")
    mids = torch.randint(0, n, (n_c, cap), generator=gen, device="cuda",
                         dtype=torch.int32)
    mids = torch.where(fill < n / (n_c * cap), mids, torch.full_like(mids, -1))
    o_ids = torch.randint(0, n, (o_cap,), generator=gen, device="cuda",
                          dtype=torch.int32)
    o_ids[torch.rand((o_cap,), generator=gen, device="cuda") < 0.5] = -1
    pop = 1.0 / torch.arange(1, n_c + 1, device="cuda", dtype=torch.float32)
    perm = torch.randperm(n_c, generator=gen, device="cuda")
    shapes = [("b4", 4, "uniform"), ("b4_sort_only", 4, "uniform"),
              ("b256", 256, "uniform"), ("b256_skewed", 256, "skewed"),
              ("b256_shared", 256, "shared"),
              ("b256_sort_only", 256, "uniform")]
    for name, b, kind in shapes:
        if b == 256 and kind == "uniform" and name == "b256":
            mv.normal_(generator=gen)  # random fp32 rows from here on
        if kind == "skewed":
            probe = perm[torch.multinomial(pop.expand(b, -1), n_probe,
                                           generator=gen)].int()
        elif kind == "shared":
            probe = torch.randperm(n_c, generator=gen, device="cuda")[
                :n_probe].int().expand(b, -1).clone()
            probe[:, -1] = torch.randint(0, n_c, (b,), generator=gen,
                                         device="cuda", dtype=torch.int32)
        else:
            probe = torch.stack([torch.randperm(n_c, generator=gen,
                                                device="cuda")[:n_probe]
                                 for _ in range(b)]).int()
        if b == 4:
            qv = int_valued(torch, gen, (b, d))
            o_sc = int_valued(torch, gen, (b, o_cap), -200, 200)
        else:
            qv = torch.randn((b, d), generator=gen, device="cuda")
            o_sc = torch.randn((b, o_cap), generator=gen, device="cuda") * 30
        width = None
        if name.endswith("sort_only"):
            width = torch.zeros((b,), dtype=torch.int32, device="cuda")
        call = (mv, mids, o_sc, o_ids, probe, qv)
        got_v, got_i = kdf.ivf_screen_select(*call, k=k, probe_width=width)
        again_v, again_i = kdf.ivf_screen_select(*call, k=k,
                                                 probe_width=width)
        want_v, want_i = ref.ivf_screen_select_ref(*call, k,
                                                   probe_width=width)
        torch.cuda.synchronize()
        if b == 4 and not (torch.equal(got_v, want_v)
                           and torch.equal(got_i, want_i)):
            raise SystemExit(f"ivf_screen_select {name} disagrees with its "
                             "plain version on small-integer rows")
        if not values_close(torch, got_v, want_v, scaled=True):
            raise SystemExit(f"ivf_screen_select {name} disagrees with its "
                             "plain version")
        del want_v, want_i
        if width is None:  # the unfused kernel probe + top-k, bit for bit
            s, i = kigs.ivf_gather_score(mv, mids, probe, qv)
            pool_s = torch.cat([s.reshape(b, -1), o_sc], 1)
            pool_i = torch.cat([i.reshape(b, -1), o_ids[None].expand(b, -1)],
                               1)
            pool_s = torch.where(pool_i >= 0, pool_s, float("-inf"))
            wv, wi = ref.topk_select_ref(pool_s, pool_i, k)
            if not (torch.equal(got_v, wv) and torch.equal(got_i, wi)):
                raise SystemExit(f"ivf_screen_select {name} != "
                                 "ivf_gather_score + top-k")
            del s, i, pool_s, pool_i
        uniq = torch.unique(probe) if width is None else probe[:, :0]
        live_rows = 0 if width is not None else int(
            (mids[probe.long()] >= 0).sum().item())
        live_uniq = int((mids[uniq.long()] >= 0).sum().item())
        fn = (lambda: kdf.ivf_screen_select(*call, k=k, probe_width=width))
        ms, host = timer.both(fn, f"ivf_screen_select {name}")
        first = digest(got_v, got_i)
        out[f"ivf_screen_select_{name}"] = {
            "ms": ms, "host_us": host, "distinct_clusters": uniq.numel(),
            "live_rows": live_rows, "digest": first,
            "repeatable": first == digest(again_v, again_i),
            "kernels_us": kernel_breakdown(torch, timer, fn),
            "plain_ms": timer(lambda: ref.ivf_screen_select_ref(
                *call, k, probe_width=width),
                f"ivf_screen_select {name} plain"),
            "bound_ms": bound_ms(live_uniq * d * 4 + uniq.numel() * cap * 4
                                 + nbytes(o_sc, o_ids, probe, qv) + b * k * 8,
                                 2.0 * d * live_rows, FP32_FLOPS)[0]}
        torch.cuda.empty_cache()


def rerank_select_case(torch, timer, gen, out: dict, args) -> None:
    from chip_smoke import FP32_FLOPS, bound_ms, nbytes, values_close
    from repro_torch.kernels import decode_fused as kdf
    from repro_torch.kernels import ref

    # tinyllama's output embedding (32,000 x 2,048), r = 2k = 1,152
    # survivors a query, k = 576; ~2 % of the survivors dead (a -inf
    # screening value), as a screen over sparse clusters leaves
    n, d, r, k = 32000, 2048, 1152, 576
    db = torch.randn((n, d), generator=gen, device="cuda")
    pop = 1.0 / torch.arange(1, n + 1, device="cuda", dtype=torch.float32)
    perm = torch.randperm(n, generator=gen, device="cuda")
    shapes = [(f"b{b}", b, "uniform") for b in args.rerank_batches]
    if 256 in args.rerank_batches:
        shapes += [("b256_skewed", 256, "skewed"),
                   ("b256_shared", 256, "shared")]
    for name, b, kind in shapes:
        if kind == "skewed":
            cand = perm[torch.multinomial(pop.expand(b, -1), r,
                                          generator=gen)].int()
        elif kind == "shared":
            # near-identical queries: each one's survivors are the top r of
            # 3,000 popular rows under one shared score plus its own noise
            pool = perm[:3000]
            shared = torch.randn((3000,), generator=gen, device="cuda")
            noisy = shared + 0.3 * torch.randn((b, 3000), generator=gen,
                                               device="cuda")
            cand = pool[noisy.topk(r, dim=1).indices].int()
        else:
            cand = torch.rand((b, n), generator=gen,
                              device="cuda").argsort(1)[:, :r].int()
        lut_vals = torch.randn((b, r), generator=gen,
                               device="cuda").sort(1, descending=True)[0]
        lut_vals[:, 17::53] = float("-inf")
        q = torch.randn((b, d), generator=gen, device="cuda")
        args = (db, cand, lut_vals, q)
        got_v, got_i = kdf.rerank_select(*args, k=k)
        want_v, _ = ref.rerank_select_ref(*args, k)
        torch.cuda.synchronize()
        if not values_close(torch, got_v, want_v, scaled=True):
            raise SystemExit(f"rerank_select {name} disagrees with its plain "
                             "version")
        live = ~torch.isneginf(lut_vals)
        rows = torch.unique(cand[live]).numel()
        ms, host = timer.both(lambda: kdf.rerank_select(*args, k=k),
                              f"rerank_select {name}")
        out[f"rerank_select_{name}"] = {
            "ms": ms, "host_us": host, "distinct_rows": rows,
            "digest": digest(got_v, got_i),
            "kernels_us": kernel_breakdown(
                torch, timer, lambda: kdf.rerank_select(*args, k=k)),
            "plain_ms": timer(lambda: ref.rerank_select_ref(*args, k),
                              f"rerank_select {name} plain"),
            "bound_ms": bound_ms(rows * d * 4 + nbytes(cand, lut_vals, q)
                                 + b * k * 8,
                                 2.0 * d * int(live.sum().item()),
                                 FP32_FLOPS)[0]}


def fused_estimator_case(torch, timer, gen, out: dict, args) -> None:
    from chip_smoke import FP32_FLOPS, bound_ms, estimator_inputs, nbytes
    from repro_torch.kernels import fused_estimator as kfe
    from repro_torch.kernels import ref

    # (name, n, d, t, k, S) — tinyllama's head chunk on five input sets,
    # then the other paths' shapes: the paper's ImageNet and word-embedding
    # tables (S distinct per query), Algorithm 3 on the ImageNet bench
    # table and structured search's amortized log Z (S from a popular head)
    shapes = [("popular", 32000, 2048, 256, 576, "popular"),
              ("uniform", 32000, 2048, 256, 576, "uniform"),
              ("shared", 32000, 2048, 256, 576, "shared"),
              ("t_only", 32000, 2048, 256, 576, "popular"),
              ("s_only", 32000, 2048, 256, 576, "popular"),
              ("imagenet", 1281167, 256, 64, 3456, "uniform"),
              ("word", 2000126, 300, 32, 4352, "uniform"),
              ("alg3", 160000, 256, 64, 1216, "popular"),
              ("structured", 32000, 2048, 4, 64, "popular")]
    route = getattr(kfe, "route", None)  # absent in trees before the rule
    for name, n, d, t, k, kind in shapes:
        emb, ids, h, log_w = estimator_inputs(torch, gen, n, d, t, k, kind)
        if name == "t_only":  # every S slot dead: the tail draws alone
            log_w[:, :k] = float("-inf")
        elif name == "s_only":  # every T slot dead: the popular S alone
            log_w[:, k:] = float("-inf")
        call = (emb, ids, h, log_w)
        got_z, got_v = kfe.fused_estimator(*call)
        again_z, again_v = kfe.fused_estimator(*call)
        want_z, want_v = ref.fused_estimator_ref(*call)
        torch.cuda.synchronize()
        live = torch.isfinite(log_w)
        tok = live.any(1)
        err = max((got_z - want_z)[tok].abs().max().item(),
                  (got_v - want_v)[tok].abs().max().item())
        del want_z, want_v
        rows = torch.unique(ids[live]).numel()
        ms, host = timer.both(lambda: kfe.fused_estimator(*call),
                              f"fused_estimator {name}")
        first = digest(got_z, got_v)
        out[f"fused_estimator_{name}"] = {
            "ms": ms, "host_us": host, "distinct_rows": rows,
            "shape": [t, 2 * k, d, n], "s_ids": kind,
            "route": route(n, d, t, 2 * k) if route else None,
            "max_abs_err": err, "digest": first,
            "repeatable": first == digest(again_z, again_v),
            "kernels_us": kernel_breakdown(
                torch, timer, lambda: kfe.fused_estimator(*call)),
            "y_ms": timer(lambda: kfe.fused_estimator(*call, return_y=True),
                          f"fused_estimator {name} y"),
            "plain_ms": timer(lambda: ref.fused_estimator_ref(*call),
                              f"fused_estimator {name} plain"),
            "bound_ms": bound_ms(rows * d * 4 + nbytes(ids, log_w, h)
                                 + t * 4 + t * d * 4,
                                 4.0 * d * int(live.sum().item()),
                                 FP32_FLOPS)[0]}
        del emb, ids, h, log_w, call
        torch.cuda.empty_cache()


def fused_estimator_bwd_case(torch, timer, gen, out: dict, args) -> None:
    import inspect

    from chip_smoke import FP32_FLOPS, bound_ms, estimator_inputs, nbytes
    from repro_torch.kernels import fused_estimator as kfe
    from repro_torch.kernels import ref

    # a tree whose backward takes the forward's scores (``y=``) gets them
    # from the forward, as the training path does; an older one recomputes
    from_y = "y" in inspect.signature(kfe.fused_estimator_bwd).parameters
    n, d, t, k = 32000, 2048, 256, 576
    for kind in ("popular", "uniform", "shared"):
        emb, ids, h, log_w = estimator_inputs(torch, gen, n, d, t, k, kind)
        gvec = 0.5 + torch.rand((t,), generator=gen, device="cuda")
        live_tok = torch.isfinite(log_w).any(1)  # the all-dead token out
        fargs = (emb, ids[live_tok], h[live_tok], log_w[live_tok])
        g = gvec[live_tok]
        if from_y:
            log_z, _, y = kfe.fused_estimator(*fargs, return_y=True)
            kw = {"y": y}
        else:
            log_z, _ = kfe.fused_estimator(*fargs)
            kw = {}
        bargs = (*fargs, log_z, g)

        def bwd():
            return kfe.fused_estimator_bwd(*bargs, **kw)

        def path():  # the checkpoint's recomputed forward, then the backward
            if from_y:
                lz, _, yy = kfe.fused_estimator(*fargs, return_y=True)
                return kfe.fused_estimator_bwd(*fargs, lz, g, y=yy)
            lz, _ = kfe.fused_estimator(*fargs)
            return kfe.fused_estimator_bwd(*fargs, lz, g)

        got_d, got_p = bwd()
        again_d, again_p = bwd()
        want_d, want_p = ref.fused_estimator_bwd_ref(*bargs)
        torch.cuda.synchronize()
        err = max((got_d - want_d).abs().max().item(),
                  (got_p - want_p).abs().max().item())
        del want_d, want_p
        live = torch.isfinite(fargs[3])
        tb = int(live_tok.sum().item())
        ms, host = timer.both(bwd, f"fused_estimator_bwd {kind}")
        first = digest(got_d, got_p)
        # bytes: ids, h, log_z, g and y (or log_w and each live distinct
        # row) in, the dense d_emb and p out; operations: p · h per live
        # pair, and where the tree recomputes y, its 2d dot too
        read = (nbytes(y) if from_y else nbytes(fargs[3])
                + torch.unique(fargs[1][live]).numel() * d * 4)
        out[f"fused_estimator_bwd_{kind}"] = {
            "ms": ms, "host_us": host, "from_y": from_y,
            "path_ms": timer(path, f"fused_estimator fwd+bwd {kind}"),
            "max_abs_err": err, "digest": first,
            "repeatable": first == digest(again_d, again_p),
            "kernels_us": kernel_breakdown(torch, timer, bwd, library=True),
            "plain_ms": timer(lambda: ref.fused_estimator_bwd_ref(*bargs, **kw),
                              f"fused_estimator_bwd {kind} plain"),
            "bound_ms": bound_ms(
                read + nbytes(fargs[1], fargs[2], log_z, g) + n * d * 4
                + tb * 2 * k * 4,
                (2.0 if from_y else 4.0) * d * int(live.sum().item()),
                FP32_FLOPS)[0]}
        del got_d, again_d
        torch.cuda.empty_cache()


def tail_gather_argmax_case(torch, timer, gen, out: dict, args) -> None:
    from chip_smoke import FP32_FLOPS, bound_ms, int_valued, nbytes, values_close
    from repro_torch.kernels import decode_fused as kdf
    from repro_torch.kernels import ref

    n, d, k, m_cap = 32000, 2048, 576, 728  # tinyllama's head, l = k
    emb = int_valued(torch, gen, (n, d))
    for name, t in (("b4", 4), ("b4_full", 4), ("b600", 600)):
        if name == "b4_full":
            emb.normal_(generator=gen)  # random fp32 rows from here on
        pos = torch.randint(0, n, (t, m_cap), generator=gen, device="cuda",
                            dtype=torch.int32)
        s_ids = torch.randint(0, n, (t, k), generator=gen, device="cuda",
                              dtype=torch.int32)
        if name == "b4":  # chip_smoke.py's tail inputs
            h = int_valued(torch, gen, (t, d))
            m_used = torch.randint(0, m_cap + 1, (t,), generator=gen,
                                   device="cuda", dtype=torch.int32)
            m_used[0], m_used[-1] = 0, m_cap
            pert_s = int_valued(torch, gen, (t, k), -300, 300)
            pert_s[:, ::7] = float("-inf")
            heights = int_valued(torch, gen, (t, m_cap), 0, 40) * 0.25
        else:  # y ~ N(0, d): S values and heights on its scale
            h = torch.randn((t, d), generator=gen, device="cuda")
            m_used = torch.randint(560, 600, (t,), generator=gen,
                                   device="cuda", dtype=torch.int32)
            pert_s = torch.randn((t, k), generator=gen, device="cuda") * 45
            heights = torch.rand((t, m_cap), generator=gen,
                                 device="cuda") * 90
        call = (emb, pos, m_used, pert_s, s_ids, heights, h)
        got_i, got_v = kdf.tail_gather_argmax(*call)
        again_i, again_v = kdf.tail_gather_argmax(*call)
        want_i, want_v = ref.tail_gather_argmax_ref(*call)
        torch.cuda.synchronize()
        if name == "b4" and not (torch.equal(got_i, want_i)
                                 and torch.equal(got_v, want_v)):
            raise SystemExit("tail_gather_argmax b4 disagrees with its plain "
                             "version on small-integer rows")
        if not values_close(torch, got_v, want_v, scaled=True):
            raise SystemExit(f"tail_gather_argmax {name} disagrees with its "
                             "plain version")
        live = torch.arange(m_cap, device="cuda")[None] < m_used[:, None]
        rows = torch.unique(pos[live]).numel()
        fn = (lambda: kdf.tail_gather_argmax(*call))
        ms, host = timer.both(fn, f"tail_gather_argmax {name}")
        burst = host_burst_us(torch, timer, fn)
        first = digest(got_i, got_v)
        out[f"tail_gather_argmax_{name}"] = {
            "ms": ms, "host_us": host, "host_burst_us": burst,
            "distinct_rows": rows, "digest": first,
            "repeatable": first == digest(again_i, again_v),
            "index_agrees_with_plain": float(
                (got_i == want_i).float().mean().item()),
            "kernels_us": kernel_breakdown(torch, timer, fn),
            "plain_ms": timer(lambda: ref.tail_gather_argmax_ref(*call),
                              f"tail_gather_argmax {name} plain"),
            "bound_ms": bound_ms(rows * d * 4 + nbytes(pos, m_used, pert_s,
                                                       s_ids, heights, h)
                                 + t * 8, 2.0 * d * int(m_used.sum().item()),
                                 FP32_FLOPS)[0]}
        torch.cuda.empty_cache()


def pq_head():
    """tinyllama's IVF-PQ head (the fields ``chip_smoke.pq_inputs`` reads)."""
    from chip_smoke import Geometry

    return Geometry(slots=4, max_seq=512, hq=32, hkv=4, hd=64, n=32000,
                    d=2048, n_c=178, cap=544, o_cap=2000, n_probe=8, k=576,
                    m_cap=728, m_sub=8, ksub=256, r=1152)


def pq_screen_select_case(torch, timer, gen, out: dict, args) -> None:
    from chip_smoke import FP32_FLOPS, bound_ms, nbytes, pq_inputs, values_close
    from repro_torch.kernels import decode_fused as kdf
    from repro_torch.kernels import pq_lut_score as kpls
    from repro_torch.kernels import ref

    g = pq_head()
    for name, b in (("b4", 4), ("b4_sort_only", 4), ("b256", 256),
                    ("b256_sort_only", 256)):
        call = pq_inputs(torch, gen, g, b, False)
        codes, mids, coarse, o_sc, o_ids, probe, lut = call
        width = None
        if name.endswith("sort_only"):
            width = torch.zeros((b,), dtype=torch.int32, device="cuda")
        got_v, got_i = kdf.pq_screen_select(*call, r=g.r, probe_width=width)
        again_v, again_i = kdf.pq_screen_select(*call, r=g.r,
                                                probe_width=width)
        want_v, _ = ref.pq_screen_select_ref(*call, g.r, probe_width=width)
        torch.cuda.synchronize()
        if not values_close(torch, got_v, want_v):
            raise SystemExit(f"pq_screen_select {name} disagrees with its "
                             "plain version")
        if width is None:  # the unfused kernel screen + top-r, bit for bit
            s2 = (kpls.pq_lut_score(codes, probe, lut)
                  + coarse[..., None]).reshape(b, -1)
            pool_i = torch.cat([mids[probe.long()].reshape(b, -1),
                                o_ids[None].expand(b, -1)], 1)
            pool_s = torch.where(pool_i >= 0, torch.cat([s2, o_sc], 1),
                                 float("-inf"))
            wv, wi = ref.topk_select_ref(pool_s, pool_i, g.r)
            if not (torch.equal(got_v, wv) and torch.equal(got_i, wi)):
                raise SystemExit(f"pq_screen_select {name} != pq_lut_score "
                                 "+ top-r")
        live = mids[probe.long()] >= 0
        tiles = torch.unique(probe) if width is None else probe[:, :0]
        live_slots = 0 if width is not None else torch.unique(
            (probe.long()[:, :, None] * g.cap
             + torch.arange(g.cap, device="cuda")[None, None, :])[live]
        ).numel()
        n_live = 0 if width is not None else int(live.sum().item())
        fn = (lambda: kdf.pq_screen_select(*call, r=g.r, probe_width=width))
        ms, host = timer.both(fn, f"pq_screen_select {name}")
        burst = host_burst_us(torch, timer, fn)
        first = digest(got_v, got_i)
        out[f"pq_screen_select_{name}"] = {
            "ms": ms, "host_us": host, "host_burst_us": burst,
            "digest": first,
            "repeatable": first == digest(again_v, again_i),
            "kernels_us": kernel_breakdown(torch, timer, fn),
            "plain_ms": timer(lambda: ref.pq_screen_select_ref(
                *call, g.r, probe_width=width), f"pq_screen_select {name} plain"),
            "bound_ms": bound_ms(tiles.numel() * g.cap * 4
                                 + live_slots * g.m_sub
                                 + nbytes(lut, coarse, probe, o_sc, o_ids)
                                 + b * g.r * 8,
                                 float(n_live * (g.m_sub + 1)), FP32_FLOPS)[0]}
        torch.cuda.empty_cache()


def pq_lut_score_case(torch, timer, gen, out: dict, args) -> None:
    from chip_smoke import FP32_FLOPS, bound_ms, nbytes, pq_inputs
    from repro_torch.kernels import pq_lut_score as kpls
    from repro_torch.kernels import ref

    g = pq_head()
    for name, b in (("b4", 4), ("b256", 256)):
        codes, _, _, _, _, probe, lut = pq_inputs(torch, gen, g, b, False)
        got = kpls.pq_lut_score(codes, probe, lut)
        again = kpls.pq_lut_score(codes, probe, lut)
        want = ref.pq_lut_score_ref(codes, probe, lut)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise SystemExit(f"pq_lut_score {name} differs from its plain "
                             "version")
        fn = (lambda: kpls.pq_lut_score(codes, probe, lut))
        ms, host = timer.both(fn, f"pq_lut_score {name}")
        burst = host_burst_us(torch, timer, fn)
        first = digest(got)
        pool = b * g.n_probe * g.cap
        out[f"pq_lut_score_{name}"] = {
            "ms": ms, "host_us": host, "host_burst_us": burst,
            "digest": first,
            "repeatable": first == digest(again),
            "kernels_us": kernel_breakdown(torch, timer, fn),
            "plain_ms": timer(lambda: ref.pq_lut_score_ref(codes, probe, lut),
                              f"pq_lut_score {name} plain"),
            "bound_ms": bound_ms(torch.unique(probe).numel() * g.cap * g.m_sub
                                 + nbytes(probe, lut) + pool * 4,
                                 float(pool * g.m_sub), FP32_FLOPS)[0]}
        torch.cuda.empty_cache()


def train_steps(torch, seed: int, steps_n: int) -> dict:
    """``steps_n`` training steps at ``chip_smoke.py``'s training
    configuration, each timed by the host clock and by CUDA events."""
    import statistics

    from chip_smoke import TRAIN_BATCH, TRAIN_OPT, TRAIN_SEQ
    from repro_torch.configs import get
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw

    cfg = get("tinyllama-1.1b").scaled(head_mips="ivf")
    model = Model(cfg, "bf16", device="cuda")
    params = model.init(seed)
    index = model.make_head_index(params)
    opt = adamw.init(params)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    batch = {k: torch.randint(0, cfg.vocab, (TRAIN_BATCH, TRAIN_SEQ),
                              generator=gen, device="cuda",
                              dtype=torch.int32)
             for k in ("tokens", "labels")}
    step = steps.make_train_step(
        model, steps.TrainConfig(opt=adamw.OptConfig(**TRAIN_OPT)))
    for _ in range(2):  # first-use costs out of the figures
        step(params, opt, batch, (seed, 0), index)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    wall, event = [], []
    for _ in range(steps_n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        step(params, opt, batch, (seed, 0), index)
        b.record()
        b.synchronize()
        wall.append(1e3 * (time.perf_counter() - t0))
        event.append(a.elapsed_time(b))
    return {"wall_ms": wall, "event_ms": event,
            "wall_ms_median": statistics.median(wall),
            "event_ms_median": statistics.median(event),
            "launches_a_step": {k: n // steps_n for k, n
                                in ops.launch_counts().items() if n}}


CASES = {"flash_decode": flash_decode_case,
         "ivf_gather_score": ivf_gather_score_case,
         "ivf_screen_select": ivf_screen_select_case,
         "rerank_select": rerank_select_case,
         "fused_estimator": fused_estimator_case,
         "fused_estimator_bwd": fused_estimator_bwd_case,
         "tail_gather_argmax": tail_gather_argmax_case,
         "pq_screen_select": pq_screen_select_case,
         "pq_lut_score": pq_lut_score_case}


if __name__ == "__main__":
    sys.exit(main())
