"""Workloads launcher for the PyTorch port (counterpart of
``repro/launch/workloads.py``): the three estimator-core clients end to
end, on CUDA unless ``--device`` says otherwise.

  # deep-kNN over trunk activation taps (conformal credibility in JSON)
  PYTHONPATH=src python -m repro_torch.launch.workloads dknn \\
      --arch tinyllama-1.1b --mips ivf --classes 4 --train 256 --test 64

  # perturb-and-MAP structured inference (MAP / stochastic beam search)
  PYTHONPATH=src python -m repro_torch.launch.workloads structured \\
      --arch tinyllama-1.1b --mode sbs --beams 4 --horizon 8 --mips exact

  # log-Z estimator head-to-head: Algorithm 3 vs the unbiased LSH sampler
  PYTHONPATH=src python -m repro_torch.launch.workloads estimator \\
      --n 8192 --d 64 --queries 8 --tables 32 --bits 6

Flags and JSON fields are the reference launcher's, plus ``--device``.
Weights are random, drawn from seed 0. The dknn task is synthetic band
classification: class ``c`` emits tokens from the ``c``-th vocab band, and
the model's mean-pooled taps (untrained: the token embeddings suffice)
separate the bands. The estimator's clustered table and θ queries are made
on the device by a ``torch.Generator`` seeded from ``--seed``.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCHS, get, get_smoke
from repro_torch.core import estimators as est
from repro_torch.core import mips
from repro_torch.models.model import Model
from repro_torch.workloads import dknn, structured

_MIPS = ("exact", "ivf", "ivfpq", "lsh")
TAPS_BATCH = 64  # examples per trunk_taps call


def index_cfg(name: str, *, n_probe: int = 16):
    """CLI backend name -> mips config dataclass (the backend selector)."""
    if name == "exact":
        return mips.ExactConfig()
    if name == "ivf":
        return mips.IVFConfig(n_probe=n_probe)
    if name == "ivfpq":
        return mips.PQConfig(n_probe=n_probe, m_sub=4)
    if name == "lsh":
        return mips.LSHConfig()
    raise ValueError(name)


def band_batches(cfg, n: int, n_classes: int, seq: int, rng, band: int = 16
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Synthetic band classification: label c draws tokens from a narrow
    c-specific vocab band, plus 20 % uniform noise. Returns (tokens (n,
    seq), labels (n,)) int64."""
    band = min(band, cfg.vocab // n_classes)
    stride = cfg.vocab // n_classes
    labels = rng.integers(0, n_classes, size=n)
    toks = labels[:, None] * stride + rng.integers(0, band, size=(n, seq))
    noise = rng.integers(0, cfg.vocab, size=(n, seq))
    toks = np.where(rng.random((n, seq)) < 0.2, noise, toks)
    return toks.astype(np.int64), labels.astype(np.int64)


@torch.no_grad()
def taps(model: Model, params, toks: np.ndarray) -> torch.Tensor:
    """(n_taps, n, d) mean-pooled trunk taps of ``toks``, ``TAPS_BATCH``
    examples a call."""
    dev = model.device
    parts = [model.trunk_taps(params, {"tokens": torch.from_numpy(
        toks[i:i + TAPS_BATCH]).to(dev)})
        for i in range(0, toks.shape[0], TAPS_BATCH)]
    return torch.cat(parts, dim=1)


def _model(args):
    cfg = get_smoke(args.arch) if args.smoke else get(args.arch)
    if args.vocab:
        cfg = cfg.scaled(vocab=args.vocab)
    model = Model(cfg, device=args.device)
    return cfg, model, model.init(0)


def run_dknn(args) -> dict:
    cfg, model, params = _model(args)
    rng = np.random.default_rng(args.seed)

    def reps(n):
        toks, labels = band_batches(cfg, n, args.classes, args.seq, rng)
        return taps(model, params, toks), torch.from_numpy(labels)

    train_reps, train_labels = reps(args.train)
    cal_reps, cal_labels = reps(args.cal)
    test_reps, test_labels = reps(args.test)
    dcfg = dknn.DKNNConfig(n_classes=args.classes, k=args.k,
                           index_cfg=index_cfg(args.mips))
    state = dknn.fit(train_reps, train_labels, cal_reps, cal_labels, dcfg)
    res = dknn.classify(state, dknn.normalize_reps(test_reps), dcfg)
    acc = float((res.pred.cpu() == test_labels).float().mean())
    p = res.p_values
    return {
        "workload": "dknn",
        "mips": args.mips,
        "n_taps": int(train_reps.shape[0]),
        "classes": args.classes,
        "k": args.k,
        "accuracy": round(acc, 4),
        "credibility_mean": round(float(res.credibility.mean()), 4),
        "confidence_mean": round(float(res.confidence.mean()), 4),
        "credibility_p10": round(float(np.percentile(
            res.credibility.cpu().numpy(), 10)), 4),
        "p_value_spread": round(float(
            (p.amax(1) - p.amin(1)).mean()), 4),
    }


def run_structured(args) -> dict:
    cfg, model, params = _model(args)
    index = None
    if args.mips != "exact":
        emb = model._out_embed(params)[: cfg.vocab].float()
        index = mips.build_index(index_cfg(args.mips), emb)
    bcfg = structured.BeamConfig(
        n_beams=args.beams, horizon=args.horizon, expand_k=args.expand_k,
        l=args.l, mode=args.mode, logz=args.logz)
    rng = np.random.default_rng(args.seed)
    prompt = rng.integers(0, cfg.vocab, size=args.prompt_len)
    out = structured.search(model, params, prompt, args.seed, bcfg, index)
    toks = out.tokens.cpu().numpy()
    live = out.live.cpu().numpy()
    return {
        "workload": "structured",
        "mode": args.mode,
        "mips": args.mips,
        "beams": args.beams,
        "horizon": args.horizon,
        "tokens": toks[live].tolist(),
        "logp": [round(float(v), 4) for v in out.logp.cpu()],
        "gumbel": [round(float(v), 4) for v in out.gumbel.cpu()],
        "exact": out.exact.cpu().numpy().tolist(),
        "ok_rate": round(float(out.ok_rate), 4),
        "distinct": int(len({tuple(r) for r in toks})),
    }


def clustered_db(n: int, d: int, *, seed: int = 0, n_centers: int = 256,
                 device=None) -> torch.Tensor:
    """Unit-norm (n, d) rows around ``n_centers`` Gaussian centres with
    noise 0.5 (the reference benchmarks' clustered table), made on
    ``device`` by a ``torch.Generator`` seeded with ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    centers = torch.randn((n_centers, d), generator=gen, device=device)
    assign = torch.randint(0, n_centers, (n,), generator=gen, device=device)
    db = centers[assign] + 0.5 * torch.randn((n, d), generator=gen,
                                             device=device)
    return db / torch.linalg.norm(db, dim=1, keepdim=True)


def random_queries(db: torch.Tensor, num: int, *, temperature: float = 0.05,
                   seed: int = 1) -> torch.Tensor:
    """θ drawn uniformly from the table's rows, scaled by 1/τ (paper
    §4.1.2), by a ``torch.Generator`` on the table's device."""
    gen = torch.Generator(device=db.device)
    gen.manual_seed(seed)
    rows = torch.randint(0, db.shape[0], (num,), generator=gen,
                         device=db.device)
    return db[rows] / temperature


def estimator_head_to_head(db: torch.Tensor, h: torch.Tensor, *, k: int,
                           l: int, tables: int, bits: int, seed: int
                           ) -> dict:
    """Algorithm 3 and the LSH sampler (``bucket_cap = n``: lossless
    buckets) against the exact ``log Z`` of queries ``h`` over ``db``:
    their estimates, the exact values and the LSH index."""
    n = db.shape[0]
    exact = est.exact_logz(db, h)
    lidx = mips.build_index(mips.LSHConfig(n_tables=tables, n_bits=bits,
                                           bucket_cap=n), db)
    lsh = est.lsh_sampler_logz(lidx, h)
    topk = est.topk_probe(db, h, k)
    keys = torch.stack([torch.full((h.shape[0],), seed),
                        torch.arange(h.shape[0]),
                        torch.zeros(h.shape[0], dtype=torch.int64)],
                       dim=1).to(db.device)
    ids, log_w = est.amortized_candidates(topk, n, l, keys=keys)
    alg3 = est.stratified_logz(db, h, ids, log_w)
    return {"exact": exact, "lsh": lsh, "alg3": alg3, "index": lidx}


def run_estimator(args) -> dict:
    """One-shot log-Z head-to-head on a synthetic clustered problem."""
    dev = resolve_device(args.device)
    db = clustered_db(args.n, args.d, seed=args.seed, device=dev)
    h = random_queries(db, args.queries, seed=args.seed + 1)
    out = estimator_head_to_head(db, h, k=args.k, l=args.l,
                                 tables=args.tables, bits=args.bits,
                                 seed=args.seed)
    exact = out["exact"]

    def rmse(x):
        return float(torch.sqrt(torch.mean((x - exact) ** 2)))

    return {
        "workload": "estimator",
        "n": args.n,
        "queries": args.queries,
        "alg3_rmse": round(rmse(out["alg3"]), 6),
        "lsh_sampler_rmse": round(rmse(out["lsh"]), 6),
        "lsh_tables": args.tables,
        "lsh_bits": args.bits,
        "lsh_dropped": out["index"].dropped_count,
        "exact_logz_mean": round(float(exact.mean()), 4),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p, mips_flag: bool = True):
        if mips_flag:
            p.add_argument("--arch", default="tinyllama-1.1b",
                           choices=list(ARCHS))
            p.add_argument("--smoke", action="store_true", default=True)
            p.add_argument("--full", dest="smoke", action="store_false")
            p.add_argument("--mips", default="exact", choices=list(_MIPS))
            p.add_argument("--vocab", type=int, default=0)
        p.add_argument("--seed", type=int, default=0)
        p.add_argument("--device", default=None,
                       help="torch device (default: CUDA, which must exist)")

    d = sub.add_parser("dknn", help="deep-kNN conformal classification")
    common(d)
    d.add_argument("--classes", type=int, default=4)
    d.add_argument("--k", type=int, default=8)
    d.add_argument("--seq", type=int, default=16)
    d.add_argument("--train", type=int, default=256)
    d.add_argument("--cal", type=int, default=64)
    d.add_argument("--test", type=int, default=64)

    s = sub.add_parser("structured", help="perturb-and-MAP beam search")
    common(s)
    s.add_argument("--mode", default="sbs", choices=["sbs", "map"])
    s.add_argument("--logz", default="exact", choices=["exact", "amortized"])
    s.add_argument("--beams", type=int, default=4)
    s.add_argument("--horizon", type=int, default=8)
    s.add_argument("--expand-k", type=int, default=64)
    s.add_argument("--l", type=int, default=32)
    s.add_argument("--prompt-len", type=int, default=4)

    e = sub.add_parser("estimator", help="log-Z estimator head-to-head")
    common(e, mips_flag=False)
    e.add_argument("--n", type=int, default=8192)
    e.add_argument("--d", type=int, default=64)
    e.add_argument("--queries", type=int, default=8)
    e.add_argument("--k", type=int, default=128)
    e.add_argument("--l", type=int, default=128)
    e.add_argument("--tables", type=int, default=32)
    e.add_argument("--bits", type=int, default=6)

    args = ap.parse_args(argv)
    out = {"dknn": run_dknn, "structured": run_structured,
           "estimator": run_estimator}[args.cmd](args)
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
