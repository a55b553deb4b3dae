"""The work counts behind the roofline shares and call_mfu, against counts
made by hand on a tiny index."""
from __future__ import annotations

import math

import torch

from bench.reference import loglinear as ll
from bench.reference import work as W

PEAK = {"fp32_flops_per_s": 67e12, "hbm_bytes_per_s": 3.35e12}


def tables():
    return {"centroids": torch.tensor([[1.0, 0.0], [0.0, 1.0], [-1.0, 0.0]]),
            "live_per_cluster": torch.tensor([5, 3, 2]),
            "overflow_live": 1}


def test_probe_counts_by_hand():
    acc = {}
    q = torch.tensor([[1.0, 0.1], [0.1, 1.0]])
    W.probe(acc, q, tables(), n_probe=2)
    # both queries probe clusters 0 and 1: 5 + 3 distinct live rows, and
    # 8 live (query, member) pairs each
    rows, pairs, b, d = 8, 16, 2, 2
    assert acc["ivf_gather_score"] == (
        rows * (4 * d + 4) + b * 2 * 4 + b * d * 4 + pairs * 8,
        2.0 * d * pairs)
    # the whole probe adds the 3 centroids and the 1 live overflow row,
    # each scored by both queries
    assert acc["probe"] == (rows * (4 * d + 4) + 3 * d * 4 + 1 * (4 * d + 4)
                            + b * d * 4, 2.0 * d * (pairs + b * (3 + 1)))


def test_probe_counts_a_cluster_once():
    acc = {}
    W.probe(acc, torch.tensor([[1.0, 0.1], [1.0, 0.2], [0.9, 0.3]]),
            tables(), n_probe=1)
    assert acc["ivf_gather_score"][1] == 2.0 * 2 * 15  # 3 queries x 5 rows
    assert acc["ivf_gather_score"][0] == (5 * 12 + 3 * 4 + 3 * 8 + 15 * 8)


def draws_case(n=40, k=4, l=6, b=3):
    cfg = {"n": n, "l": l, "m_cap": int(l + 6 * math.sqrt(l) + 8)}
    keys = torch.stack([torch.full((b,), 2 ** 31 + 5), torch.arange(b),
                        torch.zeros(b, dtype=torch.long)], 1)
    s_ids = torch.tensor([[0, 1, 2, 3], [5, 9, 7, -1], [1, 3, 5, 7]])
    s_vals = torch.tensor([[3.0, 2.0, 1.0, 0.5], [2.0, 1.0, 0.0, -math.inf],
                           [1.0, 1.0, 1.0, 1.0]])
    return cfg, keys, s_ids, s_vals


def test_tail_counts_by_hand():
    cfg, keys, s_ids, s_vals = draws_case()
    acc = {}
    W.tail(acc, keys, s_ids, s_vals, cfg, d=8)
    ids_clean, kv = ll.sanitize(s_ids, s_vals, cfg["n"])
    dr = ll.tail_draws(keys, ids_clean, kv, cfg["n"], cfg["l"], cfg["m_cap"])
    rows, atoms = set(), 0
    for i in range(3):
        m = min(int(dr.m[i]), cfg["m_cap"])
        atoms += m
        rows |= set(dr.pos[i, :m].tolist())
        assert not set(dr.pos[i, :m].tolist()) & set(s_ids[i].tolist())
    assert acc["tail"] == (len(rows) * 4 * 8, 2.0 * 8 * atoms)


def test_estimator_counts_by_hand():
    cfg, keys, s_ids, s_vals = draws_case()
    acc = {}
    W.estimator(acc, keys, s_ids, s_vals, cfg, d=8)
    ids, log_w = ll.logz_candidates(keys, s_ids, s_vals, cfg["n"], cfg["l"])
    live = [(int(i), float(w)) for i, w in zip(ids.flatten(),
                                                log_w.flatten())
            if w > -math.inf]
    assert len(live) == 3 * (4 + 6) - 1  # one dead S slot
    rows = {i for i, _ in live}
    m = 4 + 6
    assert acc["fused_estimator"] == (
        len(rows) * 4 * 8 + 3 * m * 8 + 3 * 8 * 4 + 3 * 4,
        2.0 * 8 * len(live))


def test_least_time_and_the_bound_that_binds():
    assert W.least_s(3.35e12, 1.0, PEAK) == (1.0, "bytes")
    assert W.least_s(1.0, 2 * 67e12, PEAK) == (2.0, "flops")
    assert W.peaks("NVIDIA H100 80GB HBM3") == PEAK
    assert W.peaks("some other card") is None
