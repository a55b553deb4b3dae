"""The comparison that decides ``correct``: the plain reference, in float64,
judges what the timed path produced. Imports nothing of the program.

Each judge returns, per number compared, its worst reading over the
checked queries (and per query, so failures can be counted). Where the
reference can only follow the program's own state (the index's centroids,
the top-k S that the sampler and the estimator start from), that state is
judged first, by :func:`index` and :func:`probe`.
"""
from __future__ import annotations

import math

import torch

from bench.reference import loglinear as ll

BIG = 1e30  # a reading for an answer that cannot be right at all
# centroid scores within this of the n_probe-th best may be probed either
# way: the program's float32 ranking of near-equal scores is not wrong
PROBE_TIE = 1e-4


def _finite(x: torch.Tensor) -> torch.Tensor:
    return torch.nan_to_num(x.double(), nan=BIG, posinf=BIG, neginf=BIG)


def row_clusters(member_ids: torch.Tensor, overflow_ids: torch.Tensor,
                 n: int):
    """(cluster of each row (n,): -2 for an overflow row, -1 for a row in
    no table; rows found more or less than once)."""
    dev = member_ids.device
    n_c, cap = member_ids.shape
    mids = member_ids.reshape(-1).long()
    oids = overflow_ids.long()
    live_m, live_o = mids >= 0, oids >= 0
    seen = torch.bincount(torch.cat([mids[live_m], oids[live_o]]),
                          minlength=n)[:n]
    bad = int((seen != 1).sum()) + int((mids >= n).sum() + (oids >= n).sum())
    rc = torch.full((n,), -1, dtype=torch.long, device=dev)
    cl = torch.arange(n_c, device=dev).repeat_interleave(cap)
    rc[mids[live_m & (mids < n)]] = cl[live_m & (mids < n)]
    rc[oids[live_o & (oids < n)]] = -2
    return rc, bad


def index(db: torch.Tensor, idx: ll.Index, icfg: dict, copy_faults: int
          ) -> tuple[dict, dict]:
    """Judge the index that set-up built -> (numbers, tables for the other
    judges and the work counts).

    * ``index_pack_faults``: rows in the member tables and the overflow
      other than exactly once, rows spilled, and ``copy_faults`` (member or
      overflow rows that are not the table's rows bit for bit, read before
      the program's state was freed);
    * ``index_assign_gap``: the largest float64 distance by which a row's
      cluster is farther than its nearest centroid (the index's own
      centroids); an overflow row is judged against the nearest full
      cluster.

    The centroids themselves are the program's: Lloyd's iterations on the
    card add in an order that changes from run to run, and a row that flips
    between two near-equal centroids moves both, so no second run (the
    reference's included) lands on the same centroids. How good they are
    is judged by ``topk_miss`` (the harness's share of each judged call's
    exact float64 top-k that the probe lost), which reads nothing of the
    program's state."""
    n = db.shape[0]
    n_c, cap, _ = ll.geometry(n, icfg)
    rc, bad = row_clusters(idx.member_ids, idx.overflow_ids, n)
    faults = bad + int(idx.spill_count) + int(copy_faults)
    counts = torch.bincount(rc[rc >= 0], minlength=n_c)
    full = counts >= cap
    gap = torch.zeros((), dtype=torch.float64, device=db.device)
    ref_assign = []
    for r0, dist in ll.distances(db, idx.centroids, "fp64"):
        best, arg = dist.min(1)
        ref_assign.append(arg)
        mine = rc[r0:r0 + dist.shape[0]]
        own = dist.gather(1, mine.clamp(min=0)[:, None])[:, 0]
        over = torch.where(full[None, :], dist,
                           torch.full_like(dist, math.inf)).amin(1)
        g = torch.where(mine >= 0, own - best,
                        torch.where(mine == -2, over - best,
                                    torch.zeros_like(best)))
        gap = torch.maximum(gap, _finite(g).max())
    numbers = {"index_pack_faults": float(faults),
               "index_assign_gap": float(gap)}
    # the reference's own packing around these centroids: the live rows a
    # probe of each cluster must read, for the work counts
    member, overflow, _ = ll.pack(torch.cat(ref_assign), n_c, cap,
                                  idx.overflow_ids.shape[0])
    tables = {"row_cluster": rc, "centroids": idx.centroids,
              "live_per_cluster": (member >= 0).sum(1),
              "overflow_live": int((overflow >= 0).sum())}
    return numbers, tables


def dense(db: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """(b, n) float64 scores of every row."""
    return ll.mm(q, db.T, "fp64")


def probe(y: torch.Tensor, q: torch.Tensor, ids: torch.Tensor,
          vals: torch.Tensor, tables: dict, n_probe: int
          ) -> dict[str, torch.Tensor]:
    """The top-k a probe returned, per query: ``topk_value_err``, its
    values against the float64 scores of its ids; ``topk_gap``, how far the
    best row of the probed clusters and the overflow that it left out lies
    above the worst row it kept (0 when it kept the top k; BIG when it
    returned a dead slot, a row twice, or a row outside every cluster it
    may probe)."""
    b = y.shape[0]
    ids = ids.long()
    dead = ids < 0
    safe = ids.clamp(min=0)
    y_p = y.gather(1, safe)
    err = torch.where(dead, torch.full_like(y_p, BIG),
                      (vals.double() - y_p).abs())
    cs = ll.mm(q, tables["centroids"].T, "fp64")
    srt = torch.sort(cs, dim=1, descending=True).values
    s_np = srt[:, n_probe - 1:n_probe]
    s_next = (srt[:, n_probe:n_probe + 1] if cs.shape[1] > n_probe
              else torch.full_like(s_np, -math.inf))
    must = cs > s_next + PROBE_TIE
    may = cs >= s_np - PROBE_TIE
    rc = tables["row_cluster"]
    rcb = rc.clamp(min=0)[None, :].expand(b, -1)
    pool = (must.gather(1, rcb) & (rc >= 0)) | (rc == -2)
    kept = torch.zeros_like(pool)
    kept.scatter_(1, safe, ~dead)
    left = torch.where(pool & ~kept, y, torch.full_like(y, -math.inf))
    worst = torch.where(dead, torch.full_like(y_p, math.inf), y_p).amin(1)
    gap = (left.amax(1) - worst).clamp(min=0)
    rc_p = rc[safe]
    allowed = ((may.gather(1, rc_p.clamp(min=0)) & (rc_p >= 0))
               | (rc_p == -2)) & ~dead
    srt_ids = torch.sort(ids, dim=1).values
    twice = (srt_ids[:, 1:] == srt_ids[:, :-1]).any(1)
    gap = torch.where(allowed.all(1) & ~twice, gap,
                      torch.full_like(gap, BIG))
    return {"topk_value_err": _finite(err.amax(1)),
            "topk_gap": _finite(gap)}


def lost(y: torch.Tensor, ids: torch.Tensor, k: int) -> torch.Tensor:
    """Per query, the share of the exact top-k (float64 scores of every
    row) that ``ids`` lost. A row within ``PROBE_TIE`` of the k-th score
    may be swapped for its neighbour by the program's float32 ranking and
    is not counted: what is counted is a row well inside the top-k that
    the index never offered."""
    top = torch.topk(y, k, dim=1)
    inside = top.values > top.values[:, -1:] + PROBE_TIE
    mark = torch.zeros(y.shape, dtype=torch.bool, device=y.device)
    ids = ids.long()
    mark.scatter_(1, ids.clamp(min=0), ids >= 0)
    return (inside & ~mark.gather(1, top.indices)).double().sum(1) / k


def sample(y: torch.Tensor, keys: torch.Tensor, s_ids: torch.Tensor,
           s_vals: torch.Tensor, out: dict, cfg: dict, ok_tol: float
           ) -> dict[str, torch.Tensor]:
    """The sample that the program returned, per query, against Algorithm 2
    redone in float64 from the same S and the same key row:
    ``sample_gap``, how far the program's row's perturbed value lies below
    the reference's winner (0 for the same row; BIG for a row that is no
    candidate); ``sample_value_err``, its winning value and bound against
    the reference's; ``sample_flag_faults``, a tail count, overflow or
    certificate that differs (the certificate only where the reference's
    winner clears its bound by more than ``ok_tol``)."""
    n, l, m_cap = cfg["n"], cfg["l"], cfg["m_cap"]
    ids_clean, kv = ll.sanitize(s_ids, s_vals, n)
    draws = ll.tail_draws(keys, ids_clean, kv, n, l, m_cap)
    y_s = torch.where(torch.isneginf(s_vals), torch.full_like(
        s_vals, -math.inf, dtype=torch.float64),
        y.gather(1, s_ids.long().clamp(min=0)))
    y_t = y.gather(1, draws.pos.clamp(max=n - 1))
    ref, pert, cand = ll.sample_parts(ids_clean, y_s, kv, draws, y_t, n, l,
                                      m_cap)
    idx = out["index"].long()
    mine = torch.where(cand == idx[:, None], pert,
                       torch.full_like(pert, -math.inf)).amax(1)
    gap = torch.where(torch.isneginf(mine), torch.full_like(mine, BIG),
                      ref.max_val - mine)
    err = torch.maximum((out["max_val"].double() - ref.max_val).abs(),
                        (out["bound"].double() - ref.bound).abs())
    flags = ((out["m"].long() != ref.m) | (out["overflow"].bool()
                                            != ref.overflow)
             | ((out["ok"].bool() != ref.ok)
                & ((ref.max_val - ref.bound).abs() > ok_tol)))
    return {"sample_gap": _finite(gap), "sample_value_err": _finite(err),
            "sample_flag_faults": flags.double()}


def logz(y: torch.Tensor, keys: torch.Tensor, s_ids: torch.Tensor,
         s_vals: torch.Tensor, out: dict, cfg: dict
         ) -> dict[str, torch.Tensor]:
    """``logz_err``: the program's log Ẑ against Algorithm 3 redone in
    float64 from the same S and key row; ``logz_abs_err``: against the
    exact log Z (an end-to-end metric, not a check)."""
    ids, log_w = ll.logz_candidates(keys, s_ids, s_vals, cfg["n"], cfg["l"])
    ref = torch.logsumexp(y.gather(1, ids.clamp(max=cfg["n"] - 1)) + log_w,
                          dim=1)
    got = out["log_z"].double()
    return {"logz_err": _finite((got - ref).abs()),
            "logz_abs_err": _finite((got - torch.logsumexp(y, 1)).abs())}
