"""The plain reference of the paper's log-linear setting (Mussmann, Levy &
Ermon 2017, Algorithms 2 and 3 over an IVF index): plain PyTorch, imports
nothing of the program under test.

Every function takes a precision ``prec``: ``"fp64"`` is the reference
proper, which judges the program; ``"tf32"`` is the control, the same
arithmetic with each matmul operand rounded to TF32's 10 mantissa bits and
accumulated in float32, which is what a float32 matmul on the tensor cores
computes. The control takes the program's place in ``--control 1`` runs and
must come out as not correct (the configurations state float32 with TF32
off).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from bench.reference import philox


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to nearest (ties to even) at 10 mantissa
    bits."""
    i = x.float().contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & -8192
    return i.view(torch.float32)


def cast(x: torch.Tensor, prec: str) -> torch.Tensor:
    if prec == "fp64":
        return x.double()
    if prec == "tf32":
        return tf32(x)
    raise ValueError(f"unknown precision {prec!r}")


def mm(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    """``a @ b`` at ``prec`` (float32 accumulation for tf32: TF32 is never
    applied twice, the operands are already rounded)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    return cast(a, prec) @ cast(b, prec)


def rows_dot(db: torch.Tensor, ids: torch.Tensor, q: torch.Tensor,
             prec: str, block_bytes: int = 1 << 30) -> torch.Tensor:
    """(b, m) scores ``db[ids[i, j]] · q[i]`` at ``prec``, gathered in query
    blocks of at most ``block_bytes``."""
    b, m = ids.shape
    d = db.shape[1]
    el = 8 if prec == "fp64" else 4
    step = max(1, block_bytes // max(1, m * d * el))
    out = []
    for i in range(0, b, step):
        rows = cast(db[ids[i:i + step].clamp(0, db.shape[0] - 1)], prec)
        out.append(torch.bmm(rows, cast(q[i:i + step], prec)[:, :, None])
                   [..., 0])
    return torch.cat(out)


def top_k(scores: torch.Tensor, k: int):
    """Descending top-k, the lower index first among equal values."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


# ------------------------------------------------------------------ IVF
class Index(NamedTuple):
    """An IVF index over the table: centroids (n_c, d) f32, member ids
    (n_c, cap) int32 (-1 pads), member rows (n_c, cap, d), overflow ids
    (o_cap,) int32 and rows, and the rows that fit neither (0: exact)."""

    centroids: torch.Tensor
    member_ids: torch.Tensor
    member_vecs: torch.Tensor
    overflow_ids: torch.Tensor
    overflow_vecs: torch.Tensor
    spill_count: int


def geometry(n: int, icfg: dict) -> tuple[int, int, int]:
    """(clusters, padded capacity, overflow slots) of the configuration's
    IVF index over n rows."""
    n_c = min(icfg["n_clusters"], n)
    cap = max(8, int(math.ceil(icfg["cap_factor"] * n / n_c / 8.0)) * 8)
    o_cap = max(8, int(math.ceil(icfg["overflow_frac"] * n / 8.0)) * 8)
    return n_c, cap, o_cap


def init_centroids(db: torch.Tensor, n_c: int, seed: int) -> torch.Tensor:
    """The cold start: ``n_c`` rows drawn by a seeded ``randperm`` on the
    table's device."""
    gen = torch.Generator(device=db.device)
    gen.manual_seed(seed)
    rows = torch.randperm(db.shape[0], generator=gen, device=db.device)[:n_c]
    return db[rows].float()


def distances(db: torch.Tensor, cent: torch.Tensor, prec: str,
              block_rows: int = 1 << 17):
    """Yields (row offset, (rows, n_c) ``|c|² - 2 x·c``) at ``prec`` over
    row blocks (the |x|² term is the same for every centroid)."""
    c = cast(cent, prec)
    sq = (c * c).sum(-1)
    for r0 in range(0, db.shape[0], block_rows):
        yield r0, sq[None, :] - 2.0 * mm(db[r0:r0 + block_rows], cent.T,
                                         prec)


def assign(db: torch.Tensor, cent: torch.Tensor, prec: str) -> torch.Tensor:
    """Nearest centroid of every row (the first among equals)."""
    return torch.cat([torch.argmin(dist, dim=1)
                      for _, dist in distances(db, cent, prec)])


def lloyd(db: torch.Tensor, cent: torch.Tensor, iters: int,
          prec: str) -> torch.Tensor:
    """``iters`` Lloyd iterations; an empty cluster keeps its centroid."""
    acc = torch.float64 if prec == "fp64" else torch.float32
    x = db.to(acc)
    cent = cent.to(acc)
    for _ in range(iters):
        a = assign(db, cent, prec)
        sums = torch.zeros_like(cent).index_add_(0, a, x)
        counts = torch.bincount(a, minlength=cent.shape[0]).to(acc)
        cent = torch.where(counts[:, None] > 0,
                           sums / counts.clamp(min=1.0)[:, None], cent)
    return cent.float()


def pack(a: torch.Tensor, n_c: int, cap: int, o_cap: int):
    """Rows sorted stably by cluster; a row's rank in its cluster below
    ``cap`` picks its member slot, the rest go to the overflow in sorted
    order, and rows past the overflow are counted as spilled."""
    n = a.shape[0]
    order = torch.argsort(a, stable=True)
    sa = a[order]
    counts = torch.bincount(a, minlength=n_c)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(n, device=a.device) - starts[sa]
    inside = rank < cap
    member = torch.full((n_c * cap,), -1, dtype=torch.int32, device=a.device)
    member[(sa * cap + rank)[inside]] = order[inside].int()
    over = order[~inside].int()
    overflow = torch.full((o_cap,), -1, dtype=torch.int32, device=a.device)
    overflow[:min(o_cap, over.numel())] = over[:o_cap]
    return (member.reshape(n_c, cap), overflow,
            max(0, over.numel() - o_cap))


def gather_rows(db: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    out = db[ids.long().clamp(min=0)]
    out[ids < 0] = 0
    return out


def build_index(db: torch.Tensor, icfg: dict, prec: str) -> Index:
    """The configuration's IVF index: Lloyd from the seeded row sample,
    each row packed into its nearest centroid's cluster."""
    n_c, cap, o_cap = geometry(db.shape[0], icfg)
    cent = lloyd(db, init_centroids(db, n_c, icfg["seed"]),
                 icfg["kmeans_iters"], prec)
    member, overflow, spill = pack(assign(db, cent, prec), n_c, cap, o_cap)
    return Index(cent, member, gather_rows(db, member), overflow,
                 gather_rows(db, overflow), spill)


def probe_topk(index: Index, q: torch.Tensor, k: int, n_probe: int,
               prec: str, block: int = 16):
    """The IVF top-k of queries ``q (b, d)`` -> (ids (b, k) int64, values
    (b, k) f32; dead slots id -1, -inf): the members of the ``n_probe``
    best-scoring clusters and the overflow, scored at ``prec``."""
    _, probe = top_k(mm(q, index.centroids.T, prec), n_probe)
    o_ids = index.overflow_ids.long()
    o_sc = mm(q, index.overflow_vecs.T, prec)
    ids_out, vals_out = [], []
    for i in range(0, q.shape[0], block):
        p = probe[i:i + block]
        m_ids = index.member_ids[p].reshape(p.shape[0], -1).long()
        sc = rows_dot(index.member_vecs.reshape(-1, q.shape[1]),
                      (p[:, :, None] * index.member_ids.shape[1]
                       + torch.arange(index.member_ids.shape[1],
                                      device=q.device)).reshape(
                          p.shape[0], -1), q[i:i + block], prec)
        ids = torch.cat([m_ids, o_ids[None].expand(p.shape[0], -1)], 1)
        sc = torch.cat([sc, o_sc[i:i + block]], 1).float()
        sc = torch.where(ids >= 0, sc, torch.full_like(sc, -math.inf))
        v, pos = top_k(sc, k)
        ids_out.append(torch.where(torch.isneginf(v), -1,
                                   torch.gather(ids, 1, pos)))
        vals_out.append(v)
    return torch.cat(ids_out), torch.cat(vals_out)


# ------------------------------------------------------- Algorithms 2, 3
def sanitize(ids: torch.Tensor, vals: torch.Tensor, n: int):
    """Dead S slots (-inf) -> distinct virtual ids n + slot, which exclude
    nothing; (ids, live count)."""
    live = ~torch.isneginf(vals)
    virt = n + torch.arange(ids.shape[1], device=ids.device)[None, :]
    return torch.where(live, ids.long(), virt), live.sum(1)


def complement_map(u: torch.Tensor, s_sorted: torch.Tensor) -> torch.Tensor:
    """The (u+1)-th smallest element of [0, n) outside the sorted S."""
    k = s_sorted.shape[-1]
    t = (s_sorted.long() - torch.arange(k, device=s_sorted.device)
         ).contiguous()
    return u + torch.searchsorted(t, u.long().contiguous(), right=True)


class Draws(NamedTuple):
    g_s: torch.Tensor  # (b, k) f64 Gumbels of S's slots
    m: torch.Tensor  # (b,) int64 Poisson(l) count, m_cap + 1 = overflow
    pos: torch.Tensor  # (b, m_cap) int64 tail rows
    exp: torch.Tensor  # (b, m_cap) f64 Exp(1) height excesses


def tail_draws(keys: torch.Tensor, ids_clean: torch.Tensor,
               kv: torch.Tensor, n: int, l: int, m_cap: int) -> Draws:
    """Algorithm 2's random numbers of each query, from its key row."""
    hi = torch.clamp(n - kv, min=1)
    u = philox.uniform_int(keys, m_cap, hi, philox.STREAM_COMPLEMENT)
    pos = complement_map(u, torch.sort(ids_clean, dim=1).values)
    return Draws(philox.gumbel(keys, ids_clean.shape[1],
                               philox.STREAM_GUMBEL_S),
                 philox.poisson_count(keys, float(l), m_cap,
                                      philox.STREAM_POISSON),
                 pos, philox.exponential(keys, m_cap,
                                         philox.STREAM_HEIGHTS))


class Sample(NamedTuple):
    index: torch.Tensor  # (b,) int64 sampled row
    ok: torch.Tensor  # (b,) bool certificate holds
    m: torch.Tensor  # (b,) int64 tail atoms used
    max_val: torch.Tensor  # (b,) winning perturbed value
    bound: torch.Tensor  # (b,) S_min + B
    overflow: torch.Tensor  # (b,) bool


def sample_parts(s_ids, s_y, kv, draws: Draws, y_tail, n: int, l: int,
                 m_cap: int):
    """Algorithm 2 with c = 0 from S's ids (sanitized) and scores, the
    draws and the tail scores -> (Sample, perturbed values (b, k + m_cap),
    candidate ids (b, k + m_cap))."""
    b = torch.log((float(n) - kv.double()) / l)
    m_used = torch.clamp(draws.m, max=m_cap)
    live = (torch.arange(m_cap, device=y_tail.device)[None, :]
            < m_used[:, None])
    pert_s = s_y.double() + draws.g_s
    pert_t = torch.where(live, y_tail.double() + b[:, None] + draws.exp,
                         torch.full_like(draws.exp, -math.inf))
    pert = torch.cat([pert_s, pert_t], 1)
    ids = torch.cat([s_ids, draws.pos], 1)
    best = torch.argmax(pert, dim=1, keepdim=True)
    max_val = torch.gather(pert, 1, best)[:, 0]
    s_min = torch.where(torch.isneginf(s_y.double()),
                        torch.full_like(pert_s, math.inf),
                        s_y.double()).amin(1)
    bound = s_min + b
    overflow = draws.m > m_cap
    ok = (max_val >= bound) & ~overflow
    return (Sample(torch.gather(ids, 1, best)[:, 0], ok, m_used, max_val,
                   bound, overflow), pert, ids)


def sample(db, q, s_ids, s_vals, keys, n: int, l: int, m_cap: int,
           prec: str) -> Sample:
    """Algorithm 2 for queries ``q`` given their top-k S; S's values as
    given, the tail scored at ``prec``."""
    ids_clean, kv = sanitize(s_ids, s_vals, n)
    draws = tail_draws(keys, ids_clean, kv, n, l, m_cap)
    y_tail = rows_dot(db, draws.pos, q, prec)
    return sample_parts(ids_clean, s_vals, kv, draws, y_tail, n, l,
                        m_cap)[0]


def logz_candidates(keys, s_ids, s_vals, n: int, l: int):
    """Algorithm 3's S ∪ T: (ids (b, k + l), log-weights (b, k + l) f64)."""
    ids_clean, kv = sanitize(s_ids, s_vals, n)
    hi = torch.clamp(n - kv, min=1)
    u = philox.uniform_int(keys, l, hi, philox.STREAM_COMPLEMENT)
    tail = complement_map(u, torch.sort(ids_clean, dim=1).values)
    tail_n = float(n) - kv.double()
    w_t = torch.where(tail_n > 0, torch.log(tail_n.clamp(min=1.0) / l),
                      torch.full_like(tail_n, -math.inf))
    w_s = torch.where(torch.isneginf(s_vals),
                      torch.full_like(s_vals, -math.inf, dtype=torch.float64),
                      torch.zeros_like(s_vals, dtype=torch.float64))
    ids = torch.cat([s_ids.long().clamp(min=0), tail], 1)
    return ids, torch.cat([w_s, w_t[:, None].expand(-1, l)], 1)


def logz(db, q, s_ids, s_vals, keys, n: int, l: int, prec: str
         ) -> torch.Tensor:
    """Algorithm 3's stratified log Ẑ, candidates scored at ``prec``."""
    ids, log_w = logz_candidates(keys, s_ids, s_vals, n, l)
    y = rows_dot(db, ids.clamp(max=n - 1), q, prec).double()
    return torch.logsumexp(y + log_w, dim=1)
