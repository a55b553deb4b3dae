"""SRP-LSH MIPS index (counterpart of ``repro/core/mips/lsh.py``) — the
paper's theory-side index (Theorems 2.1 / 3.6 run over it).

MIPS is reduced to maximum-cosine search by the Neyshabur & Srebro (2014)
norm completion: a database row gets the extra coordinate ``sqrt(M² -
|v|²)`` (M the largest norm), a query gets 0, after which inner-product
order is cosine order. Hashing is Charikar (2002) signed random
projections: ``n_bits`` hyperplanes per table, ``n_tables`` tables.

Buckets are padded member tables ``(n_tables, 2**n_bits, bucket_cap)``, as
the reference lays them out. The projections are drawn with numpy's
``default_rng(seed).standard_normal``, exactly as the reference draws them,
so both packages hash with the same hyperplanes. Hashing runs on the
index's device in fp32 (the package keeps TF32 off: one sign flip moves a
row to another bucket); rows are grouped by a stable sort, so the cap keeps
each bucket's lowest ids, and ``counts`` keeps the true, uncapped loads
(:attr:`LSHIndex.dropped_count`). ``refresh`` rehashes with the same
projections and cap, so every state tensor keeps its shape.

:meth:`LSHIndex.topk_batch` takes the union of the query's buckets over the
tables and scores each live candidate once: pads and repeated ids are
masked first, and only the surviving (query, row) pairs are gathered and
scored, in chunks, so the reference's ``(b, n_tables·cap, d+1)`` gather is
never built (:meth:`LSHIndex.score_candidates`, which the LSH sampler
shares, as it shares :func:`log_collision_prob`). The probe is plain PyTorch on every device, as it is XLA in
the reference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.gumbel import TopK
from repro_torch.core.mips import base

__all__ = ["LSHConfig", "LSHIndex", "LSHState", "default_bucket_cap"]

# elements of the (pairs, d+1) row gather scored at a time by topk_batch
_GATHER_ELEMS = 1 << 26


def default_bucket_cap(n: int, n_bits: int) -> int:
    """Padded per-bucket capacity ≈ 4x the expected load, rounded up to 8
    (the build default; the head sizes its buckets from it too)."""
    return max(8, int(math.ceil(4.0 * n / (2**n_bits) / 8.0)) * 8)


@dataclasses.dataclass(frozen=True)
class LSHConfig:
    n_tables: int = 8
    n_bits: int = 10
    bucket_cap: int | None = None  # None -> ~4x the expected bucket load
    seed: int = 0


class LSHState(NamedTuple):
    proj: torch.Tensor  # (n_tables, d+1, n_bits) f32 SRP hyperplanes
    table_ids: torch.Tensor  # (n_tables, 2**n_bits, cap) i32, -1 padded
    db_aug: torch.Tensor  # (n, d+1) f32 norm-completed rows (scoring)
    counts: torch.Tensor  # (n_tables, 2**n_bits) i32 TRUE bucket loads


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded fp32 square root on every device: the square root
    in fp64, rounded once to fp32 (a double rounding that is exact for
    square roots); the CPU's vectorized fp32 sqrt is off by an ulp at
    times."""
    return torch.sqrt(x.double()).float()


def _pairwise_sum(a: torch.Tensor) -> torch.Tensor:
    """Row sums of (n, m) fp32 in numpy's pairwise order (``add.reduce``
    over a contiguous axis: blocks of up to 128 summed by 8 strided
    accumulators, combined as a tree; longer rows split in halves)."""
    n, m = a.shape
    if m < 8:
        res = a.new_zeros(n)
        for i in range(m):
            res = res + a[:, i]
        return res
    if m <= 128:
        main = m - m % 8
        r = a[:, 0:8]
        for i in range(8, main, 8):
            r = r + a[:, i:i + 8]
        res = (((r[:, 0] + r[:, 1]) + (r[:, 2] + r[:, 3]))
               + ((r[:, 4] + r[:, 5]) + (r[:, 6] + r[:, 7])))
        for i in range(main, m):
            res = res + a[:, i]
        return res
    half = m // 2
    half -= half % 8
    return _pairwise_sum(a[:, :half]) + _pairwise_sum(a[:, half:])


def _augment(db: torch.Tensor) -> torch.Tensor:
    """(n, d) -> (n, d+1) norm-completed fp32 rows. The extra coordinate
    ``sqrt(M² - |x|²)`` cancels: an ulp of a row's norm moves it by
    percents. So the norms are summed in numpy's order and every root is
    correctly rounded, and the rows equal the reference's (numpy) bit for
    bit."""
    x = db.float()
    norms = _sqrt(_pairwise_sum(x * x))
    m_norm = float(norms.max()) + 1e-6
    m2 = torch.tensor(m_norm**2, dtype=torch.float32, device=x.device)
    aug = _sqrt(torch.clamp(m2 - norms * norms, min=0.0))
    return torch.cat([x, aug[:, None]], dim=1)


def _codes(x_aug: torch.Tensor, proj: torch.Tensor) -> torch.Tensor:
    """(n, d+1), (t, d+1, b) -> (t, n) int64 bucket codes: bit j set where
    the row lies on the non-negative side of hyperplane j."""
    bits = torch.einsum("nd,tdb->tnb", x_aug, proj) >= 0
    pows = 1 << torch.arange(proj.shape[2], device=x_aug.device)
    return (bits.long() * pows).sum(-1)


def _build_tables(db_aug: torch.Tensor, proj: torch.Tensor, bucket_cap: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(table_ids (t, 2**bits, cap) i32, counts (t, 2**bits) i32) on
    ``db_aug``'s device. Per table, a stable sort by code groups the rows in
    ascending id order inside each bucket; a row's rank there picks its
    slot, and rows past the cap are dropped from that table only (the
    other tables still cover them). ``counts`` are the uncapped loads."""
    n = db_aug.shape[0]
    t, _, n_bits = proj.shape
    nb = 2**n_bits
    dev = db_aug.device
    codes = _codes(db_aug, proj)  # (t, n)
    table = torch.arange(t, device=dev)[:, None]
    counts = torch.bincount((codes + table * nb).reshape(-1),
                            minlength=t * nb).reshape(t, nb)
    order = torch.argsort(codes, dim=1, stable=True)
    sc = torch.gather(codes, 1, order)
    starts = torch.cumsum(counts, 1) - counts
    rank = torch.arange(n, device=dev)[None, :] - torch.gather(starts, 1, sc)
    # one sentinel slot past the tables takes the writes the cap drops
    flat = torch.where(rank < bucket_cap, (table * nb + sc) * bucket_cap
                       + rank, t * nb * bucket_cap)
    ids = torch.full((t * nb * bucket_cap + 1,), -1, dtype=torch.int32,
                     device=dev)
    ids[flat.reshape(-1)] = order.reshape(-1).to(torch.int32)
    return (ids[:-1].reshape(t, nb, bucket_cap), counts.to(torch.int32))


def query_codes(proj: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """(t, d+1, bits), (b, d) queries -> (t, b) bucket codes (a query's
    augmented coordinate is 0)."""
    qf = q.float()
    q_aug = torch.cat([qf, qf.new_zeros((qf.shape[0], 1))], dim=1)
    return _codes(q_aug, proj)


def log_collision_prob(dots: torch.Tensor, q_norm: torch.Tensor,
                       x_norm: torch.Tensor, n_bits: int,
                       min_bit_prob: float) -> torch.Tensor:
    """``n_bits · log(max(1 - angle/π, min_bit_prob))``: the log probability
    that a query and a norm-completed row share a bucket of one table, from
    their inner products ``dots`` and norms (broadcast against ``dots``)."""
    cosv = dots / torch.clamp(q_norm * x_norm, min=1e-30)
    ang = torch.arccos(torch.clamp(cosv, -1.0, 1.0))
    return n_bits * torch.log(torch.clamp(1.0 - ang / math.pi,
                                          min=min_bit_prob))


def first_slots(cand: torch.Tensor) -> torch.Tensor:
    """(b, s) ids -> (b, s) int64: for every slot, the lowest slot of its
    row holding the same id (a slot that holds an id first points at
    itself). A stable sort groups equal ids in slot order; each run's first
    sorted element is scattered back to the run's slots."""
    b, s = cand.shape
    order = torch.argsort(cand, dim=1, stable=True)
    sorted_c = torch.gather(cand, 1, order)
    start = torch.ones_like(sorted_c, dtype=torch.bool)
    start[:, 1:] = sorted_c[:, 1:] != sorted_c[:, :-1]
    pos = torch.arange(s, device=cand.device).expand(b, s)
    run = torch.cummax(torch.where(start, pos, torch.zeros_like(pos)),
                       dim=1).values  # sorted position of the run's start
    return torch.empty_like(order).scatter_(1, order,
                                            torch.gather(order, 1, run))


@base.register_backend(LSHConfig)
class LSHIndex:
    """Stateful SRP-LSH index: frozen config + device state. ``counts``
    carries the true bucket loads, so estimator clients can check that no
    row was dropped (:attr:`dropped_count`)."""

    def __init__(self, config: LSHConfig, state: LSHState):
        self.config = config
        self.state = state

    @property
    def proj(self) -> torch.Tensor:
        return self.state.proj

    @property
    def table_ids(self) -> torch.Tensor:
        return self.state.table_ids

    @property
    def db_aug(self) -> torch.Tensor:
        return self.state.db_aug

    @property
    def counts(self) -> torch.Tensor:
        return self.state.counts

    @property
    def n_tables(self) -> int:
        return self.proj.shape[0]

    @property
    def n_bits(self) -> int:
        return self.proj.shape[2]

    @property
    def bucket_cap(self) -> int:
        return self.table_ids.shape[2]

    @property
    def dropped_count(self) -> int:
        """Member slots lost to the bucket cap, over all tables (0: lossless
        buckets, the unbiased LSH sampler's precondition). Reads the
        device."""
        over = torch.clamp(self.counts.long() - self.bucket_cap, min=0)
        return int(over.sum())

    def bucket_log_probs(self, q: torch.Tensor) -> torch.Tensor:
        """(b, n) log collision probability of every row with each query in
        one table, ``n_bits · log(1 - angle/π)`` over the norm-completed
        vectors (:func:`log_collision_prob`, the LSH sampler's importance
        weights), the per-bit probability floored at 1e-30."""
        qf = q.float()
        dots = qf @ self.db_aug[:, :-1].T  # the query's last coordinate is 0
        return log_collision_prob(
            dots, torch.linalg.norm(qf, dim=1)[:, None],
            torch.linalg.norm(self.db_aug, dim=1)[None, :], self.n_bits,
            1e-30)

    # ------------------------------------------------------------ lifecycle
    @classmethod
    def build(cls, db: torch.Tensor, config: LSHConfig | None = None
              ) -> "LSHIndex":
        """Hash ``db`` (n, d) into the tables on its device."""
        cfg = config or LSHConfig()
        n, d = db.shape
        rng = np.random.default_rng(cfg.seed)
        proj = rng.standard_normal((cfg.n_tables, d + 1, cfg.n_bits)).astype(
            np.float32)
        proj = torch.from_numpy(proj).to(db.device)
        cap = cfg.bucket_cap or default_bucket_cap(n, cfg.n_bits)
        db_aug = _augment(db)
        table_ids, counts = _build_tables(db_aug, proj, cap)
        return cls(cfg, LSHState(proj, table_ids, db_aug, counts))

    def refresh(self, db: torch.Tensor) -> "LSHIndex":
        """Rehash a drifted db with the SAME projections and bucket cap."""
        db_aug = _augment(db)
        table_ids, counts = _build_tables(db_aug, self.proj, self.bucket_cap)
        return LSHIndex(self.config,
                        LSHState(self.proj, table_ids, db_aug, counts))

    # -------------------------------------------------------------- queries
    def candidates(self, q: torch.Tensor) -> torch.Tensor:
        """(b, d) -> (b, n_tables·cap) ids of the query's buckets, table by
        table, -1 padded (repeats across tables kept)."""
        codes = query_codes(self.proj, q)  # (t, b)
        cand = self.table_ids[torch.arange(self.n_tables,
                                           device=codes.device)[:, None],
                              codes]  # (t, b, cap)
        return cand.transpose(0, 1).reshape(q.shape[0], -1)

    def score_candidates(self, qf: torch.Tensor, cand: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
        """(b, d) fp32 queries, (b, s) candidate ids -> (scores (b, s) f32,
        first (b, s) int64). Each live id of a query is scored once, at the
        first slot holding it (:func:`first_slots`, returned as ``first``);
        pads and repeats score -inf. Only the live (query, slot) pairs are
        gathered and scored, in chunks: no (b, s, d+1) gather is built."""
        first = first_slots(cand)
        slot = torch.arange(cand.shape[1], device=cand.device)
        live = (cand >= 0) & (first == slot)
        scores = torch.full(cand.shape, -math.inf, dtype=torch.float32,
                            device=qf.device)
        pairs = torch.nonzero(live)  # (P, 2): (query, slot)
        step = max(1, _GATHER_ELEMS // self.db_aug.shape[1])
        for s in range(0, pairs.shape[0], step):
            qi, si = pairs[s:s + step].unbind(1)
            rows = self.db_aug[cand[qi, si].long(), :-1]
            scores[qi, si] = torch.einsum("pd,pd->p", rows, qf[qi])
        return scores, first

    def topk_batch(self, q: torch.Tensor, k: int) -> TopK:
        """(b, d) -> TopK[(b, k)] over the union of the query's buckets.
        Among equal scores the earlier candidate slot wins; a slot with no
        live candidate comes back as (-inf, id -1)."""
        qf = q.float()
        b = qf.shape[0]
        cand = self.candidates(qf)
        scores, _ = self.score_candidates(qf, cand)
        if scores.shape[1] < k:  # fewer slots than k: pad dead slots
            pad = k - scores.shape[1]
            scores = torch.cat([scores, scores.new_full((b, pad),
                                                        -math.inf)], dim=1)
            cand = torch.cat([cand, cand.new_full((b, pad), -1)], dim=1)
        vals, pos = base.top_k(scores, k)
        ids = torch.gather(cand, 1, pos)
        ids = torch.where(torch.isneginf(vals), torch.full_like(ids, -1), ids)
        return TopK(ids, vals)

    def topk(self, q: torch.Tensor, k: int) -> TopK:
        return base.single_query(self, q, k)

    def memory_bytes(self) -> int:
        return base.state_bytes(self.state)
