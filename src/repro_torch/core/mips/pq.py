"""IVF-PQ MIPS index (counterpart of ``repro/core/mips/pq.py``) — the
compressed index: the IVF coarse geometry (padded clusters plus an
always-scanned overflow buffer), with uint8 residual-PQ codes in the member
tables instead of fp32 row copies.

Query pipeline, three stages with static shapes:

1. **coarse probe** — ``q @ centroidsᵀ`` and the top ``n_probe`` clusters,
   as the IVF probe;
2. **LUT screen** — one ``(m_sub, ksub)`` table per query
   (:func:`repro_torch.core.quant.pq.build_lut`); each probed member scores
   ``Σ_m lut[m, code_m] + q·centroid``, the overflow rows their exact inner
   products; the top ``r`` survive;
3. **exact re-rank** — the ``r`` survivors re-scored in fp32 against the
   database rows and the top-k taken from these exact scores, so
   ``TopK.values`` are true inner products.

On the card, stage 2 runs on ``pq_lut_score`` (:meth:`IVFPQIndex.topk_batch`)
or, fused with the top-r, on ``pq_screen_select``
(:meth:`IVFPQIndex.screen_select`); both score members with one device
function. Stage 3 runs on ``rerank_select`` on BOTH paths: the reference's
unfused re-rank gathers ``(b, r, d)`` rows into device memory (a 2.4 GB
gather per 256-query training chunk at tinyllama's width) and a library
product would not sum in the fused kernel's order. So ``screen_select``
equals ``topk_batch`` bit for bit, ids and values; on the CPU both paths
take the kernels' plain versions and hold the same contract.

``state.db`` is the CALLER's tensor, never a copy, and
:meth:`IVFPQIndex.memory_bytes` leaves it out: the index owns centroids,
codebooks, member ids and codes, overflow ids and two counters. A caller
that updates its rows in place (the trainer's optimizer) must build the
index over a frozen copy; the trainer's drift snapshot is that copy.

``refresh`` warm-starts the coarse centroids AND the codebooks from the
current state and keeps every shape. ``PQConfig.anisotropic_eta > 0``
trains the codebooks under the score-aware (ScaNN) objective, in the build
and in every refresh.

:meth:`IVFPQIndex.topk_adaptive` widens the probe per query until the gap
certificate passes (:mod:`repro_torch.core.mips.adaptive`), unfused on
``pq_lut_score`` or fused on ``pq_screen_select``, re-ranking each stage
on ``rerank_select``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch.core.gumbel import TopK
from repro_torch.core.mips import adaptive, base
from repro_torch.core.mips.ivf import (_cluster_radii, _coarse_quantize,
                                       _gather_rows, _geometry, _pack_ids,
                                       _pad_pool, _schedule, _stage_pool)
from repro_torch.core.quant import pq as quant
from repro_torch.kernels import ops

__all__ = ["PQConfig", "IVFPQIndex", "PQState"]


@dataclasses.dataclass(frozen=True)
class PQConfig:
    """Build- and query-time knobs. Coarse geometry follows the IVF rules
    and the PQ shapes (``m_sub`` subspaces of ``ksub <= 256`` codewords, one
    uint8 each) are frozen at build."""

    n_clusters: int | None = None  # None -> max(4, sqrt(n))
    cap_factor: float = 3.0  # padded capacity ≈ cap_factor · n / n_clusters
    overflow_frac: float = 1.0 / 16.0  # overflow buffer ≈ n/16 rows
    kmeans_iters: int = 10  # coarse Lloyd iterations, cold build
    refresh_iters: int = 2  # warm-started coarse iterations per refresh
    m_sub: int = 8  # PQ subspaces (d % m_sub == 0); bytes per coded row
    ksub: int = 256  # codewords per subspace (<= 256: uint8 codes)
    pq_iters: int = 8  # codebook Lloyd iterations, cold build
    pq_refresh_iters: int = 1  # warm-started codebook iterations per refresh
    rerank: int = 0  # top-r LUT candidates re-ranked exactly; 0 -> 2k
    seed: int = 0  # seeds the cold build's row samples (torch.Generator)
    n_probe: int = 8  # clusters probed per query
    n_probe_init: int = 0  # adaptive probe: starting width (0 -> n_probe)
    n_probe_max: int = 0  # adaptive probe: widening ceiling (0 -> n_probe)
    anisotropic_eta: float = 0.0  # score-aware codebook training: weight of
    #   the direction-parallel residual in the Lloyd objective
    #   (quant.train_codebooks); 0 -> standard (isotropic) k-means


class PQState(NamedTuple):
    centroids: torch.Tensor  # (n_c, d) f32 coarse quantizer
    codebooks: torch.Tensor  # (m_sub, ksub, d_sub) f32 residual codebooks
    member_ids: torch.Tensor  # (n_c, cap) i32, -1 padded
    member_codes: torch.Tensor  # (n_c, cap, m_sub) uint8, 0 padded
    overflow_ids: torch.Tensor  # (o_cap,) i32, -1 padded — scored exactly
    spill_count: torch.Tensor  # () i32 — rows dropped at build (0 = exact)
    rerank_spill: torch.Tensor  # () i32 — configured re-rank slots the
    #   probed pool can never fill (rerank > n_probe·cap + o_cap)
    radii: torch.Tensor  # (n_c,) f32 — max ||x - c_j|| over rows of cluster
    #   j (-inf for empty clusters), the adaptive probe's bound
    db: torch.Tensor  # (n, d) re-rank rows: the CALLER's tensor, not a copy

    @property
    def n_clusters(self) -> int:
        return self.centroids.shape[0]

    @property
    def cap(self) -> int:
        return self.member_ids.shape[1]

    @property
    def m_sub(self) -> int:
        return self.codebooks.shape[0]

    @property
    def ksub(self) -> int:
        return self.codebooks.shape[1]


def _pq_geometry(n: int, d: int, cfg: PQConfig) -> tuple[int, int, int, int]:
    """Static (n_c, cap, o_cap, ksub) for a database of (n, d) rows."""
    if cfg.ksub > 256:
        raise ValueError(f"ksub={cfg.ksub} > 256 does not fit uint8 codes")
    if d % cfg.m_sub:
        raise ValueError(f"feature dim {d} not divisible by m_sub={cfg.m_sub}")
    n_c, cap, o_cap = _geometry(n, cfg)
    return n_c, cap, o_cap, min(cfg.ksub, n)


def _device_build(db: torch.Tensor, init_cent: torch.Tensor | None,
                  init_codebooks: torch.Tensor | None, *, n_c: int, cap: int,
                  o_cap: int, m_sub: int, ksub: int, iters: int,
                  pq_iters: int, seed: int,
                  anisotropic_eta: float = 0.0) -> tuple:
    """The quantized structures of a full (re)build on ``db``'s device:
    coarse Lloyd, packing, residual codebooks, codes and radii. None
    initializers cold-start from rows sampled by ``torch.Generator``s seeded
    with ``seed`` (centroids) and ``seed + 1`` (codebooks), as the
    reference seeds its two samples; its samples cannot be replayed here,
    so tests pass them in."""
    dbf = db.float()
    cent, assign = _coarse_quantize(dbf, init_cent, n_c=n_c, iters=iters,
                                    seed=seed)
    member_ids, overflow_ids, spill = _pack_ids(assign, n_c, cap, o_cap)
    residuals = dbf - cent[assign]  # (n, d)
    codebooks = quant.train_codebooks(residuals, m_sub, ksub, pq_iters,
                                      seed=seed + 1, init=init_codebooks,
                                      anisotropic_eta=anisotropic_eta,
                                      anchors=dbf)
    codes = quant.encode(codebooks, residuals)  # (n, m_sub) uint8
    member_codes = codes[torch.clamp(member_ids.long(), min=0)]
    member_codes[member_ids < 0] = 0
    radii = _cluster_radii(dbf, cent, assign)
    return cent, codebooks, member_ids, member_codes, overflow_ids, spill, radii


@base.register_backend(PQConfig)
class IVFPQIndex:
    """Stateful IVF-PQ index: frozen config + device state."""

    def __init__(self, config: PQConfig, state: PQState):
        self.config = config
        self.state = state

    # ------------------------------------------------------------ lifecycle
    @classmethod
    def build(cls, db: torch.Tensor, config: PQConfig | None = None, *,
              init_cent: torch.Tensor | None = None,
              init_codebooks: torch.Tensor | None = None,
              iters: int | None = None, pq_iters: int | None = None
              ) -> "IVFPQIndex":
        """Build over ``db`` (kept as ``state.db``, not copied): coarse Lloyd
        from ``init_cent`` for ``iters`` iterations (default
        ``kmeans_iters``), codebook Lloyd from ``init_codebooks`` for
        ``pq_iters`` (default ``pq_iters``); None initializers are seeded row
        samples. ``iters=0, pq_iters=0`` with saved centroids and codebooks
        re-packs ``db`` into the exact index they came from — how a resumed
        run rebuilds its index."""
        cfg = config or PQConfig()
        n, d = db.shape
        n_c, cap, o_cap, ksub = _pq_geometry(n, d, cfg)
        parts = _device_build(
            db, init_cent, init_codebooks, n_c=n_c, cap=cap, o_cap=o_cap,
            m_sub=cfg.m_sub, ksub=ksub,
            iters=cfg.kmeans_iters if iters is None else iters,
            pq_iters=cfg.pq_iters if pq_iters is None else pq_iters,
            seed=cfg.seed, anisotropic_eta=cfg.anisotropic_eta)
        return cls(cfg, cls._assemble(cfg, parts, db))

    @staticmethod
    def _assemble(cfg: PQConfig, parts: tuple, db: torch.Tensor) -> PQState:
        """PQState from a build's structures and the caller's ``db``, with
        ``rerank_spill`` stamped: the configured re-rank slots beyond the
        per-query pool of ``n_probe · cap + o_cap`` slots (0 on any sane
        geometry)."""
        cent, codebooks, member_ids, member_codes, overflow_ids, spill, \
            radii = parts
        pool = min(cfg.n_probe, cent.shape[0]) * member_ids.shape[1]
        pool += overflow_ids.shape[0]
        short = torch.tensor(max(0, cfg.rerank - pool), dtype=torch.int32,
                             device=cent.device)
        return PQState(cent, codebooks, member_ids, member_codes,
                       overflow_ids, spill, short, radii, db)

    def refresh(self, db: torch.Tensor, *, iters: int | None = None
                ) -> "IVFPQIndex":
        """Warm-started rebuild over a drifted db (same n, d): coarse Lloyd
        from the current centroids, codebook Lloyd from the current
        codebooks; every state tensor keeps its shape."""
        st = self.state
        cfg = self.config
        parts = _device_build(
            db, st.centroids, st.codebooks, n_c=st.n_clusters, cap=st.cap,
            o_cap=st.overflow_ids.shape[0], m_sub=st.m_sub, ksub=st.ksub,
            iters=cfg.refresh_iters if iters is None else iters,
            pq_iters=cfg.pq_refresh_iters, seed=cfg.seed,
            anisotropic_eta=cfg.anisotropic_eta)
        return IVFPQIndex(cfg, self._assemble(cfg, parts, db))

    # -------------------------------------------------------------- queries
    def _resolved_rerank(self, k: int, pool: int) -> int:
        r = self.config.rerank or 2 * k
        return min(max(r, k), pool)

    def _screen_inputs(self, qf: torch.Tensor, n_probe: int | None):
        """What both screens take: (c_scores (b, n_c) centroid scores,
        probe (b, np), coarse (b, np) centroid scores of the probed
        clusters, lut (b, m_sub, ksub), overflow scores (b, o_cap) — exact,
        one matmul against the gathered overflow rows, dead ids as zero
        rows)."""
        st = self.state
        n_probe = min(n_probe or self.config.n_probe, st.n_clusters)
        c_scores = qf @ st.centroids.T  # (b, n_c)
        _, probe = base.top_k(c_scores, n_probe)
        coarse = torch.gather(c_scores, 1, probe)
        lut = quant.build_lut(st.codebooks, qf)
        o_scores = (_gather_rows(st.db, st.overflow_ids).float() @ qf.T).T
        return c_scores, probe, coarse, lut, o_scores

    def _screen_pool(self, probe, coarse, lut, o_scores
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        """LUT screening pool of the probe list: (scores, ids) of shape
        (b, n_probe·cap + o_cap) — the members' LUT sums plus their
        cluster's centroid score, then the overflow's exact scores. Padded
        slots carry id -1 and unmasked scores: each caller applies its own
        liveness mask, so the fixed and adaptive probes share this pool."""
        st = self.state
        b = probe.shape[0]
        scores = ops.pq_lut_score(st.member_codes, probe, lut)
        # residual PQ: the LUT sum, then q·centroid
        scores = (scores + coarse[..., None]).reshape(b, -1)
        ids = st.member_ids[probe.long()].reshape(b, -1)
        scores = torch.cat([scores, o_scores], dim=1)
        ids = torch.cat([ids, st.overflow_ids[None].expand(b, -1)], dim=1)
        return scores, ids

    def _rerank_pool(self, scores, ids, qf, k: int, r: int) -> TopK:
        """Stage 3: the top-r of a masked, k-padded LUT pool re-ranked
        exactly on ``rerank_select``."""
        lut_vals, pos = base.top_k(scores, r)
        cand = torch.gather(ids, 1, pos)
        vals, out_ids = ops.rerank_select(self.state.db, cand, lut_vals, qf,
                                          k=k)
        return TopK(out_ids, vals)

    def topk(self, q: torch.Tensor, k: int, *, n_probe: int | None = None
             ) -> TopK:
        """LUT-screened, exactly re-ranked top-k for a single query (d,)."""
        return base.single_query(self, q, k, n_probe=n_probe)

    def topk_batch(self, q: torch.Tensor, k: int, *,
                   n_probe: int | None = None) -> TopK:
        """LUT-screened, exactly re-ranked top-k: (b, d) -> TopK[(b, k)].
        Values are exact inner products; dead slots (-inf, id -1) only where
        the pool holds fewer than k live rows."""
        qf = q.float()
        _, probe, coarse, lut, o_scores = self._screen_inputs(qf, n_probe)
        scores, ids = self._screen_pool(probe, coarse, lut, o_scores)
        scores = torch.where(ids >= 0, scores,
                             torch.full_like(scores, -math.inf))
        scores, ids = _pad_pool(scores, ids, k)
        r = self._resolved_rerank(k, scores.shape[1])
        return self._rerank_pool(scores, ids, qf, k, r)

    def topk_adaptive(self, q: torch.Tensor, k: int, *, c: float = 0.0,
                      n_probe_init: int | None = None,
                      n_probe_max: int | None = None, fused: bool = False,
                      init_stage: torch.Tensor | None = None, router=None
                      ) -> adaptive.AdaptiveTopK:
        """Certificate-gated staged probe (see ``IVFIndex.topk_adaptive``).
        The certificate reads each stage's EXACT re-ranked values, for which
        the centroid + radius bound is sound; screening misses inside the
        probed clusters are the re-rank recall, as on the fixed-width path.

        Unfused, the LUT pool of the ``n_probe_max`` best clusters is scored
        once (``pq_lut_score``) and each stage masks it to the row's width,
        takes the top r and re-ranks them (``rerank_select``). Fused, each
        stage is ``pq_screen_select`` at the rows' widths, then
        ``rerank_select``. Both agree bit for bit; with init == max either
        equals :meth:`topk_batch` at that width. ``init_stage`` / ``router``
        as for IVF."""
        st = self.state
        w_max, widths = _schedule(self.config, st.n_clusters, n_probe_init,
                                  n_probe_max)
        qf = q.float()
        c_scores, probe, coarse, lut, o_scores = self._screen_inputs(qf,
                                                                     w_max)
        bound_table = adaptive.unprobed_bound_table(c_scores, st.radii, qf)
        if router is not None and init_stage is None:
            init_stage = router.init_stage(c_scores, qf, widths)
        pool = w_max * st.cap + st.overflow_ids.shape[0]
        r = self._resolved_rerank(k, max(pool, k))
        if fused:
            def stage_fn(w):
                lut_vals, cand = ops.pq_screen_select(
                    st.member_codes, st.member_ids, coarse, o_scores,
                    st.overflow_ids, probe, lut, r=r, probe_width=w)
                return ops.rerank_select(st.db, cand, lut_vals, qf, k=k)
        else:
            scores, ids = self._screen_pool(probe, coarse, lut, o_scores)

            def stage_fn(w):
                sc, sids = _stage_pool(scores, ids, w, st.cap, w_max, k)
                tk = self._rerank_pool(sc, sids, qf, k, r)
                return tk.values, tk.ids

        return adaptive.staged_widen(stage_fn, bound_table, widths, k, c=c,
                                     no_spill=st.spill_count == 0,
                                     init_stage=init_stage)

    def screen_select(self, q: torch.Tensor, k: int, *,
                      n_probe: int | None = None) -> TopK:
        """Fused query pipeline: LUT screen and pool top-r in one kernel
        (``pq_screen_select``, the pool never reaches device memory), then
        the exact re-rank and top-k (``rerank_select``). Equal to
        :meth:`topk_batch` bit for bit, ids and values."""
        st = self.state
        qf = q.float()
        _, probe, coarse, lut, o_scores = self._screen_inputs(qf, n_probe)
        pool = probe.shape[1] * st.cap + st.overflow_ids.shape[0]
        # the unfused r is resolved over the k-padded pool; the kernel
        # emits the pad slots' (-inf, -1) picks on its own
        r = self._resolved_rerank(k, max(pool, k))
        lut_vals, cand = ops.pq_screen_select(
            st.member_codes, st.member_ids, coarse, o_scores, st.overflow_ids,
            probe, lut, r=r)
        vals, ids = ops.rerank_select(st.db, cand, lut_vals, qf, k=k)
        return TopK(ids, vals)

    def memory_bytes(self) -> int:
        """Index-OWNED device memory: everything but ``state.db``, which is
        the caller's tensor."""
        return base.state_bytes(self.state[:-1])
