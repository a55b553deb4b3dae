"""The system under test: the PyTorch and CUDA port (``repro_torch``), as
the benchmark's entries call it. The only module of the harness that
imports the program.

Each method is one entry point of the port with the configuration's
sizes; outputs are the port's own tensors.
"""
from __future__ import annotations

import torch

from bench.reference import loglinear as ll


class Port:
    def __init__(self, db: torch.Tensor, cfg: dict):
        from repro_torch.core import mips
        from repro_torch.core.mips.ivf import IVFConfig

        icfg = cfg["index"]
        self.db, self.cfg = db, cfg
        self.index = mips.build_index(IVFConfig(
            n_clusters=icfg["n_clusters"], cap_factor=icfg["cap_factor"],
            overflow_frac=icfg["overflow_frac"],
            kmeans_iters=icfg["kmeans_iters"], seed=icfg["seed"],
            n_probe=icfg["n_probe"]), db)

    def probe(self, theta):
        """``IVFIndex.topk_batch`` -> (ids (b, k), values (b, k))."""
        tk = self.index.topk_batch(theta, self.cfg["k"])
        return tk.ids, tk.values

    def sample(self, theta, keys) -> dict:
        """Algorithm 2: ``core.estimators.local_gumbel_max`` over the IVF
        probe, unfused."""
        from repro_torch.core.estimators import local_gumbel_max

        c = self.cfg
        r = local_gumbel_max(self.db, theta, k=c["k"], l=c["l"], keys=keys,
                             index=self.index, m_cap=c["m_cap"],
                             fused=False)
        return {"index": r.index, "ok": r.ok, "m": r.m,
                "max_val": r.max_val, "bound": r.bound,
                "overflow": r.overflow}

    def logz(self, theta, keys, ids, vals) -> torch.Tensor:
        """Algorithm 3 from a probe's top-k: ``amortized_candidates``, then
        ``stratified_logz`` (``fused_estimator`` on the card)."""
        from repro_torch.core.estimators import (amortized_candidates,
                                                 stratified_logz)
        from repro_torch.core.gumbel import TopK

        with torch.no_grad():
            cids, log_w = amortized_candidates(TopK(ids, vals), self.cfg["n"],
                                               self.cfg["l"], keys=keys)
            return stratified_logz(self.db, theta, cids, log_w)

    def tables(self) -> ll.Index:
        st = self.index.state
        return ll.Index(st.centroids, st.member_ids, st.member_vecs,
                        st.overflow_ids, st.overflow_vecs,
                        int(st.spill_count))

    @staticmethod
    def launch_counts() -> dict:
        from repro_torch.kernels import ops

        return ops.launch_counts()

    @staticmethod
    def reset_launch_counts() -> None:
        from repro_torch.kernels import ops

        ops.reset_launch_counts()
