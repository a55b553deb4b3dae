"""MIPS indexes (counterpart of ``repro/core/mips``): the stateful Index API
with the exact oracle, the IVF and IVF-PQ backends and SRP-LSH (the theory
index). The config dataclass selects the backend::

    from repro_torch.core import mips

    index = mips.build_index(mips.IVFConfig(n_probe=8), db)
    topk  = index.topk_batch(q, k)        # TopK[(b, k)]
"""
from __future__ import annotations

from repro_torch.core.gumbel import TopK
from repro_torch.core.mips.base import (
    Index,
    backend_cls,
    build_index,
    index_spill,
    index_spill_parts,
    register_backend,
    state_bytes,
    top_k,
)
from repro_torch.core.mips.exact import ExactConfig, ExactIndex
from repro_torch.core.mips.ivf import IVFConfig, IVFIndex, IVFState
from repro_torch.core.mips.lsh import (LSHConfig, LSHIndex, LSHState,
                                       default_bucket_cap)
from repro_torch.core.mips.pq import IVFPQIndex, PQConfig, PQState

__all__ = [
    "Index",
    "backend_cls",
    "build_index",
    "index_spill",
    "index_spill_parts",
    "register_backend",
    "state_bytes",
    "top_k",
    "ExactConfig",
    "ExactIndex",
    "IVFConfig",
    "IVFIndex",
    "IVFState",
    "LSHConfig",
    "LSHIndex",
    "LSHState",
    "default_bucket_cap",
    "IVFPQIndex",
    "PQConfig",
    "PQState",
    "TopK",
]
