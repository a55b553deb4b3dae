"""Core: the paper's contribution as composable PyTorch modules
(counterpart of ``repro/core``).

- gumbel: lazy-Gumbel sampling (Algorithms 1 and 2, Poissonized tail)
- partition / expectation: the Algorithm 3 / 4 stratified estimators
- complement: exact uniform sampling from [n] \\ S
- mips: exact / IVF / IVF-PQ / SRP-LSH top-k indexes and the adaptive probe
- estimators: the estimator core of the LM head
- amortized_head: the estimators packaged as an LM softmax head
"""
from repro_torch.core.amortized_head import (HeadConfig, head_loss,
                                             head_sample, make_index)
from repro_torch.core.complement import complement_map, sample_complement
from repro_torch.core.expectation import expectation_estimate
from repro_torch.core.gumbel import (
    SampleResult,
    TopK,
    default_kl,
    gumbel_max_dense,
    sample_adaptive_b,
    sample_fixed_b,
)
from repro_torch.core.partition import partition_estimate

__all__ = [
    "HeadConfig",
    "head_loss",
    "head_sample",
    "make_index",
    "complement_map",
    "sample_complement",
    "expectation_estimate",
    "SampleResult",
    "TopK",
    "default_kl",
    "gumbel_max_dense",
    "sample_adaptive_b",
    "sample_fixed_b",
    "partition_estimate",
]
