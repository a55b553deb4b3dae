"""Workloads on the estimator core (counterpart of ``repro/workloads``):
thin clients of :mod:`repro_torch.core.estimators` and the Index API, with
no estimator math of their own.

* :mod:`repro_torch.workloads.dknn` — deep-kNN classification and
  attribution over the trunk's activation taps, with conformal credibility
  and confidence;
* :mod:`repro_torch.workloads.structured` — perturb-and-MAP structured
  inference: sequence MAP and Gumbel top-k sampling without replacement
  (stochastic beam search), certificate-gated;
* the unbiased LSH-sampler estimator lives in the core
  (:func:`repro_torch.core.estimators.lsh_sampler_logz`).

CLI: ``python -m repro_torch.launch.workloads {dknn,structured,estimator}``.
"""
from repro_torch.workloads import dknn, structured

__all__ = ["dknn", "structured"]
