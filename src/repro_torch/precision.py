"""Mixed-precision policy (counterpart of ``repro/precision.py``, DESIGN.md §9).

One frozen :class:`Policy` names the dtype of every tensor class. Two ship:

* ``f32``  — everything float32; the numerics reference the parity tests use.
* ``bf16`` — bfloat16 trunk activations and KV cache; float32 master params.

What stays float32 under every policy, and why:

* master params and optimizer moments (``param_dtype``): AdamW's update is
  a ratio of EMAs of tiny numbers that bf16's 8-bit mantissa loses;
* gradient accumulators (``grad_accum_dtype``): microbatch gradients summed
  in bf16 would make the sum order-dependent at magnitudes the optimizer
  cares about;
* estimator accumulators (``estimator_dtype``): the Algorithm-3 logsumexp
  partials and the Algorithm-2 certificate terms — a failed certificate
  must mean the probe missed, never that bf16 rounded the bound.

The only bf16 the head may see is ``score_dtype``: the candidate rows and
their scores may be bf16 (``"bf16"``); every reduction over them still
accumulates in float32.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["Policy", "F32", "BF16", "get_policy", "POLICIES"]


@dataclasses.dataclass(frozen=True)
class Policy:
    name: str
    compute_dtype: torch.dtype  # trunk activations + KV cache (weights cast at use)
    param_dtype: torch.dtype = torch.float32  # master params + optimizer moments
    grad_accum_dtype: torch.dtype = torch.float32  # microbatch gradient sums
    estimator_dtype: torch.dtype = torch.float32  # Alg-2/3 partials + certificates
    score_dtype: str = "f32"  # head candidate-gather dtype ("f32" | "bf16")

    def __post_init__(self):
        if self.param_dtype != torch.float32:
            raise ValueError("master params must be float32")
        if self.grad_accum_dtype != torch.float32:
            raise ValueError("gradient accumulators must be float32")
        if self.estimator_dtype != torch.float32:
            raise ValueError(
                "estimator accumulators (Alg-3 partials, certificates) must "
                "be float32 — approximation error must be attributable to "
                "the index, not the dtype"
            )


F32 = Policy(name="f32", compute_dtype=torch.float32)
BF16 = Policy(name="bf16", compute_dtype=torch.bfloat16)

POLICIES = {"f32": F32, "bf16": BF16}


def get_policy(p: "Policy | str | None") -> Policy:
    """Resolve a policy name / instance / None (-> bf16, the default)."""
    if p is None:
        return BF16
    if isinstance(p, Policy):
        return p
    try:
        return POLICIES[p]
    except KeyError:
        raise ValueError(
            f"unknown precision policy {p!r}; valid choices: {sorted(POLICIES)}"
        ) from None
