"""Uniform sampling from the complement of a small set S ⊂ [0, n)
(counterpart of ``repro/core/complement.py``).

If ``s_0 < s_1 < ... < s_{k-1}`` are the sorted elements of S, then

    f(u) = u + |{j : s_j - j <= u}|      for u in [0, n-k)

is a bijection from [0, n-k) onto [0, n) \\ S: a uniform u mapped through f
is a uniform draw from the complement, in O(log k) per draw via
``searchsorted``, with static shapes.
"""
from __future__ import annotations

import torch

from repro_torch.core import rng

__all__ = ["complement_map", "sample_complement"]


def complement_map(u: torch.Tensor, s_sorted: torch.Tensor) -> torch.Tensor:
    """Map u in [0, n-k) to the (u+1)-th smallest element of [0,n) \\ S.

    Args:
      u: integer tensor of indices into the complement; any shape when
        ``s_sorted`` is 1-D, else ``(..., m)`` matching ``s_sorted``'s
        leading dims (one excluded set per row).
      s_sorted: ``(k,)`` or ``(..., k)`` strictly increasing integer tensor
        (the excluded set S).

    Returns:
      integer tensor shaped and typed like ``u``, values in [0, n) \\ S.
    """
    k = s_sorted.shape[-1]
    # t_j = s_j - j is nondecreasing; rank(u) = #{j : t_j <= u}
    t = (s_sorted.long() - torch.arange(k, device=s_sorted.device)).contiguous()
    rank = torch.searchsorted(t, u.long().contiguous(), right=True)
    return u + rank.to(u.dtype)


def sample_complement(keys: torch.Tensor | None, n, s_sorted: torch.Tensor,
                      num: int, n_excluded=None, *,
                      u: torch.Tensor | None = None) -> torch.Tensor:
    """``num`` iid uniform draws (with replacement) from [0, n) \\ S per row.

    ``s_sorted`` is ``(..., k)`` strictly increasing; ``n_excluded``
    ((...,) or a scalar) overrides the count of REAL exclusions when
    ``s_sorted`` carries virtual entries >= n marking dead slots (see
    :func:`repro_torch.core.estimators.sanitize_topk`): those exclude
    nothing, so the complement has ``n - n_excluded`` elements, not
    ``n - k``. The upper bound is clamped to 1 so an empty complement stays
    in range (callers weight such draws out).

    The uniform indices come from the counter-based generator —
    ``keys`` ((..., 3) int64 rows, stream ``STREAM_COMPLEMENT``) — or are
    injected as ``u`` ((..., num) integers in [0, n - n_excluded)).
    Returns int64 ids shaped ``(..., num)``.
    """
    k = s_sorted.shape[-1] if n_excluded is None else n_excluded
    lead = s_sorted.shape[:-1]
    hi = torch.clamp(torch.as_tensor(n, device=s_sorted.device)
                     - torch.as_tensor(k, device=s_sorted.device), min=1)
    if u is None:
        if keys is None:
            raise ValueError("sample_complement needs keys or u")
        u = rng.uniform_int(keys, num, hi.long().expand(lead),
                            rng.STREAM_COMPLEMENT)
    return complement_map(u.long(), s_sorted.long())
