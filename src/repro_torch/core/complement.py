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

__all__ = ["complement_map"]


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
