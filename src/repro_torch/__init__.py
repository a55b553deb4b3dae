"""PyTorch + CUDA port of the amortized log-linear serving path.

The JAX package ``repro`` is the reference; every module here has its
counterpart at the same relative path under ``src/repro/``. This package
imports ``torch`` and never ``jax`` or ``repro``.

Entry points (``Model``, ``Server``, ``make_index``, ``launch.serve``) run
on CUDA unless the caller passes ``device="cpu"``; without CUDA and without
an explicit device they raise (:func:`resolve_device`).
"""
from __future__ import annotations

import torch

# fp32 matmuls must stay full fp32. The Algorithm-2 certificate compares the
# winner's perturbed value with S_min + c + B and attributes a failure to the
# index (the top-k gap c), never to the arithmetic (DESIGN.md §9); TF32 keeps
# ~10 mantissa bits and would let rounding flip certificates and top-k
# membership. PyTorch defaults these differently per backend, so pin both.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = ["resolve_device"]


def resolve_device(device: "torch.device | str | None" = None) -> torch.device:
    """The device an entry point runs on: CUDA unless ``device`` says
    otherwise. Raises instead of falling back to the CPU when CUDA is
    absent and no device was named."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the port "
                "on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
