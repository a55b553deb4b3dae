"""Decoding through the trunk families other than plain attention (MoE,
Mamba-2, Griffin, the vision stub): the port's ``Model.prefill`` (with the
image prefix for paligemma) and ``decode_step`` against the JAX package's
trunk and head on the same weights, at the smoke widths with vocab 4096
(so that the amortized head runs), with the reference's random numbers
injected (``_torch_families.decode_like_jax``). The dense attention
decoders, Griffin's ring past its local window, hubert's ``encode`` and
the compute-dtype cast set are in ``test_torch_families_dense.py``.

Tolerances: f32 policy; hidden states and caches rtol=atol=1e-4 (matmuls
and scans reduced in different orders by XLA-CPU and PyTorch); sampled
ids exact.
"""
import pytest
import torch

from _torch_families import decode_like_jax
from repro_torch.configs import ARCHS, get

torch.set_num_threads(1)

# the decoders whose trunk is not plain attention + SwiGLU (the dense four:
# test_torch_families_dense.py)
DECODERS = [a for a in ARCHS if get(a).has_decode
            and (get(a).layer_pattern != "attn" or get(a).is_moe
                 or get(a).frontend != "none")]


@pytest.mark.parametrize("arch", DECODERS)
def test_prefill_then_decode_sample_like_jax(arch):
    decode_like_jax(arch)
