"""paligemma-3b [vlm]: 18L d=2048 8H (GQA kv=1) d_ff=16384 vocab=257216.
SigLIP frontend is a STUB (input_specs provides 256 precomputed patch
embeddings, attended bidirectionally — prefix-LM). The 257k vocab is the
framework's largest: the amortized head's best case. [arXiv:2407.07726]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab=257216,
    frontend="vision_stub",
    n_prefix_tokens=256,
)


def smoke() -> ArchConfig:
    return CONFIG.scaled(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
        d_ff=128, vocab=512, n_prefix_tokens=8,
    )
