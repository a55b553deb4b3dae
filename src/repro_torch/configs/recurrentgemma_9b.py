"""recurrentgemma-9b [hybrid]: 38L d=4096 16H (GQA kv=1) d_ff=12288
vocab=256000. Griffin pattern (rec, rec, local-attn), RG-LRU recurrence,
local window 2048 => sub-quadratic, long_500k ok. [arXiv:2402.19427]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab=256000,
    layer_pattern="griffin",
    local_window=2048,
    lru_width=4096,
)


def smoke() -> ArchConfig:
    return CONFIG.scaled(
        n_layers=6, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
        d_ff=128, vocab=512, local_window=32, lru_width=64,
    )
