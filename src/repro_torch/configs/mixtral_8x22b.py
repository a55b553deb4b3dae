"""mixtral-8x22b [moe]: 56L d=6144 48H (GQA kv=8) d_ff=16384 vocab=32768,
MoE 8e top-2, SWA(4096). [arXiv:2401.04088; hf]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab=32768,
    n_experts=8,
    experts_per_token=2,
    window=4096,  # sliding-window attention => sub-quadratic, long_500k ok
    rope_theta=1e6,
)


def smoke() -> ArchConfig:
    return CONFIG.scaled(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512, n_experts=4, experts_per_token=2, window=32,
    )
