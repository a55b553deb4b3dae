"""qwen3-moe-30b-a3b [moe]: 48L d=2048 32H (GQA kv=4) per-expert d_ff=768
vocab=151936, MoE 128e top-8. [hf:Qwen/Qwen3-30B-A3B]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=768,
    vocab=151936,
    n_experts=128,
    experts_per_token=8,
    moe_d_ff=768,
    rope_theta=1e6,
)


def smoke() -> ArchConfig:
    return CONFIG.scaled(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=64, moe_d_ff=64, vocab=512, n_experts=8, experts_per_token=2,
    )
