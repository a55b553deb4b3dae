"""mamba2-780m [ssm]: 48L d=1536 attn-free vocab=50280, ssm_state=128.
SSD (state-space duality). Constant-size decode state => long_500k ok.
[arXiv:2405.21060]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab=50280,
    layer_pattern="ssm",
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    use_rope=False,
)


def smoke() -> ArchConfig:
    return CONFIG.scaled(
        n_layers=2, d_model=64, vocab=512, ssm_state=16, ssm_head_dim=16,
    )
