"""hubert-xlarge [audio]: 48L d=1280 16H (MHA kv=16) d_ff=5120 vocab=504.
Encoder-only; the conv waveform frontend is a STUB — input_specs provides
precomputed frame embeddings. vocab=504 is below the paper's "large output
space" regime, so the head is exact (DESIGN.md §Arch-applicability).
[arXiv:2106.07447]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab=504,
    encoder_only=True,
    causal=False,
    frontend="audio_stub",
    use_rope=False,  # conv/relative positions live in the (stubbed) frontend
    head_mode="exact",
)


def smoke() -> ArchConfig:
    return CONFIG.scaled(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=64,
    )
