"""Architecture configuration (counterpart of ``repro/models/config.py``):
one frozen dataclass drives the whole stack."""
from __future__ import annotations

import dataclasses


def _pad_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int  # query heads; 0 for attention-free archs
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int

    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0  # per-expert FFN hidden (d_ff used if 0)
    capacity_factor: float = 1.25

    # --- attention pattern ---
    window: int = 0  # sliding-window size; 0 = full attention
    layer_pattern: str = "attn"  # attn | ssm | griffin (rec,rec,attn periods)
    local_window: int = 2048  # griffin local-attention window
    encoder_only: bool = False  # bidirectional, no decode step
    causal: bool = True

    # --- SSM (mamba2 SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_width: int = 4

    # --- recurrent (RG-LRU) ---
    lru_width: int = 0  # 0 -> d_model

    # --- frontend stubs (audio/vlm): input_specs provide embeddings ---
    frontend: str = "none"  # none | audio_stub | vision_stub
    n_prefix_tokens: int = 0  # vlm: number of (bidirectional) image tokens

    # --- misc ---
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    use_rope: bool = True
    tie_embeddings: bool = False

    # --- amortized head (the paper's technique) ---
    head_mode: str = "amortized"  # exact | topk_only | amortized
    head_mips: str = "exact"  # exact | ivf | ivfpq | lsh
    head_delta: float = 1e-4
    head_k: int = 0  # 0 -> default_kl(vocab, head_delta)
    head_l: int = 0
    head_use_kernel: bool = False  # CPU: the head through the kernels'
    #   plain versions (on CUDA the kernels always run)
    head_fused_decode: bool = False  # fused screen/select + tail/argmax
    #   kernels (kernels/decode_fused.py); same samples as the unfused
    #   kernel path — see DESIGN.md §10
    head_n_probe: int = 8  # IVF/IVF-PQ clusters probed per query
    head_adaptive_probe: bool = False  # certificate-gated staged widening:
    #   probe head_n_probe_init clusters, widen geometrically (per token)
    #   up to head_n_probe_max only when the gap certificate fails —
    #   DESIGN.md §11
    head_n_probe_init: int = 0  # 0 -> head_n_probe
    head_n_probe_max: int = 0  # 0 -> head_n_probe

    # ------------------------------------------------------------------ #
    @property
    def vocab_padded(self) -> int:
        return _pad_to(self.vocab, 256)

    @property
    def d_attn(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def d_kv(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def d_inner(self) -> int:  # mamba2
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def lru_dim(self) -> int:
        return self.lru_width or self.d_model

    @property
    def expert_d_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def sub_quadratic(self) -> bool:
        """True if the arch supports long-context (500k) decode."""
        return self.layer_pattern in ("ssm", "griffin") or self.window > 0

    @property
    def has_decode(self) -> bool:
        return not self.encoder_only

    def layer_kinds(self) -> list[str]:
        """Per-layer block kind, honoring the layer pattern."""
        if self.layer_pattern == "attn":
            return ["attn"] * self.n_layers
        if self.layer_pattern == "ssm":
            return ["ssm"] * self.n_layers
        if self.layer_pattern == "griffin":
            # (rec, rec, attn) repeating, truncated to n_layers
            kinds = []
            for i in range(self.n_layers):
                kinds.append("attn" if i % 3 == 2 else "rec")
            return kinds
        raise ValueError(self.layer_pattern)

    def scaled(self, **kw) -> "ArchConfig":
        """Reduced config of the same family (smoke tests)."""
        return dataclasses.replace(self, **kw)
