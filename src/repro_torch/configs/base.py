"""Architecture + run configuration.

One ``configs/<arch>.py`` per assigned architecture instantiates ArchConfig
with the exact published numbers; ``reduce_for_smoke`` derives a tiny
same-family variant for CPU smoke tests.  Shapes (train_4k / prefill_32k /
decode_32k / long_500k) are global and apply per arch with the skip rules of
DESIGN.md §4.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "hybrid", "ssm", "audio", "vlm"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                 # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 500000.0
    rms_eps: float = 1e-5
    tie_embeddings: bool = False

    # attention variants
    causal: bool = True               # False: encoder-only (hubert)
    sliding_window: int = 0           # >0: SWA (mixtral, hymba)
    global_attn_every: int = 0        # hybrid: every Nth layer full attention

    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25

    # SSM / hybrid
    ssm_state: int = 0                # mamba d_state (hymba)
    ssm_conv: int = 4
    xlstm: bool = False               # sLSTM + mLSTM alternating blocks
    slstm_every: int = 4              # every Nth block is sLSTM

    # VLM
    cross_attn_every: int = 0         # every Nth layer is cross-attention
    n_image_tokens: int = 0

    # modality frontend stub: inputs are embeddings, not token ids
    embed_inputs: bool = False

    dtype: str = "bfloat16"

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def vlm_dims(self) -> tuple[int, int]:
        """(super-blocks, self layers in each) of a vlm config: each
        super-block is ``cross_attn_every - 1`` self layers and one cross
        layer."""
        return (self.n_layers // self.cross_attn_every,
                self.cross_attn_every - 1)

    @property
    def is_encoder(self) -> bool:
        return not self.causal

    @property
    def attention_free(self) -> bool:
        return self.xlstm

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch decode at 500k context? (DESIGN.md §4 skip rule)"""
        return self.xlstm or self.sliding_window > 0

    def n_params(self) -> int:
        """Approximate parameter count (exact for dense; close for others)."""
        d, ff, L, V = self.d_model, self.d_ff, self.n_layers, self.vocab
        hd, H, KV = self.hd, self.n_heads, self.n_kv_heads
        attn = d * H * hd + 2 * d * KV * hd + H * hd * d
        if self.n_experts:
            mlp = 3 * d * ff * self.n_experts + d * self.n_experts
        elif self.xlstm:
            mlp = 0
            attn = 8 * d * d // 2  # rough per-block projections
        else:
            mlp = 3 * d * ff
        if self.family == "hybrid":
            attn += 2 * d * d + d * (self.ssm_state * 2 + d // 16)
        emb = V * d * (1 if self.tie_embeddings else 2)
        return L * (attn + mlp + 2 * d) + emb + d

    def n_active_params(self) -> int:
        """Active params per token (MoE: only top-k experts)."""
        if not self.n_experts:
            return self.n_params()
        d, ff, L = self.d_model, self.d_ff, self.n_layers
        full = self.n_params()
        moe_all = L * 3 * d * ff * self.n_experts
        moe_act = L * 3 * d * ff * self.top_k
        return full - moe_all + moe_act


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def cell_supported(arch: ArchConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Skip rules from the assignment (recorded in EXPERIMENTS.md)."""
    if arch.is_encoder and shape.kind == "decode":
        return False, "encoder-only arch has no decode step"
    if shape.name == "long_500k" and not arch.sub_quadratic:
        return False, "pure full-attention arch cannot decode at 500k context"
    return True, ""


def reduce_for_smoke(cfg: ArchConfig) -> ArchConfig:
    """Tiny same-family variant: structure preserved, sizes shrunk."""
    kv = max(min(cfg.n_kv_heads, 2), 1)
    heads = max(4, kv)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=4 if (cfg.cross_attn_every or cfg.global_attn_every
                       or cfg.xlstm) else 2,
        d_model=64, n_heads=heads, n_kv_heads=kv, head_dim=16,
        d_ff=96 if cfg.d_ff else 0,
        vocab=512 if not cfg.embed_inputs else cfg.vocab and 128,
        n_experts=min(cfg.n_experts, 8) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        sliding_window=min(cfg.sliding_window, 16) if cfg.sliding_window else 0,
        ssm_state=min(cfg.ssm_state, 8) if cfg.ssm_state else 0,
        n_image_tokens=min(cfg.n_image_tokens, 16) if cfg.n_image_tokens else 0,
        cross_attn_every=cfg.cross_attn_every and min(cfg.cross_attn_every, 2),
        global_attn_every=cfg.global_attn_every and min(cfg.global_attn_every, 2),
        dtype="float32",
    )


# registry filled by configs/__init__.py
REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    from repro_torch import configs  # noqa: F401  (triggers registration)
    if name not in REGISTRY:
        raise KeyError(f"unknown arch '{name}'; have {sorted(REGISTRY)}")
    return REGISTRY[name]
