"""Hymba-1.5B: hybrid parallel attention + Mamba heads [arXiv:2411.13676].

32L, d_model=1600, 25 heads (GQA kv=5), d_ff=5504, vocab=32001, ssm_state=16.
SWA everywhere except periodic global-attention layers (the paper keeps 3
full-attention layers; we use every-8th => 4, noted in DESIGN.md).
Meta-tokens are omitted (DESIGN.md §4)."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, d_ff=5504,
    vocab=32001, head_dim=64, ssm_state=16,
    sliding_window=1024, global_attn_every=8, rope_theta=10000.0,
))
