"""Qwen2-7B [arXiv:2407.10671]: GQA kv=4, QKV bias.

28L, d_model=3584, 28H, d_ff=18944, vocab=152064."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen2-7b", family="dense",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4, d_ff=18944,
    vocab=152064, head_dim=128, qkv_bias=True, rope_theta=1000000.0,
))
