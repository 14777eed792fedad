"""Qwen2-72B [arXiv:2407.10671]: GQA kv=8, QKV bias.

80L, d_model=8192, 64H, d_ff=29568, vocab=152064."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen2-72b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=29568,
    vocab=152064, head_dim=128, qkv_bias=True, rope_theta=1000000.0,
))
