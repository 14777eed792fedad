"""CodeQwen1.5-7B [hf:Qwen/CodeQwen1.5-7B]: qwen1.5 arch, QKV bias, MHA.

32L, d_model=4096, 32H (kv=32 -> MHA), d_ff=13440, vocab=92416."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="codeqwen1.5-7b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32, d_ff=13440,
    vocab=92416, head_dim=128, qkv_bias=True, rope_theta=1000000.0,
))
