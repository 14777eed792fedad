"""HuBERT-XLarge [arXiv:2106.07447]: encoder-only audio backbone.

48L, d_model=1280, 16H (MHA), d_ff=5120, vocab=504 (codebook targets).
The conv feature extractor is a STUB: input_specs() provides precomputed
frame embeddings [B, T, d_model] (DESIGN.md §4)."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="hubert-xlarge", family="audio",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16, d_ff=5120,
    vocab=504, head_dim=80, causal=False, embed_inputs=True,
))
