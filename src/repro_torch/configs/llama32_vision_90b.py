"""Llama-3.2-Vision-90B [hf:meta-llama/Llama-3.2-11B-Vision, scaled]:
text decoder with interleaved cross-attention image layers.

100L total = 80 self-attention + 20 cross-attention (every 5th layer),
d_model=8192, 64H (GQA kv=8), d_ff=28672, vocab=128256.  The vision tower
is a STUB: input_specs() provides projected patch embeddings
[B, n_image_tokens, d_model] (DESIGN.md §4)."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="llama-3.2-vision-90b", family="vlm",
    n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=28672,
    vocab=128256, head_dim=128, cross_attn_every=5, n_image_tokens=1601,
    rope_theta=500000.0,
))
