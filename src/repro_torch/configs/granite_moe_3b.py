"""Granite-3.0 MoE (assignment: 40 experts top-8) — per the assignment
literal `MoE 40e top-8`; the HF granite-3.0-1b-a400m reference uses 32
experts (discrepancy noted in DESIGN.md §4).

32L, d_model=1536, 24H (GQA kv=8), expert d_ff=512, vocab=49155."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, d_ff=512,
    vocab=49155, head_dim=64, n_experts=40, top_k=8, rope_theta=10000.0,
))
