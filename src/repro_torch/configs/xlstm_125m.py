"""xLSTM-125M [arXiv:2405.04517]: sLSTM + mLSTM blocks, attention-free.

12L, d_model=768, 4 heads, vocab=50304 (d_ff=0: xLSTM blocks carry their
own projections).  Every 4th block is sLSTM, the rest mLSTM (~[7:1]-ish
mix of the paper, DESIGN.md §4)."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="xlstm-125m", family="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4, d_ff=0,
    vocab=50304, head_dim=192, xlstm=True, slstm_every=4,
))
