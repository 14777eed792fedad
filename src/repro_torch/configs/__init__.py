"""Architecture registry: the configurations the PyTorch port serves.

Every module here is a copy of its namesake in ``repro.configs`` (the
JAX package's config modules import nothing of JAX, but the port keeps
its own copy so that it never imports the reference package): the dense
family (``llama3_8b``; ``qwen2_7b``, ``qwen2_72b`` and ``codeqwen1p5_7b``
with QKV bias), the MoE family (``granite_moe_3b``; ``mixtral_8x22b``
with a sliding window), the hybrid family (``hymba_1p5b``: attention and
Mamba heads in parallel), the ssm family (``xlstm_125m``: mLSTM and
sLSTM blocks), the vlm family (``llama32_vision_90b``: a cross-attention
layer to projected image embeddings after every 4 self-attention layers)
and the audio family (``hubert_xlarge``: a bidirectional encoder over
precomputed frame embeddings)."""
from .base import (REGISTRY, SHAPES, ArchConfig, ShapeConfig, cell_supported,
                   get_config, reduce_for_smoke)
from . import (codeqwen1p5_7b, granite_moe_3b, hubert_xlarge,  # noqa: F401
               hymba_1p5b, llama3_8b, llama32_vision_90b, mixtral_8x22b,
               qwen2_72b, qwen2_7b, xlstm_125m)  # (registration side effect)

ALL_ARCHS = sorted(REGISTRY)
