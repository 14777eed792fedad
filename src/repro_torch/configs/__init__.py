"""Architecture registry: the configurations the PyTorch port serves.

Every module here is a copy of its namesake in ``repro.configs`` (the
JAX package's config modules import nothing of JAX, but the port keeps
its own copy so that it never imports the reference package): the dense
family (``llama3_8b``; ``qwen2_7b``, ``qwen2_72b`` and ``codeqwen1p5_7b``
with QKV bias), the MoE family (``granite_moe_3b``; ``mixtral_8x22b``
with a sliding window), the hybrid family (``hymba_1p5b``: attention and
Mamba heads in parallel) and the ssm family (``xlstm_125m``: mLSTM and
sLSTM blocks).  The audio and vlm configs wait for their families."""
from .base import (REGISTRY, SHAPES, ArchConfig, ShapeConfig, cell_supported,
                   get_config, reduce_for_smoke)
from . import (codeqwen1p5_7b, granite_moe_3b, hymba_1p5b,  # noqa: F401
               llama3_8b, mixtral_8x22b, qwen2_72b, qwen2_7b,
               xlstm_125m)  # (registration side effect)

ALL_ARCHS = sorted(REGISTRY)
