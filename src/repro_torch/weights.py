"""Parameters of the reference's ``repro.models.init_params`` -> the
port's parameters.

The caller passes the reference's tree with every leaf already a numpy
array (this module imports no JAX); the layouts are the same, so each
leaf becomes one tensor.  bfloat16 leaves (numpy's ``ml_dtypes``
bfloat16) go through float32, which holds them exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device, torch_dtype


# the leaves the reference keeps in fp32 whatever ``cfg.dtype`` is
FP32_LEAVES = ("blocks/moe/router", "blocks/ssm/dt_bias", "blocks/ssm/A_log",
               "blocks/ssm/D", "blocks/m_if", "blocks/m_if_b", "blocks/s_r",
               "blocks/s_b")


def _expected_leaves(cfg: ArchConfig) -> dict:
    """path -> (shape, dtype) of every parameter of ``cfg``'s decoder: the
    reference's dtype per leaf, ``cfg.dtype`` except ``FP32_LEAVES``."""
    L, d, ff, V = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab
    H, KV, hd, E = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.n_experts
    shapes = {"embed": (V, d), "final_norm": (d,), "blocks/norm1": (L, d)}
    if cfg.family == "ssm":
        xd = d // H
        shapes.update({"blocks/m_qkv": (L, d, 3, H, xd),
                       "blocks/m_if": (L, d, 2, H),
                       "blocks/m_if_b": (L, 2, H),
                       "blocks/m_og": (L, d, d), "blocks/m_out": (L, d, d),
                       "blocks/s_w": (L, d, 4, H, xd),
                       "blocks/s_r": (L, H, xd, 4, xd),
                       "blocks/s_b": (L, 4, H, xd),
                       "blocks/s_out": (L, d, d)})
    else:
        shapes.update({"blocks/norm2": (L, d),
                       "blocks/attn/wq": (L, d, H, hd),
                       "blocks/attn/wk": (L, d, KV, hd),
                       "blocks/attn/wv": (L, d, KV, hd),
                       "blocks/attn/wo": (L, H, hd, d)})
    if cfg.qkv_bias:
        shapes.update({"blocks/attn/bq": (L, H, hd),
                       "blocks/attn/bk": (L, KV, hd),
                       "blocks/attn/bv": (L, KV, hd)})
    if cfg.family == "hybrid":
        st, r = cfg.ssm_state, max(d // 16, 1)
        shapes.update({"blocks/norm_attn_out": (L, d),
                       "blocks/norm_ssm_out": (L, d),
                       "blocks/ssm/in_proj": (L, d, 2 * d),
                       "blocks/ssm/conv_w": (L, cfg.ssm_conv, d),
                       "blocks/ssm/conv_b": (L, d),
                       "blocks/ssm/x_proj": (L, d, r + 2 * st),
                       "blocks/ssm/dt_proj": (L, r, d),
                       "blocks/ssm/dt_bias": (L, d),
                       "blocks/ssm/A_log": (L, d, st),
                       "blocks/ssm/D": (L, d),
                       "blocks/ssm/out_proj": (L, d, d)})
    if cfg.family == "moe":
        shapes.update({"blocks/moe/router": (L, d, E),
                       "blocks/moe/w_gate": (L, E, d, ff),
                       "blocks/moe/w_up": (L, E, d, ff),
                       "blocks/moe/w_down": (L, E, ff, d)})
    elif cfg.family != "ssm":
        shapes.update({"blocks/mlp/w_gate": (L, d, ff),
                       "blocks/mlp/w_up": (L, d, ff),
                       "blocks/mlp/w_down": (L, ff, d)})
    if not cfg.tie_embeddings:
        shapes["unembed"] = (V, d)
    dt = torch_dtype(cfg.dtype)
    return {k: (s, torch.float32 if k in FP32_LEAVES else dt)
            for k, s in shapes.items()}


def from_jax_params(tree, cfg: ArchConfig, device=None) -> dict:
    """Nested dict of numpy arrays (the reference's parameter tree) ->
    nested dict of tensors on ``device``, each leaf in the reference's
    dtype (``cfg.dtype``; ``FP32_LEAVES`` in fp32).  Raises on a leaf
    whose path or shape ``cfg``'s decoder does not expect."""
    device = resolve_device(device)
    expected = _expected_leaves(cfg)
    seen = set()

    def conv(node, path):
        if isinstance(node, dict):
            return {k: conv(v, f"{path}/{k}" if path else k)
                    for k, v in node.items()}
        arr = np.asarray(node)
        if path not in expected or tuple(arr.shape) != expected[path][0]:
            raise ValueError(f"unexpected parameter {path} {arr.shape}")
        seen.add(path)
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=expected[path][1])

    out = conv(tree, "")
    missing = set(expected) - seen
    if missing:
        raise ValueError(f"missing parameters {sorted(missing)}")
    return out
