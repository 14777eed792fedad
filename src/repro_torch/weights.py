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
               "blocks/s_b", "blocks/cross/attn/gate")


def _block_shapes(cfg: ArchConfig, lead: tuple, cross: bool = False) -> dict:
    """path (under "blocks/") -> shape of one stack of blocks whose
    leading dims are ``lead``; ``cross`` adds the gated cross-attention's
    leaves."""
    d, ff = cfg.d_model, cfg.d_ff
    H, KV, hd, E = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.n_experts
    shapes = {"norm1": (d,)}
    if cfg.family == "ssm":
        xd = d // H
        shapes.update({"m_qkv": (d, 3, H, xd), "m_if": (d, 2, H),
                       "m_if_b": (2, H), "m_og": (d, d), "m_out": (d, d),
                       "s_w": (d, 4, H, xd), "s_r": (H, xd, 4, xd),
                       "s_b": (4, H, xd), "s_out": (d, d)})
    else:
        shapes.update({"norm2": (d,), "attn/wq": (d, H, hd),
                       "attn/wk": (d, KV, hd), "attn/wv": (d, KV, hd),
                       "attn/wo": (H, hd, d)})
    if cfg.qkv_bias:
        shapes.update({"attn/bq": (H, hd), "attn/bk": (KV, hd),
                       "attn/bv": (KV, hd)})
    if cross:
        shapes.update({"attn/gate": (), "attn/q_norm": (hd,),
                       "attn/k_norm": (hd,)})
    if cfg.family == "hybrid":
        st, r = cfg.ssm_state, max(d // 16, 1)
        shapes.update({"norm_attn_out": (d,), "norm_ssm_out": (d,),
                       "ssm/in_proj": (d, 2 * d),
                       "ssm/conv_w": (cfg.ssm_conv, d), "ssm/conv_b": (d,),
                       "ssm/x_proj": (d, r + 2 * st), "ssm/dt_proj": (r, d),
                       "ssm/dt_bias": (d,), "ssm/A_log": (d, st),
                       "ssm/D": (d,), "ssm/out_proj": (d, d)})
    if cfg.family == "moe":
        shapes.update({"moe/router": (d, E), "moe/w_gate": (E, d, ff),
                       "moe/w_up": (E, d, ff), "moe/w_down": (E, ff, d)})
    elif cfg.family == "audio":
        shapes.update({"mlp/w_in": (d, ff), "mlp/b_in": (ff,),
                       "mlp/w_out": (ff, d), "mlp/b_out": (d,)})
    elif cfg.family != "ssm":
        shapes.update({"mlp/w_gate": (d, ff), "mlp/w_up": (d, ff),
                       "mlp/w_down": (ff, d)})
    return {k: lead + s for k, s in shapes.items()}


def _expected_leaves(cfg: ArchConfig) -> dict:
    """path -> (shape, dtype) of every parameter of ``cfg``'s model: the
    reference's dtype per leaf, ``cfg.dtype`` except ``FP32_LEAVES``.
    vlm: "blocks/self/*" stacked [ns, inner, ...] and "blocks/cross/*"
    stacked [ns, ...]; audio: no "embed"."""
    d, V = cfg.d_model, cfg.vocab
    shapes = {"final_norm": (d,)}
    if not cfg.embed_inputs:
        shapes["embed"] = (V, d)
    if cfg.family == "vlm":
        ns, inner = cfg.vlm_dims
        stacks = {"blocks/self/": _block_shapes(cfg, (ns, inner)),
                  "blocks/cross/": _block_shapes(cfg, (ns,), cross=True)}
    else:
        stacks = {"blocks/": _block_shapes(cfg, (cfg.n_layers,))}
    for prefix, block in stacks.items():
        shapes.update({prefix + k: s for k, s in block.items()})
    if not cfg.tie_embeddings:
        shapes["unembed"] = (V, d)
    dt = torch_dtype(cfg.dtype)
    return {k: (s, torch.float32 if k in FP32_LEAVES else dt)
            for k, s in shapes.items()}


def from_jax_params(tree, cfg: ArchConfig, device=None) -> dict:
    """Nested dict of numpy arrays (the reference's parameter tree) ->
    nested dict of tensors on ``device``, each leaf in the reference's
    dtype (``cfg.dtype``; ``FP32_LEAVES`` in fp32).  Raises on a leaf
    whose path or shape ``cfg``'s model does not expect."""
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


def unit_fan_in(tree: dict, cfg: ArchConfig) -> dict:
    """Rescale, in place, the projections that ``init_params`` (like the
    reference's ``dense_init``) scales by 1/sqrt(shape[-2]) -- wq by
    1/sqrt(H), wk and wv by 1/sqrt(KV), wo by 1/sqrt(hd), the xLSTM's
    m_qkv and s_w by 1/sqrt(H) -- to 1/sqrt of their contracted input
    size (d; H*hd for wo).  ``tree``'s leaves are tensors or numpy
    arrays; returns ``tree``.

    At the reference's scale attention at width is nearly one-hot (scores
    of std ~200 at llama3-8b's), so fp32 reassociation alone moves logits
    by ~1e-3; checks that hold two orders of the same fp32 sums against
    each other to a tight tolerance draw their projections here."""
    d, H, KV = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    factor = {"wq": np.sqrt(H / d), "wk": np.sqrt(KV / d),
              "wv": np.sqrt(KV / d), "wo": np.sqrt(1 / H),
              "m_qkv": np.sqrt(H / d), "s_w": np.sqrt(H / d)}
    for k, v in tree.items():
        if isinstance(v, dict):
            unit_fan_in(v, cfg)
        elif k in factor:
            v *= float(factor[k])
    return tree
