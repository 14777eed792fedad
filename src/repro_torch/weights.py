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


def _block_leaves(cfg: ArchConfig, lead: tuple, cross: bool = False) -> dict:
    """path (under "blocks/") -> (shape, logical axes) of one stack of
    blocks whose leading dims are ``lead`` (each "layers"); ``cross``
    adds the gated cross-attention's leaves.  The axes are those of the
    reference's ``dense_init``/``zeros_init``/``ones_init`` calls
    (``repro/models/{attention,moe,ssm,xlstm,transformer}.py``)."""
    d, ff = cfg.d_model, cfg.d_ff
    H, KV, hd, E = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.n_experts
    emb = ("embed",)
    leaves = {"norm1": ((d,), emb)}
    if cfg.family == "ssm":
        xd = d // H
        qkv = ("embed", "qkv", "heads", None)
        leaves.update({
            "m_qkv": ((d, 3, H, xd), qkv),
            "m_if": ((d, 2, H), ("embed", None, "heads")),
            "m_if_b": ((2, H), (None, "heads")),
            "m_og": ((d, d), ("embed", "mlp")),
            "m_out": ((d, d), ("mlp", "embed")),
            "s_w": ((d, 4, H, xd), qkv),
            "s_r": ((H, xd, 4, xd), ("heads", None, "qkv", None)),
            "s_b": ((4, H, xd), ("qkv", "heads", None)),
            "s_out": ((d, d), ("mlp", "embed"))})
    else:
        leaves.update({
            "norm2": ((d,), emb),
            "attn/wq": ((d, H, hd), ("embed", "heads", None)),
            "attn/wk": ((d, KV, hd), ("embed", "kv_heads", None)),
            "attn/wv": ((d, KV, hd), ("embed", "kv_heads", None)),
            "attn/wo": ((H, hd, d), ("heads", None, "embed"))})
    if cfg.qkv_bias:
        leaves.update({"attn/bq": ((H, hd), ("heads", None)),
                       "attn/bk": ((KV, hd), ("kv_heads", None)),
                       "attn/bv": ((KV, hd), ("kv_heads", None))})
    if cross:
        leaves.update({"attn/gate": ((), ()), "attn/q_norm": ((hd,), (None,)),
                       "attn/k_norm": ((hd,), (None,))})
    if cfg.family == "hybrid":
        st, r = cfg.ssm_state, max(d // 16, 1)
        leaves.update({
            "norm_attn_out": ((d,), emb), "norm_ssm_out": ((d,), emb),
            "ssm/in_proj": ((d, 2 * d), ("embed", "mlp")),
            "ssm/conv_w": ((cfg.ssm_conv, d), ("conv", "mlp")),
            "ssm/conv_b": ((d,), ("mlp",)),
            "ssm/x_proj": ((d, r + 2 * st), ("mlp", None)),
            "ssm/dt_proj": ((r, d), (None, "mlp")),
            "ssm/dt_bias": ((d,), ("mlp",)),
            "ssm/A_log": ((d, st), ("mlp", "state")),
            "ssm/D": ((d,), ("mlp",)),
            "ssm/out_proj": ((d, d), ("mlp", "embed"))})
    if cfg.family == "moe":
        leaves.update({
            "moe/router": ((d, E), ("embed", "expert")),
            "moe/w_gate": ((E, d, ff), ("expert", "embed", "mlp")),
            "moe/w_up": ((E, d, ff), ("expert", "embed", "mlp")),
            "moe/w_down": ((E, ff, d), ("expert", "mlp", "embed"))})
    elif cfg.family == "audio":
        leaves.update({"mlp/w_in": ((d, ff), ("embed", "mlp")),
                       "mlp/b_in": ((ff,), ("mlp",)),
                       "mlp/w_out": ((ff, d), ("mlp", "embed")),
                       "mlp/b_out": ((d,), emb)})
    elif cfg.family != "ssm":
        leaves.update({"mlp/w_gate": ((d, ff), ("embed", "mlp")),
                       "mlp/w_up": ((d, ff), ("embed", "mlp")),
                       "mlp/w_down": ((ff, d), ("mlp", "embed"))})
    layers = ("layers",) * len(lead)
    return {k: (lead + s, layers + a) for k, (s, a) in leaves.items()}


def _layout(cfg: ArchConfig) -> dict:
    """path -> (shape, logical axes) of every parameter of ``cfg``'s
    model.  vlm: "blocks/self/*" stacked [ns, inner, ...] (axes "layers",
    "layers", ... as the reference's reshaped stack) and "blocks/cross/*"
    stacked [ns, ...]; audio: no "embed"."""
    d, V = cfg.d_model, cfg.vocab
    table = ((V, d), ("vocab", "embed"))
    out = {"final_norm": ((d,), ("embed",))}
    if not cfg.embed_inputs:
        out["embed"] = table
    if cfg.family == "vlm":
        ns, inner = cfg.vlm_dims
        stacks = {"blocks/self/": _block_leaves(cfg, (ns, inner)),
                  "blocks/cross/": _block_leaves(cfg, (ns,), cross=True)}
    else:
        stacks = {"blocks/": _block_leaves(cfg, (cfg.n_layers,))}
    for prefix, block in stacks.items():
        out.update({prefix + k: v for k, v in block.items()})
    if not cfg.tie_embeddings:
        out["unembed"] = table
    return out


def _expected_leaves(cfg: ArchConfig) -> dict:
    """path -> (shape, dtype) of every parameter of ``cfg``'s model: the
    reference's dtype per leaf, ``cfg.dtype`` except ``FP32_LEAVES``."""
    dt = torch_dtype(cfg.dtype)
    return {k: (s, torch.float32 if k in FP32_LEAVES else dt)
            for k, (s, _) in _layout(cfg).items()}


def _nest(flat: dict) -> dict:
    out: dict = {}
    for path, v in flat.items():
        *dirs, leaf = path.split("/")
        node = out
        for k in dirs:
            node = node.setdefault(k, {})
        node[leaf] = v
    return out


def param_axes(cfg: ArchConfig) -> dict:
    """The parameters' tree of logical-axis tuples, the reference's."""
    return _nest({k: a for k, (_, a) in _layout(cfg).items()})


def abstract_params(cfg: ArchConfig) -> dict:
    """The parameters' tree as ``meta`` tensors: shapes and dtypes, no
    storage (qwen2-72b and the 100-layer vlm cost nothing)."""
    return _nest({k: torch.empty(s, dtype=dt, device="meta")
                  for k, (s, dt) in _expected_leaves(cfg).items()})


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
