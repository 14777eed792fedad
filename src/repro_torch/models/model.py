"""The model facade (port of ``repro.models.model``): ``loss_fn``, the
entry points under the reference's names, and each cell's abstract
inputs and decode state as ``meta`` tensors (shapes and dtypes, nothing
allocated), which the sharded serving steps lay out."""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig, cell_supported
from repro_torch.device import torch_dtype

from . import transformer


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """``meta`` stand-ins for every model input of this (arch, shape)
    cell: train/prefill {"tokens" [B,S] int32 (audio: "embeds" [B,S,d]),
    "labels" [B,S] int32 for train, vlm "image_embeds" [B,n_image,d]};
    decode {"tokens" [B] int32}."""
    ok, why = cell_supported(cfg, shape)
    if not ok:
        raise ValueError(f"{cfg.name} x {shape.name} unsupported: {why}")
    B, S = shape.global_batch, shape.seq_len
    dt = torch_dtype(cfg.dtype)

    def meta(*s, dtype=torch.int32):
        return torch.empty(s, dtype=dtype, device="meta")

    if shape.kind in ("train", "prefill"):
        specs = {}
        if cfg.embed_inputs:
            specs["embeds"] = meta(B, S, cfg.d_model, dtype=dt)
        else:
            specs["tokens"] = meta(B, S)
        if shape.kind == "train":
            specs["labels"] = meta(B, S)
        if cfg.family == "vlm":
            specs["image_embeds"] = meta(B, cfg.n_image_tokens, cfg.d_model,
                                         dtype=dt)
        return specs
    return {"tokens": meta(B)}


def abstract_decode_state(cfg: ArchConfig, shape: ShapeConfig):
    """The decode state of this cell as ``meta`` tensors."""
    return transformer.init_decode_state(cfg, shape.global_batch,
                                         shape.seq_len, "meta")


def loss_fn(cfg: ArchConfig, params, batch, *, remat: str = "none",
            tp=None):
    """``lm_loss``; ``tp`` runs the split step on this rank's parameter
    pieces (the dense family, ``sharding/tensor_parallel.py``)."""
    return transformer.lm_loss(cfg, params, batch, remat=remat, tp=tp)


forward = transformer.forward
forward_chunk = transformer.forward_chunk
init_chunk_buffers = transformer.init_chunk_buffers
prefill = transformer.prefill
decode_step = transformer.decode_step
init_params = transformer.init_params
init_params_and_axes = transformer.init_params_and_axes
init_sharded_params = transformer.init_sharded_params
abstract_params_and_axes = transformer.abstract_params_and_axes
init_decode_state = transformer.init_decode_state
