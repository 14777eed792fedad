"""The model facade (port of ``repro.models.model``): ``loss_fn`` and
the entry points under the reference's names.  ``input_specs`` and
``abstract_decode_state`` wait for the port's sharding and dry-run."""

from __future__ import annotations

from repro_torch.configs.base import ArchConfig

from . import transformer


def loss_fn(cfg: ArchConfig, params, batch, *, remat: str = "none"):
    return transformer.lm_loss(cfg, params, batch, remat=remat)


forward = transformer.forward
forward_chunk = transformer.forward_chunk
init_chunk_buffers = transformer.init_chunk_buffers
prefill = transformer.prefill
decode_step = transformer.decode_step
init_params = transformer.init_params
init_decode_state = transformer.init_decode_state
