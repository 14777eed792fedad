"""Every model family of ``repro.models``: the dense, MoE, hybrid, ssm
and vlm decoders and the audio encoder, their attention (the vlm's
gated cross-attention included), the MoE FFN, the Mamba and xLSTM
branches and the KV backends; ``loss_fn`` for training."""

from .model import (abstract_decode_state, abstract_params_and_axes,
                    decode_step, forward, forward_chunk, init_chunk_buffers,
                    init_decode_state, init_params, init_params_and_axes,
                    init_sharded_params, input_specs, loss_fn, prefill)
from .transformer import DecodeState, layer_flags, lm_loss

__all__ = ["DecodeState", "abstract_decode_state",
           "abstract_params_and_axes", "decode_step", "forward",
           "forward_chunk", "init_chunk_buffers", "init_decode_state",
           "init_params", "init_params_and_axes", "init_sharded_params",
           "input_specs",
           "layer_flags", "lm_loss", "loss_fn", "prefill"]
