"""Every model family of ``repro.models``: the dense, MoE, hybrid, ssm
and vlm decoders and the audio encoder, their attention (the vlm's
gated cross-attention included), the MoE FFN, the Mamba and xLSTM
branches and the KV backends; ``loss_fn`` for training."""

from .model import (decode_step, forward, forward_chunk, init_chunk_buffers,
                    init_decode_state, init_params, loss_fn, prefill)
from .transformer import DecodeState, layer_flags, lm_loss

__all__ = ["DecodeState", "decode_step", "forward", "forward_chunk",
           "init_chunk_buffers", "init_decode_state", "init_params",
           "layer_flags", "lm_loss", "loss_fn", "prefill"]
