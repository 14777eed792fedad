"""Decoders of the dense, MoE, hybrid and ssm families, their attention,
the MoE FFN, the Mamba and xLSTM branches and the KV backends (port of
``repro.models``)."""

from .transformer import (DecodeState, decode_step, forward, forward_chunk,
                          init_chunk_buffers, init_decode_state, init_params,
                          layer_flags, prefill)

__all__ = ["DecodeState", "decode_step", "forward", "forward_chunk",
           "init_chunk_buffers", "init_decode_state", "init_params",
           "layer_flags", "prefill"]
