"""Decoders of the dense and MoE families, their attention, the MoE FFN
and the KV backends (port of ``repro.models``)."""

from .transformer import (DecodeState, decode_step, forward, forward_chunk,
                          init_chunk_buffers, init_decode_state, init_params)

__all__ = ["DecodeState", "decode_step", "forward", "forward_chunk",
           "init_chunk_buffers", "init_decode_state", "init_params"]
