"""Dense decoder, its attention and the KV backends (port of
``repro.models``, dense family)."""

from .transformer import (DecodeState, decode_step, forward, forward_chunk,
                          init_chunk_buffers, init_decode_state, init_params)

__all__ = ["DecodeState", "decode_step", "forward", "forward_chunk",
           "init_chunk_buffers", "init_decode_state", "init_params"]
