"""Serving steps (the part of ``repro.serve.decode`` the port needs:
``make_tiered_decode_step`` against one tiered KV store, and
``make_chunk_prefill_fn`` for chunked prefill).  PyTorch runs eagerly,
so there is no jit and no sharding here."""

from __future__ import annotations

import torch

from repro_torch._scatter import on_device
from repro_torch.serve import tiered as srv
from repro_torch.tiered import kvcache as tk

PATHS = ("zero_copy", "fused", "concat")


def make_tiered_decode_step(tcfg: tk.TieredConfig, *,
                            path: str = "zero_copy",
                            n_pages: int | None = None):
    """One decode step against the store: append this step's K/V token per
    lane, then read attention through the translated page table.

    ``path`` (all give the same output on live lanes):
      "zero_copy"  cached device table + split-pool kernel, no pool byte
                   moves (the production path);
      "fused"      one fused append+attend kernel (``srv.attend_tokens``);
      "concat"     the legacy baseline: full re-translation + unified-pool
                   concatenation per step (pair with
                   ``cache_device_table=False``).

    Returned signature: step(state, q, k_new, v_new, pos) -> (out, state)
    with q [B, KV, G, hd], k_new/v_new [B, KV, hd] and ``pos`` a Python
    int or an int tensor on the state's device, scalar or [B]
    (seq_lens = max(pos + 1, 0): a negative lane reads nothing).  With
    ``path="fused"`` a token axis may ride second (q [B, K, KV, G, hd],
    k_new/v_new [B, K, KV, hd]).  ``n_pages`` (fused only) is the
    live-page bucket."""
    if path not in PATHS:
        raise ValueError(f"unknown path {path!r}; want one of {PATHS}")
    if path == "fused":
        def fused_step(st, q, k_new, v_new, pos):
            if q.dim() == 4:            # k = 1 with the flat signature
                q, k_new, v_new = q[:, None], k_new[:, None], v_new[:, None]
            return srv.attend_tokens(tcfg, st, q, k_new, v_new, pos,
                                     n_pages=n_pages)
        return fused_step
    if n_pages is not None:
        raise ValueError(
            f"n_pages (live-page bucket) only applies to path='fused'; "
            f"got path={path!r}")
    read = srv.attend if path == "zero_copy" else srv.attend_concat

    def step(st, q, k_new, v_new, pos):
        dev = st.leaf_table.device
        pos = on_device(pos, torch.int32, dev)
        seqs = torch.arange(tcfg.n_seqs, dtype=torch.int32, device=dev)
        st = tk.append_token(tcfg, st, seqs, k_new, v_new, pos)
        seq_lens = torch.clamp(pos + 1, min=0).expand(tcfg.n_seqs)
        return read(tcfg, st, q, seq_lens.contiguous())

    return step


def make_chunk_prefill_fn(cfg, *, logits: bool = False):
    """One chunked-prefill step (DESIGN.md §9): step(params, chunk_tokens
    [B, C] (array or tensor), buf_k, buf_v, start) -> (buf_k, buf_v),
    plus the chunk's logits [B, C, vocab] with ``logits=True``.  The
    buffers [L, B, P, KV, hd] (``models.init_chunk_buffers``) are padded
    to the length P the one-shot prefill would run at, and rows
    [start, start + C) are written in place (``models.forward_chunk``)."""
    from repro_torch.models.transformer import forward_chunk

    def step(params, chunk_tokens, buf_k, buf_v, start):
        tokens = torch.as_tensor(chunk_tokens, device=buf_k.device)
        return forward_chunk(cfg, params, tokens, buf_k, buf_v, start,
                             return_logits=logits)

    return step
