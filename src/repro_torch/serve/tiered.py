"""Tiered KV serving path (port of ``repro.serve.tiered``): the decode
reads of one Trimma-managed store, and its maintenance.

* ``attend``: the zero-copy read.  ``tk.lookup`` translates the live
  pages (cached ``dev_table`` rows; the iRC probe and iRT walk for rows
  not yet cached), then ``paged_attention_split`` reads the fast and slow
  pools in place.  No pool byte moves.
* ``attend_concat``: the legacy baseline.  Every row is translated (pair
  it with ``cache_device_table=False``), the pools are concatenated (a
  full copy of the store) and ``paged_attention`` reads the copy.
* ``attend_tokens``: the fused k-token append+attend; the leaf entries are
  the translation.

All three give the same output: ``attend`` equals ``attend_concat`` bit
for bit on every live lane.  ``maintain`` runs one migration-scheduler
pass between steps and ``release`` recycles a lane.
"""

from __future__ import annotations

import torch

from repro_torch._scatter import on_device
from repro_torch.kernels.paged_attention.ops import (
    paged_attention_fused_op, paged_attention_op, paged_attention_split_op)
from repro_torch.obs import metrics as obs_metrics
from repro_torch.tiered import kvcache as tk


def page_table(cfg: tk.TieredConfig, st: tk.TieredState):
    """Full logical page-id table [n_seqs, max_pages_per_seq] int32."""
    dev = st.leaf_table.device
    pages = torch.arange(cfg.max_pages_per_seq, dtype=torch.int32,
                         device=dev)[None, :]
    seqs = torch.arange(cfg.n_seqs, dtype=torch.int32, device=dev)[:, None]
    return tk.logical_page(cfg, seqs, pages)


def live_mask(cfg: tk.TieredConfig, seq_lens):
    """[n_seqs, max_pages_per_seq] bool: page j holds context iff its first
    token position is under the sequence length."""
    pages = torch.arange(cfg.max_pages_per_seq, dtype=torch.int32,
                         device=seq_lens.device)[None, :]
    return pages * cfg.page_tokens < seq_lens[:, None]


def attend(cfg: tk.TieredConfig, st: tk.TieredState, q, seq_lens):
    """q [B, KV, G, hd], seq_lens [B] int32 -> (out [B, KV, G, hd], state):
    lookup over the live pages, then the split-pool read."""
    table, st = tk.lookup(cfg, st, page_table(cfg, st),
                          live=live_mask(cfg, seq_lens))
    out = paged_attention_split_op(q, st.fast_k, st.fast_v, st.slow_k,
                                   st.slow_v, table, seq_lens)
    return out, st


def attend_concat(cfg: tk.TieredConfig, st: tk.TieredState, q, seq_lens):
    """LEGACY baseline: every row translated, the pools concatenated, the
    unified-pool read.  Pair with ``cache_device_table=False``."""
    table, st = tk.lookup(cfg, st, page_table(cfg, st))
    uk, uv = tk.unified_pools(st)
    return paged_attention_op(q, uk, uv, table, seq_lens), st


def attend_tokens(cfg: tk.TieredConfig, st: tk.TieredState, q, k_new,
                  v_new, pos, *, n_pages: int | None = None):
    """Fused k-token decode read+write: q [B, K, KV, G, hd], k_new/v_new
    [B, K, KV, hd], pos [B] (first new token's position; < 0 parks the
    lane).  Returns (out [B, K, KV, G, hd], state).  One kernel overlays
    the new rows and attends all K tokens per-token-causally; the rows
    then persist through ``tk.append_tokens``, and each live page counts
    one read (``tk.record_reads``) and one touch.  ``n_pages`` is the
    live-page bucket: the caller guarantees ``n_pages * page_tokens >
    max(pos) + K - 1``."""
    K = q.shape[1]
    pos = on_device(pos, torch.int32, q.device).expand(cfg.n_seqs) \
        .contiguous()
    entries = st.leaf_table[:cfg.n_logical].view(cfg.n_seqs,
                                                 cfg.max_pages_per_seq)
    if n_pages is not None and n_pages < cfg.max_pages_per_seq:
        entries = entries[:, :n_pages]
    out = paged_attention_fused_op(q, st.fast_k, st.fast_v, st.slow_k,
                                   st.slow_v, entries, k_new, v_new, pos)
    seqs = torch.arange(cfg.n_seqs, dtype=torch.int32, device=q.device)
    st = tk.append_tokens(cfg, st, seqs, k_new, v_new, pos)
    lv = live_mask(cfg, torch.where(pos >= 0, pos + K, 0)).reshape(-1)
    table = page_table(cfg, st).reshape(-1)
    st = tk.record_reads(cfg, st, table, lv)
    return out, tk.record_touches(cfg, st, table, lv)


def maintain(cfg: tk.TieredConfig, st: tk.TieredState,
             max_moves: int | None = None, err=None) -> tk.TieredState:
    """Between decode steps: one policy-scheduler pass (bounded promotion
    and demotion queues, epoch decay); every move writes its translation
    through ``dev_table``.  ``err``: the caller's out-of-range flag for
    the pass's copies (``kvcache._replay_descs``)."""
    return tk.run_scheduler(cfg, st, max_moves=max_moves, err=err)


def release(cfg: tk.TieredConfig, st: tk.TieredState,
            seq: int) -> tk.TieredState:
    """Recycle one lane: drop its pages from every metadata structure."""
    return tk.release_seq(cfg, st, seq)


def metrics(cfg: tk.TieredConfig, st: tk.TieredState,
            copies: int = 1) -> dict:
    """Canonical telemetry of one store; ``copies`` layers share its
    metadata (``obs.metrics.tiered_metrics``)."""
    return obs_metrics.tiered_metrics(st, page_bytes=cfg.page_bytes,
                                      n_logical=cfg.n_logical,
                                      fast_slots=cfg.fast_slots,
                                      leaf_entries=tk.E, copies=copies)
