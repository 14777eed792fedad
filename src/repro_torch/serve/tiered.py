"""Tiered KV serving helpers (the part of ``repro.serve.tiered`` the fused
decode path uses): the logical page table, the live-page mask, and the
telemetry view of a store."""

from __future__ import annotations

import torch

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


def metrics(cfg: tk.TieredConfig, st: tk.TieredState,
            copies: int = 1) -> dict:
    """Canonical telemetry of one store; ``copies`` layers share its
    metadata (``obs.metrics.tiered_metrics``)."""
    return obs_metrics.tiered_metrics(st, page_bytes=cfg.page_bytes,
                                      n_logical=cfg.n_logical,
                                      fast_slots=cfg.fast_slots,
                                      leaf_entries=tk.E, copies=copies)
