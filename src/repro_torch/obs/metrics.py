"""Canonical metric view of a tiered store's in-graph counters (the
``tiered_metrics`` tap and the legacy short-key counters of
``repro.obs.metrics``) and the latency histogram geometry
(``HIST_EDGES_MS``, a copy of the reference's); the rest of the
reference's telemetry is still to be ported."""

from __future__ import annotations

import numpy as np
import torch

# log2 latency buckets from 0.25 ms: [.25, .5), [.5, 1), ..., [>= 512)
HIST_EDGES_MS = tuple(0.25 * 2 ** i for i in range(12))
HIST_BUCKETS = len(HIST_EDGES_MS) + 1


def bucket_index(value_ms: float) -> int:
    """Bucket of a latency in ms; an edge opens its bucket (0.25 -> 1)."""
    return int(np.searchsorted(np.asarray(HIST_EDGES_MS), value_ms,
                               side="right"))

# TieredState counter field -> canonical metric name
TIERED_FIELDS = {
    "lookups": "trimma_translated_pages_total",
    "irc_hits": "trimma_irc_hits_total",
    "irc_id_hits": "trimma_irc_id_hits_total",
    "dev_hits": "trimma_dev_table_hits_total",
    "migrations": "trimma_migrations_total",
    "demotions": "trimma_demotions_total",
    "forced_evict": "trimma_forced_evictions_total",
}

# legacy short key (Engine.counters) -> canonical name
LEGACY_TIERED = {
    "lookups": "trimma_translated_pages_total",
    "dev_hits": "trimma_dev_table_hits_total",
    "irc_hits": "trimma_irc_hits_total",
    "migrations": "trimma_migrations_total",
    "demotions": "trimma_demotions_total",
    "forced_evict": "trimma_forced_evictions_total",
    "promo_bytes": "trimma_promoted_bytes_total",
    "demo_bytes": "trimma_demoted_bytes_total",
}

_INVALID = -1


def tiered_metrics(st, page_bytes: int, *, n_logical: int | None = None,
                   fast_slots: int | None = None,
                   leaf_entries: int | None = None, copies: int = 1) -> dict:
    """Counters and gauges of a ``TieredState`` under their canonical
    names, as Python numbers.  ``copies`` is the number of layers the one
    shared metadata copy stands for: the reference keeps a copy per layer
    and sums them, so counts scale by ``copies`` while the ratio gauges
    do not."""
    g = lambda f: int(getattr(st, f).sum()) * copies  # noqa: E731
    out = {canon: g(field) for field, canon in TIERED_FIELDS.items()}
    misses = out["trimma_translated_pages_total"] \
        - out["trimma_irc_hits_total"]
    out["trimma_irc_misses_total"] = misses
    out["trimma_irt_walks_total"] = misses
    out["trimma_promoted_bytes_total"] = g("promo_pages") * page_bytes
    out["trimma_demoted_bytes_total"] = g("demo_pages") * page_bytes
    resident = int((st.slot_owner != _INVALID).sum()) * copies
    allocated = int((st.leaf_cnt > 0).sum()) * copies
    out["trimma_fast_resident_pages"] = resident
    out["trimma_metadata_pages"] = allocated
    if n_logical is not None and fast_slots is not None:
        out["trimma_identity_entry_ratio"] = float(
            1.0 - torch.tensor(resident, dtype=torch.float32)
            / (n_logical * copies))
    if leaf_entries is not None:
        out["trimma_irt_leaf_occupancy"] = float(
            torch.tensor(allocated, dtype=torch.float32)
            / (st.leaf_cnt.numel() * copies))
        out["trimma_metadata_bytes"] = allocated * leaf_entries * 4
    return out


def legacy_counters(metrics: dict) -> dict:
    """Canonical metric dict -> the legacy short-key counters dict."""
    return {short: metrics[canon] for short, canon in LEGACY_TIERED.items()
            if canon in metrics}
