"""In-graph metrics and the tiered-store taps (port of
``repro.obs.metrics``, DESIGN.md §10).

* A metrics pytree is ``dict[str, int32 tensor]``; ``zeros`` / ``bump`` /
  ``inc`` / ``merge`` / ``delta`` grow and combine it, and masked ops
  count only enabled lanes.  ``hist_observe`` scatters latencies into the
  one log2 histogram geometry every latency histogram shares
  (``HIST_EDGES_MS``).  None of them reads a tensor on the host.
* ``tiered_metrics`` maps a ``TieredState``'s counters onto the canonical
  names of ``obs.registry`` and derives the composed metrics (misses,
  walks, residency, the saved-metadata gauges).  The port keeps ONE copy
  of the layer-uniform metadata; ``copies`` is the number of layers it
  stands for: counts and byte gauges scale by it (the reference sums one
  copy per layer), the ratio gauges do not.
* ``tap_stash`` snapshots the tap's inputs inside the decode loop: the
  port updates its metadata in place, so the snapshot CLONES the small
  counter and occupancy tensors (a few device copies, no host read; the
  KV pools are never touched).  ``stashed_metrics`` derives the metrics
  of a whole batch of stashes after one transfer to the host.
* ``sim_metrics`` maps the simulator's counters onto their canonical
  ``sim_*`` names.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch._scatter import drop_add

from .registry import LEGACY_TIERED, TIERED_FIELDS, sim_export

# one log2 histogram geometry for every latency histogram in the repo:
# buckets [0, .25), [.25, .5), ..., [256, 512), [512, inf) ms
HIST_EDGES_MS = tuple(0.25 * 2 ** i for i in range(12))
HIST_BUCKETS = len(HIST_EDGES_MS) + 1

I32 = torch.int32


# ---------------------------------------------------------------------------
# in-graph ops (functional; no host reads)
# ---------------------------------------------------------------------------

def zeros(names, device=None) -> dict:
    """Fresh metrics pytree: one int32 scalar per name."""
    return {n: torch.zeros((), dtype=I32, device=device) for n in names}


def bump(value, delta):
    """One counter bump (int32 accumulate)."""
    if isinstance(delta, torch.Tensor):
        return value + delta.to(I32)
    return value + int(delta)


def inc(m: dict, name: str, delta=1, enable=None) -> dict:
    """Counter increment, optionally masked: ``enable`` may be a bool
    scalar or a lane vector (its enabled-lane count times ``delta`` is
    added)."""
    if enable is not None:
        en = torch.as_tensor(enable, device=m[name].device).to(I32)
        d = delta.to(I32) if isinstance(delta, torch.Tensor) else int(delta)
        delta = (en * d).sum(dtype=I32)
    return {**m, name: bump(m[name], delta)}


def hist_zeros(device=None) -> torch.Tensor:
    """Fresh log2-bucket histogram counts [HIST_BUCKETS] int32."""
    return torch.zeros((HIST_BUCKETS,), dtype=I32, device=device)


def bucket_index(value_ms: float) -> int:
    """Bucket of a latency in ms; an edge opens its bucket (0.25 -> 1)."""
    return int(np.searchsorted(np.asarray(HIST_EDGES_MS), value_ms,
                               side="right"))


def hist_observe(counts, values_ms, enable=None):
    """Scatter a batch of latency observations (``values_ms`` [N] float)
    into the bucket counts; disabled lanes (``enable`` [N] bool) count
    nothing."""
    v = torch.atleast_1d(torch.as_tensor(values_ms, device=counts.device))
    edges = torch.tensor(HIST_EDGES_MS, dtype=v.dtype, device=v.device)
    idx = torch.searchsorted(edges, v.contiguous(), right=True).to(I32)
    if enable is not None:
        en = torch.atleast_1d(torch.as_tensor(enable, device=v.device))
        idx = torch.where(en.to(torch.bool), idx, HIST_BUCKETS)
    return drop_add(counts, idx, 1)


def merge(a: dict, b: dict) -> dict:
    """Sum two metrics pytrees (same keys), e.g. per-shard partials."""
    if a.keys() != b.keys():
        raise ValueError(f"merge: keys differ {sorted(a)} vs {sorted(b)}")
    return {k: a[k] + b[k] for k in a}


def delta(cur: dict, prev: dict) -> dict:
    """Counter deltas between two snapshots (keys present in both)."""
    return {k: cur[k] - prev[k] for k in cur if k in prev}


# ---------------------------------------------------------------------------
# taps: a tiered store's counters -> canonical namespace
# ---------------------------------------------------------------------------

_INVALID = -1   # core/remap INVALID

#: the TieredState scalar counters the tap reads
_COUNTER_FIELDS = tuple(TIERED_FIELDS) + ("promo_pages", "demo_pages")
#: every TieredState field ``tiered_metrics`` reads: the stashable subset
#: (small counter and occupancy tensors, never the KV pools)
TAP_FIELDS = _COUNTER_FIELDS + ("slot_owner", "leaf_cnt")


def tap_stash(st) -> dict:
    """A snapshot of the tap's inputs that later in-place updates of
    ``st`` cannot reach: the scalar counters stacked into one fresh
    tensor, ``slot_owner`` [fast_slots] and ``leaf_cnt`` [n_leaf] cloned.
    Three device launches; nothing is read on the host."""
    counters = torch.stack([getattr(st, f).reshape(())
                            for f in _COUNTER_FIELDS])
    out = dict(zip(_COUNTER_FIELDS, counters.unbind(0)))
    out["slot_owner"] = st.slot_owner.clone()
    out["leaf_cnt"] = st.leaf_cnt.clone()
    return out


def stashed_metrics(stashes, page_bytes: int, *, n_logical=None,
                    fast_slots=None, leaf_entries=None,
                    copies: int = 1) -> dict:
    """``tiered_metrics`` of every ``tap_stash`` in ``stashes`` (one
    shape): ``{name: [value per stash]}``.  All stashes go to the host in
    one transfer; the metrics are derived there (counts as ints, the
    ratio gauges as float32 arithmetic, the reference's)."""
    stashes = list(stashes)
    if not stashes:
        return {}
    widths = [stashes[0][f].numel() for f in TAP_FIELDS]
    flat = torch.cat([s[f].reshape(-1) for s in stashes for f in TAP_FIELDS])
    rows = flat.cpu().numpy().astype(np.int64).reshape(len(stashes), -1)
    cols = dict(zip(TAP_FIELDS, np.split(rows, np.cumsum(widths)[:-1], 1)))
    g = {f: cols[f].sum(1) * copies for f in _COUNTER_FIELDS}
    out = {canon: g[field] for field, canon in TIERED_FIELDS.items()}
    misses = out["trimma_translated_pages_total"] \
        - out["trimma_irc_hits_total"]
    out["trimma_irc_misses_total"] = misses
    out["trimma_irt_walks_total"] = misses
    out["trimma_promoted_bytes_total"] = g["promo_pages"] * page_bytes
    out["trimma_demoted_bytes_total"] = g["demo_pages"] * page_bytes
    resident = (cols["slot_owner"] != _INVALID).sum(1) * copies
    allocated = (cols["leaf_cnt"] > 0).sum(1) * copies
    out["trimma_fast_resident_pages"] = resident
    out["trimma_metadata_pages"] = allocated
    f32 = np.float32
    if n_logical is not None and fast_slots is not None:
        out["trimma_identity_entry_ratio"] = \
            f32(1.0) - resident.astype(f32) / f32(n_logical * copies)
    if leaf_entries is not None:
        out["trimma_irt_leaf_occupancy"] = \
            allocated.astype(f32) / f32(widths[-1] * copies)
        out["trimma_metadata_bytes"] = allocated * leaf_entries * 4
    return {k: [v.item() for v in vals] for k, vals in out.items()}


def tiered_metrics(st, page_bytes: int, *, n_logical: int | None = None,
                   fast_slots: int | None = None,
                   leaf_entries: int | None = None, copies: int = 1) -> dict:
    """Counters and gauges of a ``TieredState`` under their canonical
    names, as Python numbers (one transfer to the host).  ``copies`` is
    the number of layers the one shared metadata copy stands for."""
    many = stashed_metrics([tap_stash(st)], page_bytes, n_logical=n_logical,
                           fast_slots=fast_slots, leaf_entries=leaf_entries,
                           copies=copies)
    return {k: v[0] for k, v in many.items()}


def legacy_counters(metrics: dict) -> dict:
    """Canonical metric dict -> the legacy short-key counters dict."""
    return {short: metrics[canon] for short, canon in LEGACY_TIERED.items()
            if canon in metrics}


def sim_metrics(counters: dict) -> dict:
    """Simulator counters (``core/simulator.run`` output) under canonical
    ``sim_*`` names, plus the derived remap-cache miss count."""
    out = sim_export(counters)
    if {"sim_accesses_total", "sim_rc_hits_total"} <= out.keys():
        out["sim_rc_misses_total"] = (out["sim_accesses_total"]
                                      - out["sim_rc_hits_total"])
    return out
