"""Batch-first remap caches (Section 3.4), port of
``repro.core.remap.rcache``: the iRC (NonIdCache + sector IdCache), the
kind the tiered store uses, and the simulator's baselines: the
conventional cache (``rc_tag``/``rc_val``/``rc_fifo``), ``none`` (every
probe misses) and ``ideal`` (every probe hits, at no cost).

State is a dict of int32 tensors, except ``id_bits``: the reference keeps
those sector vectors as uint32; here they are int64 holding values in
[0, 2**32) (torch covers few uint32 ops), compared against the reference
as integers.  Every op returns a dict holding only the updated keys.
Lanes of one batch that scatter into the same set resolve last-write-wins
and disabled lanes write nothing, as in the reference.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch._scatter import (U32, drop_add, drop_set, first_true,
                                  mul_u32, on_device, pack_u32)
from repro_torch.obs.registry import MetricSpec, register

# canonical metric names for the counters this module's probes feed
# (accumulated in TieredState; read out by the obs taps, DESIGN.md §10)
register(
    MetricSpec("trimma_irc_hits_total", "counter",
               "iRC hits (NonIdCache + IdCache) on the serving lookup "
               "path"),
    MetricSpec("trimma_irc_id_hits_total", "counter",
               "iRC IdCache (identity sector-vector) hits"),
    MetricSpec("trimma_irc_misses_total", "counter",
               "iRC misses — each one walks the iRT"),
)

IDENTITY = -1
_HASH_MULT = 2654435761  # Knuth multiplicative hash


@dataclasses.dataclass(frozen=True)
class RemapCacheGeometry:
    """Static shape of one remap cache (Table 1, proportionally scaled)."""

    kind: str = "irc"              # "irc" | "conventional" | "none" | "ideal"
    # conventional
    rc_sets: int = 256
    rc_ways: int = 8
    # iRC
    nid_sets: int = 256
    nid_ways: int = 6
    id_sets: int = 32
    id_ways: int = 16
    sector: int = 32               # blocks covered by one IdCache line

    def __post_init__(self):
        if self.kind not in ("irc", "conventional", "none", "ideal"):
            raise ValueError(f"unknown remap-cache kind {self.kind!r}")
        if self.sector != 32:
            raise ValueError("IdCache line is one 32-bit lane")

    @classmethod
    def from_sim_config(cls, cfg) -> "RemapCacheGeometry":
        return cls(kind=cfg.remap_cache, rc_sets=cfg.rc_sets,
                   rc_ways=cfg.rc_ways, nid_sets=cfg.nid_sets,
                   nid_ways=cfg.nid_ways, id_sets=cfg.id_sets,
                   id_ways=cfg.id_ways, sector=cfg.id_sector_blocks)

    @classmethod
    def from_tiered_config(cls, cfg) -> "RemapCacheGeometry":
        return cls(kind="irc", nid_sets=cfg.nid_sets, nid_ways=cfg.nid_ways,
                   id_sets=cfg.id_sets, id_ways=cfg.id_ways)


def _id_index(sb: torch.Tensor, id_sets: int) -> torch.Tensor:
    h = mul_u32(sb, _HASH_MULT) >> 16
    return (h % id_sets).to(torch.int32)


def _bit_lanes(device) -> torch.Tensor:
    return torch.arange(32, dtype=torch.int64, device=device)


def init_state(g: RemapCacheGeometry, device=None, n_traces=None) -> dict:
    """Empty cache arrays; ``n_traces`` prepends a trace axis (the
    simulator's batch, one cache per trace: the ops take those arrays
    flattened to [n_traces * sets, ...] with each lane's ``row``)."""
    lead = () if n_traces is None else (n_traces,)
    i32 = dict(dtype=torch.int32, device=device)
    if g.kind == "conventional":
        return {
            "rc_tag": torch.full(lead + (g.rc_sets, g.rc_ways), -1, **i32),
            "rc_val": torch.full(lead + (g.rc_sets, g.rc_ways), IDENTITY,
                                 **i32),
            "rc_fifo": torch.zeros(lead + (g.rc_sets,), **i32),
        }
    if g.kind != "irc":
        return {}
    return {
        "nid_tag": torch.full(lead + (g.nid_sets, g.nid_ways), -1, **i32),
        "nid_val": torch.full(lead + (g.nid_sets, g.nid_ways), IDENTITY,
                              **i32),
        "nid_fifo": torch.zeros(lead + (g.nid_sets,), **i32),
        "id_tag": torch.full(lead + (g.id_sets, g.id_ways), -1, **i32),
        "id_bits": torch.zeros(lead + (g.id_sets, g.id_ways),
                               dtype=torch.int64, device=device),
        "id_fifo": torch.zeros(lead + (g.id_sets,), **i32),
    }


# ``row`` (an int, or [N]) picks each lane's cache among caches stacked
# along dim 0 (the simulator's one cache per trace, arrays flattened to
# [T * sets, ...]): lane i's set s is row ``row[i] * sets + s``.  The
# tiered store keeps one cache, row 0.  A disabled lane's set goes out of
# range and ``drop_set`` drops it; of lanes with one target the last
# writes.

def _set(arr, enable, s, w, val):
    return drop_set(arr, (torch.where(enable, s, arr.shape[0]), w), val)


def _add(arr, enable, s):
    """+1 at each enabled lane's set."""
    return drop_add(arr, torch.where(enable, s, arr.shape[0]), 1)


def _set_cells(arr, s, mask, val):
    """Cell-granular update of the lanes' sets: only the (set, way) cells
    in ``mask`` [N, W] take ``val``, so same-set lanes never resurrect an
    entry another lane just killed."""
    n_sets, ways = arr.shape[:2]
    r = torch.where(mask, s[:, None], n_sets)
    cols = torch.arange(ways, dtype=torch.int32,
                        device=s.device)[None, :].expand(mask.shape)
    return drop_set(arr, (r, cols), val)


def probe(g: RemapCacheGeometry, st, ids: torch.Tensor, row=0):
    """Probe a batch of block ids [N] -> (hit, value, id_hit), each [N]:
    ``value`` is the device encoding (IDENTITY unless a NonIdCache or
    conventional hit), ``id_hit`` flags IdCache hits."""
    n = ids.shape[0]
    if g.kind in ("ideal", "none"):
        return (torch.full((n,), g.kind == "ideal", dtype=torch.bool,
                           device=ids.device),
                torch.full((n,), IDENTITY, dtype=torch.int32,
                           device=ids.device),
                torch.zeros((n,), dtype=torch.bool, device=ids.device))
    if g.kind == "conventional":
        s = (ids % g.rc_sets + row * g.rc_sets).long()
        match = st["rc_tag"][s] == ids[:, None]
        hit = match.any(-1)
        val = torch.where(match, st["rc_val"][s], 0).sum(-1) \
            .to(torch.int32)
        return (hit, torch.where(hit, val, IDENTITY).to(torch.int32),
                torch.zeros((n,), dtype=torch.bool, device=ids.device))
    s_n = (ids % g.nid_sets + row * g.nid_sets).long()
    n_match = st["nid_tag"][s_n] == ids[:, None]
    nid_hit = n_match.any(-1)
    nid_val = torch.where(n_match, st["nid_val"][s_n], 0).sum(-1) \
        .to(torch.int32)
    sb = ids // g.sector
    bit = (ids % g.sector).to(torch.int64)
    s_i = (_id_index(sb, g.id_sets) + row * g.id_sets).long()
    i_match = st["id_tag"][s_i] == sb[:, None]
    line = torch.where(i_match, st["id_bits"][s_i], 0).sum(-1) & U32
    id_hit = i_match.any(-1) & (((line >> bit) & 1) == 1)
    hit = nid_hit | id_hit
    val = torch.where(nid_hit, nid_val, IDENTITY).to(torch.int32)
    return hit, val, id_hit


def fill(g: RemapCacheGeometry, st, ids: torch.Tensor, dev: torch.Tensor,
         table: torch.Tensor, enable: torch.Tensor, row=0) -> dict:
    """Insert walked entries for ids [N] with device encodings dev [N];
    ``table`` is the ground-truth remap table the IdCache sector vector
    is assembled from (one [n] table per row, stacked: lane i reads
    table ``row[i]``)."""
    if g.kind in ("ideal", "none"):
        return {}
    if g.kind == "conventional":
        s = ids % g.rc_sets + row * g.rc_sets
        w = st["rc_fifo"][s.long()] % g.rc_ways
        return {"rc_tag": _set(st["rc_tag"], enable, s, w, ids),
                "rc_val": _set(st["rc_val"], enable, s, w, dev),
                "rc_fifo": _add(st["rc_fifo"], enable, s)}
    out = {}
    is_identity = dev == IDENTITY
    en_n = enable & ~is_identity
    s_n = ids % g.nid_sets + row * g.nid_sets
    w_n = st["nid_fifo"][s_n.long()] % g.nid_ways
    out["nid_tag"] = _set(st["nid_tag"], en_n, s_n, w_n, ids)
    out["nid_val"] = _set(st["nid_val"], en_n, s_n, w_n, dev)
    out["nid_fifo"] = _add(st["nid_fifo"], en_n, s_n)

    en_i = enable & is_identity
    sb = ids // g.sector
    base = sb * g.sector
    offs = base[:, None] + torch.arange(g.sector, dtype=torch.int32,
                                        device=ids.device)[None, :]
    n_tab = table.shape[-1]
    valid = offs < n_tab
    offs = offs.clamp(0, n_tab - 1).long() \
        + on_device(row * n_tab, torch.int64, ids.device).reshape(-1, 1)
    vec = pack_u32((table.reshape(-1)[offs] == IDENTITY) & valid)

    s_i = _id_index(sb, g.id_sets) + row * g.id_sets
    present = st["id_tag"][s_i.long()] == sb[:, None]
    have_line = present.any(-1)
    w_fifo = st["id_fifo"][s_i.long()] % g.id_ways
    w_i = torch.where(have_line, first_true(present), w_fifo).to(torch.int32)
    out["id_tag"] = _set(st["id_tag"], en_i, s_i, w_i, sb)
    out["id_bits"] = _set(st["id_bits"], en_i, s_i, w_i, vec)
    out["id_fifo"] = _add(st["id_fifo"], en_i & ~have_line, s_i)
    return out


def invalidate(g: RemapCacheGeometry, st, ids: torch.Tensor,
               enable: torch.Tensor, becomes_identity=False,
               row=0) -> dict:
    """Keep the cache consistent with iRT updates of ids [N]: NonIdCache
    (and conventional) entries die, IdCache bits update in place."""
    if g.kind in ("ideal", "none"):
        return {}
    if g.kind == "conventional":
        s = ids % g.rc_sets + row * g.rc_sets
        kill = (st["rc_tag"][s.long()] == ids[:, None]) & enable[:, None]
        return {"rc_tag": _set_cells(st["rc_tag"], s, kill, -1)}
    becomes_identity = on_device(becomes_identity, torch.bool,
                                 ids.device).expand(ids.shape)
    out = {}
    s_n = ids % g.nid_sets + row * g.nid_sets
    kill = (st["nid_tag"][s_n.long()] == ids[:, None]) & enable[:, None]
    out["nid_tag"] = _set_cells(st["nid_tag"], s_n, kill, -1)
    sb = ids // g.sector
    bit = (ids % g.sector).to(torch.int64)[:, None]
    s_i = _id_index(sb, g.id_sets) + row * g.id_sets
    present = (st["id_tag"][s_i.long()] == sb[:, None]) & enable[:, None]
    new_bit = becomes_identity.to(torch.int64)[:, None]
    line = st["id_bits"][s_i.long()]
    upd = (line & ~(torch.ones_like(bit) << bit) & U32) | (new_bit << bit)
    out["id_bits"] = _set_cells(st["id_bits"], s_i, present, upd)
    return out


def invalidate_range(g: RemapCacheGeometry, st, lo, hi,
                     becomes_identity=True) -> dict:
    """Make every cached mapping for ids in ``[lo, hi)`` consistent with a
    bulk reset to identity (a released lane's page rows) in one dense
    pass over the cache arrays."""
    if g.kind in ("ideal", "none"):
        return {}
    if g.kind == "conventional":
        tag = st["rc_tag"]
        return {"rc_tag": torch.where((tag >= lo) & (tag < hi), -1, tag)}
    out = {}
    tag = st["nid_tag"]
    out["nid_tag"] = torch.where((tag >= lo) & (tag < hi), -1, tag)
    sb = st["id_tag"]
    base = sb[..., None].to(torch.int64) * g.sector \
        + _bit_lanes(sb.device)
    inr = (sb[..., None] >= 0) & (base >= lo) & (base < hi)
    mask = pack_u32(inr)
    bits = st["id_bits"]
    out["id_bits"] = (bits | mask) if becomes_identity \
        else (bits & ~mask & U32)
    return out
