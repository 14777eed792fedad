"""Batch-first remap cache (Section 3.4), port of
``repro.core.remap.rcache``: the iRC (NonIdCache + sector IdCache), the
one kind the tiered store uses.  The conventional, ``none`` and
``ideal`` kinds serve the reference's simulator and come with it.

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

IDENTITY = -1
_HASH_MULT = 2654435761  # Knuth multiplicative hash


@dataclasses.dataclass(frozen=True)
class RemapCacheGeometry:
    """Static shape of one iRC (Table 1, proportionally scaled)."""

    nid_sets: int = 256
    nid_ways: int = 6
    id_sets: int = 32
    id_ways: int = 16
    sector: int = 32               # blocks covered by one IdCache line

    def __post_init__(self):
        if self.sector != 32:
            raise ValueError("IdCache line is one 32-bit lane")

    @classmethod
    def from_tiered_config(cls, cfg) -> "RemapCacheGeometry":
        return cls(nid_sets=cfg.nid_sets, nid_ways=cfg.nid_ways,
                   id_sets=cfg.id_sets, id_ways=cfg.id_ways)


def _id_index(sb: torch.Tensor, id_sets: int) -> torch.Tensor:
    h = mul_u32(sb, _HASH_MULT) >> 16
    return (h % id_sets).to(torch.int32)


def _bit_lanes(device) -> torch.Tensor:
    return torch.arange(32, dtype=torch.int64, device=device)


def init_state(g: RemapCacheGeometry, device=None) -> dict:
    i32 = dict(dtype=torch.int32, device=device)
    return {
        "nid_tag": torch.full((g.nid_sets, g.nid_ways), -1, **i32),
        "nid_val": torch.full((g.nid_sets, g.nid_ways), IDENTITY, **i32),
        "nid_fifo": torch.zeros((g.nid_sets,), **i32),
        "id_tag": torch.full((g.id_sets, g.id_ways), -1, **i32),
        "id_bits": torch.zeros((g.id_sets, g.id_ways), dtype=torch.int64,
                               device=device),
        "id_fifo": torch.zeros((g.id_sets,), **i32),
    }


def probe(g: RemapCacheGeometry, st, ids: torch.Tensor):
    """Probe a batch of block ids [N] -> (hit, value, id_hit), each [N]."""
    s_n = (ids % g.nid_sets).long()
    n_match = st["nid_tag"][s_n] == ids[:, None]
    nid_hit = n_match.any(-1)
    nid_val = torch.where(n_match, st["nid_val"][s_n], 0).sum(-1) \
        .to(torch.int32)
    sb = ids // g.sector
    bit = (ids % g.sector).to(torch.int64)
    s_i = _id_index(sb, g.id_sets).long()
    i_match = st["id_tag"][s_i] == sb[:, None]
    line = torch.where(i_match, st["id_bits"][s_i], 0).sum(-1) & U32
    id_hit = i_match.any(-1) & (((line >> bit) & 1) == 1)
    hit = nid_hit | id_hit
    val = torch.where(nid_hit, nid_val, IDENTITY).to(torch.int32)
    return hit, val, id_hit


def fill(g: RemapCacheGeometry, st, ids: torch.Tensor, dev: torch.Tensor,
         table: torch.Tensor, enable: torch.Tensor) -> dict:
    """Insert walked entries for ids [N] with device encodings dev [N];
    ``table`` is the ground-truth remap table the IdCache sector vector
    is assembled from."""
    out = {}
    is_identity = dev == IDENTITY
    en_n = enable & ~is_identity
    s_n = ids % g.nid_sets
    w_n = st["nid_fifo"][s_n.long()] % g.nid_ways
    idx = torch.where(en_n, s_n, g.nid_sets)
    out["nid_tag"] = drop_set(st["nid_tag"], (idx, w_n), ids)
    out["nid_val"] = drop_set(st["nid_val"], (idx, w_n), dev)
    out["nid_fifo"] = drop_add(st["nid_fifo"], idx, 1)

    en_i = enable & is_identity
    sb = ids // g.sector
    base = sb * g.sector
    offs = base[:, None] + torch.arange(g.sector, dtype=torch.int32,
                                        device=ids.device)[None, :]
    valid = offs < table.shape[0]
    sector = table[offs.clamp(0, table.shape[0] - 1).long()]
    vec = pack_u32((sector == IDENTITY) & valid)

    s_i = _id_index(sb, g.id_sets)
    present = st["id_tag"][s_i.long()] == sb[:, None]
    have_line = present.any(-1)
    w_fifo = st["id_fifo"][s_i.long()] % g.id_ways
    w_i = torch.where(have_line, first_true(present), w_fifo).to(torch.int32)
    idx = torch.where(en_i, s_i, g.id_sets)
    idx_new = torch.where(en_i & ~have_line, s_i, g.id_sets)
    out["id_tag"] = drop_set(st["id_tag"], (idx, w_i), sb)
    out["id_bits"] = drop_set(st["id_bits"], (idx, w_i), vec)
    out["id_fifo"] = drop_add(st["id_fifo"], idx_new, 1)
    return out


def _cells(sets, mask, n_sets, ways):
    """Cell-granular scatter targets: only the (set, way) cells a lane
    kills/updates are written, so same-set lanes never resurrect an entry
    another lane just killed."""
    rows = torch.where(mask, sets[:, None], n_sets)
    cols = torch.arange(ways, dtype=torch.int32,
                        device=sets.device)[None, :].expand(mask.shape)
    return rows, cols


def invalidate(g: RemapCacheGeometry, st, ids: torch.Tensor,
               enable: torch.Tensor, becomes_identity=False) -> dict:
    """Keep the cache consistent with iRT updates of ids [N]: NonIdCache
    entries die, IdCache bits update in place."""
    becomes_identity = on_device(becomes_identity, torch.bool,
                                 ids.device).expand(ids.shape)
    out = {}
    s_n = ids % g.nid_sets
    kill = (st["nid_tag"][s_n.long()] == ids[:, None]) & enable[:, None]
    out["nid_tag"] = drop_set(st["nid_tag"],
                              _cells(s_n, kill, g.nid_sets, g.nid_ways), -1)
    sb = ids // g.sector
    bit = (ids % g.sector).to(torch.int64)[:, None]
    s_i = _id_index(sb, g.id_sets)
    present = (st["id_tag"][s_i.long()] == sb[:, None]) & enable[:, None]
    new_bit = becomes_identity.to(torch.int64)[:, None]
    line = st["id_bits"][s_i.long()]
    upd = (line & ~(torch.ones_like(bit) << bit) & U32) | (new_bit << bit)
    out["id_bits"] = drop_set(st["id_bits"],
                              _cells(s_i, present, g.id_sets, g.id_ways), upd)
    return out


def invalidate_range(g: RemapCacheGeometry, st, lo, hi,
                     becomes_identity=True) -> dict:
    """Make every cached mapping for ids in ``[lo, hi)`` consistent with a
    bulk reset to identity (a released lane's page rows) in one dense
    pass over the cache arrays."""
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
