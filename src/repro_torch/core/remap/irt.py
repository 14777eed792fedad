"""Batch-first iRT table maintenance (Section 3.2), port of
``repro.core.remap.irt``.

The table is a dict of three int32 tensors:

    entries [n_leaf * E] : id -> device slot, INVALID when identity
    l1_bits [n_words]    : 1 bit per leaf, "is the leaf allocated?"
    leaf_cnt [n_leaf]    : live entries per leaf

``walk`` probes both levels in parallel and falls back to the identity
mapping (``home``) when the leaf is unallocated or the entry invalid; a
two-level walk of tensors on a card runs the ``irt_lookup`` kernel at
every batch size (the reference's TPU cutoff ``KERNEL_MIN_BATCH`` is not
carried over).  ``fill`` / ``invalidate`` maintain entries + leaf counts
and re-derive the level-1 words covering the touched leaves from
``leaf_cnt > 0``.  Ops are functional (state in, new tensors out), like
the reference.
"""

from __future__ import annotations

import torch

from repro_torch._scatter import (drop_add, drop_set, pack_u32,
                                  u32_to_i32)
from repro_torch.kernels.irt_lookup.ops import irt_lookup_op
from repro_torch.obs.registry import MetricSpec, register

# canonical metric names for the walk path (DESIGN.md §10): translated
# pages are the lookup lanes the metadata engine actually resolved; a
# walk is one parallel two-level probe
register(
    MetricSpec("trimma_translated_pages_total", "counter",
               "logical pages translated by the metadata engine (iRC "
               "probe + iRT walk; cached device-table rows never reach "
               "it)"),
    MetricSpec("trimma_irt_walks_total", "counter",
               "two-level iRT walks (one per iRC miss; each walk "
               "touches both levels in parallel)"),
)

INVALID = -1
E = 64                     # entries per leaf block (256 B / 4 B, Section 3.2)


def n_words(n_leaf: int) -> int:
    return -(-n_leaf // 32)


def init_tables(n_ids: int, device=None) -> dict:
    """Empty iRT covering ``n_ids`` logical ids (whole leaves)."""
    nl = -(-n_ids // E)
    i32 = dict(dtype=torch.int32, device=device)
    return {
        "entries": torch.full((nl * E,), INVALID, **i32),
        "l1_bits": torch.zeros((n_words(nl),), **i32),
        "leaf_cnt": torch.zeros((nl,), **i32),
    }


def pack_alloc_bits(leaf_cnt: torch.Tensor) -> torch.Tensor:
    """Level-1 bit vector from per-leaf live counts (bit == allocated)."""
    nl = leaf_cnt.shape[0]
    nw = n_words(nl)
    alloc = torch.zeros((nw * 32,), dtype=torch.bool, device=leaf_cnt.device)
    alloc[:nl] = leaf_cnt > 0
    return u32_to_i32(pack_u32(alloc.reshape(nw, 32)))


def walk(ids: torch.Tensor, home: torch.Tensor, l1_bits, entries, *,
         levels: int = 2) -> torch.Tensor:
    """Translate ids [N] -> device slots [N] int32, defaulting to ``home``.

    ``levels == 1`` models a linear (always-allocated) table: only the
    entry's validity is checked.  ``levels == 2`` is the iRT walk
    (``kernels/irt_lookup``: the kernel on a card, its plain version on
    the CPU)."""
    if levels == 1:
        e = entries[ids.long()]
        return torch.where(e != INVALID, e, home).to(torch.int32)
    return irt_lookup_op(ids, home, l1_bits, entries)


def _refresh_words(l1_bits, leaf_cnt, leaves, enable):
    """Re-derive only the l1 words covering ``leaves`` [N]; duplicate words
    across lanes write identical values."""
    nl = leaf_cnt.shape[0]
    words = leaves // 32
    offs = words[:, None] * 32 + torch.arange(32, dtype=torch.int32,
                                              device=leaves.device)[None, :]
    alloc = (offs < nl) & (leaf_cnt[offs.clamp(0, nl - 1).long()] > 0)
    vec = u32_to_i32(pack_u32(alloc))
    idx = torch.where(enable, words, l1_bits.shape[0])     # OOB -> dropped
    return drop_set(l1_bits, idx, vec)


def fill(tab: dict, ids: torch.Tensor, slots: torch.Tensor,
         enable: torch.Tensor) -> dict:
    """Install id -> slot entries for enabled lanes (duplicate enabled ids
    are a caller error: counts would double)."""
    n = tab["entries"].shape[0]
    nl = tab["leaf_cnt"].shape[0]
    entries = drop_set(tab["entries"], torch.where(enable, ids, n), slots)
    leaf_cnt = drop_add(tab["leaf_cnt"], torch.where(enable, ids // E, nl), 1)
    return {"entries": entries, "leaf_cnt": leaf_cnt,
            "l1_bits": _refresh_words(tab["l1_bits"], leaf_cnt, ids // E,
                                      enable)}


def invalidate(tab: dict, ids: torch.Tensor, enable: torch.Tensor) -> dict:
    """Clear id entries for enabled lanes (migration undo / eviction)."""
    n = tab["entries"].shape[0]
    nl = tab["leaf_cnt"].shape[0]
    entries = drop_set(tab["entries"], torch.where(enable, ids, n), INVALID)
    leaf_cnt = drop_add(tab["leaf_cnt"], torch.where(enable, ids // E, nl),
                        -1)
    return {"entries": entries, "leaf_cnt": leaf_cnt,
            "l1_bits": _refresh_words(tab["l1_bits"], leaf_cnt, ids // E,
                                      enable)}
