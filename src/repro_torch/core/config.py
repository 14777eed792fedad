"""Geometry + scheme configuration for the Trimma hybrid-memory simulator;
a copy of ``repro.core.config`` over the port's ``policy.config``.

Everything here mirrors Section 3 / Table 1 of the paper, scaled down so a
trace-driven simulation runs in seconds on CPU while keeping every *ratio*
faithful (slow:fast capacity ratio, metadata-to-capacity fractions, cache
geometry proportions).

Address model
-------------
The unit of management is a *block* (default 256 B).  The simulator works in
block ids; byte addresses never appear.

Cache mode ("-C"): the OS-visible physical space is the slow tier only
(``n_phys == slow_blocks``).  The fast tier is an invisible cache; every block's
*home* is its slow-tier slot, so "identity mapping" == "not currently cached".

Flat mode ("-F"): the OS-visible space is fast-data + slow
(``n_phys == fast_data_slots + slow_blocks``).  Block ``p < fast_data_slots``
has its home in fast slot ``p``; the rest live in the slow tier.  Migration
swaps a slow-home block into a fast slot, displacing the fast-home block to the
slow home of its partner (slow-swap policy, Section 3.2: an evicted block
always returns to its initial place).

Fast-tier layout (per Figure 4)
-------------------------------
``fast_total_blocks`` fast blocks are split into a *data area* and a reserved
*metadata area*.  For a linear remap table the metadata area is
``ceil(n_phys * entry_bytes / block_bytes)`` blocks and is never reusable.  For
iRT the same worst-case region is reserved, but unallocated leaf blocks inside
it are dynamically lent out as extra cache slots (Section 3.3).

Device-address encoding used throughout the simulator:
    dev == IDENTITY (-1)   -> block is at its home location
    dev >= 0               -> block occupies fast slot ``dev``
    dev <= -2              -> block occupies slow slot ``-(dev + 2)``
                              (flat mode only: a displaced fast-home block)
"""

from __future__ import annotations

import dataclasses
import math
from typing import Literal, Optional

from .policy.config import PolicyConfig

IDENTITY = -1

Mode = Literal["cache", "flat"]
MetaScheme = Literal["irt", "linear", "alloy", "lohhill", "ideal"]
RCScheme = Literal["irc", "conventional", "none", "ideal"]


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Static geometry of one simulated hybrid-memory system."""

    # --- capacities (in blocks) ------------------------------------------
    fast_total_blocks: int = 2048          # fast tier size (data + metadata)
    ratio: int = 32                        # slow : fast capacity ratio
    block_bytes: int = 256                 # paper default (Section 4)
    access_bytes: int = 64                 # one LLC-miss transfer
    entry_bytes: int = 4                   # remap-table entry size

    # --- organisation -----------------------------------------------------
    n_sets: int = 4                        # MemPod-style clustering (Section 4)
    mode: Mode = "cache"
    meta: MetaScheme = "irt"
    remap_cache: RCScheme = "irc"

    # --- iRT shape (Section 3.2) ------------------------------------------
    irt_levels: int = 2                    # 1 == linear table fallback

    # --- hotness / migration policy ---------------------------------------
    # The policy axis (trackers, deciders, scheduler — core/policy,
    # DESIGN.md §7).  Replacement/insertion policy is orthogonal to Trimma
    # (Section 3.3), which is why it is pluggable.  ``None`` resolves the
    # three legacy knobs below into the default threshold-counter policy
    # (see ``pol``); passing ``policy=`` overrides them.
    policy: Optional[PolicyConfig] = None
    # DEPRECATED shims (kept working; prefer ``policy=``):
    migrate_threshold: int = 3             # -> policy.promote_threshold
    counter_decay_shift: int = 14          # -> policy.decay_shift
    install_threshold: int = 0             # -> policy.install_threshold
    #   (0 = always-install, the DRAM-cache default used by the
    #    Alloy/Loh-Hill baselines)

    # beyond-paper (Section 3.5 "more saving opportunities"): software
    # deallocation hints recycle iRT entries immediately — a dealloc-marked
    # access clears the block's remap entry without writeback.
    dealloc_hints: bool = False

    # --- remap cache geometry (Table 1 scaled by 1/8, calibrated) ---------
    # Conventional: rc_sets x rc_ways full entries.
    # iRC: nid_sets x nid_ways (pointers) + id_sets x id_ways (32-bit vectors).
    rc_sets: int = 256
    rc_ways: int = 8
    nid_sets: int = 256
    nid_ways: int = 6
    id_sets: int = 32
    id_ways: int = 16
    id_sector_blocks: int = 32             # blocks covered by one IdCache line

    # --- generic tag-matching sweep knob (Figure 1) ------------------------
    tag_ways: int = 0                      # >0: override tag-match ways

    # ----------------------------------------------------------------------
    # Derived geometry
    # ----------------------------------------------------------------------
    @property
    def slow_blocks(self) -> int:
        return self.fast_total_blocks * self.ratio

    @property
    def meta_reserved_blocks(self) -> int:
        """Fast blocks reserved for the remap structure (worst case)."""
        if self.meta in ("alloy", "lohhill", "ideal"):
            return 0  # tags live with data / are free in the ideal case
        n_leaf = _ceil_div(self.n_phys_upper * self.entry_bytes, self.block_bytes)
        if self.meta == "linear" or self.irt_levels == 1:
            return n_leaf
        # iRT: same leaf region + intermediate bit-vector levels (tiny).
        inter = 0
        level = n_leaf
        for _ in range(self.irt_levels - 1):
            level = _ceil_div(level, self.block_bytes * 8 // 1)  # 2048 bits/blk
            inter += max(level, 1)
        return n_leaf + inter

    @property
    def n_phys_upper(self) -> int:
        """Upper bound on OS-visible blocks (used to size the reserved region).

        Flat mode is self-referential (the data area depends on the metadata
        size which depends on the physical space).  We size the region for the
        worst case: all fast blocks OS-visible.
        """
        if self.mode == "cache":
            return self.slow_blocks
        return self.slow_blocks + self.fast_total_blocks

    @property
    def fast_data_slots(self) -> int:
        d = self.fast_total_blocks - self.meta_reserved_blocks
        if d <= 0:
            if self.meta == "irt" and self.irt_levels >= 2:
                # 64:1 regime: the iRT reservation becomes virtual — the
                # data area shrinks to a floor and nearly all cache slots
                # come from unallocated leaf blocks (Section 5.3: the
                # linear table collapses here, iRT keeps working)
                d = self.n_sets
            else:
                raise ValueError(
                    f"metadata region ({self.meta_reserved_blocks} blocks) "
                    f"swallows the fast tier ({self.fast_total_blocks}); "
                    "the paper's 64:1 linear-table collapse scenario")
        # keep sets even
        return max((d // self.n_sets) * self.n_sets, self.n_sets)

    @property
    def fast_meta_slots(self) -> int:
        """Metadata-region blocks that iRT can lend out as cache slots
        (capped by the physical fast tier at extreme ratios)."""
        if self.meta != "irt" or self.irt_levels < 2:
            return 0  # a 1-level iRT degenerates to an always-allocated table
        m = min(self.meta_reserved_blocks,
                self.fast_total_blocks - self.fast_data_slots)
        return max((m // self.n_sets) * self.n_sets, 0)

    @property
    def fast_slots(self) -> int:
        """All fast slots the replacement policy can see (data + lendable)."""
        return self.fast_data_slots + self.fast_meta_slots

    @property
    def n_phys(self) -> int:
        if self.mode == "cache":
            return self.slow_blocks
        return self.fast_data_slots + self.slow_blocks

    @property
    def assoc(self) -> int:
        """Base associativity (data-area slots per set)."""
        return self.fast_data_slots // self.n_sets

    @property
    def blocks_per_set(self) -> int:
        return _ceil_div(self.n_phys, self.n_sets)

    # --- iRT leaf bookkeeping --------------------------------------------
    @property
    def entries_per_leaf(self) -> int:
        return self.block_bytes // self.entry_bytes  # 64 for 256 B / 4 B

    @property
    def n_leaf_fwd(self) -> int:
        return _ceil_div(self.n_phys, self.entries_per_leaf)

    @property
    def n_leaf_inv(self) -> int:
        # inverted entries keyed by fast slot id (Section 3.3: two 4 B entries
        # per reclaimed metadata block)
        return _ceil_div(self.fast_slots, self.entries_per_leaf)

    @property
    def n_leaf(self) -> int:
        return self.n_leaf_fwd + self.n_leaf_inv

    # --- resolved policy ---------------------------------------------------
    @property
    def pol(self) -> PolicyConfig:
        """The effective policy: ``policy=`` if given, else the legacy
        threshold knobs resolved into the default PolicyConfig."""
        if self.policy is not None:
            return self.policy
        return PolicyConfig(promote_threshold=self.migrate_threshold,
                            install_threshold=self.install_threshold,
                            decay_shift=self.counter_decay_shift)

    def validate(self) -> "SimConfig":
        if self.block_bytes % self.entry_bytes \
                or self.fast_total_blocks % self.n_sets:
            raise ValueError(f"blocks must hold whole entries and sets: "
                             f"{self}")
        if self.id_sector_blocks != 32:
            raise ValueError("IdCache line is one int32 lane")
        self.pol.validate()
        _ = self.fast_data_slots  # raises on collapse
        return self


# Convenience constructors -------------------------------------------------

def trimma_cache(**kw) -> SimConfig:
    return SimConfig(mode="cache", meta="irt", remap_cache="irc", **kw).validate()


def trimma_flat(**kw) -> SimConfig:
    return SimConfig(mode="flat", meta="irt", remap_cache="irc", **kw).validate()


def mempod(**kw) -> SimConfig:
    return SimConfig(mode="flat", meta="linear", remap_cache="conventional", **kw).validate()


def linear_cache(**kw) -> SimConfig:
    return SimConfig(mode="cache", meta="linear", remap_cache="conventional", **kw).validate()


def alloy(**kw) -> SimConfig:
    kw.setdefault("n_sets", 0)  # marker: direct-mapped, sets == fast blocks
    cfg = SimConfig(mode="cache", meta="alloy", remap_cache="none",
                    **{**kw, "n_sets": max(kw.get("n_sets") or 1, 1)})
    return cfg.validate()


def lohhill(**kw) -> SimConfig:
    return SimConfig(mode="cache", meta="lohhill", remap_cache="none", **kw).validate()


def ideal(mode: Mode = "cache", **kw) -> SimConfig:
    return SimConfig(mode=mode, meta="ideal", remap_cache="ideal", **kw).validate()
