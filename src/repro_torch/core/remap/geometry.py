"""Fast-tier geometry: set/slot/leaf layout shared by every remap consumer;
port of ``repro.core.remap.geometry``.

The ``Geometry`` dataclass, the precomputed static tables (numpy), and
the leaf-id / home-slot helpers.  The helpers are element-wise and work
alike on Python ints, numpy arrays and torch tensors: ``//`` and ``%``
floor in all three, and ``>>`` of a negative value stays negative, as in
the reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..config import SimConfig

E = 64  # iRT entries per leaf metadata block (256 B / 4 B, Section 3.2)


@dataclasses.dataclass(frozen=True)
class Geometry:
    cfg: SimConfig
    n_sets: int
    log_sets: int
    k_data: int            # data slots per set
    k_meta: int            # lendable metadata slots per set
    k: int                 # slots per set
    lf: int                # forward leaves per set
    li: int                # inverted leaves per set
    n_leaf: int            # total sim-local leaves (all sets)
    n_inter: int           # intermediate-level blocks (always allocated)
    fast_home_blocks: int  # flat mode: blocks whose home is a fast data slot

    @property
    def fast_slots(self) -> int:
        return self.n_sets * self.k


def make_geometry(cfg: SimConfig) -> Geometry:
    n_sets = cfg.n_sets
    if n_sets & (n_sets - 1):
        raise ValueError(f"n_sets must be a power of two, got {n_sets}")
    log_sets = n_sets.bit_length() - 1
    k_data = cfg.fast_data_slots // n_sets
    if k_data < 1:
        raise ValueError("no data slot per set")
    k_meta = cfg.fast_meta_slots // n_sets
    k = k_data + k_meta
    bps = -(-cfg.n_phys // n_sets)           # blocks per set
    lf = -(-bps // E)
    li = -(-k // E)
    n_leaf = n_sets * (lf + li)
    track = cfg.meta == "irt" and cfg.irt_levels >= 2
    n_inter = max(n_sets * -(-(lf + li) // (cfg.block_bytes * 8)), n_sets) \
        if track else 0
    fast_home = k_data * n_sets if cfg.mode == "flat" else 0
    return Geometry(cfg, n_sets, log_sets, k_data, k_meta, k, lf, li,
                    n_leaf, n_inter, fast_home)


def static_tables(g: Geometry) -> dict:
    """Precomputed numpy tables (the plain step keeps them as tensors)."""
    slots = np.arange(g.fast_slots, dtype=np.int32)
    slot_set = slots // g.k
    slot_u = slots % g.k
    slot_is_meta = slot_u >= g.k_data

    # leaf hosted at each lendable meta slot: per set, leaves [0, lf+li) are
    # hosted in meta slots [k_data, k_data + min(k_meta, lf+li)).
    lps = g.lf + g.li
    hosted = np.full(g.fast_slots, -1, dtype=np.int32)
    j = slot_u - g.k_data
    mask = slot_is_meta & (j < lps)
    hosted[mask] = (slot_set[mask] * lps + j[mask]).astype(np.int32)

    # slot hosting each leaf (global leaf id; -1 if not lendable)
    slot_of_leaf = np.full(max(g.n_leaf, 1), -1, dtype=np.int32)
    valid = hosted >= 0
    slot_of_leaf[hosted[valid]] = slots[valid]

    return {
        "slot_set": slot_set, "slot_u": slot_u,
        "slot_is_meta": slot_is_meta.astype(np.bool_),
        "leaf_hosted": hosted, "slot_of_leaf": slot_of_leaf,
    }


# --- id helpers (element-wise, batch-transparent) --------------------------------

def leaf_fwd(g: Geometry, b):
    s = b & (g.n_sets - 1)
    w = b >> g.log_sets
    return s * (g.lf + g.li) + w // E


def leaf_inv(g: Geometry, v):
    s = v // g.k
    u = v % g.k
    return s * (g.lf + g.li) + g.lf + u // E


def home_slot(g: Geometry, p):
    """Flat mode: fast-home slot of phys block p (valid when p < fast_home)."""
    s = p & (g.n_sets - 1)
    u = p >> g.log_sets
    return s * g.k + u


def home_block(g: Geometry, v):
    """Flat mode: the block whose home is data slot v."""
    s = v // g.k
    u = v % g.k
    return (u << g.log_sets) | s
