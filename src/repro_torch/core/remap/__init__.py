"""core/remap: the Trimma metadata engine (iRT + iRC), port of
``repro.core.remap``."""

from .geometry import (Geometry, home_block, home_slot, leaf_fwd, leaf_inv,
                       make_geometry, static_tables)
from .irt import E, INVALID, init_tables, pack_alloc_bits, walk
from .rcache import IDENTITY, RemapCacheGeometry

__all__ = ["E", "INVALID", "IDENTITY", "RemapCacheGeometry", "init_tables",
           "pack_alloc_bits", "walk", "Geometry", "make_geometry",
           "static_tables", "leaf_fwd", "leaf_inv", "home_slot",
           "home_block"]
