"""core/remap: the Trimma metadata engine (iRT + iRC), port of
``repro.core.remap``."""

from .irt import E, INVALID, init_tables, pack_alloc_bits, walk
from .rcache import IDENTITY, RemapCacheGeometry

__all__ = ["E", "INVALID", "IDENTITY", "RemapCacheGeometry", "init_tables",
           "pack_alloc_bits", "walk"]
