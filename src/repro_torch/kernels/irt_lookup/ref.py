"""Plain PyTorch versions of the two-level iRT walk (port of
``repro.kernels.irt_lookup.ref``) and of the walk with both homes."""

from __future__ import annotations

import torch

INVALID = -1
E = 64                     # entries per leaf block


def irt_lookup_ref(ids, home, l1_bits, leaf_table):
    """ids, home [N] int32; l1_bits [n_words] int32 (bit per leaf);
    leaf_table [n_leaf*E] int32 -> [N] int32: the leaf entry where the
    leaf is allocated and the entry valid, else ``home``.  The word is
    shifted in int64, so bit 31 (the int32 sign bit) reads exactly."""
    i = ids.long()
    leaf = torch.div(i, E, rounding_mode="floor")
    word = torch.div(leaf, 32, rounding_mode="floor")
    bits = l1_bits[word].long() & 0xFFFFFFFF
    allocated = ((bits >> (leaf % 32)) & 1) == 1
    entries = leaf_table[i]
    return torch.where(allocated & (entries != INVALID), entries,
                       home).to(torch.int32)


def irt_walk2_ref(ids, base: int, l1_bits, leaf_table, probe=None):
    """The walk with both homes at once: (walked, dev), each [N] int32.
    ``walked`` defaults to INVALID, ``dev`` to ``base + id``; with the iRC
    probe's ``(hit, val, id_hit)`` ``dev`` is the whole translation: a hit
    takes ``val`` (``base + id`` on an identity hit), a miss the walk."""
    walked = irt_lookup_ref(ids, torch.full_like(ids, INVALID), l1_bits,
                            leaf_table)
    home = base + ids
    dev = torch.where(walked == INVALID, home, walked)
    if probe is not None:
        hit, val, id_hit = probe
        dev = torch.where(hit, torch.where(id_hit, home, val), dev)
    return walked, dev.to(torch.int32)
