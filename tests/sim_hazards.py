"""Seeded traces that hit what the batched ``sim_scan`` kernel must get
right (``csrc/sim_scan.cu``: 32 accesses' state in warp 0's registers,
patched by every store; the trackers reloaded after each epoch edge).

Shared by ``test_torch_sim_hazards.py`` (the port's plain loop against
the JAX reference, on the CPU) and ``test_torch_cuda.py`` (the kernel
against the plain loop, on the card).  This module imports no JAX.

Each case is ``(label, scheme, policy preset, policy overrides, dealloc
hints, generator)``.  The generators make [T, L] numpy traces from a
seed; the adaptive ones run the port's plain loop one access at a time
(``sim_scan_ref`` over ``[i, i + 1)``, on the CPU) and choose the next
block from what the last access did, so the hazard is hit by
construction:

  repeat        every other block is one of the last 1-31 accesses', so
                a block comes back inside one batch and across batches;
  victim_next   (cache, on-demand) the next block is the owner an install
                just evicted;
  swap_fb_next  (flat, on-demand) the next block is the home block fb a
                swap just displaced;
  sector_next   (iRC) the next block is an identity block in the same
                32-block sector as an entry the last access rewrote, so
                its walk fills the IdCache from a sector vector that
                store changed;
  tick<shift>   epochs of 1, 2 or 4 accesses (``decay_shift`` 0-2): a
                tick inside every batch, under each tracker and decider;
  dealloc       dealloc hints on blocks that come back.

``trace`` also counts the hazards it made, for the tests to assert that
the trace hits them.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch import core as P
from repro_torch.core import simulator as sim
from repro_torch.kernels.sim_scan.ref import sim_scan_ref

GEOM = dict(fast_total_blocks=256, ratio=8, n_sets=4)
LENGTH = 256
N_TRACES = 2
# (mode, meta, remap cache) of the schemes the cases use
SCHEMES = {"trimma_c": ("cache", "irt", "irc"),
           "trimma_f": ("flat", "irt", "irc"),
           "linear_c": ("cache", "linear", "conventional")}
# the card's file runs every case: every tracker and decider at every
# short epoch; the CPU file (each case also compiles a JAX scan) runs
# these, which hit every hazard: repeats and 1-access epochs, dealloc
# hints with mea at 2-access and recency at 4-access epochs, topk, the
# evicted owner, the displaced home block, the sector fill
TICK_POLICIES = ("threshold", "mea", "recency", "topk")
TICK_SHIFTS = (0, 1, 2)
CPU_LABELS = ("tick0/threshold", "dealloc/trimma_c", "dealloc/trimma_f",
              "tick1/topk", "victim_next/trimma_c", "swap_fb_next/trimma_f",
              "sector_next/trimma_c")


def cases() -> list:
    """Every hazard case."""
    out = [
        ("repeat/trimma_c", "trimma_c", "threshold",
         dict(install_threshold=2), False, "repeat"),
        ("repeat/linear_c", "linear_c", "mea", dict(decay_shift=4), False,
         "repeat"),
        ("victim_next/trimma_c", "trimma_c", "on_demand", {}, False,
         "victim_next"),
        ("swap_fb_next/trimma_f", "trimma_f", "on_demand", {}, False,
         "swap_fb_next"),
        ("sector_next/trimma_c", "trimma_c", "on_demand", {}, False,
         "sector_next"),
        ("sector_next/trimma_f", "trimma_f", "on_demand", {}, False,
         "sector_next"),
        ("dealloc/trimma_c", "trimma_c", "mea", dict(decay_shift=1), True,
         "repeat"),
        ("dealloc/trimma_f", "trimma_f", "recency", dict(decay_shift=2),
         True, "repeat"),
    ]
    for preset in TICK_POLICIES:
        for shift in TICK_SHIFTS:
            out.append((f"tick{shift}/{preset}",
                    "trimma_f" if preset in ("mea", "recency")
                        else "trimma_c", preset, dict(decay_shift=shift),
                        False, "repeat"))
    return out


def case(label):
    return next(c for c in cases() if c[0] == label)


def config_kwargs(case) -> dict:
    """SimConfig keywords of a case, the policy left out (each package
    builds its own)."""
    _, scheme, _, _, dealloc, kind = case
    mode, meta, rc = SCHEMES[scheme]
    kw = dict(GEOM, mode=mode, meta=meta, remap_cache=rc,
              dealloc_hints=dealloc)
    if kind == "sector_next":
        # an IdCache of 4 lines: a sector's line is evicted often, so an
        # identity block's walk fills it again
        kw.update(id_sets=2, id_ways=2)
    return kw


def config(case):
    """The port's SimConfig of a case."""
    _, _, preset, over, _, _ = case
    return P.SimConfig(**config_kwargs(case),
                       policy=P.get_policy(preset, **over)).validate()


def _hot(rng, cfg, n):
    """n blocks from a hot set of 96 (slow-homed blocks in flat mode)."""
    lo = P.make_geometry(cfg).fast_home_blocks if cfg.mode == "flat" else 0
    hot = rng.choice(np.arange(lo, cfg.n_phys), 96, replace=False)
    return hot[rng.integers(0, 96, n)].astype(np.int32)


def _repeat(rng, cfg, T, L):
    blocks = np.stack([_hot(rng, cfg, L) for _ in range(T)])
    for t in range(T):
        for i in range(1, L, 2):
            blocks[t, i] = blocks[t, i - 1 - rng.integers(0, min(i, 31))]
    return blocks


def _state(cfg, T):
    return sim.init_state(cfg, sim.make_geometry(cfg), T, "cpu")


def _step(cfg, st, blocks, writes, deallocs, i):
    """Access i of every trace through the plain loop; returns the remap
    rows before and after it."""
    before = st["remap"].clone().numpy()
    sim_scan_ref(cfg, P.HBM3_DDR5, st, torch.as_tensor(blocks),
                 torch.as_tensor(writes), torch.as_tensor(deallocs), i,
                 i + 1)
    return before, st["remap"].numpy()


def _adaptive(rng, cfg, T, L, kind, writes, deallocs):
    """Blocks chosen access by access; returns them and the number of
    accesses that hit the hazard."""
    g = P.make_geometry(cfg)
    lo = g.fast_home_blocks if cfg.mode == "flat" else 0
    if kind in ("victim_next", "sector_next") and cfg.mode == "cache":
        # one set's blocks: the set fills after k installs, then every
        # miss evicts
        pool = np.arange(0, cfg.n_phys, cfg.n_sets)[:3 * g.k]
    else:
        pool = np.arange(lo, cfg.n_phys)
    blocks = np.zeros((T, L), np.int32)
    blocks[:, 0] = rng.choice(pool, T)
    st = _state(cfg, T)
    walks = st["counters"][:, sim.COUNTERS.index("walks")]
    hits, near_pick = 0, np.zeros(T, bool)
    for i in range(L):
        w0 = walks.clone()
        before, after = _step(cfg, st, blocks, writes, deallocs, i)
        walked = (walks - w0).numpy() > 0
        for t in range(T):
            # the sector fill: a walk of the block picked beside the last
            # access's store, to an identity entry (an IdCache fill)
            hits += int(near_pick[t] and walked[t]
                        and before[t, blocks[t, i]] == -1)
            near_pick[t] = False
            if i + 1 == L:
                continue
            nxt = int(rng.choice(pool))
            changed = np.nonzero(before[t] != after[t])[0]
            if kind == "victim_next":
                gone = [o for o in changed
                        if before[t, o] >= 0 and after[t, o] == -1]
                if gone and rng.random() < 0.8:
                    nxt, hits = int(gone[0]), hits + 1
            elif kind == "swap_fb_next":
                fbs = [x for x in changed
                       if before[t, x] == -1 and after[t, x] <= -2]
                if fbs and rng.random() < 0.8:
                    nxt, hits = int(fbs[0]), hits + 1
            elif kind == "sector_next":
                # an entry outside this access's own sector (an evicted
                # owner, a displaced home block): that sector's IdCache
                # line was not just filled by this access's walk
                other = [x for x in changed
                         if x >> 5 != blocks[t, i] >> 5]
                if other and rng.random() < 0.8:
                    x = int(rng.choice(other))
                    near = [y for y in range(x & ~31,
                                             min((x | 31) + 1, cfg.n_phys))
                            if y != x and after[t, y] == -1]
                    if near:
                        nxt, near_pick[t] = int(rng.choice(near)), True
            blocks[t, i + 1] = nxt
    return blocks, hits


@functools.lru_cache(maxsize=None)
def _trace(label, seed, length, n_traces):
    return _make_trace(case(label), seed, length, n_traces)


def trace(case, seed: int = 0, length: int = LENGTH,
          n_traces: int = N_TRACES):
    """(blocks [T, L] int32, writes [T, L] bool, deallocs [T, L] bool,
    hazards) of a case, from ``seed`` (made once per process; the arrays
    are copies)."""
    blocks, writes, deallocs, hazards = _trace(case[0], seed, length,
                                               n_traces)
    return blocks.copy(), writes.copy(), deallocs.copy(), hazards


def _make_trace(case, seed, length, n_traces):
    """(blocks [T, L] int32, writes [T, L] bool, deallocs [T, L] bool,
    hazards) of a case, from ``seed``.  ``hazards`` counts the accesses
    that hit the case's hazard: a block seen 1-31 accesses before
    (repeat), or an adaptive choice (the evicted owner, the displaced
    home block: the next access; the sector fill: a walk that filled the
    IdCache right after a store to the sector)."""
    label, _, _, _, dealloc, kind = case
    cfg = config(case)
    rng = np.random.default_rng([seed, sum(map(ord, label))])
    T, L = n_traces, length
    writes = rng.random((T, L)) < 0.3
    deallocs = np.zeros((T, L), bool)
    if kind == "repeat":
        blocks = _repeat(rng, cfg, T, L)
        hazards = sum(int(blocks[t, i] in blocks[t, max(0, i - 31):i])
                      for t in range(T) for i in range(L))
    else:
        blocks, hazards = _adaptive(rng, cfg, T, L, kind, writes, deallocs)
    if dealloc:
        # dead blocks that come back: a hint on every 8th access
        deallocs[:, 3::8] = True
    return blocks, writes, deallocs, hazards
