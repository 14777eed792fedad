"""Synthetic post-LLC access-trace generators; a copy of
``repro.core.traces`` (numpy with crc32 seeding: the same traces bit for
bit).

The paper evaluates SPEC CPU 2017 (rate mode, 16 copies), GAP, silo/TPC-C and
memcached/YCSB under zsim.  Those binaries + a Pin-based simulator are not
available here, so we substitute parameterised synthetic traces that model the
locality regimes that drive Trimma's behaviour (DESIGN.md §2, "Workload
substitution").  Each generator produces a stream of (block_id, is_write)
post-LLC accesses over a working set expressed as a fraction of the slow tier.

The knobs:
  ws_frac       working-set size as a fraction of the OS-visible space
  zipf_s        skew of the reuse distribution (0 == uniform)
  stream_frac   fraction of accesses that belong to sequential scans
  run_len       mean sequential-run length (in blocks) for the stream part
  write_frac    store fraction
  n_streams     number of concurrent sequential cursors (16 cores -> 16)

Mixes are calibrated so that baseline behaviours land in the ranges the paper
reports (e.g. conventional remap-cache hit rate ~54%, identity-mapping hit
rate ~6%); see benchmarks/fig11_irc.py.
"""

from __future__ import annotations

import dataclasses
import zlib

import numpy as np


@dataclasses.dataclass(frozen=True)
class TraceSpec:
    name: str
    ws_frac: float = 0.5
    zipf_s: float = 0.6
    stream_frac: float = 0.3
    run_len: int = 8
    write_frac: float = 0.25
    n_streams: int = 16


# Proxies named after the paper's workloads (Figure 7).  Parameters reflect
# the qualitative regime of each application, not measured traces.
WORKLOADS: dict[str, TraceSpec] = {
    # SPEC CPU 2017 memory-intensive subset (rate mode): large footprints.
    "cactuBSSN": TraceSpec("cactuBSSN", ws_frac=0.35, zipf_s=0.9, stream_frac=0.55, run_len=24, write_frac=0.30),
    "lbm":       TraceSpec("lbm",       ws_frac=0.85, zipf_s=0.10, stream_frac=0.85, run_len=48, write_frac=0.45),
    "fotonik3d": TraceSpec("fotonik3d", ws_frac=0.60, zipf_s=0.30, stream_frac=0.70, run_len=32, write_frac=0.35),
    "roms":      TraceSpec("roms",      ws_frac=0.55, zipf_s=0.40, stream_frac=0.60, run_len=24, write_frac=0.35),
    "xz":        TraceSpec("xz",        ws_frac=0.95, zipf_s=0.45, stream_frac=0.15, run_len=4,  write_frac=0.30),
    # GAP graph benchmarks: power-law vertex reuse + random edge scans.
    "pr":        TraceSpec("pr",        ws_frac=0.80, zipf_s=0.85, stream_frac=0.25, run_len=8,  write_frac=0.20),
    "bfs":       TraceSpec("bfs",       ws_frac=0.70, zipf_s=0.70, stream_frac=0.30, run_len=6,  write_frac=0.15),
    "cc":        TraceSpec("cc",        ws_frac=0.75, zipf_s=0.60, stream_frac=0.35, run_len=8,  write_frac=0.20),
    "sssp":      TraceSpec("sssp",      ws_frac=0.90, zipf_s=0.55, stream_frac=0.20, run_len=4,  write_frac=0.25),
    "bc":        TraceSpec("bc",        ws_frac=0.80, zipf_s=0.75, stream_frac=0.25, run_len=6,  write_frac=0.15),
    "tc":        TraceSpec("tc",        ws_frac=0.50, zipf_s=0.95, stream_frac=0.20, run_len=8,  write_frac=0.05),
    # in-memory DB / KV stores: hot-set skew, write-heavy (A) vs read-heavy (B).
    "silo_tpcc": TraceSpec("silo_tpcc", ws_frac=0.65, zipf_s=0.90, stream_frac=0.10, run_len=4,  write_frac=0.40),
    "ycsb_a":    TraceSpec("ycsb_a",    ws_frac=0.70, zipf_s=0.99, stream_frac=0.05, run_len=2,  write_frac=0.50),
    "ycsb_b":    TraceSpec("ycsb_b",    ws_frac=0.70, zipf_s=0.99, stream_frac=0.05, run_len=2,  write_frac=0.05),
}


def _zipf_ranks(rng: np.random.Generator, n: int, ws: int, s: float) -> np.ndarray:
    """Sample ``n`` ranks in [0, ws) under a Zipf-like distribution."""
    if s <= 0.01:
        return rng.integers(0, ws, size=n)
    # inverse-CDF sampling on a truncated power law; cheap and deterministic
    u = rng.random(n)
    ranks = ((ws ** (1.0 - s) - 1.0) * u + 1.0) ** (1.0 / (1.0 - s)) - 1.0 \
        if abs(s - 1.0) > 1e-6 else np.expm1(u * np.log(ws))
    return np.minimum(ranks.astype(np.int64), ws - 1)


def generate_trace(spec: TraceSpec, n_phys: int, length: int, seed: int = 0
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Return (block_ids[int32 length], is_write[bool length])."""
    # crc32, not hash(): str hashing is salted per process, which would make
    # traces (and every benchmark/golden number derived from them)
    # irreproducible across runs
    rng = np.random.default_rng(seed ^ zlib.crc32(spec.name.encode()) & 0xFFFF)
    ws = max(int(n_phys * spec.ws_frac), 64)

    # rank -> block id mapping.  Permute at 64-block (leaf-sized) chunks so
    # hot *regions* stay spatially clustered, as in real footprints; a full
    # per-block shuffle would destroy the spatial locality that both iRT leaf
    # packing (Section 3.2) and IdCache sectors (Section 3.4) exploit.
    chunk = 64
    n_chunks = n_phys // chunk
    chunk_perm = rng.permutation(n_chunks)
    perm = (chunk_perm[:, None] * chunk
            + np.arange(chunk)[None, :]).reshape(-1)[:ws]

    n_stream = int(length * spec.stream_frac)
    n_point = length - n_stream

    # pointwise (reuse-skewed) accesses
    point_ranks = _zipf_ranks(rng, n_point, ws, spec.zipf_s)

    # streaming accesses: n_streams cursors walking runs through the ws
    runs = -(-n_stream // max(spec.run_len, 1))
    starts = rng.integers(0, ws, size=max(runs, 1))
    offs = np.arange(spec.run_len, dtype=np.int64)
    stream_ranks = (starts[:, None] + offs[None, :]).reshape(-1)[:n_stream] % ws

    ranks = np.empty(length, dtype=np.int64)
    # interleave deterministically: stream accesses at positions chosen by rng
    pos = rng.permutation(length)
    ranks[pos[:n_stream]] = stream_ranks
    ranks[pos[n_stream:]] = point_ranks

    blocks = perm[ranks].astype(np.int32)
    writes = rng.random(length) < spec.write_frac
    return blocks, writes


def relabel_first_touch(blocks: np.ndarray) -> np.ndarray:
    """Relabel block ids by first-touch rank (flat-mode home assignment).

    Flat-mode systems use the first-touch policy (Section 4: "greedily
    allocating the workload data in the fast memory first").  After
    relabeling, block id == allocation order, so ids below the fast-home
    count land in the fast tier."""
    _, first_idx = np.unique(blocks, return_index=True)
    order = blocks[np.sort(first_idx)]          # distinct ids, touch order
    rank = np.empty(int(blocks.max()) + 1, dtype=np.int32)
    rank[order] = np.arange(len(order), dtype=np.int32)
    return rank[blocks]


def with_deallocs(blocks: np.ndarray, frac: float = 0.05,
                  seed: int = 0) -> np.ndarray:
    """Mark ~frac of accesses as software deallocation hints (beyond-paper,
    Section 3.5): the touched block is freed at that point (it may be
    re-touched later = reallocation).  Returns the dealloc flag array."""
    rng = np.random.default_rng(seed ^ 0xDEA1)
    return rng.random(len(blocks)) < frac
