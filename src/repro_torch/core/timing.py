"""Timing model for the hybrid-memory simulator (Table 1 of the paper);
a copy of ``repro.core.timing``.

We model a 3.2 GHz 16-core host.  Latencies are expressed in CPU cycles.
The simulator accumulates (a) critical-path latency per access and (b) byte
traffic per tier; total runtime combines them as

    T_total = max( lat_sum / MLP,  fast_bytes / BW_fast,
                   slow_rd_bytes / BW_slow + slow_wr_bytes / BW_slow_wr )

i.e. the system is either latency-bound (with ``MLP`` overlapping misses from
the 16 cores) or bandwidth-bound on one of the tiers.  This is a deliberate
simplification of zsim's OOO model; it preserves the paper's *relative*
regimes (NVM-bandwidth-bound workloads benefit from traffic reduction, others
from serve-rate) — see DESIGN.md §2 Layer A.

Latency numbers derived from Table 1:
  HBM3 1600 MHz, RCD-CAS 48-48      -> 60 ns activate+read, 30 ns row hit
  DDR5-4800, RCD-CAS 40-40          -> 33 ns activate+read, 17 ns row hit
  NVM RD 77 ns / WR 231 ns
Bandwidths:
  HBM3 16 ch  ~819 GB/s  -> 256 B/cycle
  DDR5 1 ch   ~38.4 GB/s -> 12 B/cycle   (slow tier of HBM3+DDR5)
  DDR5 2 ch   ~76.8 GB/s -> 24 B/cycle   (fast tier of DDR5+NVM)
  NVM 2 ch    ~32 GB/s   -> 10 B/cycle read, writes 3x costlier
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TimingModel:
    name: str
    t_sram: int = 3            # remap-cache probe (Table 1)
    t_fast: int = 192          # fast-tier access latency (cycles)
    t_fast_meta: int = 96      # metadata access in fast tier (row-buffer hit)
    t_slow_rd: int = 107       # slow-tier read latency
    t_slow_wr: int = 107       # slow-tier write latency (informational)
    bw_fast: float = 256.0     # bytes / cycle
    bw_slow: float = 12.0      # bytes / cycle (reads)
    slow_wr_mult: float = 1.0  # write bandwidth cost multiplier
    mlp: float = 8.0           # overlapped misses (16 cores, OOO)


HBM3_DDR5 = TimingModel(
    name="hbm3+ddr5",
    t_fast=192, t_fast_meta=96,        # HBM3 @1600, 48-48 in CPU cycles
    t_slow_rd=107, t_slow_wr=107,      # DDR5-4800 1ch
    bw_fast=256.0, bw_slow=12.0, slow_wr_mult=1.0,
)

DDR5_NVM = TimingModel(
    name="ddr5+nvm",
    t_fast=107, t_fast_meta=53,        # DDR5-4800 2ch as the fast tier
    t_slow_rd=246, t_slow_wr=739,      # NVM RD 77ns / WR 231ns
    bw_fast=24.0, bw_slow=10.0, slow_wr_mult=3.0,
)

TIMINGS = {"hbm3+ddr5": HBM3_DDR5, "ddr5+nvm": DDR5_NVM}
