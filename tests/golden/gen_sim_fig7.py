"""Regenerate the paper-size reference counters
(tests/golden/sim_fig7_counters.json).

Run from the repo root (about 20 s a scheme on a CPU):

    PYTHONPATH=src python tests/golden/gen_sim_fig7.py

The JSON pins the JAX simulator's raw counters and metadata footprint for
the Figure 7 sweep at the benchmarks' real size: the 14 workloads of
``benchmarks/common.WLS``, 49,152 accesses each, seed 3, the ``BASE``
geometry (2048 fast blocks, 32:1, 4 sets) and HBM3+DDR5 timing, for the 8
schemes of ``benchmarks/common.scheme_config``; the flat schemes' traces
are relabelled by first touch.  It also holds each scheme's ``SimConfig``
keywords and a crc32 of every trace's blocks (as generated, and
relabelled) and writes, so that another implementation can rebuild the
same configurations and check that it generates the same traces.  The
schemes are restated here (not imported from ``benchmarks``) so that the
file reads as data.
"""

import json
import os
import sys
import time
import zlib

import numpy as np

from repro.core import (HBM3_DDR5, WORKLOADS, SimConfig, generate_trace,
                        relabel_first_touch, run_many)
from repro.core.simulator import COUNTERS

BASE = dict(fast_total_blocks=2048, ratio=32, n_sets=4)
TRACE_LEN = 49152
SEED = 3
TIMING = "hbm3+ddr5"
WLS = ["cactuBSSN", "lbm", "fotonik3d", "roms", "xz",
       "pr", "bfs", "cc", "sssp", "bc", "tc",
       "silo_tpcc", "ycsb_a", "ycsb_b"]

SCHEMES = {
    "trimma_c": dict(mode="cache", meta="irt", remap_cache="irc",
                     install_threshold=2),
    "trimma_f": dict(mode="flat", meta="irt", remap_cache="irc"),
    "linear_c": dict(mode="cache", meta="linear",
                     remap_cache="conventional", install_threshold=2),
    "mempod": dict(mode="flat", meta="linear", remap_cache="conventional"),
    "alloy": dict(mode="cache", meta="alloy", remap_cache="none", n_sets=1),
    "lohhill": dict(mode="cache", meta="lohhill", remap_cache="none",
                    n_sets=1),
    "ideal_c": dict(mode="cache", meta="ideal", remap_cache="ideal",
                    install_threshold=2),
    "ideal_f": dict(mode="flat", meta="ideal", remap_cache="ideal"),
}


def config_kwargs(name: str) -> dict:
    return {**BASE, **SCHEMES[name]}


def crc(a: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(a).tobytes())


def traces(n_phys: int):
    """{workload: (blocks, relabelled blocks, writes)} at the sweep's
    length and seed."""
    out = {}
    for wl in WLS:
        blocks, writes = generate_trace(WORKLOADS[wl], n_phys, TRACE_LEN,
                                        SEED)
        out[wl] = (blocks, relabel_first_touch(blocks), writes)
    return out


def main():
    here = os.path.dirname(os.path.abspath(__file__))
    cfgs = {name: SimConfig(**config_kwargs(name)).validate()
            for name in SCHEMES}
    slow = {c.slow_blocks for c in cfgs.values()}
    assert len(slow) == 1, "every scheme generates over one slow tier"
    tr = traces(slow.pop())
    data = {
        "trace_len": TRACE_LEN, "seed": SEED, "timing": TIMING,
        "workloads": WLS,
        "configs": {name: config_kwargs(name) for name in SCHEMES},
        "trace_crc32": {wl: {"blocks": crc(b), "blocks_flat": crc(f),
                             "writes": crc(w)}
                        for wl, (b, f, w) in tr.items()},
        "counters": {},
    }
    for name, cfg in cfgs.items():
        t0 = time.time()
        flat = cfg.mode == "flat"
        blocks = np.stack([tr[wl][1 if flat else 0] for wl in WLS])
        writes = np.stack([tr[wl][2] for wl in WLS])
        outs = run_many(cfg, HBM3_DDR5, blocks, writes)
        data["counters"][name] = {
            wl: {**{c: int(o[c]) for c in COUNTERS},
                 "metadata_blocks": int(o["metadata_blocks"])}
            for wl, o in zip(WLS, outs)}
        print(f"{name}: {time.time() - t0:.1f} s")
    path = os.path.join(here, "sim_fig7_counters.json")
    with open(path, "w") as f:
        json.dump(data, f, indent=1, sort_keys=True)
    print(f"wrote {path}")


if __name__ == "__main__":
    sys.exit(main())
