"""Quickstart on the PyTorch port: the paper's two techniques in one
script, the port's counterpart of ``quickstart.py``.

1. Run the hybrid-memory simulator: Trimma vs the linear-table baseline
   on a graph-analytics-like trace (Figure 7/9/11 in miniature); on the
   card each run is one ``sim_scan`` launch.
2. Drive the tiered KV store: the same metadata scheme managing a
   two-tier KV pool for serving.

    PYTHONPATH=src python examples/torch_quickstart.py
    ... --device cpu       # the plain versions on the CPU
    EXAMPLES_SMOKE=1 ...   # tiny geometry + short trace for CI
"""
import argparse
import os
import sys

sys.path.insert(0, "src")

import torch  # noqa: E402

from repro_torch.core import (HBM3_DDR5, WORKLOADS, generate_trace,  # noqa: E402
                              mempod, relabel_first_touch, run, trimma_flat)
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.tiered import kvcache as tk  # noqa: E402

SMOKE = os.environ.get("EXAMPLES_SMOKE") == "1"
GEOM = dict(fast_total_blocks=256, ratio=8, n_sets=4) if SMOKE else {}

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
dev = resolve_device(ap.parse_args().device)

# --- 1. the simulator ------------------------------------------------------
print("=== Trimma vs MemPod (linear remap table) on a pagerank-like trace ===")
trimma, baseline = trimma_flat(**GEOM), mempod(**GEOM)
blocks, writes = generate_trace(WORKLOADS["pr"], trimma.slow_blocks,
                                4096 if SMOKE else 32768)
blocks = relabel_first_touch(blocks)

out_t = run(trimma, HBM3_DDR5, blocks, writes, device=dev)
out_b = run(baseline, HBM3_DDR5, blocks, writes, device=dev)
print(f"  metadata blocks : {out_b['metadata_blocks']} (linear) -> "
      f"{out_t['metadata_blocks']} (iRT)  "
      f"[-{100*(1-out_t['metadata_blocks']/out_b['metadata_blocks']):.0f}%]")
print(f"  remap-cache hit : {out_b['rc_hit_rate']:.0%} (conventional) -> "
      f"{out_t['rc_hit_rate']:.0%} (iRC)")
print(f"  fast serve rate : {out_b['serve_rate']:.0%} -> "
      f"{out_t['serve_rate']:.0%}")
print(f"  speedup         : {out_b['t_total']/out_t['t_total']:.2f}x")

# --- 2. the tiered KV cache -------------------------------------------------
print("\n=== TieredKVCache: Trimma metadata managing a two-tier KV pool ===")
# cache_device_table=False: this demo shows the iRC hit accounting of
# the raw metadata path; with the (default) cached device table, repeat
# lookups never reach the iRC at all (see examples/torch_serve_tiered.py)
cfg = tk.TieredConfig(n_seqs=4, max_pages_per_seq=64, page_tokens=16,
                      n_kv_heads=2, head_dim=64, fast_data_slots=16,
                      dtype="float32", cache_device_table=False)
st = tk.init_state(cfg, dev)
g = torch.Generator(device=dev).manual_seed(0)
st.slow_k.copy_(torch.randn(st.slow_k.shape, generator=g, device=dev))
st.slow_v.copy_(torch.randn(st.slow_v.shape, generator=g, device=dev))

i32 = dict(dtype=torch.int32, device=dev)     # page ids are int32
pages = torch.arange(8, **i32)[None].expand(cfg.n_seqs, 8)   # hot front
ids = tk.logical_page(cfg, torch.arange(cfg.n_seqs, **i32)[:, None], pages)
for step in range(4):
    table, st = tk.lookup(cfg, st, ids)
    st = tk.migrate_hot(cfg, st, max_moves=4)
print(f"  lookups={int(st.lookups)} iRC hits={int(st.irc_hits)} "
      f"(id-hits {int(st.irc_id_hits)})")
print(f"  migrations={int(st.migrations)} "
      f"metadata pages={int(tk.metadata_pages(cfg, st))}/{cfg.n_leaf} "
      f"(linear table would always burn {cfg.n_leaf})")
print(f"  resident in fast pool: {int((st.slot_owner != -1).sum())} pages "
      f"(incl. lent metadata slots)")
