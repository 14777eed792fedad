"""Policy sweep on the PyTorch port, the counterpart of
``policy_sweep.py``: the same Trimma metadata engine under different
hotness-tracking / migration-scheduling policies (core/policy, DESIGN.md
§7), the paper's policy-transparency claim, made sweepable.

1. Simulator: one ``run_many`` per policy preset over a shared trace
   stack (threshold / MEA-epoch / on-demand / write-aware); on the card
   one ``sim_scan`` launch.
2. Serving: the tiered KV-cache ``maintain`` pass under each policy:
   promotions, demotions and the bandwidth they cost.

    PYTHONPATH=src python examples/torch_policy_sweep.py [workload ...]
    ... --device cpu       # the plain versions on the CPU
    EXAMPLES_SMOKE=1 ...   # tiny geometry for CI
"""
import argparse
import os
import sys

sys.path.insert(0, "src")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import (HBM3_DDR5, WORKLOADS, generate_trace,  # noqa: E402
                              get_policy, relabel_first_touch, run_many,
                              trimma_flat)
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.serve import tiered as srv  # noqa: E402
from repro_torch.tiered import kvcache as tk  # noqa: E402

SMOKE = os.environ.get("EXAMPLES_SMOKE") == "1"
POLICIES = ["threshold", "mea", "on_demand", "write_aware"]

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("workloads", nargs="*", choices=sorted(WORKLOADS))
ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
args = ap.parse_args()
dev = resolve_device(args.device)

# --- 1. simulator: policy axis over a trace stack ---------------------------
wls = args.workloads or (["pr", "ycsb_a"] if SMOKE else ["pr", "lbm",
                                                          "ycsb_a"])
cfg = trimma_flat(fast_total_blocks=256 if SMOKE else 512, ratio=8, n_sets=4)
length = 2048 if SMOKE else 16384
traces = [generate_trace(WORKLOADS[w], cfg.slow_blocks, length, 0)
          for w in wls]
blocks = np.stack([relabel_first_touch(t[0]) for t in traces])
writes = np.stack([t[1] for t in traces])

print(f"=== Trimma-F under {len(POLICIES)} policies x {len(wls)} workloads "
      f"({length} accesses each) ===")
res = run_many(cfg, HBM3_DDR5, blocks, writes, policies=POLICIES,
               device=dev)
print(f"{'policy':<12}" + "".join(f"{w:>18}" for w in wls))
for pol, outs in res.items():
    cells = [f"serve={o['serve_rate']:.0%} mv={o['swaps']+o['installs']}"
             for o in outs]
    print(f"{pol:<12}" + "".join(f"{c:>18}" for c in cells))

# --- 2. serving: the maintain scheduler under each policy -------------------
print("\n=== TieredKVCache maintain() under each policy ===")
for pname in POLICIES:
    pol = get_policy(pname, epoch_len=2)   # fast epochs so decay shows up
    tcfg = tk.TieredConfig(n_seqs=2, max_pages_per_seq=32, page_tokens=8,
                           n_kv_heads=1, head_dim=16, fast_data_slots=4,
                           dtype="float32", policy=pol)
    st = tk.init_state(tcfg, dev)
    g = torch.Generator(device=dev).manual_seed(0)
    st.slow_k.copy_(torch.randn(st.slow_k.shape, generator=g, device=dev))
    st.slow_v.copy_(torch.randn(st.slow_v.shape, generator=g, device=dev))
    i32 = dict(dtype=torch.int32, device=dev)  # page ids are int32
    hot = torch.arange(6, **i32)[None].expand(tcfg.n_seqs, 6)
    ids = tk.logical_page(tcfg, torch.arange(tcfg.n_seqs, **i32)[:, None],
                          hot)
    for step in range(4):                   # warm phase: front pages hot
        _, st = tk.lookup(tcfg, st, ids)
        st = srv.maintain(tcfg, st)
    for step in range(6):                   # cold phase: nothing touched
        st = srv.maintain(tcfg, st)         # -> decay, then demotion
    moved = (int(st.promo_pages) + int(st.demo_pages)) * tcfg.page_bytes
    print(f"  {pname:<12} promotions={int(st.migrations):3d} "
          f"demotions={int(st.demotions):3d} moved={moved:6d}B "
          f"resident={int((st.slot_owner != -1).sum())}")
print("\n(threshold keeps pages until decay zeroes them; on_demand promotes "
      "on first touch;\n write_aware spends budget demote-first: same "
      "metadata engine under every policy)")
