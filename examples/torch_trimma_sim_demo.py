"""Paper-experiment walkthrough on the PyTorch port: reproduce the headline
comparisons of Section 5 on one workload, printing each effect next to
the paper's claim.  The port's counterpart of ``trimma_sim_demo.py``; the
simulator's scan runs as one kernel launch a run on the card.

    PYTHONPATH=src python examples/torch_trimma_sim_demo.py [workload]
    ... --device cpu       # the plain loop on the CPU
    EXAMPLES_SMOKE=1 ...   # tiny geometry + short trace for CI
"""
import argparse
import os
import sys

sys.path.insert(0, "src")

from repro_torch.core import (DDR5_NVM, HBM3_DDR5, WORKLOADS, alloy,  # noqa: E402
                              generate_trace, mempod, relabel_first_touch,
                              run, trimma_cache, trimma_flat)

SMOKE = os.environ.get("EXAMPLES_SMOKE") == "1"
GEOM = dict(fast_total_blocks=256, ratio=8, n_sets=4) if SMOKE else {}

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("workload", nargs="?", default="xz", choices=sorted(WORKLOADS))
ap.add_argument("--device", default=None,
                help="cuda (the default) or cpu")
args = ap.parse_args()

wl, dev = args.workload, args.device
spec = WORKLOADS[wl]
print(f"workload proxy: {wl}  (ws={spec.ws_frac:.0%} of slow tier, "
      f"zipf={spec.zipf_s}, streams={spec.stream_frac:.0%})")

cfg_c = trimma_cache(**GEOM)
blocks, writes = generate_trace(spec, cfg_c.slow_blocks,
                                4096 if SMOKE else 49152)

print("\n--- cache mode (vs Alloy Cache) on HBM3+DDR5 ---")
a = run(alloy(**GEOM), HBM3_DDR5, blocks, writes, device=dev)
t = run(cfg_c, HBM3_DDR5, blocks, writes, device=dev)
print(f"  Alloy : serve={a['serve_rate']:.0%}  t={a['t_total']:.3e}")
print(f"  Trimma: serve={t['serve_rate']:.0%}  t={t['t_total']:.3e}  "
      f"speedup={a['t_total']/t['t_total']:.2f}x "
      "(paper avg 1.33x, max 1.68x)")

print("\n--- flat mode (vs MemPod) on DDR5+NVM ---")
fb = relabel_first_touch(blocks)
m = run(mempod(**GEOM), DDR5_NVM, fb, writes, device=dev)
f = run(trimma_flat(**GEOM), DDR5_NVM, fb, writes, device=dev)
print(f"  MemPod: meta={m['metadata_blocks']}blk rc_hit={m['rc_hit_rate']:.0%} "
      f"t={m['t_total']:.3e}")
print(f"  Trimma: meta={f['metadata_blocks']}blk rc_hit={f['rc_hit_rate']:.0%} "
      f"t={f['t_total']:.3e}  speedup={m['t_total']/f['t_total']:.2f}x "
      "(paper avg 1.32x)")
print(f"  iRT metadata saving: "
      f"{1 - f['metadata_blocks']/m['metadata_blocks']:.0%} "
      "(paper avg 43%, max 85%)")
