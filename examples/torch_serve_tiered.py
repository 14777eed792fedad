"""Serving example on the PyTorch port, the counterpart of
``serve_tiered.py``: batched greedy decode with the engine, plus the
tiered KV path: long-context pages live in the slow tier, hot pages
migrate into the HBM pool under Trimma metadata, and attention reads
through the *cached* translated page table straight out of the split
pools (zero-copy: no unified-pool concatenation, near-zero steady-state
translation work).  On the card the engine replays captured steps and
the reads run the hand-written paged-attention kernels.

    PYTHONPATH=src python examples/torch_serve_tiered.py
    ... --device cpu       # the plain versions on the CPU
    EXAMPLES_SMOKE=1 ...   # fewer requests and a shorter context for CI
"""
import argparse
import os
import sys

sys.path.insert(0, "src")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config, reduce_for_smoke  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.serve import tiered as srv  # noqa: E402
from repro_torch.serve.engine import Engine, EngineConfig, Request  # noqa: E402
from repro_torch.tiered import kvcache as tk  # noqa: E402

SMOKE = os.environ.get("EXAMPLES_SMOKE") == "1"

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
dev = resolve_device(ap.parse_args().device)

# --- 1. batched serving with the engine ------------------------------------
cfg = reduce_for_smoke(get_config("llama3-8b"))
params = init_params(cfg, dev, seed=0)
eng = Engine(cfg, params, EngineConfig(batch=2, max_len=64), device=dev)
rng = np.random.default_rng(0)
for rid in range(2 if SMOKE else 4):
    eng.submit(Request(rid=rid,
                       prompt=rng.integers(0, cfg.vocab, size=4),
                       max_new=8 + 8 * (rid % 2)))
done = eng.run(log=print)
for r in sorted(done, key=lambda r: r.rid):
    print(f"  req {r.rid}: {len(r.tokens)} tokens -> {r.tokens[:8]}...")

# --- 2. tiered KV attention: translation must be invisible ------------------
print("\n=== tiered KV: dense reference vs Trimma-translated paged read ===")
tcfg = tk.TieredConfig(n_seqs=2, max_pages_per_seq=64, page_tokens=16,
                       n_kv_heads=2, head_dim=32, fast_data_slots=8,
                       dtype="float32")
st = tk.init_state(tcfg, dev)
g = torch.Generator(device=dev).manual_seed(1)
st.slow_k.copy_(torch.randn(st.slow_k.shape, generator=g, device=dev))
st.slow_v.copy_(torch.randn(st.slow_v.shape, generator=g, device=dev))
q = torch.randn((tcfg.n_seqs, tcfg.n_kv_heads, 4, tcfg.head_dim),
                generator=g, device=dev)
context = 128 if SMOKE else 512
sl = torch.full((tcfg.n_seqs,), context, dtype=torch.int32, device=dev)

outs = []
for step in range(6):
    out, st = srv.attend(tcfg, st, q, sl)
    outs.append(out.clone())
    st = srv.maintain(tcfg, st, max_moves=3)

drift = max(float((o - outs[0]).abs().max()) for o in outs)
print(f"  attention drift across {len(outs)} migration rounds: {drift:.2e} "
      "(must be ~0)")
live = 2 * -(-context // tcfg.page_tokens)
print(f"  migrations={int(st.migrations)} forced_evictions="
      f"{int(st.forced_evict)} translated pages={int(st.lookups)} "
      f"(legacy path would have translated {6 * tcfg.n_logical}), "
      f"device-table hits={int(st.dev_hits)}")
assert drift < 1e-5
# steady state: after the first attend every live page is served from the
# cached device table; maintain's moves write through, never invalidate
assert int(st.lookups) <= live + int(st.migrations) + int(st.demotions)

# --- 3. lane recycle: a finished request's pages leave the metadata ---------
st = tk.release_seq(tcfg, st, 0)
out_after, st = srv.attend(tcfg, st, q, sl)
gap = float((out_after[1] - outs[0][1]).abs().max())
print(f"  after releasing lane 0: seq-1 output drift={gap:.2e} (must be ~0)")
assert gap < 1e-5
