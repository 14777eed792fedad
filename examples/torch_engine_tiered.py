"""Full-model tiered serving on the PyTorch port, the counterpart of
``engine_tiered.py``: the engine decoding a whole transformer through
one Trimma-managed two-tier KV store per attention layer.

Every request's prompt is really prefilled (one forward pass, its K/V
pages land in the slow pool), lanes decode at independent ragged
positions, the migration scheduler runs between steps, and a finished
request's pages leave the metadata the moment its lane recycles.  The
same request mix is decoded once per backend: the tiered token streams
must match the dense ones exactly, because the logits are bit-identical.

    PYTHONPATH=src python examples/torch_engine_tiered.py
    ... --device cpu       # the plain versions on the CPU
    EXAMPLES_SMOKE=1 ...   # fewer, shorter requests for CI
"""
import argparse
import os
import sys
import time

sys.path.insert(0, "src")

import numpy as np  # noqa: E402

from repro_torch.configs import get_config, reduce_for_smoke  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.serve.engine import Engine, EngineConfig, Request  # noqa: E402

SMOKE = os.environ.get("EXAMPLES_SMOKE") == "1"

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
dev = resolve_device(ap.parse_args().device)

cfg = reduce_for_smoke(get_config("llama3-8b"))
params = init_params(cfg, dev, seed=0)


def request_mix():
    rng = np.random.default_rng(0)
    return [Request(rid=rid,
                    prompt=rng.integers(0, cfg.vocab, size=3 + rid % 4),
                    max_new=(3 if SMOKE else 6) + 4 * (rid % 3))
            for rid in range(4 if SMOKE else 6)]


streams, walls = {}, {}
for backend in ("dense", "tiered"):
    eng = Engine(cfg, params, EngineConfig(
        batch=2, max_len=64, backend=backend,
        page_tokens=8, fast_data_slots=8, maintain_every=4), device=dev)
    for r in request_mix():
        eng.submit(r)
    t0 = time.time()
    done = eng.run()
    walls[backend] = time.time() - t0
    streams[backend] = {r.rid: r.tokens for r in done}
    print(f"=== backend={backend}: {len(done)} requests, "
          f"{eng.steps} decode steps, {walls[backend]:.2f}s wall ===")
    for r in sorted(done, key=lambda r: r.rid):
        print(f"  req {r.rid}: prompt {len(r.prompt):2d} tok -> "
              f"{len(r.tokens):2d} new, latency {r.latency * 1e3:7.1f} ms, "
              f"ttft {r.ttft * 1e3:6.1f} ms, tokens {r.tokens[:6]}...")
    # engine observability: per-request latency percentiles + the
    # log-bucketed token-latency histogram
    agg = eng.request_stats(done)["aggregate"]
    hist = agg["token_latency_hist"]
    top = max(range(len(hist["counts"])), key=hist["counts"].__getitem__)
    lo = hist["edges_ms"][top - 1] if top else 0.0
    print(f"  latency p50 {agg['latency_ms']['p50']:.1f} ms / "
          f"p99 {agg['latency_ms']['p99']:.1f} ms; "
          f"ttft p50 {agg['ttft_ms']['p50']:.1f} ms; modal token "
          f"latency bucket >= {lo:.2g} ms "
          f"({hist['counts'][top]}/{sum(hist['counts'])} tokens)")
    if backend == "tiered":
        c = eng.counters
        print(f"  metadata: lookups={c['lookups']} dev_hits={c['dev_hits']} "
              f"migrations={c['migrations']} demotions={c['demotions']} "
              f"promo_bytes={c['promo_bytes']} demo_bytes={c['demo_bytes']}")
        print(f"  releases on lane recycle: {eng.releases}")
        # per-epoch migration bandwidth (bytes between maintain passes)
        print(f"  epoch promo bytes: {c['epoch_promo_bytes']}")
        print(f"  epoch demo bytes:  {c['epoch_demo_bytes']}")
        assert sum(c["epoch_promo_bytes"]) == c["promo_bytes"]

assert streams["dense"] == streams["tiered"], \
    "tiered decode diverged from dense: the translation must be invisible"
print("\ntiered token streams identical to dense: OK")
