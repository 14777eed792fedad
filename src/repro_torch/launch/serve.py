"""Serving launcher: batched greedy decode with the port's engine.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \\
      --backend tiered

runs on the card; ``--device cpu --smoke`` runs the plain versions on a
tiny same-family model.
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny same-family config (configs.reduce_for_smoke)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--backend", choices=("dense", "tiered"),
                    default="dense")
    ap.add_argument("--policy", default=None,
                    help="core/policy preset for --backend tiered")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.device import resolve_device
    from repro_torch.models import init_params
    from repro_torch.serve.engine import Engine, EngineConfig, Request

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduce_for_smoke(cfg)
    params = init_params(cfg, device, seed=0)
    eng = Engine(cfg, params, EngineConfig(
        batch=args.batch, max_len=args.max_len, backend=args.backend,
        policy=args.policy), device=device)
    rng = np.random.default_rng(0)
    for rid in range(args.requests):
        eng.submit(Request(rid=rid, prompt=rng.integers(0, cfg.vocab, size=4),
                           max_new=args.max_new))
    t0 = time.time()
    done = eng.run(log=print)
    dt = time.time() - t0
    tok = sum(len(r.tokens) for r in done)
    print(f"served {len(done)} requests, {tok} tokens in {dt:.1f}s "
          f"({tok / dt:.1f} tok/s) on {device}")
    if eng.counters:
        print(f"tiered counters: {eng.counters}")


if __name__ == "__main__":
    main()
