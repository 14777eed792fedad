"""Serving launcher: batched greedy decode with the port's engine.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \\
      --backend tiered

runs on the card; ``--device cpu --smoke`` runs the plain versions on a
tiny same-family model.  ``--scheduler chunked`` ingests prompts in
``--prefill-chunk``-token chunks and, with ``--tenants``, admits requests
by multi-tenant QoS with per-tenant fast-slot quotas and direct-to-fast
ingest for on-demand tenants (``--admit-pages``).
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def _parse_tenants(spec: str):
    """"name[:weight[:policy]],..." -> tuple of TenantConfig, e.g.
    "interactive:2:on_demand,batch:1"."""
    from repro_torch.serve.sched import TenantConfig
    out = []
    for part in spec.split(","):
        bits = part.strip().split(":")
        if not bits[0]:
            raise SystemExit(f"--tenants: empty tenant name in {spec!r}")
        weight = int(bits[1]) if len(bits) > 1 and bits[1] else 1
        policy = bits[2] if len(bits) > 2 and bits[2] else None
        out.append(TenantConfig(bits[0], weight=weight, policy=policy))
    return tuple(out)


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
    ap.add_argument("--scheduler", choices=("greedy", "chunked", "wave"),
                    default="greedy",
                    help="greedy: one-shot prefill; chunked: chunked "
                         "prefill + multi-tenant QoS admission ('wave' is "
                         "a deprecated greedy alias)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="--scheduler chunked: prompt tokens ingested per "
                         "engine step (page-aligned for tiered; 0: "
                         "one-shot prefill, QoS only)")
    ap.add_argument("--tenants", default=None,
                    help="multi-tenant QoS 'name[:weight[:policy]],...', "
                         "e.g. 'interactive:2:on_demand,batch:1'; requests "
                         "go round-robin across tenants")
    ap.add_argument("--admit-pages", type=int, default=2,
                    help="direct-to-fast pages per ingest for on-demand "
                         "tenants")
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
    tenants = _parse_tenants(args.tenants) if args.tenants else ()
    params = init_params(cfg, device, seed=0)
    eng = Engine(cfg, params, EngineConfig(
        batch=args.batch, max_len=args.max_len, backend=args.backend,
        policy=args.policy, scheduler=args.scheduler,
        prefill_chunk=args.prefill_chunk, tenants=tenants,
        admit_pages=args.admit_pages), device=device)
    rng = np.random.default_rng(0)
    names = [t.name for t in tenants] or ["default"]
    for rid in range(args.requests):
        eng.submit(Request(rid=rid, prompt=rng.integers(0, cfg.vocab, size=4),
                           max_new=args.max_new,
                           tenant_id=names[rid % len(names)]))
    t0 = time.time()
    done = eng.run(log=print)
    dt = time.time() - t0
    tok = sum(len(r.tokens) for r in done)
    print(f"served {len(done)} requests, {tok} tokens in {dt:.1f}s "
          f"({tok / dt:.1f} tok/s) on {device}")
    stats = eng.request_stats(done)
    lat, ttft = stats["aggregate"]["latency_ms"], stats["aggregate"]["ttft_ms"]
    if lat and ttft:
        print(f"latency p50 {lat['p50']:.1f} ms, p99 {lat['p99']:.1f} ms "
              f"(ttft p50 {ttft['p50']:.1f} ms)")
    if "fairness" in stats:
        print(f"fairness: {stats['fairness']}")
    if eng.counters:
        print(f"tiered counters: {eng.counters}")


if __name__ == "__main__":
    main()
