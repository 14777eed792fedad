"""Serving launcher: batched greedy decode with the port's engine.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \\
      --backend tiered

runs on the card; ``--device cpu --smoke`` runs the plain versions on a
tiny same-family model.  ``--arch`` takes every config the port
registers: the dense llama3-8b, qwen2-7b, qwen2-72b and codeqwen1.5-7b,
and the MoE granite-moe-3b-a800m and mixtral-8x22b (whose sliding window
only ``--backend dense`` serves); the engine refuses the recurrent
hymba-1.5b and xlstm-125m and the vlm llama-3.2-vision-90b, as the
reference's does (the launcher exits with its message;
``models.prefill`` and ``models.decode_step`` serve them), and the
launcher refuses the encoder hubert-xlarge before it builds anything.
``--scheduler chunked`` ingests prompts in ``--prefill-chunk``-token
chunks and, with ``--tenants``, admits requests by multi-tenant QoS with
per-tenant fast-slot quotas and direct-to-fast ingest for on-demand
tenants (``--admit-pages``).  Telemetry:
``--prom-out`` / ``--metrics-jsonl`` / ``--trace-out`` write the
Prometheus exposition, the sample series and the phase trace
(``--obs-every`` steps between samples), ``--flight`` records page
lifecycles (tiered only), ``--slo`` books per-tenant targets, and
``--http-port`` serves ``/metrics``, ``/healthz`` and ``/debug/state``
for the run (``--hold`` seconds longer).

``--mesh host [--model-parallel N]`` serves on a ("data", "model")
``DeviceMesh`` over every rank instead of the engine (which stays on one
device): the requests in waves of ``--batch`` lanes, each a
``serve.decode.jit_prefill`` then greedy ``jit_decode`` steps over the
dense caches, sequence-sharded over "model".  The compute splits over
the N "model" ranks (heads, MLP or experts, the hybrid's Mamba channels
or the xLSTM's heads, and vocabulary) and each rank draws only its
pieces of the parameters, so a model larger than one card serves on N.
The vlm, whose steps split too (``serve.decode.jit_prefill`` and
``jit_decode``), is refused here: its prompts carry image embeddings,
which the launcher does not make.  The group is torchrun's, as
``launch.train``'s:

  torchrun --nproc-per-node 4 -m repro_torch.launch.serve \
      --arch qwen2-72b --mesh host --model-parallel 4
"""

from __future__ import annotations

import argparse
import sys
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
    from repro_torch.configs import ALL_ARCHS
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ALL_ARCHS)
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
    ap.add_argument("--prom-out", default=None,
                    help="write the Prometheus text exposition here at "
                         "drain")
    ap.add_argument("--metrics-jsonl", default=None,
                    help="one JSON metrics sample per --obs-every steps")
    ap.add_argument("--trace-out", default=None,
                    help="Chrome-trace-event JSON of the engine phases "
                         "(open in https://ui.perfetto.dev)")
    ap.add_argument("--obs-every", type=int, default=4,
                    help="engine steps between metric samples")
    ap.add_argument("--flight", action="store_true",
                    help="page-lifecycle flight recorder (tiered only)")
    ap.add_argument("--flight-capacity", type=int, default=2048,
                    help="--flight: event-ring slots (oldest drop first)")
    ap.add_argument("--slo", default=None,
                    help="per-tenant SLO spec 'tenant:stat:target_ms"
                         "[:objective[:window]],...' (tenant '*' matches "
                         "all; stat latency|ttft)")
    ap.add_argument("--http-port", type=int, default=None,
                    help="serve /metrics, /healthz and /debug/state on "
                         "this port for the run (0: ephemeral)")
    ap.add_argument("--hold", type=float, default=0.0,
                    help="--http-port: keep the endpoints up this many "
                         "seconds after the run")
    ap.add_argument("--mesh", default="none", choices=["none", "host"],
                    help="host: serve on a (data, model) mesh over every "
                         "rank through jit_prefill / jit_decode (greedy "
                         "waves of --batch lanes; no engine options)")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="--mesh host: ranks on the \"model\" axis; "
                         "heads, MLP (or experts), Mamba channels and "
                         "vocabulary split over them (tensor-parallel "
                         "compute)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.mesh == "host":
        engine_only = [f for f, on in (
            ("--backend tiered", args.backend != "dense"),
            ("--scheduler", args.scheduler != "greedy"),
            ("--tenants", args.tenants), ("--flight", args.flight),
            ("--slo", args.slo), ("--prom-out", args.prom_out),
            ("--metrics-jsonl", args.metrics_jsonl),
            ("--trace-out", args.trace_out),
            ("--http-port", args.http_port is not None)) if on]
        if engine_only:
            ap.error(f"--mesh host serves without the engine; "
                     f"{', '.join(engine_only)} need it")
    elif args.model_parallel > 1:
        ap.error("--model-parallel needs --mesh host")
    if args.flight and args.backend != "tiered":
        raise SystemExit("--flight needs --backend tiered (the recorder "
                         "reads the tiered store's move descriptors)")

    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.device import resolve_device
    from repro_torch.models import init_params
    from repro_torch.serve.engine import Engine, EngineConfig

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduce_for_smoke(cfg)
    if cfg.is_encoder:
        raise SystemExit(f"{cfg.name} is encoder-only: no decode serving")
    if args.mesh == "host":
        if cfg.family == "vlm":
            raise SystemExit(f"{cfg.name}: --mesh host serves token "
                             f"prompts; the vlm's prefill takes image "
                             f"embeddings (serve.decode.jit_prefill)")
        return _serve_sharded(args, cfg, device)
    tenants = _parse_tenants(args.tenants) if args.tenants else ()
    params = init_params(cfg, device, seed=0)
    obs = None
    if (args.prom_out or args.metrics_jsonl or args.trace_out
            or args.http_port is not None):
        from repro_torch.obs import ObsConfig
        obs = ObsConfig(sample_every=args.obs_every, prom_path=args.prom_out,
                        jsonl_path=args.metrics_jsonl,
                        trace_path=args.trace_out, http_port=args.http_port)
    flight = None
    if args.flight:
        from repro_torch.obs import FlightConfig
        flight = FlightConfig(capacity=args.flight_capacity)
    slos = ()
    if args.slo:
        from repro_torch.obs import parse_slos
        slos = parse_slos(args.slo)
    try:
        eng = Engine(cfg, params, EngineConfig(
            batch=args.batch, max_len=args.max_len, backend=args.backend,
            policy=args.policy, scheduler=args.scheduler,
            prefill_chunk=args.prefill_chunk, tenants=tenants,
            admit_pages=args.admit_pages, obs=obs, flight=flight,
            slos=slos), device=device)
    except NotImplementedError as e:
        raise SystemExit(f"{cfg.name}: {e}")
    if eng.obs_server is not None:
        print(f"obs: live endpoints at {eng.obs_server.url} "
              f"(/metrics /healthz /debug/state)")
    try:
        _serve(args, cfg, eng, tenants, device)
    finally:
        if eng.obs_server is not None:
            if args.hold > 0:
                print(f"obs: holding endpoints at {eng.obs_server.url} for "
                      f"{args.hold:g}s")
                sys.stdout.flush()
                time.sleep(args.hold)
            eng.obs_server.close()


def _serve(args, cfg, eng, tenants, device):
    from repro_torch.serve.engine import Request
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
    if eng.slo is not None:
        rows = eng.slo.summary()
        if not rows:
            print("slo: no completed requests observed")
        for r in rows:
            print(f"slo: {r['tenant']}/{r['stat']} target {r['target_ms']:g}"
                  f" ms obj {r['objective']:g} -> burn {r['burn_rate']:.2f}"
                  f" ({r['window_violations']}/{r['window_n']} violating "
                  f"in window) {'OK' if r['ok'] else 'BURNING'}")
    fs = eng.flight_stats()
    if fs is not None:
        if fs["n_events"] == 0:
            print("flight: no events recorded")
        else:
            res, pp = fs["residency"], fs["pingpong"]
            print(f"flight: {fs['n_events']} events "
                  f"({fs['dropped']} dropped) by_kind={fs['by_kind']}")
            if res.get("count"):
                print(f"flight: residency mean {res['mean_steps']:.1f} "
                      f"steps (p50 {res['p50_steps']:g}, max "
                      f"{res['max_steps']}), ping-pong {pp['events']} "
                      f"re-promotions within {pp['window_steps']} steps")
    for label, path in (("prometheus", args.prom_out),
                        ("metrics jsonl", args.metrics_jsonl),
                        ("perfetto trace", args.trace_out)):
        if path:
            print(f"obs: {label} -> {path}")


PROMPT_TOKENS = 4       # each request's prompt, as ``_serve`` submits it


def _serve_sharded(args, cfg, device) -> dict:
    """``--mesh host``: ``--requests`` seeded prompts in waves of
    ``--batch`` lanes (the last wave padded with its last prompt, whose
    extra lanes' tokens are not counted), each a ``jit_prefill`` into
    caches of ``--max-len`` positions and ``--max-new`` greedy tokens
    (the first from the prefill's logits, the rest from ``jit_decode``).
    Returns {"requests", "tokens", "seconds"}; rank 0 prints them."""
    import dataclasses

    import torch

    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import process_group
    from repro_torch.models import init_sharded_params
    from repro_torch.serve.decode import (batch_shardings, jit_decode,
                                          jit_prefill)
    from repro_torch.sharding import specs

    if PROMPT_TOKENS + args.max_new - 1 > args.max_len:
        raise SystemExit(f"--max-len {args.max_len} holds no "
                         f"{PROMPT_TOKENS}-token prompt and {args.max_new} "
                         f"new tokens")
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, size=(args.requests, PROMPT_TOKENS)
                           ).astype(np.int32)
    with process_group(device) as rank:
        mesh = make_host_mesh(args.model_parallel, device)
        shape = ShapeConfig("serve", args.max_len, args.batch, "prefill")
        pre, _ = jit_prefill(cfg, shape, mesh)
        dec, _ = jit_decode(cfg, dataclasses.replace(shape, kind="decode"),
                            mesh)
        params = init_sharded_params(cfg, mesh, seed=0, device=device)
        n_tok = 0
        t0 = time.time()
        for lo in range(0, args.requests, args.batch):
            wave = prompts[lo:lo + args.batch]
            lanes = np.concatenate([wave, np.repeat(
                wave[-1:], args.batch - len(wave), axis=0)])
            x = torch.from_numpy(lanes).to(device)
            b_sh = batch_shardings({"tokens": x}, mesh)["tokens"]
            t_sh = batch_shardings({"tokens": x[:, 0]}, mesh)["tokens"]
            logits, state = pre(params, {"tokens": specs.distribute(x,
                                                                    b_sh)})
            for i in range(args.max_new):
                nxt = logits.full_tensor().argmax(-1).to(torch.int32)
                n_tok += len(wave)
                if i + 1 < args.max_new:
                    logits, state = dec(params, state,
                                        specs.distribute(nxt, t_sh))
        dt = time.time() - t0
        if rank == 0:
            print(f"served {args.requests} requests, {n_tok} tokens in "
                  f"{dt:.1f}s ({n_tok / dt:.1f} tok/s) on mesh "
                  f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}, "
                  f"{device.type}")
    return {"requests": args.requests, "tokens": n_tok, "seconds": dt}


if __name__ == "__main__":
    main()
