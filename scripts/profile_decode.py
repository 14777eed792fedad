#!/usr/bin/env python3
"""Where a steady decode step's time goes, on the card.

  python3 scripts/profile_decode.py [--skip 8] [--window 24] [--chunk]

Builds the main path of ``chip_smoke.py`` (llama3-8b at full width, the
tiered engine, the same seeded requests), prefills all 8 lanes, then
runs decode steps exactly as ``Engine.run`` does between refills:
deferred maintenance applied before a step, the live-page bucket, the
step, the argmax and the host reads, a plan every ``maintain_every``
steps.  After ``--skip`` steps it times ``--window`` steps twice, first
without and then under ``torch.profiler``, and prints: ms per step
(profiler off), the device time summed over kernels (one stream, so the
sum is the busy time) and its share of the unprofiled window, device
time by kernel class, the top kernels, the top host ops, and the kernel
launches, host copies and stream waits per step.  ``--chunk`` profiles
the chunked prefill's forward instead (``forward_chunk`` over a
2048-token prompt in 256-token chunks, as ``chip_smoke.py`` phase 7 runs
it), per chunk, with the flash kernel's share of the device time.
Needs a card.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CLASSES = (("paged_attention_fused", ("paged_attention", "paged_kernel")),
           ("flash_attention", ("flash",)),
           ("remap_gather", ("remap_gather", "remap_replay")),
           ("matmul", ("gemm", "gemv", "nvjet", "xmma", "cutlass",
                       "splitk")),
           ("copy/cast", ("copy", "cast", "fill", "memcpy", "memset")),
           ("index/scatter", ("index", "scatter", "gather", "nonzero",
                              "masked")),
           ("reduce", ("reduce", "softmax", "norm")))


def _classify(name: str) -> str:
    low = name.lower()
    for label, keys in CLASSES:
        if any(k in low for k in keys):
            return label
    return "elementwise/other"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--skip", type=int, default=8)
    ap.add_argument("--window", type=int, default=24)
    ap.add_argument("--chunk", action="store_true",
                    help="profile 256-token prefill chunks, not decode")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.models import decode_step

    if not torch.cuda.is_available():
        raise SystemExit("profile_decode: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(f"card: {chip_smoke._card_line()}")
    _build.build_all()
    cfg, params = chip_smoke.main_model(torch, dev)
    if args.chunk:
        return profile_chunks(torch, dev, cfg, params)
    eng = chip_smoke.main_path_engine(torch, dev, cfg, params)
    ec = eng.ec

    with torch.inference_mode():
        state = eng.backend.init_state(ec.batch, ec.max_len)
        tokens = torch.zeros((ec.batch,), dtype=torch.int32, device=dev)
        for lane in range(ec.batch):
            state, tok = eng.prefill_lane(state, lane,
                                          eng.scheduler.queue.popleft())
            tokens[lane] = tok

        def steps(n, state, tokens):
            buckets = set()
            for _ in range(n):
                state = eng._flush_maintain(state, overlapped=True)
                n_pages = eng._live_bucket(state.pos.cpu().numpy())
                buckets.add(n_pages)
                logits, state = decode_step(cfg, eng.params, state, tokens,
                                            backend=eng.backend,
                                            n_pages=n_pages)
                tokens = torch.argmax(logits, dim=-1).to(torch.int32)
                eng.steps += 1
                if eng.steps % ec.maintain_every == 0:
                    eng._pending_plan = eng.backend.plan_maintain(state)
                tokens.cpu(), state.pos.cpu()
            torch.cuda.synchronize()
            return state, tokens, buckets

        state, tokens, _ = steps(args.skip, state, tokens)
        t0 = time.perf_counter()
        state, tokens, buckets = steps(args.window, state, tokens)
        wall_ms = 1e3 * (time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, tokens, _ = steps(args.window, state, tokens)
            prof_ms = 1e3 * (time.perf_counter() - t0)

    n = args.window
    print(f"window: {n} decode steps after {args.skip}, 8 live lanes, "
          f"buckets {sorted(b or 0 for b in buckets)} pages: "
          f"{wall_ms / n:.2f} ms/step (profiler off), "
          f"{prof_ms / n:.2f} ms/step under the profiler")
    report(prof, n, wall_ms, "step")


def profile_chunks(torch, dev, cfg, params):
    """forward_chunk over one 2048-token prompt in 8 chunks of 256, twice
    to warm up, then timed (synchronised, host clock) and profiled."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import forward_chunk, init_chunk_buffers

    P, C = 2048, 256
    tokens = torch.as_tensor(np.random.default_rng(9).integers(
        0, cfg.vocab, (1, P)), device=dev)
    bk, bv = init_chunk_buffers(cfg, P, device=dev)

    def run():
        for start in range(0, P, C):
            forward_chunk(cfg, params, tokens[:, start:start + C], bk, bv,
                          start, return_logits=start + C >= P)
        torch.cuda.synchronize()

    with torch.inference_mode():
        run()
        run()
        t0 = time.perf_counter()
        run()
        wall_ms = 1e3 * (time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
    n = P // C
    print(f"window: {n} chunks of {C} tokens (q_offset 0..{P - C}), "
          f"{cfg.n_layers} layers: {wall_ms / n:.2f} ms/chunk (profiler "
          f"off, synchronised)")
    report(prof, n, wall_ms, "chunk")


def report(prof, n, wall_ms, unit):
    """Device busy share, device time by kernel class and top kernels,
    top host ops and launches, per ``unit``."""
    from torch.autograd import DeviceType
    dev_us: dict = {}
    for e in prof.events():                  # device-side kernel events
        if e.device_type == DeviceType.CUDA:
            dev_us[e.name] = dev_us.get(e.name, 0.0) \
                + e.time_range.elapsed_us()
    busy_ms = sum(dev_us.values()) / 1e3
    if busy_ms == 0:
        print("device: no device time in the trace")
        return
    print(f"device: busy {busy_ms / n:.2f} ms/{unit} = "
          f"{100 * busy_ms / wall_ms:.1f}% of the unprofiled window "
          f"(idle {100 * (1 - busy_ms / wall_ms):.1f}%)")
    by_class: dict = {}
    for k, us in dev_us.items():
        c = _classify(k)
        by_class[c] = by_class.get(c, 0.0) + us / 1e3
    for c, ms in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"device class {c}: {ms / n:.3f} ms/{unit} "
              f"({100 * ms / busy_ms:.1f}% of busy)")
    for k, us in sorted(dev_us.items(), key=lambda kv: -kv[1])[:10]:
        print(f"device kernel {us / 1e3 / n:8.3f} ms/{unit}  {k[:90]}")
    host = sorted((e for e in prof.key_averages()
                   if e.self_cpu_time_total > 0),
                  key=lambda e: -e.self_cpu_time_total)[:10]
    for e in host:
        print(f"host op {e.self_cpu_time_total / 1e3 / n:8.3f} ms/{unit} "
              f"self, {e.count / n:7.1f} calls/step  {e.key[:70]}")
    calls = {e.key: e.count / n for e in prof.key_averages()}
    launches = sum(v for k, v in calls.items() if "LaunchKernel" in k)
    print(f"host: {launches:.1f} kernel launches, "
          f"{calls.get('cudaMemcpyAsync', 0.0):.1f} cudaMemcpyAsync, "
          f"{calls.get('cudaStreamSynchronize', 0.0):.1f} "
          f"cudaStreamSynchronize per {unit}")


if __name__ == "__main__":
    main()
