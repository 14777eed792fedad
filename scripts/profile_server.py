#!/usr/bin/env python3
"""Where a tiered-server decode step's time goes, on the card.

  python3 scripts/profile_server.py [--skip 8] [--window 24] [--eager]

Builds the store and seeded inputs of ``chip_smoke.py``'s server phase
(one store at llama3-8b's per-layer KV widths, 16 lanes x 256 pages, 15
live lanes of 1024-3968 tokens), and for each path (zero_copy cached and
uncached, concat, fused) runs ``--skip`` steps, then times ``--window``
steps twice, first without and then under ``torch.profiler``, and one
maintenance pass under the profiler.  Prints per path: ms per step
(profiler off), device busy time per step and its share of the
unprofiled window, device time by kernel class, kernel launches and
stream waits per step, and the same for the maintenance pass.  The
server's step and pass are captured CUDA graphs (one ``cudaGraphLaunch``
each), or eager with ``--eager``.  Needs a card.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

CLASSES = (("paged attention", ("paged_attention", "paged_kernel")),
           ("irt_lookup", ("irt_lookup", "irt_walk2")),
           ("remap_gather", ("remap_gather", "remap_replay")),
           ("copy/cast", ("copy", "cast", "fill", "memcpy", "memset",
                          "cat")),
           ("index/scatter", ("index", "scatter", "gather")),
           ("reduce/sort", ("reduce", "sort", "radix", "scan")))


def _classify(name: str) -> str:
    low = name.lower()
    for label, keys in CLASSES:
        if any(k in low for k in keys):
            return label
    return "elementwise/other"


def _report(prof, n, wall_ms, what):
    from torch.autograd import DeviceType
    dev_us: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            dev_us[e.name] = dev_us.get(e.name, 0.0) \
                + e.time_range.elapsed_us()
    busy_ms = sum(dev_us.values()) / 1e3
    calls = {e.key: e.count / n for e in prof.key_averages()}
    launches = sum(v for k, v in calls.items() if "LaunchKernel" in k)
    graphs = sum(v for k, v in calls.items() if "GraphLaunch" in k)
    line = (f"{what}: {wall_ms / n:.3f} ms (profiler off); "
            f"{launches:.1f} kernel launches, {graphs:.1f} graph launches, "
            f"{calls.get('cudaStreamSynchronize', 0.0):.1f} "
            f"cudaStreamSynchronize each")
    if busy_ms == 0:
        print(f"{line}; no device time in the trace")
        return
    print(f"{line}; device busy {busy_ms / n:.3f} ms = "
          f"{100 * busy_ms / wall_ms:.1f}% (idle "
          f"{100 * (1 - busy_ms / wall_ms):.1f}%)")
    by_class: dict = {}
    for k, us in dev_us.items():
        c = _classify(k)
        by_class[c] = by_class.get(c, 0.0) + us / 1e3
    print(f"{what} device by class (ms each): " + ", ".join(
        f"{c} {ms / n:.4f}" for c, ms in
        sorted(by_class.items(), key=lambda kv: -kv[1])))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--skip", type=int, default=8)
    ap.add_argument("--window", type=int, default=24)
    ap.add_argument("--eager", action="store_true",
                    help="run the server's steps eagerly (graphs=False)")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        raise SystemExit("profile_server: needs a CUDA card")
    if args.skip + 2 * args.window > chip_smoke.SERVER_STEPS:
        chip_smoke.SERVER_STEPS = args.skip + 2 * args.window
    dev = torch.device("cuda", 0)
    print(f"card: {chip_smoke._card_line()}")
    _build.build_all()
    inputs = chip_smoke.server_inputs(torch, dev)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for label, path, cached in chip_smoke.SERVER_PATHS:
        tcfg = dataclasses.replace(inputs["tcfg"], cache_device_table=cached)
        srv = chip_smoke.make_server(torch, dev, tcfg, path,
                                     False if args.eager else None)
        pos = inputs["pos0"].clone()
        i = 0

        def steps(n):
            nonlocal pos, i
            for _ in range(n):
                srv.step(inputs["q"][i], inputs["k"][i], inputs["v"][i],
                         pos)
                pos = torch.where(pos >= 0, pos + 1, pos)
                i += 1
            torch.cuda.synchronize()

        steps(args.skip)
        t0 = time.perf_counter()
        steps(args.window)
        wall_ms = 1e3 * (time.perf_counter() - t0)
        with profile(activities=acts) as prof:
            steps(args.window)
        _report(prof, args.window, wall_ms, f"{label} step")
        srv.maintain()                       # warm: a pass after the window
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        srv.maintain()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
        with profile(activities=acts) as prof:
            srv.maintain()
            torch.cuda.synchronize()
        _report(prof, 1, wall_ms, f"{label} maintain pass")
        del srv
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
