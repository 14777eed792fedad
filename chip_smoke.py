#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

  python3 chip_smoke.py            (from the repository root, one card)

Phases, each raising on failure (the script then exits non-zero and
prints no result line):

1. device: a card must be present; TF32 is switched off for matmuls and
   cuDNN, so fp32 comparisons are fp32.
2. build: every CUDA kernel library, one nvcc per source, started
   together.
3. kernels: each kernel against its plain PyTorch version on the card, at
   its path's shapes and at the smoke shapes, with the tolerances stated
   below; the live-page buckets (64 and 61 pages) against the full width,
   and the split read against the unified read of the concatenated pools
   and the one-token fused step over the same store (bit for bit);
   flash attention's rows independent of the call around them (chunk
   calls at page-aligned offsets equal the one-shot call's rows, masked
   extra keys change nothing, bit for bit); kernel, plain and library
   times (CUDA events), each kernel's share of its bound, its achieved
   GB/s or TFLOP/s and the earlier time PERF.md's table gives for the
   same call (a constant); an
   irt_lookup sweep over N, kernel beside plain version; the replay of a
   recorded maintenance pass in one launch (remap_replay) at the main
   path's pools, bit for bit against the plain per-record replay and
   timed beside the per-copy chain of launches it replaces, then at the
   smoke and odd slab sizes; the walk to both homes with the iRC probe
   folded in (irt_walk2), exact, timed beside the chain it replaces.
   Then the same checks and times at the other families' shapes (rows
   under ``shapes`` in the kernels line): the fused read at granite's
   (KV 8, G 3, hd 64), qwen2-7b's (KV 4, G 7) and codeqwen's (KV 32,
   G 1); flash one-shot and chunk at granite's (H 24/8, hd 64) and
   qwen2-7b's (H 28/4) heads, one-shot at mixtral's (H 48/8, a
   4096-token window over 4608 keys) and hymba's (H 25/5, hd 64, a
   1024-token window over 2048 keys); the pass replay over granite's and
   qwen2-7b's stacked pools (32 and 28 layers).
4. main path: llama3-8b at its published width (32 layers, bf16, seeded
   random weights made on the card) served by the tiered engine (its
   one-shot prefill runs the flash kernel); launch counts are reset just
   before the run and read just after, one copy-engine launch per
   maintenance pass; tokens/s, step times and the wall time by engine
   phase.
5. dense against tiered at full width (2 layers, fp32, teacher-forced,
   maintenance running): logits within 1e-3.  ``init_params`` scales the
   attention projections as the reference does (fan-in ``shape[-2]``),
   which makes full-width attention nearly one-hot; there fp32
   reassociation alone moves logits by more than 1e-3, so this gate and
   the other fp32 identities below (11's window, 12(b) and (d), 13(b))
   draw those projections at 1/sqrt(d) (``weights.unit_fan_in``); the
   gap at ``init_params``' own scale is printed, not gated.
6. tiered server: ``TieredServer`` over one store at llama3-8b's
   per-layer KV widths (16 lanes of 4096 tokens), the same seeded inputs
   through the zero-copy path (cached and uncached device table), the
   legacy concat path and the fused path; launch counts reset before
   each path and read after (one copy-engine launch per ``maintain()``,
   the kernel launches of one more zero-copy pass counted by the
   profiler); zero-copy equal to concat bit for bit on every live lane at
   every step, the cached path served from the device table, a zero-copy
   step with no host wait.
7. chunked prefill + multi-tenant QoS at full width: phase 4's weights
   served by ``Engine(scheduler="chunked", prefill_chunk=256, tenants=
   (interactive: weight 2, on-demand; batch: weight 1))``, 16 requests of
   200-1900 prompt tokens; every request finished, released metadata
   back to identity, 8 finished per tenant, direct-to-fast pages for the
   on-demand tenant, migrations; launch counts reset before the run and
   read after, one copy-engine launch per maintenance pass and per
   admission; tokens/s, TTFT and latency per tenant, wall time by phase.
8. chunked == one-shot prefill at full width: a 1500-token prompt's K/V
   ingested chunk by chunk against the one-shot ``forward``'s rows, and
   the final chunk's last-row logits; bit for bit, or else within the
   bf16 limit with the measured gap printed.
9. telemetry at full width: phase 4's engine and first 8 requests under
   write_aware with ``demote_threshold`` 32, served with telemetry off,
   on, on, off (hub samples with Prometheus, JSONL and trace files, a
   flight ring, an SLO, the live endpoints scraped once mid-run); launch
   counts reset before each run and read after; equal tokens and
   counters, demotions counted and flight-recorded, the ring's kinds
   equal to what the counters imply, the exposition and trace parsed,
   the endpoints answering 200; tokens/s, ms per engine step, launches
   per loop iteration, host waits per step and maintenance ms per pass,
   off against on.
10. the paper-evaluation simulator: (a) the kernel (``sim_scan``, every
   access of every trace of a sweep in one launch) reproduces
   ``tests/golden/sim_counters.json`` for its 7 schemes; (b) kernel ==
   plain loop on the card, counters and every key of the end state, for
   every table scheme and remap-cache kind, every preset at 32-access
   epochs, dealloc hints and the tag-matching entry (4 traces x 256
   accesses); (c) the paper's Figure 7 sweep at its size (14 workloads x
   49,152 accesses, 2048 fast blocks, 32:1) for 8 schemes, one
   ``run_many`` launch each, launch counts reset before and read after,
   counters equal to the JAX reference's
   (``tests/golden/sim_fig7_counters.json``), wall ms and ns per access
   cold and warm, each scheme's warm ms beside its time before the
   kernel's redesign (a constant), the headline ratios; (d) the plain
   loop's time per access step beside the kernel's, and the kernels
   line's call (Trimma-C's first 512 accesses of the sweep, kernel and
   plain loop), with the chain's yardstick measured in the same call
   (``sim_scan_chase``: one dependent shared-memory load, one through
   L2): the row's bound is the larger of its chain bound (512 accesses x
   one shared-memory load, ``bound_by`` "operations") and its bytes
   bound, both printed and both in the row.
11. the other families at full width: qwen2-7b (random non-zero QKV
   biases) and granite-moe-3b at their published widths and depths,
   seeded weights made on the card, served by the tiered engine on phase
   4's store with phase 4's first 8 requests: every request finished and
   released to identity, launch counts as in phase 4; tokens/s, ms per
   decode step, maintenance ms per pass, the kernel launches and device
   time of a decode step (``torch.profiler``), launches per kind and,
   for granite, the routed choices dropped for capacity; each then dense
   against tiered on 2 layers in fp32 as phase 5.  mixtral-8x22b at full
   width on 2 of its 56 layers, fp32, dense backend: a 4,600-token
   prompt through flash with the 4096-token window, 16 teacher-forced
   decode steps each within 1e-3 of the one-shot forward, and a window-0
   control that matches its own forward and differs from the windowed
   one.
12. the recurrent families at full width: (a) hymba-1.5b (attention and
   Mamba heads in parallel, window 1024 except on the global layers 0,
   8, 16, 24) and (c) xlstm-125m (mLSTM, sLSTM every 4th layer) at their
   published widths and depths, bf16, seeded weights made on the card:
   ``prefill`` of 2 lanes of 2048-token prompts, then 64 greedy
   ``decode_step``s over the dense backend from the cold state the
   reference's prefill returns; launch counts set to 0 before the
   measured prefill and read after the decode (hymba: flash once a layer
   in prefill, nothing else; xlstm: no kernel); prefill ms, decode ms a
   step, tokens/s, launches and device ms of a decode step
   (``torch.profiler``), peak memory.  (b) hymba's per-layer window on 2
   layers in fp32 (layer 0 global, layer 1 windowed): a 2048-token
   prompt replayed token by token through ``decode_step`` within 1e-3 of
   ``forward`` over the last 64 positions, a window-0 control more than
   1e-2 away.  (d) ``ssm_step``, ``mlstm_step`` (from m = -1e30) and
   ``slstm_step`` x 64 against ``ssm_scan``, ``mlstm_parallel`` and
   ``slstm_scan`` at full width in fp32, and each plain scan's and
   step's time per call at (a)'s and (c)'s call.
13. the vlm and audio families: (a) llama-3.2-vision-90b at its
   published widths (d 8192, 64/8 heads of 128, ff 28672, vocab 128256,
   1,601 image tokens), depth reduced from 100 to 20 layers (4 of its 20
   super-blocks of 4 self + 1 cross layer), bf16, seeded weights made on
   the card with every cross gate at 1 (the reference's 0 hides the
   branch): ``prefill`` of 2 lanes of 512 prompt tokens, then 32 greedy
   ``decode_step``s over the dense backend; launch counts set to 0
   before the measured prefill and read after it and after the decode
   (flash 16 + 4 in prefill, 4 a decode step, nothing else; the cross
   layers' flash launches counted apart from the self layers'); prefill ms,
   decode ms a step, tokens/s, launches and device ms of a decode step
   (``torch.profiler``), peak memory.  (b) one super-block at published
   widths in fp32: the last 16 of 512 prompt tokens teacher-forced
   through ``decode_step`` after a ``prefill`` of the rest, within 1e-3
   of ``forward``; other image embeddings more than 1e-2 away.  (c)
   hubert-xlarge at its published widths and depth (48 layers, d 1280,
   16 heads of 80, non-causal), bf16: ``forward`` of 4 lanes of 1,500
   frames, flash once a layer; forward ms, frames/s, peak memory.  (d)
   flash at their shapes, as phase 3's rows: the vlm's self one-shot (S
   = T = 512), cross prefill (S = 512 over T = 1,601) and cross decode
   (S = 1), hubert's (S = T = 1,500, hd 80) in bf16 and fp32; rows
   independent of the call over the image keys, bit for bit.

14. training: (a) flash attention's backward kernel against
   ``attention_bwd_ref`` at llama3-8b's training shape (B 4, S = T =
   1024, H 32/8, hd 128, causal), hymba's (window 1024, H 25/5, hd 64, S
   = T = 2048), hubert's (hd 80, non-causal, B 4, S = T = 1500) and the
   vlm's cross-attention (S 512 over T = 1601, H 64/8), bf16 and fp32:
   each gradient within 1e-4 (fp32) or 5e-3 (bf16) of its max |value|,
   a second backward call equal to the first bit for bit, lse within
   1e-5, the forward's out bit for bit with and without the lse store;
   the library backward's error against the same reference printed
   beside the kernel's; kernel, plain, library and bound times; and the
   forward kernel checked and timed at the training shape (a row under
   flash_attention's ``shapes``, with the training run's launches).
   (b) ``fit`` of llama3-8b at published widths on 8 of its 32 layers
   (bf16, 4 x 1024 tokens, AdamW, 6 steps): launch counts set to 0
   before and read
   after, 8 flash forward and 8 backward launches a step; losses and
   gnorms finite; step ms, tokens/s, peak memory.  Resume, on 2 layers
   (a chip call may write 45 GiB to its disk; an 8-layer checkpoint is
   28 GB): 3 steps with a checkpoint in a temp directory, then a resume
   to 6, equal to 6 straight (final loss, and the hash of every
   parameter and moment).  The gradients through flash against plain
   attention (autograd), 2 layers, fp32.  Remat full against none; a
   profiled step's launches and idle share.  (c) the
   training launcher as a subprocess, exit code 0.

Output, in order: phase lines, one JSON ``kernels`` line (launches: the
main path's for paged_attention_fused, remap_gather (every launch of the
copy engine, whose two entries share one copy body) and remap_replay,
the cached zero-copy server run's for irt_lookup (every launch of the
walk, whose two entries share one body), irt_walk2 and
paged_attention_split, the concat server run's for paged_attention, the
chunked run's for flash_attention, the Figure 7 sweep's for sim_scan,
phase 14's training run's for flash_attention_bwd and for flash's row
at the training shape; a row at another family's shape counts phase
11's, 12's or 13's run of that family),
the card's name and power limit as
nvidia-smi reports them, and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
FP32_FLOP_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
BF16_FLOP_PER_S = 989e12        # H100 SXM bf16 dense tensor cores
# Each kernel's earlier device time (ms) at this script's shapes, before
# the one-launch pass replay and the two-home walk, and the bf16 backward
# before its tensor-core kernels (its CUDA-core body), from PERF.md's
# table (NVIDIA H100 80GB HBM3, 700 W); printed beside this run's.  The replay and the
# two-home walk have none: each is printed beside the chain of launches
# it replaces, timed in the same run.
EARLIER_MS = {"paged_attention_fused": 0.0318, "remap_gather": 0.0070,
              "irt_lookup": 0.0059, "paged_attention_split": 0.1361,
              "paged_attention": 0.1352, "flash_attention chunk": 0.0778,
              "flash_attention one-shot": 0.2596,
              "flash_attention_bwd bf16 at llama3-8b's shape": 7.121,
              "flash_attention_bwd bf16 at hymba-1.5b's shape": 2.798,
              "flash_attention_bwd bf16 at hubert-xlarge's shape": 7.023,
              "flash_attention_bwd bf16 at llama-3.2-vision-90b's shape":
                  10.487,
              "sim_scan": 1.1069}


def _fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def _check(cond: bool, msg: str):
    if not cond:
        raise RuntimeError(msg)


def _time_ms(fn, reps: int = 30, warmup: int = 3, setup=None) -> float:
    """Median of per-call device times (CUDA events).  Before each call
    the card is held busy (``torch.cuda._sleep``, about a millisecond)
    while the host enqueues the call, so the events bracket the device's
    work and not the host's dispatch; and a 128 MiB write leaves the
    50 MB L2 cold, as the decode step finds it (each layer's pools follow
    ~0.4 GB of weights).  ``setup``, where given, runs before each call,
    outside the timed window."""
    import torch
    flush = torch.empty(32 << 20, dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        if setup is not None:
            setup()
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if setup is not None:
            setup()
        torch.cuda._sleep(2_000_000)
        flush.zero_()
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def _vs_bound(name, ms, bound_ms, *, nbytes=None, flops=None):
    """The share of the bound a kernel reached, its achieved rate, and
    its earlier time for the same call (a constant from PERF.md), where
    there is one."""
    rate = (f", {nbytes / ms / 1e6:.1f} GB/s" if nbytes is not None else "") \
        + (f", {flops / ms / 1e9:.1f} TFLOP/s" if flops is not None else "")
    line = f"{name}: bound/time {bound_ms / ms:.3f}{rate}; {ms:.4f} ms"
    if name in EARLIER_MS:
        line += (f" against {EARLIER_MS[name]:.4f} ms earlier (PERF.md "
                 f"constant, {EARLIER_MS[name] / ms:.2f}x)")
    return line


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def _fused_inputs(torch, dev, *, B, K, KV, G, hd, P, NP, F, n_pages, dtype,
                  seed):
    """Seeded inputs: ragged positions inside the bucket, the last lane
    parked, entries mixing fast slots and slow homes.  Returns the inputs
    (entries sliced to the ``n_pages`` bucket) and the full [B, NP]
    entries."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g, device=dev).to(dtype)  # noqa
    pos = torch.randint(0, n_pages * P - K, (B,), generator=g, device=dev,
                        dtype=torch.int32)
    pos[-1] = -1
    slots = torch.randint(0, F, (B, NP), generator=g, device=dev,
                          dtype=torch.int32)
    fast = torch.rand((B, NP), generator=g, device=dev) < 0.15
    table = torch.where(fast, slots, -1).to(torch.int32)
    return dict(q=r(B, K, KV, G, hd), fast_k=r(F, KV, P, hd),
                fast_v=r(F, KV, P, hd), slow_k=r(B * NP, KV, P, hd),
                slow_v=r(B * NP, KV, P, hd), entries=table[:, :n_pages],
                k_new=r(B, K, KV, hd), v_new=r(B, K, KV, hd), pos=pos), table


def _fused_bound(d):
    """Least time for this call on this data: every input byte it needs
    read once (the live pages of live lanes; a parked lane's output is
    never read, so its pages are not needed), the output written once;
    fp32 flops of QK and PV over the attended columns."""
    B, K, KV, G, hd = d["q"].shape
    P = d["fast_k"].shape[2]
    n_pages = d["entries"].shape[1]
    item = d["q"].element_size()
    pos = d["pos"].tolist()
    pages = [min(n_pages, -(-(p + K) // P)) if p >= 0 else 0 for p in pos]
    cols = sum(pages) * P
    nbytes = (2 * d["q"].numel() * item                  # q in, out
              + 2 * d["k_new"].numel() * item
              + 2 * KV * cols * hd * item                # K and V tiles
              + 4 * (sum(pages) + B))                    # entries, pos
    flops = 2 * 2 * KV * K * G * cols * hd
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations"), nbytes


def _stored_rows(torch, d, table):
    """The pool rows at each lane's position (K=1): overlaying these
    instead of k_new/v_new is the fault of a dropped overlay row."""
    B = d["pos"].shape[0]
    P = d["fast_k"].shape[2]
    NP = d["slow_k"].shape[0] // B
    p = d["pos"].clamp(min=0).long()
    j, r = p // P, p % P
    b = torch.arange(B, device=p.device)
    e = table[b, j].long()
    fast = (e >= 0)[:, None, None]
    return [torch.where(fast, f[e.clamp(min=0), :, r], sl[b * NP + j, :, r])
            [:, None] for f, sl in ((d["fast_k"], d["slow_k"]),
                                    (d["fast_v"], d["slow_v"]))]


def kernel_phase(torch, dev):
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.paged_attention.ref import (
        bf16_tolerance, paged_attention_fused_ref)
    from repro_torch.kernels.remap_gather import ops as rg_ops
    from repro_torch.kernels.remap_gather.ref import remap_gather_ref

    rows = {}
    # paged_attention_fused at the main path's shapes: B=8, KV=8, G=4,
    # hd=128, page=16, bf16, K=1, a 64-page live bucket of 128 pages,
    # 144 fast slots.  Tolerance: two bf16 ulps of each value of the plain
    # version computed in fp32 and cast to bf16 (both sides round an fp32
    # sum of the same inputs); the same check must flag the fault of a
    # dropped overlay row; the bucket must equal the full 128-page width
    # bit for bit.
    d, table = _fused_inputs(torch, dev, B=8, K=1, KV=8, G=4, hd=128, P=16,
                             NP=128, F=144, n_pages=64,
                             dtype=torch.bfloat16, seed=1)
    live = d["pos"] >= 0
    out = pa_ops.paged_attention_fused_op(**d)
    full = pa_ops.paged_attention_fused_op(**{**d, "entries": table})
    _check(torch.equal(out[live], full[live]),
           "paged_attention_fused: the 64-page bucket differs from the full "
           "width")
    d32 = {k: (v.float() if v.is_floating_point() else v)
           for k, v in d.items()}
    ref = paged_attention_fused_ref(**d32).to(torch.bfloat16)[live].float()
    tol = bf16_tolerance(ref)
    diff = (out[live].float() - ref).abs()
    err, ratio = diff.max().item(), (diff / tol).max().item()
    _check(math.isfinite(err) and ratio <= 1.0,
           f"paged_attention_fused bf16 error {err} over two ulps "
           f"(error/limit {ratio:.3f})")
    k_old, v_old = _stored_rows(torch, d32, table)
    fault = (paged_attention_fused_ref(**{**d32, "k_new": k_old,
                                          "v_new": v_old})
             .to(torch.bfloat16)[live].float() - ref).abs()
    caught = int(((fault > tol).flatten(1).any(1)).sum())
    fault_ratio = (fault / tol).max().item()
    _check(caught == int(live.sum()),
           f"a dropped overlay row passes the bf16 limit on "
           f"{int(live.sum()) - caught} lanes")
    print(f"kernel paged_attention_fused bf16 limit: kernel error/limit "
          f"{ratio:.3f} (max abs {err:.3e}, max |ref| "
          f"{ref.abs().max().item():.3e}); a dropped overlay row: "
          f"error/limit {fault_ratio:.2f} (max abs "
          f"{fault.max().item():.3e}), caught on {caught} of "
          f"{int(live.sum())} live lanes")
    ms = _time_ms(lambda: pa_ops.paged_attention_fused_op(**d))
    plain_ms = _time_ms(lambda: paged_attention_fused_ref(**d), reps=5)
    bound_ms, bound_by, nbytes = _fused_bound(d)
    rows["paged_attention_fused"] = dict(
        name="paged_attention_fused", route="cuda",
        source="src/repro_torch/kernels/paged_attention/csrc/"
               "paged_attention_fused.cu",
        replaces="src/repro/kernels/paged_attention/paged_attention.py:259",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=None)
    print(f"kernel paged_attention_fused bf16 main shapes: max_abs_err "
          f"{err:.3e} (two-ulp limit), {ms:.4f} ms, plain {plain_ms:.3f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by})")
    print("kernel " + _vs_bound("paged_attention_fused", ms, bound_ms,
                                nbytes=nbytes))
    # a live bucket that is no multiple of the split width (8 pages) or
    # the ring depth (2): 61 pages, positions clamped inside it
    d61 = {**d, "pos": torch.where(d["pos"] >= 0,
                                   d["pos"].clamp(max=61 * 16 - 2),
                                   d["pos"]).to(torch.int32)}
    _check(torch.equal(
        pa_ops.paged_attention_fused_op(**{**d61, "entries": table[:, :61]})
        [live], pa_ops.paged_attention_fused_op(**{**d61, "entries": table})
        [live]), "paged_attention_fused: the 61-page bucket differs from "
        "the full width")
    print("kernel paged_attention_fused: the 64- and 61-page buckets equal "
          "the full 128-page width bit for bit")
    # smoke shapes: fp32, hd=16, page=8, K=2; tolerance 1e-4 (online and
    # full softmax sum in other orders)
    for K in (1, 2):
        d, _ = _fused_inputs(torch, dev, B=3, K=K, KV=2, G=2, hd=16, P=8,
                             NP=8, F=6, n_pages=8 if K == 1 else 4,
                             dtype=torch.float32, seed=2 + K)
        live = d["pos"] >= 0
        e = (pa_ops.paged_attention_fused_op(**d)[live]
             - paged_attention_fused_ref(**d)[live]).abs().max().item()
        _check(math.isfinite(e) and e <= 1e-4,
               f"paged_attention_fused fp32 K={K} error {e} > 1e-4")
        print(f"kernel paged_attention_fused fp32 smoke K={K}: max_abs_err "
              f"{e:.3e} (tol 1e-4)")
    rows["paged_attention_fused"]["shapes"] = fused_family_rows(
        torch, dev, rows["paged_attention_fused"])

    # remap_gather at the main path's call: the [L*n, KV*P, hd] view of a
    # 32-layer slow pool (n = 1024 homes, KV*P = 128 rows, hd = 128,
    # bf16), one index per layer; byte-exact.  Called, and timed, as the
    # maintenance pass calls it: with the pass's out-of-range flag, which
    # is read once after the batch.
    L, n = 32, 1024
    pool = torch.randn((L * n, 128, 128), device=dev).to(torch.bfloat16)
    idx = (torch.arange(L, device=dev, dtype=torch.int32) * n + 357)
    flag = rg_ops.new_flag(dev)
    got = rg_ops.remap_gather_op(pool, idx, flag)
    _check(torch.equal(got, remap_gather_ref(pool, idx)),
           "remap_gather bf16 differs from its plain version")
    small = torch.randn((40, 16, 16), device=dev)
    sidx = torch.tensor([3, 39, 0, 3], dtype=torch.int32, device=dev)
    _check(torch.equal(rg_ops.remap_gather_op(small, sidx, flag),
                       remap_gather_ref(small, sidx)),
           "remap_gather fp32 differs from its plain version")
    lidx = idx.long()
    ms = _time_ms(lambda: rg_ops.remap_gather_op(pool, idx, flag))
    rg_ops.check_flag(flag)
    plain_ms = _time_ms(lambda: remap_gather_ref(pool, idx))
    lib_ms = _time_ms(lambda: torch.index_select(pool, 0, lidx))
    nbytes = 2 * L * pool[0].numel() * pool.element_size() + 4 * L
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    rows["remap_gather"] = dict(
        name="remap_gather", route="cuda",
        source="src/repro_torch/kernels/remap_gather/csrc/remap_gather.cu",
        replaces="src/repro/kernels/remap_gather/remap_gather.py:24",
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by="bytes", library_ms=lib_ms)
    print(f"kernel remap_gather bf16 main call: exact, {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, index_select {lib_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms (bytes)")
    print("kernel " + _vs_bound("remap_gather", ms, bound_ms, nbytes=nbytes))
    del pool, got
    torch.cuda.empty_cache()
    rows.update(replay_rows(torch, dev))
    rows.update(irt_lookup_rows(torch, dev))
    rows.update(paged_read_rows(torch, dev))
    rows.update(flash_rows(torch, dev))
    return rows


# the other families' fused-read shapes (arch, KV heads, group, head dim),
# otherwise the main path's row: B=8, K=1, page 16, bf16, a 64-page
# bucket of 128 pages, 144 fast slots
FAMILY_FUSED = (("granite-moe-3b-a800m", 8, 3, 64), ("qwen2-7b", 4, 7, 128),
                ("codeqwen1.5-7b", 32, 1, 128))


def _shape_row(base, arch, shape, **numbers):
    """A kernel row at another family's shape: the base row's name,
    route, source and what it replaces, this shape's numbers; launches
    are those of phase 11's, 12's or 13's run of ``arch`` (0 where it
    serves none)."""
    keys = ("name", "route", "source", "replaces")
    return {**{k: base[k] for k in keys}, "arch": arch, "shape": shape,
            "launches": 0, **numbers}


def fused_family_rows(torch, dev, base):
    """paged_attention_fused at the other families' shapes, checked and
    timed as the main path's row: within two bf16 ulps of each value of
    the plain version, kernel, plain and bound times."""
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.paged_attention.ref import (
        bf16_tolerance, paged_attention_fused_ref)

    out_rows = []
    for i, (arch, KV, G, hd) in enumerate(FAMILY_FUSED):
        d, _ = _fused_inputs(torch, dev, B=8, K=1, KV=KV, G=G, hd=hd, P=16,
                             NP=128, F=144, n_pages=64,
                             dtype=torch.bfloat16, seed=40 + i)
        live = d["pos"] >= 0
        out = pa_ops.paged_attention_fused_op(**d)
        d32 = {k: (v.float() if v.is_floating_point() else v)
               for k, v in d.items()}
        ref = paged_attention_fused_ref(**d32).to(torch.bfloat16)[live] \
            .float()
        diff = (out[live].float() - ref).abs()
        err = diff.max().item()
        ratio = (diff / bf16_tolerance(ref)).max().item()
        shape = f"B 8, K 1, KV {KV}, G {G}, hd {hd}, page 16, bf16"
        _check(math.isfinite(err) and ratio <= 1.0,
               f"paged_attention_fused at {arch}'s shape ({shape}): error "
               f"{err} over two bf16 ulps (error/limit {ratio:.3f})")
        ms = _time_ms(lambda: pa_ops.paged_attention_fused_op(**d))
        plain_ms = _time_ms(lambda: paged_attention_fused_ref(**d), reps=5)
        bound_ms, bound_by, nbytes = _fused_bound(d)
        out_rows.append(_shape_row(
            base, arch, shape, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None))
        print(f"kernel paged_attention_fused at {arch}'s shape ({shape}): "
              f"error/limit {ratio:.3f} (max abs {err:.3e}), {ms:.4f} ms, "
              f"plain {plain_ms:.3f} ms, bound {bound_ms:.5f} ms "
              f"({bound_by}), {ms / bound_ms:.1f}x the bound, "
              f"{nbytes / ms / 1e6:.1f} GB/s")
    return out_rows


def _main_pass_records(torch, dev):
    """A recorded main-path pass, every record enabled: 4 demote
    copy-backs, then 4 promotions as cb1 -> install -> cb2 (rows (dir,
    src, dst, en); 144 fast slots, 1024 slow homes), with aliasing chains:
    promotion 0 installs into the slot the first demotion emptied,
    promotion 1 re-installs the page promotion 0 copied back, promotion
    2's cb2 copies back the slot it just installed (so the second window
    of 8 records runs record by record)."""
    from repro_torch.kernels.remap_gather.ref import FAST_TO_SLOW, SLOW_TO_FAST
    recs = [[FAST_TO_SLOW, s, h, 1] for s, h in
            ((3, 100), (17, 205), (40, 311), (77, 412))]
    for cb1, ins, cb2 in (((90, 500), (600, 3), (128, 700)),
                          ((91, 501), (500, 90), (129, 701)),
                          ((92, 502), (602, 92), (92, 702)),
                          ((93, 503), (603, 93), (130, 703))):
        recs += [[FAST_TO_SLOW, *cb1, 1], [SLOW_TO_FAST, *ins, 1],
                 [FAST_TO_SLOW, *cb2, 1]]
    return torch.tensor(recs, dtype=torch.int32, device=dev)


def _per_copy_chain(torch, rg_ops, pools, recs, err):
    """The replay the way the pass ran it before the replay kernel: per
    record and pool one gather launch of the page's rows on every layer,
    then a masked ``index_copy_`` (a disabled record rewrites the row's
    own bytes), src, dst and en read on the card.  Timed beside the one
    launch that replaces it."""
    from repro_torch.kernels.remap_gather.ref import FAST_TO_SLOW
    fk, fv, sk, sv = pools
    L = fk.shape[0]
    layer = torch.arange(L, dtype=torch.int32, device=fk.device)
    dirs = [r[0] for r in recs.tolist()]

    def run():
        for i, d in enumerate(dirs):
            s, t, en = recs[i, 1], recs[i, 2], recs[i, 3] != 0
            for fast, slow in ((fk, sk), (fv, sv)):
                src, dst = (fast, slow) if d == FAST_TO_SLOW else (slow, fast)
                n = src.shape[1]
                pages = rg_ops.remap_gather_op(
                    src.view(L * n, -1, src.shape[-1]),
                    (torch.where(en, s, 0) + layer * n).to(torch.int32),
                    err).view((L,) + tuple(src.shape[2:]))
                di = torch.where(en, t, 0).reshape(1).long()
                cur = dst.index_select(1, di)[:, 0]
                dst.index_copy_(1, di, torch.where(en, pages, cur)[:, None])
    return run


def replay_rows(torch, dev):
    """remap_replay, the maintenance pass's copies in one launch, at the
    main path's shapes: llama3-8b's stacked bf16 pools (32 layers, 144
    fast slots and 1024 slow homes of KV 8 x page 16 x hd 128) and a
    recorded pass of 4 demotions and 4 promotions, every record enabled,
    with aliasing chains: bit for bit against the plain per-record replay;
    kernel, plain, bound and per-copy-chain times.  Then bit for bit at
    the smoke slab (fp32, KV 2 x page 8 x hd 16) and at odd slabs (60
    and 30 bytes: the 4- and 1-byte word paths) over 600 aliasing records
    on 3 layers; an enabled record outside its pool writes nothing and
    raises the flag, a disabled one with garbage indices is never read."""
    from repro_torch.kernels.remap_gather import ops as rg_ops
    from repro_torch.kernels.remap_gather.ref import remap_replay_ref

    L = 32
    pools, recs, err, ms, plain_ms, bound_ms, nbytes = _replay_pass(
        torch, dev, L=L, KV=8, hd=128, seed=21)
    chain_ms = _time_ms(_per_copy_chain(torch, rg_ops, pools, recs, err),
                        reps=5)
    rg_ops.check_flag(err)
    n_en = int(recs[:, 3].sum())
    slab = pools[0][0, 0].numel() * pools[0].element_size()
    print(f"kernel remap_replay bf16 main pass ({recs.shape[0]} records, "
          f"{n_en} enabled, L={L}, {slab // 1024} KiB slabs): exact, one "
          f"launch {ms:.4f} ms, plain per-record version {plain_ms:.4f} ms, "
          f"per-copy chain ({2 * recs.shape[0]} gathers with their "
          f"index_copy_) {chain_ms:.4f} ms ({chain_ms / ms:.1f}x), bound "
          f"{bound_ms:.4f} ms (bytes, {nbytes / 2**20:.0f} MiB)")
    print("kernel " + _vs_bound("remap_replay", ms, bound_ms, nbytes=nbytes))
    del pools
    torch.cuda.empty_cache()
    g = torch.Generator(device=dev)
    g.manual_seed(23)

    rng = torch.Generator().manual_seed(22)
    n = 600
    d = torch.randint(0, 2, (n,), generator=rng, dtype=torch.int32)
    src = torch.where(d == 0, torch.randint(0, 5, (n,), generator=rng),
                      torch.randint(0, 9, (n,), generator=rng))
    dst = torch.where(d == 0, torch.randint(0, 9, (n,), generator=rng),
                      torch.randint(0, 5, (n,), generator=rng))
    en = torch.rand((n,), generator=rng) < 0.8
    small = torch.stack([d, torch.where(en, src, -(1 << 30)).int(),
                         torch.where(en, dst, (1 << 30) + 5).int(),
                         en.int()], 1).contiguous().to(dev)
    for dtype, page in ((torch.float32, (2, 8, 16)),
                        (torch.float32, (1, 3, 5)),
                        (torch.bfloat16, (1, 3, 5))):
        p = [torch.randn((3, m) + page, generator=g, device=dev).to(dtype)
             for m in (5, 5, 9, 9)]
        kern = [x.clone() for x in p]
        rg_ops.remap_replay_op(kern, small, err)
        rg_ops.check_flag(err)
        remap_replay_ref(p, small)
        _check(all(torch.equal(a, b) for a, b in zip(kern, p)),
               f"remap_replay differs from its plain version at {dtype} "
               f"page {page}")
    before = [x.clone() for x in kern]
    rg_ops.remap_replay_op(kern, torch.tensor(
        [[0, 0, 9, 1], [1, 1 << 30, -5, 0]], dtype=torch.int32, device=dev),
        err)
    _check(bool(err.item()) and all(torch.equal(a, b)
                                    for a, b in zip(kern, before)),
           "remap_replay: an enabled record outside its pool wrote or was "
           "not flagged")
    print(f"kernel remap_replay smoke and odd slabs (1024, 60, 30 bytes; "
          f"{n} records, {int(en.sum())} enabled, 3 layers): exact; an "
          f"out-of-range record flagged and dropped")
    row = dict(
        name="remap_replay", route="cuda",
        source="src/repro_torch/kernels/remap_gather/csrc/remap_gather.cu",
        replaces="src/repro/kernels/remap_gather/remap_gather.py:24",
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by="bytes", library_ms=None)
    row["shapes"] = []
    for arch, L, KV, hd in FAMILY_POOLS:
        pools, recs, err, ms, plain_ms, bound_ms, nbytes = _replay_pass(
            torch, dev, L=L, KV=KV, hd=hd, seed=24 + L)
        shape = f"L {L}, KV {KV}, page 16, hd {hd}, bf16"
        row["shapes"].append(_shape_row(
            row, arch, shape, max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by="bytes", library_ms=None))
        print(f"kernel remap_replay over {arch}'s stacked pools ({shape}; "
              f"the main pass's {recs.shape[0]} records): exact, {ms:.4f} "
              f"ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"(bytes, {nbytes / 2**20:.0f} MiB), {ms / bound_ms:.2f}x "
              f"the bound")
        del pools
        torch.cuda.empty_cache()
    return {"remap_replay": row}


# the other families' stacked pools (arch, layers, KV heads, head dim) at
# the main path's store: 144 fast slots, 1024 slow homes, page 16, bf16
FAMILY_POOLS = (("granite-moe-3b-a800m", 32, 8, 64), ("qwen2-7b", 28, 4, 128))


def _replay_pass(torch, dev, *, L, KV, hd, seed):
    """The recorded main-path pass replayed over seeded stacked bf16
    pools of L layers (144 fast slots, 1024 slow homes of KV x page 16 x
    hd): the kernel bit for bit against the plain per-record replay, then
    kernel and plain times and the byte bound.  Returns (pools, records,
    flag, ms, plain_ms, bound_ms, bytes)."""
    from repro_torch.kernels.remap_gather import ops as rg_ops
    from repro_torch.kernels.remap_gather.ref import remap_replay_ref

    F, S = 144, 1024
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    pools = [torch.randn((L, n, KV, 16, hd), generator=g,
                         device=dev).to(torch.bfloat16) for n in (F, F, S, S)]
    recs = _main_pass_records(torch, dev)
    kern = [x.clone() for x in pools]
    err = rg_ops.new_flag(dev)
    rg_ops.remap_replay_op(kern, recs, err)
    rg_ops.check_flag(err)
    remap_replay_ref(pools, recs)
    _check(all(torch.equal(a, b) for a, b in zip(kern, pools)),
           f"remap_replay differs from its plain version over L={L}, "
           f"KV={KV}, hd={hd} pools")
    del kern
    torch.cuda.empty_cache()
    ms = _time_ms(lambda: rg_ops.remap_replay_op(pools, recs, err))
    plain_ms = _time_ms(lambda: remap_replay_ref(pools, recs), reps=5)
    rg_ops.check_flag(err)
    n_en = int(recs[:, 3].sum())
    slab = pools[0][0, 0].numel() * pools[0].element_size()
    nbytes = n_en * 2 * L * slab * 2 + recs.numel() * 4
    return (pools, recs, err, ms, plain_ms,
            nbytes / HBM_BYTES_PER_S * 1e3, nbytes)


def _irt_table(torch, dev, n_ids, seed):
    """A seeded iRT over ``n_ids`` page ids with a fifth of them mapped to
    fast slots (leaf 31 among the allocated leaves, so bit 31 is read)."""
    from repro_torch.core.remap import irt
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    tab = irt.init_tables(n_ids, dev)
    ids = torch.randperm(n_ids, generator=g, device=dev)[:n_ids // 5]
    ids = torch.unique(torch.cat([ids, torch.tensor(
        [31 * irt.E], device=dev)]).to(torch.int32) % n_ids)
    slots = torch.randint(0, 512, ids.shape, generator=g, device=dev,
                          dtype=torch.int32)
    return irt.fill(tab, ids, slots, torch.ones_like(ids, dtype=torch.bool))


def irt_lookup_rows(torch, dev):
    """irt_lookup at the server's call (N = 4096 ids, the whole logical
    table, home = INVALID as ``_translate`` walks it), exact against the
    plain version; then a sweep over N, kernel beside plain version."""
    from repro_torch.kernels.irt_lookup import ops as irt_ops
    from repro_torch.kernels.irt_lookup.ref import irt_lookup_ref

    def walk_inputs(N, seed):
        tab = _irt_table(torch, dev, max(N, 4096), seed)
        ids = torch.arange(N, dtype=torch.int32, device=dev)
        home = torch.full_like(ids, -1)
        return ids, home, tab["l1_bits"], tab["entries"]

    args = walk_inputs(4096, 11)
    out = irt_ops.irt_lookup_op(*args)
    _check(torch.equal(out, irt_lookup_ref(*args)),
           "irt_lookup differs from its plain version at N = 4096")
    _check(bool((args[2] < 0).any()), "irt_lookup check never read bit 31")
    ms = _time_ms(lambda: irt_ops.irt_lookup_op(*args))
    plain_ms = _time_ms(lambda: irt_lookup_ref(*args))
    N = args[0].numel()
    bound_ms = (4 * 4 * N + 4 * args[2].numel()) / HBM_BYTES_PER_S * 1e3
    print(f"kernel irt_lookup at the server's N = {N}: exact, {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bound {bound_ms:.6f} ms (bytes)")
    print("kernel " + _vs_bound("irt_lookup", ms, bound_ms,
                                nbytes=bound_ms * HBM_BYTES_PER_S / 1e3))
    sweep = []
    for n in (256, 1024, 4096, 65536):
        a = walk_inputs(n, 12 + n)
        _check(torch.equal(irt_ops.irt_lookup_op(*a), irt_lookup_ref(*a)),
               f"irt_lookup differs from its plain version at N = {n}")
        k_ms = _time_ms(lambda: irt_ops.irt_lookup_op(*a))
        p_ms = _time_ms(lambda: irt_lookup_ref(*a))
        sweep.append(dict(N=n, kernel_ms=k_ms, plain_ms=p_ms))
        print(f"kernel irt_lookup sweep N={n}: kernel {k_ms:.4f} ms, plain "
              f"{p_ms:.4f} ms ({p_ms / k_ms:.2f}x), exact")
    print(f"kernel irt_lookup sweep {json.dumps(sweep)}")
    rows = {"irt_lookup": dict(
        name="irt_lookup", route="cuda",
        source="src/repro_torch/kernels/irt_lookup/csrc/irt_lookup.cu",
        replaces="src/repro/kernels/irt_lookup/irt_lookup.py:50",
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by="bytes", library_ms=None)}
    rows.update(walk2_rows(torch, dev, walk_inputs))
    return rows


def walk2_rows(torch, dev, walk_inputs):
    """irt_walk2 (the walk to both homes with the iRC probe folded in) at
    the server's call (N = 4096, base 576 fast slots, a seeded probe with
    half the ids hit), exact against its plain version; beside it the
    chain it replaces in the translation (the one-home kernel to INVALID,
    then the comparison and three ``where``s); exact at N = 1 and
    65536."""
    from repro_torch.kernels.irt_lookup import ops as irt_ops
    from repro_torch.kernels.irt_lookup.ref import irt_walk2_ref

    def inputs(N, seed):
        ids, _, l1, ent = walk_inputs(N, seed)
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        hit = torch.rand(N, generator=g, device=dev) < 0.5
        probe = (hit, torch.randint(0, 576, (N,), generator=g, device=dev,
                                    dtype=torch.int32),
                 hit & (torch.rand(N, generator=g, device=dev) < 0.5))
        return ids, l1, ent, probe

    base = 576
    for N in (1, 65536, 4096):
        ids, l1, ent, probe = inputs(N, 30 + N)   # the last: timed below
        for pr in (None, probe):
            got = irt_ops.irt_walk2_op(ids, base, l1, ent, pr)
            want = irt_walk2_ref(ids, base, l1, ent, pr)
            _check(all(torch.equal(a, b) for a, b in zip(got, want)),
                   f"irt_walk2 differs from its plain version at N = {N}")

    def chain():
        walked = irt_ops.irt_lookup_op(ids, torch.full_like(ids, -1), l1, ent)
        home = base + ids
        dev_walk = torch.where(walked == -1, home, walked)
        hit, val, id_hit = probe
        return walked, torch.where(hit, torch.where(id_hit, home, val),
                                   dev_walk)

    _check(all(torch.equal(a, b) for a, b in zip(
        chain(), irt_ops.irt_walk2_op(ids, base, l1, ent, probe))),
        "irt_walk2 differs from the chain it replaces")
    ms = _time_ms(lambda: irt_ops.irt_walk2_op(ids, base, l1, ent, probe))
    plain_ms = _time_ms(lambda: irt_walk2_ref(ids, base, l1, ent, probe))
    chain_ms = _time_ms(chain)
    N = ids.numel()
    nbytes = (4 + 4 + 1 + 4 + 1 + 2 * 4) * N + 4 * l1.numel()
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"kernel irt_walk2 at the server's N = {N} (probe folded in): "
          f"exact (and at N = 1, 65536, with and without the probe), "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, the chain it replaces "
          f"(one-home kernel + 5 launches) {chain_ms:.4f} ms "
          f"({chain_ms / ms:.2f}x), bound {bound_ms:.6f} ms (bytes)")
    print("kernel " + _vs_bound("irt_walk2", ms, bound_ms, nbytes=nbytes))
    return {"irt_walk2": dict(
        name="irt_walk2", route="cuda",
        source="src/repro_torch/kernels/irt_lookup/csrc/irt_lookup.cu",
        replaces="src/repro/kernels/irt_lookup/irt_lookup.py:50",
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by="bytes", library_ms=None)}


def _read_inputs(torch, dev, *, B, KV, G, hd, P, NP, F, lens, dtype, seed):
    """Seeded one-token read inputs: seq_lens drawn from ``lens`` (the
    last lane idle), a unified-space page table with about 15 % of pages
    on fast slots and the rest on their slow homes."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g, device=dev).to(dtype)  # noqa
    seq = torch.randint(lens[0], lens[1] + 1, (B,), generator=g, device=dev,
                        dtype=torch.int32)
    seq[-1] = 0
    homes = F + torch.arange(B * NP, dtype=torch.int32,
                             device=dev).view(B, NP)
    slots = torch.randint(0, F, (B, NP), generator=g, device=dev,
                          dtype=torch.int32)
    fast = torch.rand((B, NP), generator=g, device=dev) < 0.15
    return dict(q=r(B, KV, G, hd), fast_k=r(F, KV, P, hd),
                fast_v=r(F, KV, P, hd), slow_k=r(B * NP, KV, P, hd),
                slow_v=r(B * NP, KV, P, hd),
                page_table=torch.where(fast, slots, homes).to(torch.int32),
                seq_lens=seq)


def _read_bound(d):
    """Least time for one read on this data: q in and out once, the live
    pages of live lanes (K and V) and their page-table entries read once,
    the seq_lens; fp32 flops of QK and PV over the attended columns."""
    B, KV, G, hd = d["q"].shape
    P = d["fast_k"].shape[2]
    item = d["q"].element_size()
    pages = sum(-(-max(int(n), 0) // P) for n in d["seq_lens"].tolist())
    nbytes = (2 * d["q"].numel() * item + 2 * KV * pages * P * hd * item
              + 4 * (pages + B))
    flops = 2 * 2 * KV * G * pages * P * hd
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations"), nbytes


def _as_fused(torch, d):
    """A one-token read's inputs as the fused step over the same store:
    entries from the page table (slow homes are identity rows), pos the
    last stored row, and as the step's new rows the rows already stored
    there, so the overlay rewrites the same bytes."""
    B = d["q"].shape[0]
    F, P = d["fast_k"].shape[0], d["fast_k"].shape[2]
    table = d["page_table"]
    pos = (d["seq_lens"] - 1).to(torch.int32)
    p = pos.clamp(min=0).long()
    j, r = p // P, p % P
    slot = table[torch.arange(B, device=p.device), j].long()
    fast = (slot < F)[:, None, None]
    new = [torch.where(fast, f[slot.clamp(max=F - 1), :, r],
                       sl[(slot - F).clamp(min=0), :, r])[:, None]
           for f, sl in ((d["fast_k"], d["slow_k"]),
                         (d["fast_v"], d["slow_v"]))]
    return dict(q=d["q"][:, None], fast_k=d["fast_k"], fast_v=d["fast_v"],
                slow_k=d["slow_k"], slow_v=d["slow_v"],
                entries=torch.where(table < F, table, -1).to(torch.int32),
                k_new=new[0], v_new=new[1], pos=pos)


def paged_read_rows(torch, dev):
    """paged_attention_split and paged_attention at the server's shapes
    (B=16, KV=8, G=4, hd=128, page 16, bf16, 256 pages per lane, 576 fast
    slots, 15 live lanes of 1024-3968 tokens, one idle): within two bf16
    ulps of each value of the plain version (computed in fp32, cast to
    bf16) on live lanes, split == unified over the concatenated pools bit
    for bit, an idle lane zeros; at the smoke shapes (hd 16, page 8, fp32)
    within 1e-4 (online and full softmax sum in other orders)."""
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.paged_attention.ref import (
        bf16_tolerance, paged_attention_ref, paged_attention_split_ref)

    def unified(d):
        return (d["q"], torch.cat([d["fast_k"], d["slow_k"]]),
                torch.cat([d["fast_v"], d["slow_v"]]), d["page_table"],
                d["seq_lens"])

    rows = {}
    d = _read_inputs(torch, dev, B=16, KV=8, G=4, hd=128, P=16, NP=256,
                     F=576, lens=(1024, 3968), dtype=torch.bfloat16, seed=21)
    u = unified(d)
    live = d["seq_lens"] > 0
    split = pa_ops.paged_attention_split_op(**d)
    uni = pa_ops.paged_attention_op(*u)
    _check(torch.equal(split, uni), "paged_attention_split differs from "
           "paged_attention over the concatenated pools")
    _check(bool((split[~live] == 0).all()), "an idle lane is not zeros")
    fused = pa_ops.paged_attention_fused_op(**_as_fused(torch, d))[:, 0]
    _check(torch.equal(fused[live], split[live]), "paged_attention_split "
           "differs from the fused step over the same store")
    d32 = {k: (v.float() if v.is_floating_point() else v)
           for k, v in d.items()}
    ref = paged_attention_split_ref(**d32).to(torch.bfloat16)[live].float()
    diff = (split[live].float() - ref).abs()
    err, ratio = diff.max().item(), (diff / bf16_tolerance(ref)).max().item()
    _check(math.isfinite(err) and ratio <= 1.0,
           f"paged_attention_split bf16 error {err} over two ulps "
           f"(error/limit {ratio:.3f})")
    bound_ms, bound_by, nbytes = _read_bound(d)
    split_ms = _time_ms(lambda: pa_ops.paged_attention_split_op(**d))
    uni_ms = _time_ms(lambda: pa_ops.paged_attention_op(*u))
    split_plain = _time_ms(lambda: paged_attention_split_ref(**d), reps=5)
    uni_plain = _time_ms(lambda: paged_attention_ref(*u), reps=5)
    cat_ms = _time_ms(lambda: unified(d))
    print(f"kernel paged_attention_split/paged_attention bf16 server "
          f"shapes: split == unified bit for bit; error/limit {ratio:.3f} "
          f"(max abs {err:.3e}, max |ref| {ref.abs().max().item():.3e}); "
          f"split {split_ms:.4f} ms (plain {split_plain:.3f}), unified "
          f"{uni_ms:.4f} ms (plain {uni_plain:.3f}), the concat path's "
          f"pool copy {cat_ms:.4f} ms; bound {bound_ms:.4f} ms ({bound_by}); "
          f"split == unified == fused (one token) bit for bit")
    for name, ms in (("paged_attention_split", split_ms),
                     ("paged_attention", uni_ms)):
        print("kernel " + _vs_bound(name, ms, bound_ms, nbytes=nbytes))
    for name, ms, plain_ms, line in (
            ("paged_attention_split", split_ms, split_plain, 206),
            ("paged_attention", uni_ms, uni_plain, 164)):
        rows[name] = dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/paged_attention/csrc/"
                   "paged_attention.cu",
            replaces=f"src/repro/kernels/paged_attention/paged_attention.py"
                     f":{line}",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, library_ms=None)
    del d, u, d32, split, uni, fused
    torch.cuda.empty_cache()
    d = _read_inputs(torch, dev, B=4, KV=2, G=2, hd=16, P=8, NP=8, F=6,
                     lens=(1, 64), dtype=torch.float32, seed=22)
    live = d["seq_lens"] > 0
    want = paged_attention_split_ref(**d)[live]
    for name, got in (
            ("paged_attention_split", pa_ops.paged_attention_split_op(**d)),
            ("paged_attention", pa_ops.paged_attention_op(*unified(d)))):
        e = (got[live] - want).abs().max().item()
        _check(math.isfinite(e) and e <= 1e-4,
               f"{name} fp32 smoke error {e} > 1e-4")
        print(f"kernel {name} fp32 smoke: max_abs_err {e:.3e} (tol 1e-4)")
    return rows


def _flash_plain(q, k, v, **kw):
    """``attention_ref`` in fp32 on model-layout tensors."""
    from repro_torch.kernels.flash_attention.ref import attention_ref
    return attention_ref(q.transpose(1, 2).float(), k.transpose(1, 2).float(),
                         v.transpose(1, 2).float(), **kw).transpose(1, 2)


def _flash_bound(S, T, H, KV, hd, q_offset, item, window=0, causal=True,
                 B=1):
    """Least time for one call over B lanes: 4*hd flops per unmasked
    (query, key) pair and head at the peak for the inputs' type (bf16:
    the tensor cores; fp32: the CUDA cores, where the fp32 kernel runs),
    against Q, O and the K/V rows any query sees (those inside the
    sliding window, where there is one; all T when not causal), each
    moved once, at HBM bandwidth."""
    if causal:
        pos = range(q_offset, q_offset + S)
        low = (lambda p: max(0, p - window + 1)) if window else (lambda p: 0)
        pairs = sum(min(p + 1, T) - low(p) for p in pos)
        keys = min(q_offset + S, T) - low(q_offset)
    else:
        pairs, keys = S * T, T
    nbytes = B * item * (2 * S * H * hd + 2 * keys * KV * hd)
    flops = B * 4 * hd * H * pairs
    rate = BF16_FLOP_PER_S if item == 2 else FP32_FLOP_PER_S
    t_ops = flops / rate * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes"), flops


def _flash_case(torch, dev, q, k, v, off, label, window=0, causal=True):
    """One flash call checked and timed: bf16 within two bf16 ulps of
    each value of the plain version, fp32 within 1e-4; kernel, plain and
    ``scaled_dot_product_attention`` times (the library on [B, H, S, hd]
    copies made beforehand, causal and windowed by a boolean mask where
    ``is_causal`` does not say it, unmasked when not causal) and the
    bound.  Returns the row's numbers."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.paged_attention.ref import bf16_tolerance

    op = fa_ops.flash_attention_op
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    bf16 = q.dtype == torch.bfloat16
    kw = dict(q_offset=off, window=window, causal=causal)
    out = op(q, k, v, **kw)
    ref = _flash_plain(q, k, v, **kw).to(q.dtype).float()
    diff = (out.float() - ref).abs()
    err = diff.max().item()
    ratio = (diff / (bf16_tolerance(ref) if bf16 else 1e-4)).max().item()
    _check(math.isfinite(err) and ratio <= 1.0,
           f"flash_attention {label} {q.dtype} error {err} over its limit "
           f"(two bf16 ulps, fp32 1e-4; error/limit {ratio:.3f})")
    lq, lk, lv = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    if not causal or (off == 0 and window == 0):
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            lq, lk, lv, is_causal=causal, enable_gqa=True)
    else:
        kpos = torch.arange(T, device=dev)[None, :]
        qpos = torch.arange(off, off + S, device=dev)[:, None]
        mask = kpos <= qpos
        if window:
            mask &= kpos > qpos - window
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            lq, lk, lv, attn_mask=mask, enable_gqa=True)
    lib_err = (lib().transpose(1, 2).float() - ref).abs().max().item()
    ms = _time_ms(lambda: op(q, k, v, **kw))
    plain_ms = _time_ms(lambda: _flash_plain(q, k, v, **kw), reps=5)
    lib_ms = _time_ms(lib)
    bound_ms, bound_by, flops = _flash_bound(S, T, H, KV, hd, off,
                                             q.element_size(), window, causal,
                                             B)
    print(f"kernel flash_attention {'bf16' if bf16 else 'fp32'} {label} "
          f"(B={B}, S={S}, q_offset={off}, T={T}, H={H}/{KV}, hd={hd}, "
          f"{'causal' if causal else 'non-causal'}"
          f"{f', window {window}' if window else ''}): error/limit "
          f"{ratio:.3f} (max abs {err:.3e}), {ms:.4f} ms, plain "
          f"{plain_ms:.3f} ms, scaled_dot_product_attention {lib_ms:.4f} ms "
          f"(its max abs err {lib_err:.3e}), bound {bound_ms:.4f} ms "
          f"({bound_by}), {ms / bound_ms:.1f}x the bound")
    print("kernel " + _vs_bound(f"flash_attention {label}", ms, bound_ms,
                                flops=flops))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=lib_ms)


# the other families' prefill shapes (arch, H, KV, hd, T, window): the
# one-shot call over T, and for the unwindowed ones the 256-row chunk at
# q_offset T - 256 too
FAMILY_FLASH = (("granite-moe-3b-a800m", 24, 8, 64, 2048, 0),
                ("qwen2-7b", 28, 4, 128, 2048, 0),
                ("mixtral-8x22b", 48, 8, 128, 4608, 4096),
                ("hymba-1.5b", 25, 5, 64, 2048, 1024))


def flash_rows(torch, dev):
    """flash_attention at the main path's shapes (B=1, H=32, KV=8, hd=128,
    bf16): the one-shot causal prefill S = T = 2048, and a 256-row chunk at
    q_offset 1792 over T = 2048, as phase 7's chunked ingest runs it;
    within two bf16 ulps of each value of the plain version (fp32 scores
    and a full softmax, cast to bf16).  Rows independent of the call, bit
    for bit: the chunk call at page-aligned offsets equals the one-shot
    call's rows, and a call over 2T keys whose extra keys are causally
    masked equals the call over T.  Smoke shapes in fp32 (window > 0, not
    causal, a q_offset) within 1e-4 (online and full softmax sum in other
    orders).  Kernel, plain and ``scaled_dot_product_attention`` times.
    Then the same checks and times at the other families' shapes
    (``FAMILY_FLASH``)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops

    B, H, KV, hd, T, C = 1, 32, 8, 128, 2048, 256
    g = torch.Generator(device=dev)
    g.manual_seed(31)
    r = lambda *s: torch.randn(s, generator=g, device=dev).to(  # noqa: E731
        torch.bfloat16)
    q, k, v = r(B, T, H, hd), r(B, T, KV, hd), r(B, T, KV, hd)
    op = fa_ops.flash_attention_op
    full = op(q, k, v)
    shapes = {"one-shot": (q, 0), "chunk": (q[:, T - C:].contiguous(), T - C)}
    res = {label: _flash_case(torch, dev, qq, k, v, off, label)
           for label, (qq, off) in shapes.items()}
    starts = (0, 16, 272, 1008, 1536, 1792)
    for s in starts:
        part = op(q[:, s:s + C], k, v, q_offset=s)
        _check(torch.equal(part, full[:, s:s + C]),
               f"flash_attention: the chunk at q_offset {s} differs from the "
               f"one-shot call's rows")
    k2, v2 = (torch.cat([t, r(*t.shape)], dim=1) for t in (k, v))
    _check(torch.equal(op(q, k2, v2), full),
           "flash_attention: masked extra keys changed a row")
    print(f"kernel flash_attention rows independent of the call, bit for "
          f"bit: {C}-row chunks at q_offset {list(starts)} equal the "
          f"one-shot rows; T = {2 * T} with causally masked extra keys equals "
          f"T = {T}")
    del k2, v2, full
    gs = torch.Generator(device=dev)
    gs.manual_seed(32)
    for causal, window, off in ((True, 24, 0), (False, 0, 0), (True, 40, 32),
                                (False, 16, 64)):
        sq, sk, sv = (torch.randn(s, generator=gs, device=dev) for s in
                      ((2, 80, 4, 16), (2, 150, 2, 16), (2, 150, 2, 16)))
        kw = dict(causal=causal, window=window, q_offset=off)
        e = (op(sq, sk, sv, **kw) - _flash_plain(sq, sk, sv, **kw)) \
            .abs().max().item()
        _check(math.isfinite(e) and e <= 1e-4,
               f"flash_attention fp32 smoke {kw} error {e} > 1e-4")
        print(f"kernel flash_attention fp32 smoke {kw}: max_abs_err {e:.3e} "
              f"(tol 1e-4)")
    torch.cuda.empty_cache()
    row = dict(name="flash_attention", route="cuda",
               source="src/repro_torch/kernels/flash_attention/csrc/"
                      "flash_attention.cu",
               replaces="src/repro/kernels/flash_attention/flash_attention.py"
                        ":70", **res["chunk"])
    row["one_shot"] = res["one-shot"]
    row["shapes"] = []
    for i, (arch, H, KV, hd, T, window) in enumerate(FAMILY_FLASH):
        g.manual_seed(33 + i)
        q, k, v = r(B, T, H, hd), r(B, T, KV, hd), r(B, T, KV, hd)
        cases = [("one-shot", q, 0)] if window else [
            ("one-shot", q, 0), ("chunk", q[:, T - C:].contiguous(), T - C)]
        for label, qq, off in cases:
            shape = (f"{label}, S {qq.shape[1]}, q_offset {off}, T {T}, "
                     f"H {H}/{KV}, hd {hd}, window {window}, bf16")
            row["shapes"].append(_shape_row(row, arch, shape, **_flash_case(
                torch, dev, qq, k, v, off, f"{label} at {arch}'s shape",
                window)))
        del q, k, v
        torch.cuda.empty_cache()
    return {"flash_attention": row}


# ---------------------------------------------------------------------------
# phase 4: the main path at full width
# ---------------------------------------------------------------------------

def main_model(torch, dev):
    """llama3-8b as published, seeded random weights made on the card
    (shared by phases 4, 7 and 8)."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    cfg = get_config("llama3-8b")
    t0 = time.perf_counter()
    params = init_params(cfg, dev, seed=0)
    torch.cuda.synchronize()
    print(f"main: llama3-8b L={cfg.n_layers} d={cfg.d_model} "
          f"H={cfg.n_heads}/{cfg.n_kv_heads} hd={cfg.hd} ff={cfg.d_ff} "
          f"V={cfg.vocab} {cfg.dtype}, params made in "
          f"{time.perf_counter() - t0:.1f} s")
    return cfg, params


# the main path's engine geometry: 1024 logical pages, 144 fast slots
MAIN_EC = dict(batch=8, max_len=2048, backend="tiered", page_tokens=16,
               fast_data_slots=128, maintain_every=4)


def main_requests(cfg, n: int = 16):
    """The main path's seeded request mix, (prompt, max_new) each: prompts
    100-900 tokens, max_new 32-96 (phase 9 serves the first 8)."""
    import numpy as np
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        size = int(rng.integers(100, 901))
        out.append((rng.integers(0, cfg.vocab, size),
                    int(rng.integers(32, 97))))
    return out


def main_path_engine(torch, dev, cfg, params):
    """The main path's engine and requests: the tiered engine with 1024
    logical pages and 144 fast slots, 16 seeded requests (prompts 100-900
    tokens, max_new 32-96) already submitted."""
    from repro_torch.serve.engine import Engine, EngineConfig, Request

    eng = Engine(cfg, params, EngineConfig(**MAIN_EC), device=dev)
    t = eng.backend.tcfg
    slow = cfg.n_layers * t.n_logical * t.page_bytes
    print(f"main: {t.n_logical} logical pages, {t.fast_slots} fast slots, "
          f"slow pools {slow / 2**30:.2f} GiB")
    for i, (prompt, max_new) in enumerate(main_requests(cfg)):
        eng.submit(Request(rid=i, prompt=prompt, max_new=max_new))
    return eng


def main_path_phase(torch, dev, cfg, params):
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.remap_gather import ops as rg_ops
    from repro_torch.serve import engine as eng_mod

    eng = main_path_engine(torch, dev, cfg, params)
    spent: dict = {}              # phase -> host ms of each synchronised call
    real = eng_mod.decode_step

    def timed(phase, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            s = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            spent.setdefault(phase, []).append(
                (time.perf_counter() - s) * 1e3)
            return out
        return run

    eng_mod.decode_step = timed("decode step", real)
    eng.prefill_lane = timed("prefill", eng.prefill_lane)
    be = eng.backend
    be.plan_maintain = timed("maintenance plan", be.plan_maintain)
    be.apply_maintain = timed("maintenance apply", be.apply_maintain)
    be.release = timed("release", be.release)
    torch.cuda.reset_peak_memory_stats()
    pa_ops.launches = 0
    rg_ops.launches = rg_ops.replay_launches = 0
    fa_ops.launches = 0
    try:
        t0 = time.perf_counter()
        done = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        eng_mod.decode_step = real
    launches = {"paged_attention_fused": pa_ops.launches,
                "remap_gather": rg_ops.launches,
                "remap_replay": rg_ops.replay_launches}
    prefill_flash = fa_ops.launches
    passes = len(spent.get("maintenance apply", []))
    peak = torch.cuda.max_memory_allocated()
    c = eng.counters
    n_tok = sum(len(r.tokens) for r in done)
    _check(len(done) == 16 and all(r.done for r in done),
           f"{len(done)} of 16 requests finished")
    _check(all(0 <= x < cfg.vocab for r in done for x in r.tokens),
           "a token outside the vocabulary")
    _check(all(len(r.tokens) == r.max_new for r in done),
           "a request stopped short of max_new")
    _check(launches["paged_attention_fused"] == eng.steps * cfg.n_layers,
           f"paged_attention_fused launches {launches} != steps "
           f"{eng.steps} x {cfg.n_layers}")
    _check(passes > 0 and launches["remap_replay"] == passes
           and launches["remap_gather"] == passes,
           f"copy-engine launches {launches} != one replay per maintenance "
           f"pass ({passes})")
    _check(prefill_flash == len(spent["prefill"]) * cfg.n_layers,
           f"flash_attention launches {prefill_flash} != prefills x layers")
    _check(c["promo_bytes"] > 0, "no page was promoted")
    _check(eng.releases >= 1, "no lane was released")
    step_ms = sorted(spent["decode step"])
    print(f"main: {len(done)} requests, {n_tok} tokens, {eng.steps} decode "
          f"steps in {wall:.2f} s: {n_tok / wall:.1f} tokens/s end to end, "
          f"decode step median {step_ms[len(step_ms) // 2]:.2f} ms (p90 "
          f"{step_ms[int(len(step_ms) * 0.9)]:.2f} ms), "
          f"{eng.releases} releases")
    parts = [f"{k} {len(v)} x {sum(v) / len(v):.2f} ms = {sum(v) / 1e3:.2f} s"
             for k, v in spent.items()]
    rest = wall - sum(sum(v) for v in spent.values()) / 1e3
    print(f"main: time by phase (host clock, synchronised calls): "
          f"{'; '.join(parts)}; rest of the loop {rest:.2f} s")
    lat = sorted(r.done_at - r.arrived for r in done)
    ttft = sorted(r.first_token_at - r.arrived for r in done)
    print(f"main: request latency p50 {lat[len(lat) // 2]:.2f} s, max "
          f"{lat[-1]:.2f} s; time to first token p50 "
          f"{ttft[len(ttft) // 2]:.2f} s, max {ttft[-1]:.2f} s (all 16 "
          f"submitted at once)")
    print(f"main: launches {json.dumps(launches)} (one replay per "
          f"maintenance pass, {passes} passes); flash_attention "
          f"{prefill_flash} (the one-shot prefills)")
    totals = {k: v for k, v in c.items() if not k.startswith("epoch_")}
    print(f"main: counters {json.dumps(totals)}")
    print(f"main: peak device memory {peak / 2**30:.2f} GiB "
          f"(torch.cuda.max_memory_allocated)")
    del eng
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 5: dense against tiered at full width
# ---------------------------------------------------------------------------

def dense_tiered_phase(torch, dev, arch="llama3-8b"):
    """``arch`` at its published width, 2 layers, fp32 (random non-zero
    QKV biases where it has them), teacher-forced through the dense and
    the tiered backend with maintenance running, with the projections
    at 1/sqrt(d) (``weights.unit_fan_in``): logits within 1e-3.  For
    llama3-8b the gap at ``init_params``' own (the reference's) scale is
    printed first."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.weights import unit_fan_in

    cfg = dataclasses.replace(get_config(arch), n_layers=2, dtype="float32")
    params = init_params(cfg, dev, seed=1)
    if cfg.qkv_bias:
        _seed_biases(torch, dev, params, seed=6)
    if arch == "llama3-8b":
        worst, scale, _ = _dense_tiered_run(torch, dev, cfg, params)
        print(f"dense-vs-tiered: {arch} width at init_params' (the "
              f"reference's) projection scale: max |logit diff| {worst:.3e} "
              f"(max |logit| {scale:.3f}; not gated: fp32 reassociation "
              f"through nearly one-hot attention)")
    worst, scale, migrations = _dense_tiered_run(
        torch, dev, cfg, unit_fan_in(params, cfg))
    print(f"dense-vs-tiered: {arch} width, 2 layers, fp32, 1/sqrt(d) "
          f"projections, 24 steps, {migrations} migrations: max |logit "
          f"diff| {worst:.3e} (tol 1e-3; max |logit| {scale:.3f})")
    _check(migrations > 0, f"{arch}: no migration during the dense/tiered run")
    _check(math.isfinite(worst) and worst <= 1e-3,
           f"{arch}: dense vs tiered logits differ by {worst} > 1e-3")
    del params
    torch.cuda.empty_cache()


def _dense_tiered_run(torch, dev, cfg, params):
    """Phase 5's teacher-forced run -> (max |logit diff|, max |logit|,
    migrations)."""
    import numpy as np

    from repro_torch.core.policy import get_policy
    from repro_torch.models import decode_step, forward
    from repro_torch.models.kv_backend import DenseBackend, TieredBackend

    B, max_len = 4, 256
    dense = DenseBackend(cfg, dev)
    tiered = TieredBackend(cfg, B, max_len, page_tokens=16,
                           fast_data_slots=8,
                           policy=get_policy("threshold", epoch_len=2),
                           device=dev)
    sd, st = dense.init_state(B, max_len), tiered.init_state(B, max_len)
    rng = np.random.default_rng(2)
    with torch.inference_mode():
        for lane, n in enumerate((37, 90, 5, 150)):
            toks = torch.as_tensor(rng.integers(0, cfg.vocab, (1, n)),
                                   device=dev)
            _, _, (k, v) = forward(cfg, params, {"tokens": toks},
                                   collect_cache=True)
            sd = dense.write_prefill(sd, lane, k[:, 0], v[:, 0], n)
            st = tiered.write_prefill(st, lane, k[:, 0], v[:, 0], n)
        diffs, scale = [], 0.0
        for i in range(24):
            tok = torch.as_tensor(rng.integers(0, cfg.vocab, B),
                                  dtype=torch.int32, device=dev)
            ld, sd = decode_step(cfg, params, sd, tok, backend=dense)
            lt, st = decode_step(cfg, params, st, tok, backend=tiered)
            diffs.append((ld - lt).abs().max().item())
            scale = max(scale, ld.abs().max().item())
            if i % 3 == 2:
                st = tiered.maintain(st)
    return max(diffs), scale, int(st.caches.migrations)


def _seed_biases(torch, dev, params, seed):
    """Seeded random QKV biases, std 0.5, in place: the published init
    starts them at zero, which would leave the bias adds untested."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    for name in ("bq", "bk", "bv"):
        b = params["blocks"]["attn"][name]
        b.copy_(torch.randn(b.shape, generator=g, device=dev) * 0.5)


# ---------------------------------------------------------------------------
# phase 6: the single-store tiered server
# ---------------------------------------------------------------------------

SERVER_PATHS = (               # (label, decode path, cache_device_table)
    ("zero_copy", "zero_copy", True),
    ("split_pool_uncached", "zero_copy", False),
    ("concat", "concat", False),
    ("fused", "fused", True),
)
SERVER_STEPS = 64
RELEASE_STEP = 32


def server_inputs(torch, dev):
    """The server's store geometry and seeded inputs: llama3-8b's
    per-layer KV widths (KV 8, G 4, hd 128, bf16, page 16), 16 lanes x 256
    pages (4096 logical pages, 64 iRT leaves), 512 fast data slots (576
    fast slots), the default policy; 15 lanes start at seeded positions
    in 1024-3968, the last is idle; q, k, v for every step."""
    from repro_torch.tiered import kvcache as tk

    tcfg = tk.TieredConfig(n_seqs=16, max_pages_per_seq=256, page_tokens=16,
                           n_kv_heads=8, head_dim=128, fast_data_slots=512,
                           dtype="bfloat16")
    B, KV, G, hd = tcfg.n_seqs, tcfg.n_kv_heads, 4, tcfg.head_dim
    g = torch.Generator(device=dev)
    g.manual_seed(4)
    pos0 = torch.randint(1024, 3969, (B,), generator=g, device=dev,
                         dtype=torch.int32)
    pos0[-1] = -1
    r = lambda *s: torch.randn(s, generator=g, device=dev).to(  # noqa: E731
        torch.bfloat16)
    return dict(tcfg=tcfg, pos0=pos0, q=r(SERVER_STEPS, B, KV, G, hd),
                k=r(SERVER_STEPS, B, KV, hd), v=r(SERVER_STEPS, B, KV, hd))


def make_server(torch, dev, tcfg, path):
    """A ``TieredServer`` whose slow pools hold seeded bytes (the same for
    every path)."""
    from repro_torch.serve.engine import TieredServer
    srv = TieredServer(tcfg, path=path, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    for pool in (srv.state.slow_k, srv.state.slow_v):
        pool.copy_(torch.randn(pool.shape, generator=g, device=dev))
    return srv


def server_run(torch, dev, path, cached, inputs, *, check_waits=False,
               count_pass=False):
    """One ``TieredServer`` run over the seeded inputs: 64 steps,
    ``maintain()`` every 4 steps, lane 0 released before step 32 and
    restarted at position 0.  Launch counts are reset just before the run
    and read just after.  ``count_pass``: after the run, one more
    ``maintain()`` under the profiler, counting its kernel launches."""
    import dataclasses as dc

    from repro_torch.core.remap.irt import INVALID
    from repro_torch.kernels.irt_lookup import ops as irt_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.remap_gather import ops as rg_ops

    tcfg = dc.replace(inputs["tcfg"], cache_device_table=cached)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    srv = make_server(torch, dev, tcfg, path)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()        # after the seeding's temps
    pos = inputs["pos0"].clone()
    outs, lives, step_ms, maint_ms = [], [], [], []
    released_clean = None
    pa_ops.launches = pa_ops.split_launches = pa_ops.unified_launches = 0
    irt_ops.launches = irt_ops.walk2_launches = 0
    rg_ops.launches = rg_ops.replay_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(SERVER_STEPS):
        if i == RELEASE_STEP:
            srv.release(0)
            released_clean = bool(
                (srv.state.leaf_table[:tcfg.max_pages_per_seq]
                 == INVALID).all())
            pos[0] = 0
        lives.append(pos >= 0)
        torch.cuda.synchronize()
        s = time.perf_counter()
        if check_waits and i == 1:
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = srv.step(inputs["q"][i], inputs["k"][i],
                               inputs["v"][i], pos)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        else:
            out = srv.step(inputs["q"][i], inputs["k"][i], inputs["v"][i],
                           pos)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - s) * 1e3)
        outs.append(out.reshape(inputs["q"][i].shape))
        pos = torch.where(pos >= 0, pos + 1, pos)
        if i % 4 == 3:
            s = time.perf_counter()
            srv.maintain()
            torch.cuda.synchronize()
            maint_ms.append((time.perf_counter() - s) * 1e3)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"paged_attention_fused": pa_ops.launches,
                "remap_gather": rg_ops.launches,
                "remap_replay": rg_ops.replay_launches,
                "irt_lookup": irt_ops.launches,
                "irt_walk2": irt_ops.walk2_launches,
                "paged_attention_split": pa_ops.split_launches,
                "paged_attention": pa_ops.unified_launches}
    c = srv.counters
    pass_launches = None
    if count_pass:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            srv.maintain()
            torch.cuda.synchronize()
        pass_launches = sum(1 for e in prof.events()
                            if "LaunchKernel" in e.name)
    pool_bytes = sum(getattr(srv.state, f).numel()
                     * getattr(srv.state, f).element_size()
                     for f in ("fast_k", "fast_v", "slow_k", "slow_v"))
    copied = c["promo_bytes"] + c["demo_bytes"]
    if path == "concat":
        copied += SERVER_STEPS * pool_bytes     # unified_pools every step
    res = dict(outs=outs, lives=lives, counters=c, launches=launches,
               wall=wall, step_ms=sorted(step_ms), maint_ms=maint_ms,
               copied=copied, peak=torch.cuda.max_memory_allocated() - base,
               released_clean=released_clean, n_logical=tcfg.n_logical,
               pass_launches=pass_launches)
    del srv
    torch.cuda.empty_cache()
    return res


def server_phase(torch, dev):
    """``TieredServer`` over one store (one attention layer's worth) at
    ``server_inputs``' geometry: slow pools 2 x 128 MiB, fast pools 2 x 18
    MiB; every path sees the same seeded inputs."""
    from repro_torch.kernels.paged_attention.ref import bf16_tolerance

    inputs = server_inputs(torch, dev)
    tcfg = inputs["tcfg"]
    print(f"server: {tcfg.n_logical} logical pages, {tcfg.n_leaf} iRT "
          f"leaves, {tcfg.fast_slots} fast slots, slow pools 2 x "
          f"{tcfg.n_logical * tcfg.page_bytes // 2 / 2**20:.0f} MiB, fast "
          f"pools 2 x {tcfg.fast_slots * tcfg.page_bytes // 2 / 2**20:.0f} "
          f"MiB; {SERVER_STEPS} steps, maintain every 4, lane 0 released "
          f"at step {RELEASE_STEP}")
    runs = {}
    for label, path, cached in SERVER_PATHS:
        runs[label] = res = server_run(torch, dev, path, cached, inputs,
                                       check_waits=label == "zero_copy",
                                       count_pass=label == "zero_copy")
        n = SERVER_STEPS
        sm = res["step_ms"]
        c = res["counters"]
        print(f"server {label}: {n / res['wall']:.1f} steps/s "
              f"({res['wall'] * 1e3 / n:.3f} ms per step with maintenance), "
              f"synchronised step median {sm[n // 2]:.3f} ms (p90 "
              f"{sm[int(n * 0.9)]:.3f}), "
              f"maintain {sum(res['maint_ms']) / len(res['maint_ms']):.3f} "
              f"ms x {len(res['maint_ms'])}; translated pages per step "
              f"{c['lookups'] / n:.1f}; pool bytes copied per step "
              f"{res['copied'] / n:.0f}; launches "
              f"{json.dumps(res['launches'])}; peak memory "
              f"{res['peak'] / 2**20:.1f} MiB above the run's start (the "
              f"store's pools included); "
              f"counters {json.dumps(c)}")
    zc = runs["zero_copy"]
    worst = 0.0
    for i in range(SERVER_STEPS):
        live = zc["lives"][i]
        a = zc["outs"][i][live]
        for label in ("split_pool_uncached", "concat"):
            _check(torch.equal(a, runs[label]["outs"][i][live]),
                   f"server step {i}: zero_copy differs from {label} on a "
                   f"live lane")
        f = runs["fused"]["outs"][i][live]
        if not torch.equal(a, f):
            lim = bf16_tolerance(f)
            worst = max(worst, ((a.float() - f.float()).abs()
                                / lim).max().item())
    _check(worst <= 1.0, f"server: zero_copy vs fused at {worst:.3f} of the "
           f"bf16 limit")
    print("server: zero_copy == split_pool_uncached == concat bit for bit on "
          "every live lane at every step; zero_copy vs fused: "
          + ("bit for bit" if worst == 0.0 else
             f"error/limit {worst:.3f} (bf16 two ulps)"))
    c = zc["counters"]
    _check(c["dev_hits"] > 0, "the cached path never hit the device table")
    _check(c["lookups"] < SERVER_STEPS * zc["n_logical"] / 4,
           f"the cached path translated {c['lookups']} pages in "
           f"{SERVER_STEPS} steps")
    for label, res in runs.items():
        _check(res["released_clean"], f"server {label}: the released lane "
               f"kept a leaf entry")
        rc = res["counters"]
        _check(rc["migrations"] + rc["demotions"] > 0,
               f"server {label}: no page moved")
        n_pass = len(res["maint_ms"])
        _check(res["launches"]["remap_replay"] == n_pass
               and res["launches"]["remap_gather"] == n_pass,
               f"server {label}: copy-engine launches {res['launches']} != "
               f"one replay per maintenance pass ({n_pass})")
    _check(zc["launches"]["irt_walk2"] == zc["launches"]["irt_lookup"] > 0,
           f"server zero_copy: walk launches {zc['launches']}")
    print(f"server: one copy-engine launch per maintain() pass on every "
          f"path; a zero_copy maintain() pass makes "
          f"{zc['pass_launches']} kernel launches (torch.profiler)")
    launches = {k: runs["zero_copy"]["launches"][k]
                for k in ("irt_lookup", "irt_walk2",
                          "paged_attention_split")}
    launches["paged_attention"] = runs["concat"]["launches"]["paged_attention"]
    total = {k: sum(r["launches"][k] for r in runs.values())
             for k in runs["zero_copy"]["launches"]}
    for k in ("irt_lookup", "irt_walk2", "paged_attention_split",
              "paged_attention", "remap_gather", "remap_replay",
              "paged_attention_fused"):
        _check(total[k] > 0, f"server phase: {k} never launched")
    print(f"server: a zero-copy step ran with no host wait (sync debug mode "
          f"'error'); launches over the phase {json.dumps(total)}")
    return launches


# ---------------------------------------------------------------------------
# phase 7: chunked prefill + multi-tenant QoS at full width
# ---------------------------------------------------------------------------

def chunked_qos_phase(torch, dev, cfg, params):
    """Phase 4's weights served by the chunked scheduler with two
    tenants: 256-token chunks, one per engine step; the interactive
    tenant (weight 2, on-demand decider) admits its prompts' first two
    pages straight into the fast pool; maintenance runs the per-tenant
    pass.  16 seeded requests alternate tenants, prompts 200-1900 tokens
    (padded lengths <= 2048: 1-8 chunks each), max_new 32-64."""
    import numpy as np

    from repro_torch.core.remap.irt import INVALID
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.remap_gather import ops as rg_ops
    from repro_torch.serve import engine as eng_mod
    from repro_torch.serve.engine import Engine, EngineConfig, Request
    from repro_torch.serve.sched import TenantConfig

    ec = EngineConfig(batch=8, max_len=2048, backend="tiered",
                      page_tokens=16, fast_data_slots=128, maintain_every=4,
                      scheduler="chunked", prefill_chunk=256, admit_pages=2,
                      tenants=(TenantConfig("interactive", weight=2,
                                            policy="on_demand"),
                               TenantConfig("batch", weight=1)))
    eng = Engine(cfg, params, ec, device=dev)
    rng = np.random.default_rng(7)
    for i in range(16):
        eng.submit(Request(rid=i, prompt=rng.integers(
            0, cfg.vocab, int(rng.integers(200, 1901))),
            max_new=int(rng.integers(32, 65)),
            tenant_id=("interactive", "batch")[i % 2]))
    spent: dict = {}

    def timed(phase, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            s = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            spent.setdefault(phase, []).append(
                (time.perf_counter() - s) * 1e3)
            return out
        return run

    real_step, chunk_fwd, write_chunk = (eng_mod.decode_step, eng.chunk_fwd,
                                         eng.write_chunk)
    eng_mod.decode_step = timed("decode step", real_step)
    eng.chunk_fwd = lambda logits=False: timed(
        "chunk forward", chunk_fwd(logits=logits))
    eng.write_chunk = timed("chunk write", write_chunk)
    eng.admit_fast = timed("admission", eng.admit_fast)
    eng.prefill_lane = timed("one-shot prefill", eng.prefill_lane)
    be = eng.backend
    be.maintain_tenants = timed("maintenance", be.maintain_tenants)
    be.release = timed("release", be.release)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa_ops.launches = pa_ops.launches = rg_ops.launches = 0
    rg_ops.replay_launches = 0
    try:
        t0 = time.perf_counter()
        done = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        eng_mod.decode_step = real_step
    launches = {"flash_attention": fa_ops.launches,
                "paged_attention_fused": pa_ops.launches,
                "remap_gather": rg_ops.launches,
                "remap_replay": rg_ops.replay_launches}
    copies = len(spent.get("maintenance", [])) \
        + len(spent.get("admission", []))
    peak = torch.cuda.max_memory_allocated()
    stats = eng.request_stats(done)
    fair = stats["fairness"]
    c = eng.counters
    st = eng.final_state.caches
    n_tok = sum(len(r.tokens) for r in done)
    _check(len(done) == 16 and all(r.done for r in done),
           f"chunked: {len(done)} of 16 requests finished")
    _check(all(0 <= x < cfg.vocab for r in done for x in r.tokens),
           "chunked: a token outside the vocabulary")
    _check(all(len(r.tokens) == r.max_new for r in done),
           "chunked: a request stopped short of max_new")
    _check(eng.releases == 16, f"chunked: {eng.releases} releases, not 16")
    _check(bool((st.leaf_table == INVALID).all())
           and bool((st.slot_owner == INVALID).all()),
           "chunked: released metadata is not back to identity")
    _check(fair["interactive"]["finished"] == 8
           and fair["batch"]["finished"] == 8,
           f"chunked: finished per tenant {fair}")
    _check(fair["interactive"]["admitted_fast_pages"] > 0,
           "chunked: no page admitted straight to the fast pool")
    _check(c["migrations"] > 0, "chunked: no migration")
    for k, n in launches.items():
        _check(n > 0, f"chunked: {k} never launched")
    _check(launches["flash_attention"]
           == (len(spent.get("chunk forward", []))
               + len(spent.get("one-shot prefill", []))) * cfg.n_layers,
           f"chunked: flash_attention launches {launches['flash_attention']}"
           f" != chunks x layers")
    _check(launches["remap_replay"] == launches["remap_gather"] == copies,
           f"chunked: copy-engine launches {launches} != one replay per "
           f"maintenance pass and admission ({copies})")
    print(f"chunked: {len(done)} requests, {n_tok} tokens, {eng.steps} "
          f"engine steps in {wall:.2f} s: {n_tok / wall:.1f} tokens/s end to "
          f"end; {eng.releases} releases, released metadata back to "
          f"identity")
    for t in ("interactive", "batch"):
        b = stats["tenants"][t]
        print(f"chunked: tenant {t}: TTFT p50 {b['ttft_ms']['p50']:.1f} ms, "
              f"max {b['ttft_ms']['max']:.1f} ms; latency p50 "
              f"{b['latency_ms']['p50']:.1f} ms, max "
              f"{b['latency_ms']['max']:.1f} ms; queue wait p50 "
              f"{b['queue_wait_ms']['p50']:.1f} ms; books "
              f"{json.dumps(fair[t])}")
    parts = [f"{k} {len(v)} x {sum(v) / len(v):.2f} ms = {sum(v) / 1e3:.2f} s"
             for k, v in spent.items()]
    rest = wall - sum(sum(v) for v in spent.values()) / 1e3
    print(f"chunked: time by phase (host clock, synchronised calls): "
          f"{'; '.join(parts)}; rest of the loop {rest:.2f} s")
    totals = {k: v for k, v in c.items() if not k.startswith("epoch_")}
    print(f"chunked: launches {json.dumps(launches)}; counters "
          f"{json.dumps(totals)}; peak device memory {peak / 2**30:.2f} GiB "
          f"(torch.cuda.max_memory_allocated)")
    del eng
    torch.cuda.empty_cache()
    return {"flash_attention": launches["flash_attention"]}


# ---------------------------------------------------------------------------
# phase 8: chunked == one-shot prefill at full width
# ---------------------------------------------------------------------------

def chunk_equivalence_phase(torch, dev, cfg, params):
    """One 1500-token prompt (padded to 2048) through the one-shot
    ``forward(collect_cache=True)`` and through ``forward_chunk`` in
    256-token chunks as the scheduler runs them: every layer's K/V rows
    below 1500 and the final chunk's last-row logits, bit for bit; if
    not, within the bf16 limit (two bf16 ulps of each one-shot value; the
    logits against the same limit on the one-shot logits), the gap
    printed."""
    import numpy as np

    from repro_torch.kernels.paged_attention.ref import bf16_tolerance
    from repro_torch.models import forward, forward_chunk, init_chunk_buffers

    n, P, C = 1500, 2048, 256
    tokens = np.zeros((1, P), np.int64)
    tokens[0, :n] = np.random.default_rng(8).integers(0, cfg.vocab, n)
    t = torch.as_tensor(tokens, device=dev)
    with torch.inference_mode():
        logits, _, (k_ref, v_ref) = forward(cfg, params, {"tokens": t},
                                            collect_cache=True)
        last_ref = logits[0, n - 1].clone()
        del logits
        bk, bv = init_chunk_buffers(cfg, P, device=dev)
        for start in range(0, n, C):
            start = min(start, P - C)
            final = start + C >= n
            out = forward_chunk(cfg, params, t[:, start:start + C], bk, bv,
                                start, return_logits=final)
            if final:
                last = out[2][0, n - 1 - start]
    pairs = (("K", k_ref[:, 0, :n], bk[:, 0, :n]),
             ("V", v_ref[:, 0, :n], bv[:, 0, :n]),
             ("last-row logits", last_ref, last))
    same = all(torch.equal(a, b) for _, a, b in pairs)
    if same:
        print(f"chunked-vs-one-shot: {n}-token prompt, {P} padded, "
              f"{-(-n // C)} chunks of {C}, {cfg.n_layers} layers: K, V and "
              f"the last-row logits equal bit for bit")
    else:
        worst = 0.0
        for name, a, b in pairs:
            diff = (a.float() - b.float()).abs()
            ratio = (diff / bf16_tolerance(a.float())).max().item()
            worst = max(worst, ratio)
            layers = [i for i in range(a.shape[0]) if not torch.equal(
                a[i], b[i])] if name != "last-row logits" else []
            print(f"chunked-vs-one-shot: {name}: max |delta| "
                  f"{diff.max().item():.3e}, error/limit {ratio:.3f}, "
                  f"{int((diff > 0).sum())} of {diff.numel()} values differ"
                  + (f"; first differing layer {layers[0]}" if layers
                     else ""))
        _check(worst <= 1.0, f"chunked vs one-shot at {worst:.3f} of the "
               f"bf16 limit")
        print(f"chunked-vs-one-shot: not bit for bit; within the bf16 limit "
              f"(worst error/limit {worst:.3f})")
    del k_ref, v_ref, bk, bv
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 9: the served path with telemetry on, at full width
# ---------------------------------------------------------------------------

TELEMETRY_REQUESTS = 8
# every policy preset keeps demote_threshold 0, and a live lane touches
# each of its live pages every step, so no preset demotes in serving; at
# this threshold write_aware demotes at the main path's geometry
TELEMETRY_POLICY = dict(demote_threshold=32)
# the profiled loop iterations (first, count): one maintenance plan, one
# apply and one sample fall in every 4 iterations
TELEMETRY_WINDOW = (40, 8)
# the Prometheus families a served, flight-recorded run must export
PROM_FAMILIES = (
    "trimma_translated_pages_total", "trimma_irc_hits_total",
    "trimma_irc_misses_total", "trimma_irt_walks_total",
    "trimma_dev_table_hits_total", "trimma_migrations_total",
    "trimma_demotions_total", "trimma_promoted_bytes_total",
    "trimma_demoted_bytes_total", "trimma_fast_resident_pages",
    "trimma_metadata_pages", "trimma_metadata_bytes",
    "trimma_identity_entry_ratio", "trimma_irt_leaf_occupancy",
    "trimma_flight_events_total", "trimma_flight_kind_events_total",
    "trimma_flight_pingpong_total", "engine_steps_total",
    "engine_tokens_total", "engine_finished_requests_total",
    "engine_releases_total", "engine_request_latency_ms",
    "engine_token_latency_ms", "engine_slo_burn_rate")


def flight_identity(counters, by_kind, n_layers, page_bytes) -> dict:
    """What the counters imply for the flight ring's kinds when every
    pass is recorded (the counters sum over layers, one event stands for
    its move on every layer): promotes + installs = migrations, demotes =
    demotions, evicts = copy-backs (demoted bytes / page bytes) that were
    not demotions.  Returns {name: (from the ring, from the counters)}."""
    L = n_layers
    copy_backs = counters["demo_bytes"] // page_bytes
    return {"promote+install": (by_kind["promote"] + by_kind["install"],
                                counters["migrations"] // L),
            "demote": (by_kind["demote"], counters["demotions"] // L),
            "evict": (by_kind["evict"],
                      (copy_backs - counters["demotions"]) // L)}


def _telemetry_run(torch, dev, cfg, params, tmp, telemetry: bool):
    """Phase 4's engine and first requests under a demoting write_aware
    policy, telemetry off or on; the host waits counted (sync debug mode
    "warn", the main thread's), maintenance timed per pass (host clock:
    the plan, and the flush that applies it and reads its counters), the
    kernel launches of a window of loop iterations counted by
    ``torch.profiler`` (whose time the caller leaves out) and, with
    telemetry on, the host time spent inside the telemetry calls."""
    import threading
    import urllib.request
    import warnings

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.policy import get_policy
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.remap_gather import ops as rg_ops
    from repro_torch.models.kv_backend import TieredBackend
    from repro_torch.obs import FlightConfig, ObsConfig, parse_slos
    from repro_torch.serve import engine as eng_mod
    from repro_torch.serve.engine import Engine, EngineConfig, Request

    tel = {}
    if telemetry:
        tel = dict(obs=ObsConfig(sample_every=4,
                                 prom_path=str(tmp / "metrics.prom"),
                                 jsonl_path=str(tmp / "metrics.jsonl"),
                                 trace_path=str(tmp / "trace.json"),
                                 http_port=0),
                   flight=FlightConfig(capacity=4096),
                   slos=parse_slos("*:latency:60000:0.9:64"))
    ec = EngineConfig(**MAIN_EC, **tel)
    backend = TieredBackend(
        cfg, ec.batch, ec.max_len, page_tokens=ec.page_tokens,
        fast_data_slots=ec.fast_data_slots,
        policy=get_policy("write_aware", **TELEMETRY_POLICY), device=dev)
    eng = Engine(cfg, params, ec, backend=backend, device=dev)
    for i, (prompt, max_new) in enumerate(
            main_requests(cfg)[:TELEMETRY_REQUESTS]):
        eng.submit(Request(rid=i, prompt=prompt, max_new=max_new))

    # waits count outside the profiled window; window_s and
    # window_tokens hold its start until it closes
    book = {"plan_ms": [], "apply_ms": [], "prefills": 0, "waits": 0,
            "steps": 0, "counting": True, "window_s": 0.0,
            "window_tokens": 0, "fetched": {},
            "host_ms": {"sample": 0.0, "record": 0.0, "export": 0.0}}
    first, count = TELEMETRY_WINDOW
    real_step = eng_mod.decode_step
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def step(*a, **kw):
        i = book["steps"]
        if i == first:
            book["counting"] = False
            book["window_s"] = time.perf_counter()
            book["window_tokens"] = eng._tokens_out
            prof.start()
        elif i == first + count:
            prof.stop()
            book["window_s"] = time.perf_counter() - book["window_s"]
            book["window_tokens"] = eng._tokens_out - book["window_tokens"]
            book["counting"] = True
        book["steps"] += 1
        return real_step(*a, **kw)

    plan, flush, prefill = (backend.plan_maintain, eng._flush_maintain,
                            eng.prefill_lane)

    def timed_plan(*a, **kw):
        s = time.perf_counter()
        out = plan(*a, **kw)
        book["plan_ms"].append((time.perf_counter() - s) * 1e3)
        return out

    def timed_flush(state, **kw):
        if eng._pending_plan is None:
            return flush(state, **kw)
        s = time.perf_counter()
        out = flush(state, **kw)
        book["apply_ms"].append((time.perf_counter() - s) * 1e3)
        return out

    def counted_prefill(*a, **kw):
        book["prefills"] += 1
        return prefill(*a, **kw)

    def host_timed(key, fn):
        def call(*a, **kw):
            s = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                book["host_ms"][key] += (time.perf_counter() - s) * 1e3
        return call

    backend.plan_maintain = timed_plan
    eng._flush_maintain = timed_flush
    eng.prefill_lane = counted_prefill
    if telemetry:   # the export at the end holds the last sample
        eng._sample = host_timed("sample", eng._sample)
        eng._record = host_timed("record", eng._record)
        eng._finalize_obs = host_timed("export", eng._finalize_obs)
    main_thread = threading.get_ident()

    def on_warning(message, category, filename, lineno, file=None,
                   line=None):
        if book["counting"] and threading.get_ident() == main_thread \
                and "synchroniz" in str(message):
            book["waits"] += 1

    fetched = book["fetched"]

    def fetch():
        while eng.steps < 24 and not fetched.get("stop"):
            time.sleep(0.005)
        fetched["at_step"] = eng.steps
        for route in ("/metrics", "/healthz", "/debug/state"):
            with urllib.request.urlopen(eng.obs_server.url + route,
                                        timeout=60) as r:
                fetched[route] = (r.status, r.read())

    fetcher = None
    if eng.obs_server is not None:
        fetcher = threading.Thread(target=fetch, name="phase9-scrape",
                                   daemon=True)
        fetcher.start()
    torch.cuda.synchronize()
    pa_ops.launches = fa_ops.launches = 0
    rg_ops.launches = rg_ops.replay_launches = 0
    eng_mod.decode_step = step
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = on_warning
            torch.cuda.set_sync_debug_mode("warn")
            try:
                t0 = time.perf_counter()
                done = eng.run()
                torch.cuda.synchronize()
                book["wall"] = time.perf_counter() - t0
            finally:
                torch.cuda.set_sync_debug_mode("default")
    finally:
        eng_mod.decode_step = real_step
        fetched["stop"] = True
        if fetcher is not None:
            fetcher.join(timeout=120)
        if eng.obs_server is not None:
            eng.obs_server.close()
    launches = {"paged_attention_fused": pa_ops.launches,
                "flash_attention": fa_ops.launches,
                "remap_gather": rg_ops.launches,
                "remap_replay": rg_ops.replay_launches}
    name = "on" if telemetry else "off"
    book["launches"] = sum(e.count for e in prof.key_averages()
                           if "LaunchKernel" in e.key) / count
    _check(book["window_s"] > 0 and book["counting"]
           and book["launches"] > 0,
           f"telemetry {name}: the profiled window did not close or "
           f"counted no launch")
    passes = len(book["apply_ms"])
    _check(len(done) == TELEMETRY_REQUESTS and all(
        len(r.tokens) == r.max_new for r in done),
        f"telemetry {name}: a request did not finish")
    _check(launches["paged_attention_fused"] == eng.steps * cfg.n_layers,
           f"telemetry {name}: paged_attention_fused launches {launches} != "
           f"steps {eng.steps} x {cfg.n_layers}")
    _check(launches["flash_attention"] == book["prefills"] * cfg.n_layers,
           f"telemetry {name}: flash_attention launches {launches} != "
           f"prefills x layers")
    _check(passes > 0 and launches["remap_replay"] == passes
           == launches["remap_gather"],
           f"telemetry {name}: copy-engine launches {launches} != one "
           f"replay per maintenance pass ({passes})")
    if fetcher is not None:
        _check(not fetcher.is_alive(), "telemetry: the scrape never ended")
    return eng, done, book


def telemetry_phase(torch, dev, cfg, params):
    """Phase 4's weights and first 8 requests served twice through the
    tiered engine under a demoting write_aware policy, telemetry off, then
    on: hub samples every 4 steps with Prometheus, JSONL and trace files,
    a 4096-event flight ring, one SLO and the live endpoints scraped once
    mid-run from a thread.  Gates: equal tokens and counters, demotions
    counted and recorded, the ring's kinds equal to what the counters
    imply, the exposition parsing back with every family, the trace
    holding the decode and maintenance spans, the three endpoints
    answering 200 mid-run."""
    import tempfile

    from repro_torch.obs import parse_prometheus

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="phase9_") as d:
        tmp = Path(d)
        off, off_done, off_book = _telemetry_run(torch, dev, cfg, params,
                                                 tmp, False)
        torch.cuda.empty_cache()
        eng, done, book = _telemetry_run(torch, dev, cfg, params, tmp, True)
        prom = parse_prometheus((tmp / "metrics.prom").read_text())
        spans = {e["name"] for e in json.loads(
            (tmp / "trace.json").read_text())["traceEvents"]
            if e["ph"] == "X"}
        n_rows = len((tmp / "metrics.jsonl").read_text().splitlines())
    _check({"decode_step", "maintain", "prefill", "release"} <= spans,
           f"telemetry: trace spans {sorted(spans)}")
    _check({r.rid: r.tokens for r in done}
           == {r.rid: r.tokens for r in off_done},
           "telemetry: tokens differ between off and on")
    _check(eng.counters == off.counters,
           "telemetry: counters differ between off and on")
    fetched = book["fetched"]
    codes = {k: v[0] for k, v in fetched.items() if k.startswith("/")}
    _check(codes == {"/metrics": 200, "/healthz": 200, "/debug/state": 200},
           f"telemetry: endpoints answered {codes}")
    _check(fetched["at_step"] < eng.steps,
           "telemetry: the endpoints were not scraped mid-run")
    parse_prometheus(fetched["/metrics"][1].decode())
    json.loads(fetched["/debug/state"][1])
    c = eng.counters
    fs = eng.flight_stats()
    _check(c["demotions"] > 0 and fs["by_kind"]["demote"] > 0,
           f"telemetry: no demotion (counters {c['demotions']}, flight "
           f"{fs['by_kind']})")
    ident = flight_identity(c, fs["by_kind"], cfg.n_layers,
                            eng.backend.tcfg.page_bytes)
    _check(all(a == b for a, b in ident.values()),
           f"telemetry: flight kinds differ from the counters {ident}")
    missing = [f for f in PROM_FAMILIES if f not in prom["families"]]
    _check(not missing, f"telemetry: exposition lacks {missing}")
    _check(prom["samples"]["engine_steps_total"] == eng.steps,
           "telemetry: engine_steps_total differs from the run's steps")
    parts = []
    for name, (e, dn, bk) in (("off", (off, off_done, off_book)),
                              ("on", (eng, done, book))):
        steps = e.steps - TELEMETRY_WINDOW[1]
        rest = bk["wall"] - bk["window_s"]
        tokens = sum(len(r.tokens) for r in dn) - bk["window_tokens"]
        maint = sum(bk["plan_ms"] + bk["apply_ms"])
        parts.append(
            f"{name}: {tokens / rest:.1f} tokens/s, "
            f"{1e3 * rest / steps:.2f} ms per engine step, "
            f"{bk['launches']:.1f} launches per step, "
            f"{bk['waits'] / steps:.3f} host waits per step, maintenance "
            f"{maint / len(bk['apply_ms']):.2f} ms per pass")
    host = book["host_ms"]
    print(f"telemetry: {TELEMETRY_REQUESTS} requests, write_aware with "
          f"demote_threshold {TELEMETRY_POLICY['demote_threshold']}, "
          f"{eng.steps} engine steps and {len(book['apply_ms'])} "
          f"maintenance passes a run, tokens and counters equal off and "
          f"on; {'; '.join(parts)} (each run counts the launches of a "
          f"profiled window of {TELEMETRY_WINDOW[1]} loop iterations and "
          f"leaves it out of its other numbers; host waits: sync debug "
          f"mode 'warn'); host ms inside the telemetry calls of the on "
          f"run: samples {host['sample']:.2f}, flight records "
          f"{host['record']:.2f}, export at the end {host['export']:.2f}, "
          f"of {1e3 * book['wall']:.1f} ms; card {_card_line()}")
    print(f"telemetry: flight {fs['total_events']} events, "
          f"{fs['dropped']} dropped, by kind {json.dumps(fs['by_kind'])}, "
          f"ping-pong {fs['pingpong']['events']} re-promotions within "
          f"{fs['pingpong']['window_steps']} steps; the counters imply "
          f"{json.dumps({k: b for k, (_, b) in ident.items()})}; "
          f"demotions {c['demotions']} over {cfg.n_layers} layers")
    series = [r["metrics"] for r in eng.hub.series]
    peak = max(series, key=lambda m: m["trimma_metadata_pages"])
    final = prom["samples"]
    print(f"telemetry: trimma_metadata_pages {final['trimma_metadata_pages']:g}"
          f" and trimma_identity_entry_ratio "
          f"{final['trimma_identity_entry_ratio']:.6f} at the end (every "
          f"lane released), {peak['trimma_metadata_pages']:g} and "
          f"{peak['trimma_identity_entry_ratio']:.6f} at the largest "
          f"footprint sampled; {len(prom['families'])} families, {n_rows} "
          f"JSONL rows; endpoints 200 at step {fetched['at_step']}; phase 9 "
          f"took {time.perf_counter() - t0:.1f} s")
    del eng, off, done, off_done
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 10: the paper-evaluation simulator
# ---------------------------------------------------------------------------

SIM_GOLDEN = ROOT / "tests" / "golden" / "sim_counters.json"
SIM_FIG7 = ROOT / "tests" / "golden" / "sim_fig7_counters.json"
# the recipe of tests/golden/gen_golden.py
SIM_SMALL = dict(fast_total_blocks=512, ratio=8, n_sets=4)
# phase 10(b): kernel against the plain loop, T = 4 traces
SIM_CHECK_GEOM = dict(fast_total_blocks=256, ratio=8, n_sets=4)
SIM_CHECK_LEN = 256
SIM_CHECK_WLS = ("pr", "xz", "lbm", "ycsb_a")
# the kernels line's call: the first accesses of Trimma-C's sweep, kernel
# and plain loop over the same range of the same full-size inputs
SIM_ROW_SCHEME, SIM_ROW_LEN = "trimma_c", 512
# each scheme's warm run_many wall ms of the sweep before the kernel's
# redesign (PERF.md, NVIDIA H100 80GB HBM3, 700 W); printed beside this
# run's
SIM_SWEEP_EARLIER_MS = {"trimma_c": 100.4, "linear_c": 73.9,
                        "trimma_f": 71.2, "mempod": 63.9, "ideal_c": 41.7,
                        "ideal_f": 31.7, "alloy": 24.2, "lohhill": 24.0}


def _sim_golden_configs(P):
    s = SIM_SMALL
    return {"trimma_c": P.trimma_cache(**s), "trimma_f": P.trimma_flat(**s),
            "linear_c": P.linear_cache(**s), "mempod": P.mempod(**s),
            "alloy": P.alloy(**{**s, "n_sets": 1}),
            "lohhill": P.lohhill(**{**s, "n_sets": 1}),
            "ideal_c": P.ideal("cache", **s)}


def _sim_check_cases(P):
    """(label, SimConfig): every table scheme and remap-cache kind at its
    default policy, every PRESETS policy at 32-access epochs on Trimma-C
    and Trimma-F, dealloc hints on both, and the tag-matching entry
    (Alloy, Loh-Hill, 64 ways)."""
    g = SIM_CHECK_GEOM
    table = {"trimma_c": ("cache", "irt", "irc"),
             "trimma_f": ("flat", "irt", "irc"),
             "linear_c": ("cache", "linear", "conventional"),
             "mempod": ("flat", "linear", "conventional"),
             "irt_c_none": ("cache", "irt", "none"),
             "ideal_c": ("cache", "ideal", "ideal"),
             "ideal_f": ("flat", "ideal", "ideal")}

    def mk(name, **kw):
        m, me, rc = table[name]
        return P.SimConfig(**g, mode=m, meta=me, remap_cache=rc,
                           **kw).validate()
    cases = [(name, mk(name)) for name in table]
    for preset in sorted(P.PRESETS):
        for name in ("trimma_c", "trimma_f"):
            cases.append((f"{name}/{preset}", mk(
                name, policy=P.get_policy(preset, decay_shift=5))))
    for name in ("trimma_c", "trimma_f"):
        cases.append((f"{name}/dealloc", mk(
            name, dealloc_hints=True,
            policy=P.get_policy("mea", decay_shift=5))))
    for meta, ways in (("alloy", 0), ("lohhill", 0), ("lohhill", 64)):
        cases.append((f"{meta}/{ways}", P.SimConfig(
            **{**g, "n_sets": 1}, mode="cache", meta=meta,
            remap_cache="none", tag_ways=ways).validate()))
    return cases


def _sim_traces(P, cfg, wls, length, seed, dealloc=False):
    bs, ws = [], []
    for wl in wls:
        b, w = P.generate_trace(P.WORKLOADS[wl], cfg.slow_blocks, length,
                                seed)
        bs.append(P.relabel_first_touch(b) if cfg.mode == "flat" else b)
        ws.append(w)
    d = [P.with_deallocs(b, 0.05, seed=i) if dealloc
         else [False] * length for i, b in enumerate(bs)]
    return bs, ws, d


def _sim_pair(torch, cfg, b, w, d, start=0, end=None):
    """One kernel launch and the plain loop over the same fresh state and
    range: (the kernel's end state, the keys where the two differ,
    kernel ms, plain ms), times on the host clock around synchronised
    calls."""
    from repro_torch.core import HBM3_DDR5
    from repro_torch.core import simulator as sim
    from repro_torch.kernels.sim_scan import ops as ss_ops
    from repro_torch.kernels.sim_scan.ref import sim_scan_ref
    g = None if cfg.meta in ("alloy", "lohhill") else sim.make_geometry(cfg)
    kern = sim.init_state(cfg, g, b.shape[0], b.device)
    plain = {k: v.clone() for k, v in kern.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ss_ops.sim_scan_op(cfg, HBM3_DDR5, kern, b, w, d, start, end)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    sim_scan_ref(cfg, HBM3_DDR5, plain, b, w, d, start, end)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    bad = [k for k in plain if not torch.equal(kern[k], plain[k])]
    return kern, bad, 1e3 * (t1 - t0), 1e3 * (t2 - t1)


def _sim_row_bytes(np, before: dict, after: dict, blocks, n_phys: int):
    """Bytes a range of accesses must move, on this range's data: the
    range's trace (block, write and dealloc flags) read once; the small
    per-trace state (every array not n_phys long) read and written once;
    of the n_phys-long arrays, the 128 B line of the remap table around
    every block the range touches (a cold remap cache walks each line at
    least once and the IdCache fill reads all of it), the 32 B sector of
    each tracker entry the range touches, read once, and the 32 B sector
    of every entry that changed, written once.  Returns (bytes, the
    parts as text)."""
    T, n = blocks.shape
    trace = T * n * (4 + 1 + 1)
    small = sum(2 * v.nbytes for k, v in after.items()
                if v.shape[-1:] != (n_phys,))
    big = [k for k, v in after.items() if v.shape[-1:] == (n_phys,)]
    lines = sum(len(np.unique(blocks[t] // 32)) for t in range(T)) * 128
    trackers = (len(big) - 1) * sum(len(np.unique(blocks[t] // 8))
                                    for t in range(T)) * 32
    written = sum(len(np.unique(np.nonzero(after[k][t] != before[k][t])[0]
                                // 8)) * 32
                  for k in big for t in range(T))
    parts = (f"trace {trace}, small state in and out {small}, remap lines "
             f"{lines}, tracker sectors {trackers}, changed sectors "
             f"{written}")
    return trace + small + lines + trackers + written, parts


def _geomean(xs):
    return math.exp(sum(math.log(x) for x in xs) / len(xs))


def sim_phase(torch, dev):
    """(a) the golden counters through the kernel; (b) kernel against the
    plain loop on the card, every scheme, preset and entry, counters and
    the whole end state exact; (c) the paper's Figure 7 sweep at full
    size, one run_many launch per scheme, counters exact against the JAX
    reference's JSON, timed cold and warm, with the headline ratios; (d)
    the plain loop's time per access beside the kernel's.  Returns the
    kernels line's row and the sweep's launch count."""
    import numpy as np

    from repro_torch import core as P
    from repro_torch.core import simulator as sim
    from repro_torch.kernels.sim_scan import ops as ss_ops

    t_phase = time.perf_counter()
    # (a) golden: SMALL geometry, pr, 4096 accesses, seed 0
    want = json.loads(SIM_GOLDEN.read_text())
    for name, cfg in _sim_golden_configs(P).items():
        blocks, writes = P.generate_trace(P.WORKLOADS["pr"],
                                          cfg.slow_blocks, 4096, 0)
        if cfg.mode == "flat":
            blocks = P.relabel_first_touch(blocks)
        out = P.run(cfg, P.HBM3_DDR5, blocks, writes, device=dev)
        got = {k: int(out[k]) for k in want[name]}
        _check(got == want[name], f"sim: golden {name} differs: "
               f"{ {k: (v, got[k]) for k, v in want[name].items() if got[k] != v} }")
    print(f"sim (a): the kernel reproduces tests/golden/sim_counters.json "
          f"exactly for {len(want)} schemes (4096 accesses each)")

    # (b) kernel against the plain loop on the card
    k_ms = p_ms = 0.0
    n_acc = 0
    cases = _sim_check_cases(P)
    for label, cfg in cases:
        bs, ws, ds = _sim_traces(P, cfg, SIM_CHECK_WLS, SIM_CHECK_LEN, 1,
                                 dealloc=cfg.dealloc_hints)
        b = torch.as_tensor(np.stack(bs).astype(np.int32), device=dev)
        w = torch.as_tensor(np.stack(ws), device=dev)
        d = torch.as_tensor(np.stack(ds), device=dev)
        kern, bad, km, pm = _sim_pair(torch, cfg, b, w, d)
        _check(not bad, f"sim (b): {label}: kernel differs from the plain "
               f"loop in {bad}")
        _check(int(kern["counters"][:, 0].sum()) > 0, f"sim (b): {label}: "
               "no access counted")
        k_ms, p_ms, n_acc = k_ms + km, p_ms + pm, n_acc + SIM_CHECK_LEN
    print(f"sim (b): kernel == plain loop on the card, counters and every "
          f"key of the end state, {len(cases)} cases (every table scheme "
          f"and remap-cache kind, {len(P.PRESETS)} presets x cache/flat at "
          f"32-access epochs, dealloc hints, Alloy / Loh-Hill / 64 ways), "
          f"{len(SIM_CHECK_WLS)} traces x {SIM_CHECK_LEN} accesses each")

    # (c) the Figure 7 sweep at the paper's size
    data = json.loads(SIM_FIG7.read_text())
    wls, L = data["workloads"], data["trace_len"]
    tm = P.TIMINGS[data["timing"]]
    cfgs = {n: P.SimConfig(**kw).validate()
            for n, kw in data["configs"].items()}
    t0 = time.perf_counter()
    n_phys = next(iter(cfgs.values())).slow_blocks
    traces = {}
    for wl in wls:
        b, w = P.generate_trace(P.WORKLOADS[wl], n_phys, L, data["seed"])
        traces[wl] = (b, P.relabel_first_touch(b), w)
    gen_s = time.perf_counter() - t0
    stack = {flat: (np.stack([traces[wl][1 if flat else 0] for wl in wls]),
                    np.stack([traces[wl][2] for wl in wls]))
             for flat in (False, True)}
    ss_ops.launches = 0                      # the main path's run
    results, wall = {}, {}
    for name, cfg in cfgs.items():
        blocks, writes = stack[cfg.mode == "flat"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = P.run_many(cfg, tm, blocks, writes, device=dev)
        wall[name] = [1e3 * (time.perf_counter() - t0)]
        results[name] = outs
        for wl, o in zip(wls, outs):
            got = {k: int(o[k]) for k in data["counters"][name][wl]}
            _check(got == data["counters"][name][wl],
                   f"sim (c): {name} {wl} differs from the JAX reference")
    launches = ss_ops.launches
    _check(launches == len(cfgs), f"sim (c): {launches} sim_scan launches "
           f"for {len(cfgs)} run_many calls")
    for name, cfg in cfgs.items():            # warm: the same calls again
        blocks, writes = stack[cfg.mode == "flat"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        P.run_many(cfg, tm, blocks, writes, device=dev)
        wall[name].append(1e3 * (time.perf_counter() - t0))
    n_sweep = len(wls) * L
    print(f"sim (c): Figure 7 sweep at the paper's size: {len(wls)} "
          f"workloads x {L} accesses, seed {data['seed']}, "
          f"{data['timing']}, fast_total_blocks "
          f"{cfgs['trimma_c'].fast_total_blocks}, {cfgs['trimma_c'].ratio}:1; "
          f"counters and metadata_blocks equal the JAX reference "
          f"(tests/golden/sim_fig7_counters.json) for all {len(cfgs)} "
          f"schemes; {launches} sim_scan launches for {len(cfgs)} run_many "
          f"calls; traces generated in {gen_s:.2f} s")
    for name in cfgs:
        cold, warm = wall[name]
        was = SIM_SWEEP_EARLIER_MS[name]
        print(f"sim (c): {name}: run_many wall {cold:.1f} ms cold, "
              f"{warm:.1f} ms warm; {1e6 * cold / n_sweep:.1f} / "
              f"{1e6 * warm / n_sweep:.1f} ns per access; warm against "
              f"{was} ms before the redesign (PERF.md constant, "
              f"{was / warm:.2f}x)")
    tot_c = sum(v[0] for v in wall.values())
    tot_w = sum(v[1] for v in wall.values())
    was = sum(SIM_SWEEP_EARLIER_MS.values())
    print(f"sim (c): all {len(cfgs)} schemes {tot_c:.1f} ms cold, "
          f"{tot_w:.1f} ms warm; {1e6 * tot_w / (n_sweep * len(cfgs)):.1f} "
          f"ns per access warm; warm against {was:.1f} ms before the "
          f"redesign ({was / tot_w:.2f}x); card {_card_line()}")
    r = results
    alloy_c = _geomean([a["t_total"] / t["t_total"]
                        for a, t in zip(r["alloy"], r["trimma_c"])])
    mempod_f = _geomean([m["t_total"] / f["t_total"]
                         for m, f in zip(r["mempod"], r["trimma_f"])])
    saving = sum(1 - f["metadata_blocks"] / m["metadata_blocks"]
                 for m, f in zip(r["mempod"], r["trimma_f"])) / len(wls)
    print(f"sim (c): headline ({data['timing']}, geomean over {len(wls)} "
          f"workloads): Alloy / Trimma-C t_total {alloy_c:.3f}x (paper avg "
          f"1.33x), MemPod / Trimma-F {mempod_f:.3f}x (paper avg 1.32x, "
          f"on DDR5+NVM), Trimma-F's metadata saving against MemPod "
          f"{100 * saving:.1f} % (mean; paper avg 43 %)")

    # the kernels line's call: Trimma-C's first SIM_ROW_LEN accesses of
    # the sweep, full-size state, kernel and plain loop on the same range
    cfg = cfgs[SIM_ROW_SCHEME]
    blocks, writes = stack[False]
    b = torch.as_tensor(blocks.astype(np.int32), device=dev)
    w = torch.as_tensor(writes, device=dev)
    d = torch.zeros_like(w)
    g = sim.make_geometry(cfg)
    state = sim.init_state(cfg, g, b.shape[0], dev)
    fresh = {k: v.clone() for k, v in state.items()}

    def reset():
        for k, v in fresh.items():
            state[k].copy_(v)

    saved = ss_ops.launches
    ms = _time_ms(lambda: ss_ops.sim_scan_op(cfg, tm, state, b, w, d, 0,
                                             SIM_ROW_LEN),
                  reps=5, warmup=1, setup=reset)
    kern, bad, _, plain_ms = _sim_pair(torch, cfg, b, w, d, 0, SIM_ROW_LEN)
    ss_ops.launches = saved
    _check(not bad, f"sim: the row's call differs from the plain loop in "
           f"{bad}")
    nbytes, parts = _sim_row_bytes(
        np, {k: v.cpu().numpy() for k, v in fresh.items()},
        {k: v.cpu().numpy() for k, v in kern.items()},
        blocks[:, :SIM_ROW_LEN], cfg.n_phys)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    # the chain: every access reads a word the access before it wrote, so
    # a trace's accesses take at least one dependent shared-memory load
    # each, one after another (the traces run side by side)
    t_smem = ss_ops.sim_scan_chase_op("smem", dev)
    t_l2 = ss_ops.sim_scan_chase_op("l2", dev)
    chain_ms = SIM_ROW_LEN * t_smem["ns"] * 1e-6
    l2_trips = 1e6 * ms / SIM_ROW_LEN / t_l2["ns"]
    bound_ms = max(chain_ms, bytes_ms)
    bound_by = "operations" if chain_ms >= bytes_ms else "bytes"
    print(f"sim (d): the chain's yardstick (sim_scan_chase, this call): one "
          f"dependent shared-memory load {t_smem['ns']:.2f} ns "
          f"({t_smem['cycles']:.1f} SM cycles), one dependent load through "
          f"L2 over a 256 KB row {t_l2['ns']:.2f} ns ({t_l2['cycles']:.1f} "
          f"cycles); the row's chain bound {SIM_ROW_LEN} x "
          f"{t_smem['ns']:.2f} ns = {chain_ms:.6f} ms beside its bytes bound "
          f"{bytes_ms:.6f} ms: bound {bound_ms:.6f} ms by the "
          f"{'chain' if bound_by == 'operations' else 'bytes'}; the kernel "
          f"{ms / chain_ms:.1f}x the chain, {l2_trips:.2f} L2 round "
          f"trips' time an access step")
    acc = b.shape[0] * SIM_ROW_LEN
    print(f"sim (d): plain loop on the card {p_ms / n_acc:.3f} ms per "
          f"access step ({len(SIM_CHECK_WLS)} traces at once; kernel "
          f"{p_ms / k_ms:.0f}x faster: {1e3 * k_ms / n_acc:.3f} us per step, "
          f"host clock, launch included) over "
          f"phase (b)'s {len(cases)} cases; the row's call ({SIM_ROW_SCHEME}, "
          f"{b.shape[0]} traces x accesses [0, {SIM_ROW_LEN}) at full size): "
          f"kernel {ms:.4f} ms (CUDA events, state reset outside the "
          f"window), plain {plain_ms:.1f} ms, {plain_ms / ms:.0f}x; "
          f"{1e6 * ms / SIM_ROW_LEN:.0f} ns per access step, "
          f"{1e6 * ms / acc:.1f} ns per access; bytes bound "
          f"{bytes_ms:.6f} ms, {nbytes} B this range needs ({parts}); "
          f"{_vs_bound('sim_scan', ms, bound_ms, nbytes=nbytes)}; phase 10 "
          f"took {time.perf_counter() - t_phase:.1f} s")
    row = dict(name="sim_scan", route="cuda",
               source="src/repro_torch/kernels/sim_scan/csrc/sim_scan.cu",
               replaces="src/repro/core/simulator.py:442 (jax.lax.scan; "
                        "no Pallas kernel)",
               max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by=bound_by, library_ms=None, chain_bound_ms=chain_ms,
               bytes_bound_ms=bytes_ms, t_smem_ns=t_smem["ns"],
               t_l2_ns=t_l2["ns"])
    return row, launches


# ---------------------------------------------------------------------------
# phase 11: the other families at full width
# ---------------------------------------------------------------------------

FAMILY_REQUESTS = 8
FAMILY_ARCHS = ("qwen2-7b", "granite-moe-3b-a800m")
# decode steps profiled for their kernel launches (first, count); their
# time and tokens are left out of the run's other numbers
FAMILY_PROFILED = (24, 4)
MIXTRAL_PROMPT, MIXTRAL_STEPS = 4600, 16


def _count_drops(torch, moe_mod, dev):
    """Wrap ``moe.dispatch`` so that every call adds its dropped choices
    to a counter on the card (nothing waits for it).  Returns (counter,
    calls, restore)."""
    real = moe_mod.dispatch
    dropped = torch.zeros((), dtype=torch.int64, device=dev)
    calls = [0, 0]                      # dispatches, choices routed

    def counted(eidx, n_experts, cap):
        slot, keep = real(eidx, n_experts, cap)
        dropped.add_((~keep).sum())
        calls[0] += 1
        calls[1] += keep.numel()
        return slot, keep

    moe_mod.dispatch = counted
    return dropped, calls, lambda: setattr(moe_mod, "dispatch", real)


def family_serve(torch, dev, arch):
    """``arch`` at its published width and depth, seeded weights made on
    the card (random non-zero QKV biases where it has them), served by the
    tiered engine on phase 4's store (``MAIN_EC``) with phase 4's first 8
    requests.  Gates: every request finished and released, the metadata
    back to identity, one fused launch per layer and decode step, one
    flash launch per layer and prefill, one copy-engine launch per
    maintenance pass.  Prints tokens/s, ms per decode step (median, p90),
    maintenance ms per pass, the kernel launches of a decode step
    (``torch.profiler`` over ``FAMILY_PROFILED`` steps), the launches per
    kind, the device's busy time in the profiled steps (their kernels'
    device time) against the median step and, for MoE, the choices
    dropped for capacity.  Returns the launches per kind."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.core.remap.irt import INVALID
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.remap_gather import ops as rg_ops
    from repro_torch.models import init_params, moe
    from repro_torch.serve import engine as eng_mod
    from repro_torch.serve.engine import Engine, EngineConfig, Request

    cfg = get_config(arch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, dev, seed=0)
    if cfg.qkv_bias:
        _seed_biases(torch, dev, params, seed=7)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"families {arch}: L={cfg.n_layers} d={cfg.d_model} "
          f"H={cfg.n_heads}/{cfg.n_kv_heads} hd={cfg.hd} ff={cfg.d_ff} "
          f"V={cfg.vocab}"
          f"{f' E={cfg.n_experts} top-{cfg.top_k}' if cfg.n_experts else ''}"
          f"{' qkv_bias' if cfg.qkv_bias else ''} {cfg.dtype}, "
          f"{n_params / 1e9:.3f} B parameters made in "
          f"{time.perf_counter() - t0:.1f} s")
    eng = Engine(cfg, params, EngineConfig(**MAIN_EC), device=dev)
    for i, (prompt, max_new) in enumerate(
            main_requests(cfg)[:FAMILY_REQUESTS]):
        eng.submit(Request(rid=i, prompt=prompt, max_new=max_new))
    spent: dict = {}
    book = {"step": 0, "launches": [], "busy_ms": [], "window_s": 0.0,
            "window_tok": 0}
    real = eng_mod.decode_step
    first, count = FAMILY_PROFILED

    def timed(phase, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            s = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            spent.setdefault(phase, []).append(
                (time.perf_counter() - s) * 1e3)
            return out
        return run

    step_timed = timed("decode step", real)

    def step(cfg_, params_, state, tokens, **kw):
        i = book["step"]
        book["step"] += 1
        if not first <= i < first + count:
            return step_timed(cfg_, params_, state, tokens, **kw)
        torch.cuda.synchronize()
        s = time.perf_counter()
        book["window_tok"] += int((state.pos >= 0).sum())
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = real(cfg_, params_, state, tokens, **kw)
            torch.cuda.synchronize()
        book["launches"].append(sum(e.count for e in prof.key_averages()
                                    if "LaunchKernel" in e.key))
        book["busy_ms"].append(sum(
            e.time_range.elapsed_us() for e in prof.events()
            if e.device_type == DeviceType.CUDA) / 1e3)
        book["window_s"] += time.perf_counter() - s
        return out

    eng_mod.decode_step = step
    eng.prefill_lane = timed("prefill", eng.prefill_lane)
    be = eng.backend
    be.plan_maintain = timed("maintenance plan", be.plan_maintain)
    be.apply_maintain = timed("maintenance apply", be.apply_maintain)
    dropped, calls, restore = _count_drops(torch, moe, dev)
    pa_ops.launches = fa_ops.launches = 0
    rg_ops.launches = rg_ops.replay_launches = 0
    try:
        t0 = time.perf_counter()
        done = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        eng_mod.decode_step = real
        restore()
    launches = {"paged_attention_fused": pa_ops.launches,
                "flash_attention": fa_ops.launches,
                "remap_gather": rg_ops.launches,
                "remap_replay": rg_ops.replay_launches}
    passes = len(spent.get("maintenance apply", []))
    prefills = len(spent.get("prefill", []))
    st = eng.final_state.caches
    c = eng.counters
    n = FAMILY_REQUESTS
    _check(len(done) == n and all(len(r.tokens) == r.max_new for r in done),
           f"{arch}: {len(done)} of {n} requests finished to max_new")
    _check(all(0 <= x < cfg.vocab for r in done for x in r.tokens),
           f"{arch}: a token outside the vocabulary")
    _check(eng.releases == n, f"{arch}: {eng.releases} releases, not {n}")
    _check(bool((st.leaf_table == INVALID).all())
           and bool((st.slot_owner == INVALID).all()),
           f"{arch}: released metadata is not back to identity")
    _check(launches["paged_attention_fused"] == eng.steps * cfg.n_layers,
           f"{arch}: paged_attention_fused launches {launches} != steps "
           f"{eng.steps} x {cfg.n_layers}")
    _check(launches["flash_attention"] == prefills * cfg.n_layers,
           f"{arch}: flash_attention launches {launches} != prefills "
           f"{prefills} x layers")
    _check(passes > 0 and launches["remap_replay"] == passes
           == launches["remap_gather"],
           f"{arch}: copy-engine launches {launches} != one replay per "
           f"maintenance pass ({passes})")
    _check(len(book["launches"]) == count and min(book["launches"]) > 0,
           f"{arch}: the profiled steps counted no launch")
    steps = sorted(spent["decode step"])
    n_tok = sum(len(r.tokens) for r in done)
    maint = (sum(spent["maintenance plan"])
             + sum(spent["maintenance apply"])) / passes
    per_step = sum(book["launches"]) / count
    busy = sum(book["busy_ms"]) / count
    median = steps[len(steps) // 2]
    drops = ""
    if cfg.family == "moe":
        drops = (f"; MoE dispatches {calls[0]}, {int(dropped)} of "
                 f"{calls[1]} routed choices dropped for capacity")
    print(f"families {arch}: {n} requests, {n_tok} tokens, {eng.steps} "
          f"decode steps, {prefills} prefills, {passes} maintenance passes "
          f"in {wall:.2f} s: "
          f"{(n_tok - book['window_tok']) / (wall - book['window_s']):.1f} "
          f"tokens/s end to end (the {count} profiled steps left out), "
          f"decode step median {median:.2f} ms (p90 "
          f"{steps[int(len(steps) * 0.9)]:.2f} ms), maintenance "
          f"{maint:.2f} ms per pass (plan + apply), prefill "
          f"{sum(spent['prefill']) / prefills:.2f} ms each; "
          f"{per_step:.1f} kernel launches and {busy:.2f} ms of device "
          f"time per decode step (torch.profiler, steps {first}-"
          f"{first + count - 1}): the device idle "
          f"{100 * (1 - busy / median):.1f} % of the median step{drops}")
    print(f"families {arch}: launches {json.dumps(launches)}; every request "
          f"finished, {eng.releases} releases, released metadata back to "
          f"identity; counters "
          f"{json.dumps({k: v for k, v in c.items() if not k.startswith('epoch_')})}"
          f"; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; card "
          f"{_card_line()}")
    del eng, params
    torch.cuda.empty_cache()
    return launches


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def mixtral_window_phase(torch, dev):
    """mixtral-8x22b at its published width, 2 of its 56 layers, fp32,
    the dense backend.  A 4,600-token prompt prefilled through flash with
    the 4096-token window, then 16 teacher-forced decode steps past
    position 4096: each step's logits within 1e-3 of the one-shot
    ``forward`` over the same 4,616 tokens.  Control: the same run with
    window 0 matches its own one-shot forward and differs from the
    windowed one by more than 1e-2, so the window took effect in both
    paths.  The capacity factor is E/K (an expert's capacity is the
    call's token count): the prefill and the one-shot forward route
    different token counts, so a drop at the published 1.25 would part
    them; the drops the published factor makes on the same forward are
    counted and printed.  Returns the flash launches of the run."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import decode_step, forward, init_params, moe
    from repro_torch.models.kv_backend import DenseBackend
    from repro_torch.weights import unit_fan_in

    pub = get_config("mixtral-8x22b")
    cfg = dataclasses.replace(pub, n_layers=2, dtype="float32",
                              capacity_factor=pub.n_experts / pub.top_k)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = unit_fan_in(init_params(cfg, dev, seed=4), cfg)
    torch.cuda.synchronize()
    print(f"families mixtral-8x22b: 2 of {pub.n_layers} layers, "
          f"d={cfg.d_model} H={cfg.n_heads}/{cfg.n_kv_heads} hd={cfg.hd} "
          f"ff={cfg.d_ff} E={cfg.n_experts} top-{cfg.top_k} "
          f"window {cfg.sliding_window} V={cfg.vocab} fp32, "
          f"{sum(t.numel() for t in _leaves(params)) / 1e9:.3f} B "
          f"parameters made in {time.perf_counter() - t0:.1f} s")
    n, steps = MIXTRAL_PROMPT, MIXTRAL_STEPS
    seq = torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.vocab, (1, n + steps)), dtype=torch.int32, device=dev)
    dropped, calls, restore = _count_drops(torch, moe, dev)
    fa_ops.launches = 0
    t0 = time.perf_counter()
    try:
        with torch.inference_mode():
            out = {}
            for window in (cfg.sliding_window, 0):
                c = dataclasses.replace(cfg, sliding_window=window)
                backend = DenseBackend(c, dev)
                st = backend.init_state(1, n + steps)
                _, _, (k, v) = forward(c, params, {"tokens": seq[:, :n]},
                                       collect_cache=True)
                st = backend.write_prefill(st, 0, k[:, 0], v[:, 0], n)
                del k, v
                rows = []
                for i in range(steps):
                    lg, st = decode_step(c, params, st, seq[:, n + i],
                                         backend=backend)
                    rows.append(lg[0])
                one = forward(c, params, {"tokens": seq})[0][0, n:]
                out[window] = (torch.stack(rows), one)
            ours_drops = int(dropped)
            pub_c = dataclasses.replace(cfg, capacity_factor=1.25)
            dropped.zero_()
            forward(pub_c, params, {"tokens": seq})
            pub_drops, pub_choices = int(dropped), (n + steps) * cfg.top_k
    finally:
        restore()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    win = cfg.sliding_window
    (dec, one), (dec0, one0) = out[win], out[0]
    err = (dec - one).abs().max().item()
    err0 = (dec0 - one0).abs().max().item()
    moved = (dec0 - one).abs().max().item()
    scale = one.abs().max().item()
    _check(ours_drops == 0, f"mixtral: {ours_drops} choices dropped at "
           f"capacity factor {cfg.capacity_factor}")
    _check(math.isfinite(err) and err <= 1e-3,
           f"mixtral: windowed decode differs from the windowed one-shot "
           f"forward by {err} > 1e-3")
    _check(math.isfinite(err0) and err0 <= 1e-3,
           f"mixtral: window-0 decode differs from its one-shot forward by "
           f"{err0} > 1e-3")
    _check(moved > 1e-2, f"mixtral: the window moved the logits by only "
           f"{moved} (control)")
    _check(fa_ops.launches == 5 * cfg.n_layers,
           f"mixtral: flash_attention launches {fa_ops.launches} != 5 "
           f"forwards x {cfg.n_layers} layers")
    print(f"families mixtral-8x22b: a {n}-token prompt through flash with "
          f"window {win}, then {steps} teacher-forced decode steps at "
          f"positions {n}-{n + steps - 1} (dense backend): max |decode - "
          f"one-shot forward| {err:.3e} (tol 1e-3; max |logit| "
          f"{scale:.3f}); control with window 0: {err0:.3e} against its own "
          f"forward, {moved:.3e} from the windowed forward (must exceed "
          f"1e-2); 0 choices dropped at capacity factor "
          f"{cfg.capacity_factor:g}, {pub_drops} of {pub_choices} at the "
          f"published 1.25 on the same {n + steps}-token forward; "
          f"{fa_ops.launches} flash launches (fp32), {secs:.1f} s; peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB")
    launches = fa_ops.launches
    del params, out, dec, one, dec0, one0
    torch.cuda.empty_cache()
    return launches


def families_phase(torch, dev, rows):
    """Phase 11: qwen2-7b and granite-moe-3b served at full width and
    depth by the tiered engine, each then dense against tiered at full
    width on 2 layers; mixtral-8x22b's window at full width on 2 layers.
    Fills in the launches of phase 3's rows at these families' shapes."""
    t0 = time.perf_counter()
    runs = {}
    for arch in FAMILY_ARCHS:
        runs[arch] = family_serve(torch, dev, arch)
        dense_tiered_phase(torch, dev, arch)
    runs["mixtral-8x22b"] = {"flash_attention": mixtral_window_phase(
        torch, dev)}
    _fill_shape_launches(rows, runs)
    print(f"families: phase 11 took {time.perf_counter() - t0:.1f} s")


def _fill_shape_launches(rows, runs):
    """Phase 3's rows at the shape of an arch in ``runs`` take that arch's
    run's launches.  A run's count of a kernel is one number, which a
    flash row takes only if it is a one-shot call (no family run of
    phases 11-12 chunks its prompts), or a dict of the counts measured
    apart by the row's label (its shape's text before the first comma),
    which only a row of that label takes."""
    for name in ("paged_attention_fused", "remap_replay", "flash_attention"):
        for shape in rows[name]["shapes"]:
            if shape["arch"] not in runs:
                continue
            got = runs[shape["arch"]].get(name, 0)
            label = shape["shape"].split(",")[0]
            if isinstance(got, dict):
                if label in got:
                    shape["launches"] = got[label]
            elif name != "flash_attention" or label.startswith("one-shot"):
                shape["launches"] = got


# ---------------------------------------------------------------------------
# phase 12: the recurrent families at full width
# ---------------------------------------------------------------------------

RECURRENT_ARCHS = ("hymba-1.5b", "xlstm-125m")
RECURRENT_LANES, RECURRENT_PROMPT, RECURRENT_STEPS = 2, 2048, 64
# decode steps profiled for their launches and device time (first, count);
# their time and tokens are left out of the run's other numbers
RECURRENT_PROFILED = (24, 4)
# the window gate's last positions, the identities' steps
GATE_ROWS, IDENTITY_STEPS = 64, 64


# (name in the kernels line, kernel package, counter) of every wrapper
KERNEL_COUNTERS = (
    ("flash_attention", "flash_attention", "launches"),
    ("flash_attention_bwd", "flash_attention", "bwd_launches"),
    ("paged_attention_fused", "paged_attention", "launches"),
    ("paged_attention_split", "paged_attention", "split_launches"),
    ("paged_attention", "paged_attention", "unified_launches"),
    ("remap_gather", "remap_gather", "launches"),
    ("remap_replay", "remap_gather", "replay_launches"),
    ("irt_lookup", "irt_lookup", "launches"),
    ("sim_scan", "sim_scan", "launches"))


def _counts(zero: bool = False) -> dict:
    """Every kernel wrapper's launch count by name; with ``zero``, each
    is set to 0 after it is read."""
    import importlib

    import repro_torch.core  # noqa: F401  (sim_scan.ops imports it first)
    out = {}
    for name, pkg, attr in KERNEL_COUNTERS:
        mod = importlib.import_module(f"repro_torch.kernels.{pkg}.ops")
        out[name] = getattr(mod, attr)
        if zero:
            setattr(mod, attr, 0)
    return out


def recurrent_serve(torch, dev, arch):
    """12(a) and (c): ``arch`` at its published width and depth, bf16,
    seeded weights made on the card: ``prefill`` of 2 lanes of 2048-token
    prompts (a warm-up call, then the measured one), then 64 greedy
    ``decode_step``s over the dense backend from the cold state prefill
    returns (the reference's recurrent prefill).  Launch counts are set
    to 0 just before the measured prefill and read after the decode:
    hymba's prefill launches flash once a layer, its decode and all of
    xlstm's run no kernel of the six.  Gates: finite logits of the right
    shapes, greedy tokens inside the vocabulary, ``pos`` advanced by the
    step count.  Prints prefill ms, decode ms a step (median, p90),
    tokens/s, the kernel launches and device ms of a decode step
    (``torch.profiler``, 4 steps) and peak memory.  Returns the launch
    counts."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_params, layer_flags
    from repro_torch.models import prefill as prefill_fn
    from repro_torch.models.kv_backend import DenseBackend

    cfg = get_config(arch)
    gc.collect()                  # earlier phases' engines hold cycles
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = init_params(cfg, dev, seed=0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    flagged = [int(i) for i in layer_flags(cfg).nonzero()[0]]
    extra = (f"state {cfg.ssm_state}, window {cfg.sliding_window}, global "
             f"layers {flagged}" if cfg.family == "hybrid"
             else f"sLSTM layers {flagged}")
    print(f"recurrent {arch}: L={cfg.n_layers} d={cfg.d_model} "
          f"H={cfg.n_heads}/{cfg.n_kv_heads} hd={cfg.hd} ff={cfg.d_ff} "
          f"V={cfg.vocab} {cfg.dtype}, {extra}; {n_params / 1e9:.3f} B "
          f"parameters made in {time.perf_counter() - t0:.1f} s")
    B, S, n = RECURRENT_LANES, RECURRENT_PROMPT, RECURRENT_STEPS
    g = torch.Generator(device=dev)
    g.manual_seed(12)
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=g,
                                     device=dev, dtype=torch.int32)}
    backend = DenseBackend(cfg, dev)
    first, count = RECURRENT_PROFILED
    steps, book = [], {"launches": [], "busy_ms": []}
    with torch.inference_mode():
        prefill_fn(cfg, params, batch, max_len=S + n)
        torch.cuda.synchronize()
        _counts(zero=True)
        t0 = time.perf_counter()
        logits, st = prefill_fn(cfg, params, batch, max_len=S + n)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        after_prefill = _counts()
        _check(tuple(logits.shape) == (B, S, cfg.vocab)
               and bool(logits.isfinite().all()),
               f"{arch}: prefill logits {tuple(logits.shape)} not finite or "
               f"not [{B}, {S}, {cfg.vocab}]")
        _check(not bool(st.pos.any()),
               f"{arch}: prefill's state is not the cold state (pos 0)")
        tok = logits[:, -1].argmax(-1).int()
        del logits
        out = []
        for i in range(n):
            if first <= i < first + count:
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    lg, st = decode_step(cfg, params, st, tok,
                                         backend=backend)
                    torch.cuda.synchronize()
                book["launches"].append(sum(
                    e.count for e in prof.key_averages()
                    if "LaunchKernel" in e.key))
                book["busy_ms"].append(sum(
                    e.time_range.elapsed_us() for e in prof.events()
                    if e.device_type == DeviceType.CUDA) / 1e3)
            else:
                torch.cuda.synchronize()
                s = time.perf_counter()
                lg, st = decode_step(cfg, params, st, tok, backend=backend)
                torch.cuda.synchronize()
                steps.append((time.perf_counter() - s) * 1e3)
            _check(tuple(lg.shape) == (B, cfg.vocab)
                   and bool(lg.isfinite().all()),
                   f"{arch}: decode step {i} logits not finite or not "
                   f"[{B}, {cfg.vocab}]")
            tok = lg.argmax(-1).int()
            out.append(tok)
        toks = torch.stack(out, 1)
    launches = _counts()
    _check(bool(((toks >= 0) & (toks < cfg.vocab)).all()),
           f"{arch}: a token outside the vocabulary")
    _check(st.pos.tolist() == [n] * B,
           f"{arch}: pos {st.pos.tolist()} after {n} steps from 0")
    want = {k: 0 for k in launches}
    if cfg.family == "hybrid":
        want["flash_attention"] = cfg.n_layers
    _check(after_prefill == want and launches == want,
           f"{arch}: launches after prefill {after_prefill}, after decode "
           f"{launches}; want {want} (flash once a layer in hymba's "
           f"prefill, nothing else)")
    _check(len(book["launches"]) == count and min(book["launches"]) > 0,
           f"{arch}: the profiled steps counted no launch")
    steps.sort()
    median = steps[len(steps) // 2]
    busy = sum(book["busy_ms"]) / count
    print(f"recurrent {arch}: prefill of {B} x {S} tokens {prefill_ms:.2f} "
          f"ms ({B * S / prefill_ms * 1e3:.0f} tokens/s, warm); {n} greedy "
          f"decode steps over the dense backend: median {median:.2f} ms "
          f"(p90 {steps[int(len(steps) * 0.9)]:.2f} ms), "
          f"{B * len(steps) / sum(steps) * 1e3:.1f} tokens/s (the {count} "
          f"profiled steps left out); "
          f"{sum(book['launches']) / count:.1f} kernel launches and "
          f"{busy:.2f} ms of device time per decode step (torch.profiler, "
          f"steps {first}-{first + count - 1}): the device idle "
          f"{100 * (1 - busy / median):.1f} % of the median step; launches "
          f"{json.dumps({k: v for k, v in launches.items() if v})}; peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB ({held / 2**30:.2f} GiB of it allocated before the run); "
          f"card {_card_line()}")
    del params, st
    torch.cuda.empty_cache()
    return launches


def hymba_window_gate(torch, dev):
    """12(b): hymba-1.5b at its published width, fp32, cut to 2 layers
    (layer 0 global, layer 1 windowed: ``layer_flags`` of the first two).
    A 2048-token prompt through ``forward`` (flash, window 1024 on layer
    1), then the same prompt replayed token by token through
    ``decode_step`` from the cold state over the dense backend: the last
    64 positions' logits within 1e-3 of the forward's rows.  Control: the
    same with window 0 matches its own forward and differs from the
    windowed one by more than 1e-2, so the window bit in both paths."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import (decode_step, forward, init_decode_state,
                                    init_params, layer_flags)
    from repro_torch.models.kv_backend import DenseBackend
    from repro_torch.weights import unit_fan_in

    pub = get_config("hymba-1.5b")
    cfg = dataclasses.replace(pub, n_layers=2, dtype="float32")
    params = unit_fan_in(init_params(cfg, dev, seed=2), cfg)
    S, R = RECURRENT_PROMPT, GATE_ROWS
    seq = torch.as_tensor(np.random.default_rng(13).integers(
        0, cfg.vocab, (1, S)), dtype=torch.int32, device=dev)
    fa_ops.launches = 0
    t0 = time.perf_counter()
    out = {}
    with torch.inference_mode():
        for window in (cfg.sliding_window, 0):
            c = dataclasses.replace(cfg, sliding_window=window)
            one = forward(c, params, {"tokens": seq})[0][0, S - R:]
            st = init_decode_state(c, 1, S, dev)
            backend = DenseBackend(c, dev)
            rows = []
            for t in range(S):
                lg, st = decode_step(c, params, st, seq[:, t],
                                     backend=backend)
                if t >= S - R:
                    rows.append(lg[0])
            out[window] = (torch.stack(rows), one)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    win = cfg.sliding_window
    (dec, one), (dec0, one0) = out[win], out[0]
    err = (dec - one).abs().max().item()
    err0 = (dec0 - one0).abs().max().item()
    moved = (dec0 - one).abs().max().item()
    _check(math.isfinite(err) and err <= 1e-3,
           f"hymba: windowed decode differs from the windowed forward by "
           f"{err} > 1e-3")
    _check(math.isfinite(err0) and err0 <= 1e-3,
           f"hymba: window-0 decode differs from its forward by {err0} > "
           f"1e-3")
    _check(moved > 1e-2, f"hymba: the window moved the logits by only "
           f"{moved} (control)")
    _check(fa_ops.launches == 2 * cfg.n_layers,
           f"hymba: flash launches {fa_ops.launches} != 2 forwards x "
           f"{cfg.n_layers} layers")
    print(f"recurrent hymba-1.5b window gate: 2 of {pub.n_layers} layers "
          f"(flags {layer_flags(cfg).tolist()}: layer 0 global, layer 1 "
          f"window {win}), fp32, a {S}-token prompt through forward and "
          f"replayed token by token through decode_step from the cold "
          f"state: max |decode - forward| over the last {R} positions "
          f"{err:.3e} (tol 1e-3; max |logit| {one.abs().max().item():.3f}); "
          f"control with window 0: {err0:.3e} against its own forward, "
          f"{moved:.3e} from the windowed forward (must exceed 1e-2); "
          f"{fa_ops.launches} flash launches (fp32); {secs:.1f} s")
    del params, out, dec, one, dec0, one0
    torch.cuda.empty_cache()


def recurrent_identities(torch, dev):
    """12(d): the recurrent forms against the parallel ones at full width
    in fp32, 64 steps from the parallel form's start, at the tolerances
    the reference's tests hold its own to (``test_chunked_equivalence.
    py``): hymba's ``ssm_step`` against ``ssm_scan`` within 2e-3,
    ``mlstm_step`` from m = -1e30 against ``mlstm_parallel`` within 2e-3;
    and ``slstm_step`` against ``slstm_scan`` within 1e-4 (the same cell;
    cuBLAS may sum the W x product over 64 rows and over one in other
    orders).  Then each plain scan's and step's time per call (CUDA
    events, cold L2) at phase 12's call: 2 lanes of 2048 tokens (a step:
    one token), bf16."""
    from repro_torch.configs import get_config
    from repro_torch.models import ssm, xlstm
    from repro_torch.weights import unit_fan_in

    hy, xl = get_config("hymba-1.5b"), get_config("xlstm-125m")
    T, B, S = IDENTITY_STEPS, RECURRENT_LANES, RECURRENT_PROMPT
    H = xl.n_heads
    hd = xl.d_model // H
    g = torch.Generator(device=dev)
    g.manual_seed(20)

    def layer0(init, cfg):
        return {k: v[0] for k, v in init(
            g, dataclasses.replace(cfg, n_layers=1), dev).items()}

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    def m_state(m0):
        return {"C": torch.zeros((B, H, hd, hd), device=dev),
                "n": torch.zeros((B, H, hd), device=dev),
                "m": torch.full((B, H), m0, device=dev)}

    def stepped(step, p, x, st, *cfg):
        outs = []
        for t in range(x.shape[1]):
            o, st = step(p, x[:, t:t + 1], st, *cfg)
            outs.append(o)
        return torch.cat(outs, 1)

    with torch.inference_mode():
        h32 = dataclasses.replace(hy, dtype="float32")
        x32 = dataclasses.replace(xl, dtype="float32")
        ps = layer0(ssm.ssm_init, h32)
        px = unit_fan_in(layer0(xlstm.xlstm_init, x32), x32)
        xz = randn(B, T, 2 * hy.d_model, scale=0.3)
        xm, xs = randn(B, T, xl.d_model, scale=0.1), randn(B, T, xl.d_model)
        pairs = {
            "ssm": (stepped(ssm.ssm_step, ps, xz,
                            ssm.ssm_state_init(h32, B, dev), h32),
                    ssm.ssm_scan(ps, xz, h32)),
            "mlstm": (stepped(xlstm.mlstm_step, px, xm, m_state(-1e30)),
                      xlstm.mlstm_parallel(px, xm)),
            "slstm": (stepped(xlstm.slstm_step, px, xs,
                              xlstm.slstm_state_init(B, H, hd, dev)),
                      xlstm.slstm_scan(px, xs))}
        err = {k: (a - b).abs().max().item() for k, (a, b) in pairs.items()}
        ps, px = layer0(ssm.ssm_init, hy), layer0(xlstm.xlstm_init, xl)
        xz = randn(B, S, 2 * hy.d_model, scale=0.3).bfloat16()
        x = randn(B, S, xl.d_model, scale=0.3).bfloat16()
        hst = ssm.ssm_state_init(hy, B, dev)
        mst, sst = m_state(0.0), xlstm.slstm_state_init(B, H, hd, dev)
        times = {
            "ssm_scan": _time_ms(lambda: ssm.ssm_scan(ps, xz, hy), reps=5),
            "ssm_step": _time_ms(lambda: ssm.ssm_step(ps, xz[:, :1], hst,
                                                      hy)),
            "mlstm_parallel": _time_ms(lambda: xlstm.mlstm_parallel(px, x),
                                       reps=5),
            "mlstm_step": _time_ms(lambda: xlstm.mlstm_step(px, x[:, :1],
                                                            mst)),
            "slstm_scan": _time_ms(lambda: xlstm.slstm_scan(px, x), reps=3,
                                   warmup=1),
            "slstm_step": _time_ms(lambda: xlstm.slstm_step(px, x[:, :1],
                                                            sst))}
    tol = {"ssm": 2e-3, "mlstm": 2e-3, "slstm": 1e-4}
    for k, e in err.items():
        _check(math.isfinite(e) and e <= tol[k],
               f"recurrent identity {k}: recurrent against parallel {e} > "
               f"{tol[k]}")
    print(f"recurrent identities at full width, fp32, {T} steps (max abs "
          f"err, tolerance): "
          + ", ".join(f"{k} {e:.3e} ({tol[k]:g})" for k, e in err.items()))
    print(f"recurrent plain scans, ms per call (CUDA events, cold L2; {B} "
          f"lanes of {S} tokens or one step, bf16; hymba d {hy.d_model} "
          f"state {hy.ssm_state}, xlstm d {xl.d_model} H {H}): "
          + ", ".join(f"{k} {v:.3f}" for k, v in times.items())
          + f"; card {_card_line()}")


def recurrent_phase(torch, dev, rows):
    """Phase 12: hymba-1.5b and xlstm-125m served at full width and depth
    (prefill, then decode), hymba's per-layer window against its forward
    on 2 layers, the recurrent identities and the plain scans' times.
    Fills in the launches of phase 3's flash row at hymba's shape."""
    t0 = time.perf_counter()
    runs = {arch: recurrent_serve(torch, dev, arch)
            for arch in RECURRENT_ARCHS}
    hymba_window_gate(torch, dev)
    recurrent_identities(torch, dev)
    _fill_shape_launches(rows, runs)
    print(f"recurrent: phase 12 took {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 13: the vlm and audio families at published widths
# ---------------------------------------------------------------------------

VLM_ARCH, AUDIO_ARCH = "llama-3.2-vision-90b", "hubert-xlarge"
VLM_LAYERS = 20               # of 100: 4 super-blocks of 4 self + 1 cross
VLM_LANES, VLM_PROMPT, VLM_STEPS = 2, 512, 32
# decode steps profiled for their launches and device time (first, count);
# their time and tokens are left out of the run's other numbers
VLM_PROFILED = (8, 4)
# the cross layers' gate: tanh(1) = 0.76; the reference's 0 hides the branch
VLM_GATE = 1.0
VLM_GATE_ROWS = 16            # 13(b): teacher-forced positions
AUDIO_LANES, AUDIO_FRAMES = 4, 1500   # 30 s of audio at 50 frames/s


def _vlm_model(torch, dev, cfg, seed):
    """Seeded weights on the card with every cross gate at ``VLM_GATE``,
    and seeded image embeddings [lanes, n_image_tokens, d] in the
    model's dtype (the card's cross-attention takes no other)."""
    from repro_torch.device import torch_dtype
    from repro_torch.models import init_params
    params = init_params(cfg, dev, seed=seed)
    params["blocks"]["cross"]["attn"]["gate"].fill_(VLM_GATE)
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 100)
    img = torch.randn((VLM_LANES, cfg.n_image_tokens, cfg.d_model),
                      generator=g, device=dev).to(torch_dtype(cfg.dtype))
    return params, img, g


class _CrossTap:
    """While open, the model's ``attention.cross_attention`` is wrapped
    to add to ``launches`` the flash launches that the wrapper's own
    counter counts during each call: the cross layers' share of a run's
    flash launches, the rest being the self layers'.  Counts nothing
    else; the function is put back on exit."""

    def __init__(self):
        self.launches = 0

    def __enter__(self):
        from repro_torch.kernels.flash_attention import ops as fa_ops
        from repro_torch.models import attention

        self._mod, self._real = attention, attention.cross_attention

        def tapped(*args, **kwargs):
            before = fa_ops.launches
            out = self._real(*args, **kwargs)
            self.launches += fa_ops.launches - before
            return out
        attention.cross_attention = tapped
        return self

    def __exit__(self, *exc):
        self._mod.cross_attention = self._real
        return False


def vlm_serve(torch, dev):
    """13(a): llama-3.2-vision-90b at its published widths, depth cut to
    ``VLM_LAYERS`` (printed as ``reduced``), bf16, seeded weights made
    on the card: ``prefill`` of 2 lanes of 512 prompt tokens over 1,601
    image tokens (a warm-up call, then the measured one), then 32 greedy
    ``decode_step``s over the dense backend.  Launch counts are set to 0
    just before the measured prefill and read after it and after the
    decode, the cross layers' flash launches apart (``_CrossTap``):
    flash once a self and once a cross layer in prefill, once a cross
    layer a decode step, nothing else.  Gates: finite logits of
    the right shapes, tokens inside the vocabulary, ``pos`` advanced by
    the step count, the image K/V untouched by decode.  Prints prefill
    ms, decode ms a step, tokens/s, the launches and device ms of a
    decode step (``torch.profiler``) and peak memory.  Returns the run's
    launch counts, flash's as a dict by the labels of 13(d)'s rows."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models import decode_step
    from repro_torch.models import prefill as prefill_fn
    from repro_torch.models.kv_backend import DenseBackend

    pub = get_config(VLM_ARCH)
    cfg = dataclasses.replace(pub, n_layers=VLM_LAYERS)
    ns, inner = cfg.vlm_dims
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params, img, g = _vlm_model(torch, dev, cfg, seed=0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"vlm {VLM_ARCH}: reduced: {cfg.n_layers} of {pub.n_layers} "
          f"layers ({ns} of {pub.n_layers // pub.cross_attn_every} "
          f"super-blocks of {inner} self + 1 cross layer); published widths "
          f"d={cfg.d_model} H={cfg.n_heads}/{cfg.n_kv_heads} hd={cfg.hd} "
          f"ff={cfg.d_ff} V={cfg.vocab}, {cfg.n_image_tokens} image tokens, "
          f"{cfg.dtype}; {n_params / 1e9:.3f} B parameters made in "
          f"{time.perf_counter() - t0:.1f} s; cross gate {VLM_GATE} (tanh "
          f"{math.tanh(VLM_GATE):.3f})")
    B, S, n = VLM_LANES, VLM_PROMPT, VLM_STEPS
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=g,
                                     device=dev, dtype=torch.int32),
             "image_embeds": img}
    backend = DenseBackend(cfg, dev)
    first, count = VLM_PROFILED
    steps, book = [], {"launches": [], "busy_ms": []}
    with torch.inference_mode():
        prefill_fn(cfg, params, batch, max_len=S + n)
        torch.cuda.synchronize()
        tap = _CrossTap().__enter__()
        _counts(zero=True)
        t0 = time.perf_counter()
        logits, st = prefill_fn(cfg, params, batch, max_len=S + n)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        after_prefill = _counts()
        cross_prefill = tap.launches
        _check(tuple(logits.shape) == (B, S, cfg.vocab)
               and bool(logits.isfinite().all()),
               f"vlm: prefill logits {tuple(logits.shape)} not finite or not "
               f"[{B}, {S}, {cfg.vocab}]")
        _check(st.pos.tolist() == [S] * B, f"vlm: prefill pos {st.pos}")
        ik0 = st.caches["ik"].clone()
        tok = logits[:, -1].argmax(-1).int()
        del logits
        out = []
        for i in range(n):
            if first <= i < first + count:
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    lg, st = decode_step(cfg, params, st, tok,
                                         backend=backend)
                    torch.cuda.synchronize()
                book["launches"].append(sum(
                    e.count for e in prof.key_averages()
                    if "LaunchKernel" in e.key))
                book["busy_ms"].append(sum(
                    e.time_range.elapsed_us() for e in prof.events()
                    if e.device_type == DeviceType.CUDA) / 1e3)
            else:
                torch.cuda.synchronize()
                s = time.perf_counter()
                lg, st = decode_step(cfg, params, st, tok, backend=backend)
                torch.cuda.synchronize()
                steps.append((time.perf_counter() - s) * 1e3)
            _check(tuple(lg.shape) == (B, cfg.vocab)
                   and bool(lg.isfinite().all()),
                   f"vlm: decode step {i} logits not finite or not "
                   f"[{B}, {cfg.vocab}]")
            tok = lg.argmax(-1).int()
            out.append(tok)
        toks = torch.stack(out, 1)
    launches = _counts()
    tap.__exit__()
    flash = {"self one-shot": after_prefill["flash_attention"]
             - cross_prefill,
             "cross prefill": cross_prefill,
             "cross decode": tap.launches - cross_prefill}
    self_decode = (launches["flash_attention"]
                   - after_prefill["flash_attention"] - flash["cross decode"])
    _check(bool(((toks >= 0) & (toks < cfg.vocab)).all()),
           "vlm: a token outside the vocabulary")
    _check(st.pos.tolist() == [S + n] * B,
           f"vlm: pos {st.pos.tolist()} after {n} steps from {S}")
    _check(torch.equal(st.caches["ik"], ik0),
           "vlm: decode wrote the image K/V")
    want = {k: 0 for k in launches}
    want["flash_attention"] = ns * inner + ns
    _check(after_prefill == want,
           f"vlm: launches after prefill {after_prefill}; want {want} (flash "
           f"once a self and once a cross layer)")
    want["flash_attention"] += ns * n
    _check(launches == want,
           f"vlm: launches after decode {launches}; want {want} (flash once "
           f"a cross layer a step)")
    split = {"self one-shot": ns * inner, "cross prefill": ns,
             "cross decode": ns * n}
    _check(flash == split and self_decode == 0,
           f"vlm: flash launches by layer kind {flash}, {self_decode} by self "
           f"layers in decode; want {split}, 0")
    _check(len(book["launches"]) == count and min(book["launches"]) > 0,
           "vlm: the profiled steps counted no launch")
    steps.sort()
    median = steps[len(steps) // 2]
    busy = sum(book["busy_ms"]) / count
    print(f"vlm {VLM_ARCH}: prefill of {B} x {S} tokens over "
          f"{cfg.n_image_tokens} image tokens {prefill_ms:.2f} ms "
          f"({B * S / prefill_ms * 1e3:.0f} tokens/s, warm); {n} greedy "
          f"decode steps over the dense backend: median {median:.2f} ms "
          f"(p90 {steps[int(len(steps) * 0.9)]:.2f} ms), "
          f"{B * len(steps) / sum(steps) * 1e3:.1f} tokens/s (the {count} "
          f"profiled steps left out); "
          f"{sum(book['launches']) / count:.1f} kernel launches and "
          f"{busy:.2f} ms of device time per decode step (torch.profiler, "
          f"steps {first}-{first + count - 1}): the device idle "
          f"{100 * (1 - busy / median):.1f} % of the median step; flash "
          f"launches {after_prefill['flash_attention']} in prefill "
          f"({flash['self one-shot']} self, {flash['cross prefill']} cross, "
          f"counted apart) and "
          f"{launches['flash_attention'] - after_prefill['flash_attention']}"
          f" in decode ({flash['cross decode']} cross, {self_decode} self); "
          f"peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"({held / 2**30:.2f} GiB of it allocated before the run); card "
          f"{_card_line()}")
    del params, st, img, batch, ik0
    gc.collect()
    torch.cuda.empty_cache()
    return {**launches, "flash_attention": flash}


def vlm_gate(torch, dev):
    """13(b): llama-3.2-vision-90b at its published widths in fp32, one
    super-block (4 self + 1 cross layer).  A 512-token prompt through
    ``forward``; the same prompt's first 496 tokens through ``prefill``,
    then its last 16 teacher-forced through ``decode_step`` over the
    dense backend: their logits within 1e-3 of the forward's rows.
    Control: the forward with other image embeddings moves those rows by
    more than 1e-2, so the cross branch is live in both paths."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import decode_step, forward, prefill
    from repro_torch.models.kv_backend import DenseBackend
    from repro_torch.weights import unit_fan_in

    pub = get_config(VLM_ARCH)
    cfg = dataclasses.replace(pub, n_layers=pub.cross_attn_every,
                              dtype="float32")
    params, img, g = _vlm_model(torch, dev, cfg, seed=1)
    unit_fan_in(params, cfg)
    img2 = torch.randn(img.shape, generator=g, device=dev)
    S, R = VLM_PROMPT, VLM_GATE_ROWS
    seq = torch.randint(0, cfg.vocab, (VLM_LANES, S), generator=g,
                        device=dev, dtype=torch.int32)
    fa_ops.launches = 0
    t0 = time.perf_counter()
    with torch.inference_mode():
        one = forward(cfg, params, {"tokens": seq,
                                    "image_embeds": img})[0][:, S - R:]
        _, st = prefill(cfg, params, {"tokens": seq[:, :S - R],
                                      "image_embeds": img}, max_len=S)
        backend = DenseBackend(cfg, dev)
        rows = []
        for t in range(S - R, S):
            lg, st = decode_step(cfg, params, st, seq[:, t], backend=backend)
            rows.append(lg)
        dec = torch.stack(rows, 1)
        other = forward(cfg, params, {"tokens": seq,
                                      "image_embeds": img2})[0][:, S - R:]
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    err = (dec - one).abs().max().item()
    moved = (other - one).abs().max().item()
    _check(math.isfinite(err) and err <= 1e-3,
           f"vlm: teacher-forced decode differs from forward by {err} > 1e-3")
    _check(moved > 1e-2, f"vlm: other image embeddings moved the logits by "
           f"only {moved} (control)")
    want = 3 * cfg.n_layers + R
    _check(fa_ops.launches == want,
           f"vlm gate: flash launches {fa_ops.launches} != {want} (3 "
           f"passes of {cfg.n_layers} layers, {R} cross decode reads)")
    print(f"vlm gate: 1 super-block ({cfg.n_layers} of {pub.n_layers} "
          f"layers) at "
          f"published widths, fp32, {VLM_LANES} lanes: a {S}-token prompt "
          f"through forward, its last {R} tokens teacher-forced through "
          f"decode_step after a prefill of the rest: max |decode - forward| "
          f"{err:.3e} (tol 1e-3; max |logit| {one.abs().max().item():.3f}); "
          f"control with other image embeddings {moved:.3e} away (must "
          f"exceed 1e-2); {fa_ops.launches} flash launches (fp32); "
          f"{secs:.1f} s")
    del params, img, img2, one, dec, other, st
    gc.collect()
    torch.cuda.empty_cache()


def audio_forward(torch, dev):
    """13(c): hubert-xlarge at its published widths and depth, bf16,
    seeded weights made on the card: ``forward`` of 4 lanes of 1,500
    frames (a warm-up call, then the measured one); launch counts set to
    0 just before the measured call and read after: flash once a layer,
    nothing else.  Gates: finite logits [4, 1500, 504].  Prints forward
    ms, frames/s and peak memory.  Returns the flash launches."""
    from repro_torch.configs import get_config
    from repro_torch.models import forward, init_params

    cfg = get_config(AUDIO_ARCH)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = init_params(cfg, dev, seed=0)
    g = torch.Generator(device=dev)
    g.manual_seed(15)
    for k in ("b_in", "b_out"):
        b = params["blocks"]["mlp"][k]
        b.copy_(torch.randn(b.shape, generator=g, device=dev) * 0.1)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    B, S = AUDIO_LANES, AUDIO_FRAMES
    emb = torch.randn((B, S, cfg.d_model), generator=g,
                      device=dev).bfloat16()
    print(f"audio {AUDIO_ARCH}: L={cfg.n_layers} d={cfg.d_model} "
          f"H={cfg.n_heads}/{cfg.n_kv_heads} hd={cfg.hd} ff={cfg.d_ff} "
          f"V={cfg.vocab} {cfg.dtype}, non-causal, no RoPE, MLP biases "
          f"random (std 0.1); {n_params / 1e9:.3f} B parameters made in "
          f"{time.perf_counter() - t0:.1f} s; not cut")
    with torch.inference_mode():
        forward(cfg, params, {"embeds": emb})
        torch.cuda.synchronize()
        _counts(zero=True)
        t0 = time.perf_counter()
        logits = forward(cfg, params, {"embeds": emb})[0]
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    launches = _counts()
    _check(tuple(logits.shape) == (B, S, cfg.vocab)
           and bool(logits.isfinite().all()),
           f"audio: logits {tuple(logits.shape)} not finite or not "
           f"[{B}, {S}, {cfg.vocab}]")
    want = {k: 0 for k in launches}
    want["flash_attention"] = cfg.n_layers
    _check(launches == want, f"audio: launches {launches}; want {want}")
    print(f"audio {AUDIO_ARCH}: forward of {B} x {S} frames {ms:.2f} ms "
          f"({B * S / ms * 1e3:.0f} frames/s, warm); flash launches "
          f"{launches['flash_attention']} (one a layer); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"({held / 2**30:.2f} GiB of it allocated before the run); card "
          f"{_card_line()}")
    del params, emb, logits
    torch.cuda.empty_cache()
    return launches["flash_attention"]


def vlm_audio_flash_rows(torch, dev, base):
    """13(d): flash at the vlm's and hubert's shapes, checked and timed
    as phase 3's rows (bf16 within two ulps of each plain value, fp32
    within 1e-4; kernel, plain and library times; the bound): the vlm's
    self-attention one-shot (S = T = 512, causal), its cross-attention
    in prefill (S = 512 over T = 1,601 image keys) and in decode (S = 1),
    non-causal, H 64/8, hd 128, 2 lanes; hubert's (S = T = 1,500, H
    16/16, hd 80, non-causal, 4 lanes) in bf16 and in fp32.  Then rows
    independent of the call, bit for bit, over the image keys: single
    rows at their own positions equal the prefill call's rows, and a
    causal decode row at q_offset 1,600 over keys padded to 3,202 (the
    extra ones masked) equals the non-causal call over the 1,601.
    Returns the rows; their launches are filled in from phase 13's
    runs."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops

    op = fa_ops.flash_attention_op
    vlm, aud = get_config(VLM_ARCH), get_config(AUDIO_ARCH)
    g = torch.Generator(device=dev)
    g.manual_seed(34)

    def r(*s, dtype=torch.bfloat16):
        return torch.randn(s, generator=g, device=dev).to(dtype)

    B, S, T = VLM_LANES, VLM_PROMPT, vlm.n_image_tokens
    H, KV, hd = vlm.n_heads, vlm.n_kv_heads, vlm.hd
    q, k, v = r(B, S, H, hd), r(B, S, KV, hd), r(B, S, KV, hd)
    ik, iv = r(B, T, KV, hd), r(B, T, KV, hd)
    qa, ka, va = (r(AUDIO_LANES, AUDIO_FRAMES, h, aud.hd, dtype=torch.float32)
                  for h in (aud.n_heads, aud.n_kv_heads, aud.n_kv_heads))
    cases = (
        (VLM_ARCH, "self one-shot", q, k, v, True),
        (VLM_ARCH, "cross prefill", q, ik, iv, False),
        (VLM_ARCH, "cross decode", q[:, -1:].contiguous(), ik, iv, False),
        (AUDIO_ARCH, "one-shot", qa.bfloat16(), ka.bfloat16(), va.bfloat16(),
         False),
        (AUDIO_ARCH, "one-shot fp32", qa, ka, va, False))
    rows = []
    for arch, label, qq, kk, vv, causal in cases:
        shape = (f"{label}, B {qq.shape[0]}, S {qq.shape[1]}, T "
                 f"{kk.shape[1]}, H {qq.shape[2]}/{kk.shape[2]}, hd "
                 f"{qq.shape[3]}, {'causal' if causal else 'non-causal'}, "
                 f"{'bf16' if qq.dtype == torch.bfloat16 else 'fp32'}")
        rows.append(_shape_row(base, arch, shape, **_flash_case(
            torch, dev, qq, kk, vv, 0, f"{label} at {arch}'s shape",
            causal=causal)))
    full = op(q, ik, iv, causal=False)
    starts = (0, 17, 255, 511)
    for i in starts:
        one = op(q[:, i:i + 1].contiguous(), ik, iv, causal=False, q_offset=i)
        _check(torch.equal(one, full[:, i:i + 1]),
               f"flash_attention: cross row {i} alone differs from the "
               f"prefill call's row")
    ik2, iv2 = (torch.cat([t, r(*t.shape)], dim=1) for t in (ik, iv))
    dec = q[:, :1].contiguous()
    _check(torch.equal(op(dec, ik2, iv2, causal=True, q_offset=T - 1),
                       op(dec, ik, iv, causal=False)),
           "flash_attention: masked extra image keys changed a row")
    print(f"kernel flash_attention rows independent of the call over "
          f"{T} image keys, bit for bit: rows {list(starts)} alone equal the "
          f"{S}-row cross call's; a causal row at q_offset {T - 1} over "
          f"{2 * T} keys (the extra ones masked) equals the non-causal row "
          f"over {T}")
    del q, k, v, ik, iv, qa, ka, va, full, ik2, iv2
    torch.cuda.empty_cache()
    return rows


def vlm_audio_phase(torch, dev, rows):
    """Phase 13: llama-3.2-vision-90b (depth cut) served, its fp32
    super-block's decode against its forward, hubert-xlarge's forward
    at full width and depth, and flash at their shapes (rows added under
    phase 3's flash row)."""
    t0 = time.perf_counter()
    runs = {VLM_ARCH: vlm_serve(torch, dev)}
    vlm_gate(torch, dev)
    runs[AUDIO_ARCH] = {"flash_attention": {"one-shot": audio_forward(
        torch, dev)}}
    rows["flash_attention"]["shapes"] += vlm_audio_flash_rows(
        torch, dev, rows["flash_attention"])
    _fill_shape_launches(rows, runs)
    print(f"vlm/audio: phase 13 took {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 14: training at published widths, flash attention's backward
# ---------------------------------------------------------------------------

# (label, B, S, T, H, KV, hd, causal, window) of the backward's gates: the
# training run's layers first (its row in the kernels line), then hymba's,
# hubert's and the vlm's cross-attention shapes
FLASH_BWD_CASES = (
    ("llama3-8b", 4, 1024, 1024, 32, 8, 128, True, 0),
    ("hymba-1.5b", 1, 2048, 2048, 25, 5, 64, True, 1024),
    ("hubert-xlarge", 4, 1500, 1500, 16, 16, 80, False, 0),
    ("llama-3.2-vision-90b", 2, 512, 1601, 64, 8, 128, False, 0))
# the training run: llama3-8b at published widths, depth cut to 8 of 32
# layers (AdamW's fp32 moments of all 8.03 B parameters alone take 64 GB)
TRAIN_ARCH, TRAIN_LAYERS, TRAIN_STEPS, TRAIN_RESUME_AT = "llama3-8b", 8, 6, 3
TRAIN_SEQ, TRAIN_BATCH = 1024, 4
# the resume check's depth: two checkpoints of ~15 GB each (params and
# fp32 moments of 1.49 B parameters) stay inside the 45 GiB a chip call
# may write to its disk
TRAIN_RESUME_LAYERS = 2


def _flash_bwd_case(torch, dev, label, B, S, T, H, KV, hd, causal, window,
                    dtype, seed):
    """One backward call checked and timed.  The forward kernel's out with
    and without the lse store, bit for bit; lse within 1e-5 of
    ``torch.logsumexp`` over the masked fp32 scores; dq, dk, dv against
    ``attention_bwd_ref`` (fp32 from the same inputs, o and lse): fp32
    within 1e-4 of each one's max |value|, bf16 within 5e-3 (rounding an
    output to bf16 moves it by up to 2^-8 of its value, 3.9e-3 of the
    max); a second call equal to the first bit for bit (no atomics).  The
    library's backward (below) is held against the same reference and
    its error printed beside the kernel's, not gated.  Times: the kernel
    (median of 30, cold L2), the plain version, and the library
    (``scaled_dot_product_attention``'s forward and backward minus its
    forward, K/V repeated over the group, the same mask); the bound: 2.5x
    the forward's multiply-adds over the unmasked pairs at the type's peak
    (bf16 tensor cores; fp32 outside them), against each input read and
    each gradient written once."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                         attention_lse_ref)

    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g, device=dev).to(  # noqa: E731
        dtype)
    q, k, v, do = r(B, S, H, hd), r(B, T, KV, hd), r(B, T, KV, hd), \
        r(B, S, H, hd)
    kw = dict(causal=causal, window=window, q_offset=0)
    name = "bf16" if dtype == torch.bfloat16 else "fp32"
    o, lse, _ = fa_ops._forward(q, k, v, causal, window, 0, with_lse=True)
    _check(torch.equal(o, fa_ops._forward(q, k, v, causal, window, 0,
                                          with_lse=False)[0]),
           f"flash_attention {label} {name}: the lse store changed out")
    t = lambda x: x.transpose(1, 2).float()  # noqa: E731
    lse_err = (lse - attention_lse_ref(t(q), t(k), **kw)).abs().max().item()
    _check(math.isfinite(lse_err) and lse_err <= 1e-5,
           f"flash_attention {label} {name}: lse error {lse_err} > 1e-5")
    got = fa_ops.flash_attention_bwd_op(q, k, v, o, do, lse, **kw)
    again = fa_ops.flash_attention_bwd_op(q, k, v, o, do, lse, **kw)
    _check(all(torch.equal(a, b) for a, b in zip(got, again)),
           f"flash_attention_bwd {label} {name}: a second call differs from "
           f"the first")
    del again
    want = [w.transpose(1, 2) for w in attention_bwd_ref(
        t(q), t(k), t(v), t(o), t(do), lse, **kw)]
    G = H // KV
    lq = q.transpose(1, 2).contiguous().requires_grad_(True)
    lk, lv = (x.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
              .requires_grad_(True) for x in (k, v))
    ldo = do.transpose(1, 2).contiguous()
    mask = None
    if causal and window:
        pos = torch.arange(max(S, T), device=dev)
        mask = (pos[None, :T] <= pos[:S, None]) & \
            (pos[None, :T] > pos[:S, None] - window)
    fwd = lambda: F.scaled_dot_product_attention(  # noqa: E731
        lq, lk, lv, attn_mask=mask, is_causal=causal and not window)
    lq_g, lk_g, lv_g = torch.autograd.grad(fwd(), (lq, lk, lv), ldo)
    lib = [lq_g.transpose(1, 2)] + [
        x.float().reshape(B, KV, G, T, hd).sum(2).transpose(1, 2)
        for x in (lk_g, lv_g)]
    del lq_g, lk_g, lv_g
    limit = 1e-4 if dtype == torch.float32 else 5e-3
    errs, lib_errs, worst = [], [], 0.0
    for gname, a, w, li in zip(("dq", "dk", "dv"), got, want, lib):
        e = (a.float() - w).abs().max().item()
        wmax = w.abs().max().item()
        rel = e / wmax
        _check(math.isfinite(e) and rel <= limit,
               f"flash_attention_bwd {label} {name}: {gname} error {e} is "
               f"{rel:.2e} of its max (limit {limit})")
        errs.append(f"{gname} {rel:.2e}")
        lib_rel = (li.float() - w).abs().max().item() / wmax
        lib_errs.append(f"{gname} {lib_rel:.2e}")
        worst = max(worst, e)
    del got, want, lib
    ms = _time_ms(lambda: fa_ops.flash_attention_bwd_op(q, k, v, o, do, lse,
                                                        **kw))
    plain_ms = _time_ms(lambda: attention_bwd_ref(
        t(q), t(k), t(v), t(o), t(do), lse, **kw), reps=5)
    lib_ms = _time_ms(lambda: torch.autograd.grad(fwd(), (lq, lk, lv),
                                                  ldo)) - _time_ms(fwd)
    item = q.element_size()
    _, _, fwd_flops = _flash_bound(S, T, H, KV, hd, 0, item, window, causal,
                                   B)
    flops = 2.5 * fwd_flops
    # q, o, do in and dq out; k, v in and dk, dv out; lse in
    nbytes = item * (4 * B * S * H * hd + 4 * B * T * KV * hd) + \
        4 * B * H * S
    t_ops = flops / (BF16_FLOP_PER_S if item == 2 else FP32_FLOP_PER_S) * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(t_ops, t_bytes)
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    print(f"kernel flash_attention_bwd {name} at {label}'s shape (B={B}, "
          f"S={S}, T={T}, H={H}/{KV}, hd={hd}, "
          f"{'causal' if causal else 'non-causal'}"
          f"{f', window {window}' if window else ''}): error/max "
          f"{', '.join(errs)} (limit {limit}; the library's backward "
          f"{', '.join(lib_errs)}); two calls equal bit for bit; lse max "
          f"abs err {lse_err:.2e} (tol 1e-5); out with and without the lse "
          f"store equal bit for bit; {ms:.4f} ms, plain {plain_ms:.3f} ms, "
          f"scaled_dot_product_attention backward {lib_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}), {ms / bound_ms:.1f}x the bound")
    print("kernel " + _vs_bound(f"flash_attention_bwd {name} at {label}'s "
                                f"shape", ms, bound_ms, flops=flops))
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms)


def flash_bwd_rows(torch, dev):
    """14(a): the backward at ``FLASH_BWD_CASES`` in bf16 and fp32.
    Returns the kernels line's row: the training run's shape in bf16 (its
    numbers), the rest under ``shapes``."""
    row = dict(name="flash_attention_bwd", route="cuda",
               source="src/repro_torch/kernels/flash_attention/csrc/"
                      "flash_attention_bwd.cu",
               replaces="src/repro/kernels/flash_attention/flash_attention.py"
                        ":70", shapes=[])
    for i, (arch, B, S, T, H, KV, hd, causal, window) in enumerate(
            FLASH_BWD_CASES):
        for dtype in (torch.bfloat16, torch.float32):
            res = _flash_bwd_case(torch, dev, arch, B, S, T, H, KV, hd,
                                  causal, window, dtype, seed=40 + i)
            if i == 0 and dtype == torch.bfloat16:
                row.update(res)
            else:
                kind = "bf16" if dtype == torch.bfloat16 else "fp32"
                shape = (f"B {B}, S {S}, T {T}, H {H}/{KV}, hd {hd}, "
                         f"{'causal' if causal else 'non-causal'}, window "
                         f"{window}, {kind}")
                row["shapes"].append(_shape_row(row, arch, shape, **res))
            torch.cuda.empty_cache()
    return row


def flash_train_fwd_row(torch, dev, base):
    """14(a): the forward kernel at the training run's shape
    (``FLASH_BWD_CASES[0]``: B 4, S = T = 1024, H 32/8, hd 128, causal,
    bf16), checked and timed as phase 3's rows are (``_flash_case``).
    Returns its row for ``base``'s ``shapes``; its launches are the
    training run's (``train_phase``)."""
    arch, B, S, T, H, KV, hd, causal, window = FLASH_BWD_CASES[0]
    g = torch.Generator(device=dev)
    g.manual_seed(39)
    r = lambda *s: torch.randn(s, generator=g, device=dev).to(  # noqa: E731
        torch.bfloat16)
    q, k, v = r(B, S, H, hd), r(B, T, KV, hd), r(B, T, KV, hd)
    res = _flash_case(torch, dev, q, k, v, 0, f"one-shot at {arch}'s "
                      f"training shape", window, causal)
    shape = (f"training one-shot, B {B}, S {S}, q_offset 0, T {T}, H "
             f"{H}/{KV}, hd {hd}, window {window}, bf16")
    return _shape_row(base, arch, shape, **res)


def _manifest_hashes(directory, step) -> dict:
    with open(Path(directory) / f"step_{step:08d}" / "manifest.json") as f:
        return {k: v["sha256"] for k, v in json.load(f)["leaves"].items()}


def _train_configs():
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.train.optimizer import OptConfig

    pub = get_config(TRAIN_ARCH)
    cfg = dataclasses.replace(pub, n_layers=TRAIN_LAYERS)
    dc = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                    global_batch=TRAIN_BATCH)
    oc = OptConfig(lr=3e-4, warmup_steps=2, total_steps=TRAIN_STEPS)
    return pub, cfg, dc, oc


def train_run(torch, dev):
    """14(b): ``fit`` of llama3-8b at published widths on 8 of its 32
    layers, bf16, seeded weights from ``init_params`` (the reference's
    scale), 4 x 1024 tokens a step, AdamW (lr 3e-4, 2 warmup steps, cosine
    over 6), remat "none", 6 steps; launch counts set to 0 just before
    and read just after: 8 flash forward and 8 backward launches a step,
    nothing else.  Every loss and gnorm finite.  Prints step ms (median of
    steps 2-6: the log line's ``float`` waits for each step), tokens/s,
    peak memory and the loss by step.  Returns the forward's and the
    backward's launches."""
    from repro_torch.train.loop import TrainConfig, fit

    pub, cfg, dc, oc = _train_configs()
    print(f"train {TRAIN_ARCH}: L={cfg.n_layers} of {pub.n_layers} (cut: "
          f"AdamW's fp32 moments of all {pub.n_params() / 1e9:.2f} B "
          f"parameters take {8 * pub.n_params() / 1e9:.0f} GB) d="
          f"{cfg.d_model} H={cfg.n_heads}/{cfg.n_kv_heads} hd={cfg.hd} "
          f"ff={cfg.d_ff} V={cfg.vocab} {cfg.dtype}, "
          f"{cfg.n_params() / 1e9:.3f} B parameters; {dc.global_batch} x "
          f"{dc.seq_len} tokens a step, AdamW lr {oc.lr} warmup "
          f"{oc.warmup_steps} cosine over {oc.total_steps}, remat none")
    lines, stamps = [], []

    def log(line):
        stamps.append(time.perf_counter())
        lines.append(line)

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _counts(zero=True)
    t0 = time.perf_counter()
    fit(cfg, dc, oc, TrainConfig(steps=TRAIN_STEPS, log_every=1), log=log,
        device=dev)
    torch.cuda.synchronize()
    launches = _counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    vals = [(float(ln.split()[3]), float(ln.split()[5])) for ln in lines]
    _check(len(vals) == TRAIN_STEPS and all(
        math.isfinite(a) and math.isfinite(b) for a, b in vals),
        f"train: losses and gnorms {vals} not all finite")
    want = {k: 0 for k in launches}
    want["flash_attention"] = want["flash_attention_bwd"] = \
        cfg.n_layers * TRAIN_STEPS
    _check(launches == want, f"train: launches {launches}; want {want} (8 "
           f"flash forward and 8 backward a step)")
    times = [b - a for a, b in zip([t0] + stamps, stamps)]
    steady = sorted(times[1:])
    step_ms = steady[len(steady) // 2] * 1e3
    print(f"train {TRAIN_ARCH}: {TRAIN_STEPS} steps, loss by step "
          f"{[a for a, _ in vals]}, gnorm {[b for _, b in vals]}; step "
          f"median {step_ms:.1f} ms (steps 2-{TRAIN_STEPS}; all "
          f"{[round(x * 1e3, 1) for x in times]} ms, the first with init), "
          f"{dc.global_batch * dc.seq_len / step_ms * 1e3:.0f} tokens/s; "
          f"peak device memory {peak:.2f} GiB; launches "
          f"{json.dumps({k: v for k, v in launches.items() if v})} "
          f"({launches['flash_attention'] // TRAIN_STEPS} forward and "
          f"{launches['flash_attention_bwd'] // TRAIN_STEPS} backward a "
          f"step); card {_card_line()}")
    gc.collect()
    torch.cuda.empty_cache()
    return launches["flash_attention"], launches["flash_attention_bwd"]


def train_resume(torch, dev, tmp):
    """14(b), resume: at published widths on ``TRAIN_RESUME_LAYERS`` of
    32 layers (a chip call may write 45 GiB to its disk, and one
    checkpoint of the 8-layer run, parameters and fp32 moments, is 28
    GB), ``fit`` of 3 steps with a checkpoint in ``tmp``, then
    ``fit(resume=True)`` to 6: its final loss and the sha256 of every
    parameter and moment leaf of its step-6 checkpoint equal those of 6
    uninterrupted steps of the same ``make_train_step`` from the same
    seed and batches, hashed in memory.  Prints the seconds of the two
    runs (two checkpoint writes and a restore)."""
    import shutil

    from repro_torch.ckpt.manager import CheckpointManager, _digest
    from repro_torch.data.pipeline import device_batch
    from repro_torch.models import init_params
    from repro_torch.train.loop import TrainConfig, fit, make_train_step
    from repro_torch.train.optimizer import init_opt_state

    pub, _, dc, oc = _train_configs()
    cfg = dataclasses.replace(pub, n_layers=TRAIN_RESUME_LAYERS)
    d = tmp / "resume"
    t0 = time.perf_counter()
    tc = TrainConfig(steps=TRAIN_RESUME_AT, ckpt_dir=str(d), ckpt_every=100,
                     log_every=100)
    fit(cfg, dc, oc, tc, log=lambda s: None, device=dev)
    t1 = time.perf_counter()
    lines = []
    m_res = fit(cfg, dc, oc, dataclasses.replace(tc, steps=TRAIN_STEPS),
                log=lines.append, device=dev)
    t2 = time.perf_counter()
    _check(lines[0] == f"[ckpt] resumed from step {TRAIN_RESUME_AT}",
           f"train resume: the resumed run logged {lines[:1]}")
    hashes = _manifest_hashes(d, TRAIN_STEPS)
    nbytes = sum(f.stat().st_size for f in (d / f"step_{TRAIN_STEPS:08d}")
                 .iterdir())
    shutil.rmtree(d)
    gc.collect()
    torch.cuda.empty_cache()
    params = init_params(cfg, dev, seed=0)
    opt = init_opt_state(params)
    step = make_train_step(cfg, oc, TrainConfig())
    for it in range(TRAIN_STEPS):
        params, opt, _, m = step(params, opt, None, device_batch(dc, it, dev))
    straight = {k: _digest(arr) for k, (arr, _) in CheckpointManager
                ._snapshot({"params": params, "opt": opt}).items()}
    loss = float(m["loss"])
    del params, opt, m
    gc.collect()
    torch.cuda.empty_cache()
    _check(m_res["loss"] == loss and hashes == straight,
           f"train resume: {TRAIN_RESUME_AT} steps + resume to {TRAIN_STEPS} "
           f"gave loss {m_res['loss']} against {loss} uninterrupted; every "
           f"leaf's hash equal: {hashes == straight}")
    print(f"train resume: {TRAIN_ARCH} at published widths on "
          f"{TRAIN_RESUME_LAYERS} of {pub.n_layers} layers "
          f"({cfg.n_params() / 1e9:.3f} B parameters, a {nbytes / 1e9:.1f} "
          f"GB checkpoint): {TRAIN_RESUME_AT} steps then fit(resume=True) "
          f"to {TRAIN_STEPS}: final loss {m_res['loss']!r} equals 6 "
          f"uninterrupted steps' {loss!r}, and all {len(hashes)} parameter "
          f"and moment leaves hash the same; the runs {t1 - t0:.1f} s and "
          f"{t2 - t1:.1f} s (each writes a checkpoint; the second restores "
          f"one)")


def train_grads_vs_plain(torch, dev):
    """14(b), the kernels inside the model: one batch's gradients (4 x
    1024 tokens) of the training config on 2 layers, the reference's init
    scale, through flash (forward and backward kernels) against plain
    attention (``attention._sdpa`` with the mask, differentiated by
    autograd), both on the card.  fp32: losses within 1e-6 relative,
    gnorms within 1e-4 relative, every gradient leaf within 1e-3 of its
    max |value| (fp32 sums in other orders through nearly one-hot
    attention: scores of std ~200 at this scale).  bf16: each path's
    gnorm printed beside fp32's."""
    from repro_torch.data.pipeline import device_batch
    from repro_torch.models import attention, init_params
    from repro_torch.train.loop import TrainConfig, grads_of
    from repro_torch.train.optimizer import global_norm, leaves

    pub, _, dc, _ = _train_configs()
    batch = device_batch(dc, 0, dev)
    flash = attention.sdpa_auto

    def plain(q, k, v, *, causal, window=0, q_offset=0):
        mask = attention.make_mask(q.shape[1], k.shape[1], causal=causal,
                                   window=window, q_offset=q_offset,
                                   device=q.device)
        return attention._sdpa(q, k, v, mask)

    out = {}
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(pub, n_layers=2, dtype=dtype)
        params = init_params(cfg, dev, seed=1)
        for name, fn in (("flash", flash), ("plain", plain)):
            attention.sdpa_auto = fn
            try:
                loss, _, g = grads_of(cfg, TrainConfig(), params, batch)
            finally:
                attention.sdpa_auto = flash
            out[dtype, name] = (float(loss), float(global_norm(g)), g)
        del params
    (lf, nf, gf), (lp, np_, gp) = out["float32", "flash"], \
        out["float32", "plain"]
    worst = max(((a - b).abs().max() / b.abs().max()).item()
                for a, b in zip(leaves(gf), leaves(gp)))
    _check(abs(lf - lp) <= 1e-6 * abs(lp) and abs(nf - np_) <= 1e-4 * np_
           and worst <= 1e-3,
           f"train grads: flash against plain attention, fp32: loss {lf} / "
           f"{lp}, gnorm {nf} / {np_}, worst leaf {worst:.3e} of its max")
    bf = {name: out["bfloat16", name][1] for name in ("flash", "plain")}
    print(f"train grads: {TRAIN_ARCH} at published widths on 2 layers, the "
          f"reference's init scale, one batch: fp32 through flash against "
          f"plain attention: loss {lf!r} / {lp!r}, gnorm {nf:.6f} / "
          f"{np_:.6f}, every leaf within {worst:.2e} of its max (tol "
          f"1e-3); bf16 gnorm flash {bf['flash']:.3f}, plain "
          f"{bf['plain']:.3f} (fp32 {nf:.3f})")
    del out, gf, gp
    gc.collect()
    torch.cuda.empty_cache()


def train_remat_and_profile(torch, dev):
    """14(b), continued.  Remat: the gradients of one batch with remat
    "full" against "none", from the same weights: the same loss, every
    leaf within 1e-2 of its max |value|.  Then two ``make_train_step``
    steps (after a warm-up step) under ``torch.profiler``: launches and
    device time a step, the device's idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data.pipeline import device_batch
    from repro_torch.models import init_params
    from repro_torch.train.loop import TrainConfig, grads_of, make_train_step
    from repro_torch.train.optimizer import init_opt_state, leaves

    _, cfg, dc, oc = _train_configs()
    params = init_params(cfg, dev, seed=1)
    batch = device_batch(dc, 0, dev)
    l_none, _, g_none = grads_of(cfg, TrainConfig(), params, batch)
    l_full, _, g_full = grads_of(cfg, TrainConfig(remat="full"), params,
                                 batch)
    worst = max(((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp_min(1e-30)).item()
                for a, b in zip(leaves(g_full), leaves(g_none)))
    _check(bool(l_full == l_none) and worst <= 1e-2,
           f"train remat: full gives loss {float(l_full)} against "
           f"{float(l_none)} and grads {worst:.3e} of their max apart")
    print(f"train remat: one step's gradients with remat full against none "
          f"at {TRAIN_ARCH}'s {cfg.n_layers}-layer config: loss "
          f"{float(l_none):.6f} equal; every leaf within {worst:.2e} of its "
          f"max |value| (tol 1e-2)")
    del g_none, g_full
    torch.cuda.empty_cache()
    opt = init_opt_state(params)
    step = make_train_step(cfg, oc, TrainConfig())
    params, opt, _, m = step(params, opt, None, device_batch(dc, 1, dev))
    float(m["loss"])
    batches = [device_batch(dc, 2 + i, dev) for i in range(2)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches:
            params, opt, _, m = step(params, opt, None, b)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    launches = sum(e.count for e in prof.key_averages()
                   if "LaunchKernel" in e.key) / 2
    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA) / 1e3 / 2
    print(f"train profile: 2 make_train_step steps under torch.profiler: "
          f"{launches:.0f} kernel launches and {busy:.1f} ms of device time "
          f"a step against {wall / 2:.1f} ms of wall time (profiled): the "
          f"device idle {100 * (1 - busy / (wall / 2)):.1f} %; loss "
          f"{float(m['loss']):.4f}")
    del params, opt, batches, m
    gc.collect()
    torch.cuda.empty_cache()


def train_launcher():
    """14(c): the launcher as a subprocess on the card, exit code 0."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "llama3-8b", "--smoke", "--steps", "4"]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=600)
    _check(out.returncode == 0, f"train launcher exited {out.returncode}:\n"
           f"{out.stdout[-2000:]}\n{out.stderr[-2000:]}")
    last = out.stdout.strip().splitlines()[-1]
    print(f"train launcher: {' '.join(cmd[1:])} exited 0 in "
          f"{time.perf_counter() - t0:.1f} s; {last}")


def train_phase(torch, dev, rows, launches):
    """Phase 14: the forward at the training shape (a row under flash's
    ``shapes``), the backward's gates and times (row added to the kernels
    line), the training run with resume, remat and the profile, and the
    launcher."""
    import tempfile

    t0 = time.perf_counter()
    fwd_row = flash_train_fwd_row(torch, dev, rows["flash_attention"])
    rows["flash_attention"]["shapes"].append(fwd_row)
    rows["flash_attention_bwd"] = flash_bwd_rows(torch, dev)
    fwd_row["launches"], launches["flash_attention_bwd"] = train_run(torch,
                                                                     dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        train_resume(torch, dev, Path(tmp))
    train_grads_vs_plain(torch, dev)
    train_remat_and_profile(torch, dev)
    train_launcher()
    print(f"train: phase 14 took {time.perf_counter() - t0:.1f} s")


def main():
    if not (ROOT / "src" / "repro_torch").is_dir():
        _fail("src/repro_torch not found beside chip_smoke.py")
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false")
    dev = torch.device("cuda", 0)
    card = _card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    print(f"device: {torch.cuda.get_device_name(0)} ({card}); torch "
          f"{torch.__version__} cuda {torch.version.cuda}; TF32 off for "
          f"matmul and cuDNN")

    from repro_torch.kernels import _build
    secs = _build.build_all()
    print(f"build: {len(_build.SOURCES)} kernel libraries in {secs:.1f} s "
          f"(nvcc, sm_90a, one process per source)")
    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"build: {name}: {line.strip()}")

    rows = kernel_phase(torch, dev)
    cfg, params = main_model(torch, dev)
    launches = main_path_phase(torch, dev, cfg, params)
    dense_tiered_phase(torch, dev)
    launches.update(server_phase(torch, dev))
    launches.update(chunked_qos_phase(torch, dev, cfg, params))
    chunk_equivalence_phase(torch, dev, cfg, params)
    telemetry_phase(torch, dev, cfg, params)
    del params
    torch.cuda.empty_cache()
    rows["sim_scan"], launches["sim_scan"] = sim_phase(torch, dev)
    families_phase(torch, dev, rows)
    recurrent_phase(torch, dev, rows)
    vlm_audio_phase(torch, dev, rows)
    gc.collect()
    torch.cuda.empty_cache()
    train_phase(torch, dev, rows, launches)
    for name, n in launches.items():
        rows[name]["launches"] = n
    print(json.dumps({"kernels": [rows[k] for k in sorted(rows)]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
