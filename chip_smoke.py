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
   one-shot prefill runs the flash kernel; its decode step per live-page
   bucket, maintenance plan and apply replay CUDA graphs captured at
   their first call); launch counts are reset just before the run and
   read just after (the wrappers book a replay's launches), one
   copy-engine launch per maintenance pass; tokens/s, step times and the
   wall time by engine phase, timed around the engine's own step, plan
   and apply.
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
   step with no host wait.  Each path runs eager (``graphs=False``) and
   captured (its step and ``maintain()`` replayed as CUDA graphs): every
   output, the counters and launch counts equal bit for bit; steps/s of
   both; a captured pass is one ``cudaGraphLaunch``.
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
   the endpoints answering 200; tokens/s, ms per engine step, launch
   calls per loop iteration (``cudaLaunchKernel`` and
   ``cudaGraphLaunch``), host waits per step and maintenance ms per
   pass, off against on (with the flight recorder on, the apply runs
   eagerly).
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
   time of a decode step (``torch.profiler``: host launch calls, kernels
   or graphs), launches per kind and, for granite, the routed choices
   dropped for capacity (counted on the card, so replays count); each
   then dense
   against tiered on 2 layers in fp32 as phase 5.  mixtral-8x22b at full
   width on 2 of its 56 layers, fp32, dense backend: a 4,600-token
   prompt through flash with the 4096-token window, 16 teacher-forced
   decode steps each within 1e-3 of the one-shot forward, and a window-0
   control that matches its own forward and differs from the windowed
   one; then the ring (``REPRO_WINDOW_CACHE=1``): a 4,080-token
   ``prefill`` into a ring of 4,096 slots and 32 decode steps across
   position 4,096, each within 1e-3 of the one-shot forward.
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
15. the compiled serving steps (runs right after phase 4, before any
   ``torch.profiler`` session): (a) phase 4's workload served by two
   engines, eager (``graphs=False``) and captured
   (``serve.decode.StepGraphs``: the decode step per live-page bucket,
   the plan, the apply, the one-shot prefill per padded length, the
   release), in two interleaved pairs, eager then captured, twice: the
   first pair times the engine's steps synchronised, the second runs
   clean; (b) phase 7's chunked + two-tenant run (the chunk forward and
   write, the admission, the multi-tenant pass and the release
   captured), timed and clean; (e) a flight-recorded pair (phase 9's
   engine, recorder on: the recorded apply and release captured) and
   (c) granite-moe-3b on phase 11's store, eager against captured; (d)
   a third pair of (a)'s engines with a profiled window of loop
   iterations, the captured one with its eager call sites labelled,
   then a third pair of (b)'s with a profiled window.  Gates, every
   run: token streams, counters, the wrappers' launch counts, every
   state leaf and the flight ring equal bit for bit; every captured
   engine captures nothing after its first run, and (a)'s decodes the
   same tokens every run; in the captured profiled windows no
   hand-written kernel goes out through ``cudaLaunchKernel`` (joined on
   CUPTI correlation ids; the eager windows are the control).  Prints,
   eager and captured, tokens/s, decode step p50 and p90, maintenance
   ms a pass, prefill, chunk forward, chunk write, multi-tenant pass,
   admission and release ms (a call that captured apart),
   ``cudaLaunchKernel`` and ``cudaGraphLaunch`` calls, device ops and
   busy ms a loop iteration, the device's idle share, the
   ``cudaLaunchKernel`` calls left by call site, the graph keys,
   capture seconds and the graph pool's bytes, and the chunk K/V bytes
   copied a chunk.  Each pair of engines is then dropped with Python's
   cyclic collector off: every engine is gone and the reserved device
   memory falls (reference counting alone frees an engine's graphs,
   graph pool and KV pools).
16. sharding (after phase 14), on a one-rank NCCL group over the (1, 1)
   ("data", "model") mesh of ``launch.mesh.make_host_mesh(1)``, through
   the tensor-parallel path of the dense family (every part split over
   the one "model" rank, each layer's pieces taken inside the layer
   loop): (a) the sharded train step (parameters and moments as DTensors
   by the reference's specs, the data mean scattered onto the shards)
   against ``make_train_step`` under ``REPRO_SHARDED_CE=1`` (the split
   step's loss takes that form) at 14(b)'s llama3-8b shape (8 of 32
   layers, bf16, 4 x 1024 tokens), 3 steps each from the same
   parameters and batches: losses, gnorms and final parameters bit for
   bit, 8 flash forward and 8 backward launches a step in both; ms a step
   and peak memory of both; (b) ``jit_prefill`` of 2 x 256 tokens and 8
   greedy ``jit_decode`` steps at the same widths against ``prefill``
   (the last position unembedded alone, as ``make_prefill_fn`` does) and
   ``decode_step``: logits and tokens bit for bit; (c)
   ``dp_mean_compressed`` through NCCL against its plain single-process
   result, bit for bit; (d) the hybrid family on the split path:
   hymba-1.5b at published widths on 4 of 32 layers (layers 0-3, a
   global layer among them; its Mamba branch on the one rank's channels,
   ``in_proj``'s x and z columns), through (a)'s training run under
   ``REPRO_SHARDED_CE=1`` against ``make_train_step`` and (b)'s served
   run against ``prefill`` (the reference's cold state) and
   ``decode_step``, bit for bit; (e) the MoE family on
   the split path: granite-moe-3b-a800m at published widths on 4 of 32
   layers (every expert local to the one rank, every dispatch offset
   0), (a)'s training run under ``REPRO_SHARDED_CE=1`` and (b)'s served
   run, bit for bit; (f) the vlm and the
   audio encoder on the split path: llama-3.2-vision-90b at published
   widths on one super-block (4 self layers and 1 cross layer, its gate
   at 0.5, 1,601 seeded image tokens), (b)'s served run (flash once a
   layer in the prefill and once a cross layer a decode step), and
   hubert-xlarge at published widths on 4 of 48 layers, (a)'s training run
   on seeded frame embeddings, each bit for bit; (g) the ssm family on the
   split path: xlstm-125m at published widths on 4 of 12 layers (layer 3
   sLSTM, the others mLSTM), (a)'s training run and (b)'s served run, bit
   for bit, no flash launched.
17. one rank's share of qwen2-72b on a (1, 4) mesh (after phase 16):
   rank 0 of a 4-rank group of ``torch.distributed``'s fake backend
   (``FakeStore``: every collective returns at once and moves nothing,
   so no value is compared and no time includes communication), the
   parameters made by ``init_sharded_params`` on the card (published
   widths, all 80 layers, QKV bias, bf16), a ``jit_prefill`` of 8 x 2048
   tokens into caches padded to 4096 positions, then 32 ``jit_decode``
   steps.  Prints the rank's peak memory (and by stage: the draw, the
   prefill, the decode steps), parameter and cache bytes,
   prefill ms, decode ms p50 and p90 and flash launches (one a layer in
   the prefill, at 16 of the 64 query heads over 2 of the 8 KV heads),
   and the collectives a decode step would run on four cards (their
   count and bytes, recorded at dispatch); then flash at the rank's
   prefill shape, checked and timed as phase 3's rows.
18. one rank's share of mixtral-8x22b on a (1, 4) mesh (after phase 17,
   whose memory is freed first), as phase 17 on a fake 4-rank group,
   with ``REPRO_WINDOW_CACHE=1``: ``init_sharded_params`` on the card
   (published widths, all 56 layers, bf16, 2 of the 8 experts a rank),
   a ``jit_prefill`` of 4 x 4,032 tokens into a ring of 4,096 slots
   (1,024 a rank), then 128 ``jit_decode`` steps (the ring wraps at
   step 64).  Prints peak memory by stage (the draw, the prefill, the
   decode), parameter (expert) and cache bytes, prefill ms, decode p50
   and p90 against the weight bound, flash launches (one a layer in the
   prefill, H 12/2 a rank), the expert rows computed a layer, and the
   collectives a decode step would run on four cards; then flash at the
   rank's prefill shape (window 4,096), checked and timed as phase 3's
   rows.
19. one rank's share of llama-3.2-vision-90b on a (1, 4) mesh (after
   phase 18, whose memory is freed first), as phase 17 on a fake 4-rank
   group: ``init_sharded_params`` on the card (published widths, all
   100 layers: 20 super-blocks of 4 self layers and 1 gated cross
   layer, bf16, the gates at 0.5), a ``jit_prefill`` of 4 x 2,048
   tokens over 1,601 seeded bf16 image tokens into caches padded to
   4,096 positions, then 32 ``jit_decode`` steps.  Gates: every part
   split, the self cache piece [20, 4, 4, 1024, 8, 128], the image K/V
   whole over "model" [20, 4, 1601, 8, 128], flash 100 times in the
   prefill (80 self, 20 cross) and 20 times a decode step (the cross
   layers), 441 collectives a decode step on "model" (5 a self layer, 2
   a cross layer, 1 for the embedding) and none on another group.
   Prints peak memory by stage, parameter and cache bytes, prefill ms,
   decode p50 and p90 against the bound of reading the rank's weights
   and caches once; then flash at the rank's self prefill, cross
   prefill and cross decode shapes (H 16/2), checked and timed as phase
   3's rows.
20. one rank's share of each recurrent family on a (1, 4) mesh (after
   phase 19, whose memory is freed first), as phase 17 on a fake 4-rank
   group: hymba-1.5b (``init_sharded_params`` on the card, published
   widths, all 32 layers, bf16), a ``jit_prefill`` of 2 x 2,048 tokens
   into caches of 4,096 positions, then 64 ``jit_decode`` steps from the
   reference's cold state (``pos`` 0, caches zero: only rank 0's quarter
   of the sequence-sharded cache is written, the other ranks' all-masked
   pieces weigh 0 in the lse merge).  Gates: the Mamba pieces hold 400
   of the 1,600 channels and the scan takes the x and z columns of the
   rank's channels ([0, 400) and [1600, 2000) on rank 0); attention (25
   heads over 5 KV heads) and the 32,001-row vocabulary run whole, one
   warning a step builder; the MLP piece holds 1,376 of 5,504 columns;
   flash 32 times in the prefill; a decode step runs on "model" the
   collectives ``tests/test_torch_split_recurrent.py`` counts (7 a layer
   here: the lse's max and merge, the gather of ``in_proj``'s products with
   each rank's piece, dt/B/C's and ``out_proj``'s sums, the state's gather,
   the MLP's sum) and none on another group.  Then the same for xlstm-125m:
   a head of 4 a rank, all 12 layers, prefill 2 x 2,048, 64 steps, 2
   collectives a layer and the embedding's.  Prints for each peak memory by
   stage, parameter and state bytes, prefill ms, decode p50 and p90; then
   flash at hymba's rank prefill shape (its whole H 25/5, window 1,024),
   checked and timed as phase 3's rows, and at PR 19's B 1 row shape beside
   that row's time.
21. the dry run (``repro_torch.launch.dryrun``) against the card: (a)
   each rank share of phases 17-20 reckoned by ``run_step`` on fake
   "cuda" tensors (``FakeTensorMode``) over a fake (1, 4) group, at the
   same shapes (its prefill, then one decode step), and held against
   what those phases measured: parameter and cache bytes equal to the
   byte; the prefill's collectives on "model" by kind, count and largest
   tensor equal; a decode step's collectives on "model" equal (401, 337,
   441, 224, 25); flash's fake calls equal to its launches (prefill and
   a decode step); each reckoned stage peak (the step's arguments plus
   its temporaries at dispatch, 512-byte blocks) within 3 % (at least
   16 MiB) of the measured prefill and decode stage peaks, in bytes;
   (b) ``run_cell`` on the 16x16 production mesh (256 fake ranks) for
   one cell a family: llama3-8b train_4k, mixtral-8x22b decode_32k,
   llama-3.2-vision-90b prefill_32k, hymba-1.5b long_500k and
   hubert-xlarge train_4k, each ``status`` "ok", printed with its peak,
   ``fits``, FLOPs, bytes, collective bytes and dominant roofline term.
   Then one line of every phase's host seconds.

Output, in order: phase lines, one JSON ``kernels`` line (launches: the
main path's for paged_attention_fused, remap_gather (every launch of the
copy engine, whose two entries share one copy body) and remap_replay,
the cached zero-copy server run's for irt_lookup (every launch of the
walk, whose two entries share one body), irt_walk2 and
paged_attention_split, the concat server run's for paged_attention, the
chunked run's for flash_attention, the Figure 7 sweep's for sim_scan,
phase 14's training run's for flash_attention_bwd and for flash's row
at the training shape; a row at another family's shape counts phase
11's, 12's or 13's run of that family, and flash's row at qwen2-72b's
rank shape phase 17's prefill, at mixtral-8x22b's phase 18's and at
the vlm's rank shapes phase 19's prefill and decode, at hymba's rank
shape phase 20's prefill),
the card's name and power limit as
nvidia-smi reports them, and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
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


FLASH_HOST_CALLS = 2000


def _flash_host_cost(torch, dev, fa_ops) -> dict:
    """Host microseconds a call of flash's forward through its operator
    (``torch.ops.repro_torch.flash_fwd``, what the model calls) and of
    the launch it wraps (``ops._launch``), at a shape whose kernel takes
    a few microseconds (B 1, S = T = 16, H 1, hd 64, bf16):
    ``FLASH_HOST_CALLS`` calls queued, then one synchronise, in the order
    op, launch, op, launch; the faster block of each."""
    q = torch.randn(1, 16, 1, 64, device=dev).to(torch.bfloat16)
    fns = {"op": lambda: torch.ops.repro_torch.flash_fwd.default(
               q, q, q, True, 0, 0),
           "launch": lambda: fa_ops._launch(q, q, q, True, 0, 0, False)}
    times = {k: [] for k in fns}
    for _ in range(2):
        for name, fn in fns.items():
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(FLASH_HOST_CALLS):
                fn()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) / FLASH_HOST_CALLS
                               * 1e6)
    out = {k: round(sorted(v)[0], 2) for k, v in times.items()}
    out["added"] = round(out["op"] - out["launch"], 2)
    print(f"kernel flash_attention host cost a call: through the operator "
          f"{out['op']} us, the bare launch {out['launch']} us "
          f"(the faster of two blocks of {FLASH_HOST_CALLS} calls each; all "
          f"{json.dumps(times)}); card {_card_line()}")
    return out


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
    host_us = _flash_host_cost(torch, dev, fa_ops)
    torch.cuda.empty_cache()
    row = dict(name="flash_attention", route="cuda",
               source="src/repro_torch/kernels/flash_attention/csrc/"
                      "flash_attention.cu",
               replaces="src/repro/kernels/flash_attention/flash_attention.py"
                        ":70", **res["chunk"])
    row["one_shot"] = res["one-shot"]
    row["op_host_us"] = host_us
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

    eng = main_path_engine(torch, dev, cfg, params)
    spent: dict = {}              # phase -> host ms of each synchronised call

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

    # the engine's own steps (captured graphs, replayed)
    eng._decode = timed("decode step", eng._decode)
    eng.prefill_lane = timed("prefill", eng.prefill_lane)
    eng._plan = timed("maintenance plan", eng._plan)
    eng._apply = timed("maintenance apply", eng._apply)
    eng._release = timed("release", eng._release)
    torch.cuda.reset_peak_memory_stats()
    pa_ops.launches = 0
    rg_ops.launches = rg_ops.replay_launches = 0
    fa_ops.launches = 0
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
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
          f"{prefill_flash} (the one-shot prefills); captured steps "
          f"{sorted(map(str, eng.graphs.graphs))}, graph pool "
          f"{eng.graphs.pool_bytes / 2**20:.1f} MiB")
    totals = {k: v for k, v in c.items() if not k.startswith("epoch_")}
    print(f"main: counters {json.dumps(totals)}")
    print(f"main: peak device memory {peak / 2**30:.2f} GiB "
          f"(torch.cuda.max_memory_allocated)")
    del eng
    gc.collect()
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
    gc.collect()
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


def make_server(torch, dev, tcfg, path, graphs=None):
    """A ``TieredServer`` whose slow pools hold seeded bytes (the same for
    every path); ``graphs`` False: the eager steps."""
    from repro_torch.serve.engine import TieredServer
    srv = TieredServer(tcfg, path=path, device=dev, graphs=graphs)
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    for pool in (srv.state.slow_k, srv.state.slow_v):
        pool.copy_(torch.randn(pool.shape, generator=g, device=dev))
    return srv


def _launch_calls(prof) -> dict:
    """The host's runtime calls that launch work in a profiled window
    (``cudaLaunchKernel`` and its variants; ``cudaGraphLaunch``) and the
    kernels and copies the device ran, with their device ms (a label's
    span on the device timeline is no device work)."""
    from torch.autograd import DeviceType
    keys = prof.key_averages()
    dev_events = [e for e in prof.events()       # not phase 15's labels
                  if e.device_type == DeviceType.CUDA
                  and not e.name.startswith("site ")]
    return {"kernel_launches": sum(e.count for e in keys
                                   if "LaunchKernel" in e.key),
            "graph_launches": sum(e.count for e in keys
                                  if "GraphLaunch" in e.key),
            "device_ops": len(dev_events),
            "device_ms": sum(e.time_range.elapsed_us()
                             for e in dev_events) / 1e3}


def server_run(torch, dev, path, cached, inputs, *, check_waits=False,
               count_pass=False, graphs=None):
    """One ``TieredServer`` run over the seeded inputs: 64 steps,
    ``maintain()`` every 4 steps, lane 0 released before step 32 and
    restarted at position 0; captured steps unless ``graphs`` is False.
    Launch counts are reset just before the run and read just after.
    ``count_pass``: after the run, one more ``maintain()`` under the
    profiler, counting the host's launch calls and the device's ops."""
    import dataclasses as dc

    from repro_torch.core.remap.irt import INVALID
    from repro_torch.kernels.irt_lookup import ops as irt_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.remap_gather import ops as rg_ops

    tcfg = dc.replace(inputs["tcfg"], cache_device_table=cached)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    srv = make_server(torch, dev, tcfg, path, graphs)
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
        # a captured step's output is its graph's buffer: keep a copy
        outs.append(out.reshape(inputs["q"][i].shape).clone())
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
        pass_launches = _launch_calls(prof)
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
               pass_launches=pass_launches,
               captured=sorted(srv.graphs.graphs) if srv.graphs.enabled
               else None)
    del srv
    gc.collect()
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
    runs, eager = {}, {}
    for label, path, cached in SERVER_PATHS:
        eager[label] = server_run(torch, dev, path, cached, inputs,
                                  count_pass=label == "zero_copy",
                                  graphs=False)
        runs[label] = res = server_run(torch, dev, path, cached, inputs,
                                       check_waits=label == "zero_copy",
                                       count_pass=label == "zero_copy")
        e = eager[label]
        for i in range(SERVER_STEPS):
            _check(torch.equal(res["outs"][i], e["outs"][i]),
                   f"server {label} step {i}: captured differs from eager")
        _check(res["counters"] == e["counters"]
               and res["launches"] == e["launches"]
               and res["captured"] == ["maintain", "release", "step"],
               f"server {label}: captured counters {res['counters']}, "
               f"launches {res['launches']}, graphs {res['captured']} "
               f"against eager {e['counters']}, {e['launches']}")
        n = SERVER_STEPS
        sm = res["step_ms"]
        c = res["counters"]
        print(f"server {label}: captured == eager bit for bit (every output"
              f", counters, launch counts); eager {n / e['wall']:.1f} "
              f"steps/s, synchronised step median "
              f"{e['step_ms'][n // 2]:.3f} ms, maintain "
              f"{sum(e['maint_ms']) / len(e['maint_ms']):.3f} ms; captured:")
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
    ep, cp = eager["zero_copy"]["pass_launches"], zc["pass_launches"]
    _check(cp["graph_launches"] == 1 and cp["device_ops"] > 0,
           f"server: a captured maintain() pass made {cp}")
    print(f"server: one copy-engine launch per maintain() pass on every "
          f"path; a zero_copy maintain() pass (torch.profiler): eager "
          f"{ep['kernel_launches']} kernel launches, {ep['device_ops']} "
          f"device ops, {ep['device_ms']:.3f} device ms; captured "
          f"{cp['graph_launches']} graph launch and "
          f"{cp['kernel_launches']} kernel launches on the host, "
          f"{cp['device_ops']} device ops, {cp['device_ms']:.3f} device ms")
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

def chunked_requests(cfg):
    """Phase 7's 16 seeded requests, (prompt, max_new, tenant) each:
    prompts 200-1900 tokens, max_new 32-64, tenants alternating."""
    import numpy as np
    rng = np.random.default_rng(7)
    return [(rng.integers(0, cfg.vocab, int(rng.integers(200, 1901))),
             int(rng.integers(32, 65)), ("interactive", "batch")[i % 2])
            for i in range(16)]


def chunked_engine(cfg, params, dev, graphs=None, submit=True):
    """Phase 7's engine with its 16 requests submitted (``submit``):
    256-token chunks, two tenants (interactive: weight 2, on-demand;
    batch: weight 1), prompts 200-1900 tokens, max_new 32-64."""
    from repro_torch.serve.engine import Engine, EngineConfig, Request
    from repro_torch.serve.sched import TenantConfig

    ec = EngineConfig(batch=8, max_len=2048, backend="tiered",
                      page_tokens=16, fast_data_slots=128, maintain_every=4,
                      scheduler="chunked", prefill_chunk=256, admit_pages=2,
                      tenants=(TenantConfig("interactive", weight=2,
                                            policy="on_demand"),
                               TenantConfig("batch", weight=1)))
    eng = Engine(cfg, params, ec, device=dev, graphs=graphs)
    for i, (prompt, max_new, tenant) in enumerate(
            chunked_requests(cfg) if submit else ()):
        eng.submit(Request(rid=i, prompt=prompt, max_new=max_new,
                           tenant_id=tenant))
    return eng


def chunked_qos_phase(torch, dev, cfg, params):
    """Phase 4's weights served by the chunked scheduler with two
    tenants: 256-token chunks, one per engine step; the interactive
    tenant (weight 2, on-demand decider) admits its prompts' first two
    pages straight into the fast pool; maintenance runs the per-tenant
    pass.  16 seeded requests alternate tenants, prompts 200-1900 tokens
    (padded lengths <= 2048: 1-8 chunks each), max_new 32-64."""
    from repro_torch.core.remap.irt import INVALID
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.remap_gather import ops as rg_ops

    eng = chunked_engine(cfg, params, dev)
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

    # the engine's own steps (captured graphs, replayed)
    eng._decode = timed("decode step", eng._decode)
    eng.chunk_forward = timed("chunk forward", eng.chunk_forward)
    eng.write_chunk = timed("chunk write", eng.write_chunk)
    eng.admit_fast = timed("admission", eng.admit_fast)
    eng.prefill_lane = timed("one-shot prefill", eng.prefill_lane)
    eng._tenant_pass = timed("maintenance", eng._tenant_pass)
    eng._release = timed("release", eng._release)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa_ops.launches = pa_ops.launches = rg_ops.launches = 0
    rg_ops.replay_launches = 0
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
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
    gc.collect()
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


def demoting_engine(cfg, params, dev, graphs=None, **ec_kw):
    """Phase 4's engine and store under write_aware with
    ``TELEMETRY_POLICY`` (phases 9 and 15(e)); ``ec_kw``: the telemetry
    fields of ``EngineConfig``."""
    from repro_torch.core.policy import get_policy
    from repro_torch.models.kv_backend import TieredBackend
    from repro_torch.serve.engine import Engine, EngineConfig
    ec = EngineConfig(**MAIN_EC, **ec_kw)
    backend = TieredBackend(
        cfg, ec.batch, ec.max_len, page_tokens=ec.page_tokens,
        fast_data_slots=ec.fast_data_slots,
        policy=get_policy("write_aware", **TELEMETRY_POLICY), device=dev)
    return Engine(cfg, params, ec, backend=backend, device=dev,
                  graphs=graphs)


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

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.remap_gather import ops as rg_ops
    from repro_torch.obs import FlightConfig, ObsConfig, parse_slos
    from repro_torch.serve.engine import Request

    tel = {}
    if telemetry:
        tel = dict(obs=ObsConfig(sample_every=4,
                                 prom_path=str(tmp / "metrics.prom"),
                                 jsonl_path=str(tmp / "metrics.jsonl"),
                                 trace_path=str(tmp / "trace.json"),
                                 http_port=0),
                   flight=FlightConfig(capacity=4096),
                   slos=parse_slos("*:latency:60000:0.9:64"))
    eng = demoting_engine(cfg, params, dev, **tel)
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
    real_step = eng._decode          # the engine's step: a captured graph
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

    plan, flush, prefill = (eng._plan, eng._flush_maintain,
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

    eng._plan = timed_plan
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
    eng._decode = step
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
    # the host's launch calls: kernels launched one by one and replays of
    # captured steps (one cudaGraphLaunch each)
    calls = _launch_calls(prof)
    book["launches"] = (calls["kernel_launches"]
                        + calls["graph_launches"]) / count
    book["graph_launches"] = calls["graph_launches"] / count
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
            f"{bk['launches']:.1f} launch calls per step "
            f"({bk['graph_launches']:.1f} of them graph launches), "
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
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 15: the compiled serving steps, captured against eager
# ---------------------------------------------------------------------------

# the clean runs' profiled loop iterations (first, count): two maintenance
# plans and two applies fall in them
GRAPHS_WINDOW = (40, 8)
# the chunked run's profiled loop iterations: eight chunk forwards and
# writes and two multi-tenant passes fall in them
CHUNKED_WINDOW = (8, 8)
# the hand-written kernels' device names (substrings), by wrapper
HAND_WRITTEN = {"flash_attention": "flash", "paged_attention": "paged_kernel",
                "remap_replay": "remap_replay_kernel",
                "remap_gather": "remap_gather_kernel", "irt_lookup": "irt_"}
# the engine's eager calls between the graphs, labelled in a profiled
# window to name the cudaLaunchKernel calls left (with the scheduler's
# refill, which writes a refilled lane's first token)
SITES = ("_scalar", "_stage", "park_idle", "set_pos", "_log_bandwidth",
         "_refresh_lane_tenants", "_live_bucket")
# the engine's steps a timed run synchronises and times on the host clock
GRAPH_TIMED = {"_decode": "step", "_plan": "plan", "_apply": "apply",
               "prefill_lane": "prefill", "chunk_forward": "chunk forward",
               "write_chunk": "chunk write", "admit_fast": "admission",
               "_tenant_pass": "tenant pass", "_release": "release"}


def _kernel_counts() -> dict:
    """Every wrapper's launch counter (a replay books its graph's)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.irt_lookup import ops as irt_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.remap_gather import ops as rg_ops
    return {"paged_attention_fused": pa_ops.launches,
            "paged_attention_split": pa_ops.split_launches,
            "paged_attention": pa_ops.unified_launches,
            "remap_gather": rg_ops.launches,
            "remap_replay": rg_ops.replay_launches,
            "irt_lookup": irt_ops.launches,
            "irt_walk2": irt_ops.walk2_launches,
            "flash_attention": fa_ops.launches}


def _kernel_routes(prof) -> dict:
    """Each hand-written kernel's device launches in a profiled window by
    the host call that launched it (``cudaLaunchKernel``,
    ``cudaGraphLaunch``, ...), joined on CUPTI's correlation ids: a
    kernel replayed inside a graph carries its graph launch's."""
    from torch.autograd import DeviceType
    events = prof.profiler.kineto_results.events()
    calls = {e.correlation_id(): e.name() for e in events
             if e.device_type() == DeviceType.CPU and "Launch" in e.name()}
    routes: dict = {}
    for e in events:
        if e.device_type() != DeviceType.CUDA:
            continue
        for name, sub in HAND_WRITTEN.items():
            if sub in e.name():
                r = routes.setdefault(name, {})
                call = calls.get(e.correlation_id(), "unmatched")
                r[call] = r.get(call, 0) + 1
    return routes


def _launch_sites(prof) -> dict:
    """``cudaLaunchKernel`` calls in a profiled window by call site: the
    innermost ``SITES`` label (``_labelled``) above each, else the op
    that made it."""
    sites: dict = {}
    for e in prof.events():
        if "LaunchKernel" not in e.name:
            continue
        p = e.cpu_parent
        key = p.name if p is not None else "?"
        while p is not None:
            if p.name.startswith("site "):
                key = p.name[5:]
                break
            p = p.cpu_parent
        sites[key] = sites.get(key, 0) + 1
    return dict(sorted(sites.items(), key=lambda kv: -kv[1]))


def _labelled(torch, name, fn):
    """``fn`` under a profiler label ``site <name>``."""
    def call(*a, **kw):
        with torch.profiler.record_function("site " + name):
            return fn(*a, **kw)
    return call


def _graph_run(torch, eng, requests=None, *, timed=False, window=None,
               profiled=False, sites=False):
    """Submit ``requests`` ((prompt, max_new[, tenant]) each; None:
    already submitted) and run ``eng``.  ``timed``: the engine's steps
    (``GRAPH_TIMED``) synchronised and timed on the host clock.
    ``window`` (first, count): the wall time of those loop iterations,
    synchronised at both ends; ``profiled``: the window under
    ``torch.profiler`` (host launch calls, device ops and busy time, the
    hand-written kernels' launch routes; with ``sites`` the
    ``cudaLaunchKernel`` calls by call site, the engine's methods in
    ``SITES`` and the scheduler's ``refill`` labelled), left out of
    tokens/s.
    Returns the run's books."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.engine import Request
    for i, (prompt, max_new, *tenant) in enumerate(requests or ()):
        eng.submit(Request(rid=i, prompt=prompt, max_new=max_new,
                           **({"tenant_id": tenant[0]} if tenant else {})))
    n_req = len(eng.queue)
    spent: dict = {}
    book = {"steps": 0, "window_s": 0.0, "window_tokens": 0, "calls": None,
            "routes": None, "sites": None}
    real = {k: getattr(eng, k) for k in GRAPH_TIMED}

    def sync_timed(name, fn):
        def run(*a):           # a call that captured books apart
            n = eng.graphs.captures
            torch.cuda.synchronize()
            s = time.perf_counter()
            out = fn(*a)
            torch.cuda.synchronize()
            key = name if eng.graphs.captures == n else name + " capture"
            spent.setdefault(key, []).append(
                (time.perf_counter() - s) * 1e3)
            return out
        return run

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def windowed(*a):
        i = book["steps"]
        book["steps"] += 1
        if window is not None and i in (window[0], window[0] + window[1]):
            torch.cuda.synchronize()
            if i == window[0]:
                book["window_s"] = time.perf_counter()
                book["window_tokens"] = eng._tokens_out
                if profiled:
                    prof.start()
            else:
                book["window_s"] = time.perf_counter() - book["window_s"]
                book["window_tokens"] = (eng._tokens_out
                                         - book["window_tokens"])
                if profiled:
                    prof.stop()
                    book["calls"] = _launch_calls(prof)
                    book["routes"] = _kernel_routes(prof)
                    if sites:
                        book["sites"] = _launch_sites(prof)
        return step(*a)

    step = real["_decode"]
    if timed:
        for k, name in GRAPH_TIMED.items():
            setattr(eng, k, sync_timed(name, real[k]))
        step = eng._decode
    sched = eng.scheduler
    if sites:
        for k in SITES:
            setattr(eng, k, _labelled(torch, k, getattr(eng, k)))
        sched.refill = _labelled(torch, "refill", sched.refill)
        step = _labelled(torch, "_decode", step)
    eng._decode = windowed
    before, steps0 = _kernel_counts(), eng.steps
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        done = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for k in (*real, *SITES):         # back to the class's methods
            vars(eng).pop(k, None)
        vars(sched).pop("refill", None)
    after = _kernel_counts()
    n_tok = sum(len(r.tokens) for r in done)
    if window is not None:
        _check(book["window_tokens"] > 0
               and (book["calls"] is not None or not profiled),
               f"the window {window} did not close")
    left_out = (book["window_tokens"], book["window_s"]) if profiled \
        else (0, 0.0)
    return dict(streams={r.rid: r.tokens for r in done},
                counters=eng.counters, steps=eng.steps - steps0,
                launches={k: after[k] - before[k] for k in after},
                wall=wall, n_tok=n_tok, spent=spent,
                tok_s=(n_tok - left_out[0]) / (wall - left_out[1]),
                window_s=book["window_s"], calls=book["calls"],
                routes=book["routes"], sites=book["sites"],
                keys=sorted(map(str, eng.graphs.graphs)),
                ring={k: t.clone() for k, t in (eng._fl or {}).items()},
                copy_bytes=eng.chunk_copy_bytes,
                done=all(r.done for r in done) and len(done) == n_req)


def _states_equal(torch, a, b) -> bool:
    from torch.utils import _pytree as pytree
    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def _hold_equal(torch, label, e, c, eng_e, eng_c):
    """The captured run against the eager one: token streams, counters,
    the wrappers' launch counts, every state leaf and the flight ring
    (events, head, counts), bit for bit."""
    _check(e["done"] and c["done"], f"{label}: a request did not finish")
    _check(c["streams"] == e["streams"],
           f"{label}: captured token streams differ from eager")
    _check(c["counters"] == e["counters"],
           f"{label}: captured counters differ from eager")
    _check(c["launches"] == e["launches"],
           f"{label}: captured launch counts {c['launches']} != eager "
           f"{e['launches']}")
    _check(_states_equal(torch, eng_c.final_state, eng_e.final_state),
           f"{label}: a captured state leaf differs from eager")
    _check(c["ring"].keys() == e["ring"].keys()
           and _states_equal(torch, c["ring"], e["ring"]),
           f"{label}: the captured flight ring differs from eager")


def _mode_line(timed, clean, profiled) -> str:
    """One mode's numbers: tokens/s (the clean run), the synchronised
    step and maintenance times (the timed run), the host's launch calls,
    the device's ops and busy time a loop iteration and its idle share
    (the profiled window, against its own wall and the same iterations'
    wall in the clean run)."""
    sp = timed["spent"]
    st = sorted(sp["step"])
    passes = max(len(sp.get("apply", [])), 1)
    plan, apply = sum(sp.get("plan", [])) / passes, \
        sum(sp.get("apply", [])) / passes
    k, n = profiled["calls"], GRAPHS_WINDOW[1]
    busy = k["device_ms"] / n
    it_ms = 1e3 * clean["window_s"] / n
    return (f"{clean['tok_s']:.1f} tokens/s; decode step p50 "
            f"{st[len(st) // 2]:.2f} ms, p90 {st[int(len(st) * 0.9)]:.2f} ms "
            f"(synchronised, {len(st)} steps); maintenance "
            f"{plan + apply:.2f} ms a pass (plan {plan:.2f} + apply "
            f"{apply:.2f}, {passes} passes); a loop iteration "
            f"{k['kernel_launches'] / n:.1f} cudaLaunchKernel and "
            f"{k['graph_launches'] / n:.2f} cudaGraphLaunch on the host, "
            f"{k['device_ops'] / n:.1f} device ops, {busy:.2f} ms device "
            f"busy: idle {100 * (1 - busy / it_ms):.1f} % of the same "
            f"iterations in the clean run ({it_ms:.2f} ms each), "
            f"{100 * (1 - k['device_ms'] / (1e3 * profiled['window_s'])):.1f}"
            f" % of the profiled window ({1e3 * profiled['window_s'] / n:.2f}"
            f" ms an iteration under the profiler)")


def _graphs_pairs(torch, label, engs, reqs, rounds):
    """``rounds`` (keywords of ``_graph_run``) over the eager and the
    captured engine in turn, each captured run held to the eager run
    before it (``sites`` only for the captured one).  Returns {(round,
    mode): books}."""
    runs = {}
    for r, kw in enumerate(rounds):
        for m in (False, None):
            runs[r, m] = _graph_run(torch, engs[m], reqs, **{
                **kw, "sites": bool(kw.get("sites")) and m is None})
        _hold_equal(torch, f"{label} round {r + 1}", runs[r, False],
                    runs[r, None], engs[False], engs[None])
    return runs


def _check_routes(label, captured, eager):
    """In a captured profiled window no hand-written kernel went out
    through ``cudaLaunchKernel`` and some were replayed; in the eager
    window they went out one by one (the control of the join)."""
    one_by_one = {k: v for k, v in captured.items()
                  if any("LaunchKernel" in c for c in v)}
    _check(not one_by_one, f"{label}: hand-written kernels launched one "
           f"by one in the captured window: {one_by_one}")
    _check(any("GraphLaunch" in c for v in captured.values() for c in v),
           f"{label}: no hand-written kernel replayed in the captured "
           f"window: {captured}")
    _check(any("LaunchKernel" in c for v in eager.values() for c in v),
           f"{label}: the eager window's hand-written kernels were not "
           f"joined to their launch calls: {eager}")


def _ms(spent, name) -> str:
    v = spent.get(name, [])
    return f"{len(v)} x {sum(v) / len(v):.2f} ms" if v else "none"


def _kinds(keys) -> set:
    """The kinds of a runner's captured keys (their str forms)."""
    return {k.split("'")[1] if k.startswith("(") else k for k in keys}


def _capture_line(graphs) -> str:
    cs = graphs.capture_seconds
    return (f"{len(cs)} graphs, capture {sum(cs.values()):.2f} s in all "
            f"(max {max(cs.values()):.4f} s a key), graph pool "
            f"{graphs.pool_bytes / 2**20:.1f} MiB")


def graphs_phase(torch, dev, cfg, params):
    """Phase 15, right after phase 4 (before any ``torch.profiler``
    session).  (a) Phase 4's llama3-8b workload (published widths, bf16,
    16 requests, not cut) served by two engines, eager (``graphs=False``)
    and captured, in two interleaved pairs, eager then captured, twice:
    the first pair times the engine's steps (synchronised), the second
    runs clean (tokens/s).  (b) Phase 7's chunked + two-tenant run, eager
    against captured (the chunk forward, the chunk write, the admission,
    the multi-tenant pass and the release captured), in two pairs: timed,
    then clean.  (e) The flight-recorded pair: phase 9's engine with the
    recorder on and phase 4's first 8 requests, twice.  (c)
    granite-moe-3b-a800m at published widths and depth on phase 4's store
    with phase 4's first 8 requests.  (d) A third pair of (a)'s engines
    with a profiled window of ``GRAPHS_WINDOW`` loop iterations, the
    captured one with its eager call sites labelled (its
    ``cudaLaunchKernel`` calls by call site), then a third pair of (b)'s with a profiled window of
    ``CHUNKED_WINDOW``: last, since a process runs slower after a
    profiler session (``PERF.md`` §7).  Times of a call that captured are
    booked apart.  Gates,
    every run: token streams, counters, the wrappers' launch counts,
    every state leaf and the flight ring of the captured run equal to
    the eager run's bit for bit; every captured engine captures nothing
    after its first run, and (a)'s decodes the same tokens every run; in
    the captured profiled windows no hand-written kernel goes out through
    ``cudaLaunchKernel``."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.obs import FlightConfig
    from repro_torch.obs import flight as obs_flight
    from repro_torch.serve.engine import Engine, EngineConfig
    t0 = time.perf_counter()
    card = _card_line()
    reqs = main_requests(cfg)
    engs = {m: Engine(cfg, params, EngineConfig(**MAIN_EC), device=dev,
                      graphs=m) for m in (False, None)}
    runs = _graphs_pairs(torch, "graphs llama3-8b", engs, reqs,
                         (dict(timed=True), dict(window=GRAPHS_WINDOW)))
    keys = runs[0, None]["keys"]
    capture = _capture_line(engs[None].graphs)
    capture_s = engs[None].graphs.capture_seconds
    _check({"decode", "plan", "apply", "prefill", "release"}
           <= _kinds(keys), f"graphs: captured keys {keys}")

    ch = {m: chunked_engine(cfg, params, dev, graphs=m, submit=False)
          for m in (False, None)}
    creqs = chunked_requests(cfg)
    chunked = _graphs_pairs(torch, "graphs chunked", ch, creqs,
                            (dict(timed=True), {}))
    ckeys = chunked[0, None]["keys"]
    _check({"decode", "chunk", "write_chunk", "admit", "maintain_tenants",
            "release"} <= _kinds(ckeys),
           f"graphs chunked: captured keys {ckeys}")

    fe = {m: demoting_engine(cfg, params, dev, graphs=m,
                             flight=FlightConfig(capacity=4096))
          for m in (False, None)}
    flight = _graphs_pairs(torch, "graphs flight", fe,
                           reqs[:TELEMETRY_REQUESTS], ({}, {}))
    fkeys = flight[0, None]["keys"]
    _check(flight[1, None]["keys"] == fkeys,
           f"graphs flight: the second captured run captured "
           f"{flight[1, None]['keys']} after {fkeys}")
    _check({"apply_rec", "release_rec", "prefill"} <= _kinds(fkeys),
           f"graphs flight: captured keys {fkeys}")
    ring = flight[0, None]["ring"]
    _check(int(ring["counts"][obs_flight.K_DEMOTE]) > 0
           and int(ring["counts"][obs_flight.K_RELEASE]) > 0,
           f"graphs flight: the ring holds no demote or release "
           f"({ring['counts'].tolist()})")
    freed = [_free_without_collector(torch, "graphs flight", fe)]
    print(f"graphs flight-recorded: captured == eager bit for bit in both "
          f"pairs ({TELEMETRY_REQUESTS} requests; token streams, counters, "
          f"launch counts, every state leaf, the ring's events, head "
          f"{int(ring['head'])} and counts by kind "
          f"{ring['counts'].tolist()}); the second captured run captured "
          f"nothing; {len(fkeys)} keys; eager "
          f"{flight[0, False]['tok_s']:.1f} tokens/s, captured "
          f"{flight[0, None]['tok_s']:.1f} tokens/s; card {card}")

    gcfg = get_config("granite-moe-3b-a800m")
    gparams = init_params(gcfg, dev, seed=0)
    gen = {m: Engine(gcfg, gparams, EngineConfig(**MAIN_EC), device=dev,
                     graphs=m) for m in (False, None)}
    gran = _graphs_pairs(torch, "graphs granite", gen,
                         main_requests(gcfg)[:FAMILY_REQUESTS], ({},))
    del gparams
    freed.append(_free_without_collector(torch, "graphs granite", gen))
    print(f"graphs granite-moe-3b-a800m: captured == eager bit for bit "
          f"({FAMILY_REQUESTS} requests, {gran[0, None]['steps']} steps); "
          f"eager {gran[0, False]['tok_s']:.1f} tokens/s, captured "
          f"{gran[0, None]['tok_s']:.1f} tokens/s; card {card}")

    runs.update({(2, m): r for (_, m), r in _graphs_pairs(
        torch, "graphs llama3-8b profiled", engs, reqs,
        (dict(window=GRAPHS_WINDOW, profiled=True, sites=True),)).items()})
    chunked.update({(2, m): r for (_, m), r in _graphs_pairs(
        torch, "graphs chunked profiled", ch, creqs,
        (dict(window=CHUNKED_WINDOW, profiled=True),)).items()})
    _check(all(chunked[r, None]["keys"] == ckeys for r in (1, 2))
           and ch[None].graphs.captures == len(ckeys),
           f"graphs chunked: a later captured run captured "
           f"{chunked[2, None]['keys']} after {ckeys}")
    _check_routes("graphs chunked", chunked[2, None]["routes"],
                  chunked[2, False]["routes"])
    ccapture = _capture_line(ch[None].graphs)
    C = ch[None].scheduler.chunk
    L, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    item = torch.finfo(getattr(torch, cfg.dtype)).bits // 8
    freed.append(_free_without_collector(torch, "graphs chunked", ch))
    print(f"graphs chunked + QoS: captured == eager bit for bit in all "
          f"three pairs (token streams, counters, launch counts, every "
          f"state leaf); the later captured runs captured nothing; eager "
          f"{chunked[1, False]['tok_s']:.1f} tokens/s, captured "
          f"{chunked[1, None]['tok_s']:.1f} tokens/s (the clean pair); "
          f"card {card}")
    for m, name in ((False, "eager"), (None, "captured")):
        sp = chunked[0, m]["spent"]
        k, n = chunked[2, m]["calls"], CHUNKED_WINDOW[1]
        idle = 1 - k["device_ms"] / (1e3 * chunked[2, m]["window_s"])
        print(f"graphs chunked {name} (synchronised, host clock; a call "
              f"that captured apart): chunk forward "
              f"{_ms(sp, 'chunk forward')}, chunk write "
              f"{_ms(sp, 'chunk write')}, multi-tenant pass "
              f"{_ms(sp, 'tenant pass')}, admission {_ms(sp, 'admission')}"
              f", release {_ms(sp, 'release')}, decode step "
              f"{_ms(sp, 'step')}, chunk forward capture "
              f"{_ms(sp, 'chunk forward capture')}; profiled window "
              f"{CHUNKED_WINDOW}: {k['kernel_launches'] / n:.1f} "
              f"cudaLaunchKernel and {k['graph_launches'] / n:.2f} "
              f"cudaGraphLaunch a loop iteration, {k['device_ms'] / n:.2f} "
              f"ms device busy, idle {100 * idle:.1f} % of the window; "
              f"hand-written kernels by launch call "
              f"{json.dumps(chunked[2, m]['routes'])}; card {card}")
    sp = chunked[0, None]["spent"]
    n_chunks = sum(len(sp.get(k, ())) for k in ("chunk forward",
                                                "chunk forward capture"))
    print(f"graphs chunked captured: {ccapture}; {len(ckeys)} keys "
          f"{ckeys}; K/V rows the chunk routing copied to switch ingests "
          f"{chunked[1, None]['copy_bytes'] / n_chunks:.0f} bytes a chunk "
          f"({chunked[1, None]['copy_bytes']} over {n_chunks} chunks), "
          f"and inside each chunk graph its {C} rows "
          f"({2 * L * C * KV * hd * item} bytes) into the write's "
          f"buffers; card {card}")
    _check(engs[None].graphs.captures == len(keys)
           and all(runs[r, None]["keys"] == keys for r in (1, 2)),
           f"graphs: a later captured run captured "
           f"{runs[2, None]['keys']} after {keys}")
    _check_routes("graphs llama3-8b", runs[2, None]["routes"],
                  runs[2, False]["routes"])
    # (the step count runs on across runs, as the reference's does, so
    # the maintenance cadence and with it the counters may shift)
    _check(all(runs[r, None]["streams"] == runs[0, None]["streams"]
               for r in (1, 2)),
           "graphs: the captured engine's later runs decoded other tokens")
    for m, name in ((False, "eager"), (None, "captured")):
        sp = runs[0, m]["spent"]
        print(f"graphs llama3-8b {name}: "
              f"{_mode_line(runs[0, m], runs[1, m], runs[2, m])}; prefill "
              f"{_ms(sp, 'prefill')} a request, release "
              f"{_ms(sp, 'release')} (synchronised; calls that captured: "
              f"prefill {_ms(sp, 'prefill capture')}, release "
              f"{_ms(sp, 'release capture')}); hand-written kernels "
              f"in the profiled window by launch call "
              f"{json.dumps(runs[2, m]['routes'])}; card {card}")
    n = GRAPHS_WINDOW[1]
    sites = {k: round(v / n, 2) for k, v in runs[2, None]["sites"].items()}
    print(f"graphs llama3-8b captured: the cudaLaunchKernel calls left a "
          f"loop iteration by call site {json.dumps(sites)}; card {card}")
    print(f"graphs llama3-8b: captured == eager bit for bit in all three "
          f"pairs (16 requests, {runs[1, None]['steps']} steps: token "
          f"streams, counters, launch counts "
          f"{json.dumps(runs[1, None]['launches'])}, every state leaf); "
          f"the captured engine's later runs captured nothing and decoded "
          f"the first's tokens; {capture}; capture seconds "
          f"{json.dumps({str(k): round(v, 4) for k, v in capture_s.items()})}"
          f"; phase 15 took {time.perf_counter() - t0:.1f} s")
    freed.append(_free_without_collector(torch, "graphs llama3-8b", engs))
    print(f"graphs: each pair of engines (eager and captured) freed by "
          f"del alone, the cyclic collector off: reserved device GiB "
          f"before -> after {json.dumps(freed)} (flight, granite, chunked, "
          f"llama3-8b)")


def _free_without_collector(torch, label, engines: dict) -> list:
    """Drop ``engines`` (a dict holding the caller's only references to
    them) with Python's cyclic collector off, then empty the allocator's
    cache: every engine must be gone (a weak reference dead) and the
    reserved memory must fall, their graphs, graph pool and KV pools
    released by reference counting alone.  Returns the reserved GiB
    [before, after]."""
    import weakref

    refs = [weakref.ref(e) for e in engines.values()]
    collecting = gc.isenabled()
    gc.disable()
    try:
        torch.cuda.synchronize()
        before = torch.cuda.memory_reserved()
        engines.clear()
        torch.cuda.empty_cache()
        after = torch.cuda.memory_reserved()
    finally:
        if collecting:
            gc.enable()
    alive = sum(r() is not None for r in refs)
    _check(alive == 0 and after < before,
           f"{label}: after del with the collector off {alive} engines "
           f"alive, reserved {before / 2**30:.2f} -> {after / 2**30:.2f} "
           f"GiB")
    return [round(before / 2**30, 2), round(after / 2**30, 2)]


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
# 11's ring run: a prompt just under the window, decode steps across it
RING_PROMPT, RING_STEPS = 4080, 32


def _count_drops(torch, moe_mod, dev):
    """Wrap ``moe.dispatch`` so that every call adds its dropped choices,
    one dispatch and its routed choices to counters on the card (nothing
    waits for them; a captured step replays the adds).  Returns (the
    counters [dropped, dispatches, routed], restore)."""
    real = moe_mod.dispatch
    counts = torch.zeros((3,), dtype=torch.int64, device=dev)

    def counted(eidx, n_experts, cap, offset=None):
        slot, keep = real(eidx, n_experts, cap, offset)
        counts[0].add_((~keep).sum())
        counts[1].add_(1)
        counts[2].add_(keep.numel())
        return slot, keep

    moe_mod.dispatch = counted
    return counts, lambda: setattr(moe_mod, "dispatch", real)


def family_serve(torch, dev, arch):
    """``arch`` at its published width and depth, seeded weights made on
    the card (random non-zero QKV biases where it has them), served by the
    tiered engine on phase 4's store (``MAIN_EC``) with phase 4's first 8
    requests.  Gates: every request finished and released, the metadata
    back to identity, one fused launch per layer and decode step, one
    flash launch per layer and prefill, one copy-engine launch per
    maintenance pass.  Prints tokens/s, ms per decode step (median, p90),
    maintenance ms per pass, the host's launch calls of a decode step
    (``torch.profiler`` over ``FAMILY_PROFILED`` steps; a captured step is
    one graph launch), the launches per kind, the device's busy time in
    the profiled steps (their kernels' device time) against the median
    step and, for MoE, the choices dropped for capacity.  Returns the
    launches per kind."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.core.remap.irt import INVALID
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.remap_gather import ops as rg_ops
    from repro_torch.models import init_params, moe
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
    real = eng._decode               # the engine's step: a captured graph
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

    def step(state, tokens, n_pages):
        i = book["step"]
        book["step"] += 1
        if not first <= i < first + count:
            return step_timed(state, tokens, n_pages)
        torch.cuda.synchronize()
        s = time.perf_counter()
        book["window_tok"] += int((state.pos >= 0).sum())
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = real(state, tokens, n_pages)
            torch.cuda.synchronize()
        calls = _launch_calls(prof)
        book["launches"].append(calls["kernel_launches"]
                                + calls["graph_launches"])
        book["busy_ms"].append(calls["device_ms"])
        book["window_s"] += time.perf_counter() - s
        return out

    eng._decode = step
    eng.prefill_lane = timed("prefill", eng.prefill_lane)
    eng._plan = timed("maintenance plan", eng._plan)
    eng._apply = timed("maintenance apply", eng._apply)
    counts, restore = _count_drops(torch, moe, dev)
    pa_ops.launches = fa_ops.launches = 0
    rg_ops.launches = rg_ops.replay_launches = 0
    try:
        t0 = time.perf_counter()
        done = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
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
        dropped, dispatches, routed = counts.tolist()
        drops = (f"; MoE dispatches {dispatches}, {dropped} of "
                 f"{routed} routed choices dropped for capacity")
    print(f"families {arch}: {n} requests, {n_tok} tokens, {eng.steps} "
          f"decode steps, {prefills} prefills, {passes} maintenance passes "
          f"in {wall:.2f} s: "
          f"{(n_tok - book['window_tok']) / (wall - book['window_s']):.1f} "
          f"tokens/s end to end (the {count} profiled steps left out), "
          f"decode step median {median:.2f} ms (p90 "
          f"{steps[int(len(steps) * 0.9)]:.2f} ms), maintenance "
          f"{maint:.2f} ms per pass (plan + apply), prefill "
          f"{sum(spent['prefill']) / prefills:.2f} ms each; "
          f"{per_step:.1f} launch calls (kernels or graphs) and "
          f"{busy:.2f} ms of device time per decode step "
          f"(torch.profiler, steps {first}-"
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
    gc.collect()
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
    counts, restore = _count_drops(torch, moe, dev)
    dropped = counts[0]                 # a view: the choices dropped
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
    launches = fa_ops.launches + mixtral_ring_run(torch, dev, cfg, params)
    del params, out, dec, one, dec0, one0
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def mixtral_ring_run(torch, dev, cfg, params):
    """11(ring): the window phase's mixtral (2 layers, fp32) with
    ``REPRO_WINDOW_CACHE=1``: ``prefill`` of a ``RING_PROMPT``-token
    prompt into a ring of ``window`` slots (4,096), then ``RING_STEPS``
    teacher-forced ``decode_step``s over the dense backend at positions
    across 4,096, where the ring wraps: each step's logits within 1e-3
    of the one-shot ``forward`` over the same tokens (window 4,096).
    Returns the flash launches (the prefill's and the forward's)."""
    import numpy as np

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import decode_step, forward, prefill

    n, steps = RING_PROMPT, RING_STEPS
    seq = torch.as_tensor(np.random.default_rng(8).integers(
        0, cfg.vocab, (1, n + steps)), dtype=torch.int32, device=dev)
    fa_ops.launches = 0
    t0 = time.perf_counter()
    with torch.inference_mode(), _env(REPRO_WINDOW_CACHE="1"):
        _, st = prefill(cfg, params, {"tokens": seq[:, :n]},
                        max_len=n + steps, last=True)
        slots = st.caches["k"].shape[2]
        rows = []
        for i in range(steps):
            lg, st = decode_step(cfg, params, st, seq[:, n + i])
            rows.append(lg[0])
        one = forward(cfg, params, {"tokens": seq})[0][0, n:]
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    err = (torch.stack(rows) - one).abs().max().item()
    pos = int(st.pos[0])
    _check(slots == cfg.sliding_window,
           f"mixtral ring: the cache holds {slots} slots, want "
           f"{cfg.sliding_window}")
    _check(pos == n + steps and n < slots < pos,
           f"mixtral ring: decode ended at {pos}; the ring of {slots} slots "
           f"must wrap")
    _check(math.isfinite(err) and err <= 1e-3,
           f"mixtral ring: decode differs from the one-shot forward by "
           f"{err} > 1e-3")
    _check(fa_ops.launches == 2 * cfg.n_layers,
           f"mixtral ring: flash launches {fa_ops.launches} != 2 forwards "
           f"x {cfg.n_layers} layers")
    print(f"families mixtral-8x22b ring: REPRO_WINDOW_CACHE=1, a {n}-token "
          f"prefill into a ring of {slots} slots, then {steps} "
          f"teacher-forced decode steps at positions {n}-{n + steps - 1} "
          f"(the ring wraps at {slots}): max |decode - one-shot forward| "
          f"{err:.3e} (tol 1e-3); {fa_ops.launches} flash launches, "
          f"{secs:.1f} s")
    return fa_ops.launches


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
    gc.collect()
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
    gc.collect()
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
    gc.collect()
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
    gc.collect()
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


def _train_configs(arch=None, layers=None):
    """(published config, cfg, data config, optimiser config) of a
    training run: ``arch`` (``TRAIN_ARCH``) at published widths on
    ``layers`` (``TRAIN_LAYERS``) layers, 4 x 1024 tokens (an encoder's
    seeded frame embeddings), AdamW."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.train.optimizer import OptConfig

    pub = get_config(arch or TRAIN_ARCH)
    cfg = dataclasses.replace(pub, n_layers=layers or TRAIN_LAYERS)
    dc = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                    global_batch=TRAIN_BATCH,
                    embed_dim=cfg.d_model if cfg.embed_inputs else 0)
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


# ---------------------------------------------------------------------------
# phase 16: sharding on the card, a one-rank NCCL group
# ---------------------------------------------------------------------------

SHARD_STEPS = 3                 # 16(a): steps of each training run
# 16(b): lanes, prompt tokens and greedy decode steps of the served run
SHARD_LANES, SHARD_PROMPT, SHARD_DECODE = 2, 256, 8
# 16(d): the hybrid family and its depth (layers 0-3: a global layer and
# three windowed ones); 16(g): the ssm family (layer 3 sLSTM); 16(e): the
# MoE family; 16(f): the vlm (one super-block: 4 self layers and a cross
# layer) and the encoder
SHARD_HYBRID, SHARD_HYBRID_LAYERS = "hymba-1.5b", 4
SHARD_SSM, SHARD_SSM_LAYERS = "xlstm-125m", 4
SHARD_MOE, SHARD_MOE_LAYERS = "granite-moe-3b-a800m", 4
SHARD_VLM_LAYERS, SHARD_AUDIO_LAYERS = 5, 4
# the vlm's cross gate in 16(f) and phase 19: tanh(0.5) = 0.46 (the
# reference's 0 hides the branch)
SHARD_VLM_GATE = 0.5


@contextlib.contextmanager
def _env(**kw):
    """``os.environ`` with ``kw`` set, restored on exit."""
    old = {k: os.environ.get(k) for k in kw}
    os.environ.update(kw)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _shard_train_run(torch, dev, cfg, dc, oc, batches, mesh):
    """``SHARD_STEPS`` steps of ``make_train_step`` (``mesh`` None) or of
    ``make_sharded_train_step`` on ``mesh`` from ``init_params(cfg, dev,
    1)``: (loss and gnorm by step, host ms by step (each ends in a read of
    the loss), the wrappers' launches, peak device GiB, the final
    parameters on the host)."""
    from repro_torch.data.pipeline import make_batch
    from repro_torch.models import abstract_params_and_axes, init_params
    from repro_torch.sharding import specs
    from repro_torch.train.loop import (TrainConfig, init_sharded_state,
                                        make_sharded_train_step,
                                        make_train_step)
    from repro_torch.train.optimizer import init_opt_state, leaves

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, dev, seed=1)
    if mesh is None:
        step = make_train_step(cfg, oc, TrainConfig())
        opt, err = init_opt_state(params), None
        feed = lambda b: b  # noqa: E731
    else:
        step, p_sh, b_sh = make_sharded_train_step(
            cfg, oc, TrainConfig(), mesh, make_batch(dc, 0))
        params = specs.distribute_tree(params, p_sh)
        opt, err = init_sharded_state(
            p_sh, abstract_params_and_axes(cfg)[0], False)
        feed = lambda b: {k: specs.distribute(v, b_sh[k])  # noqa: E731
                          for k, v in b.items()}
    _counts(zero=True)
    vals, ms = [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, err, m = step(params, opt, err, feed(b))
        vals.append((m["loss"].item(), m["gnorm"].item()))
        ms.append((time.perf_counter() - t0) * 1e3)
    launches = _counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    final = [(p if mesh is None else p.full_tensor()).cpu()
             for p in leaves(params)]
    del params, opt, m
    gc.collect()
    torch.cuda.empty_cache()
    return vals, ms, launches, peak, final


def shard_train(torch, dev, mesh, arch, layers, env, label):
    """16(a), the training halves of 16(d), 16(f) and 16(g): the sharded
    train step on a (1, 1) mesh against ``make_train_step`` under
    ``env`` on both sides, ``arch`` at published widths on ``layers``
    layers, bf16, 4 x 1024 tokens (an encoder's frame embeddings), AdamW,
    the same parameters and batches, ``SHARD_STEPS`` steps each: losses,
    gnorms and every final parameter equal bit for bit (on one rank the
    data mean is the rank's own gradient), flash forward and backward
    launches a step equal (one an attention layer); ms a step (steps 2
    on) and peak memory of both.  The step runs split (every part over
    the one "model" rank, every expert local and every dispatch offset
    0; the loss takes the ``REPRO_SHARDED_CE`` form,
    which ``env`` gives the unsharded side)."""
    from repro_torch.data.pipeline import device_batch

    _, cfg, dc, oc = _train_configs(arch, layers)
    batches = [device_batch(dc, it, dev) for it in range(SHARD_STEPS)]
    with _env(**env):
        runs = {name: _shard_train_run(torch, dev, cfg, dc, oc, batches, m)
                for name, m in (("unsharded", None), ("sharded", mesh))}
    (v0, ms0, l0, pk0, f0), (v1, ms1, l1, pk1, f1) = runs.values()
    path = f"split path (parts {json.dumps(_split_parts(cfg, mesh))})"
    _check(all(_split_parts(cfg, mesh).values()),
           f"{label}: parts not split ({path})")
    worst = max((a.float() - b.float()).abs().max().item()
                for a, b in zip(f0, f1))
    n_attn = _attention_layers(cfg)
    per_step = SHARD_STEPS * n_attn
    _check(l0 == l1 and l0["flash_attention"] == per_step
           and l0["flash_attention_bwd"] == per_step,
           f"{label}: launches unsharded {l0}, sharded {l1}; want "
           f"{n_attn} flash forward and backward a step in both")
    _check(v0 == v1 and worst == 0.0,
           f"{label}: sharded (loss, gnorm) {v1} against {v0}; largest "
           f"parameter difference {worst:.3e} (want bit for bit on one rank)")
    step0, step1 = (sorted(x[1:])[len(x[1:]) // 2] for x in (ms0, ms1))
    print(f"{label}: {arch} L={cfg.n_layers} {cfg.dtype}, "
          f"{dc.global_batch} x {dc.seq_len} tokens, {SHARD_STEPS} steps "
          f"from the same parameters and batches, {path} against "
          f"make_train_step under {json.dumps(env)}; (loss, gnorm) by step "
          f"{v1} equal bit for bit, every final parameter equal "
          f"({len(f1)} leaves); flash {n_attn} forward and {n_attn} "
          f"backward launches a step in both")
    print(f"{label}: ms a step (median of steps 2-{SHARD_STEPS}; all "
          f"{[round(x, 1) for x in ms1]}) sharded {step1:.1f} against "
          f"unsharded {step0:.1f} (all {[round(x, 1) for x in ms0]}), "
          f"{step1 - step0:+.1f} ms; peak device memory sharded "
          f"{pk1:.2f} GiB against {pk0:.2f} GiB ({pk1 - pk0:+.2f} GiB); "
          f"card {_card_line()}")


def _attention_layers(cfg) -> int:
    """The layers that attend (and launch flash): every layer but the
    xLSTM's."""
    return 0 if cfg.family == "ssm" else cfg.n_layers


def _split_of(cfg, mesh):
    """The ``TensorParallel`` of ``cfg``'s parameters on ``mesh``."""
    from repro_torch.models import abstract_params_and_axes
    from repro_torch.sharding import specs
    from repro_torch.sharding.tensor_parallel import TensorParallel

    params_abs, axes = abstract_params_and_axes(cfg)
    return TensorParallel(cfg, mesh, specs.tree_shardings(
        axes, mesh, params_abs), params_abs)


def _split_parts(cfg, mesh) -> dict:
    """Which parts (attention, MLP or MoE, vocabulary) of ``cfg`` run
    split over ``mesh``'s "model" axis, from the parameters'
    shardings."""
    other = "mlp" if cfg.family == "moe" else "moe"
    return {k: v for k, v in _split_of(cfg, mesh).split.items()
            if k != other}


def shard_serve(torch, dev, mesh, arch, layers, env, label):
    """16(b), the serving halves of 16(d), 16(f) and 16(g):
    ``jit_prefill`` of ``SHARD_LANES`` x ``SHARD_PROMPT`` tokens (the
    vlm's over seeded image embeddings, its gates at ``SHARD_VLM_GATE``)
    then ``SHARD_DECODE`` greedy ``jit_decode`` steps on the (1, 1) mesh,
    ``arch`` at published widths on ``layers`` layers, bf16, against
    ``prefill`` (the last position unembedded alone, as
    ``make_prefill_fn`` does; the recurrent families' cold state) and
    ``decode_step``, under ``env`` on both sides: the logits at every
    step and the tokens equal bit for bit; flash launched once an
    attention layer in each prefill (and once a vlm cross layer a decode
    step)."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.device import torch_dtype
    from repro_torch.models import (abstract_params_and_axes, decode_step,
                                    init_params, prefill)
    from repro_torch.serve.decode import (batch_shardings, jit_decode,
                                          jit_prefill)
    from repro_torch.sharding import specs

    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    shape = ShapeConfig("phase16", SHARD_PROMPT + SHARD_DECODE, SHARD_LANES,
                        "prefill")
    params = init_params(cfg, dev, seed=2)
    g = torch.Generator(device=dev).manual_seed(3)
    prompt = {"tokens": torch.randint(
        0, cfg.vocab, (SHARD_LANES, SHARD_PROMPT), generator=g, device=dev,
        dtype=torch.int32)}
    n_cross = 0
    if cfg.family == "vlm":
        n_cross = cfg.vlm_dims[0]
        params["blocks"]["cross"]["attn"]["gate"].fill_(SHARD_VLM_GATE)
        prompt["image_embeds"] = torch.randn(
            (SHARD_LANES, cfg.n_image_tokens, cfg.d_model), generator=g,
            device=dev).to(torch_dtype(cfg.dtype))
    with _env(**env):
        _counts(zero=True)
        want, state = prefill(cfg, params, prompt, max_len=shape.seq_len,
                              last=True)
        want = [want[:, -1]]
        for _ in range(SHARD_DECODE):
            logits, state = decode_step(cfg, params, state,
                                        want[-1].argmax(-1).to(torch.int32))
            want.append(logits)
        plain_launches = _counts(zero=True)
        del state
        pre, (params_abs, _) = jit_prefill(cfg, shape, mesh)
        dec, _ = jit_decode(cfg, dataclasses.replace(shape, kind="decode"),
                            mesh)
        sharded = specs.distribute_tree(params, specs.tree_shardings(
            abstract_params_and_axes(cfg)[1], mesh, params_abs))
        b_sh = batch_shardings(prompt, mesh)
        t_sh = specs.NamedSharding(mesh, specs.spec_for(("batch",),
                                                        mesh=mesh))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, state = pre(sharded, {k: specs.distribute(v, b_sh[k])
                                      for k, v in prompt.items()})
        got = [logits.full_tensor()]
        for _ in range(SHARD_DECODE):
            logits, state = dec(sharded, state, specs.distribute(
                got[-1].argmax(-1).to(torch.int32), t_sh))
            got.append(logits.full_tensor())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _counts()
    same = [bool(torch.equal(a, b)) for a, b in zip(got, want)]
    toks = [x.argmax(-1).tolist() for x in got]
    _check(all(same), f"{label}: logits equal by step {same}")
    flash = _attention_layers(cfg) + SHARD_DECODE * n_cross
    _check(launches == plain_launches and launches["flash_attention"]
           == flash, f"{label}: launches {launches}, unsharded "
           f"{plain_launches}; want flash once a layer in prefill and "
           f"{n_cross} a decode step ({flash})")
    print(f"{label}: jit_prefill of {SHARD_LANES} x {SHARD_PROMPT} "
          f"tokens then {SHARD_DECODE} jit_decode steps at {arch}'s "
          f"widths, {cfg.n_layers} layers {cfg.dtype}, split path under "
          f"{json.dumps(env)}: logits equal bit for bit at every step, "
          f"tokens {toks}; launches "
          f"{json.dumps({k: v for k, v in launches.items() if v})} as "
          f"unsharded; {wall:.2f} s wall (eager)")
    del params, sharded, state, logits
    gc.collect()
    torch.cuda.empty_cache()


def shard_dp_mean(torch, dev):
    """16(c): ``dp_mean_compressed`` through NCCL (a float MAX and an
    int32 SUM all-reduce) on one rank against its plain single-process
    result, bit for bit, over a tree of an fp32 [4096, 4096], a bf16
    [1024, 128] and an fp32 [3] leaf."""
    from repro_torch.train.compression import _scale_for, dp_mean_compressed

    g = torch.Generator(device=dev).manual_seed(4)
    tree = {"a": torch.randn(4096, 4096, generator=g, device=dev),
            "b": {"w": torch.randn(1024, 128, generator=g, device=dev)
                  .to(torch.bfloat16),
                  "z": torch.tensor([0.0, 1.5, -3.0], device=dev)}}
    got = dp_mean_compressed(tree)

    def plain(x):
        s = _scale_for(x)
        q = torch.clamp(torch.round(x.float() / s), -127, 127)
        return (q * s / 1).to(x.dtype)
    pairs = [(got["a"], plain(tree["a"])), (got["b"]["w"],
             plain(tree["b"]["w"])), (got["b"]["z"], plain(tree["b"]["z"]))]
    _check(all(torch.equal(a, b) for a, b in pairs),
           "shard dp mean: NCCL result differs from the plain one")
    print("shard dp mean: dp_mean_compressed through NCCL (MAX, int32 SUM) "
          "equals the plain single-process result bit for bit (3 leaves, "
          "fp32 and bf16)")


def sharding_phase(torch, dev):
    """Phase 16: a one-rank NCCL group over a file store, the (1, 1)
    ("data", "model") mesh of ``make_host_mesh(1)``; 16(a), (b), (c),
    (d), (e), (f), (g); the group destroyed at the end."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pg_") as tmp:
        dist.init_process_group(
            "nccl", store=dist.FileStore(str(Path(tmp) / "store"), 1),
            rank=0, world_size=1)
        try:
            mesh = make_host_mesh(1, dev)
            shard_train(torch, dev, mesh, TRAIN_ARCH, TRAIN_LAYERS,
                        {"REPRO_SHARDED_CE": "1"}, "shard train")
            shard_serve(torch, dev, mesh, TRAIN_ARCH, TRAIN_LAYERS, {},
                        "shard serve")
            shard_dp_mean(torch, dev)
            shard_train(torch, dev, mesh, SHARD_HYBRID, SHARD_HYBRID_LAYERS,
                        {"REPRO_SHARDED_CE": "1"}, "shard hybrid train")
            shard_serve(torch, dev, mesh, SHARD_HYBRID, SHARD_HYBRID_LAYERS,
                        {}, "shard hybrid serve")
            shard_train(torch, dev, mesh, SHARD_MOE, SHARD_MOE_LAYERS,
                        {"REPRO_SHARDED_CE": "1"}, "shard moe train")
            shard_serve(torch, dev, mesh, SHARD_MOE, SHARD_MOE_LAYERS, {},
                        "shard moe serve")
            shard_serve(torch, dev, mesh, VLM_ARCH, SHARD_VLM_LAYERS, {},
                        "shard vlm serve")
            shard_train(torch, dev, mesh, AUDIO_ARCH, SHARD_AUDIO_LAYERS,
                        {"REPRO_SHARDED_CE": "1"}, "shard audio train")
            shard_train(torch, dev, mesh, SHARD_SSM, SHARD_SSM_LAYERS,
                        {"REPRO_SHARDED_CE": "1"}, "shard ssm train")
            shard_serve(torch, dev, mesh, SHARD_SSM, SHARD_SSM_LAYERS, {},
                        "shard ssm serve")
        finally:
            dist.destroy_process_group()
    print(f"sharding: phase 16 took {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 17: one rank's share of qwen2-72b on a (1, 4) mesh
# ---------------------------------------------------------------------------

TP_ARCH, TP_MODEL = "qwen2-72b", 4
TP_LANES, TP_PROMPT, TP_LEN, TP_DECODE = 8, 2048, 4096, 32


def _wire_bytes(op: str, sizes: list, n: int) -> float:
    """Bytes one rank sends for a collective over ``n`` ranks by the ring
    algorithms: all-reduce 2 (n-1)/n of the tensor, all-gather (n-1)/n of
    the gathered output, all-to-all (n-1)/n of the send buffer."""
    big = max(sizes)
    return (2 if "allreduce" in op else 1) * (n - 1) / n * big


def _peak_bytes_since(torch, base: int) -> int:
    """Bytes allocated at the peak since the last reset, above ``base``
    bytes; the peak is reset for the next stage."""
    peak = torch.cuda.max_memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    return peak


def _peak_since(torch, base: int) -> float:
    """``_peak_bytes_since`` in GiB, rounded to 0.01."""
    return round(_peak_bytes_since(torch, base) / 2**30, 2)


def _stage_peak(torch, base: int, stage: dict, exact: dict,
                name: str) -> None:
    """A rank share's peak at stage ``name``: in bytes in ``exact``
    (phase 21 holds its reckoning against it) and in GiB, rounded, in
    ``stage`` (printed)."""
    exact[name] = _peak_bytes_since(torch, base)
    stage[name] = round(exact[name] / 2**30, 2)


# each rank share's peak device memory by stage (GiB above what its phase
# found held) before the residual stream split by sequence, from the
# parent version's run on an NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md,
# section 5); printed beside this run's
EARLIER_STAGES = {
    "qwen2-72b": {"init": 40.24, "prefill": 38.65, "decode": 37.52},
    "mixtral-8x22b": {"init": 69.8, "prefill": 69.47, "decode": 66.55},
    "llama-3.2-vision-90b": {"init": 46.21, "prefill": 44.12,
                             "decode": 43.64},
    "hymba-1.5b": {"init": 1.27, "prefill": 1.5, "decode": 1.35},
    "xlstm-125m": {"init": 0.27, "prefill": 0.14, "decode": 0.13}}
# the collectives a rank share's decode step runs on "model" (gated: the
# sequence split leaves decode as it was)
DECODE_CALLS = {"qwen2-72b": 401, "mixtral-8x22b": 337,
                "llama-3.2-vision-90b": 441, "hymba-1.5b": 224,
                "xlstm-125m": 25}


# what phases 17-20 measured of each rank share, for phase 21's reckoning
SHARES: dict = {}


def _keep_share(arch, shape, prompt, env, p_bytes, c_bytes, stage, calls,
                decode_calls, flash_prefill, flash_decode):
    """Record a rank share's measurements for phase 21: the prefill's
    ``ShapeConfig`` and prompt length, the environment it ran under, the
    parameter and cache bytes, the prefill and decode stage peaks in
    bytes (``_stage_peak``'s ``exact``), the prefill's collectives
    (``_prefill_calls``), a decode step's collectives on "model", and
    flash's launches in the prefill and a decode step."""
    SHARES[arch] = dict(shape=shape, prompt=prompt, env=env,
                        p_bytes=p_bytes, c_bytes=c_bytes, stage=dict(stage),
                        calls=calls, decode_calls=decode_calls,
                        flash_prefill=flash_prefill,
                        flash_decode=flash_decode)


class _ResidualTap:
    """Records, while on, the shape of the residual stream entering every
    split block (``transformer._block_fwd_tp``, called with (cfg, tp,
    aux, sp, layer pieces, x, ...)): a Python call a layer, no device
    work."""

    def __enter__(self):
        from repro_torch.models import transformer

        self.mod, self.real = transformer, transformer._block_fwd_tp
        self.shapes = []

        def tap(*a, **kw):
            self.shapes.append(tuple(a[5].shape))
            return self.real(*a, **kw)
        transformer._block_fwd_tp = tap
        return self

    def __exit__(self, *exc):
        self.mod._block_fwd_tp = self.real


def _prefill_calls(torch, pre, params, batch, model: str) -> dict:
    """A second, untimed run of the prefill step ``pre`` under
    ``CollectiveLog`` (its outputs dropped): its collectives on the group
    named ``model`` by kind, each kind's count and largest tensor in
    bytes, and the count on other groups."""
    from repro_torch.sharding.tensor_parallel import CollectiveLog
    from repro_torch.utils.step_analysis import calls_by_group

    rec = CollectiveLog()
    with rec:
        out = pre(params, batch)
    torch.cuda.synchronize()
    del out
    kinds = dict(sorted(calls_by_group(rec.calls).get(model, {}).items()))
    return {"model": kinds, "other": len(rec.calls) - sum(
        v["calls"] for v in kinds.values())}


def _seq_split_gates(label: str, arch: str, shapes: list, want: tuple,
                     m: int, layers: int, calls: dict, stage: dict,
                     decode_calls: int, card: str) -> None:
    """The sequence split's gates on a rank share's prefill: the residual
    entering each of its ``layers`` split blocks is this rank's rows
    ``want`` ([B/dp, S/m, d], m "model" ranks); its collectives on
    "model" include
    reduce-scatters, and no all-reduce there is as large as the whole
    residual [B/dp, S, d] (the sums over "model" between the products
    are reduce-scatters); nothing runs on another group; the decode step
    runs ``DECODE_CALLS[arch]`` collectives on "model".  Prints the
    prefill's collectives and the peak by stage beside
    ``EARLIER_STAGES``."""
    B, rows, d = want
    whole = B * rows * m * d * 2                    # bf16 [B/dp, S, d]
    kinds = calls["model"]
    rs = sum(v["calls"] for k, v in kinds.items() if "reduce_scatter" in k)
    ar = max((v["largest_bytes"] for k, v in kinds.items()
              if "allreduce" in k), default=0)
    _check(len(shapes) == layers and set(shapes) == {want},
           f"{label}: the residual entering the {len(shapes)} blocks of the "
           f"prefill was {sorted(set(shapes))}; want {layers} of {want}")
    _check(rs > 0 and ar < whole and calls["other"] == 0,
           f"{label}: the prefill's collectives {json.dumps(calls)}: want "
           f"reduce-scatters, no all-reduce of the whole residual "
           f"({whole} bytes) and none on another group")
    _check(decode_calls == DECODE_CALLS[arch],
           f"{label}: a decode step ran {decode_calls} collectives on "
           f"\"model\"; want {DECODE_CALLS[arch]}")
    print(f"{label}: sequence split: the residual entering each of the "
          f"{layers} blocks of the prefill is the rank's rows {list(want)} "
          f"([B/dp, S/m, d]); the prefill's collectives on \"model\" "
          f"{json.dumps(calls['model'])} ({calls['other']} on other "
          f"groups); peak device memory by stage {json.dumps(stage)} "
          f"against {json.dumps(EARLIER_STAGES[arch])} before the split "
          f"(GiB); the decode step's {decode_calls} collectives held; card "
          f"{card}")


def tp_share_phase(torch, dev, rows):
    """Phase 17: rank 0's share of qwen2-72b on a (1, 4) ("data",
    "model") mesh, a fake 4-rank group (module docstring): parameters by
    ``init_sharded_params`` on the card, a ``jit_prefill`` of
    ``TP_LANES`` x ``TP_PROMPT`` tokens into caches padded to ``TP_LEN``,
    ``TP_DECODE`` ``jit_decode`` steps (each rank's greedy pick over its
    own vocab columns).  No value is checked: the fake collectives leave
    their outputs unwritten.  Every part must run split, the cache piece
    must be [80, 8, 1024, 8, 128] and flash must run once a layer in the
    prefill.  Appends flash's row at the rank's prefill shape to
    ``rows``."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import init_sharded_params
    from repro_torch.serve.decode import (batch_shardings, jit_decode,
                                          jit_prefill)
    from repro_torch.sharding import specs
    from repro_torch.sharding.tensor_parallel import CollectiveLog
    from repro_torch.train.optimizer import leaves

    t0 = time.perf_counter()
    card = _card_line()
    cfg = get_config(TP_ARCH)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=TP_MODEL)
    try:
        mesh = make_host_mesh(TP_MODEL, dev)
        split = _split_parts(cfg, mesh)
        _check(all(split.values()), f"tp share: parts not split {split}")
        t1 = time.perf_counter()
        params = init_sharded_params(cfg, mesh, seed=5, device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t1
        stage, exact = {"init": _peak_since(torch, base)}, {}
        p_bytes = sum(t.to_local().numel() * t.to_local().element_size()
                      for t in leaves(params))
        shape = ShapeConfig("phase17", TP_LEN, TP_LANES, "prefill")
        pre, _ = jit_prefill(cfg, shape, mesh)
        dec, _ = jit_decode(cfg, dataclasses.replace(shape, kind="decode"),
                            mesh)
        g = torch.Generator(device=dev).manual_seed(6)
        prompt = torch.randint(0, cfg.vocab, (TP_LANES, TP_PROMPT),
                               generator=g, device=dev, dtype=torch.int32)
        b_sh = batch_shardings({"tokens": prompt}, mesh)["tokens"]
        t_sh = batch_shardings({"tokens": prompt[:, 0]}, mesh)["tokens"]
        vocab0 = cfg.vocab // TP_MODEL * mesh.get_coordinate()[1]
        _counts(zero=True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with _ResidualTap() as resid:
            logits, state = pre(params, {"tokens": specs.distribute(
                prompt, b_sh)})
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t1) * 1e3
        _stage_peak(torch, base, stage, exact, "prefill")
        launches = _counts(zero=True)
        piece = tuple(state.caches["k"].to_local().shape)
        want = (cfg.n_layers, TP_LANES, TP_LEN // TP_MODEL, cfg.n_kv_heads,
                cfg.hd)
        _check(piece == want, f"tp share: cache piece {piece}, want {want}")
        c_bytes = sum(t.to_local().numel() * t.to_local().element_size()
                      for t in state.caches.values())
        ms, rec = [], CollectiveLog()
        for i in range(TP_DECODE):
            tok = (logits.to_local().argmax(-1) + vocab0).to(torch.int32)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            if i == 0:
                with rec:
                    logits, state = dec(params, state, specs.distribute(
                        tok, t_sh))
            else:
                logits, state = dec(params, state, specs.distribute(tok,
                                                                    t_sh))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t1) * 1e3)
        dec_launches = _counts()
        _stage_peak(torch, base, stage, exact, "decode")
        peak = max(stage.values())
        model = mesh.get_group("model").group_name
        on_model = [c for c in rec.calls if c.group == model]
        kinds: dict = {}
        for c in on_model:
            op = c.op.split(".")[1]
            kinds[op] = kinds.get(op, 0) + 1
        wire = sum(_wire_bytes(c.op, c.nbytes, TP_MODEL) for c in on_model)
        largest = max(max(c.nbytes) for c in on_model)
        del state, logits
        calls = _prefill_calls(torch, pre, params, {
            "tokens": specs.distribute(prompt, b_sh)}, model)
        del params
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    _keep_share(TP_ARCH, shape, TP_PROMPT, {}, p_bytes, c_bytes, exact, calls,
                len(on_model), launches["flash_attention"],
                dec_launches["flash_attention"] / TP_DECODE)
    _seq_split_gates("tp share", TP_ARCH, resid.shapes,
                     (TP_LANES, TP_PROMPT // TP_MODEL, cfg.d_model),
                     TP_MODEL, cfg.n_layers, calls, stage, len(on_model),
                     card)
    st = sorted(ms[1:])
    p50, p90 = st[len(st) // 2], st[int(len(st) * 0.9)]
    bound_ms = p_bytes / HBM_BYTES_PER_S * 1e3
    _check(launches["flash_attention"] == cfg.n_layers
           and dec_launches["flash_attention"] == 0,
           f"tp share: flash launches prefill {launches}, decode "
           f"{dec_launches}; want {cfg.n_layers} in the prefill")
    print(f"tp share: {TP_ARCH} rank 0 of a (1, {TP_MODEL}) mesh on a "
          f"fake {TP_MODEL}-rank group (no value compared; no time "
          f"includes communication: the fake collectives move nothing), "
          f"published widths, {cfg.n_layers} layers, QKV bias, "
          f"{cfg.dtype}, parts {json.dumps(split)}: parameters of the "
          f"rank {p_bytes / 1e9:.2f} GB (init_sharded_params "
          f"{init_s:.1f} s), cache of the rank {c_bytes / 1e9:.2f} GB "
          f"(piece {list(piece)}), peak device memory of the rank "
          f"{peak:.2f} GiB (by stage {json.dumps(stage)}); card {card}")
    print(f"tp share: prefill of {TP_LANES} x {TP_PROMPT} tokens into "
          f"{TP_LEN} positions {prefill_ms:.1f} ms with flash launched "
          f"{launches['flash_attention']} times (once a layer, H "
          f"{cfg.n_heads // TP_MODEL}/{cfg.n_kv_heads // TP_MODEL} heads a "
          f"rank); decode ms a step p50 {p50:.2f}, p90 {p90:.2f} "
          f"(steps 2-{TP_DECODE}, synchronised, all "
          f"{[round(x, 2) for x in ms]}), against the weight-read bound "
          f"{bound_ms:.2f} ms (the rank's parameter bytes at "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s); excluding communication; "
          f"card {card}")
    print(f"tp share: a decode step on 4 cards would run {len(on_model)} "
          f"collectives on \"model\" ({json.dumps(kinds)}; "
          f"{len(rec.calls) - len(on_model)} on other groups), the largest "
          f"tensor {largest} bytes, {wire / 1e6:.3f} MB sent a rank by the "
          f"ring algorithms; phase 17 took {time.perf_counter() - t0:.1f} s")
    B, S = TP_LANES, TP_PROMPT
    H, KV, hd = cfg.n_heads // TP_MODEL, cfg.n_kv_heads // TP_MODEL, cfg.hd
    g = torch.Generator(device=dev).manual_seed(7)
    q, k, v = (torch.randn(B, S, h, hd, generator=g, device=dev).to(
        torch.bfloat16) for h in (H, KV, KV))
    base_row = rows["flash_attention"]
    row = _shape_row(base_row, TP_ARCH, f"tensor-parallel rank, B {B}, S {S}, "
                     f"T {S}, H {H}/{KV}, hd {hd}, causal, bf16",
                     **_flash_case(torch, dev, q, k, v, 0,
                                   f"at {TP_ARCH}'s rank shape (tp 4)"))
    row["launches"] = launches["flash_attention"]
    base_row["shapes"].append(row)


# ---------------------------------------------------------------------------
# phase 18: one rank's share of mixtral-8x22b on a (1, 4) mesh
# ---------------------------------------------------------------------------

MOE_ARCH, MOE_MODEL = "mixtral-8x22b", 4
# lanes, prompt tokens (under the 4,096-token window: a ring prefill takes
# no longer prompt) and decode steps (the ring wraps at step 64)
MOE_LANES, MOE_PROMPT, MOE_DECODE = 4, 4032, 128


def moe_share_phase(torch, dev, rows):
    """Phase 18: rank 0's share of mixtral-8x22b on a (1, 4) ("data",
    "model") mesh, a fake 4-rank group as phase 17's (no value compared,
    no communication timed), ``REPRO_WINDOW_CACHE=1``: parameters by
    ``init_sharded_params`` on the card (published widths, all 56
    layers, bf16; 2 of the 8 experts a rank), a ``jit_prefill`` of
    ``MOE_LANES`` x ``MOE_PROMPT`` tokens into a ring of 4,096 slots
    (1,024 on the rank), ``MOE_DECODE`` ``jit_decode`` steps past the
    window.  Gates: every part split, the experts by expert (2 a rank),
    the cache piece [56, 4, 1024, 8, 128], flash once a layer in the
    prefill and never in decode, the MoE layer dispatched once a layer
    in each call.  Prints peak memory by stage, parameter (and expert)
    and cache bytes, prefill ms, decode p50 and p90 against the weight
    bound, the expert rows computed a layer, and the collectives a
    decode step would run on four cards; then appends flash's row at the
    rank's prefill shape to ``rows``."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import init_sharded_params, moe
    from repro_torch.serve.decode import (batch_shardings, jit_decode,
                                          jit_prefill)
    from repro_torch.sharding import specs
    from repro_torch.sharding.tensor_parallel import CollectiveLog
    from repro_torch.train.optimizer import leaves

    t0 = time.perf_counter()
    card = _card_line()
    cfg = get_config(MOE_ARCH)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    caps = []                       # each dispatch's capacity (host ints)
    real = moe.dispatch

    def counted(eidx, n_experts, cap, offset=None):
        caps.append(cap)
        return real(eidx, n_experts, cap, offset)
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=MOE_MODEL)
    moe.dispatch = counted
    try:
        with _env(REPRO_WINDOW_CACHE="1"):
            mesh = make_host_mesh(MOE_MODEL, dev)
            tp = _split_of(cfg, mesh)
            split = _split_parts(cfg, mesh)
            n_loc = tp.moe_experts[0]
            _check(all(split.values()) and tp.moe_mode == "expert"
                   and n_loc == cfg.n_experts // MOE_MODEL,
                   f"moe share: parts {split}, MoE split "
                   f"{tp.moe_mode} {tp.moe_experts}")
            t1 = time.perf_counter()
            params = init_sharded_params(cfg, mesh, seed=5, device=dev)
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t1
            stage, exact = {"init": _peak_since(torch, base)}, {}
            p_bytes = sum(t.to_local().numel() * t.to_local().element_size()
                          for t in leaves(params))
            e_bytes = sum(t.to_local().numel() * t.to_local().element_size()
                          for t in params["blocks"]["moe"].values())
            shape = ShapeConfig("phase18", MOE_PROMPT + MOE_DECODE,
                                MOE_LANES, "prefill")
            pre, _ = jit_prefill(cfg, shape, mesh)
            dec, _ = jit_decode(cfg, dataclasses.replace(shape,
                                                         kind="decode"),
                                mesh)
            g = torch.Generator(device=dev).manual_seed(6)
            prompt = torch.randint(0, cfg.vocab, (MOE_LANES, MOE_PROMPT),
                                   generator=g, device=dev,
                                   dtype=torch.int32)
            b_sh = batch_shardings({"tokens": prompt}, mesh)["tokens"]
            t_sh = batch_shardings({"tokens": prompt[:, 0]}, mesh)["tokens"]
            vocab0 = cfg.vocab // MOE_MODEL * mesh.get_coordinate()[1]
            _counts(zero=True)
            caps.clear()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            with _ResidualTap() as resid:
                logits, state = pre(params, {"tokens": specs.distribute(
                    prompt, b_sh)})
            torch.cuda.synchronize()
            prefill_ms = (time.perf_counter() - t1) * 1e3
            _stage_peak(torch, base, stage, exact, "prefill")
            launches = _counts(zero=True)
            pre_caps = list(caps)
            caps.clear()
            slots = cfg.sliding_window
            piece = tuple(state.caches["k"].to_local().shape)
            want = (cfg.n_layers, MOE_LANES, slots // MOE_MODEL,
                    cfg.n_kv_heads, cfg.hd)
            _check(piece == want,
                   f"moe share: cache piece {piece}, want {want}")
            c_bytes = sum(t.to_local().numel() * t.to_local().element_size()
                          for t in state.caches.values())
            ms, rec = [], CollectiveLog()
            for i in range(MOE_DECODE):
                tok = (logits.to_local().argmax(-1) + vocab0).to(torch.int32)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                if i == 0:
                    with rec:
                        logits, state = dec(params, state, specs.distribute(
                            tok, t_sh))
                else:
                    logits, state = dec(params, state, specs.distribute(
                        tok, t_sh))
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t1) * 1e3)
            dec_launches = _counts()
            _stage_peak(torch, base, stage, exact, "decode")
            end = int(state.pos.to_local().max())
            model = mesh.get_group("model").group_name
            on_model = [c for c in rec.calls if c.group == model]
            kinds: dict = {}
            for c in on_model:
                op = c.op.split(".")[1]
                kinds[op] = kinds.get(op, 0) + 1
            wire = sum(_wire_bytes(c.op, c.nbytes, MOE_MODEL)
                       for c in on_model)
            largest = max(max(c.nbytes) for c in on_model)
            del state, logits
            n_caps = len(caps)
            calls = _prefill_calls(torch, pre, params, {
                "tokens": specs.distribute(prompt, b_sh)}, model)
            del caps[n_caps:], params
    finally:
        moe.dispatch = real
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    _keep_share(MOE_ARCH, shape, MOE_PROMPT, {"REPRO_WINDOW_CACHE": "1"},
                p_bytes, c_bytes, exact, calls, len(on_model),
                launches["flash_attention"],
                dec_launches["flash_attention"] / MOE_DECODE)
    _seq_split_gates("moe share", MOE_ARCH, resid.shapes,
                     (MOE_LANES, MOE_PROMPT // MOE_MODEL, cfg.d_model),
                     MOE_MODEL, cfg.n_layers, calls, stage, len(on_model),
                     card)
    peak = max(stage.values())
    st = sorted(ms[1:])
    p50, p90 = st[len(st) // 2], st[int(len(st) * 0.9)]
    bound_ms = p_bytes / HBM_BYTES_PER_S * 1e3
    dec_caps = caps[:cfg.n_layers]
    _check(launches["flash_attention"] == cfg.n_layers
           and dec_launches["flash_attention"] == 0,
           f"moe share: flash launches prefill {launches}, decode "
           f"{dec_launches}; want {cfg.n_layers} in the prefill")
    _check(len(pre_caps) == cfg.n_layers
           and len(caps) == cfg.n_layers * MOE_DECODE,
           f"moe share: {len(pre_caps)} dispatches in the prefill and "
           f"{len(caps)} in decode; want one a layer a call")
    _check(end == MOE_PROMPT + MOE_DECODE and end > slots,
           f"moe share: decode ended at {end}; the ring of {slots} slots "
           f"must wrap")
    print(f"moe share: {MOE_ARCH} rank 0 of a (1, {MOE_MODEL}) mesh on a "
          f"fake {MOE_MODEL}-rank group (no value compared; no time "
          f"includes communication), published widths, {cfg.n_layers} "
          f"layers, {cfg.dtype}, REPRO_WINDOW_CACHE=1, parts "
          f"{json.dumps(split)}, experts split by expert ({n_loc} of "
          f"{cfg.n_experts} a rank): parameters of the rank "
          f"{p_bytes / 1e9:.2f} GB ({e_bytes / 1e9:.2f} GB of experts; "
          f"init_sharded_params {init_s:.1f} s), ring cache of the rank "
          f"{c_bytes / 1e9:.3f} GB (piece {list(piece)} of {slots} slots), "
          f"peak device memory of the rank {peak:.2f} GiB above the "
          f"{base / 2**30:.2f} GiB held before (by stage "
          f"{json.dumps(stage)}); card {card}")
    print(f"moe share: prefill of {MOE_LANES} x {MOE_PROMPT} tokens into "
          f"the ring {prefill_ms:.1f} ms with flash launched "
          f"{launches['flash_attention']} times (once a layer, H "
          f"{cfg.n_heads // MOE_MODEL}/{cfg.n_kv_heads // MOE_MODEL} heads "
          f"a rank); expert rows computed a layer: prefill {n_loc} x "
          f"{pre_caps[0]} = {n_loc * pre_caps[0]}, decode {n_loc} x "
          f"{dec_caps[0]} = {n_loc * dec_caps[0]} (this rank's experts x "
          f"the call's capacity); decode ms a step p50 {p50:.2f}, p90 "
          f"{p90:.2f} (steps 2-{MOE_DECODE}, positions {MOE_PROMPT}-"
          f"{end - 1}, the ring wrapping at {slots}; synchronised, all "
          f"{[round(x, 2) for x in ms]}), against the weight-read bound "
          f"{bound_ms:.2f} ms (the rank's parameter bytes at "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s); excluding communication; "
          f"card {card}")
    print(f"moe share: a decode step on 4 cards would run {len(on_model)} "
          f"collectives on \"model\" ({json.dumps(kinds)}; "
          f"{len(rec.calls) - len(on_model)} on other groups), the largest "
          f"tensor {largest} bytes, {wire / 1e6:.3f} MB sent a rank by the "
          f"ring algorithms; phase 18 took {time.perf_counter() - t0:.1f} s")
    B, S = MOE_LANES, MOE_PROMPT
    H, KV, hd = cfg.n_heads // MOE_MODEL, cfg.n_kv_heads // MOE_MODEL, cfg.hd
    g = torch.Generator(device=dev).manual_seed(8)
    q, k, v = (torch.randn(B, S, h, hd, generator=g, device=dev).to(
        torch.bfloat16) for h in (H, KV, KV))
    base_row = rows["flash_attention"]
    row = _shape_row(base_row, MOE_ARCH, f"expert-parallel rank, B {B}, S "
                     f"{S}, T {S}, H {H}/{KV}, hd {hd}, causal, window "
                     f"{cfg.sliding_window}, bf16",
                     **_flash_case(torch, dev, q, k, v, 0,
                                   f"at {MOE_ARCH}'s rank shape (tp 4)",
                                   window=cfg.sliding_window))
    row["launches"] = launches["flash_attention"]
    base_row["shapes"].append(row)


# ---------------------------------------------------------------------------
# phase 19: one rank's share of llama-3.2-vision-90b on a (1, 4) mesh
# ---------------------------------------------------------------------------

VLM_MODEL = 4
VLM_SHARE_LANES, VLM_SHARE_PROMPT, VLM_SHARE_LEN = 4, 2048, 4096
VLM_SHARE_DECODE = 32


def vlm_share_phase(torch, dev, rows):
    """Phase 19: rank 0's share of llama-3.2-vision-90b on a (1, 4)
    ("data", "model") mesh, a fake 4-rank group as phase 17's (no value
    compared, no communication timed): parameters by
    ``init_sharded_params`` on the card (published widths, all 100
    layers, bf16, every cross gate at ``SHARD_VLM_GATE``), a
    ``jit_prefill`` of ``VLM_SHARE_LANES`` x ``VLM_SHARE_PROMPT`` tokens
    over 1,601 seeded bf16 image tokens into caches padded to
    ``VLM_SHARE_LEN``, then ``VLM_SHARE_DECODE`` ``jit_decode`` steps.
    Gates: every part split, the self cache piece [20, 4, 4, 1024, 8,
    128], the image K/V [20, 4, 1601, 8, 128] (whole over "model"),
    flash 80 times in the self layers and 20 in the cross layers of the
    prefill and 20 times a decode step, 441 collectives a decode step on
    "model" and none on another group.  Prints peak memory by stage,
    parameter and cache bytes, prefill ms, decode p50 and p90 against
    the bound of one read of the rank's parameters, its self cache piece
    and its KV heads of the image K/V; then appends flash's rows at the
    rank's self prefill, cross prefill and cross decode shapes to
    ``rows``."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import init_sharded_params
    from repro_torch.serve.decode import (batch_shardings, jit_decode,
                                          jit_prefill)
    from repro_torch.sharding import specs
    from repro_torch.sharding.tensor_parallel import CollectiveLog
    from repro_torch.train.optimizer import leaves

    t0 = time.perf_counter()
    card = _card_line()
    cfg = get_config(VLM_ARCH)
    ns, inner = cfg.vlm_dims
    B, S, T = VLM_SHARE_LANES, VLM_SHARE_PROMPT, cfg.n_image_tokens
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=VLM_MODEL)
    try:
        mesh = make_host_mesh(VLM_MODEL, dev)
        split = _split_parts(cfg, mesh)
        _check(all(split.values()), f"vlm share: parts not split {split}")
        t1 = time.perf_counter()
        params = init_sharded_params(cfg, mesh, seed=5, device=dev)
        params["blocks"]["cross"]["attn"]["gate"].to_local().fill_(
            SHARD_VLM_GATE)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t1
        stage, exact = {"init": _peak_since(torch, base)}, {}
        p_bytes = sum(t.to_local().numel() * t.to_local().element_size()
                      for t in leaves(params))
        shape = ShapeConfig("phase19", VLM_SHARE_LEN, B, "prefill")
        pre, _ = jit_prefill(cfg, shape, mesh)
        dec, _ = jit_decode(cfg, dataclasses.replace(shape, kind="decode"),
                            mesh)
        g = torch.Generator(device=dev).manual_seed(6)
        prompt = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=g,
                                          device=dev, dtype=torch.int32),
                  "image_embeds": torch.randn(
                      (B, T, cfg.d_model), generator=g,
                      device=dev).to(torch.bfloat16)}
        b_sh = batch_shardings(prompt, mesh)
        t_sh = batch_shardings({"tokens": prompt["tokens"][:, 0]},
                               mesh)["tokens"]
        vocab0 = cfg.vocab // VLM_MODEL * mesh.get_coordinate()[1]
        _counts(zero=True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with _CrossTap() as cross, _ResidualTap() as resid:
            logits, state = pre(params, {k: specs.distribute(v, b_sh[k])
                                         for k, v in prompt.items()})
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t1) * 1e3
        _stage_peak(torch, base, stage, exact, "prefill")
        launches = _counts(zero=True)
        pieces = {k: tuple(t.to_local().shape)
                  for k, t in state.caches.items()}
        want = {"k": (ns, inner, B, VLM_SHARE_LEN // VLM_MODEL,
                      cfg.n_kv_heads, cfg.hd),
                "ik": (ns, B, T, cfg.n_kv_heads, cfg.hd)}
        _check(pieces["k"] == want["k"] and pieces["ik"] == want["ik"],
               f"vlm share: cache pieces {pieces}, want {want}")
        c_bytes = {k: t.to_local().numel() * t.to_local().element_size()
                   for k, t in state.caches.items()}
        ms, rec = [], CollectiveLog()
        for i in range(VLM_SHARE_DECODE):
            tok = (logits.to_local().argmax(-1) + vocab0).to(torch.int32)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            if i == 0:
                with rec:
                    logits, state = dec(params, state, specs.distribute(
                        tok, t_sh))
            else:
                logits, state = dec(params, state, specs.distribute(tok,
                                                                    t_sh))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t1) * 1e3)
        dec_launches = _counts()
        _stage_peak(torch, base, stage, exact, "decode")
        end = int(state.pos.to_local().max())
        model = mesh.get_group("model").group_name
        on_model = [c for c in rec.calls if c.group == model]
        kinds: dict = {}
        for c in on_model:
            op = c.op.split(".")[1]
            kinds[op] = kinds.get(op, 0) + 1
        wire = sum(_wire_bytes(c.op, c.nbytes, VLM_MODEL) for c in on_model)
        largest = max(max(c.nbytes) for c in on_model)
        del state, logits
        calls = _prefill_calls(torch, pre, params, {
            k: specs.distribute(v, b_sh[k]) for k, v in prompt.items()},
            model)
        del params, prompt
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    _keep_share(VLM_ARCH, shape, S, {}, p_bytes, sum(c_bytes.values()), exact,
                calls, len(on_model), launches["flash_attention"],
                dec_launches["flash_attention"] / VLM_SHARE_DECODE)
    _seq_split_gates("vlm share", VLM_ARCH, resid.shapes,
                     (B, S // VLM_MODEL, cfg.d_model), VLM_MODEL,
                     ns * inner, calls, stage, len(on_model), card)
    peak = max(stage.values())
    st = sorted(ms[1:])
    p50, p90 = st[len(st) // 2], st[int(len(st) * 0.9)]
    # one decode step reads the rank's weights, its self cache piece and
    # its KV heads of the image K/V once
    read = p_bytes + c_bytes["k"] + c_bytes["v"] + (
        c_bytes["ik"] + c_bytes["iv"]) // VLM_MODEL
    bound_ms = read / HBM_BYTES_PER_S * 1e3
    n_self, n_cross = ns * inner, ns
    want_calls = 5 * n_self + 2 * n_cross + 1
    _check(launches["flash_attention"] == n_self + n_cross
           and cross.launches == n_cross
           and dec_launches["flash_attention"] == n_cross * VLM_SHARE_DECODE,
           f"vlm share: flash launches prefill {launches['flash_attention']} "
           f"({cross.launches} cross), decode "
           f"{dec_launches['flash_attention']}; want {n_self + n_cross} "
           f"({n_cross} cross) and {n_cross} a decode step")
    _check(len(on_model) == want_calls and len(rec.calls) == want_calls,
           f"vlm share: a decode step ran {len(on_model)} collectives on "
           f"\"model\" and {len(rec.calls) - len(on_model)} on other "
           f"groups; want {want_calls} (5 a self layer, 2 a cross layer, 1 "
           f"for the embedding) and none")
    _check(end == S + VLM_SHARE_DECODE,
           f"vlm share: decode ended at {end}, want {S + VLM_SHARE_DECODE}")
    print(f"vlm share: {VLM_ARCH} rank 0 of a (1, {VLM_MODEL}) mesh on a "
          f"fake {VLM_MODEL}-rank group (no value compared; no time "
          f"includes communication), published widths, {cfg.n_layers} "
          f"layers ({ns} super-blocks of {inner} self + 1 cross), "
          f"{cfg.dtype}, gates {SHARD_VLM_GATE}, parts {json.dumps(split)}: "
          f"parameters of the rank {p_bytes / 1e9:.2f} GB "
          f"(init_sharded_params {init_s:.1f} s), self cache of the rank "
          f"{(c_bytes['k'] + c_bytes['v']) / 1e9:.3f} GB (piece "
          f"{list(pieces['k'])}), image K/V {(c_bytes['ik'] + c_bytes['iv']) / 1e9:.3f} "
          f"GB (whole over \"model\", {list(pieces['ik'])}), peak device "
          f"memory of the rank {peak:.2f} GiB above the {base / 2**30:.2f} "
          f"GiB held before (by stage {json.dumps(stage)}); card {card}")
    print(f"vlm share: prefill of {B} x {S} tokens over {T} image tokens "
          f"into {VLM_SHARE_LEN} positions {prefill_ms:.1f} ms with flash "
          f"launched {launches['flash_attention']} times "
          f"({launches['flash_attention'] - cross.launches} self, "
          f"{cross.launches} cross; H {cfg.n_heads // VLM_MODEL}/"
          f"{cfg.n_kv_heads // VLM_MODEL} heads a rank); decode ms a step "
          f"p50 {p50:.2f}, p90 {p90:.2f} (steps 2-{VLM_SHARE_DECODE}, "
          f"synchronised, all {[round(x, 2) for x in ms]}; flash "
          f"{dec_launches['flash_attention']} launches in all), against "
          f"the bound {bound_ms:.2f} ms (one read of the rank's "
          f"parameters, self cache piece and KV heads of the image K/V, "
          f"{read / 1e9:.2f} GB at {HBM_BYTES_PER_S / 1e12:.2f} TB/s); "
          f"excluding communication; card {card}")
    print(f"vlm share: a decode step on 4 cards would run {len(on_model)} "
          f"collectives on \"model\" ({json.dumps(kinds)}; "
          f"{len(rec.calls) - len(on_model)} on other groups), the largest "
          f"tensor {largest} bytes, {wire / 1e6:.3f} MB sent a rank by the "
          f"ring algorithms; phase 19 took {time.perf_counter() - t0:.1f} s")
    H, KV, hd = cfg.n_heads // VLM_MODEL, cfg.n_kv_heads // VLM_MODEL, cfg.hd
    g = torch.Generator(device=dev).manual_seed(9)
    q, k, v = (torch.randn(B, S, h, hd, generator=g, device=dev).to(
        torch.bfloat16) for h in (H, KV, KV))
    ik, iv = (torch.randn(B, T, KV, hd, generator=g, device=dev).to(
        torch.bfloat16) for _ in range(2))
    base_row = rows["flash_attention"]
    cases = (("self prefill", q, k, v, True, n_self),
             ("cross prefill", q, ik, iv, False, n_cross),
             ("cross decode", q[:, -1:].contiguous(), ik, iv, False,
              n_cross * VLM_SHARE_DECODE))
    for label, qq, kk, vv, causal, n in cases:
        row = _shape_row(
            base_row, VLM_ARCH, f"tensor-parallel rank, {label}, B {B}, S "
            f"{qq.shape[1]}, T {kk.shape[1]}, H {H}/{KV}, hd {hd}, "
            f"{'causal' if causal else 'non-causal'}, bf16",
            **_flash_case(torch, dev, qq, kk, vv, 0,
                          f"{label} at {VLM_ARCH}'s rank shape (tp 4)",
                          causal=causal))
        row["launches"] = n
        base_row["shapes"].append(row)
    del q, k, v, ik, iv
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 20: one rank's share of each recurrent family on a (1, 4) mesh
# ---------------------------------------------------------------------------

REC_MODEL = 4
REC_SHARE_LANES, REC_SHARE_PROMPT, REC_SHARE_LEN = 2, 2048, 4096
REC_SHARE_DECODE = 64
# PR 19's flash row at hymba's heads (B 1, S = T = 2048, window 1024):
# its time on the card in ms (PERF.md, the kernel table)
HYMBA_FLASH_PR19_MS = 0.1049


def _rec_decode_calls(cfg, tp, seq_split: bool) -> int:
    """The collectives a split decode step of a recurrent family runs on
    "model" (``tests/test_torch_split_recurrent.py``'s count): xLSTM, 2 a
    layer (the output's sum, the state's gather); hymba, per layer the
    lse's max and merge over a sequence-split cache, q/k/v gathered and wo
    summed where attention splits (else its leaves that ``spec_for`` split
    gathered), ``in_proj``'s products with each rank's piece gathered,
    dt/B/C and ``out_proj`` summed, the state gathered, the MLP summed; and
    the embedding's sum where the vocabulary splits."""
    vocab = int(tp.split["vocab"])
    if cfg.family == "ssm":
        return 2 * cfg.n_layers + vocab
    if tp.split["attn"]:
        attn = 2
    else:
        attn = sum(1 for path, plan in tp.plans.items()
                   if "/attn/" in path and any(i == tp.m
                                               for i, _ in plan.gathers))
    return cfg.n_layers * (2 * seq_split + attn + 4 + int(
        tp.split["mlp"])) + vocab


class _ScanTap:
    """Records, while on, the width of each ``ssm_scan`` call's xz and of
    its conv taps: the channels of x and z the Mamba branch computes."""

    def __enter__(self):
        from repro_torch.models import ssm

        self.mod, self.real, self.widths = ssm, ssm.ssm_scan, set()

        def tap(p, xz, cfg, tp=None):
            self.widths.add((xz.shape[-1], p["conv_w"].shape[-1]))
            return self.real(p, xz, cfg, tp)
        ssm.ssm_scan = tap
        return self

    def __exit__(self, *exc):
        self.mod.ssm_scan = self.real


def _rec_share(torch, dev, arch):
    """Rank 0's share of ``arch`` (hymba-1.5b or xlstm-125m) on a
    (1, ``REC_MODEL``) mesh of a fake group, as phase 17's; its gates
    (the module docstring's phase 20).  Returns the flash launches of
    its prefill."""
    import warnings

    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import init_sharded_params
    from repro_torch.serve.decode import (batch_shardings, jit_decode,
                                          jit_prefill)
    from repro_torch.sharding import specs
    from repro_torch.sharding.tensor_parallel import CollectiveLog
    from repro_torch.train.optimizer import leaves

    t0 = time.perf_counter()
    card = _card_line()
    cfg = get_config(arch)
    B, S, L = REC_SHARE_LANES, REC_SHARE_PROMPT, cfg.n_layers
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=REC_MODEL)
    try:
        mesh = make_host_mesh(REC_MODEL, dev)
        tp = _split_of(cfg, mesh)
        split = {k: v for k, v in tp.split.items() if k != "moe"}
        t1 = time.perf_counter()
        params = init_sharded_params(cfg, mesh, seed=5, device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t1
        stage, exact = {"init": _peak_since(torch, base)}, {}
        p_bytes = sum(t.to_local().numel() * t.to_local().element_size()
                      for t in leaves(params))
        blocks = params["blocks"]
        if cfg.family == "hybrid":
            di, ff = cfg.d_model, cfg.d_ff
            ch = tp.ssm_channels()
            pieces = {"conv_w": tuple(blocks["ssm"]["conv_w"].to_local()
                                      .shape),
                      "in_proj": tuple(blocks["ssm"]["in_proj"].to_local()
                                       .shape),
                      "w_gate": tuple(blocks["mlp"]["w_gate"].to_local()
                                      .shape)}
            want_pieces = {"conv_w": (L, cfg.ssm_conv, di // REC_MODEL),
                           "in_proj": (L, cfg.d_model, 2 * di // REC_MODEL),
                           "w_gate": (L, cfg.d_model, ff // REC_MODEL)}
            _check(split["ssm"] and split["mlp"] and not split["attn"]
                   and not split["vocab"] and pieces == want_pieces
                   and (ch.start, ch.stop) == (0, di // REC_MODEL),
                   f"rec share {arch}: parts {split}, pieces {pieces} (want "
                   f"{want_pieces}), channels {ch}")
        else:
            pieces = {k: tuple(blocks[k].to_local().shape)
                      for k in ("m_qkv", "s_r", "m_og", "m_out")}
            _check(all(split.values())
                   and pieces["m_qkv"][-2] == cfg.n_heads // REC_MODEL
                   and pieces["s_r"][1] == cfg.n_heads // REC_MODEL,
                   f"rec share {arch}: parts {split}, pieces {pieces}")
        shape = ShapeConfig("phase20", REC_SHARE_LEN, B, "prefill")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            pre, _ = jit_prefill(cfg, shape, mesh)
            dec, _ = jit_decode(cfg, dataclasses.replace(shape,
                                                         kind="decode"),
                                mesh)
        whole = [str(w.message) for w in caught
                 if " whole on each of" in str(w.message)]
        want_whole = 2 * bool(tp.whole_parts())
        _check(len(whole) == want_whole
               and all("attn" in w for w in whole[:want_whole]),
               f"rec share {arch}: warnings of whole parts {whole}, want "
               f"{want_whole} naming attn")
        g = torch.Generator(device=dev).manual_seed(6)
        prompt = torch.randint(0, cfg.vocab, (B, S), generator=g,
                               device=dev, dtype=torch.int32)
        b_sh = batch_shardings({"tokens": prompt}, mesh)["tokens"]
        t_sh = batch_shardings({"tokens": prompt[:, 0]}, mesh)["tokens"]
        vocab0 = tp.vocab_start
        _counts(zero=True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with _ScanTap() as scan, _ResidualTap() as resid:
            logits, state = pre(params, {"tokens": specs.distribute(prompt,
                                                                    b_sh)})
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t1) * 1e3
        _stage_peak(torch, base, stage, exact, "prefill")
        launches = _counts(zero=True)
        if cfg.family == "hybrid":
            n = di // REC_MODEL
            _check(scan.widths == {(2 * n, n)},
                   f"rec share {arch}: the scan took (xz, conv) widths "
                   f"{scan.widths}, want {(2 * n, n)}")
        pos0 = state.pos.to_local().tolist()
        state_pieces = {k: tuple(t.to_local().shape)
                        for k, t in _paths(state.caches).items()}
        s_bytes = sum(t.to_local().numel() * t.to_local().element_size()
                      for t in _leaves(state.caches))
        seq_split = "k" in state.caches and \
            state.caches["k"].to_local().shape[2] < REC_SHARE_LEN
        ms, rec = [], CollectiveLog()
        for i in range(REC_SHARE_DECODE):
            tok = (logits.to_local().argmax(-1) + vocab0).to(torch.int32)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            if i == 0:
                with rec:
                    logits, state = dec(params, state, specs.distribute(
                        tok, t_sh))
            else:
                logits, state = dec(params, state, specs.distribute(tok,
                                                                    t_sh))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t1) * 1e3)
        dec_launches = _counts()
        _stage_peak(torch, base, stage, exact, "decode")
        end = state.pos.to_local().tolist()
        model = mesh.get_group("model").group_name
        on_model = [c for c in rec.calls if c.group == model]
        kinds: dict = {}
        for c in on_model:
            op = c.op.split(".")[1]
            kinds[op] = kinds.get(op, 0) + 1
        wire = sum(_wire_bytes(c.op, c.nbytes, REC_MODEL) for c in on_model)
        largest = max(max(c.nbytes) for c in on_model)
        want_calls = _rec_decode_calls(cfg, tp, seq_split)
        del state, logits
        calls = _prefill_calls(torch, pre, params, {
            "tokens": specs.distribute(prompt, b_sh)}, model)
        del params
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    _keep_share(arch, shape, S, {}, p_bytes, s_bytes, exact, calls,
                len(on_model), launches["flash_attention"],
                dec_launches["flash_attention"] / REC_SHARE_DECODE)
    _seq_split_gates(f"rec share {arch}", arch, resid.shapes,
                     (B, S // REC_MODEL, cfg.d_model), REC_MODEL, L, calls,
                     stage, len(on_model), card)
    if arch == "hymba-1.5b":
        _check(f"{wire / 1e6:.3f}" == "7.417",
               f"rec share {arch}: a decode step would send "
               f"{wire / 1e6:.3f} MB a rank; want 7.417")
    peak = max(stage.values())
    st = sorted(ms[1:])
    p50, p90 = st[len(st) // 2], st[int(len(st) * 0.9)]
    n_attn = _attention_layers(cfg)
    _check(launches["flash_attention"] == n_attn
           and dec_launches["flash_attention"] == 0,
           f"rec share {arch}: flash launches prefill {launches}, decode "
           f"{dec_launches}; want {n_attn} in the prefill, none in decode")
    _check(len(on_model) == want_calls and len(rec.calls) == want_calls,
           f"rec share {arch}: a decode step ran {len(on_model)} "
           f"collectives on \"model\" and {len(rec.calls) - len(on_model)} "
           f"on other groups; want {want_calls} and none")
    _check(pos0 == [0] * B and end == [REC_SHARE_DECODE] * B,
           f"rec share {arch}: positions after the prefill {pos0} (want the "
           f"cold state's 0), after the decode {end}")
    print(f"rec share: {arch} rank 0 of a (1, {REC_MODEL}) mesh on a fake "
          f"{REC_MODEL}-rank group (no value compared; no time includes "
          f"communication), published widths, {L} layers, {cfg.dtype}, "
          f"parts {json.dumps(split)}, pieces {json.dumps(pieces)}"
          + (f", the scan on x columns [{ch.start}, {ch.stop}) and z "
             f"columns [{di + ch.start}, {di + ch.stop}) of in_proj"
             if cfg.family == "hybrid" else "")
          + f", warnings of whole parts {len(whole)}: parameters of the "
          f"rank {p_bytes / 1e9:.3f} GB (init_sharded_params "
          f"{init_s:.1f} s), state of the rank {s_bytes / 1e9:.3f} GB "
          f"({json.dumps(state_pieces)}), peak device memory of the rank "
          f"{peak:.2f} GiB above the {base / 2**30:.2f} GiB held before (by "
          f"stage {json.dumps(stage)}); card {card}")
    print(f"rec share: {arch} prefill of {B} x {S} tokens (the cold state: "
          f"positions {pos0}) {prefill_ms:.1f} ms with flash launched "
          f"{launches['flash_attention']} times; decode ms a step p50 "
          f"{p50:.2f}, p90 {p90:.2f} (steps 2-{REC_SHARE_DECODE}, positions "
          f"0-{REC_SHARE_DECODE - 1}, synchronised, all "
          f"{[round(x, 2) for x in ms]}); excluding communication; card "
          f"{card}")
    print(f"rec share: {arch} a decode step on 4 cards would run "
          f"{len(on_model)} collectives on \"model\" ({json.dumps(kinds)}; "
          f"{len(rec.calls) - len(on_model)} on other groups; the CPU "
          f"test's count {want_calls}), the largest tensor {largest} bytes, "
          f"{wire / 1e6:.3f} MB sent a rank by the ring algorithms; "
          f"{time.perf_counter() - t0:.1f} s")
    return launches["flash_attention"]


def rec_share_phase(torch, dev, rows):
    """Phase 20: rank 0's share of hymba-1.5b, then of xlstm-125m, on a
    (1, 4) mesh of a fake group (``_rec_share``); then flash at hymba's
    rank prefill shape (the whole H 25/5 of its windowed layers), checked
    and timed as phase 3's rows, and at PR 19's B 1 row beside that
    row's time."""
    from repro_torch.configs import get_config
    from repro_torch.models import layer_flags

    t0 = time.perf_counter()
    flash = {arch: _rec_share(torch, dev, arch) for arch in RECURRENT_ARCHS}
    cfg = get_config("hymba-1.5b")
    H, KV, hd, w = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.sliding_window
    S = REC_SHARE_PROMPT
    g = torch.Generator(device=dev).manual_seed(10)
    base_row = rows["flash_attention"]
    for B in (REC_SHARE_LANES, 1):
        q, k, v = (torch.randn(B, S, h, hd, generator=g, device=dev).to(
            torch.bfloat16) for h in (H, KV, KV))
        res = _flash_case(torch, dev, q, k, v, 0,
                          f"at hymba-1.5b's rank shape (tp 4, B {B})",
                          window=w)
        if B == 1:
            print(f"rec share: flash at PR 19's row shape (B 1, S = T = "
                  f"{S}, H {H}/{KV}, hd {hd}, window {w}, bf16) "
                  f"{res['ms']:.4f} ms against that row's "
                  f"{HYMBA_FLASH_PR19_MS} ms; card {_card_line()}")
            continue
        row = _shape_row(
            base_row, "hymba-1.5b", f"tensor-parallel rank (attention whole), "
            f"B {B}, S {S}, T {S}, H {H}/{KV}, hd {hd}, causal, window {w}, "
            f"bf16", **res)
        # the windowed layers of phase 20's prefill (the global ones
        # attend without a window)
        row["launches"] = flash["hymba-1.5b"] - int(layer_flags(cfg).sum())
        base_row["shapes"].append(row)
        del q, k, v
    torch.cuda.empty_cache()
    print(f"rec share: phase 20 took {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 21: the dry run against the card
# ---------------------------------------------------------------------------

# the reckoned stage peak's tolerance against the measured one (bytes)
DRYRUN_PEAK_FRAC, DRYRUN_PEAK_MIN = 0.03, 16 * 2**20
# one production cell a family, on the 16x16 mesh
DRYRUN_CELLS = (("llama3-8b", "train_4k"), ("mixtral-8x22b", "decode_32k"),
                ("llama-3.2-vision-90b", "prefill_32k"),
                ("hymba-1.5b", "long_500k"), ("hubert-xlarge", "train_4k"))


def _gib(n: int) -> float:
    return n / 2**30


def _share_reckoning(torch, dev, arch, m: dict) -> dict:
    """Phase 21(a) for one rank share: ``run_step`` of its prefill and of
    one decode step on fake "cuda" tensors over a fake (1, 4) group, held
    against phases 17-20's measurements ``m`` (``_keep_share``)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import run_step
    from repro_torch.sharding.specs import MeshShape

    cfg = get_config(arch)
    mesh = MeshShape((1, 4), ("data", "model"))
    with _env(**m["env"]):
        pre = run_step(cfg, m["shape"], mesh, device=dev,
                       prompt_len=m["prompt"])
        dec = run_step(cfg, dataclasses.replace(m["shape"], kind="decode"),
                       mesh, device=dev)
    label = f"dryrun share {arch}"
    model = pre["calls"].get("model", {})
    other = sum(v["calls"] for ax, ops in pre["calls"].items()
                if ax != "model" for v in ops.values())
    dec_model = sum(v["calls"] for v in dec["calls"].get("model",
                                                          {}).values())
    flash = (pre["ops"].get("repro_torch.flash_fwd", 0),
             dec["ops"].get("repro_torch.flash_fwd", 0))
    _check(pre["parts"]["params"] == m["p_bytes"]
           and pre["caches"] == m["c_bytes"],
           f"{label}: reckoned parameter and cache bytes "
           f"{pre['parts']['params']}, {pre['caches']}; measured "
           f"{m['p_bytes']}, {m['c_bytes']}")
    _check(model == m["calls"]["model"] and other == m["calls"]["other"],
           f"{label}: reckoned prefill collectives on \"model\" "
           f"{json.dumps(model)} ({other} elsewhere); measured "
           f"{json.dumps(m['calls'])}")
    _check(dec_model == m["decode_calls"],
           f"{label}: reckoned {dec_model} collectives a decode step on "
           f"\"model\"; measured {m['decode_calls']}")
    _check(flash == (m["flash_prefill"], m["flash_decode"]),
           f"{label}: flash's fake calls (prefill, a decode step) {flash}; "
           f"launches measured {(m['flash_prefill'], m['flash_decode'])}")
    peaks = {"prefill": pre["memory"]["peak_bytes"],
             "decode": dec["memory"]["peak_bytes"]}
    for stage, reck in peaks.items():
        meas = m["stage"][stage]
        tol = max(DRYRUN_PEAK_FRAC * meas, DRYRUN_PEAK_MIN)
        _check(abs(reck - meas) <= tol,
               f"{label}: reckoned {stage} peak {reck} bytes, measured "
               f"{meas} (tolerance {tol:.0f})")
    print(f"{label}: reckoned against measured (rank 0 of (1, 4), fake "
          f"\"cuda\" tensors; held): parameters {pre['parts']['params']} "
          f"bytes, caches {pre['caches']} bytes (equal); prefill "
          f"collectives on \"model\" {json.dumps(model)} (equal); decode "
          f"step {dec_model} collectives (equal); flash {flash[0]} calls in "
          f"the prefill and {flash[1]} a decode step (equal); peak GiB "
          f"prefill {_gib(peaks['prefill']):.4f} against "
          f"{_gib(m['stage']['prefill']):.4f}, decode "
          f"{_gib(peaks['decode']):.4f} against "
          f"{_gib(m['stage']['decode']):.4f} (bytes {json.dumps(peaks)} "
          f"against {json.dumps(m['stage'])}; held within 3 %, at least "
          f"16 MiB) "
          f"(arguments {_gib(pre['memory']['argument_size_in_bytes']):.3f} "
          f"+ temp {_gib(pre['memory']['temp_size_in_bytes']):.3f}; "
          f"{_gib(dec['memory']['argument_size_in_bytes']):.3f} + "
          f"{_gib(dec['memory']['temp_size_in_bytes']):.3f}); traced in "
          f"{pre['trace_s']} + {dec['trace_s']} s")
    return {"arch": arch, "prefill": pre, "decode": dec, "measured": {
        k: v for k, v in m.items() if k not in ("shape", "env")}}


def dryrun_phase(torch, dev):
    """Phase 21 (module docstring): (a) the rank shares of phases 17-20
    reckoned and held against their measurements, (b) one production
    cell a family on 16x16.  Writes every record to
    ``dryrun_results/phase21.json`` (gitignored)."""
    from repro_torch.launch.dryrun import run_cell

    t0 = time.perf_counter()
    card = _card_line()
    _check(set(SHARES) == {TP_ARCH, MOE_ARCH, VLM_ARCH, *RECURRENT_ARCHS},
           f"dryrun: rank shares measured {sorted(SHARES)}")
    out = {"shares": [_share_reckoning(torch, dev, arch, m)
                      for arch, m in SHARES.items()], "cells": []}
    for arch, shape in DRYRUN_CELLS:
        rec = run_cell(arch, shape, False, device=dev)
        _check(rec["status"] == "ok", f"dryrun: {arch} x {shape}: {rec}")
        out["cells"].append(rec)
        mem, coll = rec["memory"], rec["collectives"]
        print(f"dryrun cell: {arch} x {shape} on 16x16 (rank 0 of 256, fake "
              f"\"cuda\" tensors): status ok, arguments "
              f"{_gib(mem['argument_size_in_bytes']):.2f} GiB, peak "
              f"{_gib(mem['peak_bytes']):.2f} GiB, fits {rec['fits']}, "
              f"FLOPs {rec['cost']['flops']:.4e}, bytes "
              f"{rec['cost']['bytes']:.4e}, collective bytes "
              f"{coll['total_bytes']:.4e} ({json.dumps(coll['by_axis_bytes'])}),"
              f" dominant {rec['roofline']['dominant']} "
              f"({rec['roofline']['bound_s'] * 1e3:.2f} ms), flash "
              f"{json.dumps(rec['ops'])}, traced in {rec['trace_s']} s; "
              f"card {card}")
    path = ROOT / "dryrun_results" / "phase21.json"
    path.parent.mkdir(exist_ok=True)
    path.write_text(json.dumps(out, indent=1, default=str))
    print(f"dryrun: phase 21 took {time.perf_counter() - t0:.1f} s")


def _paths(tree, prefix: str = "") -> dict:
    """path -> leaf of a tree of dicts."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


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
    seconds = {}                  # phase -> host seconds, in run order

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = round(time.perf_counter() - t0, 1)
        return out

    from repro_torch.kernels import _build
    secs = phase("2 build", _build.build_all)
    print(f"build: {len(_build.SOURCES)} kernel libraries in {secs:.1f} s "
          f"(nvcc, sm_90a, one process per source)")
    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"build: {name}: {line.strip()}")

    rows = phase("3 kernels", kernel_phase, torch, dev)
    cfg, params = phase("4 model", main_model, torch, dev)
    launches = phase("4 main path", main_path_phase, torch, dev, cfg, params)
    phase("15 graphs", graphs_phase, torch, dev, cfg, params)
    phase("5 dense-tiered", dense_tiered_phase, torch, dev)
    launches.update(phase("6 server", server_phase, torch, dev))
    launches.update(phase("7 chunked", chunked_qos_phase, torch, dev, cfg,
                          params))
    phase("8 chunk equivalence", chunk_equivalence_phase, torch, dev, cfg,
          params)
    phase("9 telemetry", telemetry_phase, torch, dev, cfg, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    rows["sim_scan"], launches["sim_scan"] = phase("10 simulator", sim_phase,
                                                   torch, dev)
    phase("11 families", families_phase, torch, dev, rows)
    phase("12 recurrent", recurrent_phase, torch, dev, rows)
    phase("13 vlm/audio", vlm_audio_phase, torch, dev, rows)
    gc.collect()
    torch.cuda.empty_cache()
    phase("14 train", train_phase, torch, dev, rows, launches)
    phase("16 sharding", sharding_phase, torch, dev)
    phase("17 tp share", tp_share_phase, torch, dev, rows)
    phase("18 moe share", moe_share_phase, torch, dev, rows)
    phase("19 vlm share", vlm_share_phase, torch, dev, rows)
    phase("20 recurrent share", rec_share_phase, torch, dev, rows)
    phase("21 dry run", dryrun_phase, torch, dev)
    print(f"phases: host seconds {json.dumps(seconds)}, "
          f"{sum(seconds.values()):.1f} s in all")
    for name, n in launches.items():
        rows[name]["launches"] = n
    print(json.dumps({"kernels": [rows[k] for k in sorted(rows)]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
