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
4. main path: llama3-8b at its published width (32 layers, bf16, seeded
   random weights made on the card) served by the tiered engine (its
   one-shot prefill runs the flash kernel); launch counts are reset just
   before the run and read just after, one copy-engine launch per
   maintenance pass; tokens/s, step times and the wall time by engine
   phase.
5. dense against tiered at full width (2 layers, fp32, teacher-forced,
   maintenance running): logits within 1e-3.
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

Output, in order: phase lines, one JSON ``kernels`` line (launches: the
main path's for paged_attention_fused, remap_gather (every launch of the
copy engine, whose two entries share one copy body) and remap_replay,
the cached zero-copy server run's for irt_lookup (every launch of the
walk, whose two entries share one body), irt_walk2 and
paged_attention_split, the concat server run's for paged_attention, the
chunked run's for flash_attention), the card's name and power limit as
nvidia-smi reports them, and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
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
# the one-launch pass replay and the two-home walk, from PERF.md's table
# (NVIDIA H100 80GB HBM3, 700 W); printed beside this run's.  The replay
# and the two-home walk have none: each is printed beside the chain of
# launches it replaces, timed in the same run.
EARLIER_MS = {"paged_attention_fused": 0.0318, "remap_gather": 0.0070,
              "irt_lookup": 0.0059, "paged_attention_split": 0.1361,
              "paged_attention": 0.1352, "flash_attention chunk": 0.0778,
              "flash_attention one-shot": 0.2596}


def _fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def _check(cond: bool, msg: str):
    if not cond:
        raise RuntimeError(msg)


def _time_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Median of per-call device times (CUDA events).  Before each call
    the card is held busy (``torch.cuda._sleep``, about a millisecond)
    while the host enqueues the call, so the events bracket the device's
    work and not the host's dispatch; and a 128 MiB write leaves the
    50 MB L2 cold, as the decode step finds it (each layer's pools follow
    ~0.4 GB of weights)."""
    import torch
    flush = torch.empty(32 << 20, dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
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

    L, F, S = 32, 144, 1024
    g = torch.Generator(device=dev)
    g.manual_seed(21)
    pools = [torch.randn((L, n, 8, 16, 128), generator=g,
                         device=dev).to(torch.bfloat16) for n in (F, F, S, S)]
    recs = _main_pass_records(torch, dev)
    kern = [x.clone() for x in pools]
    err = rg_ops.new_flag(dev)
    rg_ops.remap_replay_op(kern, recs, err)
    rg_ops.check_flag(err)
    remap_replay_ref(pools, recs)
    _check(all(torch.equal(a, b) for a, b in zip(kern, pools)),
           "remap_replay differs from its plain version at the main path's "
           "shapes")
    del kern
    torch.cuda.empty_cache()
    ms = _time_ms(lambda: rg_ops.remap_replay_op(pools, recs, err))
    plain_ms = _time_ms(lambda: remap_replay_ref(pools, recs), reps=5)
    chain_ms = _time_ms(_per_copy_chain(torch, rg_ops, pools, recs, err),
                        reps=5)
    rg_ops.check_flag(err)
    n_en = int(recs[:, 3].sum())
    slab = pools[0][0, 0].numel() * pools[0].element_size()
    nbytes = n_en * 2 * L * slab * 2 + recs.numel() * 4
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"kernel remap_replay bf16 main pass ({recs.shape[0]} records, "
          f"{n_en} enabled, L={L}, {slab // 1024} KiB slabs): exact, one "
          f"launch {ms:.4f} ms, plain per-record version {plain_ms:.4f} ms, "
          f"per-copy chain ({2 * recs.shape[0]} gathers with their "
          f"index_copy_) {chain_ms:.4f} ms ({chain_ms / ms:.1f}x), bound "
          f"{bound_ms:.4f} ms (bytes, {nbytes / 2**20:.0f} MiB)")
    print("kernel " + _vs_bound("remap_replay", ms, bound_ms, nbytes=nbytes))
    del pools
    torch.cuda.empty_cache()

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
    return {"remap_replay": dict(
        name="remap_replay", route="cuda",
        source="src/repro_torch/kernels/remap_gather/csrc/remap_gather.cu",
        replaces="src/repro/kernels/remap_gather/remap_gather.py:24",
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by="bytes", library_ms=None)}


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


def _flash_bound(S, T, H, KV, hd, q_offset, item):
    """Least time for one causal call: 4*hd flops per unmasked (query,
    key) pair and head at the bf16 tensor-core peak, against Q, O and the
    K/V rows any query sees, each moved once, at HBM bandwidth."""
    pos = range(q_offset, q_offset + S)
    pairs = sum(min(p + 1, T) for p in pos)
    keys = min(q_offset + S, T)
    nbytes = item * (2 * S * H * hd + 2 * keys * KV * hd)
    flops = 4 * hd * H * pairs
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes"), flops


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
    orders).  Kernel, plain and ``scaled_dot_product_attention`` times."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.paged_attention.ref import bf16_tolerance

    B, H, KV, hd, T, C = 1, 32, 8, 128, 2048, 256
    g = torch.Generator(device=dev)
    g.manual_seed(31)
    r = lambda *s: torch.randn(s, generator=g, device=dev).to(  # noqa: E731
        torch.bfloat16)
    q, k, v = r(B, T, H, hd), r(B, T, KV, hd), r(B, T, KV, hd)
    op = fa_ops.flash_attention_op
    full = op(q, k, v)
    shapes = {"one-shot": (q, 0), "chunk": (q[:, T - C:].contiguous(), T - C)}
    res = {}
    for label, (qq, off) in shapes.items():
        out = op(qq, k, v, q_offset=off)
        ref = _flash_plain(qq, k, v, q_offset=off).to(torch.bfloat16).float()
        diff = (out.float() - ref).abs()
        err = diff.max().item()
        ratio = (diff / bf16_tolerance(ref)).max().item()
        _check(math.isfinite(err) and ratio <= 1.0,
               f"flash_attention {label} bf16 error {err} over two ulps "
               f"(error/limit {ratio:.3f})")
        # the library call, on [B, H, S, hd] copies made beforehand
        lq, lk, lv = (t.transpose(1, 2).contiguous() for t in (qq, k, v))
        if off == 0:
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                lq, lk, lv, is_causal=True, enable_gqa=True)
        else:
            mask = (torch.arange(T, device=dev)[None, :]
                    <= torch.arange(off, off + qq.shape[1],
                                    device=dev)[:, None])
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                lq, lk, lv, attn_mask=mask, enable_gqa=True)
        lib_err = (lib().transpose(1, 2).float() - ref).abs().max().item()
        ms = _time_ms(lambda: op(qq, k, v, q_offset=off))
        plain_ms = _time_ms(lambda: _flash_plain(qq, k, v, q_offset=off),
                            reps=5)
        lib_ms = _time_ms(lib)
        bound_ms, bound_by, flops = _flash_bound(qq.shape[1], T, H, KV, hd,
                                                 off, 2)
        res[label] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by,
                          library_ms=lib_ms)
        print(f"kernel flash_attention bf16 {label} (S={qq.shape[1]}, "
              f"q_offset={off}, T={T}, H={H}/{KV}, hd={hd}, causal): "
              f"error/limit {ratio:.3f} (max abs {err:.3e}), "
              f"{ms:.4f} ms, plain {plain_ms:.3f} ms, "
              f"scaled_dot_product_attention {lib_ms:.4f} ms (its max abs "
              f"err {lib_err:.3e}), bound {bound_ms:.4f} ms ({bound_by}), "
              f"{ms / bound_ms:.1f}x the bound")
        print("kernel " + _vs_bound(f"flash_attention {label}", ms, bound_ms,
                                    flops=flops))
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


def main_path_engine(torch, dev, cfg, params):
    """The main path's engine and requests: the tiered engine with 1024
    logical pages and 144 fast slots, 16 seeded requests (prompts 100-900
    tokens, max_new 32-96) already submitted."""
    import numpy as np

    from repro_torch.serve.engine import Engine, EngineConfig, Request

    ec = EngineConfig(batch=8, max_len=2048, backend="tiered",
                      page_tokens=16, fast_data_slots=128, maintain_every=4)
    eng = Engine(cfg, params, ec, device=dev)
    t = eng.backend.tcfg
    slow = cfg.n_layers * t.n_logical * t.page_bytes
    print(f"main: {t.n_logical} logical pages, {t.fast_slots} fast slots, "
          f"slow pools {slow / 2**30:.2f} GiB")
    rng = np.random.default_rng(0)
    for i in range(16):
        n = int(rng.integers(100, 901))
        eng.submit(Request(rid=i, prompt=rng.integers(0, cfg.vocab, n),
                           max_new=int(rng.integers(32, 97))))
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

def dense_tiered_phase(torch, dev):
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.policy import get_policy
    from repro_torch.models import decode_step, forward, init_params
    from repro_torch.models.kv_backend import DenseBackend, TieredBackend

    cfg = dataclasses.replace(get_config("llama3-8b"), n_layers=2,
                              dtype="float32")
    params = init_params(cfg, dev, seed=1)
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
    worst = max(diffs)
    c = st.caches
    print(f"dense-vs-tiered: llama3-8b width, 2 layers, fp32, 24 steps, "
          f"{int(c.migrations)} migrations: max |logit diff| {worst:.3e} "
          f"(tol 1e-3; max |logit| {scale:.3f})")
    _check(int(c.migrations) > 0, "no migration during the dense/tiered run")
    _check(math.isfinite(worst) and worst <= 1e-3,
           f"dense vs tiered logits differ by {worst} > 1e-3")
    del params
    torch.cuda.empty_cache()


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
    del params
    for name, n in launches.items():
        rows[name]["launches"] = n
    print(json.dumps({"kernels": [rows[k] for k in sorted(rows)]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
