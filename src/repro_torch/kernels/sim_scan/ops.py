"""Public wrapper for the simulator's scan: ``sim_scan_op`` runs accesses
``[start, end)`` of T same-length traces through one scheme's step,
updating the batched simulator state in place.

Tensors on the CPU go to the plain version (``ref.sim_scan_ref``: a
Python loop of the batch-first step); tensors on a card launch the
hand-written kernel (``csrc/sim_scan.cu``: one thread block per trace,
the whole range of accesses inside one launch; warp 0 runs the accesses
with the next 32 accesses' trace words, remap entries, tracker words and
sector vectors in registers, patched by every store, so no access waits
on device memory) or raise on what it does not take.  ``launches``
counts the kernel's launches (reset by assignment).

``sim_scan_chase_op`` measures the yardstick of the kernel's dependent
chain, the latency of one dependent load in shared memory and through
L2; ``chip_smoke.py`` and a card test call it, the simulator never does.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.policy.access import tracked_keys
from repro_torch.core.remap.geometry import make_geometry
from repro_torch.kernels import _build

from .ref import COUNTERS, init_state, sim_scan_ref, tagmatch_shape

launches = 0

# the kernel's counter order (csrc/sim_scan.cu, enum Counter)
KERNEL_COUNTERS = (
    "n_acc", "rc_hit", "rc_id_hit", "rc_nid_hit", "rc_incons", "serve_fast",
    "installs", "swaps", "forced_evict", "writebacks", "walks", "deallocs",
    "cyc_sram", "cyc_meta", "cyc_fast", "cyc_slow", "by_fast", "by_slow_rd",
    "by_slow_wr")

# the int64 argument vector (csrc/sim_scan.cu, enum Arg)
_ARGS = (
    "T", "L", "start", "end",
    "n_phys", "slots", "k", "k_data", "k_meta", "n_sets", "log_sets", "lf",
    "li", "n_leaf", "leaf_alloc", "fast_home", "track", "flat", "dealloc",
    "rc_kind", "vc_sets", "vc_ways", "id_sets", "id_ways",
    "t_sram", "t_fast", "t_fast_meta", "t_slow_rd", "blk", "acc",
    "n_meta_acc",
    "tracks", "tracker", "topk_decider", "thr", "topk", "decay_shift",
    "history", "write_weight",
    "tm_ways", "tm_sets", "tm_bursts", "tm_tag_read",
    "blocks", "writes", "deallocs", "remap", "slot_owner", "slot_dirty",
    "leaf_cnt", "fifo_ptr", "step", "touch", "pol_ema", "pol_last",
    "pol_cut", "pol_budget", "vc_tag", "vc_val", "vc_fifo", "id_tag",
    "id_bits", "id_fifo", "counters")
_RC_KINDS = {"irc": 0, "conventional": 1, "none": 2, "ideal": 3}
_TRACKERS = {"touch": 0, "mea": 1, "recency": 2}


def _bind(lib):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for name in ("sim_scan_remap", "sim_scan_tagmatch"):
        fn = getattr(lib, name)
        fn.argtypes = [vp, vp]
        fn.restype = ci
    lib.sim_scan_chase.argtypes = [vp, ci, ci, ci, ci, vp, vp]
    lib.sim_scan_chase.restype = ci
    lib.sim_scan_n_args.argtypes = []
    lib.sim_scan_n_args.restype = ci
    if lib.sim_scan_n_args() != len(_ARGS):
        raise RuntimeError("sim_scan: the library's argument vector does "
                           "not match the wrapper's")
    return lib.sim_scan_remap, lib.sim_scan_tagmatch, lib.sim_scan_chase


def is_tagmatch(cfg) -> bool:
    return cfg.meta in ("alloy", "lohhill")


def _check(name, t, device, dtype, shape):
    if not isinstance(t, torch.Tensor) or t.device != device \
            or t.dtype != dtype:
        raise ValueError(f"sim_scan: {name} must be {dtype} on {device}")
    if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"sim_scan: {name} must be a contiguous "
                         f"{tuple(shape)} tensor, got {tuple(t.shape)}")


def _scalars(cfg, timing, T, L, start, end) -> dict:
    a = dict(T=T, L=L, start=start, end=end)
    if is_tagmatch(cfg):
        ways, sets, bursts = tagmatch_shape(cfg)
        a.update(tm_ways=ways, tm_sets=sets, tm_bursts=bursts,
                 tm_tag_read=int(bool(cfg.meta == "lohhill"
                                      or cfg.tag_ways)))
    else:
        g = make_geometry(cfg)
        pol = cfg.pol
        tracks = bool(tracked_keys(pol, cfg.mode))
        if tracks and not 0 <= pol.decay_shift < 31:
            raise ValueError(f"sim_scan: decay_shift {pol.decay_shift} "
                             f"outside [0, 31)")
        a.update(n_phys=cfg.n_phys, slots=g.fast_slots, k=g.k,
                 k_data=g.k_data, k_meta=g.k_meta, n_sets=g.n_sets,
                 log_sets=g.log_sets, lf=g.lf, li=g.li, n_leaf=g.n_leaf,
                 leaf_alloc=max(g.n_leaf, 1), fast_home=g.fast_home_blocks,
                 track=int(cfg.meta == "irt" and cfg.irt_levels >= 2),
                 flat=int(cfg.mode == "flat"),
                 dealloc=int(cfg.dealloc_hints),
                 rc_kind=_RC_KINDS[cfg.remap_cache],
                 n_meta_acc=cfg.irt_levels if cfg.meta == "irt" else 1,
                 tracks=int(tracks), tracker=_TRACKERS[pol.tracker],
                 topk_decider=int(pol.decider == "topk"),
                 thr=pol.threshold_for(cfg.mode), topk=pol.topk,
                 decay_shift=pol.decay_shift, history=pol.history_len,
                 write_weight=pol.write_weight)
        if cfg.remap_cache == "conventional":
            a.update(vc_sets=cfg.rc_sets, vc_ways=cfg.rc_ways)
        elif cfg.remap_cache == "irc":
            a.update(vc_sets=cfg.nid_sets, vc_ways=cfg.nid_ways,
                     id_sets=cfg.id_sets, id_ways=cfg.id_ways)
    a.update(t_sram=timing.t_sram, t_fast=timing.t_fast,
             t_fast_meta=timing.t_fast_meta, t_slow_rd=timing.t_slow_rd,
             blk=cfg.block_bytes, acc=cfg.access_bytes)
    return a


# state keys under the kernel's names for the value cache (the
# conventional cache, or the iRC's NonIdCache)
_VC = {"conventional": ("rc_tag", "rc_val", "rc_fifo"),
       "irc": ("nid_tag", "nid_val", "nid_fifo")}


def sim_scan_op(cfg, timing, state: dict, blocks, writes, deallocs,
                start: int = 0, end: int | None = None) -> dict:
    """Run accesses ``[start, end)`` of T traces through ``cfg``'s step:
    ``blocks`` [T, L] int32, ``writes`` / ``deallocs`` [T, L] bool, and
    ``state`` the batched state (``ref.init_state``), updated in place and
    returned.  On a card the whole range is one launch; ranges that
    split a trace continue one another exactly."""
    global launches
    if blocks.device.type == "cpu":
        return sim_scan_ref(cfg, timing, state, blocks, writes, deallocs,
                            start, end)
    if blocks.device.type != "cuda":
        raise ValueError(f"sim_scan: unsupported device {blocks.device}")
    if tuple(COUNTERS) != KERNEL_COUNTERS:
        raise RuntimeError("sim_scan: the counter order changed")
    dev = blocks.device
    if blocks.dim() != 2:
        raise ValueError("sim_scan: blocks must be [n_traces, trace_len]")
    T, L = blocks.shape
    end = L if end is None else int(end)
    start = int(start)
    if not 0 <= start <= end <= L:
        raise ValueError(f"sim_scan: range [{start}, {end}) outside "
                         f"[0, {L}]")
    _check("blocks", blocks, dev, torch.int32, (T, L))
    _check("writes", writes, dev, torch.bool, (T, L))
    _check("deallocs", deallocs, dev, torch.bool, (T, L))
    want = init_state(cfg, None if is_tagmatch(cfg) else make_geometry(cfg),
                      T, "meta")
    if set(state) != set(want):
        raise ValueError(f"sim_scan: state keys {sorted(state)} are not "
                         f"{sorted(want)}")
    for key, w in want.items():
        _check(key, state[key], dev, w.dtype, w.shape)
    if T == 0 or start == end:
        return state
    args = dict.fromkeys(_ARGS, 0)
    args.update(_scalars(cfg, timing, T, L, start, end))
    ptrs = {"blocks": blocks, "writes": writes, "deallocs": deallocs,
            **state}
    for kernel_key, key in zip(("vc_tag", "vc_val", "vc_fifo"),
                               _VC.get(cfg.remap_cache, ())):
        ptrs[kernel_key] = state[key]
    for key, t in ptrs.items():
        if key in args:
            args[key] = t.data_ptr()
    vec = (ctypes.c_int64 * len(_ARGS))(*[int(args[k]) for k in _ARGS])
    remap_entry, tagmatch_entry, _ = _build.load("sim_scan", _bind)
    entry = tagmatch_entry if is_tagmatch(cfg) else remap_entry
    rc = entry(ctypes.cast(vec, ctypes.c_void_p), _build.stream_ptr(dev))
    if rc != 0:
        raise RuntimeError(f"sim_scan launch failed: cudaError {rc}")
    launches += 1
    return state


# the chase's cycles: shared memory (16 KB), and one remap row (256 KB)
CHASE_WORDS = {"smem": 4096, "l2": 65536}
_CHASE_KINDS = {"smem": 0, "l2": 1}
CHASE_STEPS = 1 << 16


def sim_scan_chase_op(kind: str, device) -> dict:
    """The latency of one dependent load on the card: one thread follows
    a random cycle (seed 0) of ``CHASE_WORDS[kind]`` int32 words, in
    shared memory (``"smem"``) or in device memory through L2 (``"l2"``,
    loads that bypass L1), once round untimed and then ``CHASE_STEPS``
    hops.  Returns ``{"ns": ..., "cycles": ...}`` per hop.  The yardstick
    of the scan's dependent chain: called by ``chip_smoke.py`` and a card
    test, never by ``run`` / ``run_many``; it synchronises to read its
    result."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"sim_scan_chase: needs a card, got {dev}")
    n = CHASE_WORDS[kind]
    order = torch.randperm(n, generator=torch.Generator().manual_seed(0))
    nxt = torch.empty(n, dtype=torch.int32)
    nxt[order] = order.roll(-1).to(torch.int32)    # one cycle through all n
    nxt = nxt.to(dev)
    out = torch.zeros(3, dtype=torch.int64, device=dev)
    *_, chase = _build.load("sim_scan", _bind)
    rc = chase(ctypes.c_void_p(nxt.data_ptr()), n, _CHASE_KINDS[kind], n,
               CHASE_STEPS, ctypes.c_void_p(out.data_ptr()),
               _build.stream_ptr(dev))
    if rc != 0:
        raise RuntimeError(f"sim_scan_chase launch failed: cudaError {rc}")
    cycles, ns, _ = out.tolist()
    return {"ns": ns / CHASE_STEPS, "cycles": cycles / CHASE_STEPS}
