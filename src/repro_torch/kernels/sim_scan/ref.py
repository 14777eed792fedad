"""Plain PyTorch version of ``sim_scan``: the simulator's per-access step,
written batch-first over a leading trace axis T (the reference's ``vmap``
written out), and the Python loop over accesses that drives it (the
reference's ``lax.scan``, ``repro/core/simulator.py:442``).

Two steps, each the reference's op for op (``repro/core/simulator.py``):

  ``make_step``           remap-table schemes (irt / linear / ideal; cache
                          or flat; every remap-cache kind and policy;
                          dealloc hints), ``:117-351``;
  ``make_step_tagmatch``  Alloy / Loh-Hill / ``tag_ways``, ``:358-419``.

State is a dict of tensors with a leading trace axis, updated in place:
``remap`` [T, n_phys], ``slot_owner`` / ``slot_dirty`` [T, slots],
``leaf_cnt`` [T, leaves], ``fifo_ptr`` [T, sets], ``step`` [T], the
policy's tracker arrays, the remap cache's arrays, and ``counters``
[T, len(COUNTERS)] int32 in ``COUNTERS`` order.  A masked store of a
disabled lane writes back the value already there, in its own trace's
row, and the remap cache's ops drop it: it never reaches another
trace.  Every trace is at the same access,
so an access's epoch tick is known on the host from its index (the step
counter advances on every access, dealloc hints included) and the loop
branches on it without reading the card.  The step does read a few
masks to the host (any dealloc hint, any walk, any install, any forced
eviction), to skip a section whose every lane is masked off: the same
result, far fewer launches.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch._scatter import first_true
from repro_torch.core.policy import access as pol_access
from repro_torch.core.remap import rcache as rc_ops
from repro_torch.core.remap.geometry import (home_block, leaf_fwd, leaf_inv,
                                             make_geometry, static_tables)
from repro_torch.core.remap.rcache import IDENTITY, RemapCacheGeometry
from repro_torch.obs.registry import sim_counter_keys

COUNTERS = sim_counter_keys()
_C = {name: i for i, name in enumerate(COUNTERS)}

_madd, _mset = pol_access.masked_add, pol_access.masked_set


def tagmatch_shape(cfg) -> tuple:
    """(ways, sets, tag bursts per probe) of a tag-matching scheme."""
    ways = cfg.tag_ways or (30 if cfg.meta == "lohhill" else 1)
    n_sets = max(cfg.fast_total_blocks // ways, 1)
    # tag storage read per probe: ways x 4 B entries in 64 B bursts
    bursts = -(-ways * cfg.entry_bytes // cfg.access_bytes)
    return ways, n_sets, bursts


def epoch_mask(cfg) -> int | None:
    """``2^decay_shift - 1`` where the policy keeps tracker state (its
    epochs tick), else None."""
    if cfg.meta in ("alloy", "lohhill"):
        return None
    pol = cfg.pol
    if not pol_access.tracked_keys(pol, cfg.mode):
        return None
    return (1 << pol.decay_shift) - 1


def _bump(st, name, delta):
    c = st["counters"]
    if isinstance(delta, torch.Tensor):
        c[:, _C[name]] += delta.to(torch.int32)
    else:
        c[:, _C[name]] += int(delta)


@functools.lru_cache(maxsize=64)
def _tables(cfg, device: str) -> dict:
    return {k: torch.as_tensor(v, device=device)
            for k, v in static_tables(make_geometry(cfg)).items()}


def make_step(cfg, timing):
    """The remap-table step: ``step(st, b, is_write, dealloc, tick)`` over
    [T] int32 / bool lanes and the host-side tick of this access; updates
    ``st`` in place."""
    g = make_geometry(cfg)
    rcg = RemapCacheGeometry.from_sim_config(cfg)
    track = cfg.meta == "irt" and cfg.irt_levels >= 2
    is_flat = cfg.mode == "flat"
    blk, acc = cfg.block_bytes, cfg.access_bytes
    n_meta_acc = cfg.irt_levels if cfg.meta == "irt" else 1
    pol = cfg.pol
    rc_keys = tuple(rc_ops.init_state(rcg))

    def step(st, b, is_write, dealloc, tick: bool):
        rows = torch.arange(b.shape[0], device=b.device)
        tab = _tables(cfg, str(b.device))

        def rc_view():
            """The per-trace caches flattened to [T * sets, ...], lane t
            addressing row t (``rcache``'s stacked layout)."""
            return {k: st[k].flatten(0, 1) for k in rc_keys}

        def rc_store(out):
            for k, v in out.items():
                st[k].copy_(v.view(st[k].shape))

        def rc_invalidate(ids, enable, becomes_identity=False):
            rc_store(rc_ops.invalidate(rcg, rc_view(), ids, enable,
                                       becomes_identity, row=rows))

        def lf_of(x):
            if not track:
                return torch.zeros_like(x)
            return torch.clamp(leaf_fwd(g, x), 0, g.n_leaf - 1)

        def li_of(v):
            if not track:
                return torch.zeros_like(v)
            return torch.clamp(leaf_inv(g, v), 0, g.n_leaf - 1)

        def at(name, idx):
            return st[name][rows, idx.long()]

        def copy_evict(v, enable):
            """Evict the cache-copy occupant of slot v (if any); restore
            identity."""
            vv = torch.where(enable, v, 0)
            o = at("slot_owner", vv)
            has = enable & (o >= 0)
            dirty = has & at("slot_dirty", vv)
            _mset(st["remap"], o, IDENTITY, has)
            if track:
                _madd(st["leaf_cnt"], lf_of(o), -1, has)
                is_meta = tab["slot_is_meta"][vv.long()]
                _madd(st["leaf_cnt"], li_of(v), -1, has & is_meta)
            _mset(st["slot_owner"], v, -1, enable)
            _mset(st["slot_dirty"], v, False, enable)
            # dirty writeback: fast read + slow write, off the critical path
            d = dirty.to(torch.int32)
            _bump(st, "by_fast", d * blk)
            _bump(st, "by_slow_wr", d * blk)
            _bump(st, "writebacks", d)
            rc_invalidate(o, has, becomes_identity=True)
            return has

        def force_evict_hosted(leaf, enable):
            """Metadata priority (Section 3.3): if ``leaf`` just became
            allocated and its hosting slot caches data, evict that data
            block."""
            lc = torch.clamp(leaf, 0, g.n_leaf - 1)
            h = tab["slot_of_leaf"][lc.long()]
            now_alloc = at("leaf_cnt", lc) > 0
            hv = torch.clamp(h, 0, g.fast_slots - 1)
            need = enable & (h >= 0) & now_alloc & (at("slot_owner", hv) >= 0)
            if not bool(need.any()):
                return
            did = copy_evict(torch.clamp(h, min=0), need)
            _bump(st, "forced_evict", did)

        def pick_victim(bb, s):
            """FIFO victim among the set's slots, skipping allocated
            metadata blocks and slots whose reuse would conflict with the
            entries installing ``bb`` must allocate."""
            order = (at("fifo_ptr", s)[:, None]
                     + torch.arange(g.k, device=bb.device)) % g.k
            cand = (s * g.k)[:, None] + order                      # [T, k]
            is_meta = tab["slot_is_meta"][cand]
            hosted = tab["leaf_hosted"][cand]
            free = st["leaf_cnt"][rows[:, None],
                                  torch.clamp(hosted, 0, g.n_leaf - 1)] == 0
            ok = torch.where(is_meta, (hosted >= 0) & free, True)
            if track:
                ok &= cand != tab["slot_of_leaf"][lf_of(bb).long()][:, None]
                self_host = tab["slot_of_leaf"][li_of(cand).long()] == cand
                ok &= ~(is_meta & self_host)
            pos = first_true(ok)                # first admissible candidate
            return cand[rows, pos.long()].to(torch.int32), pos

        def commit_fifo(s, pos, enable):
            _madd(st["fifo_ptr"], s, pos + 1, enable)
            st["fifo_ptr"].remainder_(g.k)

        def install_copy(bb, v, w, enable):
            """Cache ``bb`` (a copy) into slot ``v`` (cache mode, or a
            flat-mode lendable metadata slot)."""
            copy_evict(v, enable)
            vv = torch.where(enable, v, 0)
            is_meta = tab["slot_is_meta"][vv.long()]
            _mset(st["slot_owner"], v, bb, enable)
            _mset(st["slot_dirty"], v, w, enable)
            _mset(st["remap"], bb, v, enable)
            if track:
                _madd(st["leaf_cnt"], lf_of(bb), 1, enable)
                _madd(st["leaf_cnt"], li_of(v), 1, enable & is_meta)
                force_evict_hosted(lf_of(bb), enable)
                force_evict_hosted(li_of(v), enable & is_meta)
            rc_invalidate(bb, enable)
            e = enable.to(torch.int32)
            _bump(st, "by_slow_rd", e * blk)
            _bump(st, "by_fast", e * blk)
            _bump(st, "installs", e)

        def install_swap(bb, v, enable):
            """Flat mode: migrate slow-home ``bb`` into data slot ``v``
            under the slow-swap policy (Section 3.2)."""
            fb = home_block(g, v)
            vv = torch.where(enable, v, 0)
            o = at("slot_owner", vv)
            migrant = enable & (o >= 0) & (o != fb)
            # 1. a resident migrant goes back to its own slow home
            _mset(st["remap"], o, IDENTITY, migrant)
            if track:
                _madd(st["leaf_cnt"], lf_of(o), -1, migrant)
            rc_invalidate(o, migrant, becomes_identity=True)
            m = migrant.to(torch.int32)
            _bump(st, "by_fast", m * blk)
            _bump(st, "by_slow_wr", m * blk)
            # 2. the displaced home block fb takes over bb's slow home
            hb = bb - g.fast_home_blocks
            fbv = torch.where(enable, fb, 0)
            fb_was_home = at("remap", fbv) == IDENTITY
            _mset(st["remap"], fb, -(hb + 2), enable)
            if track:
                _madd(st["leaf_cnt"], lf_of(fb), 1, enable & fb_was_home)
            rc_invalidate(fb, enable)
            e = enable.to(torch.int32)
            _bump(st, "by_slow_wr", e * blk)
            _bump(st, "by_slow_rd", (enable & ~fb_was_home).to(torch.int32)
                  * blk)
            _bump(st, "by_fast", (enable & fb_was_home).to(torch.int32) * blk)
            # 3. bb moves into v
            _mset(st["remap"], bb, v, enable)
            _mset(st["slot_owner"], v, bb, enable)
            _mset(st["slot_dirty"], v, False, enable)
            if track:
                _madd(st["leaf_cnt"], lf_of(bb), 1, enable)
                force_evict_hosted(lf_of(bb), enable)
                force_evict_hosted(lf_of(fb), enable)
            rc_invalidate(bb, enable)
            _bump(st, "by_slow_rd", e * blk)
            _bump(st, "by_fast", e * blk)
            _bump(st, "swaps", e)

        s = b & (g.n_sets - 1)
        skip = torch.zeros_like(dealloc)
        if cfg.dealloc_hints and bool(dealloc.any()):
            # Section 3.5: the OS tells the controller the block is dead ->
            # recycle its entry, free its slot, skip the writeback
            m0 = at("remap", b)
            freed = dealloc & (m0 >= 0)
            # displaced flat-mode blocks (m0 <= -2) keep their entry: the
            # swap partner still depends on it
            clearable = dealloc & (m0 >= IDENTITY)
            slot0 = torch.clamp(m0, min=0)
            _mset(st["remap"], b, IDENTITY, clearable)
            _mset(st["slot_owner"], slot0, -1, freed)
            _mset(st["slot_dirty"], slot0, False, freed)
            if track:
                _madd(st["leaf_cnt"], lf_of(b), -1, freed)
                is_meta0 = tab["slot_is_meta"][slot0.long()]
                _madd(st["leaf_cnt"], li_of(slot0), -1, freed & is_meta0)
            rc_invalidate(b, clearable, becomes_identity=True)
            pol_access.forget(pol, st, b, dealloc)
            _bump(st, "deallocs", dealloc)
            is_write = is_write & ~dealloc
            skip = dealloc

        _bump(st, "n_acc", ~skip)
        st["step"] += 1

        # 1. metadata lookup: remap cache probe, then table walk on a miss
        m = at("remap", b)                     # ground truth == table content
        if cfg.remap_cache != "ideal":
            hit, val, id_hit = rc_ops.probe(rcg, rc_view(), b, row=rows)
            hit = hit | skip
            walk = ~hit
            _bump(st, "rc_incons", hit & (val != m))
            _bump(st, "rc_hit", hit)
            _bump(st, "rc_id_hit", id_hit)
            _bump(st, "rc_nid_hit", hit & ~id_hit)
            _bump(st, "walks", walk)
            _bump(st, "cyc_sram", timing.t_sram)
            w32 = walk.to(torch.int32)
            _bump(st, "cyc_meta", w32 * timing.t_fast_meta)
            _bump(st, "by_fast", w32 * (acc * n_meta_acc))
            if bool(walk.any()):
                rc_store(rc_ops.fill(rcg, rc_view(), b, m, st["remap"],
                                     walk, row=rows))

        # 2. data access
        if is_flat:
            at_fast_home = (m == IDENTITY) & (b < g.fast_home_blocks)
        else:
            at_fast_home = torch.zeros_like(skip)
        in_fast = ((m >= 0) | at_fast_home) & ~skip
        f32 = in_fast.to(torch.int32)
        slow = ~in_fast & ~skip
        _bump(st, "serve_fast", f32)
        _bump(st, "cyc_fast", f32 * timing.t_fast)
        _bump(st, "cyc_slow", slow.to(torch.int32) * timing.t_slow_rd)
        _bump(st, "by_fast", f32 * acc)
        _bump(st, "by_slow_rd", (slow & ~is_write).to(torch.int32) * acc)
        _bump(st, "by_slow_wr", (slow & is_write).to(torch.int32) * acc)
        _mset(st["slot_dirty"], torch.clamp(m, min=0), True,
              is_write & (m >= 0))

        # 3. fill / migrate on a fast-tier miss, gated by the policy
        if cfg.mode == "cache":
            go = pol_access.gate(pol, "cache", st, b, is_write, slow, tick)
        else:
            movable = slow & (b >= g.fast_home_blocks)  # displaced fast-home
            go = pol_access.gate(pol, "flat", st, b,    # blocks stay put
                                 is_write, movable, tick)
        if not bool(go.any()):
            return                   # every lane's install is masked off
        v, pos = pick_victim(b, s)
        commit_fifo(s, pos, go)
        if cfg.mode == "cache":
            install_copy(b, v, is_write, go)
        else:
            v_is_meta = tab["slot_is_meta"][v.long()]
            install_copy(b, v, is_write, go & v_is_meta)
            install_swap(b, v, go & ~v_is_meta)

    return step, g


def tagmatch_init(cfg, n_traces: int = 1, device=None) -> dict:
    """Fresh state of a tag-matching scheme for ``n_traces`` traces."""
    ways, sets, _ = tagmatch_shape(cfg)
    i32 = dict(dtype=torch.int32, device=device)
    return {"slot_owner": torch.full((n_traces, sets * ways), -1, **i32),
            "slot_dirty": torch.zeros((n_traces, sets * ways),
                                      dtype=torch.bool, device=device),
            "fifo_ptr": torch.zeros((n_traces, 1), **i32),
            "counters": torch.zeros((n_traces, len(COUNTERS)), **i32)}


def init_state(cfg, g, n_traces: int = 1, device=None) -> dict:
    """Fresh state of ``n_traces`` traces (leading axis), as the
    reference's ``init_state`` (or the tag-matching ``init``) per trace;
    the counters are one [T, len(COUNTERS)] int32 tensor.  ``g`` is the
    scheme's ``Geometry`` (None for tag matching).  This is the one
    statement of the state's layout: the kernel's wrapper checks a
    caller's state against it (on the meta device)."""
    if cfg.meta in ("alloy", "lohhill"):
        return tagmatch_init(cfg, n_traces, device)
    T, i32 = n_traces, dict(dtype=torch.int32, device=device)
    st = {
        "remap": torch.full((T, cfg.n_phys), IDENTITY, **i32),
        "slot_owner": torch.full((T, g.fast_slots), -1, **i32),
        "slot_dirty": torch.zeros((T, g.fast_slots), dtype=torch.bool,
                                  device=device),
        "leaf_cnt": torch.zeros((T, max(g.n_leaf, 1)), **i32),
        "fifo_ptr": torch.zeros((T, g.n_sets), **i32),
        "step": torch.zeros((T,), **i32),
    }
    if cfg.mode == "flat":
        # data slots start occupied by their home blocks (identity); the
        # policy's hotness tracker drives migration
        tab = static_tables(g)
        owner = np.where(
            ~tab["slot_is_meta"],
            ((tab["slot_u"] << g.log_sets) | tab["slot_set"]).astype(np.int32),
            -1)
        st["slot_owner"] = torch.as_tensor(owner, **i32).repeat(T, 1)
    st.update(pol_access.init(cfg.pol, cfg.mode, cfg.n_phys, T, device))
    st.update(rc_ops.init_state(RemapCacheGeometry.from_sim_config(cfg),
                                device, n_traces=T))
    st["counters"] = torch.zeros((T, len(COUNTERS)), **i32)
    return st


def make_step_tagmatch(cfg, timing):
    """Alloy Cache (direct-mapped, perfect MAP) / Loh-Hill (30-way,
    perfect MissMap): tags live with the data; FIFO replacement with one
    pointer for the whole cache, as in the reference.  Returns (step,
    init), ``init(n_traces, device)`` the fresh state."""
    blk, acc = cfg.block_bytes, cfg.access_bytes
    ways, _, n_tag_bursts = tagmatch_shape(cfg)
    tag_read = cfg.meta == "lohhill" or cfg.tag_ways

    def step(st, b, is_write, dealloc, tick: bool):
        del dealloc, tick
        rows = torch.arange(b.shape[0], device=b.device)
        _bump(st, "n_acc", 1)
        slot0 = (b % (st["slot_owner"].shape[1] // ways)) * ways
        cols = slot0[:, None] + torch.arange(ways, device=b.device)
        match = st["slot_owner"][rows[:, None], cols] == b[:, None]
        hit = match.any(-1)
        way = first_true(match)
        slot = slot0 + torch.where(hit, way, st["fifo_ptr"][:, 0] % ways)
        h32 = hit.to(torch.int32)
        if tag_read:
            # tag read from the same DRAM row before the data access; > 16
            # tags need multiple 64 B bursts (Section 2.2)
            _bump(st, "cyc_meta", h32 * (timing.t_fast_meta * n_tag_bursts))
            _bump(st, "by_fast", h32 * (n_tag_bursts * acc))
        miss = ~hit
        m32 = miss.to(torch.int32)
        _bump(st, "serve_fast", h32)
        _bump(st, "cyc_fast", h32 * timing.t_fast)
        _bump(st, "cyc_slow", m32 * timing.t_slow_rd)
        _bump(st, "by_fast", h32 * acc)
        _bump(st, "by_slow_rd", m32 * acc)
        _mset(st["slot_dirty"], slot, True, hit & is_write)
        o = st["slot_owner"][rows, slot.long()]
        dirty_evict = miss & (o >= 0) & st["slot_dirty"][rows, slot.long()]
        d32 = dirty_evict.to(torch.int32)
        _bump(st, "by_fast", d32 * blk)
        _bump(st, "by_slow_wr", d32 * blk)
        _bump(st, "writebacks", d32)
        _mset(st["slot_owner"], slot, b, miss)
        _mset(st["slot_dirty"], slot, is_write, miss)
        _bump(st, "by_slow_rd", m32 * blk)
        _bump(st, "by_fast", m32 * blk)
        _bump(st, "installs", m32)
        st["fifo_ptr"][:, 0] += m32

    return step, functools.partial(tagmatch_init, cfg)


@functools.lru_cache(maxsize=64)
def plain_step(cfg, timing):
    """The plain step for ``cfg``'s scheme."""
    if cfg.meta in ("alloy", "lohhill"):
        return make_step_tagmatch(cfg, timing)[0]
    return make_step(cfg, timing)[0]


def sim_scan_ref(cfg, timing, state: dict, blocks, writes, deallocs,
                 start: int = 0, end: int | None = None) -> dict:
    """Run accesses ``[start, end)`` of T traces (``blocks`` [T, L] int32,
    ``writes`` / ``deallocs`` [T, L] bool) through the plain step, one
    access of every trace at a time; updates ``state`` in place and
    returns it."""
    end = blocks.shape[1] if end is None else end
    step = plain_step(cfg, timing)
    mask = epoch_mask(cfg)
    step0 = 0
    if mask is not None:
        first = state["step"][:1].item()           # one host read a scan
        if not bool((state["step"] == first).all()):
            raise ValueError("sim_scan: traces at different steps")
        step0 = first - start
    for i in range(start, end):
        tick = mask is not None and ((step0 + i + 1) & mask) == 0
        step(state, blocks[:, i], writes[:, i], deallocs[:, i], tick)
    return state
