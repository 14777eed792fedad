"""Two-tier paged KV store under Trimma metadata: the on-path part of
``repro.tiered.kvcache``.

Two pools of KV pages: the slow pool holds every logical page's home,
the small fast pool holds hot pages plus the iRT metadata region (whose
slots back data pages while their leaf is unallocated, Section 3.3).
Metadata ops drive ``core/remap`` (iRT + iRC) and ``core/policy``
(trackers + scheduler) exactly as the reference does.

Differences from the reference, all invisible to its results:

* **Pools update in place.**  The reference returns a new state; at full
  width the slow pools are about 2 GiB, and functional copies would
  double both time and memory.  Metadata stays functional (small new
  tensors per op).  A caller that needs the old pool bytes clones them.
* **One copy of the metadata for all layers.**  The reference stacks a
  ``TieredState`` per layer, but every metadata field is identical across
  layers by construction, so a *stacked* state here is a ``TieredState``
  whose four pools carry a leading ``[L]`` axis and whose metadata does
  not; the reference's ``_layer0`` / ``_restack`` vanish, and parity is
  checked against the reference's layer-0 slice.
* ``lax.scan`` over moves is a Python loop in the same order: move order
  matters (a promotion may install into a slot an earlier move freed).
* Pools are zero-initialised: the fused attention relies on pools never
  holding non-finite bytes (a NaN behind a masked column would reach the
  output through ``0 * NaN``).

A maintenance pass's or an admission's page copies are recorded by the
metadata moves and replayed over the [L, ...] pools in one launch of the
copy engine (``kernels/remap_gather``, ``remap_replay_op``); the
unstacked ``migrate_one`` / ``demote_one`` gather one page at a time
(``remap_gather_op``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch._scatter import (at, drop_add, drop_set, drop_set_,
                                  first_true, on_device, set_at)
from repro_torch.core.policy import scheduler as pol_sched
from repro_torch.core.policy import trackers as pol_track
from repro_torch.core.policy.config import PolicyConfig
from repro_torch.core.remap import irt as irt_ops
from repro_torch.core.remap import rcache as rc_ops
from repro_torch.core.remap.irt import E, INVALID
from repro_torch.core.remap.rcache import RemapCacheGeometry
from repro_torch.device import resolve_device, torch_dtype
from repro_torch.kernels.irt_lookup.ops import irt_walk2_op
from repro_torch.kernels.remap_gather import ops as rg_ops
from repro_torch.kernels.remap_gather.ref import FAST_TO_SLOW, SLOW_TO_FAST
from repro_torch.obs.registry import MetricSpec, register

I32 = torch.int32

# canonical metric names for the counters this store accumulates beyond
# the iRC/iRT/migration families its building blocks declare
# (DESIGN.md §10; obs.metrics.tiered_metrics is the tap)
register(
    MetricSpec("trimma_dev_table_hits_total", "counter",
               "live lookup lanes served from the cached device page "
               "table (zero iRC probes, zero iRT walks)"),
    MetricSpec("trimma_fast_resident_pages", "gauge",
               "pages currently resident in the fast pool"),
    MetricSpec("trimma_metadata_pages", "gauge",
               "allocated iRT leaf blocks (saved-space metadata "
               "footprint, Figure 9 analogue)"),
    MetricSpec("trimma_identity_entry_ratio", "gauge",
               "fraction of logical pages holding NO remap entry "
               "(identity-mapped — the saved-metadata story, live)"),
    MetricSpec("trimma_irt_leaf_occupancy", "gauge",
               "allocated iRT leaf blocks / provisioned leaf slots "
               "(leaf-level table occupancy)"),
    MetricSpec("trimma_metadata_bytes", "gauge",
               "bytes of allocated iRT leaf metadata (E entries x 4 "
               "bytes per allocated leaf)", unit="bytes"),
)


@dataclasses.dataclass(frozen=True)
class TieredConfig:
    n_seqs: int
    max_pages_per_seq: int          # logical pages per sequence
    page_tokens: int
    n_kv_heads: int
    head_dim: int
    fast_data_slots: int            # fast-tier data-area pages
    policy: Optional[PolicyConfig] = None
    migrate_threshold: int = 2      # DEPRECATED -> policy.promote_threshold
    nid_sets: int = 32
    nid_ways: int = 6
    id_sets: int = 8
    id_ways: int = 16
    dtype: str = "bfloat16"
    # keep the translated device table in state and re-translate only
    # rows whose mapping changed (False: the legacy re-walk of every row
    # per lookup, the baseline of the concat path)
    cache_device_table: bool = True

    @property
    def n_logical(self) -> int:
        return self.n_seqs * self.max_pages_per_seq

    @property
    def n_leaf(self) -> int:
        return -(-self.n_logical // E)

    @property
    def meta_slots(self) -> int:
        """Reserved metadata region (one slot hosts one leaf block)."""
        return self.n_leaf

    @property
    def fast_slots(self) -> int:
        return self.fast_data_slots + self.meta_slots

    @property
    def rc_geometry(self) -> RemapCacheGeometry:
        return RemapCacheGeometry.from_tiered_config(self)

    @property
    def pol(self) -> PolicyConfig:
        """``policy=`` if given, else the legacy ``migrate_threshold`` knob
        resolved into the default policy."""
        if self.policy is not None:
            return self.policy
        return PolicyConfig(promote_threshold=self.migrate_threshold)

    @property
    def page_bytes(self) -> int:
        """Bytes one K+V page moves across tiers (bandwidth accounting)."""
        item = torch.empty((), dtype=torch_dtype(self.dtype)).element_size()
        return (2 * self.n_kv_heads * self.page_tokens * self.head_dim
                * item)


class TieredState(NamedTuple):
    fast_k: torch.Tensor         # [(L,) fast_slots, KV, page, hd]
    fast_v: torch.Tensor
    slow_k: torch.Tensor         # [(L,) n_logical, KV, page, hd] (homes)
    slow_v: torch.Tensor
    l1_bits: torch.Tensor        # [n_words] int32
    leaf_table: torch.Tensor     # [n_leaf*E] int32 (page -> fast slot)
    leaf_cnt: torch.Tensor       # [n_leaf] int32
    slot_owner: torch.Tensor     # [fast_slots] int32 (inverse mapping)
    touch: torch.Tensor          # [n_logical] int32 hotness
    ema: torch.Tensor            # [n_logical] int32 (mea tracker carry)
    last_seen: torch.Tensor      # [n_logical] int32 (recency tracker)
    wtouch: torch.Tensor         # [n_logical] int32 write intensity
    epoch: torch.Tensor          # scalar: maintain() calls so far
    fifo_ptr: torch.Tensor       # scalar
    dev_table: torch.Tensor      # [n_logical] int32 cached device slots
    dev_valid: torch.Tensor      # [n_logical] bool
    nid_tag: torch.Tensor        # iRC (layout owned by core/remap/rcache)
    nid_val: torch.Tensor
    nid_fifo: torch.Tensor
    id_tag: torch.Tensor
    id_bits: torch.Tensor        # int64 holding uint32 sector vectors
    id_fifo: torch.Tensor
    lookups: torch.Tensor        # counters (int32 scalars)
    irc_hits: torch.Tensor
    irc_id_hits: torch.Tensor
    migrations: torch.Tensor
    demotions: torch.Tensor
    forced_evict: torch.Tensor
    promo_pages: torch.Tensor
    demo_pages: torch.Tensor
    dev_hits: torch.Tensor


_RC_KEYS = ("nid_tag", "nid_val", "nid_fifo", "id_tag", "id_bits", "id_fifo")
_TR_FIELDS = {"touch": "touch", "pol_ema": "ema", "pol_last": "last_seen"}
POOL_FIELDS = ("fast_k", "fast_v", "slow_k", "slow_v")


def _rc_view(st: TieredState) -> dict:
    return {k: getattr(st, k) for k in _RC_KEYS}


def _tr_view(cfg: TieredConfig, st: TieredState) -> dict:
    tr = {"touch": st.touch}
    if cfg.pol.tracker == "mea":
        tr["pol_ema"] = st.ema
    elif cfg.pol.tracker == "recency":
        tr["pol_last"] = st.last_seen
    return tr


def _tr_replace(st: TieredState, tr: dict) -> TieredState:
    return st._replace(**{_TR_FIELDS[k]: v for k, v in tr.items()})


def _now(cfg: TieredConfig, st: TieredState):
    """Current epoch index (``epoch_len`` maintain calls per epoch)."""
    return st.epoch // cfg.pol.epoch_len


def _irt_view(st: TieredState) -> dict:
    return {"entries": st.leaf_table, "l1_bits": st.l1_bits,
            "leaf_cnt": st.leaf_cnt}


def _irt_replace(st: TieredState, tab: dict) -> TieredState:
    return st._replace(leaf_table=tab["entries"], l1_bits=tab["l1_bits"],
                       leaf_cnt=tab["leaf_cnt"])


def init_state(cfg: TieredConfig, device=None,
               n_layers: int | None = None) -> TieredState:
    """Fresh store on ``device`` (the card unless the caller asks for the
    CPU); ``n_layers`` stacks the pools (one shared metadata)."""
    device = resolve_device(device)
    dt = torch_dtype(cfg.dtype)
    lead = () if n_layers is None else (n_layers,)
    KV, P, hd = cfg.n_kv_heads, cfg.page_tokens, cfg.head_dim
    n = cfg.n_logical

    def pool(rows):
        return torch.zeros(lead + (rows, KV, P, hd), dtype=dt, device=device)

    def z(shape=()):
        return torch.zeros(shape, dtype=I32, device=device)

    tab = irt_ops.init_tables(n, device)
    return TieredState(
        fast_k=pool(cfg.fast_slots), fast_v=pool(cfg.fast_slots),
        slow_k=pool(n), slow_v=pool(n),
        l1_bits=tab["l1_bits"], leaf_table=tab["entries"],
        leaf_cnt=tab["leaf_cnt"],
        slot_owner=torch.full((cfg.fast_slots,), INVALID, dtype=I32,
                              device=device),
        touch=z((n,)), ema=z((n,)),
        last_seen=torch.full((n,), -(1 << 20), dtype=I32, device=device),
        wtouch=z((n,)), epoch=z(), fifo_ptr=z(),
        dev_table=cfg.fast_slots + torch.arange(n, dtype=I32, device=device),
        dev_valid=torch.zeros((n,), dtype=torch.bool, device=device),
        lookups=z(), irc_hits=z(), irc_id_hits=z(), migrations=z(),
        demotions=z(), forced_evict=z(), promo_pages=z(), demo_pages=z(),
        dev_hits=z(),
        **rc_ops.init_state(cfg.rc_geometry, device),
    )


def logical_page(cfg: TieredConfig, seq, j):
    return seq * cfg.max_pages_per_seq + j


# ---------------------------------------------------------------------------
# lookup: logical page table -> device page table (the zero-copy and
# concat read paths)
# ---------------------------------------------------------------------------

def _translate(cfg: TieredConfig, st: TieredState, ids, enable):
    """The metadata path for page ids [N]: iRC probe, then the parallel
    two-level iRT walk to both homes with the probe folded in
    (``irt_walk2_op``: one kernel launch on a card; the reference
    walks to INVALID and selects with ``where``s, the same values).  iRC
    fills and counters are masked by ``enable``.  Returns (device slots
    [N], meaningful on enabled lanes; state)."""
    rcg = cfg.rc_geometry
    hit, val, id_hit = rc_ops.probe(rcg, _rc_view(st), ids)
    walked, dev = irt_walk2_op(ids, cfg.fast_slots, st.l1_bits,
                               st.leaf_table, probe=(hit, val, id_hit))
    st = st._replace(**rc_ops.fill(rcg, _rc_view(st), ids, walked,
                                   st.leaf_table, enable & ~hit))
    st = st._replace(
        lookups=st.lookups + enable.sum(dtype=I32),
        irc_hits=st.irc_hits + (enable & hit).sum(dtype=I32),
        irc_id_hits=st.irc_id_hits + (enable & id_hit).sum(dtype=I32))
    return dev, st


def lookup(cfg: TieredConfig, st: TieredState, page_ids, live=None):
    """page_ids [B, npages] logical -> (device table [B, npages] int32,
    state).  Slots index the unified space: < fast_slots the fast pool,
    else fast_slots + home.  ``live`` [B, npages] bool masks the pages
    that hold context: dead ones are neither translated nor counted and
    resolve to their identity home.

    With ``cfg.cache_device_table`` valid ``dev_table`` rows are served
    directly and only live rows not yet cached are translated.  The
    reference skips that miss branch with ``lax.cond(need.any(), ...)``;
    here it always runs, because reading ``need.any()`` would make the
    host wait for the card every step.  Every write in it is masked by
    ``need`` (iRC fills and FIFO advances, the drop-mode ``dev_table``
    scatters, masked counter sums), so with ``need`` all false the state
    is exactly the reference's.  Hotness is recorded for every live page
    either way."""
    B, NP = page_ids.shape
    ids = page_ids.reshape(-1)
    lv = (torch.ones(ids.shape, dtype=torch.bool, device=ids.device)
          if live is None else live.reshape(-1))
    home = cfg.fast_slots + ids
    if not cfg.cache_device_table:
        dev, st = _translate(cfg, st, ids, lv)
        dev = torch.where(lv, dev, home)
    else:
        need = lv & ~st.dev_valid[ids.long()]
        dev, st = _translate(cfg, st, ids, need)
        idx = torch.where(need, ids, cfg.n_logical)
        st = st._replace(
            dev_table=drop_set(st.dev_table, idx, dev),
            dev_valid=drop_set(st.dev_valid, idx, True),
            dev_hits=st.dev_hits + (lv & ~need).sum(dtype=I32))
        dev = torch.where(lv, st.dev_table[ids.long()], home)
    st = record_touches(cfg, st, ids, lv)
    return dev.to(I32).reshape(B, NP), st


def unified_pools(st: TieredState):
    """LEGACY: the concatenated (fast | slow) pools, a full copy of the KV
    store; only the concat baseline path reads it."""
    return (torch.cat([st.fast_k, st.slow_k], dim=0),
            torch.cat([st.fast_v, st.slow_v], dim=0))


# ---------------------------------------------------------------------------
# read-side accounting (the fused decode path's leaf entries are the
# translation: no walk runs)
# ---------------------------------------------------------------------------

def record_touches(cfg: TieredConfig, st: TieredState, ids,
                   enable) -> TieredState:
    """One hotness-tracker touch per enabled page id."""
    return _tr_replace(st, pol_track.record(cfg.pol, _tr_view(cfg, st),
                                            ids, now=_now(cfg, st),
                                            enable=enable))


def record_reads(cfg: TieredConfig, st: TieredState, ids,
                 lv) -> TieredState:
    """A live page whose ``dev_table`` row is not cached counts one
    translation (the leaf entry is the translation) and caches its row; a
    cached one counts one ``dev_table`` hit.  Without
    ``cfg.cache_device_table`` every live page counts a translation.
    ``ids``/``lv`` are flat."""
    if not cfg.cache_device_table:
        return st._replace(lookups=st.lookups + lv.sum(dtype=I32))
    valid = st.dev_valid[ids.long()]
    cold = lv & ~valid
    entry = st.leaf_table[ids.long()]
    dev = torch.where(entry != INVALID, entry, cfg.fast_slots + ids)
    idx = torch.where(cold, ids, cfg.n_logical)
    return st._replace(
        dev_table=drop_set(st.dev_table, idx, dev),
        dev_valid=drop_set(st.dev_valid, idx, True),
        lookups=st.lookups + cold.sum(dtype=I32),
        dev_hits=st.dev_hits + (lv & valid).sum(dtype=I32))


def _page_gather(pool, pid):
    """One page [KV, page, hd] through the migration gather."""
    n, KV, P, hd = pool.shape
    err = rg_ops.new_flag(pool.device)
    out = rg_ops.remap_gather_op(pool.view(n, KV * P, hd),
                                 pid.reshape(1).to(I32), err)
    rg_ops.check_flag(err)
    return out.view(KV, P, hd)


def _dev_update(cfg: TieredConfig, st: TieredState, pid, slot,
                enable) -> TieredState:
    """Write a page's new translation through the cached device table
    (the row stays valid); masked by ``enable``."""
    idx = torch.where(enable, pid, cfg.n_logical)
    return st._replace(dev_table=drop_set(st.dev_table, idx, slot),
                       dev_valid=drop_set(st.dev_valid, idx, True))


# ---------------------------------------------------------------------------
# append
# ---------------------------------------------------------------------------

def append_routing(cfg: TieredConfig, st: TieredState, seq_ids, pos, k_tok):
    """Routing for ``k_tok`` consecutive new tokens per lane starting at
    ``pos`` [B]: (ok, ids, fast_idx, slow_idx, off), all [B, k_tok].
    Masked-out entries carry the out-of-range sentinel of their pool;
    idle lanes (``pos < 0``) are fully masked."""
    pos = torch.as_tensor(pos, dtype=I32, device=seq_ids.device) \
        .expand(seq_ids.shape)
    pgrid = pos[:, None] + torch.arange(k_tok, dtype=I32,
                                        device=seq_ids.device)
    page = torch.div(pgrid, cfg.page_tokens, rounding_mode="floor")
    off = pgrid % cfg.page_tokens
    ok = (pos[:, None] >= 0) & (page >= 0) & (page < cfg.max_pages_per_seq)
    ids = logical_page(cfg, seq_ids[:, None],
                       page.clamp(0, cfg.max_pages_per_seq - 1))
    entry = st.leaf_table[ids.long()]
    in_fast = entry != INVALID
    fast_idx = torch.where(ok & in_fast, entry, cfg.fast_slots)
    slow_idx = torch.where(ok & ~in_fast, ids, cfg.n_logical)
    return ok, ids, fast_idx, slow_idx, off


def append_tokens(cfg: TieredConfig, st: TieredState, seq_ids, k, v, pos):
    """Write K consecutive new tokens per lane (k, v [B, K, KV, hd]; lane
    b's token i at ``pos[b] + i``) into each page's current tier; idle and
    past-capacity lanes write nothing.  Pools update in place."""
    K = k.shape[1]
    ok, ids, fast_idx, slow_idx, off = append_routing(cfg, st, seq_ids,
                                                      pos, K)
    dt = st.fast_k.dtype
    drop_set_(st.fast_k, (fast_idx, slice(None), off), k.to(dt))
    drop_set_(st.fast_v, (fast_idx, slice(None), off), v.to(dt))
    drop_set_(st.slow_k, (slow_idx, slice(None), off), k.to(dt))
    drop_set_(st.slow_v, (slow_idx, slice(None), off), v.to(dt))
    st = st._replace(wtouch=drop_add(
        st.wtouch, torch.where(ok, ids, cfg.n_logical), 1))
    if cfg.pol.write_weight > 1:        # write-aware: appends heat pages up
        st = record_touches(cfg, st, ids.reshape(-1), ok.reshape(-1))
    return st


def append_token(cfg: TieredConfig, st: TieredState, seq_ids, k, v, pos):
    """One new token per lane (k, v [B, KV, hd]; ``pos`` scalar or [B])."""
    return append_tokens(cfg, st, seq_ids, k[:, None], v[:, None], pos)


# ---------------------------------------------------------------------------
# migrate / demote / release
# ---------------------------------------------------------------------------

def _leaf_hosting_slot(cfg: TieredConfig, leaf):
    """Leaf i is hosted at fast slot fast_data_slots + i (Section 3.2)."""
    return cfg.fast_data_slots + leaf


def _drop_entry(cfg: TieredConfig, st: TieredState, pid, enable,
                copy_back_from=None, apply_pools: bool = True
                ) -> TieredState:
    """Shared eviction tail: clear pid's iRT entry, set its iRC bit to
    identity, write the identity translation through the device table,
    optionally copy the fast bytes home.  ``apply_pools=False`` keeps
    every metadata effect and counter but moves no bytes (the stacked
    path replays the copies itself)."""
    pv = torch.where(enable, pid, 0)
    if copy_back_from is not None:
        if apply_pools:
            src = torch.where(enable, copy_back_from, 0)
            for fast, slow in ((st.fast_k, st.slow_k), (st.fast_v, st.slow_v)):
                slow[pv.long()] = torch.where(enable, _page_gather(fast, src),
                                              slow[pv.long()])
        st = st._replace(demo_pages=st.demo_pages + enable.to(I32))
    st = _irt_replace(st, irt_ops.invalidate(_irt_view(st), pv[None],
                                             enable[None]))
    st = st._replace(**rc_ops.invalidate(
        cfg.rc_geometry, _rc_view(st), pv[None], enable[None],
        becomes_identity=True))
    return _dev_update(cfg, st, pv, cfg.fast_slots + pv, enable)


def _migrate_one_desc(cfg: TieredConfig, st: TieredState, page_id, enable,
                      apply_pools: bool = True):
    """Migrate one hot logical page into the fast pool (FIFO victim,
    skipping allocated-metadata slots; metadata priority on leaf
    allocation), masked by ``enable``.  Returns ``(state, desc)``, where
    ``desc`` records the page copies the move implies (victim copy-back,
    install, forced-evict copy-back) as (src, dst, enable) scalars."""
    dev = st.leaf_table.device
    pid = torch.where(enable, page_id, 0).to(I32)
    already = at(st.leaf_table, pid) != INVALID
    en = enable & ~already

    # --- FIFO victim skipping slots whose hosted leaf is allocated -------
    K = cfg.fast_slots
    order = (st.fifo_ptr + torch.arange(K, dtype=I32, device=dev)) % K
    hosted_leaf = order - cfg.fast_data_slots          # leaf id or <0
    is_meta = order >= cfg.fast_data_slots
    leaf_ok = torch.where(
        is_meta,
        st.leaf_cnt[hosted_leaf.clamp(0, cfg.n_leaf - 1).long()] == 0, True)
    my_leaf = pid // E
    leaf_ok &= order != _leaf_hosting_slot(cfg, my_leaf)
    # prefer an admissible empty slot; only evicting a resident advances
    # the FIFO hand
    empty_ok = leaf_ok & (st.slot_owner[order.long()] == INVALID)
    has_empty = empty_ok.any()
    pos = torch.where(has_empty, first_true(empty_ok), first_true(leaf_ok))
    v = at(order, pos)
    st = st._replace(fifo_ptr=torch.where(en & ~has_empty,
                                          (st.fifo_ptr + pos + 1) % K,
                                          st.fifo_ptr))

    # --- evict the current occupant ---------------------------------------
    o = at(st.slot_owner, v)
    has_o = en & (o != INVALID)
    st = _drop_entry(cfg, st, o, has_o, copy_back_from=torch.where(en, v, 0),
                     apply_pools=apply_pools)

    # --- install the page from its slow home -------------------------------
    vv = torch.where(en, v, 0)
    if apply_pools:
        for fast, slow in ((st.fast_k, st.slow_k), (st.fast_v, st.slow_v)):
            fast[vv.long()] = torch.where(en, _page_gather(slow, pid),
                                          fast[vv.long()])
    st = st._replace(
        slot_owner=set_at(st.slot_owner, vv,
                          torch.where(en, pid, at(st.slot_owner, vv))),
        migrations=st.migrations + en.to(I32),
        promo_pages=st.promo_pages + en.to(I32))
    st = _irt_replace(st, irt_ops.fill(_irt_view(st), pid[None], v[None],
                                       en[None]))
    st = st._replace(**rc_ops.invalidate(
        cfg.rc_geometry, _rc_view(st), pid[None], en[None],
        becomes_identity=False))
    st = _dev_update(cfg, st, pid, vv, en)

    # --- metadata priority: evict data from the newly allocated leaf's
    # hosting slot (Section 3.3) -----------------------------------------
    h = _leaf_hosting_slot(cfg, my_leaf)
    was_free = at(st.leaf_cnt, my_leaf) == 1       # allocated just now
    x = at(st.slot_owner, h.clamp(0, cfg.fast_slots - 1))
    need = en & was_free & (x != INVALID) & (h < cfg.fast_slots)
    hv = torch.where(need, h, 0)
    st = _drop_entry(cfg, st, x, need, copy_back_from=hv,
                     apply_pools=apply_pools)
    st = st._replace(
        slot_owner=set_at(st.slot_owner, hv,
                          torch.where(need, INVALID,
                                      at(st.slot_owner, hv))),
        forced_evict=st.forced_evict + need.to(I32))
    desc = {"cb1_src": torch.where(en, v, 0),
            "cb1_dst": torch.where(has_o, o, 0), "cb1_en": has_o,
            "in_src": pid, "in_dst": vv, "in_en": en,
            "cb2_src": hv, "cb2_dst": torch.where(need, x, 0),
            "cb2_en": need}
    return st, desc


def migrate_one(cfg: TieredConfig, st: TieredState, page_id, enable):
    """Migrate one logical page into the fast pool (masked by ``enable``)."""
    return _migrate_one_desc(cfg, st, page_id, enable)[0]


def _demote_one_desc(cfg: TieredConfig, st: TieredState, page_id, enable,
                     apply_pools: bool = True):
    """Demote one resident page to its slow home (copy the fast bytes
    home, clear the iRT entry and the slot); returns ``(state, desc)``
    with one copy-back triple."""
    pid = torch.where(enable, page_id, 0).to(I32)
    entry = at(st.leaf_table, pid)
    en = enable & (entry != INVALID)
    slot = torch.where(en, entry, 0)
    st = _drop_entry(cfg, st, pid, en, copy_back_from=slot,
                     apply_pools=apply_pools)
    owner = torch.where(en, INVALID, at(st.slot_owner, slot))
    st = st._replace(slot_owner=set_at(st.slot_owner, slot, owner),
                     demotions=st.demotions + en.to(I32))
    return st, {"cb1_src": slot, "cb1_dst": pid, "cb1_en": en}


def demote_one(cfg: TieredConfig, st: TieredState, page_id, enable):
    return _demote_one_desc(cfg, st, page_id, enable)[0]


def _lane_index(seq):
    """A lane as a Python int, or a 0-d int tensor on the store's device
    as it stands: a captured step takes the lane as a device scalar, and
    ``int`` would read it on the host (and bake it into the graph)."""
    return seq if isinstance(seq, torch.Tensor) else int(seq)


def release_seq(cfg: TieredConfig, st: TieredState, seq) -> TieredState:
    """Free one sequence's pages when its lane is recycled: pure metadata
    (no bytes move) reset to identity in one batched pass — iRT entries,
    fast slots, hotness, the iRC row range, and the device-table rows
    (rewritten to the identity homes, still valid).  Works on a single
    or a stacked store alike (the metadata is shared).  ``seq``: a Python
    int or a 0-d int tensor on the device (``_lane_index``)."""
    dev = st.leaf_table.device
    lo = _lane_index(seq) * cfg.max_pages_per_seq
    ids = lo + torch.arange(cfg.max_pages_per_seq, dtype=I32, device=dev)
    entry = st.leaf_table[ids.long()]
    res = entry != INVALID
    st = st._replace(slot_owner=drop_set(
        st.slot_owner, torch.where(res, entry, cfg.fast_slots), INVALID))
    st = _irt_replace(st, irt_ops.invalidate(_irt_view(st), ids, res))
    st = st._replace(**rc_ops.invalidate_range(
        cfg.rc_geometry, _rc_view(st), lo, lo + cfg.max_pages_per_seq))
    st = _tr_replace(st, pol_track.forget(
        cfg.pol, _tr_view(cfg, st), ids, torch.ones_like(res)))
    return st._replace(
        wtouch=set_at(st.wtouch, ids, 0),
        dev_table=set_at(st.dev_table, ids, cfg.fast_slots + ids),
        dev_valid=set_at(st.dev_valid, ids, True))


release_seq_stacked = release_seq


# ---------------------------------------------------------------------------
# the maintenance pass
# ---------------------------------------------------------------------------

def _plan_inputs(cfg: TieredConfig, st: TieredState):
    """(scores [n], residency [n], epoch now)."""
    pol = cfg.pol
    n = cfg.n_logical
    now = _now(cfg, st)
    sc = pol_track.score(pol, _tr_view(cfg, st), now=now)[:n]
    if pol.decider == "write_aware":
        # touch holds R + W, wtouch holds W: R + write_weight * W
        sc = sc + (pol.write_weight - 1) * st.wtouch[:n]
    resident = st.leaf_table[:n] != INVALID
    return sc, resident, now


def _stack_descs(descs):
    if not descs:
        return None
    return {k: torch.stack([d[k] for d in descs]) for k in descs[0]}


def _apply_plan(cfg: TieredConfig, st: TieredState, p, now):
    """Demotions, then promotions, then tracker forget/decay and the epoch
    advance, on the metadata only.  Returns ``(state, demote_descs,
    promote_descs)``: the copy descriptors each move recorded, stacked
    move-major, for ``_replay_descs``."""
    pol = cfg.pol
    n = cfg.n_logical
    ddescs, pdescs = [], []
    for i in range(p.demote_ids.shape[0]):
        st, d = _demote_one_desc(cfg, st, p.demote_ids[i], p.demote_en[i],
                                 apply_pools=False)
        ddescs.append(d)
    for i in range(p.promote_ids.shape[0]):
        st, d = _migrate_one_desc(cfg, st, p.promote_ids[i], p.promote_en[i],
                                  apply_pools=False)
        pdescs.append(d)
    # demoted pages restart cold; promoted pages keep their score
    tr = pol_track.forget(pol, _tr_view(cfg, st), p.demote_ids, p.demote_en)
    tick = ((st.epoch + 1) % pol.epoch_len) == 0
    tr = pol_track.epoch_tick(pol, tr, now=now, enable=tick)
    st = _tr_replace(st, tr)
    wtouch = drop_set(st.wtouch, torch.where(p.demote_en, p.demote_ids, n), 0)
    st = st._replace(epoch=st.epoch + 1,
                     wtouch=torch.where(tick, wtouch >> 1, wtouch))
    return st, _stack_descs(ddescs), _stack_descs(pdescs)


def _one_layer(st: TieredState) -> TieredState:
    """A single-layer store as a one-layer stack: views of its pools, so
    the stacked ops' in-place pool writes land in ``st``."""
    return st._replace(**{f: getattr(st, f)[None] for f in POOL_FIELDS})


def _unstack(one: TieredState, st: TieredState) -> TieredState:
    return one._replace(**{f: getattr(st, f) for f in POOL_FIELDS})


def run_scheduler(cfg: TieredConfig, st: TieredState,
                  max_moves: int | None = None, err=None) -> TieredState:
    """One maintenance pass on a single-layer store: score, plan bounded
    promotion + demotion queues, apply them, advance the epoch.  The page
    copies replay as on a one-layer stack (``run_scheduler_stacked``), so
    the pass reads its out-of-range flag once, not once per copy (or, with
    the caller's ``err``, leaves it to the caller: ``_replay_descs``)."""
    return _unstack(run_scheduler_stacked(cfg, _one_layer(st), max_moves,
                                          err=err), st)


def migrate_hot(cfg: TieredConfig, st: TieredState,
                max_moves: int = 4) -> TieredState:
    """DEPRECATED shim: the inlined top-k promotion pass is now the policy
    scheduler (``run_scheduler``), which adds demotion and epoch decay."""
    return run_scheduler(cfg, st, max_moves=max_moves)


def metadata_pages(cfg: TieredConfig, st: TieredState) -> torch.Tensor:
    """Current metadata footprint in pages (allocated leaves), against
    the linear-table equivalent ``n_leaf`` (Figure 9 analogue for
    serving); a 0-d tensor on the store's device."""
    return (st.leaf_cnt > 0).sum()


def run_scheduler_tenants(cfg: TieredConfig, st: TieredState, page_tenant,
                          pols, quotas) -> TieredState:
    """The multi-tenant maintenance pass on a single-layer store (see
    ``run_scheduler_tenants_stacked``)."""
    return _unstack(run_scheduler_tenants_stacked(
        cfg, _one_layer(st), page_tenant, pols, quotas), st)


# ---------------------------------------------------------------------------
# layer-stacked maintenance: metadata once, copies replayed over [L, ...]
# ---------------------------------------------------------------------------

def _pass_records(ddesc, pdesc):
    """A pass's recorded copies as one int32 table [n_rec, 4] of (dir,
    src, dst, en) rows, built on the device in the order the metadata pass
    recorded them: all demote copy-backs, then per promotion victim
    copy-back -> install -> forced-evict copy-back.  None: no copies."""
    def rows(direction, desc, kind):
        src = desc[kind + "_src"].to(I32)
        return [torch.full_like(src, direction), src,
                desc[kind + "_dst"].to(I32), desc[kind + "_en"].to(I32)]

    parts = []
    if ddesc is not None:
        parts.append(torch.stack(rows(FAST_TO_SLOW, ddesc, "cb1"), -1))
    if pdesc is not None:
        parts.append(torch.stack(
            rows(FAST_TO_SLOW, pdesc, "cb1") + rows(SLOW_TO_FAST, pdesc, "in")
            + rows(FAST_TO_SLOW, pdesc, "cb2"), -1).view(-1, 4))
    return torch.cat(parts) if parts else None


def _replay_descs(pools, ddesc, pdesc, err=None):
    """Apply recorded maintenance copies to the stacked pools in exactly
    the order the metadata pass recorded them (``_pass_records``), every
    layer alike, in one launch of the copy engine's replay
    (``remap_replay_op``).  Without ``err`` its out-of-range flag is read
    at once; with the caller's ``err`` (``remap_gather.ops.new_flag``)
    the launch sets that flag and nothing waits for the card: the caller
    reads it (``check_flag``) where it next waits anyway, so the pass can
    run inside a captured CUDA graph."""
    recs = _pass_records(ddesc, pdesc)
    if recs is None:
        return
    if err is not None:
        rg_ops.remap_replay_op(pools, recs, err)
        return
    err = rg_ops.new_flag(pools[0].device)
    rg_ops.remap_replay_op(pools, recs, err)
    rg_ops.check_flag(err)


def _stacked_pools(sts: TieredState):
    return tuple(getattr(sts, f) for f in POOL_FIELDS)


def plan_maintenance(cfg: TieredConfig, sts: TieredState,
                     max_moves: int | None = None):
    """Score + plan (no state change); one plan serves every layer.
    ``apply_maintenance_stacked`` may apply it one decode step later:
    write-through keeps both tiers' bytes fresh."""
    pol = cfg.pol
    mm = pol.max_moves if max_moves is None else int(max_moves)
    sc, resident, _ = _plan_inputs(cfg, sts)
    return pol_sched.plan(pol, sc, resident, mm)


def apply_maintenance_stacked_desc(cfg: TieredConfig, sts: TieredState, p,
                                   err=None):
    """Apply a Plan to a stacked store: the metadata pass runs once with
    pool copies recorded, then the copies replay over the [L, ...] pools
    (in place; ``err`` as in ``_replay_descs``).  Returns ``(state, ddesc,
    pdesc)``."""
    sts, ddesc, pdesc = _apply_plan(cfg, sts, p, _now(cfg, sts))
    _replay_descs(_stacked_pools(sts), ddesc, pdesc, err)
    return sts, ddesc, pdesc


def apply_maintenance_stacked(cfg: TieredConfig, sts: TieredState, p,
                              err=None) -> TieredState:
    return apply_maintenance_stacked_desc(cfg, sts, p, err)[0]


def run_scheduler_stacked(cfg: TieredConfig, sts: TieredState,
                          max_moves: int | None = None,
                          err=None) -> TieredState:
    """One synchronous maintenance pass over a stacked store (``err`` as
    in ``_replay_descs``)."""
    return apply_maintenance_stacked(
        cfg, sts, plan_maintenance(cfg, sts, max_moves), err)


def run_scheduler_tenants_stacked(cfg: TieredConfig, sts: TieredState,
                                  page_tenant, pols, quotas,
                                  err=None) -> TieredState:
    """The multi-tenant maintenance pass (DESIGN.md §9) over a stacked
    store: ``run_scheduler``'s scoring and apply, with the move queues of
    ``core/policy.plan_tenants``: one bounded plan per tenant over its own
    pages (``page_tenant`` [n_logical] int32, < 0: moves for nobody), each
    with its tenant's policy (``pols``) and fast-slot quota
    (``quotas``).  Always synchronous: the engine never defers it.
    ``err`` as in ``_replay_descs``."""
    sc, resident, now = _plan_inputs(cfg, sts)
    p = pol_sched.plan_tenants(pols, sc, resident, page_tenant, quotas)
    sts, ddesc, pdesc = _apply_plan(cfg, sts, p, now)
    _replay_descs(_stacked_pools(sts), ddesc, pdesc, err)
    return sts


def _paged(cfg: TieredConfig, x, dt):
    """[..., S, KV, hd] rows -> [..., npages, KV, P, hd] pages (zero pad)."""
    S, KV, hd = x.shape[-3:]
    P = cfg.page_tokens
    npages = -(-S // P)
    if npages > cfg.max_pages_per_seq:
        raise ValueError(
            f"prompt of {S} tokens needs {npages} pages; sequence capacity "
            f"is {cfg.max_pages_per_seq}")
    pad = torch.zeros(x.shape[:-3] + (npages * P - S, KV, hd), dtype=dt,
                      device=x.device)
    x = torch.cat([x.to(dt), pad], dim=-3)
    return x.reshape(x.shape[:-3] + (npages, P, KV, hd)).transpose(-3, -2)


def prefill_tokens_stacked(cfg: TieredConfig, sts: TieredState, seq, k, v,
                           length=None) -> TieredState:
    """Batched prompt ingest into one sequence's slow homes in every
    layer: k, v [L, S, KV, hd], pages at or past ``length`` skipped, one
    scatter per pool.  ``seq`` and ``length``: Python ints or 0-d int
    tensors on the device.  Precondition: the sequence's pages map to
    identity (freshly released)."""
    dt = sts.slow_k.dtype
    pk, pv = _paged(cfg, k, dt), _paged(cfg, v, dt)
    j = torch.arange(pk.shape[1], dtype=I32, device=sts.slow_k.device)
    length = on_device(k.shape[1] if length is None else length, I32,
                       j.device)
    rows = torch.where(j * cfg.page_tokens < length,
                       _lane_index(seq) * cfg.max_pages_per_seq + j,
                       cfg.n_logical)
    drop_set_(sts.slow_k, (slice(None), rows), pk)
    drop_set_(sts.slow_v, (slice(None), rows), pv)
    return sts


def prefill_chunk_stacked(cfg: TieredConfig, sts: TieredState, seq, k, v,
                          start: int, length) -> TieredState:
    """Chunked prompt ingest (DESIGN.md §9): tokens ``[start, start + C)``
    of sequence ``seq`` in every layer (k, v [L, C, KV, hd]; ``start``
    page aligned; every chunk but the last covers whole pages; ``seq``,
    ``start`` and ``length`` Python ints or 0-d int tensors on the
    device).  Unlike ``prefill_tokens_stacked`` each page goes to its
    current tier: the fast copy of a resident page (admitted at ingest or
    promoted mid-ingest), else the slow home, as appends do.  Pages at or
    past ``length`` are skipped.  Pools update in place."""
    dt = sts.slow_k.dtype
    pk, pv = _paged(cfg, k, dt), _paged(cfg, v, dt)
    dev = sts.slow_k.device
    j = _lane_index(start) // cfg.page_tokens + torch.arange(
        pk.shape[1], dtype=I32, device=dev)
    ok = (j * cfg.page_tokens < on_device(length, I32, dev)) \
        & (j < cfg.max_pages_per_seq)
    ids = logical_page(cfg, _lane_index(seq),
                       j.clamp(0, cfg.max_pages_per_seq - 1))
    entry = sts.leaf_table[ids.long()]
    in_fast = entry != INVALID
    fast_idx = torch.where(ok & in_fast, entry, cfg.fast_slots)
    slow_idx = torch.where(ok & ~in_fast, ids, cfg.n_logical)
    for pool, pages, idx in ((sts.fast_k, pk, fast_idx),
                             (sts.fast_v, pv, fast_idx),
                             (sts.slow_k, pk, slow_idx),
                             (sts.slow_v, pv, slow_idx)):
        drop_set_(pool, (slice(None), idx), pages)
    return sts


def prefill_chunk(cfg: TieredConfig, st: TieredState, seq, k, v, start: int,
                  length) -> TieredState:
    """``prefill_chunk_stacked`` on a single-layer store (k, v
    [C, KV, hd])."""
    prefill_chunk_stacked(cfg, _one_layer(st), seq, k[None], v[None], start,
                          length)
    return st


def admit_pages_stacked_desc(cfg: TieredConfig, sts: TieredState, seq,
                             length, n_pages: int, err=None):
    """Direct-to-fast admission at ingest (DESIGN.md §9): promote the
    first ``n_pages`` pages of sequence ``seq`` that hold tokens below
    ``length`` into the fast pool now, with one tracker touch each (the
    install touch, so a maintenance pass mid-ingest does not demote them
    straight back).  The moves run once on the metadata, in page order;
    their install copies replay over the [L, ...] pools (``err`` as in
    ``_replay_descs``).  ``seq`` and ``length``: Python ints or 0-d int
    tensors on the device; ``n_pages`` is static.  Returns ``(state,
    pdesc)``, the moves' copy descriptors."""
    dev = sts.leaf_table.device
    mpp = cfg.max_pages_per_seq
    j = torch.arange(int(n_pages), dtype=I32, device=dev)
    en = (j * cfg.page_tokens < on_device(length, I32, dev)) & (j < mpp)
    ids = logical_page(cfg, _lane_index(seq), j.clamp(0, mpp - 1))
    descs = []
    for i in range(int(n_pages)):
        sts, d = _migrate_one_desc(cfg, sts, ids[i], en[i],
                                   apply_pools=False)
        descs.append(d)
    sts = _tr_replace(sts, pol_track.record(cfg.pol, _tr_view(cfg, sts), ids,
                                            now=_now(cfg, sts), enable=en))
    pdesc = _stack_descs(descs)
    _replay_descs(_stacked_pools(sts), None, pdesc, err)
    return sts, pdesc


def admit_pages_stacked(cfg: TieredConfig, sts: TieredState, seq, length,
                        n_pages: int, err=None) -> TieredState:
    return admit_pages_stacked_desc(cfg, sts, seq, length, n_pages, err)[0]


def prefill_tokens(cfg: TieredConfig, st: TieredState, seq, k, v,
                   length=None) -> TieredState:
    """``prefill_tokens_stacked`` on a single-layer store: tokens ``[0,
    length)`` of sequence ``seq`` into its slow homes in one pass, k, v
    [S, KV, hd] (padding past ``length`` skipped page-wise; more pages
    than a sequence holds raise ``ValueError``).  Pools update in place.
    Precondition: the sequence's pages map to identity (freshly
    released)."""
    return _unstack(prefill_tokens_stacked(cfg, _one_layer(st), seq,
                                           k[None], v[None], length), st)


def admit_pages(cfg: TieredConfig, st: TieredState, seq, length,
                n_pages: int) -> TieredState:
    """``admit_pages_stacked`` on a single-layer store."""
    return _unstack(admit_pages_stacked(cfg, _one_layer(st), seq, length,
                                        n_pages), st)
