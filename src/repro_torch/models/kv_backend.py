"""KV-cache backends for the decode loop (port of
``repro.models.kv_backend``).

  DenseBackend   contiguous [L, B, max_len, KV, hd] caches (and the
                 recurrent states of the hybrid and ssm families),
                 per-layer ``append`` then ``attend``;
  TieredBackend  one Trimma-managed two-tier store for all layers: pools
                 stacked [L, ...] under one shared copy of the metadata
                 (``tiered.kvcache``).  A decode step routes its append
                 and advances the metadata once (``begin_step``), runs one
                 fused append+attend kernel per layer (``append_attend``)
                 and persists every layer's new rows in four stacked
                 scatters (``end_step``).

Both take a prompt in one shot (``write_prefill``) or chunk by chunk
(``write_prefill_chunk``); the tiered backend also admits a prompt's
first pages straight into the fast pool (``admit_prefix``) and runs the
multi-tenant maintenance pass (``maintain_tenants``).

``pos`` is per lane ([B] int32); a negative position marks an idle lane,
whose append is dropped and whose read sees nothing.  Caches, pools and
``pos`` update in place.  The lane, ``start`` and ``length`` of the
prompt and lifecycle methods are Python ints or 0-d int tensors on the
device (a captured step's device scalars, never read on the host).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch._scatter import drop_add, drop_set_, on_device
from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device

from . import attention as attn


def _lane_rows(lane, device) -> torch.Tensor:
    """A lane (Python int or 0-d tensor) as a [1] int64 index on
    ``device``: a 0-d tensor index would be read on the host."""
    return on_device(lane, torch.int64, device).reshape(1)


def _set_pos(pos: torch.Tensor, lane, length) -> None:
    """``pos[lane] = length`` in place, without a host read."""
    pos[_lane_rows(lane, pos.device)] = on_device(
        length, pos.dtype, pos.device).reshape(1)


def _host_num(v):
    """Integral values as exact ints, fractional gauges as floats."""
    f = float(v)
    return int(f) if f.is_integer() else f


class DenseBackend:
    """Contiguous per-layer caches (``transformer.init_decode_state``):
    ``{"k", "v"}`` [L, B, max_len, KV, hd], for the hybrid family with
    the Mamba state ``"ssm"`` beside them, for the vlm family stacked
    [ns, inner, ...] with the image K/V ``"ik"``, ``"iv"`` beside them;
    the ssm family's caches are its recurrent states only.  ``append``
    and ``attend`` take one layer's [B, max_len, KV, hd] slice (views)
    and touch only its "k" and "v"; the decode step writes a layer's
    recurrent states into their slices in place, as ``append`` writes
    the KV rows."""

    def __init__(self, cfg: ArchConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)

    def init_state(self, batch: int, max_len: int):
        from . import transformer
        return transformer.init_decode_state(self.cfg, batch, max_len,
                                             self.device)

    def is_ring(self, cache) -> bool:
        """Whether a layer's cache view is a ring of the sliding window's
        slots (``transformer._ring_cache_len``): no more positions than
        the window, as the reference decides."""
        sw = self.cfg.sliding_window
        return sw > 0 and cache["k"].shape[1] <= sw

    def append(self, cache, k, v, pos, *, ring: bool = False):
        """Write one token's K/V per lane (k, v [B, KV, hd]) into one
        layer's cache view, at row ``pos`` (``pos % S`` in a ring); idle
        and past-capacity lanes write nothing.  Every lane has its own
        row, so a lane that writes nothing rewrites the bytes already at
        its position clamped into the cache (a few launches, where
        ``drop_set_``'s general rule takes ~35)."""
        ck, cv = cache["k"], cache["v"]
        B, S = ck.shape[:2]
        if ring:
            ok, row = pos >= 0, pos.remainder(S).long()
        else:
            ok, row = (pos >= 0) & (pos < S), pos.clamp(0, S - 1).long()
        ok = ok[:, None, None]
        lane = torch.arange(B, device=ck.device)
        for c, new in ((ck, k), (cv, v)):
            c[lane, row] = torch.where(ok, new.to(c.dtype), c[lane, row])
        return cache

    def attend(self, cache, q, pos, *, window: int = 0, ring: bool = False):
        """q [B, KV, G, hd] attends positions <= pos per lane, and with
        ``window`` > 0 only those > pos - window (the reference's sliding
        window mask); in a ring (``ring``) slot s holds position
        ``pos - ((pos - s) mod S)``, masked by the same rule (an idle lane
        sees nothing)."""
        B, KV, G, hd = q.shape
        ck, cv = cache["k"], cache["v"]
        mask = self.shard_mask(pos, ck.shape[1], window=window,
                               ring=ck.shape[1] if ring else 0)
        out = attn._sdpa(q.reshape(B, 1, KV * G, hd), ck.to(q.dtype),
                         cv.to(q.dtype), mask[:, None, None, None, :])
        return out.reshape(B, KV, G, hd), cache

    @staticmethod
    def shard_mask(pos, rows: int, *, start: int = 0, window: int = 0,
                   ring: int = 0):
        """[B, rows] additive fp32 mask of positions [start, start + rows)
        against each lane's ``pos`` (``attend``'s rule); with ``ring`` = W
        slots [start, start + rows) of a ring of W slots, at the positions
        they hold."""
        ki = torch.arange(rows, device=pos.device)[None, :] + start
        pb = pos[:, None]
        if ring:
            ki = pb - (pb - ki).remainder(ring)
            ok = ki >= 0
        else:
            ok = ki <= pb
        if window > 0:
            ok &= ki > pb - window
        return torch.where(ok, 0.0, attn.NEG_INF).float()

    def attend_shard(self, cache, q, pos, *, start: int = 0,
                     window: int = 0, mask=None):
        """``attend`` over a piece of the sequence: the layer's cache view
        holds positions [start, start + rows) (a rank's piece of the
        sequence-sharded cache; a ring's slots take ``shard_mask``'s
        ``ring``).  Returns (out [B, KV, G, hd], lse [B, KV, G]), the scores'
        log-sum-exp beside the output, for the merge across pieces; a
        lane with no position of the piece at or below its ``pos`` gets
        an lse near -1e30 and weighs nothing there.  With ``start`` 0 and
        the whole cache, ``out`` is ``attend``'s.  ``mask``:
        ``shard_mask``'s, made once for every layer of a step."""
        B, KV, G, hd = q.shape
        ck, cv = cache["k"], cache["v"]
        if mask is None:
            mask = self.shard_mask(pos, ck.shape[1], start=start,
                                   window=window)
        out, lse = attn._sdpa_lse(q.reshape(B, 1, KV * G, hd),
                                  ck.to(q.dtype), cv.to(q.dtype),
                                  mask[:, None, None, None, :], lse=True)
        return out.reshape(B, KV, G, hd), lse.reshape(B, KV, G)

    def write_prefill(self, state, lane, k_layers, v_layers, length):
        """Install a prompt's K/V (k/v [L, P, KV, hd], rows < ``length``
        real) into one lane and set ``pos[lane] = length``."""
        c = state.caches
        P = k_layers.shape[1]
        ln = _lane_rows(lane, c["k"].device)
        c["k"][:, ln, :P] = k_layers[:, None].to(c["k"].dtype)
        c["v"][:, ln, :P] = v_layers[:, None].to(c["v"].dtype)
        _set_pos(state.pos, lane, length)
        return state

    def write_prefill_chunk(self, state, lane, k_layers, v_layers, start,
                            length):
        """Chunked prompt ingest: rows [start, start + C) of one lane's
        prompt K/V (k/v [L, C, KV, hd]).  ``pos`` is untouched: the
        scheduler sets it when the last chunk lands."""
        c = state.caches
        dev = c["k"].device
        rows = on_device(start, torch.int64, dev) + torch.arange(
            k_layers.shape[1], device=dev)
        ln = _lane_rows(lane, dev)
        c["k"][:, ln, rows] = k_layers.to(c["k"].dtype)
        c["v"][:, ln, rows] = v_layers.to(c["v"].dtype)
        return state


class PoolOperands(NamedTuple):
    """The four pool tensors of a stacked store: the layer loop's view."""
    fast_k: Any
    fast_v: Any
    slow_k: Any
    slow_v: Any


class TieredBackend:
    """One shared-metadata ``TieredState`` whose pools stack the layers.

    ``maintain`` / ``plan_maintain`` + ``apply_maintain`` run the
    scheduler once on the shared metadata and replay the page copies over
    the [L, ...] pools; ``release`` resets a lane's metadata;
    ``write_prefill`` lands a prompt in the slow homes of every layer.
    Only plain-KV decoders without a sliding window qualify."""

    def __init__(self, cfg: ArchConfig, batch: int, max_len: int, *,
                 page_tokens: int = 16, fast_data_slots: int = 16,
                 policy=None, device=None):
        from repro_torch.tiered import kvcache as tk
        if cfg.family not in ("dense", "moe"):
            raise NotImplementedError(
                f"TieredBackend supports plain-KV decoder families; got "
                f"family={cfg.family!r}")
        if cfg.sliding_window:
            raise NotImplementedError(
                "TieredBackend has no sliding-window semantics (the paged "
                "kernel reads every live page)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.n_layers = cfg.n_layers
        self.tcfg = tk.TieredConfig(
            n_seqs=batch, max_pages_per_seq=-(-max_len // page_tokens),
            page_tokens=page_tokens, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.hd, fast_data_slots=fast_data_slots, policy=policy,
            dtype=cfg.dtype)
        self._seq_ids = torch.arange(batch, dtype=torch.int32,
                                     device=self.device)

    def init_state(self, batch: int, max_len: int):
        from repro_torch.tiered import kvcache as tk

        from . import transformer
        if batch != self.tcfg.n_seqs:
            raise ValueError(f"batch {batch} != backend's {self.tcfg.n_seqs}")
        return transformer.DecodeState(
            torch.zeros((batch,), dtype=torch.int32, device=self.device),
            tk.init_state(self.tcfg, self.device, n_layers=self.n_layers))

    # -- one layer's store (unstacked), the reference's scan slice -------

    def append(self, cache, k, v, pos, *, ring: bool = False):
        """Write one token per lane (k, v [B, KV, hd]) into ONE layer's
        unstacked ``TieredState``; idle lanes write nothing."""
        if ring:
            raise NotImplementedError(
                "TieredBackend cannot ring-wrap appends: a paged store has "
                "no modular position axis")
        from repro_torch.tiered import kvcache as tk
        return tk.append_token(self.tcfg, cache, self._seq_ids, k, v, pos)

    def attend(self, cache, q, pos, *, window=0, ring: bool = False):
        """The zero-copy read of ONE layer's unstacked store: q
        [B, KV, G, hd] attends positions <= pos per lane -> (out, cache)."""
        if ring:
            raise NotImplementedError(
                "TieredBackend cannot ring-read: a paged store has no "
                "modular position axis")
        if not isinstance(window, int) or window != 0:
            raise NotImplementedError(
                "TieredBackend has no sliding-window semantics (the paged "
                "kernel reads every live page)")
        from repro_torch.serve import tiered as srv
        seq_lens = torch.clamp(pos.to(torch.int32) + 1, min=0)
        return srv.attend(self.tcfg, cache, q, seq_lens.contiguous())

    # -- fused decode step ------------------------------------------------

    def begin_step(self, caches, pos, n_pages: int | None = None):
        """Route this step's one-token append and advance all per-step
        metadata once: write touches, tracker records, device-table
        hits.  Returns (caches, aux); ``aux`` carries the routing and the
        leaf entries (sliced to the live-page bucket ``n_pages``) that
        ``append_attend``/``end_step`` consume.  No pool byte moves."""
        from repro_torch.serve import tiered as srv
        from repro_torch.tiered import kvcache as tk
        cfg = self.tcfg
        pos = pos.to(torch.int32).expand(cfg.n_seqs)
        entries = caches.leaf_table[:cfg.n_logical].view(
            cfg.n_seqs, cfg.max_pages_per_seq)
        if n_pages is not None and n_pages < cfg.max_pages_per_seq:
            entries = entries[:, :n_pages]
        ok, ids, fast_idx, slow_idx, off = tk.append_routing(
            cfg, caches, self._seq_ids, pos, 1)
        aux = {"entries": entries, "fast_idx": fast_idx[:, 0],
               "slow_idx": slow_idx[:, 0], "off": off[:, 0]}
        st = caches._replace(wtouch=drop_add(
            caches.wtouch, torch.where(ok, ids, cfg.n_logical), 1))
        if cfg.pol.write_weight > 1:    # write-aware: appends heat pages
            st = tk.record_touches(cfg, st, ids.reshape(-1), ok.reshape(-1))
        lv = srv.live_mask(cfg, torch.where(pos >= 0, pos + 1, 0)).reshape(-1)
        table = srv.page_table(cfg, st).reshape(-1)
        st = tk.record_reads(cfg, st, table, lv)
        st = tk.record_touches(cfg, st, table, lv)
        return st, aux

    def scan_operands(self, caches):
        return PoolOperands(caches.fast_k, caches.fast_v, caches.slow_k,
                            caches.slow_v)

    def append_attend(self, cache, q, k1, v1, pos, aux):
        """One layer's fused append+attend: q [B, KV, G, hd], k1/v1
        [B, KV, hd] -> [B, KV, G, hd]; ``cache`` is one layer's pools,
        read only."""
        from repro_torch.kernels.paged_attention.ops import \
            paged_attention_fused_op
        out = paged_attention_fused_op(
            q[:, None], cache.fast_k, cache.fast_v, cache.slow_k,
            cache.slow_v, aux["entries"], k1[:, None], v1[:, None],
            pos.to(torch.int32))
        return out[:, 0]

    def end_step(self, caches, knv, pos, aux):
        """Persist every layer's new row (k, v [L, B, KV, hd]) with four
        stacked scatters routed by ``begin_step`` (appends never move
        pages, so the routing still holds)."""
        k_all, v_all = knv
        li = torch.arange(self.n_layers, device=k_all.device)[:, None]
        fi, si, off = (aux["fast_idx"][None], aux["slow_idx"][None],
                       aux["off"][None])
        dt = caches.fast_k.dtype
        drop_set_(caches.fast_k, (li, fi, slice(None), off), k_all.to(dt))
        drop_set_(caches.fast_v, (li, fi, slice(None), off), v_all.to(dt))
        drop_set_(caches.slow_k, (li, si, slice(None), off), k_all.to(dt))
        drop_set_(caches.slow_v, (li, si, slice(None), off), v_all.to(dt))
        return caches

    # -- maintenance & lane lifecycle ---------------------------------------

    def maintain(self, state, max_moves: int | None = None, err=None):
        """One synchronous migration-scheduler pass.  ``err``: the
        caller's out-of-range flag for the pass's copies, read by the
        caller (``kvcache._replay_descs``); without it the pass reads its
        own at once."""
        from repro_torch.tiered import kvcache as tk
        return state._replace(caches=tk.run_scheduler_stacked(
            self.tcfg, state.caches, max_moves=max_moves, err=err))

    def plan_maintain(self, state, max_moves: int | None = None):
        """Score + plan only; the engine applies it one step later."""
        from repro_torch.tiered import kvcache as tk
        return tk.plan_maintenance(self.tcfg, state.caches,
                                   max_moves=max_moves)

    def apply_maintain(self, state, plan, err=None):
        """Apply a previously computed plan (safe one step late:
        write-through keeps both tiers' bytes fresh); ``err`` as in
        ``maintain``."""
        from repro_torch.tiered import kvcache as tk
        return state._replace(caches=tk.apply_maintenance_stacked(
            self.tcfg, state.caches, plan, err))

    def apply_maintain_desc(self, state, plan, err=None):
        """``apply_maintain`` that also returns the (ddesc, pdesc) move
        descriptors, what each plan entry actually did, for the flight
        recorder.  The same pass (one replay launch); the descriptors are
        the ones its copy table was built from; ``err`` as in
        ``maintain``."""
        from repro_torch.tiered import kvcache as tk
        caches, ddesc, pdesc = tk.apply_maintenance_stacked_desc(
            self.tcfg, state.caches, plan, err)
        return state._replace(caches=caches), ddesc, pdesc

    def release(self, state, lane):
        """Drop one lane's pages from the metadata (pos untouched)."""
        from repro_torch.tiered import kvcache as tk
        return state._replace(caches=tk.release_seq_stacked(
            self.tcfg, state.caches, lane))

    def write_prefill(self, state, lane, k_layers, v_layers, length):
        """All layers' prompt K/V pages land in the slow homes; sets
        ``pos[lane] = length``.  The lane must have been released."""
        from repro_torch.tiered import kvcache as tk
        caches = tk.prefill_tokens_stacked(self.tcfg, state.caches, lane,
                                           k_layers, v_layers, length)
        _set_pos(state.pos, lane, length)
        return state._replace(caches=caches)

    def write_prefill_chunk(self, state, lane, k_layers, v_layers, start,
                            length):
        """Chunked prompt ingest, one page-aligned chunk: rows
        [start, start + C) of each layer's prompt K/V land in each page's
        current tier (``prefill_chunk_stacked``: a page admitted to the
        fast pool takes its fast copy).  ``pos`` untouched."""
        from repro_torch.tiered import kvcache as tk
        return state._replace(caches=tk.prefill_chunk_stacked(
            self.tcfg, state.caches, lane, k_layers, v_layers, start,
            length))

    def admit_prefix(self, state, lane, length, n_pages: int, err=None):
        """Direct-to-fast admission at ingest: promote the first
        ``n_pages`` prompt pages of ``lane`` into the fast pool of every
        layer now (``admit_pages_stacked``; ``err`` as in ``maintain``)."""
        from repro_torch.tiered import kvcache as tk
        return state._replace(caches=tk.admit_pages_stacked(
            self.tcfg, state.caches, lane, length, n_pages, err))

    def admit_prefix_desc(self, state, lane, length, n_pages: int,
                          err=None):
        """``admit_prefix`` that also returns the install descriptors
        (flight-recorder install and admission-eviction events)."""
        from repro_torch.tiered import kvcache as tk
        caches, pdesc = tk.admit_pages_stacked_desc(
            self.tcfg, state.caches, lane, length, n_pages, err)
        return state._replace(caches=caches), pdesc

    def maintain_tenants(self, state, lane_tenant, pols, quotas, err=None):
        """Multi-tenant maintenance: one ``run_scheduler_tenants_stacked``
        pass (always synchronous).  ``lane_tenant`` [B] maps each lane to
        its tenant (< 0: idle, its pages move for nobody): an int32
        tensor on the device, taken as it stands (the engine's own
        buffer), or an array, copied there; ``pols`` and ``quotas`` are
        the per-tenant policies and fast-slot partition; ``err`` as in
        ``maintain``."""
        from repro_torch.tiered import kvcache as tk
        lt = torch.as_tensor(lane_tenant, dtype=torch.int32,
                             device=self.device)
        page_tenant = lt[:, None].expand(
            -1, self.tcfg.max_pages_per_seq).reshape(-1)
        return state._replace(caches=tk.run_scheduler_tenants_stacked(
            self.tcfg, state.caches, page_tenant, pols, quotas, err))

    def metrics(self, state) -> dict:
        """Canonical telemetry, with counts summed over the layers the
        shared metadata stands for (the reference's per-layer sum)."""
        from repro_torch.serve import tiered as srv
        return {k: _host_num(v) for k, v in srv.metrics(
            self.tcfg, state.caches, copies=self.n_layers).items()}

    def counters(self, state) -> dict:
        """Legacy short-key counters, re-derived from the canonical view."""
        from repro_torch.obs.metrics import legacy_counters
        return legacy_counters(self.metrics(state))


def make_backend(cfg: ArchConfig, kind: str, batch: int, max_len: int, *,
                 device=None, **tiered_kw: Any):
    """``kind`` is "dense" or "tiered"; ``tiered_kw`` forwards geometry and
    policy to ``TieredBackend``."""
    if kind == "dense":
        return DenseBackend(cfg, device)
    if kind == "tiered":
        return TieredBackend(cfg, batch, max_len, device=device, **tiered_kw)
    raise ValueError(f"unknown KV backend {kind!r} (want dense|tiered)")
