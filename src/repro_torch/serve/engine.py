"""Serving drivers (port of ``repro.serve.engine``): ``TieredServer``, the
single-store decode driver, and the batched greedy-decode ``Engine`` with
``EngineConfig``, ``Request`` and ``padded_len``.

Continuous batching over a fixed-width batch: finished lanes release
their tiered metadata and refill from the queue through the scheduler
(``serve/sched``: greedy one-shot prefill, or chunked prefill with
multi-tenant QoS admission and direct-to-fast ingest); idle lanes sit at
pos = -1; with ``backend="tiered"`` every decode step is the fused path
(``begin_step`` -> one kernel per layer -> ``end_step``) over the
live-page bucket, and a migration-scheduler pass runs every
``maintain_every`` steps, double-buffered (``overlap_maintain``: plan at
the hook, apply before the next step, flushed before any release) except
the multi-tenant pass, which is always synchronous.

Left out of the port so far: the observability hub, tracer, flight
recorder, SLO monitor and HTTP endpoints.  ``jax.jit`` state donation
has no counterpart: the pools update in place.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import decode_step, forward
from repro_torch.models.kv_backend import TieredBackend, make_backend
from repro_torch.obs import metrics as obs_metrics


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # [S] int32
    max_new: int
    tenant_id: str = "default"    # QoS tenant (serve/sched/qos)
    arrived: float = 0.0          # enqueue time (stamped by submit)
    admitted_at: float = 0.0      # lane assignment time
    first_token_at: float = 0.0   # first decoded token
    done_at: float = 0.0          # wall time the last token was decoded
    tokens: list = dataclasses.field(default_factory=list)
    token_times: list = dataclasses.field(default_factory=list)
    done: bool = False

    @property
    def latency(self) -> float:
        """End-to-end latency from the request's own enqueue time."""
        return self.done_at - self.arrived

    @property
    def ttft(self) -> float:
        """Time to first token, from enqueue."""
        return self.first_token_at - self.arrived

    @property
    def queue_wait(self) -> float:
        return self.admitted_at - self.arrived


@dataclasses.dataclass
class EngineConfig:
    batch: int = 4
    max_len: int = 256
    bucket: int = 64              # straggler bucketing granularity
    backend: str = "dense"        # KV backend: "dense" | "tiered"
    page_tokens: int = 16         # tiered geometry / policy (ignored for
    fast_data_slots: int = 16     # dense)
    policy: str | None = None     # core/policy preset name
    maintain_every: int = 4       # migration-scheduler cadence (steps)
    overlap_maintain: bool = True  # plan at the hook, apply before the
                                  # next decode step
    page_bucket: bool = True      # attend only the power-of-two live-page
                                  # prefix covering every lane
    scheduler: str = "greedy"     # "greedy" | "chunked" ("wave": a
                                  # deprecated greedy alias)
    prefill_chunk: int = 0        # chunked: prompt tokens ingested per
                                  # engine step (0: one-shot prefill)
    admit_pages: int = 2          # direct-to-fast pages per ingest when a
                                  # tenant's decider is on-demand
    tenants: tuple = ()           # TenantConfig per tenant (empty: one
                                  # default tenant)
    starvation_bound: int = 8     # QoS: most admission skips in a row


class TieredServer:
    """Continuous tiered-KV decode driver over ONE Trimma-managed two-tier
    store (a single attention layer's worth; ``Engine`` serves a model
    through ``TieredBackend``), on ``device`` (the card unless the caller
    asks for the CPU).

    ``step`` is one decode token for every lane through
    ``serve.decode.make_tiered_decode_step`` (``path``: "zero_copy",
    "concat" or "fused"); ``maintain`` runs one migration-scheduler pass
    between steps; ``release`` recycles a lane, dropping its pages from
    the iRT, the iRC and the device table in one batched pass.  The pools
    update in place."""

    def __init__(self, tcfg, *, path: str = "zero_copy", device=None):
        from repro_torch.serve.decode import make_tiered_decode_step
        from repro_torch.tiered import kvcache as tk
        self.cfg = tcfg
        self.device = resolve_device(device)
        self.state = tk.init_state(tcfg, self.device)
        self._step = make_tiered_decode_step(tcfg, path=path)
        self.steps = 0

    def step(self, q, k_new, v_new, pos):
        """One decode token per lane: q [B, KV, G, hd], k_new/v_new
        [B, KV, hd], ``pos`` a Python int or an int tensor on the
        server's device, scalar or [B] (< 0 idles a lane).  Returns
        [B, KV, G, hd]; nothing waits for the card."""
        out, self.state = self._step(self.state, q, k_new, v_new, pos)
        self.steps += 1
        return out

    def maintain(self):
        from repro_torch.serve import tiered as srv
        self.state = srv.maintain(self.cfg, self.state)

    def release(self, seq: int):
        from repro_torch.serve import tiered as srv
        self.state = srv.release(self.cfg, self.state, seq)

    @property
    def metrics(self) -> dict:
        """Canonical telemetry of the store (counters as exact ints, the
        ratio gauges as floats)."""
        from repro_torch.models.kv_backend import _host_num
        from repro_torch.serve import tiered as srv
        return {k: _host_num(v)
                for k, v in srv.metrics(self.cfg, self.state).items()}

    @property
    def counters(self) -> dict:
        """Legacy short-key counters, re-derived from the canonical view."""
        from repro_torch.obs.metrics import legacy_counters
        return legacy_counters(self.metrics)


def padded_len(ctx: int, max_len: int) -> int:
    """Prefill padding: the context pads to a power of two, clamped to the
    cache capacity."""
    return min(1 << (max(int(ctx), 1) - 1).bit_length(), max_len)


class Engine:
    """Greedy-decode serving engine over a fixed-width batch, on ``device``
    (the card unless the caller asks for the CPU; ``params`` must live
    there)."""

    def __init__(self, cfg: ArchConfig, params, ec: EngineConfig,
                 backend=None, scheduler=None, *, device=None):
        if cfg.family != "dense":
            raise NotImplementedError(
                f"Engine serves the dense decoder family; got "
                f"{cfg.family!r}")
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, the "
                             f"engine on {self.device}")
        self.cfg, self.params, self.ec = cfg, params, ec
        if backend is not None:
            self.backend = backend
        else:
            kw = {}
            if ec.backend == "tiered":
                kw = dict(page_tokens=ec.page_tokens,
                          fast_data_slots=ec.fast_data_slots)
                if ec.policy is not None:
                    from repro_torch.core.policy import get_policy
                    kw["policy"] = get_policy(ec.policy)
            self.backend = make_backend(cfg, ec.backend, ec.batch,
                                        ec.max_len, device=self.device, **kw)
        self._tiered = isinstance(self.backend, TieredBackend)
        self._maintain_tenants = None  # bound by a multi-tenant scheduler
        self._pending_plan = None
        self.maintain_overlaps = 0
        self.releases = 0
        self.steps = 0
        self._bw_log: list = []        # (promo, demo) pages per maintain
        from repro_torch.serve.sched import make_scheduler
        self.scheduler = scheduler if scheduler is not None \
            else make_scheduler(ec)
        self.scheduler.bind(self)

    def submit(self, req: Request):
        req.arrived = time.time()
        self.scheduler.submit(req)

    @property
    def queue(self):
        return self.scheduler.queue

    # -- primitives the scheduler calls -----------------------------------

    def _live_bucket(self, pos: np.ndarray) -> int | None:
        """The smallest power-of-two page prefix covering every lane's
        append position (None: bucketing off, dense backend, every lane
        parked, or the bucket spans the whole table)."""
        if not (self._tiered and self.ec.page_bucket):
            return None
        mx = int(pos.max())
        if mx < 0:
            return None
        tcfg = self.backend.tcfg
        need = mx // tcfg.page_tokens + 1
        bucket = 1 << (need - 1).bit_length()
        return None if bucket >= tcfg.max_pages_per_seq else bucket

    def _flush_maintain(self, state, *, overlapped: bool = False):
        """Apply a deferred maintenance plan, if one is pending (at the top
        of the next loop iteration, or before any release: every plan
        lands before the next metadata mutation)."""
        if self._pending_plan is None:
            return state
        state = self.backend.apply_maintain(state, self._pending_plan)
        self._pending_plan = None
        if overlapped:
            self.maintain_overlaps += 1
        self._log_bandwidth(state)
        return state

    def _log_bandwidth(self, state):
        L = self.backend.n_layers
        self._bw_log.append((int(state.caches.promo_pages) * L,
                             int(state.caches.demo_pages) * L))

    def release_lane(self, state, lane: int):
        """Recycle one lane's metadata (tiered; dense: the position mask
        hides stale rows).  A pending plan flushes first."""
        if self._tiered:
            state = self._flush_maintain(state)
            state = self.backend.release(state, lane)
            self.releases += 1
        return state

    def park_idle(self, state, idle):
        idle = torch.as_tensor(idle, device=self.device)
        return state._replace(pos=torch.where(idle, -1, state.pos))

    def set_pos(self, state, lane: int, pos: int):
        p = state.pos.clone()
        p[lane] = pos
        return state._replace(pos=p)

    def chunk_buffers(self, P: int):
        """Fresh chunked-prefill K/V buffers for a padded length P."""
        from repro_torch.models import init_chunk_buffers
        return init_chunk_buffers(self.cfg, P, device=self.device)

    def chunk_fwd(self, *, logits: bool = False) -> Callable:
        """The chunked-prefill forward (``serve.decode
        .make_chunk_prefill_fn``): (params, chunk_tokens [1, C], buf_k,
        buf_v, start) -> the buffers with rows [start, start+C) written in
        place, plus the chunk's logits [1, C, vocab] with ``logits``."""
        from repro_torch.serve.decode import make_chunk_prefill_fn
        return make_chunk_prefill_fn(self.cfg, logits=logits)

    def write_chunk(self, state, lane: int, bk, bv, start: int, C: int,
                    length: int):
        """Chunk ingest: rows [start, start+C) of the accumulated buffers
        through ``backend.write_prefill_chunk`` (tiered: routed page
        stores)."""
        return self.backend.write_prefill_chunk(
            state, lane, bk[:, 0, start:start + C], bv[:, 0, start:start + C],
            start, length)

    def admit_fast(self, state, lane: int, length: int, n_pages: int):
        """Direct-to-fast admission: promote the first ``n_pages`` prompt
        pages of ``lane`` into every layer's fast pool (tiered only)."""
        return self.backend.admit_prefix(state, lane, length, n_pages)

    def build_maintain_tenants(self, pols: tuple, quotas: tuple):
        """Bind the multi-tenant maintenance pass to a fixed tenant
        partition (called once by the QoS scheduler at bind)."""
        self._maintain_tenants = lambda s, lt: self.backend.maintain_tenants(
            s, lt, pols, quotas)

    def note_token(self, req: Request, tok: int, pos: int,
                   now: float | None = None):
        """Book one decoded token of ``req``; ``pos`` is its lane's
        position after the token.  The harvest loop books each decode
        step's tokens here, and the chunked scheduler the first token it
        takes off the final chunk's last prompt row."""
        now = time.time() if now is None else now
        if not req.tokens:
            req.first_token_at = now
        req.tokens.append(int(tok))
        req.token_times.append(now)
        if len(req.tokens) >= req.max_new or pos >= self.ec.max_len - 1:
            req.done = True
            req.done_at = now

    def prefill_lane(self, state, lane: int, req: Request):
        """One-shot prefill of ``req``'s prompt into ``lane``; returns
        (state, the token the first decode step consumes)."""
        prompt = np.asarray(req.prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        ctx = prompt[:-1]
        if ctx.size > self.ec.max_len - 1:
            raise ValueError(
                f"prompt ({prompt.size}) exceeds max_len ({self.ec.max_len})")
        if ctx.size == 0:
            pos = state.pos.clone()
            pos[lane] = 0
            return state._replace(pos=pos), int(prompt[-1])
        P = padded_len(int(ctx.size), self.ec.max_len)
        padded = np.zeros((1, P), np.int32)
        padded[0, :ctx.size] = ctx
        tokens = torch.as_tensor(padded, device=self.device)
        _, _, (k, v) = forward(self.cfg, self.params, {"tokens": tokens},
                               collect_cache=True)
        state = self.backend.write_prefill(state, lane, k[:, 0], v[:, 0],
                                           int(ctx.size))
        return state, int(prompt[-1])

    # -- decode loop ---------------------------------------------------------

    @torch.inference_mode()
    def run(self, log: Callable[[str], None] = lambda s: None
            ) -> list[Request]:
        ec = self.ec
        sched = self.scheduler
        lanes: list[Request | None] = [None] * ec.batch
        state = self.backend.init_state(ec.batch, ec.max_len)
        tokens = torch.zeros((ec.batch,), dtype=torch.int32,
                             device=self.device)
        finished: list[Request] = []
        self._bw_log = []
        self._pending_plan = None
        state, tokens = sched.refill(state, tokens, lanes, finished)
        while any(l is not None for l in lanes):
            state = self._flush_maintain(state, overlapped=True)
            n_pages = self._live_bucket(state.pos.cpu().numpy())
            logits, state = decode_step(self.cfg, self.params, state, tokens,
                                        backend=self.backend,
                                        n_pages=n_pages)
            tokens = torch.argmax(logits, dim=-1).to(torch.int32)
            self.steps += 1
            if self._tiered and self.steps % ec.maintain_every == 0:
                # the multi-tenant pass stays synchronous: the lane ->
                # tenant map can go stale across a deferral
                if ec.overlap_maintain and self._maintain_tenants is None:
                    self._pending_plan = self.backend.plan_maintain(state)
                else:
                    state = sched.maintain(state)
                    self._log_bandwidth(state)
            nxt = tokens.cpu().numpy()
            pos = state.pos.cpu().numpy()
            now = time.time()
            for i, r in enumerate(lanes):
                if r is None or r.done or not sched.is_decoding(i):
                    continue
                self.note_token(r, int(nxt[i]), int(pos[i]), now)
            if self.steps % 16 == 0:
                log(f"[engine] step {self.steps}, queue={len(self.queue)}, "
                    f"done={len(finished)}")
            state, tokens = sched.refill(state, tokens, lanes, finished)
        state = self._flush_maintain(state)   # a last hook may be open
        self.final_state = state
        return finished

    @property
    def counters(self) -> dict:
        """Tiered metadata/migration counters summed over layers (empty
        for the dense backend), plus per-maintain migration bandwidth
        series ``epoch_promo_bytes`` / ``epoch_demo_bytes``."""
        if not self._tiered or not hasattr(self, "final_state"):
            return {}
        out = self.backend.counters(self.final_state)
        if self._bw_log:
            pb = self.backend.tcfg.page_bytes
            promo = [p for p, _ in self._bw_log]
            demo = [d for _, d in self._bw_log]
            out["epoch_promo_bytes"] = [
                (b - a) * pb for a, b in zip([0] + promo[:-1], promo)]
            out["epoch_demo_bytes"] = [
                (b - a) * pb for a, b in zip([0] + demo[:-1], demo)]
        return out

    def request_stats(self, requests: list[Request]) -> dict:
        """Latency statistics of finished requests: aggregate and
        per-tenant percentiles (ms) of latency, time to first token and
        queue wait, a log2-bucketed histogram of inter-token gaps, and the
        scheduler's fairness counters (chunked scheduler)."""
        def _ms(xs):
            xs = np.asarray(sorted(xs), np.float64) * 1e3
            if not xs.size:
                return {}
            return dict(n=int(xs.size), mean=float(xs.mean()),
                        p50=float(np.percentile(xs, 50)),
                        p99=float(np.percentile(xs, 99)),
                        max=float(xs.max()))

        def _hist(gaps_ms):
            counts = [0] * obs_metrics.HIST_BUCKETS
            for g in gaps_ms:
                counts[obs_metrics.bucket_index(g)] += 1
            return dict(edges_ms=list(obs_metrics.HIST_EDGES_MS),
                        counts=counts)

        def _block(rs):
            gaps = []                       # one latency per decoded token
            for r in rs:
                ts = [r.admitted_at] + list(r.token_times)
                gaps += [1e3 * (b - a) for a, b in zip(ts, ts[1:])]
            return dict(
                latency_ms=_ms([r.latency for r in rs]),
                ttft_ms=_ms([r.ttft for r in rs]),
                queue_wait_ms=_ms([r.queue_wait for r in rs]),
                tokens=sum(len(r.tokens) for r in rs),
                token_latency_hist=_hist(gaps))

        out = {"aggregate": _block(requests)}
        tenants = sorted({r.tenant_id for r in requests})
        if len(tenants) > 1:
            out["tenants"] = {
                t: _block([r for r in requests if r.tenant_id == t])
                for t in tenants}
        book = getattr(self.scheduler, "book", None)
        if book is not None:
            out["fairness"] = book.fairness()
        return out
