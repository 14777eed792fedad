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

Telemetry (``obs``, DESIGN.md §10, §12), each part off unless configured:
``EngineConfig.obs`` samples the engine books and the tiered counters
every ``sample_every`` steps into a ``MetricsHub`` (a sample clones a few
small counter tensors and reads nothing on the host; the drain moves
every sample to the host at once), traces the engine phases
(``StepTracer``), wraps the run in ``torch.profiler`` and serves the live
endpoints; ``EngineConfig.flight`` records every page move and release
into a ring on the device, read from the same descriptors the pass's
copy replay runs; ``EngineConfig.slos`` books each finished request's
latency against its tenant's targets.  With all three off the engine
launches exactly what it launches without them.  ``jax.jit`` state
donation has no counterpart: the pools update in place.

Compiled steps: where the reference jits a serving step, the port
captures it once per key as a CUDA graph and replays it (``serve.decode
.StepGraphs``): the engine's decode step per live-page bucket (its greedy
argmax inside), the maintenance plan, its apply and the synchronous
pass, the one-shot prefill per padded length P (the forward without the
unembedding, then the install), the chunk forward per (P, C, start, final
chunk) (the flash kernel takes ``start`` as a host ``q_offset``), the
chunk write per C, the admission per page count, the release, the
multi-tenant pass, the flight-recorded apply, admission and release, and
``TieredServer``'s step, maintenance and release.  A lane, length, chunk
start or flight step goes in as one of the engine's own 0-d int32 device
buffers, filled before the call (a Python int would be baked into the
graph at capture); prompt and chunk tokens go in through the engine's own
[1, n] buffers (from pinned host memory, without a wait), the chunk K/V
through its own work buffers per P (``_chunk_route``), the multi-tenant
pass's lane -> tenant map through its own [B] buffer, and the flight
ring is written in place.  The engine's state buffers outlive a run
(``run`` resets them in place), so each graph is captured at most once
per engine.  ``graphs=None`` captures on a card and runs eagerly on the
CPU, ``False`` runs eagerly everywhere (the counterpart of
``jax.disable_jit``).  Between the graphs stay the host reads (the
bucket, tokens and ``pos`` after a step, a final chunk's first token,
the copy flag after each pass and at the end of a run) and two small
eager steps, ``set_pos`` and ``park_idle`` (one to three ops each).
"""

from __future__ import annotations

import dataclasses
import functools
import time
import weakref
from typing import Callable

import numpy as np
import torch

from repro_torch._scatter import at
from repro_torch.configs.base import ArchConfig
from repro_torch.core.remap.irt import E, INVALID
from repro_torch.device import resolve_device
from repro_torch.models import decode_step, forward
from repro_torch.models.kv_backend import TieredBackend, make_backend
from repro_torch.obs import NULL_TRACER, MetricsHub, ObsConfig, StepTracer
from repro_torch.obs import flight as obs_flight
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.registry import MetricSpec, register
from repro_torch.obs.slo import SLOMonitor
from repro_torch.obs.trace import profiler_trace
from repro_torch.serve.decode import StepGraphs

# the serving engine's own books (DESIGN.md §10); the trimma_* families
# are declared by the modules that own them
register(
    MetricSpec("engine_steps_total", "counter",
               "decode steps executed"),
    MetricSpec("engine_tokens_total", "counter",
               "tokens harvested from decoding lanes"),
    MetricSpec("engine_finished_requests_total", "counter",
               "requests fully decoded"),
    MetricSpec("engine_releases_total", "counter",
               "lane metadata recycles (tiered release passes)"),
    MetricSpec("engine_maintain_overlap", "counter",
               "maintenance applies overlapped with the next decode step "
               "(double-buffered plan/apply split, DESIGN.md §11)"),
    MetricSpec("engine_queue_depth", "gauge",
               "requests waiting in the scheduler queue"),
    MetricSpec("engine_active_lanes", "gauge",
               "lanes holding a live request"),
    MetricSpec("engine_translated_pages_per_step", "gauge",
               "metadata-engine translations per decode step (live pages "
               "that missed the cached device table)"),
    MetricSpec("engine_request_latency_ms", "gauge",
               "request latency percentiles "
               '(labels: tenant, stat in latency|ttft|queue_wait, '
               "quantile)", unit="ms"),
    MetricSpec("engine_token_latency_ms", "histogram",
               "inter-token latency (log2 buckets from 0.25 ms)",
               unit="ms"),
)


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


def _weakly(method) -> Callable:
    """``method`` (a bound method) as a callable that does not keep its
    object alive: the obs server's callbacks would otherwise tie the
    engine into a cycle that only the cyclic collector frees."""
    ref = weakref.WeakMethod(method)

    def call(*args, **kw):
        return ref()(*args, **kw)
    return call


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
    obs: ObsConfig | None = None  # hub samples, Prometheus / JSONL / trace
                                  # files, profiler, live endpoints
    flight: obs_flight.FlightConfig | None = None  # page-lifecycle ring
                                  # (tiered only)
    slos: tuple = ()              # SLOConfig per target (obs/slo)


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
    update in place.  All three are captured CUDA graphs on a card
    (``graphs`` as ``Engine``'s; the released lane goes in as a device
    scalar)."""

    def __init__(self, tcfg, *, path: str = "zero_copy", device=None,
                 graphs: bool | None = None):
        from repro_torch.kernels.remap_gather.ops import new_flag
        from repro_torch.serve.decode import make_tiered_decode_step
        from repro_torch.tiered import kvcache as tk
        self.cfg = tcfg
        self.device = resolve_device(device)
        self.graphs = StepGraphs(self.device, graphs)
        self.state = self.graphs.bind(tk.init_state(tcfg, self.device))
        self._step = make_tiered_decode_step(tcfg, path=path)
        self._pos = self.graphs.own(torch.zeros(
            (tcfg.n_seqs,), dtype=torch.int32, device=self.device))
        self._lane = self.graphs.own(torch.zeros(
            (), dtype=torch.int32, device=self.device))
        self._copy_err = new_flag(self.device)
        self.steps = 0

    def step(self, q, k_new, v_new, pos):
        """One decode token per lane: q [B, KV, G, hd], k_new/v_new
        [B, KV, hd], ``pos`` a Python int or an int tensor on the
        server's device, scalar or [B] (< 0 idles a lane), copied into
        the step's [B] int32 buffer.  Returns [B, KV, G, hd], on a card
        the graph's output buffer, which the next step overwrites (clone
        it to keep it); nothing waits for the card."""
        if isinstance(pos, torch.Tensor):
            self._pos.copy_(pos.expand(self.cfg.n_seqs))
        else:
            self._pos.fill_(int(pos))
        out, self.state = self.graphs.run("step", self._step, self.state,
                                          q, k_new, v_new, self._pos)
        self.steps += 1
        return out

    def _pass(self, st):
        from repro_torch.serve import tiered as srv
        return None, srv.maintain(self.cfg, st, err=self._copy_err)

    def maintain(self):
        """One maintenance pass; raises ``IndexError`` if one of its page
        copies met an index outside its pool (one host read)."""
        from repro_torch.kernels.remap_gather.ops import check_flag
        _, self.state = self.graphs.run("maintain", self._pass, self.state)
        check_flag(self._copy_err)

    def _release_fn(self, st, seq):
        from repro_torch.serve import tiered as srv
        return None, srv.release(self.cfg, st, seq)

    def release(self, seq: int):
        """Recycle lane ``seq`` (its number goes in as the server's own
        device scalar, filled here)."""
        _, self.state = self.graphs.run("release", self._release_fn,
                                        self.state, self._lane.fill_(int(seq)))

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


_PREFILL_FAMILIES = ("dense", "moe")


def padded_len(ctx: int, max_len: int) -> int:
    """Prefill padding: the context pads to a power of two, clamped to the
    cache capacity."""
    return min(1 << (max(int(ctx), 1) - 1).bit_length(), max_len)


class Engine:
    """Greedy-decode serving engine over a fixed-width batch, on ``device``
    (the card unless the caller asks for the CPU; ``params`` must live
    there)."""

    def __init__(self, cfg: ArchConfig, params, ec: EngineConfig,
                 backend=None, scheduler=None, *, device=None,
                 graphs: bool | None = None):
        if cfg.family not in _PREFILL_FAMILIES:
            raise NotImplementedError(
                f"Engine prefill supports KV-cache families "
                f"{_PREFILL_FAMILIES}; got {cfg.family!r}")
        from repro_torch.models.transformer import _ring_cache_len
        if _ring_cache_len(cfg, ec.max_len) != ec.max_len:
            raise NotImplementedError(
                "Engine prefill writes prompt rows linearly and does not "
                "support the ring-buffer window cache "
                "(REPRO_WINDOW_CACHE=1)")
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
        # the compiled steps (module docstring): one runner, one graph pool
        self.graphs = StepGraphs(self.device, graphs)
        self._kept = None              # (state, tokens): every run's buffers
        self._copy_err = None          # the captured passes' copy flag
        if self._tiered:
            from repro_torch.kernels.remap_gather.ops import new_flag
            self._copy_err = new_flag(self.device)
        # the captured steps' scalar arguments (lane, prompt length, chunk
        # start, flight step): 0-d int32 buffers filled before each call
        self._lane_s, self._len_s, self._start_s, self._step_s = (
            self.graphs.own(torch.zeros((), dtype=torch.int32,
                                        device=self.device))
            for _ in range(4))
        self._tok_bufs: dict = {}      # width n -> [1, n] token buffer
        self._chunk_work: dict = {}    # P -> chunk K/V work buffers
        self._chunk_rows: dict = {}    # C -> a chunk's K/V rows [L, C, ...]
        self._chunk_holder: dict = {}  # P -> the ingest the work buffers hold
        self.chunk_copy_bytes = 0      # K/V bytes moved to switch ingests
        self._tenant_parts = None      # (pols, quotas) of a multi-tenant
                                       # scheduler's pass
        self._pass_tenant = None       # its lane -> tenant device buffer
        self._pending_plan = None      # (plan, the step it was made at)
        self.maintain_overlaps = 0
        self.releases = 0
        self.steps = 0
        self._bw_log: list = []        # (promo, demo) pages per maintain
        from repro_torch.serve.sched import make_scheduler
        self.scheduler = scheduler if scheduler is not None \
            else make_scheduler(ec)
        self.scheduler.bind(self)
        # telemetry: the hub and tracer only when configured; NULL_TRACER
        # keeps the loop's span sites free of work
        self.hub: MetricsHub | None = \
            MetricsHub(ec.obs) if ec.obs is not None else None
        self.tracer = StepTracer() \
            if ec.obs is not None and ec.obs.trace_path else NULL_TRACER
        self._pending_obs: list[dict] = []
        self._last_obs = None          # the newest drained sample
        self._lanes_ref: list = []     # the running loop's lanes
        self._tokens_out = 0           # tokens harvested (engine_tokens_total)
        # flight recorder: a ring on the device; tenant stamps come from a
        # lane -> tenant-index map kept on the host and mirrored on the
        # device, written only when a lane changes tenant
        self._fl_cfg = ec.flight \
            if (ec.flight is not None and self._tiered) else None
        self._fl = None
        self._flight_cache = None
        self._event_cols: dict = {}    # event batch sizes -> kind, cause
        self._tenant_idx: dict[str, int] = {}
        for t in ec.tenants:
            self._tenant_idx.setdefault(getattr(t, "name", str(t)),
                                        len(self._tenant_idx))
        if self._fl_cfg is not None:   # written in place by the graphs
            self._fl = {k: self.graphs.own(t) for k, t in obs_flight.init(
                self._fl_cfg.capacity, self.device).items()}
            self._lane_tenant_np = np.zeros((ec.batch,), np.int32)
            self._lane_tenant = self.graphs.own(torch.zeros(
                (ec.batch,), dtype=torch.int32, device=self.device))
        self.slo = SLOMonitor(ec.slos) if ec.slos else None
        self.obs_server = None
        if self.hub is not None and ec.obs.http_port is not None:
            from repro_torch.obs.http import ObsServer
            self.obs_server = ObsServer(
                metrics_fn=self.hub.to_prometheus,
                health_fn=_weakly(self._health),
                state_fn=_weakly(self.debug_state),
                host=ec.obs.http_host, port=ec.obs.http_port)
            # the server's thread outlives the engine unless closed with it
            weakref.finalize(self, self.obs_server.close)

    def submit(self, req: Request):
        req.arrived = time.time()
        self.scheduler.submit(req)

    @property
    def queue(self):
        return self.scheduler.queue

    @property
    def active_bucket(self):
        """The greedy scheduler's wave anchor (None for schedulers
        without straggler bucketing)."""
        return getattr(self.scheduler, "active_bucket", None)

    # -- the compiled steps (captured once, replayed) ----------------------

    def _decode_step(self, state, tokens, n_pages: int | None):
        """The full-model decode step of live-page bucket ``n_pages``, its
        greedy token written into ``tokens`` in place."""
        logits, state = decode_step(self.cfg, self.params, state, tokens,
                                    backend=self.backend, n_pages=n_pages)
        tokens.copy_(torch.argmax(logits, dim=-1))
        return (logits, tokens), state

    def _decode(self, state, tokens, n_pages: int | None):
        """One decode step -> (logits, next tokens, state): one graph per
        live-page bucket, as the reference jits one step per bucket.  The
        returned tokens are the step's token buffer, which the scheduler
        writes in place and the next step reads."""
        (logits, tokens), state = self.graphs.run(
            ("decode", n_pages),
            lambda st, tok: self._decode_step(st, tok, n_pages), state,
            tokens)
        return logits, tokens, state

    def _plan_fn(self, state):
        return self.backend.plan_maintain(state), state

    def _apply_fn(self, state, plan):
        return None, self.backend.apply_maintain(state, plan,
                                                 err=self._copy_err)

    def _pass_fn(self, state):
        return None, self.backend.maintain(state, err=self._copy_err)

    def _plan(self, state):
        """Score and plan a maintenance pass (a graph): the plan's tensors
        are the graph's outputs, applied before its next replay."""
        return self.graphs.run("plan", self._plan_fn, state)[0]

    def _apply(self, state, plan):
        """Apply a plan (a graph); its copies set ``_copy_err``, which
        ``_log_bandwidth`` reads."""
        return self.graphs.run("apply", self._apply_fn, state, plan)[1]

    def _maintain(self, state):
        """One synchronous maintenance pass (a graph; the schedulers'
        single-tenant pass)."""
        return self.graphs.run("maintain", self._pass_fn, state)[1]

    def _tenant_pass(self, state, lane_tenant: np.ndarray):
        """The multi-tenant maintenance pass (a graph) over the scheduler's
        lane -> tenant map ``lane_tenant`` [B] (< 0: idle), mirrored into
        the engine's own device buffer one write per lane that changed."""
        for i in np.flatnonzero(lane_tenant != self._pass_tenant_np):
            self._pass_tenant[int(i)] = int(lane_tenant[i])
            self._pass_tenant_np[i] = lane_tenant[i]
        return self.graphs.run("maintain_tenants", self._maintain_tenants,
                               state, self._pass_tenant)[1]

    def _prefill_fn(self, state, tokens, lane, length):
        """One-shot prefill of padded ``tokens`` [1, P]: the forward without
        the unembedding (its logits are never read), then the backend
        installs the K/V into ``lane`` and sets its ``pos``."""
        _, _, (k, v) = forward(self.cfg, self.params, {"tokens": tokens},
                               collect_cache=True, return_logits=False)
        return None, self.backend.write_prefill(state, lane, k[:, 0],
                                                v[:, 0], length)

    def _chunk_fn(self, state, tokens, bk, bv, rk, rv, *, start: int,
                  logits: bool):
        """One chunk forward (``serve.decode.make_chunk_prefill_fn``) over
        the work buffers ``bk``/``bv``; the chunk's K/V rows are copied
        into ``rk``/``rv`` [L, C, KV, hd] for the write."""
        from repro_torch.serve.decode import make_chunk_prefill_fn
        out = make_chunk_prefill_fn(self.cfg, logits=logits)(
            self.params, tokens, bk, bv, start)
        C = tokens.shape[1]
        rk.copy_(bk[:, 0, start:start + C])
        rv.copy_(bv[:, 0, start:start + C])
        return (out[2] if logits else None), state

    def _write_chunk_fn(self, state, rk, rv, lane, start, length):
        return None, self.backend.write_prefill_chunk(state, lane, rk, rv,
                                                      start, length)

    def _admit_fn(self, state, lane, length, *, n_pages: int):
        return None, self.backend.admit_prefix(state, lane, length, n_pages,
                                               err=self._copy_err)

    def _release_fn(self, state, lane):
        return None, self.backend.release(state, lane)

    def _release(self, state, lane: int):
        """Recycle one lane's tiered metadata (a graph); flight-recorded,
        one RELEASE event per page the lane still holds comes first."""
        lane_s = self._scalar(self._lane_s, lane)
        if self._fl is None:
            return self.graphs.run("release", self._release_fn, state,
                                   lane_s)[1]
        self._refresh_lane_tenants(self._lanes_ref)
        return self.graphs.run("release_rec", self._rec_release_fn, state,
                               lane_s, self._scalar(self._step_s,
                                                    self.steps))[1]

    @staticmethod
    def _scalar(buf, value) -> torch.Tensor:
        """``buf``, one of the engine's 0-d int32 arguments, filled with
        ``value``: a fill on the card, no copy from the host."""
        return buf.fill_(int(value))

    def _stage(self, values: np.ndarray) -> torch.Tensor:
        """int32 ``values`` [n] in the engine's own [1, n] token buffer,
        copied from pinned host memory on a card (nothing waits)."""
        n = values.shape[0]
        buf = self._tok_bufs.get(n)
        if buf is None:
            buf = self._tok_bufs[n] = self.graphs.own(torch.zeros(
                (1, n), dtype=torch.int32, device=self.device))
        src = torch.from_numpy(np.ascontiguousarray(values, np.int32))
        if buf.is_cuda:
            src = src.pin_memory()
        return buf.copy_(src.view(1, n), non_blocking=buf.is_cuda)

    def _reset_state(self):
        """The (state, tokens) buffers every run reuses, reset in place to
        a fresh ``init_state`` and zero tokens (made on the first run,
        then bound as the graphs' static buffers)."""
        ec = self.ec
        fresh = self.backend.init_state(ec.batch, ec.max_len)
        if self._kept is None:             # the copy flag is fresh too
            self._kept = (self.graphs.bind(fresh), self.graphs.own(
                torch.zeros((ec.batch,), dtype=torch.int32,
                            device=self.device)))
            return self._kept
        self.graphs.bind(fresh)
        self._kept[1].zero_()
        if self._copy_err is not None:
            self._copy_err.zero_()
        return self._kept

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

    # -- flight recorder ------------------------------------------------------

    def _record(self, batches, step, touch) -> None:
        """Append event batches ``(kind, cause, pages, enable)`` to the
        ring in order, as ONE ``record`` written into the ring in place:
        lanes from the pages, tenants from the device lane map, ``step``
        an int or a 0-d device tensor, ``score`` the tracker hotness in
        ``touch`` (read before the moves)."""
        key = tuple((k, c, p.numel()) for k, c, p, _ in batches)
        if key not in self._event_cols:
            self._event_cols[key] = tuple(torch.cat([
                torch.full((n,), (k, c)[j], dtype=torch.int32,
                           device=self.device) for k, c, n in key])
                for j in (0, 1))
        kind, cause = self._event_cols[key]
        pages = torch.cat([p.reshape(-1) for _, _, p, _ in batches])
        en = torch.cat([e.reshape(-1) for _, _, _, e in batches])
        lane = pages // self.backend.tcfg.max_pages_per_seq
        self._ring_write(obs_flight.record(
            self._fl, kind, pages, en, step=step, lane=lane,
            tenant=at(self._lane_tenant, lane), cause=cause,
            score=at(touch, pages)))

    def _ring_write(self, fl: dict) -> None:
        """The ring's new tensors copied into its own buffers."""
        for k, t in fl.items():
            self._fl[k].copy_(t)

    def _rec_apply(self, state, plan, step: int):
        """Apply a maintenance plan and record its moves (a graph): events
        stamp ``step``, the step the plan was MADE at, filled into the
        step scalar before the call, so an overlapped apply records the
        same stream as a synchronous one."""
        return self.graphs.run("apply_rec", self._rec_apply_fn, state, plan,
                               self._scalar(self._step_s, step))[1]

    def _rec_apply_fn(self, state, plan, step):
        """Apply a maintenance plan through the descriptor-returning pass
        and record one event per ACTUAL move: demotes, FIFO-victim
        evicts, promotes, forced metadata evicts, in that order;
        ``score`` is the page's hotness read before the apply."""
        touch = state.caches.touch     # metadata is functional: stays put
        state, ddesc, pdesc = self.backend.apply_maintain_desc(
            state, plan, err=self._copy_err)
        self._record([
            (obs_flight.K_DEMOTE, obs_flight.C_PLAN_DEMOTE, ddesc["cb1_dst"],
             ddesc["cb1_en"]),
            (obs_flight.K_EVICT, obs_flight.C_VICTIM, pdesc["cb1_dst"],
             pdesc["cb1_en"]),
            (obs_flight.K_PROMOTE, obs_flight.C_PLAN_PROMOTE,
             pdesc["in_src"], pdesc["in_en"]),
            (obs_flight.K_EVICT, obs_flight.C_FORCED, pdesc["cb2_dst"],
             pdesc["cb2_en"])], step, touch)
        return None, state

    def _rec_release_fn(self, state, lane, step):
        """One RELEASE event per page ``lane`` (a 0-d device tensor) still
        holds under Trimma metadata, its tenant read from the device lane
        map, then the release itself."""
        caches = state.caches
        mpp = self.backend.tcfg.max_pages_per_seq
        ids = lane * mpp + torch.arange(mpp, dtype=torch.int32,
                                        device=self.device)
        held = at(caches.leaf_table, ids) != INVALID
        self._ring_write(obs_flight.record(
            self._fl, obs_flight.K_RELEASE, ids, held, step=step,
            lane=lane, tenant=at(self._lane_tenant, lane),
            cause=obs_flight.C_RECYCLE, score=at(caches.touch, ids)))
        return None, self.backend.release(state, lane)

    def _rec_admit_fn(self, state, lane, length, step, *, n_pages: int):
        """A flight-recorded admission: each actual install and each
        eviction it forced records an event (victim evicts, installs,
        forced evicts)."""
        touch = state.caches.touch
        state, pdesc = self.backend.admit_prefix_desc(
            state, lane, length, n_pages, err=self._copy_err)
        self._record([
            (obs_flight.K_EVICT, obs_flight.C_VICTIM, pdesc["cb1_dst"],
             pdesc["cb1_en"]),
            (obs_flight.K_INSTALL, obs_flight.C_ADMIT, pdesc["in_src"],
             pdesc["in_en"]),
            (obs_flight.K_EVICT, obs_flight.C_FORCED, pdesc["cb2_dst"],
             pdesc["cb2_en"])], step, touch)
        return None, state

    def _refresh_lane_tenants(self, lanes) -> None:
        """Update the lane -> tenant-index map from the live lane
        assignments (the device copy takes one write per change).  A
        freed lane keeps its LAST tenant, which its release event
        stamps."""
        if self._fl is None:
            return
        for i, r in enumerate(lanes):
            if r is not None:
                idx = self._tenant_idx.setdefault(r.tenant_id,
                                                  len(self._tenant_idx))
                if self._lane_tenant_np[i] != idx:
                    self._lane_tenant_np[i] = idx
                    self._lane_tenant[i] = idx

    @property
    def _tenant_names(self) -> list[str]:
        return [t for t, _ in sorted(self._tenant_idx.items(),
                                     key=lambda kv: kv[1])]

    def flight_stats(self) -> dict | None:
        """Drain the flight ring and derive its analytics (residency and
        reuse-distance histograms, ping-pong churn, per-tenant counts,
        ``obs.flight.analyze``).  None when the recorder is off; cached
        until the ring next grows."""
        if self._fl is None:
            return None
        fl = self._fl
        head = int(fl["head"])
        cached = self._flight_cache
        if cached is not None and cached[0] == head:
            return cached[1]
        stats = obs_flight.analyze(
            obs_flight.drain(fl), pingpong_steps=self._fl_cfg.pingpong_steps,
            tenant_names=self._tenant_names or ["default"])
        self._flight_cache = (head, stats)
        return stats

    # -- maintenance and lane lifecycle -----------------------------------

    def _flush_maintain(self, state, *, overlapped: bool = False):
        """Apply a deferred maintenance plan, if one is pending (at the top
        of the next loop iteration, or before any release: every plan
        lands before the next metadata mutation)."""
        if self._pending_plan is None:
            return state
        plan, plan_step = self._pending_plan
        with self.tracer.span("maintain_apply", step=self.steps):
            if self._fl is not None:
                state = self._rec_apply(state, plan, plan_step)
            else:
                state = self._apply(state, plan)
        self._pending_plan = None
        if overlapped:
            self.maintain_overlaps += 1
        self._log_bandwidth(state)
        return state

    def _log_bandwidth(self, state):
        """Book the pass's page counts and read the captured passes' copy
        flag, in one host read after every pass; a copy that met an index
        outside its pool raises ``IndexError`` here."""
        L = self.backend.n_layers
        c = state.caches
        promo, demo, bad = torch.stack(
            [c.promo_pages, c.demo_pages, self._copy_err[0]]).tolist()
        if bad:
            raise IndexError("remap_gather: an index lay outside its pool")
        self._bw_log.append((promo * L, demo * L))

    def _maintain_hook(self, state):
        """The maintenance hook after every ``maintain_every``-th step.
        Double-buffered by default: plan now, apply before the next step
        (the plan carries its hook step, which the deferred apply's
        flight events stamp).  The multi-tenant pass stays synchronous
        (the lane -> tenant map can go stale across a deferral) and is
        not flight-recorded: its plan has no single-descriptor pass."""
        tenants = self._tenant_parts is not None
        if self.ec.overlap_maintain and not tenants:
            with self.tracer.span("maintain", step=self.steps, phase="plan"):
                self._pending_plan = (self._plan(state), self.steps)
            return state
        with self.tracer.span("maintain", step=self.steps):
            if self._fl is not None and not tenants:
                state = self._rec_apply(state, self._plan(state), self.steps)
            else:
                state = self.scheduler.maintain(state)
        self._log_bandwidth(state)
        return state

    def release_lane(self, state, lane: int):
        """Recycle one lane's metadata (tiered; dense: the position mask
        hides stale rows).  A pending plan flushes first."""
        if self._tiered:
            state = self._flush_maintain(state)
            with self.tracer.span("release", lane=lane):
                state = self._release(state, lane)
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

    def _chunk_route(self, ing, start: int):
        """The engine's own chunk K/V work buffers of ``ing``'s padded
        length P (the chunk graphs' static inputs), holding ``ing``'s rows
        below ``start``.  One ingest at a time holds them: a switch parks
        the holder's rows in its own buffers (``buf_k``/``buf_v``, made
        at its first park) and brings the next ingest's back, the only
        K/V copies of the routing (``chunk_copy_bytes``)."""
        P = ing.P
        work = self._chunk_work.get(P)
        if work is None:
            work = self._chunk_work[P] = tuple(
                map(self.graphs.own, self.chunk_buffers(P)))
        held = self._chunk_holder.get(P)
        if held is not ing:
            if held is not None and held.start > 0:
                if held.buf_k is None:
                    held.buf_k, held.buf_v = self.chunk_buffers(P)
                self._copy_rows((held.buf_k, held.buf_v), work, held.start)
            if start > 0:
                self._copy_rows(work, (ing.buf_k, ing.buf_v), start)
            self._chunk_holder[P] = ing
        return work

    def _copy_rows(self, dst, src, n: int) -> None:
        for d, s in zip(dst, src):
            d[:, :, :n].copy_(s[:, :, :n])
            self.chunk_copy_bytes += d[:, :, :n].numel() * d.element_size()

    def chunk_forward(self, state, ing, start: int, C: int, final: bool):
        """One chunk of the chunked scheduler's ingest ``ing`` (its padded
        prompt ``ctx``, length P, parked buffers): the forward of rows
        [start, start + C) against the rows before them, a graph per (P,
        C, start, final) over the engine's work buffers (``_chunk_route``).
        Returns (state, the chunk's logits [1, C, vocab] when ``final``,
        the graph's buffer, else None)."""
        bk, bv = self._chunk_route(ing, start)
        rows = self._chunk_rows.get(C)
        if rows is None:
            L, _, _, KV, hd = bk.shape
            rows = self._chunk_rows[C] = tuple(
                self.graphs.own(bk.new_zeros((L, C, KV, hd)))
                for _ in range(2))
        logits, state = self.graphs.run(
            ("chunk", ing.P, C, start, final),
            functools.partial(self._chunk_fn, start=start, logits=final),
            state, self._stage(ing.ctx[start:start + C]), bk, bv, *rows)
        if final:
            self._chunk_holder.pop(ing.P, None)
        return state, logits

    def write_chunk(self, state, lane: int, start: int, C: int,
                    length: int):
        """Chunk ingest: the K/V rows of the last ``chunk_forward`` of
        width C through ``backend.write_prefill_chunk`` (tiered: routed
        page stores), a graph per C."""
        with self.tracer.span("prefill_chunk", lane=lane, start=start,
                              tokens=C):
            return self.graphs.run(
                ("write_chunk", C), self._write_chunk_fn, state,
                *self._chunk_rows[C], self._scalar(self._lane_s, lane),
                self._scalar(self._start_s, start),
                self._scalar(self._len_s, length))[1]

    def admit_fast(self, state, lane: int, length: int, n_pages: int):
        """Direct-to-fast admission: promote the first ``n_pages`` prompt
        pages of ``lane`` into every layer's fast pool (tiered only; a
        graph per ``n_pages``, flight-recorded or not)."""
        args = (self._scalar(self._lane_s, lane),
                self._scalar(self._len_s, length))
        with self.tracer.span("admit_fast", lane=lane, pages=n_pages):
            if self._fl is None:
                return self.graphs.run(
                    ("admit", n_pages),
                    functools.partial(self._admit_fn, n_pages=n_pages),
                    state, *args)[1]
            self._refresh_lane_tenants(self._lanes_ref)
            return self.graphs.run(
                ("admit_rec", n_pages),
                functools.partial(self._rec_admit_fn, n_pages=n_pages),
                state, *args, self._scalar(self._step_s, self.steps))[1]

    def build_maintain_tenants(self, pols: tuple, quotas: tuple):
        """Bind the multi-tenant maintenance pass to a fixed tenant
        partition (called once by the QoS scheduler at bind), with its
        lane -> tenant device buffer."""
        self._tenant_parts = (pols, quotas)
        self._pass_tenant = self.graphs.own(torch.full(
            (self.ec.batch,), -1, dtype=torch.int32, device=self.device))
        self._pass_tenant_np = np.full((self.ec.batch,), -1, np.int32)

    def _maintain_tenants(self, state, lane_tenant):
        """The multi-tenant pass over ``build_maintain_tenants``'s
        partition, as a step: (None, state)."""
        pols, quotas = self._tenant_parts
        return None, self.backend.maintain_tenants(
            state, lane_tenant, pols, quotas, err=self._copy_err)

    def _health(self) -> dict:
        return {"steps": self.steps, "tokens": self._tokens_out}

    def note_token(self, req: Request, tok: int, pos: int,
                   now: float | None = None):
        """Book one decoded token of ``req``; ``pos`` is its lane's
        position after the token.  The harvest loop books each decode
        step's tokens here, and the chunked scheduler the first token it
        takes off the final chunk's last prompt row.  A finished request
        is booked against its tenant's SLOs."""
        now = time.time() if now is None else now
        if not req.tokens:
            req.first_token_at = now
        req.tokens.append(int(tok))
        req.token_times.append(now)
        self._tokens_out += 1
        if len(req.tokens) >= req.max_new or pos >= self.ec.max_len - 1:
            req.done = True
            req.done_at = now
            if self.slo is not None:
                self.slo.observe(req.tenant_id, latency_ms=1e3 * req.latency,
                                 ttft_ms=1e3 * req.ttft)

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
        padded = np.zeros((P,), np.int32)
        padded[:ctx.size] = ctx
        with self.tracer.span("prefill", lane=lane, rid=req.rid,
                              tokens=int(ctx.size), padded=P):
            state = self.graphs.run(
                ("prefill", P), self._prefill_fn, state, self._stage(padded),
                self._scalar(self._lane_s, lane),
                self._scalar(self._len_s, ctx.size))[1]
        return state, int(prompt[-1])

    # -- decode loop ---------------------------------------------------------

    @torch.inference_mode()
    def run(self, log: Callable[[str], None] = lambda s: None
            ) -> list[Request]:
        ec = self.ec
        sched = self.scheduler
        obs, tracer = ec.obs, self.tracer
        lanes: list[Request | None] = [None] * ec.batch
        self._lanes_ref = lanes
        state, tokens = self._reset_state()
        finished: list[Request] = []
        self._bw_log = []
        self._pending_plan = None
        tracer.clear()             # one saved trace == one run
        self._pending_obs = []
        self._chunk_holder = {}
        self.chunk_copy_bytes = 0
        if self._fl_cfg is not None:   # fresh ring: one ring == one run
            for t in self._fl.values():
                t.zero_()
            self._flight_cache = None
            self._lane_tenant_np[:] = 0
            self._lane_tenant.zero_()
        with profiler_trace(obs.profiler_dir if obs else None):
            state, tokens = sched.refill(state, tokens, lanes, finished)
            while any(l is not None for l in lanes):
                self._refresh_lane_tenants(lanes)
                state = self._flush_maintain(state, overlapped=True)
                n_pages = self._live_bucket(state.pos.cpu().numpy())
                with tracer.span("decode_step", step=self.steps):
                    _, tokens, state = self._decode(state, tokens, n_pages)
                self.steps += 1
                if self._tiered and self.steps % ec.maintain_every == 0:
                    state = self._maintain_hook(state)
                nxt = tokens.cpu().numpy()
                pos = state.pos.cpu().numpy()
                now = time.time()
                for i, r in enumerate(lanes):
                    if r is None or r.done or not sched.is_decoding(i):
                        continue
                    self.note_token(r, int(nxt[i]), int(pos[i]), now)
                if self.hub is not None \
                        and self.steps % obs.sample_every == 0:
                    self._sample(state, lanes, len(finished))
                if self.steps % 16 == 0:
                    log(f"[engine] step {self.steps}, "
                        f"queue={len(self.queue)}, done={len(finished)}")
                state, tokens = sched.refill(state, tokens, lanes, finished)
            state = self._flush_maintain(state)   # a last hook may be open
            if self._copy_err is not None:   # admissions since the last pass
                from repro_torch.kernels.remap_gather.ops import check_flag
                check_flag(self._copy_err)
        self.final_state = state
        if self.hub is not None:
            self._finalize_obs(state, lanes, finished)
        return finished

    # -- telemetry --------------------------------------------------------

    def _sample(self, state, lanes, n_finished: int) -> None:
        """One periodic sample point (every ``obs.sample_every`` steps):
        the engine books as host ints and a ``tap_stash`` of the tiered
        counters (device copies; nothing is read on the host).
        ``_drain_samples`` turns the series into hub rows at drain."""
        active = sum(1 for l in lanes if l is not None)
        self._pending_obs.append(dict(
            step=self.steps, ts=time.time(), ts_us=self.tracer.now_us(),
            queue=len(self.queue), active=active,
            tokens=self._tokens_out, finished=n_finished,
            releases=self.releases, overlaps=self.maintain_overlaps,
            tap=obs_metrics.tap_stash(state.caches)
            if self._tiered else None))
        if self.obs_server is not None:
            # live endpoints: publish the host books now so a mid-run
            # scrape sees them (absolute values: the drain's replay lands
            # on the same numbers); the tiered series waits for the drain
            self.hub.record({
                "engine_steps_total": self.steps,
                "engine_tokens_total": self._tokens_out,
                "engine_finished_requests_total": n_finished,
                "engine_releases_total": self.releases,
                "engine_maintain_overlap": self.maintain_overlaps})
            self.hub.set("engine_queue_depth", len(self.queue))
            self.hub.set("engine_active_lanes", active)

    def _drain_samples(self) -> None:
        """Replay the stashed sample points into the hub, in order: every
        stash goes to the host in one transfer (``stashed_metrics``), then
        each point becomes a hub row and a trace counter event stamped at
        its observed time."""
        hub, pend = self.hub, self._pending_obs
        self._pending_obs = []
        if pend:
            self._last_obs = pend[-1]
        series: dict = {}
        if pend and pend[0]["tap"] is not None:
            tcfg = self.backend.tcfg
            series = obs_metrics.stashed_metrics(
                [p["tap"] for p in pend], tcfg.page_bytes,
                n_logical=tcfg.n_logical, fast_slots=tcfg.fast_slots,
                leaf_entries=E, copies=self.backend.n_layers)
        for i, p in enumerate(pend):
            hub.record({
                "engine_steps_total": p["step"],
                "engine_tokens_total": p["tokens"],
                "engine_finished_requests_total": p["finished"],
                "engine_releases_total": p["releases"],
                "engine_maintain_overlap": p["overlaps"],
            })
            hub.set("engine_queue_depth", p["queue"])
            hub.set("engine_active_lanes", p["active"])
            if series:
                m = {k: float(v[i]) for k, v in series.items()}
                hub.record(m)
                hub.set("engine_translated_pages_per_step",
                        m["trimma_translated_pages_total"]
                        / max(p["step"], 1))
                self.tracer.counter("trimma_pages", {
                    "fast_resident": m["trimma_fast_resident_pages"],
                    "metadata": m["trimma_metadata_pages"]},
                    ts=p["ts_us"])
            hub.sample(step=p["step"], ts=p["ts"])

    def _finalize_obs(self, state, lanes, finished) -> None:
        """Drain-time export: the sample series, request-latency
        percentiles as labelled gauges, the token-latency histogram, the
        tenant books, SLO burn rates and flight analytics, then the
        Prometheus exposition and the trace file."""
        hub = self.hub
        self._sample(state, lanes, len(finished))   # final sample point
        self._drain_samples()
        stats = self.request_stats(finished)
        blocks = {"all": stats["aggregate"], **stats.get("tenants", {})}
        for tenant, block in blocks.items():
            for stat in ("latency_ms", "ttft_ms", "queue_wait_ms"):
                for q, v in block.get(stat, {}).items():
                    if q == "n":
                        continue
                    hub.set("engine_request_latency_ms", v,
                            labels={"tenant": tenant, "stat": stat[:-3],
                                    "quantile": q})
        h = stats["aggregate"]["token_latency_hist"]
        gaps = []
        for r in finished:
            ts = [r.admitted_at] + list(r.token_times)
            gaps += [1e3 * (b - a) for a, b in zip(ts, ts[1:])]
        hub.observe_hist("engine_token_latency_ms", h["edges_ms"],
                         h["counts"], sum(gaps))
        book = getattr(self.scheduler, "book", None)
        if book is not None:
            for name, value, labels in book.metrics():
                hub.set(name, value, labels=labels)
        if self.slo is not None:
            self.slo.export(hub)
        fs = self.flight_stats()
        if fs is not None:
            obs_flight.export(hub, fs)
        hub.finalize(step=self.steps)
        if self.ec.obs.trace_path and self.tracer is not NULL_TRACER:
            self.tracer.save(self.ec.obs.trace_path)

    def debug_state(self) -> dict:
        """Live JSON-able snapshot for ``/debug/state`` (obs/http): the
        engine books, per-lane assignments, tenant fairness, fast-pool
        occupancy from the newest sample's cloned tap (counts over the
        layers, as the hub's), the flight analytics and the SLO summary.
        Called from the HTTP thread: reads host books, the cloned tap and
        the ring, never the live state or the pools."""
        lanes = self._lanes_ref
        out: dict = {
            "steps": self.steps,
            "tokens_out": self._tokens_out,
            "releases": self.releases,
            "maintain_overlaps": self.maintain_overlaps,
            "queue_depth": len(self.queue),
            "lanes": [None if r is None else
                      {"rid": r.rid, "tenant": r.tenant_id,
                       "tokens": len(r.tokens), "max_new": r.max_new,
                       "done": r.done}
                      for r in lanes],
        }
        book = getattr(self.scheduler, "book", None)
        if book is not None:
            out["tenants"] = book.fairness()
        pend = self._pending_obs
        last = pend[-1] if pend else self._last_obs
        if last is not None and last.get("tap") is not None:
            L = self.backend.n_layers
            owner = last["tap"]["slot_owner"].cpu()
            leaf = last["tap"]["leaf_cnt"].cpu()
            out["fast_pool"] = {
                "sampled_step": last["step"],
                "resident_pages": int((owner != INVALID).sum()) * L,
                "slots": owner.numel() * L,
                "metadata_pages": int((leaf > 0).sum()) * L,
            }
        fs = self.flight_stats()
        if fs is not None:
            out["flight"] = fs
        if self.slo is not None:
            out["slo"] = self.slo.summary()
        return out

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
