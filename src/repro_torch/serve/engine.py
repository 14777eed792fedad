"""Serving drivers (port of ``repro.serve.engine``): ``TieredServer``, the
single-store decode driver, and the batched greedy-decode ``Engine`` with
``EngineConfig``, ``Request`` and ``padded_len``.

Continuous batching over a fixed-width batch: finished lanes release
their tiered metadata and refill from the queue with a one-shot prefill;
idle lanes sit at pos = -1; with ``backend="tiered"`` every decode step is
the fused path (``begin_step`` -> one kernel per layer -> ``end_step``)
over the live-page bucket, and a migration-scheduler pass runs every
``maintain_every`` steps, double-buffered (``overlap_maintain``: plan at
the hook, apply before the next step, flushed before any release).

Left out of the port so far: the observability hub, tracer, flight
recorder, SLO monitor and HTTP endpoints, and the chunked and QoS
schedulers.  ``jax.jit`` state donation has no counterpart: the pools
update in place.
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


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # [S] int32
    max_new: int
    arrived: float = 0.0          # enqueue time (stamped by submit)
    admitted_at: float = 0.0      # lane assignment time
    first_token_at: float = 0.0   # first decoded token
    done_at: float = 0.0          # wall time the last token was decoded
    tokens: list = dataclasses.field(default_factory=list)
    done: bool = False


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
    scheduler: str = "greedy"


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
                if ec.overlap_maintain:
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
                if not r.tokens:
                    r.first_token_at = now
                r.tokens.append(int(nxt[i]))
                if len(r.tokens) >= r.max_new \
                        or int(pos[i]) >= ec.max_len - 1:
                    r.done = True
                    r.done_at = now
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
