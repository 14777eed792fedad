"""ChunkedScheduler: chunked prefill, multi-tenant QoS admission and
direct-to-fast ingest (port of ``repro.serve.sched.chunked``; the same
decisions, so the same token streams; DESIGN.md §9).

Chunked prefill: a prompt ingests in page-aligned chunks of at most
``EngineConfig.prefill_chunk`` tokens, ONE chunk per engine step,
interleaved with the other lanes' decode steps.  Each chunk forward
(``models.forward_chunk``) scores against the padded key length the
one-shot forward uses, so the ingested K/V and every logit decoded from
it equal one-shot prefill.  The ingesting lane stays parked at pos = -1
until its last chunk lands; each chunk is written through the backend as
it is produced (tiered: each page to its current tier).

QoS: requests carry ``tenant_id``; admission is the ``TenantBook``'s
starvation-bounded weighted deficit round-robin, the fast-slot pool is
partitioned per tenant (``split_slots``), and maintenance runs per-tenant
move budgets (``plan_tenants`` through the backend's
``maintain_tenants``).

Direct-to-fast: for a tenant whose policy decider is "on_demand" (or
whose ``admit_pages`` forces it) the prompt's first pages are admitted
straight into the fast pool at ingest (``admit_pages``).
"""

from __future__ import annotations

import dataclasses
import time
import weakref

import numpy as np
import torch

from .qos import TenantBook, resolve_tenants, split_slots


@dataclasses.dataclass
class _Ingest:
    """One lane's in-flight chunked prompt ingest."""
    req: object
    ctx: np.ndarray            # [P] int32 padded FULL prompt (the last
                               # token ingests too: the final chunk's
                               # logits give the first generated token)
    length: int                # real prompt tokens
    P: int                     # padded (power-of-two) buffer length
    start: int = 0             # next chunk's first position
    buf_k: object = None       # [L, 1, P, KV, hd] chunk K/V rows parked
    buf_v: object = None       # while another ingest holds the engine's
                               # work buffers (``Engine._chunk_route``)


class ChunkedScheduler:
    kind = "chunked"

    def __init__(self, ec):
        self.ec = ec
        self.tenants = resolve_tenants(ec)
        self.book = TenantBook(self.tenants, ec.starvation_bound)
        self.ingests: dict[int, _Ingest] = {}
        self.lane_tenant = np.full((ec.batch,), -1, np.int32)
        self._admitted = np.zeros((ec.batch,), np.int32)  # live admitted
        self._rr = 0                                      # pages per lane
        self.eng = None

    # -- binding ----------------------------------------------------------

    def bind(self, engine) -> None:
        # a proxy, as ``GreedyScheduler.bind`` keeps: no engine cycle
        self.eng = weakref.proxy(engine)
        ec = self.ec
        self.chunk = int(ec.prefill_chunk)
        if engine._tiered:
            tcfg = engine.backend.tcfg
            if self.chunk > 0:
                if tcfg.page_tokens & (tcfg.page_tokens - 1):
                    raise ValueError(
                        "chunked prefill on the tiered backend needs "
                        f"power-of-two page_tokens (got {tcfg.page_tokens}): "
                        "chunk starts must stay page-aligned inside the "
                        "power-of-two padded buffer")
                # chunks cover whole pages (each page row is one store)
                self.chunk = max(tcfg.page_tokens,
                                 self.chunk // tcfg.page_tokens
                                 * tcfg.page_tokens)
            base = tcfg.pol
            self.pols = tuple(t.resolve_policy(base) for t in self.tenants)
            for t, p in zip(self.tenants, self.pols):
                if p.tracker != base.tracker:
                    raise ValueError(
                        f"tenant {t.name!r}: tracker {p.tracker!r} differs "
                        f"from the store's {base.tracker!r}: tracker state "
                        "is shared; tenants may vary deciders, thresholds "
                        "and budgets only")
            self.quotas = split_slots(tcfg.fast_data_slots, self.tenants)
            if len(self.tenants) > 1:
                engine.build_maintain_tenants(self.pols, self.quotas)
        else:
            self.pols = tuple(t.resolve_policy(None) if t.policy is not None
                              else None for t in self.tenants)
            self.quotas = (0,) * len(self.tenants)

    # -- queue ------------------------------------------------------------

    def submit(self, req) -> None:
        self.book.submit(req)

    @property
    def pending(self) -> int:
        return self.book.pending

    @property
    def queue(self) -> tuple:
        """Snapshot of every queued request."""
        return tuple(r for q in self.book.queues for r in q)

    def is_decoding(self, lane: int) -> bool:
        return lane not in self.ingests

    # -- admission helpers ------------------------------------------------

    def _admit_fast_pages(self, lane: int, tenant: int, length: int) -> int:
        """How many of this prompt's first pages to admit straight into
        the fast pool: the tenant's ``admit_pages`` if set, else the
        engine's cap iff the tenant's decider is on-demand; always capped
        at the tenant's remaining quota (its quota minus the pages it
        admitted on still-live lanes)."""
        if not self.eng._tiered or length <= 0:
            return 0
        t = self.tenants[tenant]
        if t.admit_pages is not None:
            n = t.admit_pages
        else:
            pol = self.pols[tenant] or self.eng.backend.tcfg.pol
            n = self.ec.admit_pages if pol.decider == "on_demand" else 0
        if n <= 0:
            return 0
        pt = self.eng.backend.tcfg.page_tokens
        outstanding = int(self._admitted[self.lane_tenant == tenant].sum())
        room = max(0, self.quotas[tenant] - outstanding)
        return min(n, -(-length // pt), room)

    def _note_admit(self, lane: int, tenant: int, pages: int) -> None:
        self._admitted[lane] = pages
        self.book.stats[tenant]["admitted_fast_pages"] += pages

    def _admit(self, state, tokens, lane: int, req):
        """Assign ``req`` to ``lane``: one-shot prefill when chunking is
        off, the prompt is one token, or its padded length exceeds
        ``CHUNKED_THRESHOLD``; else start a chunked ingest (the lane
        parks until its last chunk lands)."""
        from repro_torch.models.attention import CHUNKED_THRESHOLD
        from repro_torch.serve.engine import padded_len
        eng, ec = self.eng, self.ec
        t = self.book.tenant_of(req)
        req.admitted_at = time.time()
        self.lane_tenant[lane] = t
        prompt = np.asarray(req.prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        ctx = prompt[:-1]
        if ctx.size > ec.max_len - 1:
            raise ValueError(
                f"prompt ({prompt.size}) exceeds max_len ({ec.max_len})")
        # the FULL prompt ingests (last token included): the final
        # chunk's logits give the first generated token
        P = padded_len(int(prompt.size), ec.max_len)
        admit = self._admit_fast_pages(lane, t, int(prompt.size))
        if self.chunk <= 0 or ctx.size == 0 or P > CHUNKED_THRESHOLD:
            # admission runs AFTER the one-shot install, whose writes
            # assume identity mapping
            state, tok = eng.prefill_lane(state, lane, req)
            tokens[lane] = tok
            if admit:
                state = eng.admit_fast(state, lane, int(ctx.size), admit)
                self._note_admit(lane, t, admit)
            return state, tokens
        padded = np.zeros((P,), np.int32)
        padded[:prompt.size] = prompt
        self.ingests[lane] = _Ingest(req=req, ctx=padded,
                                     length=int(prompt.size), P=P)
        if admit:
            # BEFORE the chunk writes: they route to the fast copies
            state = eng.admit_fast(state, lane, int(prompt.size), admit)
            self._note_admit(lane, t, admit)
        return state, tokens

    def _advance(self, state, tokens, lane: int):
        """One chunk of ``lane``'s ingest: the chunk forward against the
        accumulated rows, the chunk written through the backend, and on
        the final chunk the lane un-parked with the request's first token
        taken off the chunk's logits (a host read between the graphs)."""
        eng = self.eng
        ing = self.ingests[lane]
        C = min(self.chunk, ing.P)
        # back-align a final chunk that would overhang the buffer: the
        # overlapped rows recompute and re-write the same values
        start = min(ing.start, ing.P - C)
        final = start + C >= ing.length
        state, logits = eng.chunk_forward(state, ing, start, C, final)
        state = eng.write_chunk(state, lane, start, C, ing.length)
        ing.start = start + C
        self.book.stats[self.book.tenant_of(ing.req)]["chunks"] += 1
        if final:
            del self.ingests[lane]
            state = eng.set_pos(state, lane, ing.length)
            tok1 = int(torch.argmax(logits[0, ing.length - 1 - start]))
            tokens[lane] = tok1
            eng.note_token(ing.req, tok1, ing.length)
        return state, tokens

    # -- the per-step pass ------------------------------------------------

    def refill(self, state, tokens, lanes, finished):
        eng, ec = self.eng, self.ec
        # 1. recycle finished lanes
        for i in range(ec.batch):
            r = lanes[i]
            if r is not None and r.done:
                finished.append(r)
                self.book.finish(r)
                lanes[i] = None
                self.lane_tenant[i] = -1
                self._admitted[i] = 0
                state = eng.release_lane(state, i)
        # 2. chunk budget: advance ONE in-flight ingest by one chunk,
        #    round-robin across ingesting lanes
        live = sorted(self.ingests)
        if live:
            lane = live[self._rr % len(live)]
            self._rr += 1
            state, tokens = self._advance(state, tokens, lane)
        # 3. admit queued requests to free lanes (QoS picker)
        for i in range(ec.batch):
            if lanes[i] is not None:
                continue
            req = self.book.pick()
            if req is None:
                break
            lanes[i] = req
            state, tokens = self._admit(state, tokens, i, req)
        # 4. park empty and still-ingesting lanes
        idle = np.array([lanes[i] is None or i in self.ingests
                         for i in range(ec.batch)])
        if idle.any():
            state = eng.park_idle(state, idle)
        return state, tokens

    def maintain(self, state):
        if not self.eng._tiered:
            return state
        if len(self.tenants) == 1:
            return self.eng._maintain(state)
        return self.eng._tenant_pass(state, self.lane_tenant)
