"""GreedyScheduler: wave refill with one-shot prefill, straggler bucketing
anchored to the first request of a wave, single tenant (port of
``repro.serve.sched.greedy``; same decisions, so the same token streams)."""

from __future__ import annotations

import time
import weakref
from collections import deque

import numpy as np


class GreedyScheduler:
    kind = "greedy"

    def __init__(self, ec):
        self.ec = ec
        self.queue: deque = deque()
        self.active_bucket: int | None = None
        self.eng = None

    def bind(self, engine) -> None:
        # a proxy: the engine holds its scheduler, and a strong reference
        # back would leave the engine to the cyclic collector
        self.eng = weakref.proxy(engine)

    def submit(self, req) -> None:
        self.queue.append(req)

    @property
    def pending(self) -> int:
        return len(self.queue)

    def is_decoding(self, lane: int) -> bool:
        return True                      # one-shot prefill: a filled lane
                                         # decodes from its first step

    def _pick(self, bucket_len: int | None):
        """Prefer a request whose target length lands in the active bucket
        (straggler mitigation)."""
        if not self.queue:
            return None
        if bucket_len is None:
            return self.queue.popleft()
        for i, r in enumerate(self.queue):
            if abs(r.max_new - bucket_len) <= self.ec.bucket:
                del self.queue[i]
                return r
        return self.queue.popleft()

    def refill(self, state, tokens, lanes, finished):
        """Recycle finished lanes (release their pages), fill empty lanes
        from the queue (one-shot prefill), park still-empty lanes at
        pos = -1.  ``tokens`` updates in place."""
        eng, ec = self.eng, self.ec
        for i in range(ec.batch):
            r = lanes[i]
            if r is not None and r.done:
                finished.append(r)
                lanes[i] = None
                state = eng.release_lane(state, i)
            if lanes[i] is None:
                req = self._pick(self.active_bucket)
                if req is None:
                    continue
                if self.active_bucket is None:
                    self.active_bucket = req.max_new
                lanes[i] = req
                req.admitted_at = time.time()
                state, tok = eng.prefill_lane(state, i, req)
                tokens[i] = tok
        idle = np.array([l is None for l in lanes])
        if idle.any():
            state = eng.park_idle(state, idle)
        if idle.all() and not self.queue:
            self.active_bucket = None       # the wave drained: re-anchor
        return state, tokens

    def maintain(self, state):
        return self.eng._maintain(state)
