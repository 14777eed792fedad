"""serve/sched: continuous-batching request scheduling (port of
``repro.serve.sched``).

  GreedyScheduler   wave refill with one-shot prefill, straggler
                    bucketing, one tenant (the default);
  ChunkedScheduler  chunked prefill (page-aligned prompt chunks, one per
                    engine step, equal to one-shot prefill), multi-tenant
                    QoS admission (weighted deficit round-robin with a
                    starvation bound, per-tenant fast-slot quotas and
                    move budgets) and direct-to-fast admission at ingest.
"""

from .base import Scheduler, make_scheduler
from .chunked import ChunkedScheduler
from .greedy import GreedyScheduler
from .qos import TenantBook, TenantConfig, resolve_tenants, split_slots

__all__ = [
    "ChunkedScheduler", "GreedyScheduler", "Scheduler", "TenantBook",
    "TenantConfig", "make_scheduler", "resolve_tenants", "split_slots",
]
