"""Multi-tenant QoS (port of ``repro.serve.sched.qos``): tenant config,
fast-slot partitioning, fairness counters and starvation-bounded
weighted admission (DESIGN.md §9).

Each tenant brings a weight (its share of ``fast_data_slots`` and of
admission) and optionally its own ``core/policy`` preset (decider
thresholds and ``max_moves``; the hotness tracker is shared state).
Admission is weighted deficit round-robin with a hard starvation bound;
``TenantBook.metrics`` exports the books as labelled hub samples.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional, Union

from repro_torch.core.policy import PolicyConfig, get_policy
from repro_torch.obs.registry import MetricSpec, register

# canonical per-tenant fairness metrics (DESIGN.md §10; one sample per
# tenant, labelled {tenant="..."}: ``TenantBook.metrics`` exports them)
register(
    MetricSpec("engine_tenant_submitted_total", "counter",
               "requests submitted, per tenant"),
    MetricSpec("engine_tenant_admitted_total", "counter",
               "requests admitted to a lane, per tenant"),
    MetricSpec("engine_tenant_finished_total", "counter",
               "requests finished, per tenant"),
    MetricSpec("engine_tenant_tokens_total", "counter",
               "tokens decoded, per tenant"),
    MetricSpec("engine_tenant_max_skips", "gauge",
               "worst consecutive admission skips observed, per tenant "
               "(must stay <= the starvation bound)"),
)

_TENANT_METRIC_KEYS = {
    "submitted": "engine_tenant_submitted_total",
    "admitted": "engine_tenant_admitted_total",
    "finished": "engine_tenant_finished_total",
    "tokens": "engine_tenant_tokens_total",
    "max_skips": "engine_tenant_max_skips",
}


@dataclasses.dataclass(frozen=True)
class TenantConfig:
    """One tenant's QoS contract.

    weight       share of the fast-slot partition and of admission;
    policy       per-tenant policy preset name or PolicyConfig (None: the
                 engine's); its tracker kind must match the engine's;
    admit_pages  direct-to-fast pages at ingest.  None: the engine's
                 ``admit_pages`` iff this tenant's decider is "on_demand";
                 0 disables; > 0 forces.
    """

    name: str
    weight: int = 1
    policy: Union[PolicyConfig, str, None] = None
    admit_pages: Optional[int] = None

    def resolve_policy(self, default: PolicyConfig) -> PolicyConfig:
        if self.policy is None:
            return default
        return get_policy(self.policy)


def resolve_tenants(ec) -> tuple:
    """EngineConfig.tenants, defaulting to one catch-all tenant."""
    ts = tuple(ec.tenants or ())
    if not ts:
        ts = (TenantConfig("default"),)
    names = [t.name for t in ts]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate tenant names: {names}")
    if any(t.weight < 1 for t in ts):
        raise ValueError("tenant weights must be >= 1")
    return ts


def split_slots(total: int, tenants) -> tuple:
    """Partition ``total`` fast data slots across tenants by weight
    (largest remainder; every tenant at least 1 slot while slots allow).
    The quotas cap each tenant's residency in ``plan_tenants``."""
    wsum = sum(t.weight for t in tenants)
    raw = [total * t.weight / wsum for t in tenants]
    quotas = [int(r) for r in raw]
    rest = total - sum(quotas)
    order = sorted(range(len(tenants)), key=lambda i: raw[i] - quotas[i],
                   reverse=True)
    for i in order[:rest]:
        quotas[i] += 1
    for i in range(len(quotas)):       # floor of 1: steal from the largest
        if quotas[i] == 0 and max(quotas) > 1:
            quotas[quotas.index(max(quotas))] -= 1
            quotas[i] = 1
    return tuple(quotas)


class TenantBook:
    """Per-tenant queues, fairness counters and the starvation-bounded
    weighted admission picker."""

    def __init__(self, tenants, starvation_bound: int = 8):
        if starvation_bound < 1:
            raise ValueError("starvation_bound must be >= 1")
        self.tenants = tuple(tenants)
        self.bound = starvation_bound
        self.index = {t.name: i for i, t in enumerate(self.tenants)}
        self.queues = [deque() for _ in self.tenants]
        self.credit = [0] * len(self.tenants)
        self.skips = [0] * len(self.tenants)
        self.stats = [dict(submitted=0, admitted=0, finished=0, tokens=0,
                           chunks=0, admitted_fast_pages=0, max_skips=0)
                      for _ in self.tenants]

    def tenant_of(self, req) -> int:
        tid = getattr(req, "tenant_id", "default")
        if tid not in self.index:
            if len(self.tenants) == 1:
                return 0                     # single tenant: catch-all
            raise KeyError(
                f"request {req.rid}: unknown tenant {tid!r}; configured "
                f"tenants: {sorted(self.index)}")
        return self.index[tid]

    def submit(self, req) -> None:
        t = self.tenant_of(req)
        self.queues[t].append(req)
        self.stats[t]["submitted"] += 1

    @property
    def pending(self) -> int:
        return sum(len(q) for q in self.queues)

    def pick(self):
        """Pop the next request to admit, or None.  Every call credits
        each non-empty tenant its weight and picks the largest credit; a
        non-empty tenant skipped ``bound`` times in a row is picked
        first (earliest-arrived head among the starved)."""
        live = [t for t, q in enumerate(self.queues) if q]
        if not live:
            return None
        starved = [t for t in live if self.skips[t] >= self.bound]
        if starved:
            pick = min(starved, key=lambda t: self.queues[t][0].arrived)
        else:
            for t in live:
                self.credit[t] += self.tenants[t].weight
            pick = max(live, key=lambda t: (self.credit[t], -t))
            self.credit[pick] -= sum(self.tenants[t].weight for t in live)
        for t in live:
            if t == pick:
                self.skips[t] = 0
            else:
                self.skips[t] += 1
                self.stats[t]["max_skips"] = max(self.stats[t]["max_skips"],
                                                 self.skips[t])
        self.stats[pick]["admitted"] += 1
        return self.queues[pick].popleft()

    def finish(self, req) -> None:
        t = self.tenant_of(req)
        self.stats[t]["finished"] += 1
        self.stats[t]["tokens"] += len(req.tokens)

    def fairness(self) -> dict:
        """Per-tenant fairness counters (``Engine.request_stats``)."""
        return {t.name: dict(weight=t.weight, **s)
                for t, s in zip(self.tenants, self.stats)}

    def metrics(self) -> list:
        """Canonical per-tenant metric samples for the hub:
        ``(name, value, {"tenant": ...})`` triples (DESIGN.md §10)."""
        return [(canon, s[key], {"tenant": t.name})
                for t, s in zip(self.tenants, self.stats)
                for key, canon in _TENANT_METRIC_KEYS.items()]
