"""Per-tenant SLO targets with rolling-window burn rate (port of
``repro.obs.slo``, DESIGN.md §12).

An SLO here is "``objective`` of requests meet ``target_ms`` on
``stat``" (end-to-end latency or TTFT).  The monitor consumes the same
per-request completion stamps the engine already books into its
``TenantBook`` percentiles, keeps a rolling window of the last
``window`` finished requests per (SLO, tenant), and reports the SRE
burn rate:

    burn = (violating fraction of the window) / (1 - objective)

burn == 1.0 means the error budget is being consumed exactly as fast
as the objective allows; > 1 means the tenant is burning budget faster
than sustainable (the launcher prints BURNING, ``engine_slo_burn_rate``
carries it per tenant, and ``/debug/state`` snapshots the summary).

Host-side and pure Python; the engine calls
``observe`` once per completed request.
"""

from __future__ import annotations

import dataclasses
from collections import deque

from .registry import MetricSpec, register

register(
    MetricSpec("engine_slo_target_ms", "gauge",
               "SLO latency target (labels: tenant, stat)", unit="ms"),
    MetricSpec("engine_slo_objective", "gauge",
               "SLO objective: fraction of requests that must meet the "
               "target (labels: tenant, stat)"),
    MetricSpec("engine_slo_window_requests", "gauge",
               "finished requests in the SLO rolling window "
               "(labels: tenant, stat)"),
    MetricSpec("engine_slo_violations_total", "counter",
               "requests over the SLO target since start "
               "(labels: tenant, stat)"),
    MetricSpec("engine_slo_burn_rate", "gauge",
               "rolling-window error-budget burn rate: violating "
               "fraction / (1 - objective); > 1 == burning faster than "
               "the objective sustains (labels: tenant, stat)"),
)

_STATS = ("latency", "ttft")


@dataclasses.dataclass(frozen=True)
class SLOConfig:
    """One target: ``tenant`` names a QoS tenant ("*" applies to every
    tenant, tracked separately per actual tenant); ``stat`` picks the
    request stat; ``objective`` is the fraction of requests that must
    meet ``target_ms`` over the rolling ``window``."""

    tenant: str = "*"
    stat: str = "latency"          # "latency" | "ttft"
    target_ms: float = 1000.0
    objective: float = 0.9
    window: int = 64

    def __post_init__(self):
        assert self.stat in _STATS, f"bad SLO stat {self.stat!r}"
        assert 0.0 < self.objective < 1.0, self.objective
        assert self.window >= 1, self.window


def parse_slos(text: str | None) -> tuple[SLOConfig, ...]:
    """CLI spec -> SLOConfigs: comma-separated
    ``tenant:stat:target_ms[:objective[:window]]`` entries, e.g.
    ``interactive:latency:250:0.9,*:ttft:500``."""
    if not text:
        return ()
    out = []
    for part in text.split(","):
        bits = part.strip().split(":")
        if len(bits) < 3:
            raise ValueError(
                f"bad SLO spec {part!r} "
                "(want tenant:stat:target_ms[:objective[:window]])")
        kw = dict(tenant=bits[0], stat=bits[1], target_ms=float(bits[2]))
        if len(bits) > 3:
            kw["objective"] = float(bits[3])
        if len(bits) > 4:
            kw["window"] = int(bits[4])
        out.append(SLOConfig(**kw))
    return tuple(out)


class SLOMonitor:
    """Rolling-window burn-rate tracker over a set of SLOConfigs."""

    def __init__(self, slos):
        self.slos = tuple(slos)
        self._win: dict[tuple, deque] = {}    # (slo_idx, tenant) -> bools
        self._viol: dict[tuple, int] = {}     # lifetime violation counts

    def observe(self, tenant: str, *, latency_ms: float,
                ttft_ms: float) -> None:
        """Book one finished request into every SLO that matches its
        tenant."""
        vals = {"latency": latency_ms, "ttft": ttft_ms}
        for i, s in enumerate(self.slos):
            if s.tenant not in ("*", tenant):
                continue
            key = (i, tenant)
            win = self._win.get(key)
            if win is None:
                win = self._win[key] = deque(maxlen=s.window)
            bad = vals[s.stat] > s.target_ms
            win.append(bad)
            if bad:
                self._viol[key] = self._viol.get(key, 0) + 1

    def summary(self) -> list[dict]:
        """One row per (SLO, tenant) seen so far: window occupancy,
        violation counts, burn rate and the sustainable-budget verdict."""
        rows = []
        for (i, tenant), win in sorted(self._win.items()):
            s = self.slos[i]
            n = len(win)
            bad = sum(win)
            burn = (bad / n) / max(1.0 - s.objective, 1e-9) if n else 0.0
            rows.append(dict(
                tenant=tenant, stat=s.stat, target_ms=s.target_ms,
                objective=s.objective, window=s.window, window_n=n,
                window_violations=bad,
                violations_total=self._viol.get((i, tenant), 0),
                burn_rate=burn, ok=burn <= 1.0))
        return rows

    def metrics(self):
        """Yield ``(name, value, labels)`` triples for the hub — the
        same shape ``TenantBook.metrics`` uses."""
        for row in self.summary():
            labels = {"tenant": row["tenant"], "stat": row["stat"]}
            yield "engine_slo_target_ms", row["target_ms"], labels
            yield "engine_slo_objective", row["objective"], labels
            yield "engine_slo_window_requests", row["window_n"], labels
            yield ("engine_slo_violations_total",
                   row["violations_total"], labels)
            yield "engine_slo_burn_rate", row["burn_rate"], labels

    def export(self, hub) -> None:
        for name, value, labels in self.metrics():
            hub.set(name, value, labels=labels)
