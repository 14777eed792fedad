"""Metric registry (port of ``repro.obs.registry``): one namespace for
every counter the repo exports (DESIGN.md §10).

Trimma's argument is quantitative — remap-cache hit rates, iRT walk
depth, migration bandwidth — so the counters that tell the story must
carry one canonical name from the in-graph state that accumulates them
all the way to the Prometheus exposition and the JSONL time series.
Each subsystem *declares its own metrics next to the code that owns
them* (``core/remap/rcache.py`` registers the iRC family,
``core/policy/scheduler.py`` the migration family, ``serve/engine.py``
the engine family, ...); this module only holds the spec type, the
shared registry, and the canonical-name maps the taps in
``obs.metrics`` use.

Naming rules (Prometheus conventions):
  * ``trimma_*``  — metadata-engine metrics (iRC / iRT / device table /
    migration), summed over layers when the store is stacked;
  * ``engine_*``  — serving-engine metrics (steps, tokens, queue depth,
    request latency);
  * ``sim_*``     — trace-simulator counters (the Figure 7/8 books);
  * counters end in ``_total`` (or ``_bytes_total``); gauges do not;
  * histograms expose ``_bucket``/``_sum``/``_count`` series.

Pure Python — safe to import from any layer.
"""

from __future__ import annotations

import dataclasses

KINDS = ("counter", "gauge", "histogram")


@dataclasses.dataclass(frozen=True)
class MetricSpec:
    """One named metric: its kind, help string and (optional) unit."""

    name: str
    kind: str = "counter"
    help: str = ""
    unit: str = ""

    def __post_init__(self):
        assert self.kind in KINDS, f"bad metric kind {self.kind!r}"


_REGISTRY: dict[str, MetricSpec] = {}


def register(*specs: MetricSpec) -> None:
    """Declare metrics.  Idempotent for identical re-declarations;
    conflicting re-declarations (same name, different spec) are a
    programming error."""
    for s in specs:
        old = _REGISTRY.get(s.name)
        if old is not None and old != s:
            raise ValueError(
                f"metric {s.name!r} already registered with a different "
                f"spec: {old} vs {s}")
        _REGISTRY[s.name] = s


def spec(name: str) -> MetricSpec:
    """Spec for ``name``; unregistered names resolve to an inferred
    fallback (``*_total`` -> counter, else gauge) so ad-hoc exports
    still render."""
    s = _REGISTRY.get(name)
    if s is None:
        kind = "counter" if name.endswith("_total") else "gauge"
        s = MetricSpec(name, kind, help="(unregistered)")
    return s


def registered() -> dict[str, MetricSpec]:
    """Snapshot of the registry (insertion-ordered)."""
    return dict(_REGISTRY)


# ---------------------------------------------------------------------------
# canonical-name maps
# ---------------------------------------------------------------------------

# TieredState counter field -> canonical metric name.  ``obs.metrics
# .tiered_metrics`` reads the fields through this map (plus a few derived
# entries it computes itself); the legacy ``counters`` dicts the tests and
# examples consume are re-derived from the canonical view (LEGACY_TIERED).
TIERED_FIELDS = {
    "lookups": "trimma_translated_pages_total",
    "irc_hits": "trimma_irc_hits_total",
    "irc_id_hits": "trimma_irc_id_hits_total",
    "dev_hits": "trimma_dev_table_hits_total",
    "migrations": "trimma_migrations_total",
    "demotions": "trimma_demotions_total",
    "forced_evict": "trimma_forced_evictions_total",
}

# legacy short key (TieredServer.counters / TieredBackend.counters) ->
# canonical name; kept stable so downstream consumers don't churn
LEGACY_TIERED = {
    "lookups": "trimma_translated_pages_total",
    "dev_hits": "trimma_dev_table_hits_total",
    "irc_hits": "trimma_irc_hits_total",
    "migrations": "trimma_migrations_total",
    "demotions": "trimma_demotions_total",
    "forced_evict": "trimma_forced_evictions_total",
    "promo_bytes": "trimma_promoted_bytes_total",
    "demo_bytes": "trimma_demoted_bytes_total",
}

# simulator counter key (core/simulator.COUNTERS order matters: the golden
# JSON and run()'s output dict use exactly these keys) -> canonical name
SIM_COUNTERS = {
    "n_acc": "sim_accesses_total",
    "rc_hit": "sim_rc_hits_total",
    "rc_id_hit": "sim_rc_id_hits_total",
    "rc_nid_hit": "sim_rc_nid_hits_total",
    "rc_incons": "sim_rc_inconsistencies_total",
    "serve_fast": "sim_served_fast_total",
    "installs": "sim_installs_total",
    "swaps": "sim_swaps_total",
    "forced_evict": "sim_forced_evictions_total",
    "writebacks": "sim_writebacks_total",
    "walks": "sim_irt_walks_total",
    "deallocs": "sim_deallocs_total",
    "cyc_sram": "sim_cycles_sram_total",
    "cyc_meta": "sim_cycles_meta_total",
    "cyc_fast": "sim_cycles_fast_total",
    "cyc_slow": "sim_cycles_slow_total",
    "by_fast": "sim_bytes_fast_total",
    "by_slow_rd": "sim_bytes_slow_read_total",
    "by_slow_wr": "sim_bytes_slow_write_total",
}


def sim_counter_keys() -> list[str]:
    """The simulator's in-state counter keys, in declaration order (the
    golden-counter contract: ``core/simulator.COUNTERS`` is this list)."""
    return list(SIM_COUNTERS)


def sim_export(counters: dict) -> dict:
    """Simulator counters dict -> canonical-namespace dict (only the keys
    present; derived metrics like rates stay with ``derive_metrics``)."""
    return {SIM_COUNTERS[k]: v for k, v in counters.items()
            if k in SIM_COUNTERS}


register(
    MetricSpec("sim_accesses_total", "counter",
               "trace accesses simulated"),
    MetricSpec("sim_rc_hits_total", "counter",
               "remap-cache hits (conventional or iRC)"),
    MetricSpec("sim_rc_id_hits_total", "counter",
               "iRC IdCache (identity sector-vector) hits"),
    MetricSpec("sim_rc_nid_hits_total", "counter",
               "iRC NonIdCache hits"),
    MetricSpec("sim_rc_inconsistencies_total", "counter",
               "remap-cache hits whose value disagreed with the table "
               "(must stay 0 — the invalidation invariant)"),
    MetricSpec("sim_served_fast_total", "counter",
               "accesses served from the fast tier"),
    MetricSpec("sim_installs_total", "counter",
               "cache-mode installs (block copies into the fast tier)"),
    MetricSpec("sim_swaps_total", "counter",
               "flat-mode slow-swap migrations"),
    MetricSpec("sim_forced_evictions_total", "counter",
               "metadata-priority evictions (Section 3.3)"),
    MetricSpec("sim_writebacks_total", "counter",
               "dirty writebacks to the slow tier"),
    MetricSpec("sim_irt_walks_total", "counter",
               "remap-table walks (remap-cache misses)"),
    MetricSpec("sim_deallocs_total", "counter",
               "OS dealloc hints consumed (Section 3.5)"),
    MetricSpec("sim_cycles_sram_total", "counter",
               "cycles in SRAM metadata probes", unit="cycles"),
    MetricSpec("sim_cycles_meta_total", "counter",
               "cycles in fast-tier metadata walks", unit="cycles"),
    MetricSpec("sim_cycles_fast_total", "counter",
               "cycles in fast-tier data accesses", unit="cycles"),
    MetricSpec("sim_cycles_slow_total", "counter",
               "cycles in slow-tier data accesses", unit="cycles"),
    MetricSpec("sim_bytes_fast_total", "counter",
               "fast-tier bytes moved", unit="bytes"),
    MetricSpec("sim_bytes_slow_read_total", "counter",
               "slow-tier bytes read", unit="bytes"),
    MetricSpec("sim_bytes_slow_write_total", "counter",
               "slow-tier bytes written", unit="bytes"),
)
