"""Telemetry (port of ``repro.obs``, DESIGN.md §10, §12).

  ``obs.registry``  metric specs — every subsystem declares its metrics
                    next to the code that owns them;
  ``obs.metrics``   in-graph metrics ops and the taps that read the
                    tiered store's counters under canonical names;
  ``obs.hub``       host-side MetricsHub — snapshot/delta samples,
                    JSONL time series, Prometheus text exposition;
  ``obs.trace``     structured step tracer — Chrome-trace-event JSON
                    spans per engine phase, plus ``torch.profiler`` hooks;
  ``obs.flight``    page-lifecycle flight recorder — a bounded event ring
                    on the device, drained host-side into residency /
                    reuse-distance / ping-pong analytics;
  ``obs.slo``       per-tenant SLO targets with rolling-window burn
                    rates (``engine_slo_*``);
  ``obs.http``      live ``/metrics`` + ``/healthz`` + ``/debug/state``
                    endpoints over a running engine.
"""

from . import flight, metrics, registry, slo, trace  # noqa: F401
from .flight import FlightConfig  # noqa: F401
from .hub import (MetricsHub, ObsConfig, parse_labels,  # noqa: F401
                  parse_prometheus)
from .registry import MetricSpec, register  # noqa: F401
from .slo import SLOConfig, SLOMonitor, parse_slos  # noqa: F401
from .trace import NULL_TRACER, StepTracer  # noqa: F401
