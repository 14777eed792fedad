"""MetricsHub: the host-side metrics sink (port of ``repro.obs.hub``,
DESIGN.md §10).

The in-graph counters (``obs.metrics`` taps) accumulate monotonically on
device; the hub owns the host-side view: periodic *samples* with
snapshot/delta semantics, a JSONL time series, and the Prometheus text
exposition written at drain.

Snapshot/delta rules (the contract tests pin):
  * ``record`` overwrites the current value of a metric (counters are
    monotonic totals — the caller hands the hub the *absolute* in-graph
    value, never a delta);
  * ``sample`` freezes the current values into a row (ts, step, values,
    and per-counter deltas vs the previous sample), appends it to the
    series and — when configured — buffers it for the JSONL file
    (flushed incrementally and at ``finalize``);
  * gauges carry no delta; histograms export cumulative buckets.

Pure Python: the hub consumes plain Python numbers (callers read their
taps' tensors to the host first), so it is importable from launchers and
benchmark harnesses without touching the device.
"""

from __future__ import annotations

import dataclasses
import json
import re
import time
from typing import Optional

from . import registry


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """Observability wiring for one engine/launcher run.

    ``sample_every``  engine steps between metric samples (the engine
                      stashes device copies of the small counter tensors
                      per sample, a few launches and no host read, and
                      defers the transfer, the derived metrics and all
                      I/O to drain);
    ``prom_path``     Prometheus text exposition, written at drain;
    ``jsonl_path``    metrics time series, one JSON object per sample;
    ``trace_path``    Chrome trace events (Perfetto-loadable), written
                      at drain;
    ``profiler_dir``  optional ``torch.profiler`` trace directory wrapped
                      around the whole run (a Chrome trace with the
                      kernels' device spans);
    ``http_port``     when set, the engine serves ``/metrics`` /
                      ``/healthz`` / ``/debug/state`` live on this port
                      for the whole run (``obs.http.ObsServer``; 0 =
                      ephemeral, read back from ``engine.obs_server``).
    """

    sample_every: int = 4
    prom_path: Optional[str] = None
    jsonl_path: Optional[str] = None
    trace_path: Optional[str] = None
    profiler_dir: Optional[str] = None
    http_port: Optional[int] = None
    http_host: str = "127.0.0.1"


def _labels_key(labels: Optional[dict]) -> tuple:
    return tuple(sorted(labels.items())) if labels else ()


def _escape_label(v) -> str:
    """Exposition-format label-value escaping (the format's three escape
    sequences: backslash, double-quote, newline)."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _unescape_label(v: str) -> str:
    out, i = [], 0
    while i < len(v):
        c = v[i]
        if c == "\\" and i + 1 < len(v):
            nxt = v[i + 1]
            out.append({"\\": "\\", '"': '"', "n": "\n"}.get(nxt,
                                                             c + nxt))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _render_name(name: str, lk: tuple) -> str:
    if not lk:
        return name
    inner = ",".join(f'{k}="{_escape_label(v)}"' for k, v in lk)
    return f"{name}{{{inner}}}"


#: one label: name="value" with escaped backslash/quote/newline inside
_LABEL_RE = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')
#: one sample key: metric name + optional {label,...} block
_KEY_RE = re.compile(r"^([A-Za-z_:][A-Za-z0-9_:]*)(?:\{(.*)\})?$")


def parse_labels(key: str) -> tuple[str, dict]:
    """Rendered sample key -> ``(metric_name, labels_dict)`` — the
    inverse of ``_render_name`` (escape-aware, so values containing
    quotes, backslashes or newlines round-trip)."""
    m = _KEY_RE.match(key)
    assert m, f"bad sample key: {key!r}"
    name, inner = m.group(1), m.group(2)
    if not inner:
        return name, {}
    labels = {k: _unescape_label(v)
              for k, v in _LABEL_RE.findall(inner)}
    return name, labels


class MetricsHub:
    """Accumulates metric values host-side; exports Prometheus + JSONL."""

    #: JSONL rows buffered before an incremental flush (bounds both the
    #: per-sample file I/O and the memory a long run can pin)
    FLUSH_EVERY = 64

    def __init__(self, cfg: ObsConfig | None = None):
        self.cfg = cfg or ObsConfig()
        self._values: dict[tuple, float] = {}    # (name, labels) -> value
        self._hists: dict[tuple, dict] = {}      # (name, labels) -> h
        self._prev: dict[tuple, float] = {}
        self.series: list[dict] = []
        self._jsonl_buf: list[str] = []
        self._t0 = time.time()
        if self.cfg.jsonl_path:                  # truncate per run
            open(self.cfg.jsonl_path, "w").close()

    # -- recording --------------------------------------------------------

    def record(self, values: dict, labels: Optional[dict] = None) -> None:
        """Set the current absolute value of each metric in ``values``."""
        lk = _labels_key(labels)
        for name, v in values.items():
            self._values[(name, lk)] = float(v)

    def set(self, name: str, value, labels: Optional[dict] = None) -> None:
        self._values[(name, _labels_key(labels))] = float(value)

    def observe_hist(self, name: str, edges_ms, counts, total_ms: float,
                     labels: Optional[dict] = None) -> None:
        """Set a histogram's cumulative state: per-bucket counts (len ==
        len(edges) + 1, last bucket is +Inf) plus the sum of observations."""
        assert len(counts) == len(edges_ms) + 1, (len(counts), len(edges_ms))
        self._hists[(name, _labels_key(labels))] = dict(
            edges=list(edges_ms), counts=[int(c) for c in counts],
            sum=float(total_ms))

    # -- snapshot / delta -------------------------------------------------

    def snapshot(self) -> dict:
        """Current values, flat ``{rendered_name: value}``.  Copies the
        store first — the live ``/metrics`` endpoint renders from its
        own thread while the engine records (obs/http)."""
        return {_render_name(n, lk): v
                for (n, lk), v in sorted(dict(self._values).items())}

    def delta(self) -> dict:
        """Counter deltas vs the previous ``sample`` (counters only —
        gauges have no delta semantics)."""
        out = {}
        for key, v in dict(self._values).items():
            name, lk = key
            if registry.spec(name).kind != "counter":
                continue
            out[_render_name(name, lk)] = v - self._prev.get(key, 0.0)
        return out

    def sample(self, step: int | None = None,
               ts: float | None = None) -> dict:
        """Freeze the current values into a time-series row and buffer it
        for the JSONL file (when configured; flushed every FLUSH_EVERY
        rows and at ``finalize``).  ``ts`` lets deferred callers stamp
        the observation time instead of the replay time.  Returns the
        row."""
        now = time.time() if ts is None else ts
        row = {"ts": now, "rel_s": now - self._t0,
               "step": step, "metrics": self.snapshot(),
               "deltas": self.delta()}
        self._prev = dict(self._values)
        self.series.append(row)
        if self.cfg.jsonl_path:
            self._jsonl_buf.append(json.dumps(row, sort_keys=True))
            if len(self._jsonl_buf) >= self.FLUSH_EVERY:
                self.flush_jsonl()
        return row

    def flush_jsonl(self) -> None:
        """Append the buffered rows to the JSONL file."""
        if self.cfg.jsonl_path and self._jsonl_buf:
            with open(self.cfg.jsonl_path, "a") as f:
                f.write("\n".join(self._jsonl_buf) + "\n")
            self._jsonl_buf.clear()

    # -- Prometheus text exposition ---------------------------------------

    def to_prometheus(self) -> str:
        """Text exposition format 0.0.4 (one ``# HELP``/``# TYPE`` pair
        per metric family, then its sample lines)."""
        fams: dict[str, list[str]] = {}
        for (name, lk), v in sorted(dict(self._values).items()):
            val = int(v) if float(v).is_integer() else v
            fams.setdefault(name, []).append(
                f"{_render_name(name, lk)} {val}")
        lines = []
        for name in fams:
            s = registry.spec(name)
            lines.append(f"# HELP {name} {s.help or name}")
            lines.append(f"# TYPE {name} {s.kind}")
            lines.extend(fams[name])
        for (name, lk), h in sorted(dict(self._hists).items()):
            s = registry.spec(name)
            lines.append(f"# HELP {name} {s.help or name}")
            lines.append(f"# TYPE {name} histogram")
            cum = 0
            for edge, c in zip(list(h["edges"]) + ["+Inf"], h["counts"]):
                cum += c
                le = edge if edge == "+Inf" else f"{float(edge):g}"
                lab = dict(lk)
                lab["le"] = le
                lines.append(_render_name(name + "_bucket",
                                          _labels_key(lab)) + f" {cum}")
            lines.append(_render_name(name + "_sum", lk)
                         + f" {h['sum']:g}")
            lines.append(_render_name(name + "_count", lk) + f" {cum}")
        return "\n".join(lines) + "\n"

    def write_prometheus(self, path: Optional[str] = None) -> str:
        path = path or self.cfg.prom_path
        assert path, "no prom_path configured"
        with open(path, "w") as f:
            f.write(self.to_prometheus())
        return path

    def finalize(self, step: int | None = None) -> None:
        """Final sample, JSONL flush + write the exposition file (when
        configured)."""
        self.sample(step=step)
        self.flush_jsonl()
        if self.cfg.prom_path:
            self.write_prometheus(self.cfg.prom_path)


def parse_prometheus(text: str) -> dict:
    """Parse a text exposition back into
    ``{"families": {name: kind}, "samples": {rendered_name: float},
    "series": {name: [{"labels": {...}, "value": float}, ...]}}`` —
    the validator ``make obs-smoke``, the tests and the ``/metrics``
    curl smoke run over the emitted text (a real scrape hits the same
    format).

    ``samples`` keeps the historical flat view (rendered key -> value);
    ``series`` decomposes every sample into (metric name, labels dict,
    value), escape-aware, so labelled families — the per-tenant
    ``{tenant="..."}`` samples from ``TenantBook.metrics()`` and the
    ``engine_slo_*`` family — round-trip structurally: re-rendering a
    series entry with ``_render_name`` reproduces its ``samples`` key
    exactly (tests/test_obs.py pins it)."""
    families: dict[str, str] = {}
    samples: dict[str, float] = {}
    series: dict[str, list] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("# TYPE"):
            _, _, name, kind = line.split(None, 3)
            assert kind in registry.KINDS, f"bad TYPE line: {line!r}"
            families[name] = kind
        elif line.startswith("#"):
            continue
        else:
            key, _, val = line.rpartition(" ")
            assert key, f"bad sample line: {line!r}"
            fval = float(val) if val != "+Inf" else float("inf")
            samples[key] = fval
            name, labels = parse_labels(key)
            series.setdefault(name, []).append(
                {"labels": labels, "value": fval})
    return {"families": families, "samples": samples, "series": series}
