"""Structured step tracing (port of ``repro.obs.trace``): Chrome-trace-
event JSON (Perfetto-loadable) spans for the serving loop's phases, plus
optional ``torch.profiler`` hooks for kernel-level timelines (DESIGN.md
§10).

Span semantics: a ``span`` measures the host-observed wall time of one
engine phase — ``prefill_chunk`` / ``prefill`` / ``decode_step`` /
``maintain`` / ``release`` — on the host clock around dispatch: a span
waits for the card only where the phase itself does (the decode loop
reads every step's tokens back after its ``decode_step`` span), so a
phase's device time may land in a later span.  Per-span metric
annotations ride in ``args`` and show up in Perfetto's span details.

Event schema (Trace Event Format, the subset Perfetto ingests):
  {"ph": "X", "name": ..., "cat": ..., "pid": 1, "tid": ...,
   "ts": <µs since tracer start>, "dur": <µs>, "args": {...}}     spans
  {"ph": "C", "name": ..., "ts": ..., "args": {metric: value}}  counters
  {"ph": "i", "name": ..., "ts": ..., "s": "g"}                 instants
  {"ph": "M", ...}                                    process/thread names

Open a saved trace at https://ui.perfetto.dev ("Open trace file") or
chrome://tracing — the file is a standard ``{"traceEvents": [...]}``
JSON object.
"""

from __future__ import annotations

import contextlib
import json
import time


class StepTracer:
    """Collects trace events in memory; ``save`` writes the JSON."""

    #: lanes (Perfetto "threads") the engine phases render on — spans on
    #: separate tids stack visually instead of overlapping
    TIDS = {"decode_step": 0, "prefill": 1, "prefill_chunk": 1,
            "admit_fast": 1, "maintain": 2, "release": 3}

    def __init__(self, process_name: str = "repro_torch.serve.engine"):
        self._t0 = time.perf_counter()
        self.events: list[dict] = [
            {"ph": "M", "name": "process_name", "pid": 1, "tid": 0,
             "args": {"name": process_name}},
        ]
        for name, tid in (("decode", 0), ("prefill", 1),
                          ("maintain", 2), ("release", 3)):
            self.events.append(
                {"ph": "M", "name": "thread_name", "pid": 1, "tid": tid,
                 "args": {"name": name}})
        self._n_meta = len(self.events)

    def clear(self) -> None:
        """Reset to an empty trace (fresh t0, metadata events kept): the
        engine clears at the top of each ``run`` so the saved file covers
        exactly that run instead of growing across runs."""
        self._t0 = time.perf_counter()
        del self.events[self._n_meta:]

    def now_us(self) -> float:
        """µs since tracer start — the timebase of every event ``ts``
        (callers stash it to emit deferred events at the right spot)."""
        return (time.perf_counter() - self._t0) * 1e6

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "engine", tid: int | None = None,
             **args):
        """Complete-event span around one phase; ``args`` annotate it."""
        ts = self.now_us()
        try:
            yield
        finally:
            self.events.append({
                "ph": "X", "name": name, "cat": cat, "pid": 1,
                "tid": self.TIDS.get(name, 0) if tid is None else tid,
                "ts": ts, "dur": self.now_us() - ts,
                "args": args,
            })

    def instant(self, name: str, cat: str = "engine", **args) -> None:
        self.events.append({"ph": "i", "name": name, "cat": cat, "pid": 1,
                            "tid": 0, "ts": self.now_us(), "s": "g",
                            "args": args})

    def counter(self, name: str, values: dict,
                ts: float | None = None) -> None:
        """Counter track (Perfetto renders a stacked area chart).  ``ts``
        lets deferred emitters stamp the time the value was observed."""
        self.events.append({"ph": "C", "name": name, "pid": 1, "tid": 0,
                            "ts": self.now_us() if ts is None else ts,
                            "args": {k: float(v) for k, v in values.items()}})

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump({"traceEvents": self.events,
                       "displayTimeUnit": "ms"}, f)
        return path


class NullTracer:
    """No-op stand-in so the engine's hot loop stays branch-free: the
    span context manager costs one attribute lookup when tracing is off."""

    _NULL = contextlib.nullcontext()

    def span(self, name, cat="engine", tid=None, **args):
        return self._NULL

    def clear(self):
        pass

    def now_us(self):
        return 0.0

    def instant(self, *a, **k):
        pass

    def counter(self, *a, **k):
        pass

    def save(self, path):
        raise RuntimeError("tracing is disabled (NullTracer)")


NULL_TRACER = NullTracer()


@contextlib.contextmanager
def profiler_trace(log_dir: str | None):
    """Optionally wrap a block in a ``torch.profiler`` trace: when
    ``log_dir`` is set, host operators and, on a card, the device's
    kernels (the hand-written ones included) land in a Chrome trace,
    ``<log_dir>/trace.json``; ``None`` is a no-op.  Imported lazily."""
    if not log_dir:
        yield
        return
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str, enabled: bool = True):
    """Named ``torch.profiler.record_function`` range (shows up in the
    profiler timeline around the wrapped dispatches).  No-op when
    disabled."""
    if not enabled:
        yield
        return
    import torch
    with torch.profiler.record_function(name):
        yield
