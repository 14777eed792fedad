"""Scheduler protocol: the seam between the engine's primitives and the
request-level decisions above them (port of
``repro.serve.sched.base``)."""

from __future__ import annotations

import warnings
from typing import Protocol, runtime_checkable


@runtime_checkable
class Scheduler(Protocol):
    """Owns the request queue, lane assignment and prefill pacing.  The
    engine ``bind``s itself, calls ``refill`` once before the decode loop
    and after every step, and ``maintain`` on the migration cadence."""

    def bind(self, engine) -> None: ...

    def submit(self, req) -> None: ...

    @property
    def pending(self) -> int: ...

    def refill(self, state, tokens, lanes, finished):
        """Recycle finished lanes, advance chunked prefills within the
        chunk budget, admit queued requests to free lanes, park idle lanes
        at pos = -1; returns the new (state, tokens)."""
        ...

    def maintain(self, state): ...

    def is_decoding(self, lane: int) -> bool: ...


def make_scheduler(ec) -> "Scheduler":
    """Resolve ``EngineConfig.scheduler``: "greedy" (the default),
    "chunked" (chunked prefill + multi-tenant QoS), or the deprecated
    alias "wave" -> greedy."""
    from .chunked import ChunkedScheduler
    from .greedy import GreedyScheduler
    kind = ec.scheduler
    if kind == "wave":
        warnings.warn(
            "EngineConfig(scheduler=\"wave\") is a deprecated alias of the "
            "implicit wave-refill path; use scheduler=\"greedy\" (same "
            "behaviour) or \"chunked\" (chunked prefill + QoS admission)",
            FutureWarning, stacklevel=2)
        kind = "greedy"
    if kind == "greedy":
        return GreedyScheduler(ec)
    if kind == "chunked":
        return ChunkedScheduler(ec)
    raise ValueError(
        f"unknown scheduler {ec.scheduler!r} (want greedy|chunked)")
