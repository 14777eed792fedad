"""Scheduler protocol: the seam between the engine's primitives and the
request-level decisions above them (port of
``repro.serve.sched.base``; the chunked and QoS schedulers come later)."""

from __future__ import annotations

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
        """Recycle finished lanes, admit queued requests to free lanes,
        park idle lanes at pos = -1; returns the new (state, tokens)."""
        ...

    def maintain(self, state): ...

    def is_decoding(self, lane: int) -> bool: ...


def make_scheduler(ec) -> "Scheduler":
    """Resolve ``EngineConfig.scheduler``: only "greedy" is ported."""
    from .greedy import GreedyScheduler
    if ec.scheduler == "greedy":
        return GreedyScheduler(ec)
    raise ValueError(f"unknown scheduler {ec.scheduler!r} (the port has "
                     f"greedy only)")
