"""serve/sched: continuous-batching request scheduling (greedy)."""

from .base import Scheduler, make_scheduler
from .greedy import GreedyScheduler

__all__ = ["GreedyScheduler", "Scheduler", "make_scheduler"]
