"""core/policy: hotness tracking + migration scheduling (port of
``repro.core.policy``; ``config.py`` is a copy of the reference's;
``access`` is the per-access gate the trace simulator scans over)."""

from . import access, deciders, scheduler, trackers
from .config import (DECIDERS, PRESETS, TRACKERS, PolicyConfig, get_policy,
                     mea_policy, on_demand_policy, recency_policy,
                     threshold_policy, topk_policy, write_aware_policy)
from .scheduler import Plan, plan, plan_tenants

__all__ = [
    "PolicyConfig", "get_policy", "PRESETS", "TRACKERS", "DECIDERS",
    "threshold_policy", "mea_policy", "on_demand_policy",
    "write_aware_policy", "topk_policy", "recency_policy",
    "Plan", "plan", "plan_tenants", "trackers", "deciders", "scheduler",
    "access",
]
