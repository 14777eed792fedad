"""Deciders: which blocks *qualify* to move, given tracker scores (port of
``repro.core.policy.deciders``).  Pure elementwise masks; ranking and
budgeting live in ``scheduler``."""

from __future__ import annotations

import torch

from .config import PolicyConfig

__all__ = ["promote_mask", "demote_mask"]


def promote_mask(pol: PolicyConfig, score, resident) -> torch.Tensor:
    """Non-resident blocks eligible for promotion this epoch (residents are
    always excluded)."""
    eligible = ~resident
    if pol.decider in ("on_demand", "topk"):
        return eligible & (score >= 1)
    return eligible & (score >= pol.promote_threshold)


def demote_mask(pol: PolicyConfig, score, resident) -> torch.Tensor:
    """Resident blocks whose hotness decayed to the demotion band."""
    return resident & (score <= pol.demote_threshold)
