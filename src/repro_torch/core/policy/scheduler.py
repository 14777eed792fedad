"""Migration scheduler: bounded promotion and demotion queues per epoch
(port of ``repro.core.policy.scheduler.plan``; ``plan_tenants`` comes
with the QoS scheduler).

Both queues rank with ``_scatter.top_k``, whose ties break by lowest id
as ``jax.lax.top_k``'s do: ``torch.topk`` may order tied lanes
differently, and then plans, iRT entries and counters diverge from the
reference.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch._scatter import top_k

from . import deciders
from .config import PolicyConfig

__all__ = ["Plan", "plan"]

_SCORE_CAP = 1 << 20       # demotion ranking headroom (scores clip here)


class Plan(NamedTuple):
    promote_ids: torch.Tensor     # [k] int32, hottest-first
    promote_en: torch.Tensor      # [k] bool
    demote_ids: torch.Tensor      # [k] int32, coldest-first
    demote_en: torch.Tensor       # [k] bool


def plan(pol: PolicyConfig, score, resident, max_moves: int,
         demote_key=None, member=None) -> Plan:
    """This epoch's move queues over ``score`` [n] int32 and ``resident``
    [n] bool; at most ``max_moves`` enabled lanes in total, enabled lanes
    a prefix of each queue.  ``demote_key`` overrides the demotion
    ranking, ``member`` restricts eligibility."""
    n = score.shape[0]
    k = min(int(max_moves), n)
    dev = score.device
    lanes = torch.arange(k, device=dev)

    want_p = deciders.promote_mask(pol, score, resident)
    if member is not None:
        want_p &= member
    p_key = torch.where(want_p, score.clamp(0, _SCORE_CAP) + 1, 0)
    p_val, p_ids = top_k(p_key, k)
    p_en = p_val > 0
    if pol.decider == "topk":
        p_en &= lanes < pol.topk

    want_d = deciders.demote_mask(pol, score, resident)
    if member is not None:
        want_d &= member
    dk = score if demote_key is None else demote_key
    d_keyv = torch.where(want_d, _SCORE_CAP - dk.clamp(0, _SCORE_CAP - 1), 0)
    d_val, d_ids = top_k(d_keyv, k)
    d_en = d_val > 0

    # shared budget: the preferred queue keeps its lanes, the other is
    # truncated so the total never exceeds max_moves
    if pol.demote_first:
        p_en &= (lanes + d_en.sum()) < max_moves
    else:
        d_en &= (lanes + p_en.sum()) < max_moves
    return Plan(p_ids.to(torch.int32), p_en, d_ids.to(torch.int32), d_en)
