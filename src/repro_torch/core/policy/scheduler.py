"""Migration scheduler: bounded promotion and demotion queues per epoch
(port of ``repro.core.policy.scheduler``: ``plan`` and the per-tenant
``plan_tenants``).

Both queues rank with ``_scatter.top_k``, whose ties break by lowest id
as ``jax.lax.top_k``'s do: ``torch.topk`` may order tied lanes
differently, and then plans, iRT entries and counters diverge from the
reference.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch._scatter import top_k
from repro_torch.obs.registry import MetricSpec, register

from . import deciders
from .config import PolicyConfig

# canonical metric names for the moves this module plans (DESIGN.md §10);
# the copy sites in tiered/kvcache account them
register(
    MetricSpec("trimma_migrations_total", "counter",
               "pages promoted into the fast tier (installs)"),
    MetricSpec("trimma_demotions_total", "counter",
               "scheduler demotions back to the slow home"),
    MetricSpec("trimma_forced_evictions_total", "counter",
               "metadata-priority forced evictions (Section 3.3)"),
    MetricSpec("trimma_promoted_bytes_total", "counter",
               "slow->fast migration bandwidth", unit="bytes"),
    MetricSpec("trimma_demoted_bytes_total", "counter",
               "fast->slow copy-back bandwidth (demotions + victim and "
               "forced evictions)", unit="bytes"),
)

__all__ = ["Plan", "plan", "plan_tenants"]

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


def plan_tenants(pols, score, resident, group, quotas,
                 demote_key=None) -> Plan:
    """One bounded ``plan`` per tenant over its own blocks, concatenated.
    ``pols``/``quotas``: per-tenant policies (their own thresholds and
    ``max_moves``) and fast-slot quotas; ``group`` [n] int32 is each
    block's tenant (< 0: moves for nobody).  A tenant's enabled
    promotions are capped at its quota minus its residents."""
    if len(pols) != len(quotas) or not pols:
        raise ValueError("plan_tenants: one policy and one quota per tenant")
    plans = []
    for t, (pol, quota) in enumerate(zip(pols, quotas)):
        mine = group == t
        p = plan(pol, score, resident, pol.max_moves, demote_key=demote_key,
                 member=mine)
        res_t = (resident & mine).sum(dtype=torch.int32)
        room = torch.clamp(quota - res_t, min=0)
        k = p.promote_en.shape[0]
        lanes = torch.arange(k, device=score.device)
        plans.append(p._replace(promote_en=p.promote_en & (lanes < room)))
    return Plan(*(torch.cat([getattr(p, f) for p in plans])
                  for f in Plan._fields))
