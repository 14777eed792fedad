"""Hotness trackers over a block/page id space (port of
``repro.core.policy.trackers``).

  "touch"     [n] int32   base counters (every tracker keeps these)
  "pol_ema"   [n] int32   mea only: decayed carry from previous epochs
  "pol_last"  [n] int32   recency only: epoch the block was last seen

Functional (state in, new tensors out) and vectorised over a batch of
ids; duplicate ids accumulate.
"""

from __future__ import annotations

import torch

from repro_torch._scatter import drop_add, drop_set, on_device

from .config import PolicyConfig

__all__ = ["init", "record", "score", "epoch_tick", "forget"]

_NEVER = -(1 << 20)


def _i32(x, device):
    return on_device(x, torch.int32, device)


def init(pol: PolicyConfig, n: int, device=None) -> dict:
    tr = {"touch": torch.zeros((n,), dtype=torch.int32, device=device)}
    if pol.tracker == "mea":
        tr["pol_ema"] = torch.zeros((n,), dtype=torch.int32, device=device)
    elif pol.tracker == "recency":
        tr["pol_last"] = torch.full((n,), _NEVER, dtype=torch.int32,
                                    device=device)
    return tr


def record(pol: PolicyConfig, tr: dict, ids, now=0, is_write=False,
           enable=None) -> dict:
    """Record one batched round of touches; ``enable`` [B] masks lanes
    out (weight 0, and no recency stamp)."""
    dev = tr["touch"].device
    w = _i32(1, dev)
    if pol.write_weight > 1:
        w = torch.where(on_device(is_write, torch.bool, dev),
                        pol.write_weight, 1).to(torch.int32)
    w = w.expand(ids.shape)
    if enable is not None:
        w = torch.where(enable, w, 0)
    tr = dict(tr)
    tr["touch"] = drop_add(tr["touch"], ids, w)
    if pol.tracker == "recency":
        idx = ids if enable is None else torch.where(
            enable, ids, tr["pol_last"].shape[0])
        tr["pol_last"] = drop_set(tr["pol_last"], idx, _i32(now, dev))
    return tr


def score(pol: PolicyConfig, tr: dict, now=0) -> torch.Tensor:
    """Current hotness score per block ([n] int32, higher == hotter)."""
    if pol.tracker == "mea":
        return tr["touch"] + (tr["pol_ema"] >> 1)
    if pol.tracker == "recency":
        recent = (_i32(now, tr["touch"].device) - tr["pol_last"]) \
            <= pol.history_len
        return torch.where(recent, tr["touch"], 0)
    return tr["touch"]


def epoch_tick(pol: PolicyConfig, tr: dict, now=0, enable=True) -> dict:
    """Decay at an epoch boundary, masked by ``enable``."""
    dev = tr["touch"].device
    en = on_device(enable, torch.bool, dev)
    tr = dict(tr)
    if pol.tracker == "mea":
        tr["pol_ema"] = torch.where(en, tr["touch"] + (tr["pol_ema"] >> 1),
                                    tr["pol_ema"])
        tr["touch"] = torch.where(en, 0, tr["touch"])
    elif pol.tracker == "recency":
        stale = (_i32(now, dev) - tr["pol_last"]) > pol.history_len
        tr["touch"] = torch.where(en & stale, 0, tr["touch"])
    else:
        tr["touch"] = torch.where(en, tr["touch"] >> 1, tr["touch"])
    return tr


def forget(pol: PolicyConfig, tr: dict, ids, enable) -> dict:
    """Reset a batch of blocks; disabled lanes drop out of bounds."""
    idx = torch.where(enable, ids, tr["touch"].shape[0])
    tr = dict(tr)
    tr["touch"] = drop_set(tr["touch"], idx, 0)
    if "pol_ema" in tr:
        tr["pol_ema"] = drop_set(tr["pol_ema"], idx, 0)
    if "pol_last" in tr:
        tr["pol_last"] = drop_set(tr["pol_last"], idx, _NEVER)
    return tr
