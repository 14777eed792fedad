"""PolicyConfig: the one documented knob surface for hotness tracking and
migration scheduling (DESIGN.md §7).

Trimma is deliberately policy-transparent (the paper evaluates it under
both cache-style and MemPod/flat-style remap policies and claims
compatibility with "various types of hybrid memory systems"), so the
*policy* axis — when is a block hot, when does it move, how much moves per
epoch — is factored out of the metadata engine into this config plus three
pluggable pieces:

  tracker   (trackers.py)   how hotness is measured
  decider   (deciders.py)   when a block qualifies to move
  scheduler (scheduler.py)  bounded promotion/demotion per epoch

Both consumers read it: ``core/simulator`` drives the per-access gate
(``policy.access``) inside its ``lax.scan`` step, and ``tiered/kvcache`` /
``serve/tiered.maintain`` drive the batched epoch scheduler.

The legacy knobs ``SimConfig.install_threshold`` /
``SimConfig.migrate_threshold`` / ``SimConfig.counter_decay_shift`` and
``TieredConfig.migrate_threshold`` are deprecation shims that resolve to a
default ``PolicyConfig`` (see ``SimConfig.pol`` / ``TieredConfig.pol``);
new code should pass ``policy=`` explicitly.
"""

from __future__ import annotations

import dataclasses

TRACKERS = ("touch", "mea", "recency")
DECIDERS = ("threshold", "topk", "on_demand", "write_aware")


@dataclasses.dataclass(frozen=True)
class PolicyConfig:
    """Hotness-tracking + migration-scheduling policy (pure static config).

    Tracker kinds
      touch     raw touch counters, halved every epoch (the paper's
                threshold-counter default; MemPod-adjacent)
      mea       majority-element-style epoch counters: per-epoch counts
                plus an exponentially decayed carry from previous epochs
                (MemPod MEA, *Efficient Page Migration in Hybrid Memory
                Systems*)
      recency   bounded recency window: counters only score while the
                block was seen within the last ``history_len`` epochs
                (history-aware promotion, *Exploiting Inter- and
                Intra-Memory Asymmetries ...*)

    Decider kinds
      threshold    move when score >= promote/install threshold
      topk         per-epoch: the ``topk`` hottest eligible blocks move
                   (epoch ranking; the simulator's per-access loop
                   approximates it with the threshold gate)
      on_demand    cache-style: move on every eligible miss/touch
      write_aware  threshold on write-weighted scores; the scheduler
                   demotes first and prefers evicting write-cold pages
                   (write-asymmetry aware, for NVM-backed slow tiers)
    """

    name: str = "threshold"          # preset label, used as the sweep key
    tracker: str = "touch"
    decider: str = "threshold"

    # --- decider thresholds ------------------------------------------------
    promote_threshold: int = 3       # flat/serving: touches before migration
    install_threshold: int = 0       # cache mode: 0 == install on every miss
    demote_threshold: int = 0        # resident pages at/below score demote
    topk: int = 4                    # topk decider: promotions per epoch

    # --- tracker shape -----------------------------------------------------
    decay_shift: int = 14            # simulator: epoch == 2^k accesses
    epoch_len: int = 8               # serving: maintain() calls per epoch
    history_len: int = 4             # recency tracker: window in epochs
    write_weight: int = 1            # >1: a write touch counts this much

    # --- scheduler ---------------------------------------------------------
    max_moves: int = 4               # move budget (promote+demote) per call

    def validate(self) -> "PolicyConfig":
        if self.tracker not in TRACKERS or self.decider not in DECIDERS:
            raise ValueError(f"unknown tracker {self.tracker!r} or decider "
                             f"{self.decider!r}")
        if min(self.promote_threshold, self.install_threshold,
               self.demote_threshold, self.decay_shift) < 0 \
                or min(self.epoch_len, self.history_len, self.write_weight,
                       self.max_moves, self.topk) < 1:
            raise ValueError(f"policy values out of range: {self}")
        return self

    @property
    def demote_first(self) -> bool:
        """Write-aware policies spend the move budget on demotions first
        (freeing fast slots before pulling new pages in)."""
        return self.decider == "write_aware"


# ---------------------------------------------------------------------------
# presets — the sweepable family (each maps to a scheme in the literature)
# ---------------------------------------------------------------------------

def threshold_policy(**kw) -> PolicyConfig:
    """Paper default: raw counters + migrate/install threshold."""
    return PolicyConfig(name="threshold", **kw).validate()


def mea_policy(**kw) -> PolicyConfig:
    """MemPod-style majority-element epoch counters with decay."""
    kw.setdefault("promote_threshold", 2)
    kw.setdefault("install_threshold", 2)
    return PolicyConfig(name="mea", tracker="mea", **kw).validate()


def on_demand_policy(**kw) -> PolicyConfig:
    """Cache-style on-demand: install/promote on every eligible miss."""
    return PolicyConfig(name="on_demand", decider="on_demand",
                        **kw).validate()


def write_aware_policy(**kw) -> PolicyConfig:
    """Write-asymmetry aware: writes weigh double, demote-first scheduling,
    write-cold residents evicted first (NVM slow tiers)."""
    kw.setdefault("promote_threshold", 2)
    kw.setdefault("install_threshold", 2)
    kw.setdefault("write_weight", 2)
    return PolicyConfig(name="write_aware", decider="write_aware",
                        **kw).validate()


def topk_policy(**kw) -> PolicyConfig:
    """Top-k-per-epoch promotion (epoch ranking instead of a threshold).

    Ranked admission only moves at epoch edges, so its epochs must be
    much shorter than a decay epoch or the budget never refreshes (a
    trace shorter than ``2^decay_shift`` accesses would get exactly
    ``topk`` installs, total) — MemPod-style intervals, not decay
    windows.  Hence the short 256-access default here; the serving
    scheduler paces by ``epoch_len`` and is unaffected."""
    kw.setdefault("promote_threshold", 1)
    kw.setdefault("install_threshold", 1)
    kw.setdefault("decay_shift", 8)
    return PolicyConfig(name="topk", decider="topk", **kw).validate()


def recency_policy(**kw) -> PolicyConfig:
    """History-aware: only recently-seen blocks can promote; stale
    counters are dropped wholesale at the window edge."""
    kw.setdefault("promote_threshold", 2)
    kw.setdefault("install_threshold", 2)
    return PolicyConfig(name="recency", tracker="recency", **kw).validate()


PRESETS = {
    "threshold": threshold_policy,
    "mea": mea_policy,
    "on_demand": on_demand_policy,
    "write_aware": write_aware_policy,
    "topk": topk_policy,
    "recency": recency_policy,
}


def get_policy(name_or_cfg, **kw) -> PolicyConfig:
    """Resolve a preset name (or pass a PolicyConfig through)."""
    if isinstance(name_or_cfg, PolicyConfig):
        if kw:
            raise ValueError("overrides apply to a preset name only")
        return name_or_cfg
    return PRESETS[name_or_cfg](**kw)
