"""Page-lifecycle flight recorder (port of ``repro.obs.flight``,
DESIGN.md §12).

A bounded ring buffer of per-page lifecycle events — install / promote
/ demote / evict / release — each stamped with the decode step, layer,
tenant, requesting lane and the policy decision (``cause``) that
produced it.  The ring lives on the device: one int32 [capacity,
len(FIELDS)] event table plus the ``head`` and per-kind ``counts``
tensors; ``record`` is one masked batch scatter and reads nothing on the
host, and all analysis happens host-side at drain.  The reference writes
its ring in plain jnp (no Pallas kernel), so this one is plain PyTorch.

Ring semantics (the wraparound test pins them):
  * ``head`` is the MONOTONIC count of events ever recorded — it never
    wraps.  Event ``i`` lives at slot ``i % capacity``, so once more
    than ``capacity`` events exist the oldest are overwritten and
    ``drain`` reports them as ``dropped = head - capacity``;
  * per-kind totals (``counts``) accumulate alongside and are exact
    regardless of how many events the ring has dropped;
  * ``drain`` returns the surviving window oldest-to-newest — within
    one ``record`` call events keep their batch order, and calls land
    in program order, so the drained window is chronological.

Events come from the migration *descriptors* (``tiered.kvcache``'s
``_migrate_one_desc`` / ``_demote_one_desc`` move records, the same ones
the pass's copy replay reads) — the ground truth of what actually moved,
not what the plan asked for — so a promotion that found its page
already resident records nothing, and the two eviction flavours (FIFO
victim vs forced metadata-priority evict) are distinguishable by
``cause``.

Metadata is layer-uniform by construction (DESIGN.md §11: one plan on
layer 0, copies replayed over the stack), so one event represents the
same move on every layer; ``layer`` is stamped 0.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch._scatter import drop_set

from .registry import MetricSpec, register

# -- event vocabulary -------------------------------------------------------

#: lifecycle event kinds (the ``kind`` field)
KINDS = ("install", "promote", "demote", "evict", "release")
K_INSTALL, K_PROMOTE, K_DEMOTE, K_EVICT, K_RELEASE = range(len(KINDS))

#: policy decisions (the ``cause`` field): which decision produced the event
CAUSES = ("admit_prefix",     # direct-to-fast admission at prompt ingest
          "plan_promote",     # migration scheduler promotion
          "plan_demote",      # migration scheduler demotion
          "victim_fifo",      # FIFO victim copied back to make room
          "forced_meta",      # metadata-priority forced eviction
          "lane_recycle")     # lane released on request completion
C_ADMIT, C_PLAN_PROMOTE, C_PLAN_DEMOTE, C_VICTIM, C_FORCED, C_RECYCLE = \
    range(len(CAUSES))

#: per-event int32 fields, in drain order
FIELDS = ("kind", "page", "step", "layer", "lane", "tenant", "cause",
          "score")

#: residency / reuse-distance histogram edges (decode steps, log2)
STEP_EDGES = tuple(1 << i for i in range(12))

register(
    MetricSpec("trimma_flight_events_total", "counter",
               "page-lifecycle events recorded by the flight ring "
               "(monotonic; survives ring wraparound)"),
    MetricSpec("trimma_flight_dropped_total", "counter",
               "flight events overwritten by ring wraparound"),
    MetricSpec("trimma_flight_kind_events_total", "counter",
               "flight events by lifecycle kind (labels: kind)"),
    MetricSpec("trimma_flight_pingpong_total", "counter",
               "re-promotions within the ping-pong window of the "
               "page's last demotion/eviction (fast-slot churn)"),
    MetricSpec("trimma_page_residency_steps", "histogram",
               "fast-pool residency time per completed stay "
               "(decode steps, log2 buckets)", unit="steps"),
    MetricSpec("trimma_page_reuse_distance_steps", "histogram",
               "steps between a page leaving the fast pool and "
               "re-entering it (log2 buckets)", unit="steps"),
)


@dataclasses.dataclass(frozen=True)
class FlightConfig:
    """Recorder wiring: ``capacity`` bounds the ring (events beyond it
    drop oldest-first); ``pingpong_steps`` is the re-promotion window N
    under which a promote counts as ping-pong churn."""

    capacity: int = 2048
    pingpong_steps: int = 32


# -- ring ops (functional; no host reads) ------------------------------------

def init(capacity: int, device=None) -> dict:
    """Fresh ring: the int32 event table [capacity, len(FIELDS)] (one
    column per field), the monotonic ``head`` event count, and exact
    per-kind ``counts``."""
    z = lambda *s: torch.zeros(s, dtype=torch.int32, device=device)  # noqa
    return {"events": z(int(capacity), len(FIELDS)), "head": z(),
            "counts": z(len(KINDS))}


def record(fl: dict, kind, pages, enable, *, step, lane, tenant, cause,
           score=None) -> dict:
    """Append the enabled subset of a batch of events, in batch order.

    ``pages``/``enable`` are [M] tensors on the ring's device; ``kind``,
    ``cause``, ``step``, ``lane``, ``tenant`` and ``score`` are each a
    Python int (broadcast) or an [M] tensor (per entry: one call may
    carry several kinds, which keeps a maintenance pass to one scatter).
    ``score`` stamps the policy-tracker hotness (0 when absent).  The
    i-th enabled entry lands in slot ``(head + #enabled before i) %
    capacity``; disabled entries write nothing and do not advance
    ``head``; ``counts[kind]`` grows by the enabled entries of each
    kind.  When one batch wraps the ring, the later entry of a slot wins
    (``drop_set``'s last-lane rule)."""
    dev = fl["events"].device
    pages = torch.atleast_1d(pages).to(torch.int32)
    en = torch.atleast_1d(enable).to(torch.bool)
    m = pages.shape[0]
    cap = fl["events"].shape[0]

    def col(x):
        if isinstance(x, torch.Tensor):
            return torch.broadcast_to(x.to(torch.int32), (m,))
        return torch.full((m,), int(x), dtype=torch.int32, device=dev)

    vals = dict(kind=col(kind), page=pages, step=col(step), layer=col(0),
                lane=col(lane), tenant=col(tenant), cause=col(cause),
                score=col(0 if score is None else score))
    offs = torch.cumsum(en.to(torch.int32), 0) - 1
    idx = torch.where(en, (fl["head"] + offs) % cap, cap)   # disabled: drop
    events = drop_set(fl["events"], idx,
                      torch.stack([vals[f] for f in FIELDS], -1))
    kinds = torch.arange(len(KINDS), dtype=torch.int32, device=dev)
    per_kind = ((vals["kind"][:, None] == kinds) & en[:, None]).sum(
        0, dtype=torch.int32)
    return {"events": events,
            "head": fl["head"] + per_kind.sum(dtype=torch.int32),
            "counts": fl["counts"] + per_kind}


# -- host-side drain + analytics --------------------------------------------

def drain(fl: dict) -> dict:
    """Materialise the ring host-side: the surviving window oldest-to-
    newest (numpy arrays per field), plus the exact totals.  Events
    beyond capacity were overwritten oldest-first: ``dropped`` counts
    them; ``total_events`` (== head) and ``counts`` stay exact."""
    head = int(fl["head"])
    events = fl["events"].cpu().numpy()
    cap = events.shape[0]
    n = min(head, cap)
    order = (head - n + np.arange(n)) % cap if n else np.arange(0)
    out = {f: events[order, i] for i, f in enumerate(FIELDS)}
    out["n"] = n
    out["total_events"] = head
    out["dropped"] = head - n
    out["counts"] = fl["counts"].cpu().numpy()
    return out


def _hist(values) -> dict:
    edges = np.asarray(STEP_EDGES)
    counts = np.zeros(len(edges) + 1, np.int64)
    for v in values:
        counts[int(np.searchsorted(edges, v, side="right"))] += 1
    return {"edges_steps": list(STEP_EDGES),
            "counts": [int(c) for c in counts]}


def _summ(values) -> dict:
    if not values:
        return {"count": 0}
    a = np.asarray(values, np.float64)
    return {"count": int(a.size), "mean_steps": float(a.mean()),
            "p50_steps": float(np.percentile(a, 50)),
            "max_steps": int(a.max()), "hist": _hist(values)}


def analyze(ev: dict, pingpong_steps: int = 32,
            tenant_names=None) -> dict:
    """Derived analytics over a drained event window (``drain`` output).

    Walks the chronological window once per page: a promote/install
    opens a fast-pool stay, a demote/evict closes it (residency = steps
    in between) and arms the reuse clock; the next promote of the same
    page measures reuse distance and — when it lands within
    ``pingpong_steps`` — counts as ping-pong churn.  The window is
    bounded by the ring capacity, so stays that started before the
    oldest surviving event are simply not counted (documented drain
    rule, DESIGN.md §12)."""
    names = list(tenant_names or [])
    tname = lambda t: (names[t] if 0 <= t < len(names)  # noqa: E731
                       else str(t))
    out: dict = {
        "n_events": int(ev["n"]),
        "total_events": int(ev["total_events"]),
        "dropped": int(ev["dropped"]),
        "by_kind": {k: int(c) for k, c in zip(KINDS, ev["counts"])},
        "pingpong": {"window_steps": int(pingpong_steps), "events": 0,
                     "pages": 0},
    }
    enters = {}          # page -> step it entered the fast pool
    left = {}            # page -> step it last left the fast pool
    residency, reuse = [], []
    pp_pages: dict[int, int] = {}
    per_tenant: dict = {}
    for i in range(int(ev["n"])):
        kind, page, step = (int(ev["kind"][i]), int(ev["page"][i]),
                            int(ev["step"][i]))
        t = per_tenant.setdefault(tname(int(ev["tenant"][i])),
                                  {k: 0 for k in KINDS})
        t[KINDS[kind]] += 1
        if kind in (K_INSTALL, K_PROMOTE):
            if page in left:
                gap = step - left.pop(page)
                reuse.append(gap)
                if gap <= pingpong_steps:
                    pp_pages[page] = pp_pages.get(page, 0) + 1
                    t["pingpong"] = t.get("pingpong", 0) + 1
            enters[page] = step
        elif kind in (K_DEMOTE, K_EVICT, K_RELEASE):
            if page in enters:
                residency.append(step - enters.pop(page))
                if kind != K_RELEASE:     # released pages never return
                    left[page] = step
    out["residency"] = _summ(residency)
    out["reuse"] = _summ(reuse)
    out["pingpong"]["events"] = sum(pp_pages.values())
    out["pingpong"]["pages"] = len(pp_pages)
    if pp_pages:
        top = sorted(pp_pages.items(), key=lambda kv: -kv[1])[:5]
        out["pingpong"]["top_pages"] = [[p, c] for p, c in top]
    out["per_tenant"] = per_tenant
    return out


def export(hub, stats: dict) -> None:
    """Publish a recorder analytics dict into a MetricsHub (drain-time:
    counters, per-kind labelled counters, residency/reuse histograms)."""
    hub.record({"trimma_flight_events_total": stats["total_events"],
                "trimma_flight_dropped_total": stats["dropped"],
                "trimma_flight_pingpong_total":
                    stats["pingpong"]["events"]})
    for kind, c in stats["by_kind"].items():
        hub.set("trimma_flight_kind_events_total", c,
                labels={"kind": kind})
    for name, block in (("trimma_page_residency_steps",
                         stats["residency"]),
                        ("trimma_page_reuse_distance_steps",
                         stats["reuse"])):
        if block.get("count"):
            h = block["hist"]
            hub.observe_hist(name, h["edges_steps"], h["counts"],
                             float(block["mean_steps"]) * block["count"])
