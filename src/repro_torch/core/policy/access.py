"""Per-access policy gate for the trace simulator, port of
``repro.core.policy.access``, written batch-first over a leading trace
axis T (the reference's ``vmap`` written out).

``core/simulator``'s step calls ``gate`` once per access: given each
trace's access (block id [T], write flag [T]) and an eligibility mask [T]
(cache mode: fast-tier miss; flat mode: movable slow-home miss), the
gate updates the tracker arrays ([T, n_phys]) of the simulator's state
dict and answers "does this access trigger an install/migration?".

The default policy (touch tracker + threshold decider) emits exactly the
op sequence the reference's pre-policy simulator inlined, so
``tests/golden/sim_counters.json`` reproduces bit for bit.

Epochs are access-count based: every ``2^decay_shift`` accesses.  Every
trace of a batch is at the same access, so whether an access ends an
epoch (its tick) is one host-side bool the caller passes in; the
epoch-edge work (decay, and topk's ranking of every block's score) runs
only then.  The reference computes topk's rank on every access and reads
it only at the tick.

Updates are in place.  A lane whose ``enable`` is false leaves its row
unchanged: its store goes to an element of its own trace's row and
writes back the value already there, so it can never touch another
trace's state.
"""

from __future__ import annotations

import torch

from repro_torch._scatter import on_device, top_k

from .config import PolicyConfig

__all__ = ["init", "gate", "forget", "tracked_keys", "masked_add",
           "masked_set"]

_STALE = -(1 << 20)


def _rows(arr: torch.Tensor) -> torch.Tensor:
    return torch.arange(arr.shape[0], device=arr.device)


def masked_add(arr, idx, delta, enable):
    """In place ``arr[t, idx[t]] += delta[t]`` where ``enable[t]``;
    ``arr`` is [T, n], the rest [T] (``delta`` may be a Python int)."""
    rows, i = _rows(arr), torch.where(enable, idx, 0).long()
    arr[rows, i] += torch.where(enable, delta, 0).to(arr.dtype)
    return arr


def masked_set(arr, idx, val, enable):
    """In place ``arr[t, idx[t]] = val[t]`` where ``enable[t]``."""
    rows, i = _rows(arr), torch.where(enable, idx, 0).long()
    arr[rows, i] = torch.where(enable, on_device(val, arr.dtype, arr.device),
                               arr[rows, i])
    return arr


def _tracks(pol: PolicyConfig, mode: str) -> bool:
    """Does this (policy, sim mode) pair keep per-block tracker state?"""
    if pol.decider == "on_demand":
        return False
    return pol.threshold_for(mode) > 0


def tracked_keys(pol: PolicyConfig, mode: str) -> tuple:
    if not _tracks(pol, mode):
        return ()
    if pol.tracker == "mea":
        return ("touch", "pol_ema")
    if pol.tracker == "recency":
        return ("touch", "pol_last")
    return ("touch",)


def init(pol: PolicyConfig, mode: str, n: int, n_traces: int = 1,
         device=None) -> dict:
    """Tracker arrays ([T, n] int32, plus topk's [T] cut and budget) to
    merge into the simulator state dict."""
    out = {}
    for key in tracked_keys(pol, mode):
        fill = _STALE if key == "pol_last" else 0
        out[key] = torch.full((n_traces, n), fill, dtype=torch.int32,
                              device=device)
    if out and pol.decider == "topk":
        # epoch-ranked carry: the admission cut and the per-epoch move
        # budget, refreshed at every epoch edge; the first epoch starts
        # with a full budget and a cut of 1
        out["pol_cut"] = torch.ones((n_traces,), dtype=torch.int32,
                                    device=device)
        out["pol_budget"] = torch.full((n_traces,), int(pol.topk),
                                       dtype=torch.int32, device=device)
    return out


def _scores(pol: PolicyConfig, st: dict, rows=None, b=None):
    if rows is None:
        touch = st["touch"]
        return touch + (st["pol_ema"] >> 1) if pol.tracker == "mea" \
            else touch
    sc = st["touch"][rows, b]
    if pol.tracker == "mea":
        sc = sc + (st["pol_ema"][rows, b] >> 1)
    return sc


def gate(pol: PolicyConfig, mode: str, st: dict, b, is_write, eligible,
         tick: bool):
    """One access of every trace: record the touch, decide, reset on a
    move, decay at the epoch edge (``tick``).  ``b``, ``is_write`` and
    ``eligible`` are [T]; returns ``go`` [T] (bool)."""
    if not _tracks(pol, mode):
        return eligible                        # on-demand / zero threshold
    thr = pol.threshold_for(mode)
    rows = _rows(st["touch"])
    bl = b.long()
    inc = 1 if pol.write_weight <= 1 else \
        torch.where(is_write, pol.write_weight, 1)
    masked_add(st["touch"], bl, inc, eligible)
    if pol.tracker == "recency":
        masked_set(st["pol_last"], bl, st["step"] >> pol.decay_shift,
                   eligible)
    sc = _scores(pol, st, rows, bl)
    if pol.decider == "topk":
        # epoch-ranked admission: at the epoch edge rank EVERY block's
        # score, carry the k-th highest as the epoch's cut and refill the
        # budget; an access installs only while budget remains and its
        # block clears the cut (and was touched at all)
        if tick:
            scores = _scores(pol, st)
            k = min(int(pol.topk), scores.shape[1])
            kth = top_k(scores, k)[0][:, -1]
            st["pol_cut"].copy_(torch.clamp(kth, min=1))
            st["pol_budget"].fill_(pol.topk)
        go = eligible & (sc >= 1) & (sc >= st["pol_cut"]) \
            & (st["pol_budget"] > 0)
        st["pol_budget"] -= go.to(torch.int32)
    else:
        go = eligible & (sc >= thr)

    masked_set(st["touch"], bl, 0, go)
    if pol.tracker == "mea":
        masked_set(st["pol_ema"], bl, 0, go)

    if tick:
        if pol.tracker == "mea":
            st["pol_ema"].copy_(st["touch"] + (st["pol_ema"] >> 1))
            st["touch"].zero_()
        elif pol.tracker == "recency":
            now = (st["step"] >> pol.decay_shift)[:, None]
            st["touch"].masked_fill_((now - st["pol_last"])
                                     > pol.history_len, 0)
        else:
            st["touch"].bitwise_right_shift_(1)
    return go


def forget(pol: PolicyConfig, st: dict, b, enable) -> dict:
    """Dealloc hint: drop the block's tracker state (Section 3.5 path)."""
    bl = b.long()
    if "touch" in st:
        masked_set(st["touch"], bl, 0, enable)
    if "pol_ema" in st:
        masked_set(st["pol_ema"], bl, 0, enable)
    if "pol_last" in st:
        masked_set(st["pol_last"], bl, _STALE, enable)
    return st
