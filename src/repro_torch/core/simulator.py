"""Trace-driven hybrid-memory simulator, port of ``repro.core.simulator``.

The access flow of Figure 3/4 for every scheme the paper evaluates:
Trimma-C / Trimma-F (iRT + saved-space caching + iRC), linear-C /
MemPod-F (linear table + conventional remap cache), Alloy and Loh-Hill
(tag matching) and the zero-cost ideal bound.

The reference scans one access per step under ``jax.lax.scan`` and
``vmap``s over traces.  Here the step is written batch-first over a
leading trace axis (``kernels/sim_scan/ref.py``), and the scan is
``kernels/sim_scan``: on a card one kernel launch runs every access of
every trace of a sweep; on the CPU the plain loop runs it.  ``run`` is
``run_many`` at one trace.  Entry points run on the card unless the
caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.sim_scan.ops import is_tagmatch, sim_scan_op
from repro_torch.kernels.sim_scan.ref import (COUNTERS, init_state,
                                              make_step, make_step_tagmatch)

from .config import SimConfig
from .policy.config import PolicyConfig, get_policy
from .remap.geometry import (E, Geometry, home_block, home_slot, leaf_fwd,
                             leaf_inv, make_geometry, static_tables)
from .timing import TimingModel

__all__ = [
    "E", "Geometry", "make_geometry", "static_tables", "leaf_fwd",
    "leaf_inv", "home_slot", "home_block", "COUNTERS", "init_state",
    "make_step", "make_step_tagmatch", "run", "run_many", "derive_metrics",
    "metadata_blocks",
]


def _as_traces(blocks, writes, deallocs, device):
    blocks = np.asarray(blocks)
    writes = np.asarray(writes)
    if blocks.ndim != 2 or blocks.shape != writes.shape:
        raise ValueError("run_many expects [n_traces, trace_len] blocks and "
                         "writes of one shape")
    if deallocs is None:
        deallocs = np.zeros(blocks.shape, bool)
    deallocs = np.asarray(deallocs)
    if deallocs.shape != blocks.shape:
        raise ValueError("deallocs must match blocks")
    return (torch.as_tensor(blocks.astype(np.int32), device=device),
            torch.as_tensor(writes.astype(bool), device=device),
            torch.as_tensor(deallocs.astype(bool), device=device))


def _check_trace(cfg: SimConfig, blocks: np.ndarray):
    if blocks.shape[-1] * 1024 >= 2 ** 31:
        raise ValueError("trace too long for int32 counter headroom")
    if blocks.size and (int(blocks.max()) >= cfg.n_phys
                        or int(blocks.min()) < 0):
        raise ValueError("trace exceeds physical space")


def _scan(cfg, timing, blocks, writes, deallocs, device):
    """The end state of every trace after the whole scan."""
    dev = resolve_device(device)
    _check_trace(cfg, np.asarray(blocks))
    b, w, d = _as_traces(blocks, writes, deallocs, dev)
    g = None if is_tagmatch(cfg) else make_geometry(cfg)
    state = init_state(cfg, g, b.shape[0], dev)
    sim_scan_op(cfg, timing, state, b, w, d)
    return state, g


def _results(cfg, timing, g, host: dict, t: int) -> dict:
    out = {c: int(host["counters"][t, i]) for i, c in enumerate(COUNTERS)}
    out.update(derive_metrics(cfg, timing, out))
    out["metadata_blocks"] = metadata_blocks(
        cfg, g, {"leaf_cnt": host["leaf_cnt"][t]} if "leaf_cnt" in host
        else {})
    return out


def run(cfg: SimConfig, timing: TimingModel, blocks: np.ndarray,
        writes: np.ndarray, deallocs: np.ndarray | None = None,
        device=None) -> dict:
    """Simulate one trace; returns raw counters + derived metrics, and
    the end state under ``_state`` (the reference's keys, one counter
    per key; tensors on the run's device)."""
    deallocs = None if deallocs is None else np.asarray(deallocs)[None]
    state, g = _scan(cfg, timing, np.asarray(blocks)[None],
                     np.asarray(writes)[None], deallocs, device)
    host = {k: v.cpu().numpy() for k, v in state.items()}
    out = _results(cfg, timing, g, host, 0)
    one = {k: v[0] for k, v in state.items() if k != "counters"}
    one.update({c: state["counters"][0, i] for i, c in enumerate(COUNTERS)})
    out["_state"] = one
    return out


def run_many(cfg: SimConfig, timing: TimingModel, blocks: np.ndarray,
             writes: np.ndarray, deallocs: np.ndarray | None = None,
             policies: list | None = None, device=None) -> list[dict] | dict:
    """Simulate T same-length traces (``blocks``/``writes``/``deallocs``
    [T, L]) in one scan: on a card, one kernel launch.  Returns one dict
    per trace with exactly the counters + derived metrics ``run`` gives
    that trace alone.

    ``policies`` sweeps the policy axis: a list of ``PolicyConfig``s or
    preset names; the result becomes ``{policy_name: [per-trace
    dicts]}``, one scan per policy."""
    if policies is not None:
        out = {}
        for p in policies:
            pc = get_policy(p) if not isinstance(p, PolicyConfig) else p
            if pc.name in out:
                raise ValueError(
                    f"duplicate policy name {pc.name!r} in sweep: results "
                    "are keyed by PolicyConfig.name; give variants "
                    "distinct names (dataclasses.replace(pol, name=...))")
            pcfg = dataclasses.replace(cfg, policy=pc)
            out[pc.name] = run_many(pcfg, timing, blocks, writes, deallocs,
                                    device=device)
        return out
    state, g = _scan(cfg, timing, blocks, writes, deallocs, device)
    host = {k: v.cpu().numpy() for k, v in state.items()
            if k in ("counters", "leaf_cnt")}
    return [_results(cfg, timing, g, host, t)
            for t in range(host["counters"].shape[0])]


def metadata_blocks(cfg: SimConfig, g: Geometry | None, state: dict) -> int:
    """Current metadata footprint in fast-tier blocks (Figure 9)."""
    if cfg.meta in ("ideal", "alloy", "lohhill"):
        return 0
    if cfg.meta == "linear" or cfg.irt_levels == 1:
        return cfg.meta_reserved_blocks
    leaf = state["leaf_cnt"]
    alloc = int((leaf > 0).sum())
    return alloc + g.n_inter + g.n_sets  # leaves + intermediates + tag roots


def derive_metrics(cfg: SimConfig, timing: TimingModel, c: dict) -> dict:
    """Loaded-latency timing: per-tier latencies inflate with utilisation
    (1/(1-rho) queueing, solved self-consistently), so bandwidth pressure
    on the slow tier feeds back into AMAT.  Unloaded latencies come from
    Table 1.  The reference's code, on the same int counters."""
    n = max(c["n_acc"], 1)
    t_fast_bw = c["by_fast"] / timing.bw_fast
    t_slow_bw = (c["by_slow_rd"] / timing.bw_slow
                 + c["by_slow_wr"] / (timing.bw_slow / timing.slow_wr_mult))
    lat0 = c["cyc_sram"] + c["cyc_meta"] + c["cyc_fast"] + c["cyc_slow"]
    total = max(lat0 / timing.mlp, t_fast_bw, t_slow_bw)
    for _ in range(12):                      # fixed-point on loaded latency
        rho_f = min(t_fast_bw / max(total, 1e-9), 0.95)
        rho_s = min(t_slow_bw / max(total, 1e-9), 0.95)
        lat = (c["cyc_sram"]
               + (c["cyc_meta"] + c["cyc_fast"]) / (1 - rho_f)
               + c["cyc_slow"] / (1 - rho_s))
        total = max(lat / timing.mlp, t_fast_bw, t_slow_bw)
    t_lat = lat / timing.mlp
    return {
        "amat": lat / n,
        "amat_meta": (c["cyc_sram"] + c["cyc_meta"] / (1 - rho_f)) / n,
        "amat_fast": c["cyc_fast"] / (1 - rho_f) / n,
        "amat_slow": c["cyc_slow"] / (1 - rho_s) / n,
        "serve_rate": c["serve_fast"] / n,
        "rc_hit_rate": c["rc_hit"] / n,
        "rc_id_hit_rate": c["rc_id_hit"] / n,
        "bloat": c["by_fast"] / (n * cfg.access_bytes),
        "t_total": total,
        "t_lat": t_lat, "t_fast_bw": t_fast_bw, "t_slow_bw": t_slow_bw,
        "bound": ["lat", "fast_bw", "slow_bw"][int(np.argmax(
            [t_lat, t_fast_bw, t_slow_bw]))],
    }
