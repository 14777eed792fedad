"""PyTorch port vs the JAX reference: the trace-driven simulator's plain
version (``repro_torch.core.simulator`` on the CPU, the batch-first step
of ``kernels/sim_scan/ref.py``), its remap-cache kinds, its traces and
its metrics.  Counters and every integer of the end state must be
exactly equal."""


import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
from repro.core import simulator as j_sim
from repro.core.remap import rcache as j_rc
from repro.obs import metrics as j_metrics
import repro_torch.core as P
from repro_torch.core import simulator as p_sim
from repro_torch.core.remap import rcache as p_rc
from repro_torch.obs import metrics as p_metrics
from torch_threads import one_torch_thread  # noqa: F401

GEOM = dict(fast_total_blocks=256, ratio=8, n_sets=4)


def _eq(jx, tx, what=""):
    np.testing.assert_array_equal(np.asarray(jx).astype(np.int64),
                                  np.asarray(tx).astype(np.int64), what)


def _traces(cfg, length, wls=("pr", "xz"), seed=1, dealloc=False):
    """[T, L] numpy traces over ``cfg``'s slow tier (relabelled by first
    touch in flat mode), and dealloc hints when asked."""
    bs, ws = [], []
    for wl in wls:
        b, w = P.generate_trace(P.WORKLOADS[wl], cfg.slow_blocks, length,
                                seed)
        bs.append(P.relabel_first_touch(b) if cfg.mode == "flat" else b)
        ws.append(w)
    blocks, writes = np.stack(bs), np.stack(ws)
    deallocs = None
    if dealloc:
        deallocs = np.stack([P.with_deallocs(b, 0.05, seed=i)
                             for i, b in enumerate(blocks)])
    return blocks, writes, deallocs


# ---------------------------------------------------------------------------
# run / run_many against the reference, end state included
# ---------------------------------------------------------------------------

# (mode, meta, remap cache): every table scheme and remap-cache kind
_SCHEMES = {
    "trimma_c": ("cache", "irt", "irc"),
    "trimma_f": ("flat", "irt", "irc"),
    "linear_c": ("cache", "linear", "conventional"),
    "mempod": ("flat", "linear", "conventional"),
    "irt_c_conventional": ("cache", "irt", "conventional"),
    "irt_f_none": ("flat", "irt", "none"),
    "irt_c_ideal": ("cache", "irt", "ideal"),
    "ideal_f": ("flat", "ideal", "ideal"),
    "alloy": ("cache", "alloy", "none"),
    "lohhill": ("cache", "lohhill", "none"),
}


def _kw(name, **over):
    mode, meta, rc = _SCHEMES[name]
    kw = dict(GEOM, mode=mode, meta=meta, remap_cache=rc)
    if meta in ("alloy", "lohhill"):
        kw["n_sets"] = 1
    kw.update(over)
    return kw


def _assert_runs_match(kw, length, dealloc=False, policy=None):
    """``policy``: a preset name, built on each side, or a (reference,
    port) pair of PolicyConfigs."""
    jkw, pkw = dict(kw), dict(kw)
    if isinstance(policy, str):
        policy = (J.get_policy(policy), P.get_policy(policy))
    if policy is not None:
        jkw["policy"], pkw["policy"] = policy
    jcfg = J.SimConfig(**jkw).validate()
    pcfg = P.SimConfig(**pkw).validate()
    blocks, writes, deallocs = _traces(pcfg, length, dealloc=dealloc)
    d0 = None if deallocs is None else deallocs[0]
    jo = j_sim.run(jcfg, J.HBM3_DDR5, blocks[0], writes[0], d0)
    po = p_sim.run(pcfg, P.HBM3_DDR5, blocks[0], writes[0], d0,
                   device="cpu")
    for c in list(j_sim.COUNTERS) + ["metadata_blocks"]:
        assert int(jo[c]) == int(po[c]), c
    assert set(jo["_state"]) == set(po["_state"])
    for k, v in jo["_state"].items():
        _eq(v, po["_state"][k].numpy(), k)
    jm = j_sim.run_many(jcfg, J.HBM3_DDR5, blocks, writes, deallocs)
    pm = p_sim.run_many(pcfg, P.HBM3_DDR5, blocks, writes, deallocs,
                        device="cpu")
    for t, (a, b) in enumerate(zip(jm, pm)):
        for c in list(j_sim.COUNTERS) + ["metadata_blocks"]:
            assert a[c] == b[c], (t, c)
    return po


@pytest.mark.parametrize("name", sorted(_SCHEMES))
def test_run_and_run_many_match_reference(name):
    """Counters exact and the end state exact as integers, every scheme
    and remap-cache kind, 768 accesses at fast_total_blocks 256, 8:1
    (Trimma-C's run force-evicts: metadata priority, Section 3.3)."""
    po = _assert_runs_match(_kw(name), 768)
    if name == "trimma_c":
        assert po["forced_evict"] > 0


def test_flat_swaps_and_lendable_installs_match_reference():
    """A flat run that swaps into data slots and copies into lendable
    metadata slots (the on-demand policy)."""
    po = _assert_runs_match(_kw("trimma_f"), 768, policy="on_demand")
    assert po["swaps"] > 0 and po["installs"] > 0


def test_tag_ways_sweep_matches_reference():
    """Figure 1's tag-matching sweep: more ways than a warp's lanes."""
    _assert_runs_match(_kw("lohhill", tag_ways=64), 768)


@pytest.mark.parametrize("name", ["trimma_c", "trimma_f", "alloy"])
def test_run_many_equals_separate_runs(name):
    """T traces in one scan == T scans of one trace (no lane reaches
    another trace's state)."""
    cfg = P.SimConfig(**_kw(name)).validate()
    blocks, writes, _ = _traces(cfg, 256, wls=("pr", "xz", "lbm"))
    many = p_sim.run_many(cfg, P.HBM3_DDR5, blocks, writes, device="cpu")
    for t in range(len(blocks)):
        one = p_sim.run(cfg, P.HBM3_DDR5, blocks[t], writes[t],
                        device="cpu")
        for c in list(p_sim.COUNTERS) + ["metadata_blocks"]:
            assert many[t][c] == one[c], (t, c)


def test_scan_ranges_continue_one_another():
    """[0, a) then [a, L) of the plain scan == one [0, L) scan."""
    from repro_torch.kernels.sim_scan.ops import sim_scan_op
    cfg = P.trimma_cache(**GEOM, policy=P.get_policy("mea", decay_shift=5))
    blocks, writes, _ = _traces(cfg, 300)
    b = torch.as_tensor(blocks.astype(np.int32))
    w = torch.as_tensor(writes)
    d = torch.zeros_like(w)
    g = P.make_geometry(cfg)
    one = p_sim.init_state(cfg, g, 2, "cpu")
    sim_scan_op(cfg, P.HBM3_DDR5, one, b, w, d)
    two = p_sim.init_state(cfg, g, 2, "cpu")
    sim_scan_op(cfg, P.HBM3_DDR5, two, b, w, d, 0, 97)
    sim_scan_op(cfg, P.HBM3_DDR5, two, b, w, d, 97, 300)
    for k in one:
        assert torch.equal(one[k], two[k]), k


def test_entry_points_default_to_the_card():
    cfg = P.trimma_cache(**GEOM)
    blocks, writes, _ = _traces(cfg, 8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            p_sim.run(cfg, P.HBM3_DDR5, blocks[0], writes[0])


# ---------------------------------------------------------------------------
# remap-cache kinds (core/remap/rcache) against the reference's ops
# ---------------------------------------------------------------------------

def _rc_stream(rng, n_ops, n_lanes, n_blocks, n_slots):
    """Batched ops with random enables and in-batch duplicates."""
    for _ in range(n_ops):
        kind = rng.choice(["fill", "invalidate", "probe", "range"],
                          p=[0.4, 0.3, 0.25, 0.05])
        ids = rng.integers(0, n_blocks, n_lanes).astype(np.int32)
        ids[rng.random(n_lanes) < 0.2] = ids[0]       # same-set lanes
        en = rng.random(n_lanes) < 0.8
        table = np.where(rng.random(n_blocks) < 0.5, -1,
                         rng.integers(0, n_slots, n_blocks)).astype(np.int32)
        lo = int(rng.integers(0, n_blocks))
        yield (kind, ids, en, table, bool(rng.random() < 0.5), lo,
               lo + int(rng.integers(1, 70)))


@pytest.mark.parametrize("kind", ["irc", "conventional", "none", "ideal"])
def test_rcache_kinds_match_reference_batched(kind):
    """Every op of every kind on N = 8 lanes (random enables, lanes
    sharing a set) gives the reference's probe results and arrays."""
    geo = dict(kind=kind, rc_sets=8, rc_ways=4, nid_sets=8, nid_ways=3,
               id_sets=4, id_ways=2)
    jg, pg = j_rc.RemapCacheGeometry(**geo), p_rc.RemapCacheGeometry(**geo)
    js, ps = j_rc.init_state(jg), p_rc.init_state(pg)
    assert set(js) == set(ps)
    rng = np.random.default_rng(7)
    for op in _rc_stream(rng, 150, 8, 512, 64):
        name, ids, en, table, bi, lo, hi = op
        jid, pid = jnp.asarray(ids), torch.as_tensor(ids)
        jen, pen = jnp.asarray(en), torch.as_tensor(en)
        if name == "probe":
            for a, b in zip(j_rc.probe(jg, js, jid),
                            p_rc.probe(pg, ps, pid)):
                _eq(a, b.numpy(), name)
            continue
        if name == "fill":
            dev = table[ids]
            js = {**js, **j_rc.fill(jg, js, jid, jnp.asarray(dev),
                                    jnp.asarray(table), jen)}
            ps = {**ps, **p_rc.fill(pg, ps, pid, torch.as_tensor(dev),
                                    torch.as_tensor(table), pen)}
        elif name == "invalidate":
            js = {**js, **j_rc.invalidate(jg, js, jid, jen, bi)}
            ps = {**ps, **p_rc.invalidate(pg, ps, pid, pen, bi)}
        else:
            js = {**js, **j_rc.invalidate_range(jg, js, lo, hi, bi)}
            ps = {**ps, **p_rc.invalidate_range(pg, ps, lo, hi, bi)}
        for k in js:
            _eq(js[k], ps[k].numpy(), f"{name} {k}")


@pytest.mark.parametrize("kind", ["irc", "conventional"])
def test_rcache_trace_rows_equal_one_cache_per_trace(kind):
    """The simulator's layout (one cache per trace, the arrays flattened
    to [T * sets, ...], lane t at ``row`` t) == each trace's cache under
    the one-cache ops, a disabled lane included."""
    geo = dict(kind=kind, rc_sets=8, rc_ways=4, nid_sets=8, nid_ways=3,
               id_sets=4, id_ways=2)
    g = p_rc.RemapCacheGeometry(**geo)
    T = 3
    batched = p_rc.init_state(g, n_traces=T)
    single = [p_rc.init_state(g) for _ in range(T)]
    rows = torch.arange(T)
    rng = np.random.default_rng(5)
    tables = [np.where(rng.random(512) < 0.5, -1, rng.integers(0, 64, 512))
              .astype(np.int32) for _ in range(T)]
    tab = torch.as_tensor(np.stack(tables))

    def flat():
        return {k: v.flatten(0, 1) for k, v in batched.items()}

    def store(out):
        batched.update({k: v.view(batched[k].shape)
                        for k, v in out.items()})

    for op in _rc_stream(rng, 120, T, 512, 64):
        name, ids, en, _, bi, _, _ = op
        if name == "range":
            continue
        pid, pen = torch.as_tensor(ids), torch.as_tensor(en)
        if name == "probe":
            got = p_rc.probe(g, flat(), pid, row=rows)
            for t in range(T):
                want = p_rc.probe(g, single[t], pid[t:t + 1])
                for a, b in zip(got, want):
                    assert a[t].item() == b[0].item()
            continue
        for t in range(T):
            one = pid[t:t + 1]
            if name == "fill":
                single[t] = {**single[t], **p_rc.fill(
                    g, single[t], one, tab[t][one.long()], tab[t],
                    pen[t:t + 1])}
            else:
                single[t] = {**single[t], **p_rc.invalidate(
                    g, single[t], one, pen[t:t + 1], bi)}
        if name == "fill":
            store(p_rc.fill(g, flat(), pid, tab[rows, pid.long()], tab, pen,
                            row=rows))
        else:
            store(p_rc.invalidate(g, flat(), pid, pen, bi, row=rows))
        for k in batched:
            for t in range(T):
                assert torch.equal(batched[k][t], single[t][k]), (name, k)


def test_rcache_from_sim_config():
    cfg = P.mempod(**GEOM)
    g = p_rc.RemapCacheGeometry.from_sim_config(cfg)
    jg = j_rc.RemapCacheGeometry.from_sim_config(J.mempod(**GEOM))
    assert g.kind == jg.kind == "conventional"
    assert (g.rc_sets, g.rc_ways) == (jg.rc_sets, jg.rc_ways)
    with pytest.raises(ValueError):
        p_rc.RemapCacheGeometry(kind="bogus")


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def test_derive_metrics_and_sim_metrics_equal_reference():
    """Host Python on the int counters: the same floats, the same
    canonical names, under both timing models."""
    cfg = P.trimma_flat(**GEOM)
    blocks, writes, _ = _traces(cfg, 512)
    out = p_sim.run(cfg, P.HBM3_DDR5, blocks[0], writes[0], device="cpu")
    counters = {c: out[c] for c in p_sim.COUNTERS}
    for jt, pt in ((J.HBM3_DDR5, P.HBM3_DDR5), (J.DDR5_NVM, P.DDR5_NVM)):
        want = j_sim.derive_metrics(J.trimma_flat(**GEOM), jt, counters)
        assert p_sim.derive_metrics(cfg, pt, counters) == want
    assert p_metrics.sim_metrics(counters) == j_metrics.sim_metrics(counters)
    assert p_metrics.sim_metrics(out)["sim_rc_misses_total"] \
        == out["n_acc"] - out["rc_hit"]
