"""PyTorch port vs the JAX reference: the simulator's policy gate
(``repro_torch.core.policy.access``) under every preset, in cache and
flat mode, with epochs short enough that the tick (decay, mea's carry,
recency's staleness, topk's ranked cut and budget) falls several times
in a trace (the dealloc hints, whose ``forget`` clears the tracker
state, in ``test_torch_sim_dealloc.py``).  ``run_many``'s counters and
every trace's end state (the reference's through its vmapped scan, the
same compiled runner ``run_many`` calls; the port's the state its own
``run_many`` scanned to) must be exactly equal."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

import repro.core as J
from repro.core import simulator as j_sim
import repro_torch.core as P
from repro_torch.core import simulator as p_sim
from repro_torch.core.policy import access as p_access
from test_torch_sim import GEOM, _eq, _kw, _traces
from torch_threads import one_torch_thread  # noqa: F401


def _assert_runs_match(kw, length, dealloc=False, policy=None):
    """run_many on two traces, then both end states, against the
    reference; ``policy`` a (reference, port) pair of PolicyConfigs.
    The port's end state is the one its ``run_many`` computed (the scan
    ``simulator._scan`` returned to it), not a second scan."""
    jkw, pkw = dict(kw), dict(kw)
    if policy is not None:
        jkw["policy"], pkw["policy"] = policy
    jcfg = J.SimConfig(**jkw).validate()
    pcfg = P.SimConfig(**pkw).validate()
    blocks, writes, deallocs = _traces(pcfg, length, dealloc=dealloc)
    if deallocs is None:
        deallocs = np.zeros(blocks.shape, bool)
    jm = j_sim.run_many(jcfg, J.HBM3_DDR5, blocks, writes, deallocs)
    scanned, real = [], p_sim._scan

    def kept(*a, **kw):
        scanned.append(real(*a, **kw))
        return scanned[-1]
    p_sim._scan = kept
    try:
        pm = p_sim.run_many(pcfg, P.HBM3_DDR5, blocks, writes, deallocs,
                            device="cpu")
    finally:
        p_sim._scan = real
    assert len(scanned) == 1
    for t, (a, b) in enumerate(zip(jm, pm)):
        for c in list(j_sim.COUNTERS) + ["metadata_blocks"]:
            assert a[c] == b[c], (t, c)
    runner, _ = j_sim._compiled_many(jcfg, J.HBM3_DDR5)
    jst = runner(jnp.asarray(blocks, jnp.int32), jnp.asarray(writes),
                 jnp.asarray(deallocs))
    pst = scanned[0][0]
    counters = list(p_sim.COUNTERS)
    assert set(jst) == (set(pst) - {"counters"}) | set(counters)
    for k, v in jst.items():
        got = pst["counters"][:, counters.index(k)] if k in counters \
            else pst[k]
        _eq(v, got.numpy(), k)
    return pm[0]


@pytest.mark.parametrize("mode", ["trimma_c", "trimma_f"])
@pytest.mark.parametrize("preset", sorted(P.PRESETS))
def test_every_preset_matches_reference(preset, mode):
    """448 accesses, epochs of 64 (decay_shift 6): seven ticks."""
    kw = _kw(mode)
    jpol = J.get_policy(preset, decay_shift=6)
    ppol = P.get_policy(preset, decay_shift=6)
    po = _assert_runs_match(kw, 448, policy=(jpol, ppol))
    assert po["n_acc"] == 448


def test_topk_default_epochs_match_reference():
    """topk at its own 256-access epochs with a budget of 2, on the
    conventional-cache linear scheme (a second table kind under the
    ranked gate)."""
    jpol = J.get_policy("topk", topk=2)
    ppol = P.get_policy("topk", topk=2)
    po = _assert_runs_match(_kw("linear_c"), 768, policy=(jpol, ppol))
    assert 0 < po["installs"] <= 2 * 3


def test_recency_window_of_one_epoch_matches_reference():
    """recency with a one-epoch window: stale counters drop at every
    tick."""
    jpol = J.get_policy("recency", decay_shift=5, history_len=1)
    ppol = P.get_policy("recency", decay_shift=5, history_len=1)
    _assert_runs_match(_kw("mempod"), 512, policy=(jpol, ppol))


def test_policy_sweep_through_run_many():
    """``run_many(policies=...)`` keys results by policy name, one scan
    per policy, each equal to that policy's own run_many."""
    cfg = P.trimma_cache(**GEOM)
    blocks, writes, _ = _traces(cfg, 128)
    pols = ["threshold", P.get_policy("mea", decay_shift=4)]
    out = P.run_many(cfg, P.HBM3_DDR5, blocks, writes, policies=pols,
                     device="cpu")
    assert set(out) == {"threshold", "mea"}
    one = P.run_many(dataclasses.replace(cfg, policy=pols[1]), P.HBM3_DDR5,
                     blocks, writes, device="cpu")
    assert out["mea"] == one
    with pytest.raises(ValueError, match="duplicate"):
        P.run_many(cfg, P.HBM3_DDR5, blocks, writes,
                   policies=["mea", "mea"], device="cpu")


def test_tracked_keys_match_reference():
    from repro.core.policy import access as j_access
    for name in P.PRESETS:
        for mode in ("cache", "flat"):
            assert p_access.tracked_keys(P.get_policy(name), mode) \
                == j_access.tracked_keys(J.get_policy(name), mode)
