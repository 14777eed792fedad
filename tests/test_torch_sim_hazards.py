"""PyTorch port vs the JAX reference on the hazard traces of
``sim_hazards``: what the batched ``sim_scan`` kernel must get right (a
block back within 32 accesses, the evicted owner or the displaced home
block accessed next, an IdCache fill right after a store to its sector,
epochs of 1-4 accesses, dealloc hints).  The port's plain loop
(``run_many(..., device="cpu")``) and the reference's ``run`` must give
equal counters and end states; each trace must hit its hazard.  The card
runs the kernel against the plain loop on the same traces
(``test_torch_cuda.py -k hazard``)."""

import numpy as np
import pytest
import torch

import repro.core as J
from repro.core import simulator as j_sim
import repro_torch.core as P
from repro_torch.core import simulator as p_sim
from repro_torch.kernels.sim_scan.ops import sim_scan_op
from repro_torch.kernels.sim_scan.ref import sim_scan_ref
import sim_hazards as hz


def _counts(label, pm):
    return {c: sum(o[c] for o in pm) for c in p_sim.COUNTERS}


@pytest.mark.parametrize("label", hz.CPU_LABELS)
def test_hazard_trace_matches_reference(label):
    """Counters and every integer of each trace's end state exact, two
    traces of 256 accesses at fast_total_blocks 256, 8:1."""
    case = hz.case(label)
    blocks, writes, deallocs, hazards = hz.trace(case)
    _, _, preset, over, _, kind = case
    jcfg = J.SimConfig(**hz.config_kwargs(case),
                       policy=J.get_policy(preset, **over)).validate()
    pcfg = hz.config(case)
    pm = p_sim.run_many(pcfg, P.HBM3_DDR5, blocks, writes, deallocs,
                        device="cpu")
    pst = p_sim.init_state(pcfg, P.make_geometry(pcfg), len(blocks), "cpu")
    sim_scan_op(pcfg, P.HBM3_DDR5, pst, torch.as_tensor(blocks),
                torch.as_tensor(writes), torch.as_tensor(deallocs))
    counters = list(p_sim.COUNTERS)
    for t in range(len(blocks)):
        jo = j_sim.run(jcfg, J.HBM3_DDR5, blocks[t], writes[t], deallocs[t])
        for c in counters + ["metadata_blocks"]:
            assert int(jo[c]) == int(pm[t][c]), (t, c)
        assert set(jo["_state"]) == (set(pst) - {"counters"}) | set(counters)
        for k, v in jo["_state"].items():
            got = pst["counters"][t, counters.index(k)] if k in counters \
                else pst[k][t]
            np.testing.assert_array_equal(
                np.asarray(v).astype(np.int64), got.numpy().astype(np.int64),
                f"trace {t}, {k}")
    # the trace hits its hazard
    n = _counts(label, pm)
    assert hazards > 0
    assert n["installs"] + n["swaps"] > 0
    if kind == "swap_fb_next":
        assert n["swaps"] > 0
    if case[4]:
        assert n["deallocs"] > 0
    if label.startswith("tick"):
        assert pcfg.pol.decay_shift <= 2           # a tick in every batch


def _duplicates(arr: torch.Tensor) -> int:
    """Non-negative tags held twice in one set ([T, sets, ways])."""
    srt = arr.sort(-1).values
    return int(((srt[..., 1:] == srt[..., :-1]) & (srt[..., 1:] >= 0))
               .sum())


@pytest.mark.parametrize("label", ["sector_next/trimma_c",
                                   "repeat/linear_c"])
def test_remap_cache_sets_hold_a_tag_once(label):
    """The kernel's probe takes the matching way by one ballot and one
    shuffle where the reference sums the values of every matching way:
    the two agree only if no set ever holds a tag twice (a fill follows a
    miss; the IdCache refills a present line in place).  Checked after
    every access of the plain loop, on the iRC with a 4-line IdCache that
    churns, and on the conventional cache."""
    case = hz.case(label)
    cfg = hz.config(case)
    blocks, writes, deallocs, _ = hz.trace(case)
    st = p_sim.init_state(cfg, P.make_geometry(cfg), len(blocks), "cpu")
    b, w, d = (torch.as_tensor(x) for x in (blocks, writes, deallocs))
    keys = [k for k in ("rc_tag", "nid_tag", "id_tag") if k in st]
    assert keys
    for i in range(blocks.shape[1]):
        sim_scan_ref(cfg, P.HBM3_DDR5, st, b, w, d, i, i + 1)
        for k in keys:
            assert _duplicates(st[k]) == 0, (i, k)
    assert int(st["counters"][:, p_sim.COUNTERS.index("walks")].sum()) > 0
