"""The port's simulator (the plain version on the CPU) against the JAX
reference's recorded results: the golden counters of
``tests/golden/sim_counters.json`` and the Figure 7 sweep's traces of
``tests/golden/sim_fig7_counters.json``, exactly, as
``test_torch_sim.py`` holds runs against the reference itself."""

import json
import os
import zlib

import pytest

import repro_torch.core as P
from repro_torch.core import simulator as p_sim
from torch_threads import one_torch_thread  # noqa: F401

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")

# ---------------------------------------------------------------------------
# golden counters and the paper-size traces
# ---------------------------------------------------------------------------

_SMALL = dict(fast_total_blocks=512, ratio=8, n_sets=4)
_GOLDEN_SCHEMES = {
    "trimma_c": lambda: P.trimma_cache(**_SMALL),
    "trimma_f": lambda: P.trimma_flat(**_SMALL),
    "linear_c": lambda: P.linear_cache(**_SMALL),
    "mempod": lambda: P.mempod(**_SMALL),
    "alloy": lambda: P.alloy(**{**_SMALL, "n_sets": 1}),
    "lohhill": lambda: P.lohhill(**{**_SMALL, "n_sets": 1}),
    "ideal_c": lambda: P.ideal("cache", **_SMALL),
}


@pytest.mark.parametrize("scheme", sorted(_GOLDEN_SCHEMES))
def test_plain_reproduces_golden_counters(scheme):
    """The recipe of tests/golden/gen_golden.py through the port: SMALL
    geometry, ``pr``, 4096 accesses, seed 0, flat traces relabelled."""
    with open(os.path.join(GOLDEN, "sim_counters.json")) as f:
        want = json.load(f)[scheme]
    cfg = _GOLDEN_SCHEMES[scheme]()
    blocks, writes = P.generate_trace(P.WORKLOADS["pr"], cfg.slow_blocks,
                                      4096, 0)
    if cfg.mode == "flat":
        blocks = P.relabel_first_touch(blocks)
    out = P.run(cfg, P.HBM3_DDR5, blocks, writes, device="cpu")
    got = {c: int(out[c]) for c in p_sim.COUNTERS}
    got["metadata_blocks"] = int(out["metadata_blocks"])
    assert got == want, {k: (v, got[k]) for k, v in want.items()
                         if got[k] != v}


def test_traces_reproduce_the_paper_size_sweep():
    """The port's trace copy gives the Figure 7 sweep's traces bit for
    bit (crc32s of tests/golden/sim_fig7_counters.json, written by the
    JAX reference), and each scheme's keywords build a valid config."""
    with open(os.path.join(GOLDEN, "sim_fig7_counters.json")) as f:
        data = json.load(f)
    cfgs = {name: P.SimConfig(**kw).validate()
            for name, kw in data["configs"].items()}
    slow = {c.slow_blocks for c in cfgs.values()}
    assert len(slow) == 1
    n_phys = slow.pop()
    for wl in data["workloads"]:
        b, w = P.generate_trace(P.WORKLOADS[wl], n_phys, data["trace_len"],
                                data["seed"])
        crc = data["trace_crc32"][wl]
        assert zlib.crc32(b.tobytes()) == crc["blocks"], wl
        assert zlib.crc32(P.relabel_first_touch(b).tobytes()) \
            == crc["blocks_flat"], wl
        assert zlib.crc32(w.tobytes()) == crc["writes"], wl
    assert set(data["counters"]) == set(cfgs)
