"""PyTorch port vs the JAX reference: the simulator's dealloc hints
(Section 3.5: recycled entries, freed slots, forgotten tracker state)
under every remap-cache kind, and mea's ``forget`` in flat mode;
``run_many``'s counters and every trace's end state exactly equal
(``test_torch_sim_policy.py``'s ``_assert_runs_match``)."""

import pytest

import repro.core as J
import repro_torch.core as P
from test_torch_sim import _kw
from test_torch_sim_policy import _assert_runs_match
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("name", ["trimma_c", "trimma_f",
                                  "irt_c_conventional", "irt_f_none"])
def test_dealloc_hints_match_reference(name):
    """Section 3.5's dealloc hints (5 % of accesses): recycled entries,
    freed slots, forgotten tracker state, every remap-cache kind."""
    po = _assert_runs_match(_kw(name, dealloc_hints=True), 512,
                            dealloc=True)
    assert po["deallocs"] > 0


def test_dealloc_hints_forget_tracker_state_matches_reference():
    """mea in flat mode with dealloc hints: ``forget`` clears touch and
    ema of freed blocks between ticks."""
    jpol = J.get_policy("mea", decay_shift=6)
    ppol = P.get_policy("mea", decay_shift=6)
    po = _assert_runs_match(_kw("trimma_f", dealloc_hints=True), 512,
                            dealloc=True, policy=(jpol, ppol))
    assert po["deallocs"] > 0
