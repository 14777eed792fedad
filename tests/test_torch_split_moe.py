"""The MoE family's split over "model" against the JAX reference and the
unsharded port, in the worker's "moe" spawn of 4 gloo ranks on (2, 2)
and (1, 4): experts over "model" (d_ff where the experts do not divide
it), each data rank on its own rows, its choices ranked after the
earlier ranks'.  The split step against the reference's
``make_sharded_train_step``, the dispatch's kept set and slots against
the reference's ``_moe_tokens``, split serving against the unsharded
port (mixtral's ring cache too), the collectives and
``init_sharded_params``.  Tolerances: those of ``test_torch_sharding.py``;
the dispatch's ids, slots and kept flags and ``init_sharded_params``
exactly, its output within 1e-5.
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_dist_worker as W
from repro.configs import get_config as j_get_config
from repro.configs import reduce_for_smoke as j_reduce
from test_torch_sharding import (LOGIT_ATOL, _check_train, _reference_run,
                                 check_sequence_split, sp_cases,
                                 spawn_fixture)
from torch_threads import one_torch_thread  # noqa: F401

dist_run = spawn_fixture("moe")


@pytest.mark.parametrize("case", range(len(W.MOE_TRAIN_CASES)),
                         ids=["-".join(map(str, c)).replace(" ", "")
                              for c in W.MOE_TRAIN_CASES])
def test_split_moe_train_step_matches_reference(case, dist_run,
                                                monkeypatch):
    """The split MoE step (``TRAIN_STEPS`` steps on 4 ranks: experts over
    "model", each data rank on its own rows, its choices ranked after
    the earlier ranks') against the reference's
    ``make_sharded_train_step`` on one device, with and without
    ``REPRO_MOE_GROUPS=2``, within the sharded step's tolerances.  Split
    by expert where E divides the "model" size, by d_ff where only d_ff
    does (6 experts over 4 ranks); no warning of gathered or repeated
    work."""
    shape, arch, wide, groups, n_exp = W.MOE_TRAIN_CASES[case]
    monkeypatch.setenv("REPRO_MOE_GROUPS", str(groups))
    got = np.load(dist_run / f"moe_train_{case}.npz")
    assert str(got["mode"]) == ("mlp" if n_exp else "expert")
    assert got["split"].tolist() == [True, True, True]
    assert int(got["port_warnings"]) == 0
    _check_train(got, _reference_run((arch, 1, False, 0), wide, n_exp))


@pytest.mark.parametrize("case", **sp_cases("moe"))
def test_sequence_split_moe_by_column(case, dist_run):
    """The MoE layer by d_ff column ("mlp": 6 experts over 4 "model"
    ranks, smoke granite widened on (1, 4)) under the sequence split:
    the rows gathered before the dispatch, the sum over "model" moved
    after the combine as a reduce-scatter, the router and this rank's
    share of the aux terms on ``Partial``; the residual and saved
    activations [B/dp, S/m, d], forward and gradient against the
    unsharded port (``test_torch_sharding.check_sequence_split``)."""
    r = check_sequence_split("moe", case, dist_run)
    assert r["mode"] == "mlp" and r["split"]["moe"]


def _j_moe_dispatch(monkeypatch, jcfg, p, x, groups: int):
    """The reference's routing of x [B, S, d] as ``moe_ffn`` groups it
    (each group through its ``_moe_tokens``, as its vmap does): expert
    ids, slots and kept flags in token-major order over the groups, and
    the output."""
    from repro.models import moe as j_moe

    B, S, d = x.shape
    G = groups if groups > 1 and B % groups == 0 else 1
    real_top_k = jax.lax.top_k
    seen = {}

    def spy(probs, k):
        gate, eidx = real_top_k(probs, k)
        seen["eidx"] = np.asarray(eidx)
        return gate, eidx
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    out = {"eidx": [], "slot": [], "keep": [], "y": []}
    for xg in x.reshape(G, B // G * S, d):
        monkeypatch.setattr(jax.lax, "top_k", spy)
        y, _ = j_moe._moe_tokens(jp, jnp.asarray(xg), jcfg)
        monkeypatch.setattr(jax.lax, "top_k", real_top_k)
        C = j_moe.capacity(jcfg, xg.shape[0])
        flat = seen["eidx"].reshape(-1)
        order = np.argsort(flat, kind="stable")
        first = np.searchsorted(flat[order], np.arange(jcfg.n_experts))
        pos = np.empty_like(flat)
        pos[order] = np.arange(flat.size) - first[flat[order]]
        keep = pos < C
        out["eidx"].append(flat)
        out["slot"].append(np.where(keep, flat * C + pos,
                                    jcfg.n_experts * C))
        out["keep"].append(keep)
        out["y"].append(np.asarray(y))
    return {k: np.concatenate(v) for k, v in out.items()}


def test_split_moe_dispatch_matches_reference(dist_run, monkeypatch):
    """``moe_ffn_split`` with each data rank on its rows, on (4, 1) and
    (2, 2) (experts over the 2 "model" ranks there), a router biased so
    that its first expert overflows, ``REPRO_MOE_GROUPS`` 0 (one
    ranking across every rank) and 2 (groups across 2 ranks on (4, 1),
    on one rank on (2, 2)): the expert ids, the kept set and the slots
    equal the reference's ``_moe_tokens`` on the whole batch exactly, the
    output within 1e-5 (fp32 products in another order), and some
    choices dropped."""
    got = np.load(dist_run / "moe_dispatch.npz")
    jcfg = j_reduce(j_get_config("granite-moe-3b-a800m"))
    p, x = W.moe_dispatch_inputs(W.smoke("granite-moe-3b-a800m"))
    for groups in (0, 2):
        want = _j_moe_dispatch(monkeypatch, jcfg, p, x, groups)
        assert not want["keep"].all()
        for mesh in ("4x1", "2x2"):
            key = f"{mesh}/{groups}"
            for name in ("eidx", "slot", "keep"):
                np.testing.assert_array_equal(got[f"{key}/{name}"],
                                              want[name], err_msg=key)
            np.testing.assert_allclose(got[f"{key}/y"].reshape(-1),
                                       want["y"].reshape(-1), rtol=0,
                                       atol=1e-5, err_msg=key)


@pytest.mark.parametrize("case", range(len(W.MOE_SERVE_CASES)),
                         ids=["-".join(map(str, c)).replace(" ", "")
                              for c in W.MOE_SERVE_CASES])
def test_split_moe_serving_matches_unsharded(case, dist_run):
    """Split ``jit_prefill`` and greedy ``jit_decode`` of the MoE family
    against the unsharded port, as ``test_split_serving_matches_
    unsharded``, with ragged positions and an idle lane; mixtral with
    ``REPRO_WINDOW_CACHE=1`` on both sides keeps a ring of 8 slots, 8 /
    m on each "model" rank, and decodes past it.  No warning of gathered
    or repeated work."""
    shape, _, _, window, ring = W.MOE_SERVE_CASES[case]
    got = json.loads((dist_run / "moe_serve.json").read_text())[case]
    pos0 = W.RING_POS if ring else W.TP_SERVE_POS
    assert got["port_warnings"] == 0
    assert got["tokens"] == got["want_tokens"]
    assert got["pos"] == got["want_pos"] == [p + W.SERVE_STEPS
                                             for p in pos0]
    assert got["logit_gap"] <= LOGIT_ATOL
    assert got["cache_gap"] <= 1e-4
    whole = got["whole"]
    assert whole[2] == (W.RING_WINDOW if ring else W.SERVE_LEN)
    if ring:
        assert max(pos0) + W.SERVE_STEPS > W.RING_WINDOW
    assert got["piece"] == [whole[0], whole[1] // shape[0],
                            whole[2] // shape[1]] + whole[3:]


def test_split_moe_collectives(dist_run):
    """Every collective of one split MoE train step, prefill and decode
    step (smoke granite on (2, 2), the wide one on (1, 4)): on "model"
    none has an expert leaf's piece or layer shape, each is
    activation-sized, and the router's logits or columns are gathered
    (E leads the gathered output) in each phase; on "data" (2 ranks) the
    dispatch's [n, groups, E] int64 counts are gathered in each phase and
    the aux loss's [groups, 2, E] sums all-reduced in the train step
    only; on (1, 4), one data rank, neither runs."""
    info = json.loads((dist_run / "moe_comm.json").read_text())
    for mesh, r in info.items():
        E = r["E"]
        experts = {tuple(sh) for sh in r["experts"]}
        for phase in ("train", "prefill", "decode"):
            calls = r[phase]
            model = [c for c in calls if c[1] == r["groups"]["model"]]
            data = [c for c in calls if c[1] == r["groups"]["data"]]
            for op, _, shapes, _ in model:
                assert not any(tuple(sh) in experts for sh in shapes), (
                    mesh, phase, op, shapes)
                assert max(math.prod(sh) for sh in shapes) <= \
                    r["bounds"][phase], (mesh, phase, op, shapes)
            # the gathered dimension leads the output: [E, T] or [E, d]
            assert any("allgather" in op and shapes[0][0] == E
                       for op, _, shapes, _ in model), (mesh, phase)
            counts = [c for c in data if "allgather" in c[0]
                      and c[2][-1][-1] == E and c[3][-1] == 8 * math.prod(
                          c[2][-1])]
            shares = [c for c in data if "allreduce" in c[0]
                      and c[2][-1][-2:] == [2, E]]
            if mesh == "(1, 4)":
                assert counts == shares == [], (mesh, phase)
                continue
            assert counts, (mesh, phase)
            assert bool(shares) == (phase == "train"), (mesh, phase)


def test_moe_init_sharded_params(dist_run):
    """``init_sharded_params`` of the MoE family on (2, 2) and (1, 4):
    the gathered pieces equal ``init_params``'s draw, each rank keeps
    E / m experts of each expert leaf (and E / m router columns), and no
    op made a tensor larger than one layer of a leaf."""
    info = json.loads((dist_run / "moe_init.json").read_text())
    cfg = W.widen(W.smoke("granite-moe-3b-a800m"), True)
    L, d, ff, E = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.n_experts
    for mesh, r in info.items():
        dp, m = eval(mesh)
        assert r["unequal"] == [], mesh
        assert r["largest"] <= r["layer"], mesh
        assert r["piece"]["blocks/moe/w_gate"] == [L, E // m, d // dp, ff]
        assert r["piece"]["blocks/moe/w_down"] == [L, E // m, ff, d // dp]
        assert r["piece"]["blocks/moe/router"] == [L, d // dp, E // m]
