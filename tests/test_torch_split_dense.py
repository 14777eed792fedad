"""Tensor-parallel compute of the dense family over "model" against the
JAX reference and the unsharded port, in the worker's "dense" spawn of 4
gloo ranks (``tests/torch_dist_worker.py``) on (2, 2) and on a (1, 4)
mesh of the same ranks: the split train step of smoke qwen2-7b (QKV
bias) and of smoke llama3-8b and qwen2-7b widened to 8 heads over 4 KV
heads against the reference's step (plain, and 2 microbatches with int8
error feedback), smoke llama3-8b on (1, 4), whose 2 KV heads do not
split over 4 ranks (attention runs whole, with one warning); split
prefill and decode against the unsharded port with ragged positions, an
idle lane and a window; the collectives of a split train step, prefill
and decode step (none on "model" moves a parameter piece or the cache,
and each is activation-sized); ``init_sharded_params`` against
``init_params``.  Tolerances: those of ``test_torch_sharding.py`` (its
``check_split_train`` and ``check_split_serve``); ``init_sharded_params``
exactly.
"""

import json
import math

import pytest

import torch_dist_worker as W
from test_torch_sharding import (check_sequence_split, check_split_serve,
                                 check_split_train, sp_cases, spawn_fixture,
                                 split_cases)
from torch_threads import one_torch_thread  # noqa: F401

dist_run = spawn_fixture("dense")


@pytest.mark.parametrize("case", **split_cases(W.TP_TRAIN_CASES, "dense"))
def test_split_train_step_matches_reference(case, dist_run):
    """The dense family's split step against the reference's
    (``test_torch_sharding.check_split_train``): smoke qwen2-7b on
    (2, 2), llama3-8b and qwen2-7b widened on (1, 4), llama3-8b on
    (1, 4) with attention whole."""
    check_split_train(case, dist_run)


@pytest.mark.parametrize("case", **split_cases(W.TP_SERVE_CASES, "dense"))
def test_split_serving_matches_unsharded(case, dist_run):
    """The dense family's split serving against the unsharded port
    (``test_torch_sharding.check_split_serve``), one case with a
    6-token window."""
    check_split_serve(case, dist_run)


@pytest.mark.parametrize("case", **sp_cases("dense"))
def test_sequence_split_residual_and_gradient(case, dist_run):
    """The residual stream splits by sequence over "model" where its 16
    tokens divide the "model" size (smoke llama3-8b on (2, 2), widened on
    (1, 4), with attention whole on (1, 4), and with a vocabulary of 514
    that runs whole) and not at 18 tokens on (1, 4): the residual and
    the saved activations are [B/dp, S/m, d] or [B/dp, S, d], and the
    forward and gradient match the unsharded port
    (``test_torch_sharding.check_sequence_split``)."""
    r = check_sequence_split("dense", case, dist_run)
    shape, _, wide, _, vocab, _ = W.SP_CASES["dense"][case]
    assert r["split"]["attn"] == (wide or shape == (2, 2))
    assert r["split"]["vocab"] == (vocab == 0)


def test_split_collectives_are_activation_sized(dist_run):
    """Every collective on the "model" group in one split train step, one
    prefill and one decode step (smoke llama3-8b on (2, 2), the wide one
    on (1, 4)): there are some in each, none has a parameter piece's, a
    parameter layer's or a cache piece's shape, and each is
    activation-sized: [B/dp, S, d] or smaller, and in decode at most one
    token's q, k and v ([B/dp, H + 2 KV, hd], gathered in one call) or
    the [B/dp, H, hd + 1] merge."""
    info = json.loads((dist_run / "comm.json").read_text())
    for mesh in ("(2, 2)", "(1, 4)"):
        r = info[mesh]
        forbidden = {tuple(f) for f in r["forbidden"]}
        for phase in ("train", "prefill", "decode"):
            calls = r[phase]
            assert calls, (mesh, phase)
            for op, _, shapes, _ in calls:
                assert not any(tuple(sh) in forbidden for sh in shapes), (
                    mesh, phase, op, shapes)
                assert max(math.prod(sh) for sh in shapes) <= \
                    r["bounds"][phase], (mesh, phase, op, shapes)


def test_split_step_remat_gathers_again(dist_run):
    """The split step under remat "full" gives remat "none"'s data-mean
    gradient bit for bit, and its backward gathers each layer's pieces
    over "data" again: smoke llama3-8b's 2 layers of 9 leaves, each
    gathered once more (18 all-gathers beyond the forward's)."""
    info = json.loads((dist_run / "remat.json").read_text())
    assert info["max_diff"] == 0.0
    g = info["gathers"]
    assert g["full"] - g["none"] == 18, g


def test_init_sharded_params_pieces_and_sizes(dist_run):
    """``init_sharded_params`` on (2, 2) and (1, 4): the gathered pieces
    equal ``init_params``'s draw, and no op made a tensor larger than one
    layer of a leaf (the embedding tables are one layer), nor one of a
    split layer-stacked leaf's whole shape."""
    info = json.loads((dist_run / "init.json").read_text())
    for mesh, r in info.items():
        assert r["unequal"] == [], mesh
        shapes = {tuple(sh) for sh in r["shapes"]}
        assert max(math.prod(sh) for sh in shapes) <= max(
            r["layer"].values()), mesh
        pieces = {tuple(p) for p in r["piece"].values()}
        split = [k for k, w in r["whole"].items() if k.startswith("blocks/")
                 and math.prod(r["piece"][k]) < math.prod(w)]
        assert split, mesh
        for k in split:
            w = tuple(r["whole"][k])
            assert w not in shapes or w in pieces, (mesh, k)
