"""Tensor-parallel compute of the vlm (self and gated cross layers) and
of hubert over "model" against the JAX reference and the unsharded
port, in the worker's "vlm" spawn of 4 gloo ranks on (2, 2) and (1, 4):
the split train step against the reference's (the vlm's cross gates at
``W.VLM_GATE``, its image embeddings seeded; hubert's MLP biases drawn),
the vlm's split prefill and decode against the unsharded port (the image
K/V too), a decode step's collectives, and ``init_sharded_params``.
Tolerances: those of ``test_torch_sharding.py``; ``init_sharded_params``
exactly.
"""

import json

import pytest

import torch_dist_worker as W
from test_torch_sharding import (check_split_serve, check_split_train,
                                 spawn_fixture, split_cases)
from torch_threads import one_torch_thread  # noqa: F401

dist_run = spawn_fixture("vlm")


@pytest.mark.parametrize("case", **split_cases(W.TP_TRAIN_CASES, "vlm"))
def test_split_train_step_matches_reference(case, dist_run):
    """The vlm's and hubert's split step against the reference's
    (``test_torch_sharding.check_split_train``), on (2, 2) and widened on
    (1, 4) with 2 microbatches and int8 error feedback."""
    check_split_train(case, dist_run)


@pytest.mark.parametrize("case", **split_cases(W.TP_SERVE_CASES, "vlm"))
def test_split_serving_matches_unsharded(case, dist_run):
    """The vlm's split serving against the unsharded port
    (``test_torch_sharding.check_split_serve``), its gates at
    ``W.VLM_GATE``, its image K/V gathered and compared too."""
    check_split_serve(case, dist_run)


def test_split_vlm_decode_collectives(dist_run):
    """One split decode step of the vlm on (2, 2) and on (1, 4) (the
    split serving cases, real gloo collectives): on "model", exactly 5
    collectives a self layer (q, k and v gathered, the lse's max and the
    merge, the attention's and the MLP's sums), 2 a cross layer (its
    ``wo``'s and its MLP's sums: the image K/V are read on each rank's
    KV heads, with no gather and no merge) and 1 for the embedding; on
    (1, 4), one data rank, nothing on another group."""
    cfg = W.smoke("llama-3.2-vision-90b")
    ns, inner = cfg.vlm_dims
    seen = 0
    for case, (shape, arch, _, _) in enumerate(W.TP_SERVE_CASES):
        if arch != "llama-3.2-vision-90b":
            continue
        got = json.loads((dist_run / f"tp_serve_{case}.json").read_text())[
            "collectives"]
        assert got["model"] == 5 * ns * inner + 2 * ns + 1, (shape, got)
        if shape[0] == 1:
            assert got["other"] == 0, (shape, got)
        seen += 1
    assert seen == 2


def test_vlm_and_audio_init_sharded_params(dist_run):
    """``init_sharded_params`` of smoke vlm and hubert on (2, 2): the
    gathered pieces equal ``init_params``'s draw exactly; the vlm's self
    stack keeps both layer dimensions whole on every rank and its
    projections split (wq on heads over "model" and on d over "data"),
    hubert's MLP splits on d_ff, its output bias only over "data"."""
    info = json.loads((dist_run / "tp_init.json").read_text())
    vlm, aud = (W.smoke(a) for a in ("llama-3.2-vision-90b",
                                     "hubert-xlarge"))
    ns, inner = vlm.vlm_dims
    d, H, hd = vlm.d_model, vlm.n_heads, vlm.hd
    for arch, r in info.items():
        assert r["unequal"] == [], arch
    pieces = info["llama-3.2-vision-90b"]["piece"]
    assert pieces["blocks/self/attn/wq"] == [ns, inner, d // 2, H // 2, hd]
    assert pieces["blocks/cross/attn/wq"] == [ns, d // 2, H // 2, hd]
    assert pieces["blocks/cross/attn/gate"] == [ns]
    assert pieces["blocks/cross/attn/q_norm"] == [ns, hd]
    pieces = info["hubert-xlarge"]["piece"]
    L, da, ff = aud.n_layers, aud.d_model, aud.d_ff
    assert pieces["blocks/mlp/w_in"] == [L, da // 2, ff // 2]
    assert pieces["blocks/mlp/b_in"] == [L, ff // 2]
    assert pieces["blocks/mlp/b_out"] == [L, da // 2]
    assert "embed" not in pieces and pieces["unembed"] == [aud.vocab // 2,
                                                           da // 2]
