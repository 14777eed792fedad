"""Tensor-parallel compute of the recurrent families over "model" against
the JAX reference and the unsharded port, in the worker's "recurrent"
spawn of 4 gloo ranks (``tests/torch_dist_worker.py``) on (2, 2) and on
a (1, 4) mesh of the same ranks.

hymba-1.5b (family "hybrid") splits its Mamba branch over d_inner: each
rank runs its channels of x and z (``in_proj`` gathered over "model", its x
and z columns taken; in decode its products with each rank's piece), dt, B
and C summed over "model", ``out_proj`` row-split; attention splits by
heads where its KV heads divide the "model" ranks (smoke on (2, 2), widened
on (1, 4)) and runs whole with a warning where they do not (smoke on
(1, 4)); the MLP on d_ff, the vocabulary.  xlstm-125m (family "ssm") splits
both branches by heads, 2 or 1 a rank.  The split train step against the
reference's ``make_sharded_train_step``; split prefill (the reference's
cold state) and decode (hymba's window of 6 on every second layer) against
the unsharded port, the recurrent states gathered and compared; a decode
step's collectives counted exactly; ``init_sharded_params`` against
``init_params``; ``fit(mesh=)`` against the split step; the launchers'
``--mesh host``.

Tolerances: those of ``test_torch_sharding.py`` (its
``check_split_train`` and ``check_split_serve``: logits within 1e-5, the
states within 1e-4); the cold prefill state, ``init_sharded_params`` and
``fit``'s loss exactly.
"""

import json

import numpy as np
import pytest

import torch_dist_worker as W
from test_torch_sharding import (attn_whole, check_sequence_split,
                                 check_split_serve, check_split_train,
                                 sp_cases, spawn_fixture, split_cases)
from torch_threads import one_torch_thread  # noqa: F401

dist_run = spawn_fixture("recurrent")


@pytest.mark.parametrize("case", **split_cases(W.TP_TRAIN_CASES,
                                               "recurrent"))
def test_split_train_step_matches_reference(case, dist_run):
    """hymba's and xlstm's split step against the reference's
    (``test_torch_sharding.check_split_train``): hymba on (2, 2) with
    attention split, and on (1, 4) with attention whole (one warning),
    2 microbatches and int8 error feedback, its x and z columns of
    ``in_proj`` on different ranks; xlstm on (2, 2) and (1, 4); no
    warning of gathered work."""
    check_split_train(case, dist_run)


@pytest.mark.parametrize("case", **sp_cases("recurrent"))
def test_sequence_split_hybrid(case, dist_run):
    """hymba on (1, 4) under the sequence split: attention whole (its 2
    KV heads) beside the Mamba branch on this rank's channels, both fed
    by one gather of the normed rows, attention's rows cut from its
    whole output; the residual and saved activations [B/dp, S/m, d],
    forward and gradient against the unsharded port
    (``test_torch_sharding.check_sequence_split``)."""
    r = check_sequence_split("recurrent", case, dist_run)
    assert not r["split"]["attn"] and r["split"]["ssm"]


@pytest.mark.parametrize("case", **split_cases(W.TP_SERVE_CASES,
                                               "recurrent"))
def test_split_serving_matches_unsharded(case, dist_run):
    """hymba's and xlstm's split serving against the unsharded port
    (``test_torch_sharding.check_split_serve``); besides: the prefill's
    state is the reference's cold one (``pos`` 0 on every lane, the
    caches and recurrent states zero, gathered equal to the unsharded
    port's exactly), and each rank holds its lanes of every recurrent
    state leaf, whole over "model"."""
    shape, arch, wide, _ = W.TP_SERVE_CASES[case]
    got = check_split_serve(case, dist_run)
    assert got["prefill_pos"] == [[0] * W.SERVE_B] * 2
    assert got["prefill_gap"] == 0.0
    recurrent = [k for k in got["pieces"] if k not in ("k", "v")]
    assert recurrent, got["pieces"]
    for k in recurrent:
        whole = got["wholes"][k]
        assert got["pieces"][k] == [whole[0], whole[1] // shape[0]] \
            + whole[2:], (k, got["pieces"][k], whole)


def _want_calls(shape, arch, wide) -> dict:
    """A decode step's collectives on "model" by kind, and the element
    count of the recurrent state's gather, for a split serving case."""
    cfg = W.widen(W.smoke(arch), wide)
    L, m, B = cfg.n_layers, shape[1], W.SERVE_B // shape[0]
    if cfg.family == "ssm":
        # each layer: the output's sum, the state's gather (the mLSTM's
        # C, n and m, or the sLSTM's h, c, n and m); the embedding's sum
        H, hd = cfg.n_heads // m, cfg.d_model // cfg.n_heads
        flags = [i % cfg.slstm_every == cfg.slstm_every - 1
                 for i in range(L)]
        sizes = sorted({B * H * (4 * hd if f else hd * hd + hd + 1)
                        for f in flags})
        return {"allreduce": L + 1, "allgather": L, "state": sizes}
    split = not attn_whole(shape, arch, wide)
    # attention whole: its leaves that spec_for split (the heads that
    # divide the ranks) gathered over "model" with the layer
    whole = 0 if split else sum(n % m == 0 for n in (
        cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads, cfg.n_heads))
    di = cfg.d_model // m
    # each layer: q, k and v gathered (attention split), the lse's max
    # and the merge, wo's sum (split); in_proj's products gathered,
    # dt/B/C summed, out_proj summed, the state (h and conv) gathered;
    # the MLP's sum; and the embedding's sum
    return {"allgather": L * (int(split) + 2 + whole),
            "allreduce": L * (2 + int(split) + 3) + 1,
            "state": [B * (di * cfg.ssm_state + (cfg.ssm_conv - 1) * di)]}


def test_split_recurrent_decode_collectives(dist_run):
    """One split decode step of every hymba and xlstm serving case (real
    gloo collectives, ``CollectiveLog``): on "model", exactly the
    all-gathers and all-reduces ``_want_calls`` counts (hymba 7 a layer
    with attention whole, and its wq and wo gathered, 9 split; xlstm 2 a
    layer; and the embedding's sum), the recurrent state gathered in ONE
    all-gather a layer of its packed fp32 pieces, no piece of hymba's
    ``in_proj`` moved; on (1, 4), one data rank, nothing on another
    group."""
    seen = 0
    for case in W.group_cases(W.TP_SERVE_CASES, "recurrent"):
        shape, arch, wide, _ = W.TP_SERVE_CASES[case]
        got = json.loads((dist_run / f"tp_serve_{case}.json").read_text())
        want = _want_calls(shape, arch, wide)
        model = [c for c in got["calls"] if c[1] == "model"]
        kinds = {k: sum(k in op for op, _, _ in model)
                 for k in ("allgather", "allreduce")}
        assert kinds == {k: want[k] for k in kinds}, (case, kinds, want)
        assert len(model) == sum(kinds.values()) == \
            got["collectives"]["model"], (case, model)
        # a gathered state piece: its input is one flat fp32 tensor
        state = sorted({shapes[-1][0] for op, _, shapes in model
                        if "allgather" in op and len(shapes[-1]) == 1})
        assert state == want["state"], (case, state, want)
        # no piece of in_proj [d, 2 di/m] leaves its rank: its products
        # with the tokens are gathered
        d = W.widen(W.smoke(arch), wide).d_model
        piece = {(d, 2 * d // shape[1]), (2 * d // shape[1], d)}
        assert not [c for c in model if tuple(c[2][-1]) in piece], case
        if shape[0] == 1:
            assert got["collectives"]["other"] == 0, case
        seen += 1
    assert seen == 5


def test_hybrid_and_ssm_init_sharded_params(dist_run):
    """``init_sharded_params`` of smoke hymba and xlstm on (2, 2) and
    (1, 4): the gathered pieces equal ``init_params``'s draw exactly;
    hymba's Mamba leaves hold d_inner / m channels ("embed" over "data"),
    ``in_proj`` its contiguous piece of the [d, 2 di] matrix; xlstm's
    leaves hold H / m heads, ``m_og`` d / m columns, ``m_out`` and
    ``s_out`` d / m rows."""
    info = json.loads((dist_run / "rec_init.json").read_text())
    for key, r in info.items():
        assert r["unequal"] == [], key
    hy = W.smoke("hymba-1.5b")
    L, d, K, st = hy.n_layers, hy.d_model, hy.ssm_conv, hy.ssm_state
    r = max(d // 16, 1)
    for dp, m in ((2, 2), (1, 4)):
        p = info[f"hymba-1.5b {(dp, m)}"]["piece"]
        assert p["blocks/ssm/in_proj"] == [L, d // dp, 2 * d // m]
        assert p["blocks/ssm/conv_w"] == [L, K, d // m]
        assert p["blocks/ssm/x_proj"] == [L, d // m, r + 2 * st]
        assert p["blocks/ssm/dt_proj"] == [L, r, d // m]
        assert p["blocks/ssm/A_log"] == [L, d // m, st]
        assert p["blocks/ssm/D"] == p["blocks/ssm/dt_bias"] == [L, d // m]
        assert p["blocks/ssm/out_proj"] == [L, d // m, d // dp]
    xl = W.smoke("xlstm-125m")
    L, d, H = xl.n_layers, xl.d_model, xl.n_heads
    hd = d // H
    for dp, m in ((2, 2), (1, 4)):
        p = info[f"xlstm-125m {(dp, m)}"]["piece"]
        assert p["blocks/m_qkv"] == [L, d // dp, 3, H // m, hd]
        assert p["blocks/s_w"] == [L, d // dp, 4, H // m, hd]
        assert p["blocks/m_if"] == [L, d // dp, 2, H // m]
        assert p["blocks/m_if_b"] == [L, 2, H // m]
        assert p["blocks/s_r"] == [L, H // m, hd, 4, hd]
        assert p["blocks/s_b"] == [L, 4, H // m, hd]
        assert p["blocks/m_og"] == [L, d // dp, d // m]
        assert p["blocks/m_out"] == p["blocks/s_out"] == [L, d // m, d // dp]


def test_recurrent_fit_on_a_mesh(dist_run):
    """``fit(mesh=)`` of smoke hymba and xlstm on (2, 2), its parameters
    drawn by ``init_sharded_params``, reaches the split step's loss and
    gradient norm from ``init_params`` on the same batches, exactly."""
    info = json.loads((dist_run / "rec_fit.json").read_text())
    for arch, r in info.items():
        assert r["fit"]["loss"] == r["loss"][-1], (arch, r)
        assert r["fit"]["gnorm"] == r["gnorm"][-1], (arch, r)
        assert np.isfinite(r["loss"]).all()


@pytest.mark.parametrize("arch", ["hymba-1.5b", "xlstm-125m"])
def test_launchers_mesh_host_recurrent(arch, capsys):
    """``launch.serve --mesh host`` and ``launch.train --mesh host`` of
    the smoke recurrent configs on a one-rank gloo group: 3 requests in
    waves of 2 lanes, 3 greedy tokens each, and 2 training steps with a
    finite loss."""
    import torch.distributed as dist

    from repro_torch.launch import serve, train

    out = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--mesh", "host", "--requests", "3", "--batch", "2",
                      "--max-new", "3", "--max-len", "16"])
    assert out["requests"] == 3 and out["tokens"] == 9
    assert "served 3 requests, 9 tokens" in capsys.readouterr().out
    m = train.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps",
                    "2", "--batch", "2", "--seq", "16", "--mesh", "host"])
    assert np.isfinite(m["loss"]) and "final:" in capsys.readouterr().out
    assert not dist.is_initialized()
