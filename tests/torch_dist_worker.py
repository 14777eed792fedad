"""Multi-rank checks of the port's sharding, run in spawned gloo processes
by the sharding tests (this module imports no JAX: each spawned process
imports it afresh).

``run(rank, world, store, out, group)`` joins a ``world``-rank gloo group
over the file ``store``, runs the cases of one ``GROUPS`` entry, each
spawned by its own test file, and rank 0 writes what the test compares
into the directory ``out``:

* "sharded" (``tests/test_torch_sharding.py``): ``train_<i>.npz``,
  ``ckpt.json``, ``serve.json``, ``dp_mean.npz``, ``preempt.json``;
* "dense" (``tests/test_torch_split_dense.py``): the dense family's
  ``tp_train_<i>.npz`` and ``tp_serve_<i>.json``, ``comm.json``,
  ``remat.json``, ``init.json``;
* "vlm" (``tests/test_torch_split_vlm.py``): the vlm's and hubert's
  ``tp_train_<i>.npz`` and ``tp_serve_<i>.json``, ``tp_init.json``;
* "moe" (``tests/test_torch_split_moe.py``): every ``moe_*`` file;
* "recurrent" (``tests/test_torch_split_recurrent.py``): hymba's and
  xlstm's ``tp_train_<i>.npz`` and ``tp_serve_<i>.json``,
  ``rec_init.json``, ``rec_fit.json``;
* "dense", "moe" and "recurrent" each also write ``sp_<group>.json``.

The files:

* ``train_<i>.npz``: ``TRAIN_CASES[i]`` on a (2, 2) mesh, ``TRAIN_STEPS``
  sharded steps from ``init_params(cfg, "cpu", 0)`` on the pipeline's
  batches: losses, gnorms, the first step's data-mean gradient (gathered)
  and the final parameters (and error state), leaf paths as keys;
* ``ckpt.json``: the state of case 0 saved from the (2, 2) mesh and
  restored onto (4, 1): every leaf equal, on the (4, 1) placements;
* ``serve.json``: ``jit_prefill`` and ``jit_decode`` on (2, 2) against
  the unsharded ``prefill``/``decode_step``, for each ``SERVE_ARCHS``;
* ``dp_mean.npz``: ``dp_mean_compressed`` of ``dp_tree(rank)`` over the
  world;
* ``preempt.json``: ``fit`` on (2, 2) with SIGTERM on rank 1 alone after
  step 0: each rank's logged steps and whether it stopped, and the
  steps saved;
* ``tp_train_<i>.npz``: ``TP_TRAIN_CASES[i]``, the tensor-parallel train
  step of a config of any family on its mesh, as ``train_<i>.npz``
  (with the parts that ran split and the port's warnings);
* ``tp_serve_<i>.json``: ``TP_SERVE_CASES[i]``, split prefill then decode
  with ragged positions, an idle lane and (some cases) a window, against
  the unsharded port (the vlm's image K/V and the recurrent states too;
  the state after the prefill as well), with the collectives of the
  first decode step by group and the port's warnings;
* ``comm.json``: every collective of one split train step, prefill and
  decode step (op, group, elements), recorded under a dispatch mode;
* ``remat.json``: the split step's gradient under remat "full"
  against "none", and the all-gathers each ran on "data";
* ``init.json``: ``init_sharded_params`` on (2, 2) and (1, 4): the
  gathered pieces against ``init_params``, and the largest tensor an op
  made while drawing;
* ``tp_init.json``: ``init_sharded_params`` of smoke vlm and hubert on
  (2, 2) against ``init_params``, and the pieces' shapes;
* ``moe_train_<i>.npz``: ``MOE_TRAIN_CASES[i]``, the split MoE step
  (experts over "model", or d_ff where E does not divide it) as
  ``train_<i>.npz``, with its mode and the warnings it raised;
* ``moe_dispatch.npz``: the split layer's expert ids, slots and kept
  flags on (4, 1) and (2, 2), every rank's in rank order, and its output
  gathered, for ``MOE_DISPATCH_INPUT``;
* ``moe_serve.json``: ``MOE_SERVE_CASES``, as ``tp_serve.json`` (ring
  caches for mixtral, ``REPRO_WINDOW_CACHE=1`` on both sides) and the
  warnings raised;
* ``moe_comm.json``: the collectives of a split MoE train step, prefill
  and decode step, and the shapes of the expert pieces;
* ``moe_init.json``: ``init_sharded_params`` of smoke granite against
  ``init_params``;
* ``rec_init.json``: ``init_sharded_params`` of smoke hymba and xlstm on
  (2, 2) and (1, 4) against ``init_params``, and the pieces' shapes;
* ``rec_fit.json``: ``fit(mesh=)`` of smoke hymba and xlstm on (2, 2):
  the last step's metrics and the split step's loss by step;
* ``sp_<group>.json``: ``SP_CASES[group]``, the split step under remat
  "full" at a sequence length that splits over "model" or not: whether
  it split, the residual's shape entering every block, the largest
  activation [B/dp, .., d] saved for the backward, and the split
  forward's logits, loss and data-mean gradient (gathered) against the
  unsharded port's on the whole batch.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import warnings

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.sharding.tensor_parallel import CollectiveLog

WORLD = 4
TRAIN_STEPS = 2
# (arch, microbatches, compress_grads, REPRO_MOE_GROUPS): granite with 2
# groups routes each data rank's rows on their own; with none every rank
# computes the whole batch (the reference routes it together)
TRAIN_CASES = (("llama3-8b", 1, False, 0), ("llama3-8b", 2, True, 0),
               ("granite-moe-3b-a800m", 1, False, 2),
               ("granite-moe-3b-a800m", 2, True, 0))
DC_KW = dict(seq_len=16, global_batch=8, seed=5)
SERVE_ARCHS = ("llama3-8b", "granite-moe-3b-a800m")
SERVE_B, SERVE_PROMPT, SERVE_LEN, SERVE_STEPS = 4, 10, 16, 6
PREEMPT_STEPS = 3
# tensor-parallel cases: (mesh, arch, wide, microbatches, compress_grads);
# "wide" gives the smoke config 8 heads over 4 KV heads, which split over
# a 4-rank "model" axis; the smoke config's 2 KV heads do not (attention
# runs whole there, the last case)
TP_TRAIN_CASES = (((2, 2), "qwen2-7b", False, 1, False),
                  ((2, 2), "qwen2-7b", False, 2, True),
                  ((1, 4), "llama3-8b", True, 1, False),
                  ((1, 4), "llama3-8b", True, 2, True),
                  ((1, 4), "qwen2-7b", True, 1, False),
                  ((1, 4), "qwen2-7b", True, 2, True),
                  ((1, 4), "llama3-8b", False, 1, False),
                  ((2, 2), "llama-3.2-vision-90b", False, 1, False),
                  ((1, 4), "llama-3.2-vision-90b", True, 2, True),
                  ((2, 2), "hubert-xlarge", False, 1, False),
                  ((1, 4), "hubert-xlarge", True, 2, True),
                  # hymba: attention split on (2, 2); on (1, 4) its 2 KV
                  # heads run whole, and in_proj's x and z columns lie on
                  # different ranks; xlstm by heads, 2 or 1 a rank
                  ((2, 2), "hymba-1.5b", False, 1, False),
                  ((1, 4), "hymba-1.5b", False, 2, True),
                  ((2, 2), "xlstm-125m", False, 1, False),
                  ((1, 4), "xlstm-125m", False, 2, True))
# (mesh, arch, wide, sliding window)
TP_SERVE_CASES = (((2, 2), "llama3-8b", False, 0),
                  ((2, 2), "qwen2-7b", False, 0),
                  ((1, 4), "llama3-8b", True, 6),
                  ((1, 4), "qwen2-7b", True, 0),
                  ((1, 4), "llama3-8b", False, 0),
                  ((2, 2), "llama-3.2-vision-90b", False, 0),
                  ((1, 4), "llama-3.2-vision-90b", True, 0),
                  # hymba's window on every second layer (its global
                  # layers attend everything), attention whole on (1, 4)
                  # unless wide
                  ((2, 2), "hymba-1.5b", False, 6),
                  ((1, 4), "hymba-1.5b", True, 6),
                  ((1, 4), "hymba-1.5b", False, 6),
                  ((2, 2), "xlstm-125m", False, 0),
                  ((1, 4), "xlstm-125m", False, 0))
# the vlm's cross layers' gate in every case: at its init of 0, tanh(gate)
# hides the cross branch
VLM_GATE = 0.5
# the seed of the vlm's image embeddings (the pipeline makes none)
IMAGE_SEED = 11
# lanes' positions after the prefill: ragged, lane 3 idle throughout
TP_SERVE_POS = (10, 7, 3, -100)
# the split MoE step: (mesh, arch, wide, REPRO_MOE_GROUPS, n_experts (0:
# the config's)); 6 experts do not split over 4 "model" ranks, d_ff 96
# does.  With TRAIN_CASES' granite on (2, 2) (groups 2, and none with 2
# microbatches and int8) each arch runs on both meshes, with and
# without groups
MOE_TRAIN_CASES = (((2, 2), "mixtral-8x22b", False, 0, 0),
                   ((1, 4), "mixtral-8x22b", True, 2, 0),
                   ((1, 4), "granite-moe-3b-a800m", True, 0, 0),
                   ((1, 4), "granite-moe-3b-a800m", True, 0, 6))
# split MoE serving: (mesh, arch, wide, window, ring cache); a ring of
# ``RING_WINDOW`` slots takes a ``RING_PROMPT``-token prompt, and the
# decode passes the window (``RING_POS``)
MOE_SERVE_CASES = (((2, 2), "granite-moe-3b-a800m", False, 0, False),
                   ((1, 4), "granite-moe-3b-a800m", True, 0, False),
                   ((1, 4), "mixtral-8x22b", True, 8, True),
                   ((2, 2), "mixtral-8x22b", False, 8, True))
RING_WINDOW, RING_PROMPT = 8, 6
RING_POS = (6, 5, 3, -100)
# the sequence split's cases, by spawn: (mesh, arch, wide, n_experts (0:
# the config's), vocab (0: the config's), seq_len).  16 tokens split over
# "model" on (2, 2) and (1, 4), 18 do not on (1, 4); smoke llama3-8b on
# (1, 4) runs attention whole, granite with 6 experts splits by d_ff
# ("mlp"), hymba on (1, 4) runs attention whole beside a split Mamba
# branch (one gather feeds both), and a vocabulary of 514 runs whole
SP_CASES = {"dense": (((2, 2), "llama3-8b", False, 0, 0, 16),
                      ((1, 4), "llama3-8b", True, 0, 0, 16),
                      ((1, 4), "llama3-8b", False, 0, 0, 16),
                      ((1, 4), "llama3-8b", True, 0, 514, 16),
                      ((1, 4), "llama3-8b", True, 0, 0, 18)),
            "moe": (((1, 4), "granite-moe-3b-a800m", True, 6, 0, 16),),
            "recurrent": (((1, 4), "hymba-1.5b", False, 0, 0, 16),)}
# the spawn that runs each arch's split cases
_ARCH_GROUP = {"llama-3.2-vision-90b": "vlm", "hubert-xlarge": "vlm",
               "hymba-1.5b": "recurrent", "xlstm-125m": "recurrent"}
# the dispatch case: B rows of S tokens, router column 0 biased so that
# its expert overflows (drops), REPRO_MOE_GROUPS 0 and 2
MOE_DISPATCH_INPUT = dict(B=8, S=6, bias=6.0, seed=7)


def case_group(arch: str) -> str:
    """The spawn ("dense", "vlm" or "recurrent") that runs ``arch``'s
    split cases."""
    return _ARCH_GROUP.get(arch, "dense")


def group_cases(cases, group: str) -> list:
    """The indices of the split ``cases`` (``TP_TRAIN_CASES``,
    ``TP_SERVE_CASES``) whose arch ``group`` runs."""
    return [i for i, c in enumerate(cases) if case_group(c[1]) == group]


def opt_config():
    from repro_torch.train.optimizer import OptConfig
    # eps 1: AdamW's first step nearly linear in the gradient (the port's
    # train-step parity setting)
    return OptConfig(lr=3e-3, warmup_steps=5, total_steps=60, eps=1.0)


def smoke(arch):
    from repro_torch.configs import get_config, reduce_for_smoke
    return reduce_for_smoke(get_config(arch))


def widen(cfg, wide: bool, window: int = 0):
    """The smoke config with 8 heads over 4 KV heads (``wide``) and a
    sliding window; either package's config."""
    if wide:
        cfg = dataclasses.replace(cfg, n_heads=8, n_kv_heads=4)
    return dataclasses.replace(cfg, sliding_window=window) if window else cfg


def init(cfg) -> dict:
    """``init_params(cfg, "cpu", 0)`` with the QKV biases, the audio
    MLP's biases and the Mamba branch's conv bias drawn (normal, 0.5) and
    the vlm's gate at ``VLM_GATE``: at their init of zero they would not
    show in the outputs, bk's gradient is zero in exact arithmetic
    (softmax is unmoved by one shift of every key), so from zero its
    values after a step are rounding noise, and a leaf at zero has no
    scale for the parameters' tolerance, which is relative to it.  The
    xLSTM's projections at ``weights.unit_fan_in``, as every xLSTM parity
    test takes them: at the reference's ``m_qkv`` scale its exponential
    gates part the two packages' gradients by more than 1e-4 unsharded
    (``test_torch_train.py``'s ``_family_inputs``)."""
    from repro_torch.models import init_params
    from repro_torch.weights import unit_fan_in
    params = init_params(cfg, "cpu", seed=0)
    if cfg.family == "ssm":
        unit_fan_in(params, cfg)
    rng = np.random.default_rng(12)
    drawn = []
    if cfg.qkv_bias:
        drawn = [params["blocks"]["attn"][k] for k in ("bq", "bk", "bv")]
    if cfg.family == "audio":
        drawn = [params["blocks"]["mlp"][k] for k in ("b_in", "b_out")]
    if cfg.family == "hybrid":
        drawn = [params["blocks"]["ssm"]["conv_b"]]
    for b in drawn:
        b.copy_(torch.from_numpy(rng.normal(0, 0.5, b.shape).astype(
            np.float32)))
    if cfg.family == "vlm":
        params["blocks"]["cross"]["attn"]["gate"].fill_(VLM_GATE)
    return params


def data_config(cfg):
    from repro_torch.data.pipeline import DataConfig
    return DataConfig(vocab=cfg.vocab, **DC_KW,
                      embed_dim=cfg.d_model if cfg.embed_inputs else 0)


def image_embeds(cfg, rows: int, step: int) -> np.ndarray:
    """The vlm's seeded image embeddings [rows, T, d] of a step."""
    rng = np.random.default_rng([DC_KW["seed"], step, IMAGE_SEED])
    return rng.standard_normal((rows, cfg.n_image_tokens, cfg.d_model),
                               dtype=np.float32)


def whole_batch(cfg, dc, step: int) -> dict:
    """``make_batch(dc, step)`` with the vlm's image embeddings (either
    package's ``make_batch``, which draw the same)."""
    from repro_torch.data.pipeline import make_batch
    batch = make_batch(dc, step)
    if cfg.family == "vlm":
        batch["image_embeds"] = image_embeds(cfg, dc.global_batch, step)
    return batch


def dp_tree(rank: int) -> dict:
    """A rank's gradient tree for the int8 mean: leaves of other sizes
    and scales, one with a value on an int8 half-step."""
    rng = np.random.default_rng(100 + rank)
    return {"a": (rng.standard_normal((6, 5)) * (rank + 1)).astype(
                np.float32),
            "b": {"w": (rng.standard_normal(7) * 1e-3).astype(np.float32),
                  "z": np.zeros(3, np.float32)}}


def flat(tree, prefix=""):
    if hasattr(tree, "_fields"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _full(t) -> np.ndarray:
    return t.full_tensor().float().numpy()


def _mesh(shape):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))


def _batch(cfg, dc, it, b_sh, mesh):
    """This rank's rows of ``whole_batch(cfg, dc, it)`` as DTensors on
    ``b_sh``."""
    from repro_torch.data.pipeline import batch_rows
    from repro_torch.sharding import specs
    n, idx = specs.shard_index(next(iter(b_sh.values())).placements, mesh)
    local = batch_rows(dc, it, idx, n)
    if cfg.family == "vlm":
        rows = dc.global_batch // n
        local["image_embeds"] = image_embeds(cfg, dc.global_batch, it)[
            idx * rows:(idx + 1) * rows]
    return {k: specs.distribute_local(torch.from_numpy(v), mesh,
                                      b_sh[k].placements,
                                      (dc.global_batch,) + v.shape[1:])
            for k, v in local.items()}


def train_case(i, mesh, out):
    arch, mb, compress, groups = TRAIN_CASES[i]
    os.environ["REPRO_MOE_GROUPS"] = str(groups)
    res, state = _train(smoke(arch), mb, compress, mesh)
    os.environ.pop("REPRO_MOE_GROUPS")
    if dist.get_rank() == 0:
        np.savez(os.path.join(out, f"train_{i}.npz"), **res)
    return state


def tp_train_case(i, meshes, out):
    shape, arch, wide, mb, compress = TP_TRAIN_CASES[i]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        res, (_, _, _, step) = _train(widen(smoke(arch), wide), mb, compress,
                                      meshes[shape])
    res["split"] = np.array([step.tp.split[p] for p in ("attn", "mlp",
                                                        "vocab")])
    res["whole_parts"] = np.array(step.tp.whole_parts(), dtype=str)
    res["whole_warnings"] = np.array(sum("computes attn whole" in
                                         str(w.message) for w in caught))
    res["port_warnings"] = np.array(_port_warnings(caught))
    if dist.get_rank() == 0:
        np.savez(os.path.join(out, f"tp_train_{i}.npz"), **res)


def _train(cfg, mb, compress, mesh, draw=None):
    """``TRAIN_STEPS`` sharded steps of ``cfg`` on ``mesh`` from
    ``draw(cfg)`` (default ``init``) -> (what ``train_<i>.npz`` holds,
    (params, opt, p_sh, the step))."""
    from repro_torch.models import abstract_params_and_axes
    from repro_torch.sharding import specs
    from repro_torch.train.loop import (TrainConfig, init_sharded_state,
                                        make_sharded_train_step)

    dc = data_config(cfg)
    tc = TrainConfig(microbatches=mb, compress_grads=compress)
    step, p_sh, b_sh = make_sharded_train_step(cfg, opt_config(), tc, mesh,
                                               whole_batch(cfg, dc, 0))
    params = specs.distribute_tree((draw or init)(cfg), p_sh)
    opt, err = init_sharded_state(p_sh, abstract_params_and_axes(cfg)[0],
                                  compress)
    res = {}
    g = step.grads(params, _batch(cfg, dc, 0, b_sh, mesh))
    sh, shapes = flat(p_sh), {k: t.shape for k, t in flat(params).items()}
    res.update({f"grad/{k}": specs.distribute_local(
        v, mesh, sh[k].placements, shapes[k]).full_tensor().numpy()
        for k, v in flat(g).items()})
    losses, gnorms = [], []
    for it in range(TRAIN_STEPS):
        params, opt, err, m = step(params, opt, err, _batch(cfg, dc, it,
                                                            b_sh, mesh))
        losses.append(float(m["loss"]))
        gnorms.append(float(m["gnorm"]))
    res.update({f"param/{k}": _full(v) for k, v in flat(params).items()})
    if compress:
        res.update({f"err/{k}": _full(v) for k, v in flat(err).items()})
    res["loss"], res["gnorm"] = np.array(losses), np.array(gnorms)
    res["step"] = np.array(int(opt.step.full_tensor()))
    return res, (params, opt, p_sh, step)


def ckpt_case(state, out, rank):
    """Save on (2, 2) (async, gathered on every rank, written by rank 0),
    restore onto (4, 1) by that mesh's shardings."""
    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.models import abstract_params_and_axes
    from repro_torch.sharding import specs
    from repro_torch.train.loop import opt_shardings
    from repro_torch.train.optimizer import OptState

    arch = TRAIN_CASES[0][0]
    cfg = smoke(arch)
    mgr = CheckpointManager(os.path.join(out, "ckpt"))
    params, opt = state[:2]
    mgr.save_async(2, {"params": params, "opt": opt}, extra={"arch": arch})
    mgr.wait()
    mesh41 = _mesh((4, 1))
    abstract, axes = abstract_params_and_axes(cfg)
    p_sh = specs.tree_shardings(axes, mesh41, abstract)
    none = lambda t: None  # noqa: E731
    tmpl = {"params": specs.map_leaves(none, abstract),
            "opt": OptState(None, specs.map_leaves(none, abstract),
                            specs.map_leaves(none, abstract))}
    back, extra, step = mgr.restore(None, tmpl, "cpu", {
        "params": p_sh, "opt": opt_shardings(mesh41, p_sh)})
    want = flat({"params": params, "opt": opt})
    got = flat(back)
    sh = flat({"params": p_sh, "opt": opt_shardings(mesh41, p_sh)})
    bad = [k for k in want if not torch.equal(want[k].full_tensor(),
                                              got[k].full_tensor())]
    wrong_pl = [k for k in want if tuple(got[k].placements)
                != tuple(sh[k].placements) or got[k].device_mesh is not
                mesh41]
    specs41 = sorted({str(s.spec) for s in sh.values()})
    if rank == 0:
        with open(os.path.join(out, "ckpt.json"), "w") as f:
            json.dump({"step": step, "extra": extra, "leaves": len(want),
                       "unequal": bad, "misplaced": wrong_pl,
                       "specs41": specs41}, f)


def serve_case(arch, mesh):
    """Greedy tokens and logits of the sharded prefill + decode against
    the unsharded ones, on every rank."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.models import (abstract_params_and_axes, decode_step,
                                    init_params, prefill)
    from repro_torch.serve.decode import (batch_shardings,
                                          decode_state_shardings, jit_decode,
                                          jit_prefill)
    from repro_torch.sharding import specs

    cfg = smoke(arch)
    full = init_params(cfg, "cpu", seed=0)
    shape = ShapeConfig("serve", SERVE_LEN, SERVE_B, "prefill")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        pre, (params_abs, specs_in) = jit_prefill(cfg, shape, mesh)
        dec, (_, state_abs, _) = jit_decode(cfg, dataclasses.replace(
            shape, kind="decode"), mesh)
    whole = sum("computes the whole batch" in str(w.message)
                for w in caught)
    _, axes = abstract_params_and_axes(cfg)
    params = specs.distribute_tree(full, specs.tree_shardings(
        axes, mesh, params_abs))
    rng = np.random.default_rng(9)
    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab, (SERVE_B, SERVE_PROMPT), dtype=np.int32))
    b_sh = batch_shardings({"tokens": prompt}, mesh)
    logits, state = pre(params, {"tokens": specs.distribute(
        prompt, b_sh["tokens"])})
    s_sh = decode_state_shardings(cfg, state_abs, mesh)
    placed = all(tuple(a.placements) == tuple(b.placements) for a, b in zip(
        flat(state).values(), flat(s_sh).values()))
    want_logits, want_state = prefill(cfg, full, {"tokens": prompt},
                                      max_len=SERVE_LEN)
    want_logits = want_logits[:, -1]
    toks, want_toks, gap = [], [], 0.0
    t_sh = specs.NamedSharding(mesh, specs.spec_for(
        ("batch",), mesh=mesh, shape=(SERVE_B,)))
    for _ in range(SERVE_STEPS):
        got = logits.full_tensor()
        gap = max(gap, (got - want_logits).abs().max().item())
        nxt, want_nxt = got.argmax(-1), want_logits.argmax(-1)
        toks.append(nxt.tolist())
        want_toks.append(want_nxt.tolist())
        logits, state = dec(params, state, specs.distribute(
            nxt.to(torch.int32), t_sh))
        want_logits, want_state = decode_step(cfg, full, want_state,
                                              want_nxt)
    return {"tokens": toks, "want_tokens": want_toks, "logit_gap": gap,
            "pos": state.pos.full_tensor().tolist(),
            "want_pos": want_state.pos.tolist(), "placed": placed,
            "whole_batch_warnings": whole,
            "state_specs": sorted({str(s.spec) for s in
                                   flat(s_sh).values()})}


def preempt_case(mesh, out, rank):
    """``fit`` on (2, 2) with SIGTERM raised on rank 1 alone after step 0:
    the steps each rank logged, whether it stopped, the steps saved."""
    import signal

    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.train.loop import TrainConfig, fit

    cfg = smoke(TRAIN_CASES[0][0])
    lines = []

    def log(line):
        lines.append(line)
        if rank == 1 and line.split()[:2] == ["step", "0"]:
            os.kill(os.getpid(), signal.SIGTERM)

    ckpt = os.path.join(out, "preempt")
    tc = TrainConfig(steps=PREEMPT_STEPS, ckpt_dir=ckpt, ckpt_every=100,
                     log_every=1)
    fit(cfg, data_config(cfg), opt_config(), tc, mesh=mesh, log=log,
        device="cpu")
    signal.signal(signal.SIGTERM, signal.SIG_DFL)
    mine = {"steps": [int(ln.split()[1]) for ln in lines
                      if ln.startswith("step ")],
            "stopped": any(ln.startswith("[preempt]") for ln in lines)}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    if rank == 0:
        with open(os.path.join(out, "preempt.json"), "w") as f:
            json.dump({"ranks": every,
                       "saved": CheckpointManager(ckpt).all_steps()}, f)


def tp_serve_case(i, meshes):
    """Split ``jit_prefill``, the positions set to ``TP_SERVE_POS``, then
    greedy split ``jit_decode`` steps against the unsharded port with the
    same positions: tokens, the logits' largest gap, the caches gathered
    against the unsharded ones, and each cache piece's shape; the port's
    warnings raised."""
    shape, arch, wide, window = TP_SERVE_CASES[i]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        res = _split_serve(meshes[shape], widen(smoke(arch), wide, window),
                           SERVE_PROMPT, TP_SERVE_POS)
    return dict(res, port_warnings=_port_warnings(caught))


def moe_serve_case(i, meshes):
    """``MOE_SERVE_CASES[i]`` as ``tp_serve_case``; a ring case runs with
    ``REPRO_WINDOW_CACHE=1`` on both sides, a ``RING_PROMPT``-token
    prompt and ``RING_POS``.  Adds the port's warnings raised."""
    shape, arch, wide, window, ring = MOE_SERVE_CASES[i]
    if ring:
        os.environ["REPRO_WINDOW_CACHE"] = "1"
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            res = _split_serve(meshes[shape], moe_config(
                smoke(arch), wide, window=window),
                RING_PROMPT if ring else SERVE_PROMPT,
                RING_POS if ring else TP_SERVE_POS)
    finally:
        os.environ.pop("REPRO_WINDOW_CACHE", None)
    return dict(res, port_warnings=_port_warnings(caught))


def _split_serve(mesh, cfg, prompt_len: int, pos0):
    """``tp_serve_case``'s run of ``cfg`` on ``mesh``: a prompt of
    ``prompt_len`` tokens (the vlm's over seeded image embeddings), the
    positions then set to ``pos0``; the first decode step's collectives
    counted by group ("model" and the others)."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.models import (abstract_params_and_axes, decode_step,
                                    prefill)
    from repro_torch.serve.decode import (batch_shardings,
                                          decode_state_shardings, jit_decode,
                                          jit_prefill)
    from repro_torch.sharding import specs

    full = init(cfg)
    sh = ShapeConfig("serve", SERVE_LEN, SERVE_B, "prefill")
    pre, (params_abs, _) = jit_prefill(cfg, sh, mesh)
    dec, (_, state_abs, _) = jit_decode(cfg, dataclasses.replace(
        sh, kind="decode"), mesh)
    params = specs.distribute_tree(full, specs.tree_shardings(
        abstract_params_and_axes(cfg)[1], mesh, params_abs))
    prompt = {"tokens": torch.from_numpy(np.random.default_rng(11).integers(
        0, cfg.vocab, (SERVE_B, prompt_len), dtype=np.int32))}
    if cfg.family == "vlm":
        prompt["image_embeds"] = torch.from_numpy(image_embeds(cfg, SERVE_B,
                                                               0))
    b_sh = batch_shardings(prompt, mesh)
    logits, state = pre(params, {k: specs.distribute(v, b_sh[k])
                                 for k, v in prompt.items()})
    want_logits, want = prefill(cfg, full, prompt, max_len=SERVE_LEN)
    want_logits = want_logits[:, -1]
    prefill_gap = _state_gap(state, want)
    prefill_pos = (state.pos.full_tensor().tolist(), want.pos.tolist())
    s_sh = decode_state_shardings(cfg, state_abs, mesh)
    pos = torch.tensor(pos0, dtype=torch.int32)
    state = state._replace(pos=specs.distribute(pos, s_sh.pos))
    want = want._replace(pos=pos.clone())
    t_sh = specs.NamedSharding(mesh, specs.spec_for(
        ("batch",), mesh=mesh, shape=(SERVE_B,)))
    toks, want_toks, gap = [], [], 0.0
    rec = CollectiveLog()
    for i in range(SERVE_STEPS):
        got = logits.full_tensor()
        gap = max(gap, (got - want_logits).abs().max().item())
        nxt, want_nxt = got.argmax(-1), want_logits.argmax(-1)
        toks.append(nxt.tolist())
        want_toks.append(want_nxt.tolist())
        nxt = specs.distribute(nxt.to(torch.int32), t_sh)
        if i == 0:
            with rec:
                logits, state = dec(params, state, nxt)
        else:
            logits, state = dec(params, state, nxt)
        want_logits, want = decode_step(cfg, full, want, want_nxt)
    got = logits.full_tensor()
    gap = max(gap, (got - want_logits).abs().max().item())
    model = mesh.get_group("model").group_name
    on_model = sum(c.group == model for c in rec.calls)
    pieces = {k: list(t.to_local().shape)
              for k, t in flat(state.caches).items()}
    wholes = {k: list(t.shape) for k, t in flat(state_abs.caches).items()}
    return {"collectives": {"model": on_model,
                            "other": len(rec.calls) - on_model},
            "calls": [[c.op, "model" if c.group == model else "other",
                       c.shapes] for c in rec.calls],
            "tokens": toks, "want_tokens": want_toks, "logit_gap": gap,
            "cache_gap": _state_gap(state, want),
            "prefill_gap": prefill_gap, "prefill_pos": prefill_pos,
            "pos": state.pos.full_tensor().tolist(),
            "want_pos": want.pos.tolist(),
            "piece": pieces.get("k"), "whole": wholes.get("k"),
            "pieces": pieces, "wholes": wholes,
            "logits_spec": str(logits.placements)}


def _state_gap(state, want) -> float:
    """The largest gap between a split decode state's caches, gathered,
    and the unsharded ones, over every leaf."""
    got = flat(state.caches)
    return max((got[k].full_tensor().float() - v.float()).abs().max().item()
               for k, v in flat(want.caches).items())


def comm_case(meshes, out, rank):
    """Under ``CollectiveLog``: one split train step, a prefill and a decode
    step of smoke llama3-8b on (2, 2) and of the wide one on (1, 4): the
    collectives on "model" and the shapes no such collective may have
    (every parameter leaf's piece, layer and whole, and the caches')."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.data.pipeline import make_batch
    from repro_torch.models import (abstract_params_and_axes, init_params)
    from repro_torch.serve.decode import batch_shardings, jit_decode, \
        jit_prefill
    from repro_torch.sharding import specs
    from repro_torch.train.loop import (TrainConfig, init_sharded_state,
                                        make_sharded_train_step)

    res = {}
    for shape, wide in (((2, 2), False), ((1, 4), True)):
        mesh = meshes[shape]
        cfg = widen(smoke("llama3-8b"), wide)
        # 24 tokens: no activation shares a shape with a parameter
        dc = dataclasses.replace(data_config(cfg), seq_len=24)
        step, p_sh, b_sh = make_sharded_train_step(
            cfg, opt_config(), TrainConfig(), mesh, make_batch(dc, 0))
        full = init_params(cfg, "cpu", seed=0)
        params = specs.distribute_tree(full, p_sh)
        opt, err = init_sharded_state(
            p_sh, abstract_params_and_axes(cfg)[0], False)
        batch = _batch(cfg, dc, 0, b_sh, mesh)
        sh = ShapeConfig("serve", SERVE_LEN, SERVE_B, "prefill")
        pre, _ = jit_prefill(cfg, sh, mesh)
        dec, (_, state_abs, _) = jit_decode(cfg, dataclasses.replace(
            sh, kind="decode"), mesh)
        prompt = torch.zeros((SERVE_B, SERVE_PROMPT), dtype=torch.int32)
        tokens = torch.zeros((SERVE_B,), dtype=torch.int32)
        bs = batch_shardings({"tokens": prompt}, mesh)["tokens"]
        ts = batch_shardings({"tokens": tokens}, mesh)["tokens"]
        recs = {}
        for phase in ("train", "prefill", "decode"):
            rec = CollectiveLog()
            with rec:
                if phase == "train":
                    step(params, opt, err, batch)
                elif phase == "prefill":
                    _, state = pre(params, {"tokens": specs.distribute(
                        prompt, bs)})
                else:
                    dec(params, state, specs.distribute(tokens, ts))
            recs[phase] = rec.calls
        model = mesh.get_group("model").group_name
        pieces = set()
        for t in flat(params).values():
            pieces.add(tuple(t.to_local().shape))
            pieces.add(tuple(t.to_local().shape[1:]))
            pieces.add(tuple(t.shape))
            pieces.add(tuple(t.shape[1:]))
        for t in flat(state.caches).values():
            pieces.add(tuple(t.to_local().shape))
            pieces.add(tuple(t.to_local().shape[1:]))
        res[str(shape)] = {
            ph: [c for c in calls_ if c[1] == model]
            for ph, calls_ in recs.items()}
        res[str(shape)]["n_all"] = {ph: len(c) for ph, c in recs.items()}
        res[str(shape)]["forbidden"] = sorted(map(list, pieces))
        res[str(shape)]["bounds"] = {
            "train": dc.global_batch // shape[0] * dc.seq_len
            * cfg.d_model,
            "prefill": SERVE_B // shape[0] * SERVE_LEN * cfg.d_model,
            "decode": SERVE_B // shape[0] * max(
                cfg.d_model, (cfg.n_heads + 2 * cfg.n_kv_heads)
                * cfg.hd, cfg.n_heads * (cfg.hd + 1))}
    if rank == 0:
        with open(os.path.join(out, "comm.json"), "w") as f:
            json.dump(res, f)


def remat_case(meshes, out, rank):
    """The split step's data-mean gradient of smoke llama3-8b on (2, 2)
    under remat "full" against "none" (the largest difference), and the
    all-gathers each ran on the "data" group (a recomputing backward
    gathers each layer's pieces again)."""
    from repro_torch.data.pipeline import make_batch
    from repro_torch.sharding import specs
    from repro_torch.train.loop import TrainConfig, make_sharded_train_step

    mesh = meshes[(2, 2)]
    cfg = smoke("llama3-8b")
    dc = data_config(cfg)
    data = mesh.get_group("data").group_name
    grads, gathers = {}, {}
    for remat in ("none", "full"):
        step, p_sh, b_sh = make_sharded_train_step(
            cfg, opt_config(), TrainConfig(remat=remat), mesh,
            make_batch(dc, 0))
        params = specs.distribute_tree(init(cfg), p_sh)
        rec = CollectiveLog()
        with rec:
            grads[remat] = flat(step.grads(params, _batch(
                cfg, dc, 0, b_sh, mesh)))
        gathers[remat] = sum(c.op.startswith("c10d._allgather_base")
                             and c.group == data for c in rec.calls)
    diff = max((grads["full"][k] - grads["none"][k]).abs().max().item()
               for k in grads["none"])
    if rank == 0:
        with open(os.path.join(out, "remat.json"), "w") as f:
            json.dump({"max_diff": diff, "gathers": gathers}, f)


class Sizes(TorchDispatchMode):
    """The shape of every tensor an op makes in the mode (meta tensors,
    which hold no memory, aside)."""

    def __init__(self):
        super().__init__()
        self.shapes = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (list, tuple)) else [out]):
            if isinstance(t, torch.Tensor) and t.device.type != "meta":
                self.shapes.add(tuple(t.shape))
        return out


def tp_init_case(meshes, out, rank):
    """``init_sharded_params`` of smoke vlm and hubert on (2, 2): the
    leaves whose gathered pieces differ from ``init_params``'s, and each
    leaf's piece and whole shape."""
    from repro_torch.models import init_params, init_sharded_params

    res = {}
    for arch in ("llama-3.2-vision-90b", "hubert-xlarge"):
        cfg = smoke(arch)
        want = flat(init_params(cfg, "cpu", seed=4))
        got = flat(init_sharded_params(cfg, meshes[(2, 2)], seed=4,
                                       device="cpu"))
        res[arch] = {
            "unequal": [k for k in want if not torch.equal(
                got[k].full_tensor(), want[k])],
            "piece": {k: list(got[k].to_local().shape) for k in want},
            "whole": {k: list(v.shape) for k, v in want.items()}}
    if rank == 0:
        with open(os.path.join(out, "tp_init.json"), "w") as f:
            json.dump(res, f)


def init_case(meshes, out, rank):
    """``init_sharded_params`` of smoke qwen2-7b (QKV bias) on (2, 2)
    and (1, 4): the leaves whose gathered pieces differ from
    ``init_params``'s, the shapes of what ops made while drawing, and
    per leaf one layer's element count, its piece's and its whole
    shape."""
    from repro_torch.models import init_params, init_sharded_params

    cfg = smoke("qwen2-7b")
    want = flat(init_params(cfg, "cpu", seed=4))
    res = {}
    for shape, mesh in meshes.items():
        rec = Sizes()
        with rec:
            got = flat(init_sharded_params(cfg, mesh, seed=4, device="cpu"))
        res[str(shape)] = {
            "unequal": [k for k in want if not torch.equal(
                got[k].full_tensor(), want[k])],
            "shapes": sorted(map(list, rec.shapes)),
            "layer": {k: (v[0].numel() if k.startswith("blocks/")
                          else v.numel()) for k, v in want.items()},
            "whole": {k: list(v.shape) for k, v in want.items()},
            "piece": {k: list(got[k].to_local().shape) for k in want}}
    if rank == 0:
        with open(os.path.join(out, "init.json"), "w") as f:
            json.dump(res, f)


def moe_comm_case(meshes, out, rank):
    """Under ``CollectiveLog``: one split train step, a prefill and a
    decode step of smoke granite on (2, 2) and of the wide one on (1,
    4): every collective (op, group, shapes, bytes), the groups' names,
    each expert leaf's piece and layer shapes (which no collective on
    "model" may have) and the bounds of an activation."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.data.pipeline import make_batch
    from repro_torch.models import abstract_params_and_axes
    from repro_torch.serve.decode import batch_shardings, jit_decode, \
        jit_prefill
    from repro_torch.sharding import specs
    from repro_torch.train.loop import (TrainConfig, init_sharded_state,
                                        make_sharded_train_step)

    res = {}
    for shape, wide in (((2, 2), False), ((1, 4), True)):
        mesh = meshes[shape]
        cfg = widen(smoke("granite-moe-3b-a800m"), wide)
        dc = dataclasses.replace(data_config(cfg), seq_len=24)
        step, p_sh, b_sh = make_sharded_train_step(
            cfg, opt_config(), TrainConfig(), mesh, make_batch(dc, 0))
        params = specs.distribute_tree(init(cfg), p_sh)
        opt, err = init_sharded_state(
            p_sh, abstract_params_and_axes(cfg)[0], False)
        batch = _batch(cfg, dc, 0, b_sh, mesh)
        sh = ShapeConfig("serve", SERVE_LEN, SERVE_B, "prefill")
        pre, _ = jit_prefill(cfg, sh, mesh)
        dec, _ = jit_decode(cfg, dataclasses.replace(sh, kind="decode"),
                            mesh)
        prompt = torch.zeros((SERVE_B, SERVE_PROMPT), dtype=torch.int32)
        tokens = torch.zeros((SERVE_B,), dtype=torch.int32)
        bs = batch_shardings({"tokens": prompt}, mesh)["tokens"]
        ts = batch_shardings({"tokens": tokens}, mesh)["tokens"]
        r = {}
        for phase in ("train", "prefill", "decode"):
            rec = CollectiveLog()
            with rec:
                if phase == "train":
                    step(params, opt, err, batch)
                elif phase == "prefill":
                    _, state = pre(params, {"tokens": specs.distribute(
                        prompt, bs)})
                else:
                    dec(params, state, specs.distribute(tokens, ts))
            r[phase] = [list(c) for c in rec.calls]
        experts = set()
        for name in ("w_gate", "w_up", "w_down"):
            t = params["blocks"]["moe"][name]
            for full in (t.to_local().shape, t.shape):
                experts.add(tuple(full))
                experts.add(tuple(full[1:]))
        dp = shape[0]
        r.update(groups={"model": mesh.get_group("model").group_name,
                         "data": mesh.get_group("data").group_name},
                 experts=sorted(map(list, experts)),
                 bounds={"train": dc.global_batch // dp * dc.seq_len
                         * cfg.d_model,
                         "prefill": SERVE_B // dp * SERVE_LEN * cfg.d_model,
                         "decode": SERVE_B // dp * max(
                             cfg.d_model, (cfg.n_heads + 2 * cfg.n_kv_heads)
                             * cfg.hd, cfg.n_heads * (cfg.hd + 1))},
                 E=cfg.n_experts)
        res[str(shape)] = r
    if rank == 0:
        with open(os.path.join(out, "moe_comm.json"), "w") as f:
            json.dump(res, f)


def moe_init_case(meshes, out, rank):
    """``init_sharded_params`` of smoke granite (wide) on (2, 2) and
    (1, 4) against ``init_params``: the leaves whose gathered pieces
    differ, each MoE leaf's piece shape, and the largest tensor an op
    made while drawing against the largest layer of a leaf."""
    from repro_torch.models import init_params, init_sharded_params

    cfg = widen(smoke("granite-moe-3b-a800m"), True)
    want = flat(init_params(cfg, "cpu", seed=4))
    res = {}
    for shape, mesh in meshes.items():
        if shape not in ((2, 2), (1, 4)):
            continue
        rec = Sizes()
        with rec:
            got = flat(init_sharded_params(cfg, mesh, seed=4, device="cpu"))
        res[str(shape)] = {
            "unequal": [k for k in want if not torch.equal(
                got[k].full_tensor(), want[k])],
            "largest": max(math.prod(sh) for sh in rec.shapes),
            "layer": max(v[0].numel() if k.startswith("blocks/")
                         else v.numel() for k, v in want.items()),
            "piece": {k: list(got[k].to_local().shape) for k in want
                      if "/moe/" in k}}
    if rank == 0:
        with open(os.path.join(out, "moe_init.json"), "w") as f:
            json.dump(res, f)


def moe_config(cfg, wide: bool, n_experts: int = 0, window: int = 0):
    """``widen``, with ``n_experts`` experts when not 0; either
    package's config."""
    cfg = widen(cfg, wide, window)
    return dataclasses.replace(cfg, n_experts=n_experts) if n_experts \
        else cfg


_PORT_WARNINGS = ("computes the whole batch", "gathers every parameter",
                  " whole on each of")


def _port_warnings(caught) -> int:
    """How many of ``caught`` are the port's warnings of gathered or
    repeated work."""
    return sum(any(m in str(w.message) for m in _PORT_WARNINGS)
               for w in caught)


def moe_train_case(i, meshes, out):
    """``MOE_TRAIN_CASES[i]``: the split MoE step, as ``train_case``."""
    shape, arch, wide, groups, n_exp = MOE_TRAIN_CASES[i]
    os.environ["REPRO_MOE_GROUPS"] = str(groups)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        res, (_, _, _, step) = _train(moe_config(smoke(arch), wide, n_exp),
                                      1, False, meshes[shape])
    os.environ.pop("REPRO_MOE_GROUPS")
    res["mode"] = np.array(str(step.tp.moe_mode))
    res["split"] = np.array([step.tp.split[p] for p in ("attn", "moe",
                                                        "vocab")])
    res["port_warnings"] = np.array(_port_warnings(caught))
    if dist.get_rank() == 0:
        np.savez(os.path.join(out, f"moe_train_{i}.npz"), **res)


def moe_dispatch_inputs(cfg):
    """The dispatch case's seeded router and experts (fp32) and hidden
    states x [B, S, d], router column 0 biased so that its expert
    overflows."""
    kw = MOE_DISPATCH_INPUT
    rng = np.random.default_rng(kw["seed"])
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {"router": rng.normal(0, d ** -0.5, (d, E)).astype(np.float32),
         "w_gate": rng.normal(0, d ** -0.5, (E, d, ff)).astype(np.float32),
         "w_up": rng.normal(0, d ** -0.5, (E, d, ff)).astype(np.float32),
         "w_down": rng.normal(0, ff ** -0.5, (E, ff, d)).astype(np.float32)}
    x = rng.normal(0, 1, (kw["B"], kw["S"], d)).astype(np.float32)
    u = p["router"][:, 0] / np.linalg.norm(p["router"][:, 0])
    return p, x + kw["bias"] * u


def moe_dispatch_case(meshes, out, rank):
    """``moe.moe_ffn_split`` of smoke granite on the dispatch inputs, each
    data rank on its rows, on (4, 1) and (2, 2), REPRO_MOE_GROUPS 0 and 2:
    every dispatch's expert ids, slots and kept flags in rank order (the
    first "model" rank of each data rank's), and the output."""
    from repro_torch.models import abstract_params_and_axes, moe
    from repro_torch.sharding import specs
    from repro_torch.sharding.tensor_parallel import TensorParallel

    cfg = smoke("granite-moe-3b-a800m")
    p_np, x_np = moe_dispatch_inputs(cfg)
    res = {}
    for shape in ((4, 1), (2, 2)):
        if shape not in meshes:
            meshes[shape] = _mesh(shape)
        mesh = meshes[shape]
        params_abs, axes = abstract_params_and_axes(cfg)
        p_sh = specs.tree_shardings(axes, mesh, params_abs)
        b_pl = specs.NamedSharding(mesh, specs.spec_for(
            ("batch", None, None), mesh=mesh,
            shape=x_np.shape)).placements
        tp = TensorParallel(cfg, mesh, p_sh, params_abs, rows=b_pl)
        plans = tp.block_plans["moe"]
        p = {k: specs.local_chunk(torch.from_numpy(v), mesh,
                                  plans[k].compute) for k, v in p_np.items()}
        n, idx = tp.rows
        rows = x_np.shape[0] // n
        x = torch.from_numpy(x_np[idx * rows:(idx + 1) * rows])
        for groups in (0, 2):
            os.environ["REPRO_MOE_GROUPS"] = str(groups)
            seen = []
            real = moe.dispatch

            def spy(eidx, n_experts, cap, offset=None):
                slot, keep = real(eidx, n_experts, cap, offset)
                seen.append((eidx.reshape(-1).numpy(), slot.numpy(),
                             keep.numpy()))
                return slot, keep
            moe.dispatch = spy
            try:
                y, _ = moe.moe_ffn_split(p, x, cfg, tp, aux=False)
            finally:
                moe.dispatch = real
                os.environ.pop("REPRO_MOE_GROUPS")
            mine = None
            if mesh.get_coordinate()[1] == 0:
                mine = ([np.concatenate(t) for t in zip(*seen)],
                        y.detach().numpy())
            every = [None] * dist.get_world_size()
            dist.all_gather_object(every, mine)
            every = [e for e in every if e is not None]
            key = f"{shape[0]}x{shape[1]}/{groups}"
            for j, name in enumerate(("eidx", "slot", "keep")):
                res[f"{key}/{name}"] = np.concatenate([e[0][j]
                                                       for e in every])
            res[f"{key}/y"] = np.concatenate([e[1] for e in every])
            res[f"{key}/calls"] = np.array(len(seen))
    if rank == 0:
        np.savez(os.path.join(out, "moe_dispatch.npz"), **res)


def dp_case(out, rank):
    from repro_torch.train.compression import dp_mean_compressed
    tree = {k: torch.from_numpy(v) if not isinstance(v, dict) else
            {kk: torch.from_numpy(vv) for kk, vv in v.items()}
            for k, v in dp_tree(rank).items()}
    got = flat(dp_mean_compressed(tree))
    if rank == 0:
        np.savez(os.path.join(out, "dp_mean.npz"),
                 **{k: v.numpy() for k, v in got.items()})


def rec_init_case(meshes, out, rank):
    """``init_sharded_params`` of smoke hymba and xlstm on (2, 2) and
    (1, 4): the leaves whose gathered pieces differ from
    ``init_params``'s, and each leaf's piece and whole shape."""
    from repro_torch.models import init_params, init_sharded_params

    res = {}
    for arch in ("hymba-1.5b", "xlstm-125m"):
        cfg = smoke(arch)
        want = flat(init_params(cfg, "cpu", seed=4))
        for shape in ((2, 2), (1, 4)):
            got = flat(init_sharded_params(cfg, meshes[shape], seed=4,
                                           device="cpu"))
            res[f"{arch} {shape}"] = {
                "unequal": [k for k in want if not torch.equal(
                    got[k].full_tensor(), want[k])],
                "piece": {k: list(got[k].to_local().shape) for k in want},
                "whole": {k: list(v.shape) for k, v in want.items()}}
    if rank == 0:
        with open(os.path.join(out, "rec_init.json"), "w") as f:
            json.dump(res, f)


def rec_fit_case(meshes, out, rank):
    """``fit(mesh=)`` of smoke hymba and xlstm on (2, 2) for
    ``TRAIN_STEPS`` steps from ``init_sharded_params`` (seed 0), and the
    split step's run from ``init_params`` on the same batches: the last
    step's metrics of each."""
    from repro_torch.models import init_params
    from repro_torch.train.loop import TrainConfig, fit

    res = {}
    for arch in ("hymba-1.5b", "xlstm-125m"):
        cfg = smoke(arch)
        got = fit(cfg, data_config(cfg), opt_config(),
                  TrainConfig(steps=TRAIN_STEPS, log_every=100),
                  mesh=meshes[(2, 2)], log=lambda line: None, device="cpu")
        want, _ = _train(cfg, 1, False, meshes[(2, 2)],
                         lambda c: init_params(c, "cpu", seed=0))
        res[arch] = {"fit": got, "loss": want["loss"].tolist(),
                     "gnorm": want["gnorm"].tolist()}
    if rank == 0:
        with open(os.path.join(out, "rec_fit.json"), "w") as f:
            json.dump(res, f)


def sp_case(group: str, meshes, out, rank):
    """``SP_CASES[group]``: each case's split step (remat "full") on one
    batch of its sequence length, recording the residual entering every
    block (``transformer._block_fwd_tp`` wrapped) and every activation
    saved for the backward (``saved_tensors_hooks``), then the split
    forward's logits and loss and the step's data-mean gradient against
    the unsharded port's (``REPRO_SHARDED_CE=1``, the split step's form)
    on the whole batch."""
    from repro_torch.data.pipeline import make_batch
    from repro_torch.models import forward, loss_fn, transformer
    from repro_torch.sharding import specs
    from repro_torch.sharding.tensor_parallel import local_tree
    from repro_torch.train.loop import (TrainConfig, grads_of,
                                        make_sharded_train_step)

    os.environ["REPRO_SHARDED_CE"] = "1"
    res = []
    for shape, arch, wide, n_exp, vocab, seq in SP_CASES[group]:
        mesh = meshes[shape]
        cfg = moe_config(smoke(arch), wide, n_exp)
        if vocab:
            cfg = dataclasses.replace(cfg, vocab=vocab)
        dc = dataclasses.replace(data_config(cfg), seq_len=seq)
        tc = TrainConfig(remat="full")
        whole = whole_batch(cfg, dc, 0)
        step, p_sh, b_sh = make_sharded_train_step(cfg, opt_config(), tc,
                                                   mesh, whole)
        full = init(cfg)
        params = specs.distribute_tree(full, p_sh)
        batch = _batch(cfg, dc, 0, b_sh, mesh)
        rows = {k: v.to_local() for k, v in batch.items()}
        B = rows["tokens"].shape[0]
        residual, saved = set(), []
        real = transformer._block_fwd_tp

        def spy(*a, **kw):
            residual.add(tuple(a[5].shape))       # (cfg, tp, aux, sp, p, x)
            return real(*a, **kw)

        def pack(t):
            if t.dim() == 3 and t.shape[0] == B \
                    and t.shape[-1] == cfg.d_model:
                saved.append(tuple(t.shape))
            return t
        transformer._block_fwd_tp = spy
        try:
            with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
                g = step.grads(params, batch)
        finally:
            transformer._block_fwd_tp = real
        sh = flat(p_sh)
        shapes = {k: t.shape for k, t in flat(params).items()}
        got = {k: specs.distribute_local(v, mesh, sh[k].placements,
                                         shapes[k]).full_tensor()
               for k, v in flat(g).items()}
        with torch.no_grad():
            logits = forward(cfg, local_tree(params), rows, tp=step.tp)[0]
            loss = loss_fn(cfg, local_tree(params), rows, tp=step.tp)[0]
        every = torch.stack([loss.reshape(())])
        dist.all_reduce(every)           # each data rank's loss, m times
        glob = (dc.global_batch, seq, cfg.vocab)
        logits = specs.distribute_local(logits, mesh, specs.placements_for(
            specs.spec_for(("batch", None, "vocab"), mesh=mesh, shape=glob),
            mesh), glob).full_tensor()
        wb = {k: torch.from_numpy(v) for k, v in whole.items()}
        want_loss, _, want = grads_of(cfg, TrainConfig(), full, wb)
        with torch.no_grad():
            want_logits = forward(cfg, full, wb)[0]
        want = flat(want)
        res.append({
            "sp": step.tp.splits_sequence(B, seq), "rows": B,
            "residual": sorted(map(list, residual)),
            "saved": list(max(saved, key=math.prod)) if saved else None,
            "logit_gap": (logits - want_logits).abs().max().item(),
            "loss": float(every[0]) / dist.get_world_size(),
            "want_loss": float(want_loss),
            "grad_gap": {k: (got[k].float() - want[k].float()).abs().max()
                         .item() for k in want},
            "grad_scale": {k: want[k].float().abs().max().item()
                           for k in want},
            "split": {p: step.tp.split[p] for p in ("attn", "mlp", "moe",
                                                    "vocab", "ssm")},
            "mode": str(step.tp.moe_mode)})
    os.environ.pop("REPRO_SHARDED_CE")
    if rank == 0:
        with open(os.path.join(out, f"sp_{group}.json"), "w") as f:
            json.dump(res, f)


def _split_cases(group: str, meshes, out, rank):
    """``group``'s cases of ``TP_TRAIN_CASES`` and ``TP_SERVE_CASES``."""
    for i in group_cases(TP_TRAIN_CASES, group):
        tp_train_case(i, meshes, out)
    for i in group_cases(TP_SERVE_CASES, group):
        res = tp_serve_case(i, meshes)
        if rank == 0:
            with open(os.path.join(out, f"tp_serve_{i}.json"), "w") as f:
                json.dump(res, f)


def sharded_group(meshes, out, rank):
    mesh = meshes[(2, 2)]
    state = None
    for i in range(len(TRAIN_CASES)):
        res = train_case(i, mesh, out)
        if i == 0:
            state = res
    ckpt_case(state, out, rank)
    serve = {arch: serve_case(arch, mesh) for arch in SERVE_ARCHS}
    if rank == 0:
        with open(os.path.join(out, "serve.json"), "w") as f:
            json.dump(serve, f)
    dp_case(out, rank)
    preempt_case(mesh, out, rank)


def dense_group(meshes, out, rank):
    _split_cases("dense", meshes, out, rank)
    sp_case("dense", meshes, out, rank)
    comm_case(meshes, out, rank)
    remat_case(meshes, out, rank)
    init_case(meshes, out, rank)


def vlm_group(meshes, out, rank):
    _split_cases("vlm", meshes, out, rank)
    tp_init_case(meshes, out, rank)


def moe_group(meshes, out, rank):
    for i in range(len(MOE_TRAIN_CASES)):
        moe_train_case(i, meshes, out)
    moe_serve = [moe_serve_case(i, meshes) for i in range(len(
        MOE_SERVE_CASES))]
    if rank == 0:
        with open(os.path.join(out, "moe_serve.json"), "w") as f:
            json.dump(moe_serve, f)
    moe_comm_case(meshes, out, rank)
    moe_init_case(meshes, out, rank)
    moe_dispatch_case(meshes, out, rank)
    sp_case("moe", meshes, out, rank)


def recurrent_group(meshes, out, rank):
    _split_cases("recurrent", meshes, out, rank)
    rec_init_case(meshes, out, rank)
    rec_fit_case(meshes, out, rank)
    sp_case("recurrent", meshes, out, rank)


# the spawns, each run by its own test file
GROUPS = {"sharded": sharded_group, "dense": dense_group, "vlm": vlm_group,
          "moe": moe_group, "recurrent": recurrent_group}


def run(rank: int, world: int, store: str, out: str, group: str):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        meshes = {(2, 2): _mesh((2, 2)), (1, 4): _mesh((1, 4))}
        GROUPS[group](meshes, out, rank)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn(out: str, group: str, timeout: float = 240.0) -> None:
    """Run ``run`` of ``group`` on ``WORLD`` spawned ranks; a rank's error
    is raised here, and ranks still running at ``timeout`` seconds are
    killed and a TimeoutError raised (a hang fails, it does not stall
    the suite)."""
    import time

    import torch.multiprocessing as mp

    ctx = mp.start_processes(run, args=(WORLD, os.path.join(out, "store"),
                                        out, group),
                             nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            raise TimeoutError(f"{WORLD} ranks of {group!r} still running "
                               f"after {timeout} s")
