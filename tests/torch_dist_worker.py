"""Multi-rank checks of the port's sharding, run in spawned gloo processes
by ``tests/test_torch_sharding.py`` (this module imports no JAX: each
spawned process imports it afresh).

``run(rank, world, store, out)`` joins a ``world``-rank gloo group over
the file ``store``, runs every case below, and rank 0 writes what the
test compares into the directory ``out``:

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
  steps saved.
"""

from __future__ import annotations

import dataclasses
import json
import os
import warnings

import numpy as np
import torch
import torch.distributed as dist

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


def opt_config():
    from repro_torch.train.optimizer import OptConfig
    # eps 1: AdamW's first step nearly linear in the gradient (the port's
    # train-step parity setting)
    return OptConfig(lr=3e-3, warmup_steps=5, total_steps=60, eps=1.0)


def smoke(arch):
    from repro_torch.configs import get_config, reduce_for_smoke
    return reduce_for_smoke(get_config(arch))


def data_config(cfg):
    from repro_torch.data.pipeline import DataConfig
    return DataConfig(vocab=cfg.vocab, **DC_KW)


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


def _batch(dc, it, b_sh, mesh):
    from repro_torch.data.pipeline import make_batch
    from repro_torch.sharding import specs
    n, idx = specs.shard_index(next(iter(b_sh.values())).placements, mesh)
    local = make_batch(dc, it, shard=idx, n_shards=n)
    return {k: specs.distribute_local(torch.from_numpy(v), mesh,
                                      b_sh[k].placements,
                                      (dc.global_batch,) + v.shape[1:])
            for k, v in local.items()}


def train_case(i, mesh, out):
    from repro_torch.data.pipeline import make_batch
    from repro_torch.models import abstract_params_and_axes, init_params
    from repro_torch.sharding import specs
    from repro_torch.train.loop import (TrainConfig, init_sharded_state,
                                        make_sharded_train_step)

    arch, mb, compress, groups = TRAIN_CASES[i]
    os.environ["REPRO_MOE_GROUPS"] = str(groups)
    cfg = smoke(arch)
    dc = data_config(cfg)
    tc = TrainConfig(microbatches=mb, compress_grads=compress)
    step, p_sh, b_sh = make_sharded_train_step(cfg, opt_config(), tc, mesh,
                                               make_batch(dc, 0))
    params = specs.distribute_tree(init_params(cfg, "cpu", seed=0), p_sh)
    opt, err = init_sharded_state(p_sh, abstract_params_and_axes(cfg)[0],
                                  compress)
    res = {}
    g = step.grads(params, _batch(dc, 0, b_sh, mesh))
    sh, shapes = flat(p_sh), {k: t.shape for k, t in flat(params).items()}
    res.update({f"grad/{k}": specs.distribute_local(
        v, mesh, sh[k].placements, shapes[k]).full_tensor().numpy()
        for k, v in flat(g).items()})
    losses, gnorms = [], []
    for it in range(TRAIN_STEPS):
        params, opt, err, m = step(params, opt, err, _batch(dc, it, b_sh,
                                                            mesh))
        losses.append(float(m["loss"]))
        gnorms.append(float(m["gnorm"]))
    res.update({f"param/{k}": _full(v) for k, v in flat(params).items()})
    if compress:
        res.update({f"err/{k}": _full(v) for k, v in flat(err).items()})
    res["loss"], res["gnorm"] = np.array(losses), np.array(gnorms)
    res["step"] = np.array(int(opt.step.full_tensor()))
    os.environ.pop("REPRO_MOE_GROUPS")
    if dist.get_rank() == 0:
        np.savez(os.path.join(out, f"train_{i}.npz"), **res)
    return params, opt, p_sh


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
    params, opt, _ = state
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


def dp_case(out, rank):
    from repro_torch.train.compression import dp_mean_compressed
    tree = {k: torch.from_numpy(v) if not isinstance(v, dict) else
            {kk: torch.from_numpy(vv) for kk, vv in v.items()}
            for k, v in dp_tree(rank).items()}
    got = flat(dp_mean_compressed(tree))
    if rank == 0:
        np.savez(os.path.join(out, "dp_mean.npz"),
                 **{k: v.numpy() for k, v in got.items()})


def run(rank: int, world: int, store: str, out: str):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        mesh = _mesh((2, 2))
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
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn(out: str, timeout: float = 240.0) -> None:
    """Run ``run`` on ``WORLD`` spawned ranks; a rank's error is raised
    here, and ranks still running at ``timeout`` seconds are killed and
    a TimeoutError raised (a hang fails, it does not stall the suite)."""
    import time

    import torch.multiprocessing as mp

    ctx = mp.start_processes(run, args=(WORLD, os.path.join(out, "store"),
                                        out),
                             nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            raise TimeoutError(f"{WORLD} ranks still running after "
                               f"{timeout} s")
