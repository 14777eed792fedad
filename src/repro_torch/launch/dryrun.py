"""Multi-pod dry run (port of ``repro.launch.dryrun``).

For every (architecture x input-shape) cell, run the port's real split
step (``train.loop.make_sharded_train_step``, ``serve.decode.
jit_prefill`` or ``jit_decode``) as rank 0 of the production mesh, 16x16
("data", "model") or 2x16x16 ("pod", "data", "model"), on fake tensors
(``FakeTensorMode``: shapes and dtypes, no storage) over a process group
of the "fake" backend at the mesh's world size (``mesh.make_fake_mesh``:
its collectives move nothing), and record, as the reference records
from XLA:

  * ``memory``: the rank's argument, output and temp bytes at dispatch
    (``utils/step_analysis.StepMemory``), and ``fits``: its peak within
    the card's ``HBM_BYTES``;
  * ``cost``: FLOPs (``FlopCounterMode``) and bytes moved, for the
    roofline;
  * ``collectives``: each kind's output bytes and count, and the bytes
    on each mesh axis;
  * ``roofline``: the terms at the H100's peaks (``launch/mesh.py``).

Parameters, AdamW state, decode state and inputs are fake DTensors of
the rank's local shapes on the reference's specs: nothing is drawn.  The
device defaults to the card, as every entry point of the port: on
"cuda" each attention reaches flash's fake op (one call, what the card
launches); ``--device cpu`` reckons the plain path instead, whose
attention materialises its scores (``models/attention.sdpa_auto``: the
quadratic path, or ``chunked_sdpa``'s blocks past 4,096 tokens, a
Python loop that makes a 32k prefill trace for minutes).

Results append to ``dryrun_results/dryrun_<mesh>.jsonl`` (gitignored);
re-runs skip completed cells (the sweep is resumable).

Usage (the card's host, or any host with ``--device cpu``):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
      [--force] [--remat full|dots|none] [--microbatches N] [--device cpu]
(``--arch`` or ``--shape`` alone runs every cell of that arch or shape.
A cell's trace is one host thread, and xlstm-125m's prefill_32k and
train_4k trace its sLSTM token loop op by op, the better part of an
hour each: run those side by side, one process each with
``--arch xlstm-125m --shape ...`` and the same ``--out``, before or
after ``--all``, which then skips them.  Each record is one line
appended in one write.)
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "dryrun_results")


def _local_shape(shape, sharding) -> list:
    """A leaf's local shape on ``sharding``: each mesh dim that shards a
    dimension divides it (``spec_for`` keeps only axes that divide)."""
    out = list(shape)
    for i, pl in enumerate(sharding.placements):
        if pl.is_shard():
            out[pl.dim] //= sharding.mesh.size(i)
    return out


def _placed(abs_tree, sh_tree, device):
    """A tree of DTensors on ``sh_tree`` shaped as ``abs_tree``'s meta
    leaves, each rank's piece zeros on ``device`` (fake ones under
    ``FakeTensorMode``)."""
    import torch

    from repro_torch.sharding import specs

    return specs.map_leaves(
        lambda a, sh: specs.distribute_local(
            torch.zeros(_local_shape(a.shape, sh), dtype=a.dtype,
                        device=device), sh.mesh, sh.placements,
            tuple(a.shape)), abs_tree, sh_tree)


def _raw_bytes(tree) -> int:
    """Bytes of the local pieces of a tree's tensors (no rounding)."""
    from repro_torch.utils.step_analysis import _bytes, _tensors
    return sum(_bytes(t) for t in _tensors(tree))


def _build(cfg, shape, mesh, *, prompt_len, remat, microbatches):
    """(the step for this cell on ``mesh``, [(part, abstract tree of its
    arguments, their shardings)]).  The step is built before any fake
    mode: a ``DeviceMesh`` flattens its axes with real tensor ops."""
    import torch

    from repro_torch.models import abstract_params_and_axes, input_specs
    from repro_torch.serve.decode import (batch_shardings,
                                          decode_state_shardings,
                                          jit_decode, jit_prefill)
    from repro_torch.sharding import specs

    params_abs, axes = abstract_params_and_axes(cfg)
    p_sh = specs.tree_shardings(axes, mesh, params_abs)
    if shape.kind == "decode":
        fn, (params_abs, state_abs, t_abs) = jit_decode(cfg, shape, mesh)
        return fn, [
            ("params", params_abs, p_sh),
            ("state", state_abs, decode_state_shardings(cfg, state_abs,
                                                        mesh)),
            ("inputs", t_abs,
             batch_shardings({"tokens": t_abs}, mesh)["tokens"])]
    specs_in = input_specs(cfg, shape)
    if prompt_len is not None:
        specs_in = {k: v if k == "image_embeds" else torch.empty(
            (v.shape[0], prompt_len) + tuple(v.shape[2:]), dtype=v.dtype,
            device="meta") for k, v in specs_in.items()}
    if shape.kind == "prefill":
        fn, _ = jit_prefill(cfg, shape, mesh)
        return fn, [("params", params_abs, p_sh),
                    ("inputs", specs_in, batch_shardings(specs_in, mesh))]
    from repro_torch.train.loop import (TrainConfig, make_sharded_train_step,
                                        opt_shardings)
    from repro_torch.train.optimizer import OptConfig, OptState

    step, p_sh, b_sh = make_sharded_train_step(
        cfg, OptConfig(), TrainConfig(remat=remat, microbatches=microbatches),
        mesh, specs_in)
    f32 = specs.map_leaves(
        lambda a: torch.empty(a.shape, dtype=torch.float32, device="meta"),
        params_abs)
    opt_abs = OptState(torch.empty((), dtype=torch.int32, device="meta"),
                       f32, f32)

    def train_step(params, opt_state, batch):
        return step(params, opt_state, None, batch)
    return train_step, [("params", params_abs, p_sh),
                        ("opt_state", opt_abs, opt_shardings(mesh, p_sh)),
                        ("inputs", specs_in, b_sh)]


def _place(parts, device) -> tuple[list, dict]:
    """(the step's arguments, {part: bytes}) from ``_build``'s parts:
    zeros of each rank's local shapes (fake under ``FakeTensorMode``)."""
    args = [_placed(a, sh, device) for _, a, sh in parts]
    return args, {name: _raw_bytes(t) for (name, _, _), t in zip(parts, args)}


@contextlib.contextmanager
def _fake_group(mesh_shape, device):
    """The ``DeviceMesh`` of ``mesh_shape`` over a fake process group
    while on; the group is destroyed after."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_fake_mesh

    mesh = make_fake_mesh(mesh_shape, device)
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


def _fake_mode():
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode(allow_non_fake_inputs=True)


def _arguments(cfg, shape, mesh_shape, *, device=None,
               prompt_len: int | None = None, remat: str = "full",
               microbatches: int = 1) -> dict:
    """{part: bytes} of the arguments ``run_step`` gives the step (its
    "parts"), built on fake tensors without running the step: the
    reference's ``argument_size_in_bytes`` without the run, which for a
    32k prefill on the plain path takes a minute or two."""
    from repro_torch.device import resolve_device

    device = resolve_device(device)
    with _fake_group(mesh_shape, device) as mesh:
        _, parts = _build(cfg, shape, mesh, prompt_len=prompt_len,
                          remat=remat, microbatches=microbatches)
        with _fake_mode():
            return _place(parts, device)[1]


def _group_ranks(name: str) -> list[int]:
    """The global ranks of the process group named ``name``."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    return dist.get_process_group_ranks(_resolve_process_group(name))


def run_step(cfg, shape, mesh_shape, *, device=None, fake: bool = True,
             prompt_len: int | None = None, remat: str = "full",
             microbatches: int = 1) -> dict:
    """Run one step of ``cfg`` at ``shape`` as rank 0 of ``mesh_shape``
    (a ``MeshShape``) over a fake process group, and reckon it: the
    record's "memory", "fits", "cost", "collectives", "roofline",
    "trace_s", "card" (whose peaks the roofline takes), and "parts"
    (argument bytes by part: parameters, AdamW state, decode state,
    inputs; unrounded, as ``_arguments``), "caches" (a prefill's caches'
    bytes), "calls" (``calls_by_group`` by mesh axis) and "ops" (the
    calls of the port's own ops, flash's).  ``fake`` False runs it on zeros of
    the same shapes instead (the CPU tests' control); ``prompt_len``
    gives a prefill a prompt shorter than ``shape.seq_len``, the caches'
    length; ``remat`` and ``microbatches`` set a train step's
    ``TrainConfig``.  No process group may be initialised."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import (CARD, HBM_BYTES, axis_links,
                                         group_axes)
    from repro_torch.utils import step_analysis as sa

    device = resolve_device(device)
    t0 = time.perf_counter()
    with _fake_group(mesh_shape, device) as mesh:
        fn, parts = _build(cfg, shape, mesh, prompt_len=prompt_len,
                           remat=remat, microbatches=microbatches)
        with _fake_mode() if fake else contextlib.nullcontext():
            args, parts = _place(parts, device)
            flops, cost, log, mem = (FlopCounterMode(display=False),
                                     sa.StepCost(), sa.StepCollectives(),
                                     sa.StepMemory())
            mem.arguments(args)
            with flops, cost, log, mem:
                out = fn(*args)
            mem.outputs(out)
            caches = _raw_bytes(out[1].caches) if shape.kind == "prefill" \
                and hasattr(out[1], "caches") else None
            del out, args
        groups = {c.group: _group_ranks(c.group) for c in log.calls
                  if c.group is not None}
    trace_s = time.perf_counter() - t0
    # each group by the mesh axes it spans: a flattened mesh's
    # ("pod", "data") group is "pod+data"
    axes = {g: group_axes(mesh_shape, r) for g, r in groups.items()}
    sizes = {g: len(r) for g, r in groups.items()}
    memory = mem.memory()
    coll = sa.collective_bytes(log.calls, axes, sizes)
    summary = sa.summarize_cost(flops, cost)
    return {
        "status": "ok",
        "trace_s": round(trace_s, 1),
        "device": device.type,
        "fake": fake,
        "cost": summary,
        "collectives": coll,
        "memory": memory,
        "fits": memory["peak_bytes"] <= HBM_BYTES,
        "card": CARD,
        "roofline": sa.roofline_terms(
            summary["flops"], summary["bytes"], coll["total_bytes"],
            math.prod(mesh_shape.shape), by_axis=coll["by_axis_bytes"],
            links=axis_links(mesh_shape, set(axes.values()))),
        "parts": parts,
        "caches": caches,
        "calls": sa.calls_by_group(log.calls, axes),
        "ops": {k: v for k, v in cost.ops.items()
                if k.startswith("repro_torch.")},
        "n_devices": math.prod(mesh_shape.shape),
    }


def run_cell(arch: str, shape_name: str, multi_pod: bool, *, device=None,
             remat: str = "full", microbatches: int = 1) -> dict:
    """The reference's record of one (arch, shape) cell on the production
    mesh (``run_step``; "trace_s" in place of "compile_s"), or
    ``status`` "skipped" with the reason for a cell the skip rules
    leave out."""
    from repro_torch.configs import SHAPES, cell_supported, get_config
    from repro_torch.launch.mesh import make_production_mesh

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = cell_supported(cfg, shape)
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "2x16x16" if multi_pod else "16x16"}
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec
    rec.update(run_step(cfg, shape, make_production_mesh(multi_pod=multi_pod),
                        device=device, remat=remat,
                        microbatches=microbatches))
    rec.update(params=cfg.n_params(), active_params=cfg.n_active_params())
    return rec


def _done_cells(path: str) -> set:
    done = set()
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                try:
                    r = json.loads(line)
                    if r.get("status") in ("ok", "skipped"):
                        done.add((r["arch"], r["shape"]))
                except json.JSONDecodeError:
                    pass
    return done


def _cell_record(arch: str, shape: str, args) -> dict:
    """``run_cell``'s record of one cell under ``main``'s ``args``, or
    ``status`` "error" with the exception."""
    try:
        return run_cell(arch, shape, args.multi_pod, device=args.device,
                        remat=args.remat, microbatches=args.microbatches)
    except Exception as e:
        return {"arch": arch, "shape": shape,
                "mesh": "2x16x16" if args.multi_pod else "16x16",
                "status": "error", "error": f"{type(e).__name__}: {e}",
                "trace": traceback.format_exc()[-2000:]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--remat", default="full",
                    choices=("none", "dots", "full"))
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu: the plain path")
    args = ap.parse_args(argv)
    if not (args.all or args.arch or args.shape):
        ap.error("give --arch, --shape or --all")

    from repro_torch.configs import ALL_ARCHS, SHAPES

    mesh_tag = "2x16x16" if args.multi_pod else "16x16"
    out_path = args.out or os.path.abspath(
        os.path.join(RESULTS_DIR, f"dryrun_{mesh_tag}.jsonl"))
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)

    # --arch or --shape alone: every cell of that arch or shape
    cells = [(a, s) for a in ALL_ARCHS for s in SHAPES
             if args.arch in (None, a) and args.shape in (None, s)]
    done = set() if args.force else _done_cells(out_path)

    todo = []
    for arch, shape in cells:
        if (arch, shape) in done:
            print(f"[skip-done] {arch} x {shape}")
        else:
            todo.append((arch, shape))
    print(f"[dryrun] {len(todo)} cells on {mesh_tag} ...", flush=True)
    for arch, shape in todo:
        rec = _cell_record(arch, shape, args)
        with open(out_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        msg = rec["status"]
        if rec["status"] == "ok":
            msg += (f" trace={rec['trace_s']}s "
                    f"peak={rec['memory']['peak_bytes'] / 2**30:.2f}GiB "
                    f"fits={rec['fits']} "
                    f"flops={rec['cost']['flops']:.3e} "
                    f"coll={rec['collectives']['total_bytes']:.3e}B "
                    f"bound={rec['roofline']['dominant']}")
        elif rec["status"] == "error":
            msg += " " + rec["error"][:200]
        print(f"[dryrun] {arch} x {shape}: {msg}", flush=True)


if __name__ == "__main__":
    main()
