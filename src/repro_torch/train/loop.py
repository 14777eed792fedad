"""The training step and the fault-tolerant training loop (port of
``repro.train.loop``).

``make_train_step`` assembles one step:
  loss (``models.loss_fn``, each layer under ``remat``)
  -> gradients (optionally over microbatches, with int8 error-feedback
     compression of each microbatch's gradients)
  -> AdamW (``train/optimizer.py``, in place).
On a card every attention layer runs the flash kernel forward and its
backward kernel (``kernels/flash_attention``); on the CPU the plain
attention, differentiated by autograd.

``fit`` runs the steps: parameters from the seed, resume from the latest
checkpoint, async checkpoints, SIGTERM saves and stops, a watchdog line
for a stalled step, and seekable data (``data/pipeline.py``), so a
resumed run takes the same batches and, the backward being deterministic,
reaches the same parameters as an uninterrupted one.

``make_sharded_train_step`` is the step on a ``DeviceMesh``: every
parameter, AdamW moment and error-feedback buffer is a DTensor laid out
by the reference's logical-axis specs (``sharding/specs.py``), and the
batch is split over the data axes.  The step computes tensor parallel
over "model" (``sharding/tensor_parallel.py``): each layer's pieces are
gathered over the data axes only, inside the layer loop, and each rank
runs its own heads, MLP columns (or experts), Mamba channels or xLSTM
heads and vocab columns on its rows (on a card, the flash kernels
forward and backward on H/tp heads); each leaf's gradient is reduced to
its data mean and scattered onto the leaf's piece as the backward leaves
the layer.  AdamW then runs on the shards with the global norm of the
whole gradient: ZeRO-3 over the whole mesh.  ``fit`` takes ``mesh=`` to train so.
"""

from __future__ import annotations

import dataclasses
import functools
import signal
import time
from typing import Callable

import torch

from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.configs.base import ArchConfig
from repro_torch.data.pipeline import (DataConfig, batch_rows, device_batch,
                                       make_batch)
from repro_torch.device import resolve_device
from repro_torch.models import (abstract_params_and_axes,
                                init_params_and_axes, init_sharded_params,
                                loss_fn)
from repro_torch.models import moe as moe_mod
from repro_torch.sharding import specs
from repro_torch.sharding.tensor_parallel import TensorParallel, local_tree
from repro_torch.train import compression
from repro_torch.train.optimizer import (OptConfig, OptState, apply_updates,
                                         init_opt_state, leaves, map_tree,
                                         norm_of)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    steps: int = 200
    microbatches: int = 1            # gradient accumulation
    remat: str = "none"              # none | dots | full
    compress_grads: bool = False     # int8 error-feedback accumulation
    ckpt_dir: str | None = None
    ckpt_every: int = 50
    log_every: int = 10
    watchdog_secs: float = 0.0       # > 0: warn when a step stalls


def grads_of(cfg: ArchConfig, tc: TrainConfig, params, batch, tp=None):
    """(loss, metrics, gradients in the parameters' tree and dtypes) of
    ``loss_fn`` under ``tc.remat``; ``params`` are left as they are.
    With ``tp`` (``TensorParallel``) ``params`` are this rank's pieces and
    so are the gradients: each piece's share of the data mean."""
    flat = []

    def track(t):
        t = t.detach().requires_grad_(True)
        flat.append(t)
        return t

    with torch.enable_grad():
        loss, metrics = loss_fn(cfg, map_tree(track, params), batch,
                                remat=tc.remat, tp=tp)
        gs = torch.autograd.grad(loss, flat, allow_unused=True)
    it = iter(g if g is not None else torch.zeros_like(t)
              for g, t in zip(gs, flat))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            map_tree(lambda _: next(it), params))


def make_train_step(cfg: ArchConfig, opt_cfg: OptConfig,
                    tc: TrainConfig) -> Callable:
    """Returns train_step(params, opt_state, err_state, batch) ->
    (params, opt_state, err_state, metrics); params and the optimizer's
    moments are updated in place.  With ``tc.microbatches`` > 1 the batch
    splits into that many row blocks; their gradients (each compressed
    with error feedback when ``tc.compress_grads``) are summed in fp32
    and divided by the count, and the loss is their mean, as the
    reference's scan does; metrics then hold the loss and the optimizer's
    stats only."""

    def step(params, opt_state, err_state, batch):
        if tc.microbatches > 1:
            n = tc.microbatches
            acc = map_tree(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                 device=p.device), params)
            losses = []
            for i in range(n):
                mb = {k: v.reshape((n, v.shape[0] // n) + v.shape[1:])[i]
                      for k, v in batch.items()}
                loss_i, _, g = grads_of(cfg, tc, params, mb)
                if tc.compress_grads:
                    q, s, err_state = compression.compress_tree(g, err_state)
                    g = compression.decompress_tree(q, s)
                acc = _add(acc, g)
                losses.append(loss_i)
            g = map_tree(lambda x: x / n, acc)
            loss = torch.stack(losses).mean()
            metrics = {}
        else:
            loss, metrics, g = grads_of(cfg, tc, params, batch)
            if tc.compress_grads:
                q, s, err_state = compression.compress_tree(g, err_state)
                g = compression.decompress_tree(q, s)
        params, opt_state, stats = apply_updates(opt_cfg, params, g,
                                                 opt_state)
        return params, opt_state, err_state, {"loss": loss, **stats,
                                              **metrics}

    return step


def _add(a, b):
    if isinstance(a, dict):
        return {k: _add(a[k], b[k]) for k in a}
    return a + b


# ---------------------------------------------------------------------------
# the sharded step
# ---------------------------------------------------------------------------

def batch_logical_axes(batch_like: dict) -> dict:
    """Every batch array's rows over "batch", the rest unsharded."""
    return {k: ("batch",) + (None,) * (len(v.shape) - 1)
            for k, v in batch_like.items()}


def opt_shardings(mesh, p_sh) -> OptState:
    """AdamW's state on a mesh: the step count replicated, the moments
    on the parameters' shardings."""
    return OptState(specs.NamedSharding(mesh, specs.spec_for((), mesh=mesh)),
                    p_sh, p_sh)


def init_sharded_state(p_sh, params_abs, compress: bool):
    """(AdamW state, error-feedback state or None) as zeros on the
    parameters' shardings; each rank allocates its shards only."""
    mesh = leaves(p_sh)[0].mesh
    sh = opt_shardings(mesh, p_sh)

    def zeros(p, s):
        return specs.zeros(p.shape, torch.float32, s)
    moments = lambda: specs.map_leaves(zeros, params_abs, p_sh)  # noqa: E731
    opt = OptState(specs.zeros((), torch.int32, sh.step), moments(),
                   moments())
    return opt, (moments() if compress else None)


class _Layout:
    """How one sharded step's tensors move: which mesh dims split the
    batch's rows, whether ranks compute on their own rows, and the
    collectives from per-rank values to shards."""

    def __init__(self, cfg, mesh, b_pl, rows_per_call: int):
        from torch.distributed.tensor import Partial, Replicate

        self.mesh = mesh
        self.n, self.idx = specs.shard_index(b_pl, mesh)
        self.shards = moe_mod.data_shards(cfg, self.n, rows_per_call)
        self.local = self.shards == self.n
        # how a rank's rows lie in a call's rows (None: it has them all)
        self.row_placements = b_pl if self.local else None
        # a per-rank value: a partial sum over the dims that split the
        # rows when ranks compute their own rows, else the same everywhere
        self.partial = tuple(
            Partial() if self.local and pl.is_shard(0) else Replicate()
            for pl in b_pl)

    def rows(self, full: dict, lo: int, hi: int) -> dict:
        """This rank's rows of the global rows [lo, hi)."""
        if self.local:
            step = (hi - lo) // self.n
            lo, hi = lo + self.idx * step, lo + (self.idx + 1) * step
        return {k: v[lo:hi] for k, v in full.items()}

    def data_mean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean over data shards of a per-rank tensor."""
        return specs.distribute_local(t / self.shards, self.mesh,
                                      self.partial, t.shape).full_tensor()

    def reduce(self, g: torch.Tensor, sh, compute: tuple | None = None,
               shape: tuple | None = None) -> torch.Tensor:
        """A per-rank gradient leaf -> this rank's shard of the data
        mean on ``sh`` (a sharding or its placements), in the leaf's
        dtype (summed in fp32).  ``g`` is whole on the mesh dims that do
        not split the rows, or, given ``compute``, on those placements
        (the tensor-parallel step's ``Shard`` on "model") of the global
        ``shape``."""
        pl = self.partial
        if compute is not None:
            pl = tuple(r if r.is_partial() else c
                       for r, c in zip(self.partial, compute))
        t = specs.distribute_local(g.float() / self.shards, self.mesh, pl,
                                   g.shape if shape is None else shape)
        return t.redistribute(self.mesh, getattr(sh, "placements", sh)) \
            .to_local().to(g.dtype)


def _sharded_norm(mesh, g, p_sh) -> torch.Tensor:
    """The global norm of a gradient whose leaves are this rank's shards:
    each leaf's sum of squares summed over the mesh dims that shard it
    (one all-reduce per such dim for all leaves that share the pattern),
    then added in leaf order, as ``global_norm`` adds them."""
    import torch.distributed as dist

    sums = [x.float().square().sum() for x in leaves(g)]
    dims = [tuple(i for i, pl in enumerate(s.placements) if pl.is_shard())
            for s in leaves(p_sh)]
    for pattern in set(dims):
        idx = [i for i, d in enumerate(dims) if d == pattern]
        vec = torch.stack([sums[i] for i in idx])
        for m in pattern:
            dist.all_reduce(vec, group=mesh.get_group(m))
        for i, v in zip(idx, vec.unbind()):
            sums[i] = v
    return norm_of(sums)


def make_sharded_train_step(cfg: ArchConfig, opt_cfg: OptConfig,
                            tc: TrainConfig, mesh, batch_like: dict):
    """The step on ``mesh``: returns (train_step, the parameters'
    sharding tree, the batch's shardings).

    train_step(params, opt_state, err_state, batch) -> (params,
    opt_state, err_state, metrics) takes and updates in place DTensors:
    params and the moments on the parameters' shardings (the
    reference's ``tree_shardings`` of ``abstract_params_and_axes``), the
    step count replicated, ``err_state`` (when ``tc.compress_grads``) on
    the parameters' shardings, the batch's rows over ("pod", "data").
    The values are the reference's step on the whole batch: the loss and
    its metrics are data means; with ``tc.microbatches`` = n,
    microbatch i is the global rows [i*B/n, (i+1)*B/n) and each rank
    takes its piece of them; with ``tc.compress_grads`` each
    microbatch's data-mean gradient is compressed with error feedback,
    each leaf against its whole leaf's scale.

    Ranks compute their own rows unless a microbatch does not split
    evenly over them (``moe.data_shards``, which warns); then every rank
    computes the whole batch and the gradient needs no reduction.  An
    MoE dispatch ranks each rank's choices after the earlier ranks' of
    its routing group (``moe.moe_ffn_split``), as the reference routes
    the whole batch.
    ``train_step.grads(params, batch)`` gives this rank's shards of the
    data-mean gradient, without a step.

    The step is tensor parallel (module docstring; its ``train_step.tp``
    is the ``TensorParallel``): where the sequence divides the "model"
    size a rank holds its own S/m rows of the residual stream between the
    split products, [B/dp, S/m, d], and runs the norms on them; the loss
    takes the reference's ``REPRO_SHARDED_CE`` form.  A part whose leaves
    ``spec_for`` left whole on "model" runs whole on every rank, with one
    warning when the step is made.  Peak memory of a rank in the split
    step, with P the parameters' bytes, n = dp x tp ranks, w bytes per
    parameter value, L layers, P_l one layer's parameter bytes, R = B/dp
    rows of S tokens and V the vocab:
      P/n x (1 + 8/w)      the pieces and their fp32 AdamW moments
      + 4P/(n w)           the error buffers, with compression
      + P_l/tp             one layer's pieces gathered over data
      + L x A              what autograd keeps of each layer: with remat
                           "none" its activations at H/tp heads and ff/tp
                           columns, its gathered input R S d w and its
                           gathered weights P_l/tp; with remat "full" its
                           input, this rank's rows of the residual, R S d
                           w / tp where S splits over "model" (the
                           sequence split, ``TensorParallel.
                           splits_sequence``), else R S d w
      + 3 x R S V/tp x 4   the fp32 logits, their exponentials and their
                           gradient.
    An MoE layer's activations are its [E/tp, C, d] expert buffers (C the
    routing group's capacity) and their [E/tp, C, ff] products; a hybrid
    layer's Mamba branch gathers its ``in_proj`` whole over "model"
    (2 d di w bytes)."""
    params_abs, axes = abstract_params_and_axes(cfg)
    p_sh = specs.tree_shardings(axes, mesh, params_abs)
    b_sh = {k: specs.NamedSharding(mesh, specs.spec_for(ax, mesh=mesh))
            for k, ax in batch_logical_axes(batch_like).items()}
    B = next(iter(batch_like.values())).shape[0]
    n_mb = tc.microbatches
    lay = _Layout(cfg, mesh, next(iter(b_sh.values())).placements,
                  B // n_mb)
    tp = TensorParallel(cfg, mesh, p_sh, params_abs, reduce=lay.reduce,
                        rows=lay.row_placements)
    tp.warn_whole("make_sharded_train_step")

    def grads(compute, rows):
        return grads_of(cfg, tc, compute, rows, tp=tp)

    def whole_batch(batch):
        """The batch's rows on every rank (tokens only: small)."""
        return {k: v.full_tensor() for k, v in batch.items()}

    def step(params, opt_state, err_state, batch):
        full = local_tree(params)
        if n_mb == 1 and lay.local:
            rows = {k: v.to_local() for k, v in batch.items()}
        else:
            rows = whole_batch(batch)
        if n_mb > 1:
            acc = map_tree(lambda p: torch.zeros(p.to_local().shape,
                                                 dtype=torch.float32,
                                                 device=p.device), params)
            losses = []
            for i in range(n_mb):
                loss_i, _, g = grads(full, lay.rows(rows, i * B // n_mb,
                                                    (i + 1) * B // n_mb))
                if tc.compress_grads:
                    g = compression.compress_shards(mesh, g, err_state)
                acc = _add(acc, g)
                losses.append(loss_i)
            g = map_tree(lambda x: x / n_mb, acc)
            loss = lay.data_mean(torch.stack(losses)).mean()
            metrics = {}
        else:
            loss, metrics, g = grads(full, rows)
            if tc.compress_grads:
                g = compression.compress_shards(mesh, g, err_state)
            names = sorted(metrics)
            vals = lay.data_mean(torch.stack([loss] + [metrics[k]
                                                       for k in names]))
            loss, metrics = vals[0], dict(zip(names, vals[1:]))
        del full
        gnorm = _sharded_norm(mesh, g, p_sh)
        local = OptState(opt_state.step.to_local(),
                         map_tree(lambda t: t.to_local(), opt_state.mu),
                         map_tree(lambda t: t.to_local(), opt_state.nu))
        _, new, stats = apply_updates(
            opt_cfg, map_tree(lambda t: t.to_local(), params), g, local,
            gnorm=gnorm)
        opt_state.step.to_local().copy_(new.step)
        return params, opt_state, err_state, {"loss": loss, **stats,
                                              **metrics}

    def data_mean_grads(params, batch):
        """This rank's shards of the data-mean gradient at ``params`` over
        the whole ``batch`` (one microbatch)."""
        return grads(local_tree(params),
                     lay.rows(whole_batch(batch), 0, B))[2]

    step.grads = data_mean_grads
    step.tp = tp
    return step, p_sh, b_sh


class _Preempt:
    """SIGTERM -> finish the current step, save, stop."""

    def __init__(self):
        self.flag = False
        try:
            signal.signal(signal.SIGTERM, self._h)
        except ValueError:
            pass  # not the main thread

    def _h(self, *_):
        self.flag = True

    def stop(self, mesh, device) -> bool:
        """Whether to save and stop after this step.  On a mesh every rank
        agrees (a MAX all-reduce of the flags): a rank that alone saw the
        signal would otherwise gather for its save while the others gather
        for the next step."""
        if mesh is None:
            return self.flag
        import torch.distributed as dist

        t = torch.tensor([int(self.flag)], dtype=torch.int32, device=device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return bool(t.item())


def fit(cfg: ArchConfig, dc: DataConfig, opt_cfg: OptConfig, tc: TrainConfig,
        *, mesh=None, resume: bool = True, seed: int = 0,
        log: Callable[[str], None] = print, device=None) -> dict:
    """Train from ``init_params(cfg, device, seed)`` (or the latest
    checkpoint in ``tc.ckpt_dir`` when ``resume``) to ``tc.steps`` on
    ``device`` (the card unless the caller asks for the CPU).  Returns
    the last step's metrics as floats.

    With ``mesh`` (a ``DeviceMesh`` over every rank, on ``device``'s
    type) the state is laid out by the reference's specs inside
    ``use_mesh`` and stepped by ``make_sharded_train_step``; each rank
    makes only its rows of each batch (the pipeline's ``shard`` of
    ``n_shards``), a checkpoint is gathered on every rank and written by
    rank 0, and a resume lays the checkpoint out on this mesh whatever
    mesh wrote it."""
    device = resolve_device(device)
    ctx = specs.use_mesh(mesh) if mesh is not None else None
    if ctx is not None:
        ctx.__enter__()
    try:
        return _fit(cfg, dc, opt_cfg, tc, mesh, resume, seed, log, device)
    finally:
        if ctx is not None:
            ctx.__exit__(None, None, None)


def _fit(cfg, dc, opt_cfg, tc, mesh, resume, seed, log, device):
    if mesh is not None:
        # each rank draws its own pieces: no rank holds the whole tree
        params = init_sharded_params(cfg, mesh, seed, device)
        axes = abstract_params_and_axes(cfg)[1]
        step_fn, p_sh, b_sh = make_sharded_train_step(
            cfg, opt_cfg, tc, mesh, make_batch(dc, 0))
        opt_state, err_state = init_sharded_state(
            p_sh, abstract_params_and_axes(cfg)[0], tc.compress_grads)
        b_pl = next(iter(b_sh.values())).placements
        n_rows, my_rows = specs.shard_index(b_pl, mesh)

        def batch_at(it):
            local = batch_rows(dc, it, my_rows, n_rows)
            return {k: specs.distribute_local(
                torch.from_numpy(v).to(device), mesh, b_sh[k].placements,
                (dc.global_batch,) + v.shape[1:]) for k, v in local.items()}
        shardings = {"params": p_sh, "opt": opt_shardings(mesh, p_sh)}
    else:
        params, axes = init_params_and_axes(cfg, device, seed=seed)
        opt_state = init_opt_state(params)
        err_state = (compression.init_error_state(params)
                     if tc.compress_grads else None)
        step_fn = make_train_step(cfg, opt_cfg, tc)
        batch_at = functools.partial(device_batch, dc, device=device)
        shardings = None

    mgr = CheckpointManager(tc.ckpt_dir) if tc.ckpt_dir else None
    start = 0
    if mgr and resume and mgr.latest_step() is not None:
        # the template gives the structure only: free the fresh state
        # before the restored one lands on the device
        tmpl = {"params": map_tree(lambda _: None, axes),
                "opt": OptState(None, map_tree(lambda _: None, axes),
                                map_tree(lambda _: None, axes))}
        params = opt_state = None
        restored, extra, step_no = mgr.restore(None, tmpl, device, shardings)
        params, opt_state = restored["params"], restored["opt"]
        start = step_no
        log(f"[ckpt] resumed from step {start}")

    pre = _Preempt()
    metrics = {}
    t_step = time.time()
    for it in range(start, tc.steps):
        batch = batch_at(it)
        params, opt_state, err_state, metrics = step_fn(
            params, opt_state, err_state, batch)
        if tc.watchdog_secs and (time.time() - t_step) > tc.watchdog_secs:
            log(f"[watchdog] step {it} took {time.time()-t_step:.1f}s "
                "(straggler suspected)")
        t_step = time.time()
        if it % tc.log_every == 0 or it == tc.steps - 1:
            log(f"step {it:5d} loss {float(metrics['loss']):.4f} "
                f"gnorm {float(metrics['gnorm']):.3f} "
                f"lr {float(metrics['lr']):.2e}")
        stop = pre.stop(mesh, device)
        if mgr and ((it + 1) % tc.ckpt_every == 0 or stop
                    or it == tc.steps - 1):
            mgr.save_async(it + 1, {"params": params, "opt": opt_state},
                           extra={"loss": float(metrics["loss"])})
        if stop:
            log("[preempt] SIGTERM received (by this or another rank); "
                "checkpoint queued, exiting")
            break
    if mgr:
        mgr.wait()
    return {k: float(v) for k, v in metrics.items()}
