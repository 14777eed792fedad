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
reaches the same parameters as an uninterrupted one.  The sharded step
(``make_sharded_train_step``) waits for the port's sharding.
"""

from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable

import torch

from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.configs.base import ArchConfig
from repro_torch.data.pipeline import DataConfig, device_batch
from repro_torch.device import resolve_device
from repro_torch.models import init_params, loss_fn
from repro_torch.train import compression
from repro_torch.train.optimizer import (OptConfig, OptState, apply_updates,
                                         init_opt_state, map_tree)


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


def grads_of(cfg: ArchConfig, tc: TrainConfig, params, batch):
    """(loss, metrics, gradients in the parameters' tree and dtypes) of
    ``loss_fn`` under ``tc.remat``; ``params`` are left as they are."""
    flat = []

    def track(t):
        t = t.detach().requires_grad_(True)
        flat.append(t)
        return t

    with torch.enable_grad():
        loss, metrics = loss_fn(cfg, map_tree(track, params), batch,
                                remat=tc.remat)
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


def fit(cfg: ArchConfig, dc: DataConfig, opt_cfg: OptConfig, tc: TrainConfig,
        *, resume: bool = True, seed: int = 0,
        log: Callable[[str], None] = print, device=None) -> dict:
    """Train from ``init_params(cfg, device, seed)`` (or the latest
    checkpoint in ``tc.ckpt_dir`` when ``resume``) to ``tc.steps`` on
    ``device`` (the card unless the caller asks for the CPU).  Returns
    the last step's metrics as floats."""
    device = resolve_device(device)
    params = init_params(cfg, device, seed=seed)
    opt_state = init_opt_state(params)
    err_state = (compression.init_error_state(params)
                 if tc.compress_grads else None)
    step_fn = make_train_step(cfg, opt_cfg, tc)

    mgr = CheckpointManager(tc.ckpt_dir) if tc.ckpt_dir else None
    start = 0
    if mgr and resume and mgr.latest_step() is not None:
        # the template gives the structure only: free the fresh state
        # before the restored one lands on the device
        tmpl = {"params": map_tree(lambda _: None, params),
                "opt": OptState(None, map_tree(lambda _: None, params),
                                map_tree(lambda _: None, params))}
        params = opt_state = None
        restored, extra, step_no = mgr.restore(None, tmpl, device)
        params, opt_state = restored["params"], restored["opt"]
        start = step_no
        log(f"[ckpt] resumed from step {start}")

    pre = _Preempt()
    metrics = {}
    t_step = time.time()
    for it in range(start, tc.steps):
        batch = device_batch(dc, it, device)
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
        if mgr and ((it + 1) % tc.ckpt_every == 0 or pre.flag
                    or it == tc.steps - 1):
            mgr.save_async(it + 1, {"params": params, "opt": opt_state},
                           extra={"loss": float(metrics["loss"])})
        if pre.flag:
            log("[preempt] SIGTERM received; checkpoint queued, exiting")
            break
    if mgr:
        mgr.wait()
    return {k: float(v) for k, v in metrics.items()}
