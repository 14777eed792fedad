"""AdamW with global-norm clipping and a warmup-then-cosine schedule
(port of ``repro.train.optimizer``), as plain functions on parameter
trees (nested dicts of tensors).

Not ``torch.optim.AdamW``: the reference takes the decay into the update
before the learning rate multiplies it, decays only leaves with two or
more dimensions, keeps fp32 moments for every leaf, and casts the fp32
result back to the leaf's dtype; this module repeats its arithmetic op
for op.  ``apply_updates`` updates the parameters and the moments IN
PLACE (the reference returns new trees): at llama3-8b's width a second
copy of the fp32 moments alone would take 8 bytes a parameter.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class OptState(NamedTuple):
    step: torch.Tensor      # 0-d int32: updates applied
    mu: Any                 # fp32 first moments, the parameters' tree
    nu: Any                 # fp32 second moments


def leaves(tree) -> list:
    """The tensors of a tree of dicts in the reference's leaf order
    (dict keys sorted)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in leaves(tree[k])]
    return [tree]


def map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def init_opt_state(params) -> OptState:
    leaf = leaves(params)[0]
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    return OptState(torch.zeros((), dtype=torch.int32, device=leaf.device),
                    map_tree(zeros, params), map_tree(zeros, params))


def schedule(cfg: OptConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor): linear warmup to
    ``cfg.lr``, then cosine down to ``min_lr_frac`` of it, in fp32."""
    step = step.float()
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(tree) -> torch.Tensor:
    return norm_of(g.float().square().sum() for g in leaves(tree))


def norm_of(sums) -> torch.Tensor:
    """sqrt of the leaves' sums of squares, added in leaf order."""
    return torch.sqrt(sum(sums))


@torch.no_grad()
def apply_updates(cfg: OptConfig, params, grads, state: OptState,
                  gnorm=None):
    """One AdamW step: params, ``state.mu`` and ``state.nu`` are updated
    in place.  Returns (params, new state, {"gnorm", "lr"} as 0-d fp32
    tensors).  ``gnorm``, when given, is the clip's global norm (the
    sharded step passes the norm of the whole gradient, with this rank's
    shards as the trees); else ``global_norm(grads)``."""
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = state.step + 1
    lr = schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()
    for p, g, mu, nu in zip(leaves(params), leaves(grads), leaves(state.mu),
                            leaves(state.nu)):
        g = g.float() * scale
        mu.copy_(cfg.b1 * mu + (1 - cfg.b1) * g)
        nu.copy_(cfg.b2 * nu + (1 - cfg.b2) * g.square())
        delta = (mu / b1c) / (torch.sqrt(nu / b2c) + cfg.eps)
        if p.dim() >= 2:  # decoupled weight decay on matrices only
            delta = delta + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
    return params, OptState(step, state.mu, state.nu), {"gnorm": gnorm,
                                                        "lr": lr}
