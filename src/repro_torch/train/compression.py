"""int8 error-feedback gradient compression (port of
``repro.train.compression``): gradients are quantised to int8 with a
per-leaf scale, and the quantisation residual is carried to the next
step, which keeps the optimizer unbiased over steps.  ``make_train_step``
uses it on the microbatch accumulators.  The data-parallel reduction
(``dp_mean_compressed``) waits for the port's sharding."""

from __future__ import annotations

import torch

from .optimizer import leaves, map_tree


def _scale_for(g):
    amax = g.float().abs().max()
    return torch.clamp(amax / 127.0, min=1e-12)


def quantize(g, err=None):
    """g (+ carried error) -> (int8 payload, fp32 scale, new error).
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    gf = g.float()
    if err is not None:
        gf = gf + err
    scale = _scale_for(gf)
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    new_err = gf - q.float() * scale
    return q, scale, new_err


def dequantize(q, scale):
    return q.float() * scale


def _unflatten(tree, it):
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], it) for k in sorted(tree)}
    return next(it)


def compress_tree(grads, err_tree):
    """-> (int8 payloads, scales, new errors), each a tree like grads."""
    flat_e = leaves(err_tree) if err_tree is not None \
        else [None] * len(leaves(grads))
    out = [quantize(g, e) for g, e in zip(leaves(grads), flat_e)]
    return tuple(_unflatten(grads, iter([o[i] for o in out]))
                 for i in range(3))


def decompress_tree(qs, scales):
    return _unflatten(qs, iter([dequantize(q, s) for q, s in
                                zip(leaves(qs), leaves(scales))]))


def init_error_state(params):
    return map_tree(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
