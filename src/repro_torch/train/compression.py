"""int8 error-feedback gradient compression (port of
``repro.train.compression``): gradients are quantised to int8 with a
per-leaf scale, and the quantisation residual is carried to the next
step, which keeps the optimizer unbiased over steps.  ``make_train_step``
uses it on the microbatch accumulators, ``make_sharded_train_step`` on
each rank's shard of the data-mean gradient (the scale from the whole
leaf).  ``dp_mean_compressed`` is the int8 data-parallel mean over a
process group."""

from __future__ import annotations

import torch

from .optimizer import leaves, map_tree


def _scale_for(g, amax=None):
    if amax is None:
        amax = g.float().abs().max()
    return torch.clamp(amax / 127.0, min=1e-12)


def quantize(g, err=None, amax=None):
    """g (+ carried error) -> (int8 payload, fp32 scale, new error).
    ``torch.round`` rounds half to even, as ``jnp.round`` does.  ``amax``,
    when given, is max |g + err| over the whole leaf of which ``g`` is a
    shard."""
    gf = g.float()
    if err is not None:
        gf = gf + err
    scale = _scale_for(gf, amax)
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


def dp_mean_compressed(tree, group=None):
    """Mean of a gradient tree over the ranks of ``group`` (None: the
    world) with int8 payloads, as the reference's ``dp_mean_compressed``
    computes it per shard: every rank quantises its own leaf against the
    ranks' largest scale (a MAX all-reduce), the int8 payloads are summed
    as int32 (a SUM all-reduce), then rescaled and divided by the rank
    count, in the leaf's dtype.  One all-reduce of each kind for the
    whole tree."""
    import torch.distributed as dist

    flat = leaves(tree)
    n = dist.get_world_size(group)
    smax = torch.stack([_scale_for(g) for g in flat])
    dist.all_reduce(smax, op=dist.ReduceOp.MAX, group=group)
    q = [torch.clamp(torch.round(g.float() / s), -127, 127).to(torch.int8)
         for g, s in zip(flat, smax)]
    tot = torch.cat([x.reshape(-1).to(torch.int32) for x in q])
    dist.all_reduce(tot, op=dist.ReduceOp.SUM, group=group)
    out = [(t.view(g.shape).float() * s / n).to(g.dtype) for t, g, s in
           zip(tot.split([g.numel() for g in flat]), flat, smax)]
    return _unflatten(tree, iter(out))


def compress_shards(mesh, grads, err_tree):
    """Error-feedback compression of a tree of shards on ``mesh``
    (``err_tree``: DTensors on the same shardings), each shard against
    the scale of its whole leaf (one MAX all-reduce per mesh dim for the
    tree), so the values are those of ``compress_tree`` on the whole
    leaves.  Returns the dequantised shards; the new errors are written
    into ``err_tree``'s shards in place."""
    import torch.distributed as dist

    gs, es = leaves(grads), [e.to_local() for e in leaves(err_tree)]
    amax = torch.stack([(g.float() + e).abs().max() for g, e in zip(gs, es)])
    for i in range(mesh.ndim):
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=mesh.get_group(i))
    out = []
    for g, e, a in zip(gs, es, amax):
        q, s, new = quantize(g, e, amax=a)
        e.copy_(new)
        out.append(dequantize(q, s))
    return _unflatten(grads, iter(out))
