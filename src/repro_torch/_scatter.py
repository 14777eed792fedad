"""Helpers with no JAX counterpart: JAX's scatter/top-k/uint32 semantics
reproduced on torch tensors.

* ``drop_set`` / ``drop_add`` / ``drop_set_`` reproduce ``x.at[idx]
  .set/add(v, mode="drop")``: negative indices in ``[-n, 0)`` wrap, and
  a lane whose index is out of range in ANY indexed dimension writes
  nothing (torch's ``index_put_`` would raise instead), and of lanes with
  one target the last writes (JAX's order on the CPU).  Nothing waits
  for the card (no ``nonzero``): the functional forms write into a copy
  with one scratch slot past the end, where every dropped lane lands;
  ``drop_add`` sums duplicate indices.  ``drop_set_`` writes in place
  (the KV pools, with ``slice(None)`` between indices, numpy's placement
  rules): a dropped lane repeats the last kept lane's write (same place,
  same value), or, when no lane is kept, writes back the bytes already
  at index 0.
* ``on_device`` makes a scalar operand on the device (a fill) instead of
  copying it from the host, and ``at`` / ``set_at`` index with a 0-d
  index tensor without reading it on the host: either would wait for
  the card.
* ``top_k`` is ``jax.lax.top_k``: ties break by lowest index, which
  ``torch.topk`` does not promise (a stable descending sort does).
* ``pack_u32`` / ``u32_to_i32`` / ``mul_u32`` carry uint32 arithmetic in
  int64: values are masked to 32 bits, an int64 product that wraps is
  still right modulo 2**32, and an int32 word keeps bit 31 exactly.
"""

from __future__ import annotations

import math

import torch

U32 = 0xFFFFFFFF


def on_device(x, dtype: torch.dtype, device) -> torch.Tensor:
    """``x``, a Python scalar or a tensor, as a ``dtype`` tensor on
    ``device``; a scalar is filled in there, never copied from the host."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.full((), x, dtype=dtype, device=device)


def _flat_index(x: torch.Tensor, index: tuple):
    """Tensor-only index tuple -> (flat index into the indexed dims, their
    size m); a lane out of range in any dimension gets m, the scratch
    slot."""
    ts = torch.broadcast_tensors(*[t.long() for t in index])
    lin, ok = 0, True
    for d, t in enumerate(ts):
        n = x.shape[d]
        lin = lin * n + t.remainder(n)              # wraps [-n, 0)
        ok = ok & (t >= -n) & (t < n)
    m = math.prod(x.shape[:len(ts)])
    return torch.where(ok, lin, m), m


def _last_writer(lin: torch.Tensor, m: int) -> torch.Tensor:
    """``lin`` with every lane but the last (in row-major lane order) of
    each target moved to the scratch slot ``m``: JAX's last-write-wins
    for duplicate indices, which a CUDA ``index_put_`` does not promise
    (two scatters of one batch, a tag and its value, could keep
    different lanes)."""
    flat = lin.reshape(-1)
    lane = torch.arange(flat.numel(), device=lin.device)
    win = torch.full((m + 1,), -1, dtype=torch.long, device=lin.device)
    win.scatter_reduce_(0, flat, lane, reduce="amax")
    return torch.where(win[flat] == lane, flat, m).view(lin.shape)


def _into_scratch_copy(x: torch.Tensor, index, val, accumulate: bool):
    index = index if isinstance(index, tuple) else (index,)
    lin, m = _flat_index(x, index)
    if not accumulate and lin.numel() > 1:
        lin = _last_writer(lin, m)
    rest = tuple(x.shape[len(index):])
    buf = x.new_empty((m + 1,) + rest)
    buf[:m] = x.reshape((m,) + rest)
    v = on_device(val, x.dtype, x.device)
    buf.index_put_((lin,), torch.broadcast_to(v, lin.shape + rest),
                   accumulate=accumulate)
    return buf[:m].view(x.shape)


def drop_set(x: torch.Tensor, index, val) -> torch.Tensor:
    """Functional ``x.at[index].set(val, mode="drop")``."""
    return _into_scratch_copy(x, index, val, accumulate=False)


def drop_add(x: torch.Tensor, index, val) -> torch.Tensor:
    """Functional ``x.at[index].add(val, mode="drop")``; duplicates sum."""
    return _into_scratch_copy(x, index, val, accumulate=True)


def drop_set_(x: torch.Tensor, index, val) -> torch.Tensor:
    """In-place ``drop_set`` (the KV pools: a copy would double their
    memory).  ``index`` may hold ``slice(None)`` entries."""
    index = index if isinstance(index, tuple) else (index,)
    adv = [d for d, i in enumerate(index) if isinstance(i, torch.Tensor)]
    for d, i in enumerate(index):
        if d not in adv and i != slice(None):
            raise ValueError(f"index entry {d} must be a tensor or ':'")
    ts = torch.broadcast_tensors(*[index[d].long() for d in adv])
    shape = ts[0].shape
    keep = torch.ones(shape, dtype=torch.bool, device=x.device)
    for d, t in zip(adv, ts):
        keep &= (t >= -x.shape[d]) & (t < x.shape[d])
    keep = keep.reshape(-1)
    # numpy placement: adjacent advanced indices keep their place, else
    # the broadcast lane dims go first
    loc = adv[0] if adv == list(range(adv[0], adv[-1] + 1)) else 0
    rest = [x.shape[d] for d in range(len(index)) if d not in adv] \
        + list(x.shape[len(index):])
    nl = len(shape)
    v = on_device(val, x.dtype, x.device)
    v = torch.broadcast_to(v, rest[:loc] + list(shape) + rest[loc:]).movedim(
        tuple(range(loc, loc + nl)), tuple(range(nl))).reshape(-1, *rest)
    any_kept = keep.any()
    # the last kept lane, as a [1] index (a 0-d index would be read on
    # the host)
    last = (keep.numel() - 1
            - torch.argmax(keep.flip(0).to(torch.int32))).view(1)
    new_index = list(index)
    for d, t in zip(adv, ts):
        t = t.reshape(-1).remainder(x.shape[d])     # wraps [-n, 0)
        new_index[d] = torch.where(keep, t, torch.where(
            any_kept, t.index_select(0, last), 0))
    new_index = tuple(new_index)
    cur = x[new_index].movedim(loc, 0)
    v = torch.where(keep.view(-1, *[1] * len(rest)), v,
                    torch.where(any_kept, v.index_select(0, last), cur))
    x[new_index] = v.movedim(0, loc)
    return x


def at(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``x[index]`` along dim 0 for an index tensor of any shape; a 0-d
    index is not read on the host, as ``x[index]`` would read it."""
    i = index.long().reshape(-1)
    return x.index_select(0, i).reshape(index.shape + x.shape[1:])


def set_at(x: torch.Tensor, index: torch.Tensor, val) -> torch.Tensor:
    """Functional ``x.at[index].set(val)`` for in-range indices (a 0-d
    index included, without a host read)."""
    out = x.clone()
    v = on_device(val, x.dtype, x.device)
    out[index.long().reshape(-1)] = v.reshape(-1, *x.shape[1:]) \
        if v.dim() > 0 else v
    return out


def top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: (values, int64 indices), ties
    broken by lowest index."""
    vals, ids = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


def first_true(mask: torch.Tensor) -> torch.Tensor:
    """``jnp.argmax`` of a bool vector: the first True lane, else 0."""
    return torch.argmax(mask.to(torch.int32), dim=-1).to(torch.int32)


def pack_u32(bits: torch.Tensor) -> torch.Tensor:
    """[..., 32] bools -> int64 words in [0, 2**32): bit i from lane i."""
    sh = torch.arange(32, dtype=torch.int64, device=bits.device)
    return (bits.to(torch.int64) << sh).sum(-1)


def u32_to_i32(v: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 -> int32 with the same bit pattern."""
    v = v & U32
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def mul_u32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``a * c`` modulo 2**32 (uint32 multiply) in int64."""
    return ((a.to(torch.int64) & U32) * c) & U32
