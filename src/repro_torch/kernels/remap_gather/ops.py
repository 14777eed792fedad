"""Public wrappers for the migration engine's copy engine: the gather
``out[i] = pool[idx[i]]`` (``remap_gather_op``) and the replay of a
maintenance pass's recorded page copies in one launch
(``remap_replay_op``).

Tensors on the CPU go to the plain versions (``ref.py``); tensors on a
card launch the hand-written kernels (``csrc/remap_gather.cu``, one copy
body for both) or raise.  ``launches`` counts every launch of the copy
engine, gather or replay; ``replay_launches`` the replays alone (reset
both by assignment).
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

from .ref import remap_gather_ref, remap_replay_ref

launches = 0
replay_launches = 0


def _bind(lib):
    """(gather entry, replay entry) with their C signatures."""
    vp, i64 = ctypes.c_void_p, ctypes.c_longlong
    gather = lib.remap_gather
    gather.argtypes = [vp, vp, vp, i64, i64, i64, vp, vp]
    gather.restype = ctypes.c_int
    replay = lib.remap_replay
    replay.argtypes = [vp, vp, vp, vp, vp, i64, i64, i64, i64, i64, vp, vp]
    replay.restype = ctypes.c_int
    return gather, replay


def new_flag(device) -> torch.Tensor:
    """A cleared out-of-range flag for a batch of copies on ``device``."""
    return torch.zeros((1,), dtype=torch.int32, device=device)


def check_flag(err: torch.Tensor):
    """Raise ``IndexError`` if a copy of the batch met an index outside
    its pool.  One host read for the whole batch."""
    if int(err.item()):
        raise IndexError("remap_gather: an index lay outside its pool")


def _check_flag_arg(err, device):
    if err.device != device or err.dtype != torch.int32 or err.numel() != 1:
        raise ValueError("remap_gather: err must be an int32 [1] flag on "
                         "the pools' device")


def remap_gather_op(pool: torch.Tensor, idx: torch.Tensor,
                    err: torch.Tensor) -> torch.Tensor:
    """pool [n, rows, cols]; idx [n_out] int32 -> [n_out, rows, cols],
    byte-exact.  On a card an index outside [0, n) is never read: the
    kernel zero-fills that slab and sets ``err`` (an int32 [1] tensor from
    ``new_flag``), which the caller reads once after its batch of copies
    (``check_flag``); the launch itself never waits for the card.  On the
    CPU such an index raises ``IndexError`` at once."""
    global launches
    if pool.device.type == "cpu":
        return remap_gather_ref(pool, idx)
    if pool.device.type != "cuda":
        raise ValueError(f"remap_gather: unsupported device {pool.device}")
    if idx.device != pool.device or idx.dtype != torch.int32 \
            or idx.dim() != 1:
        raise ValueError("remap_gather: idx must be a 1-D int32 tensor on "
                         "the pool's device")
    _check_flag_arg(err, pool.device)
    if pool.dim() != 3 or not pool.is_contiguous():
        raise ValueError("remap_gather: pool must be a contiguous "
                         "[n, rows, cols] tensor")
    idx = idx.contiguous()
    out = torch.empty((idx.shape[0],) + tuple(pool.shape[1:]),
                      dtype=pool.dtype, device=pool.device)
    slab_bytes = pool[0].numel() * pool.element_size()
    gather, _ = _build.load("remap_gather", _bind)
    rc = gather(_build.ptr(pool), _build.ptr(idx), _build.ptr(out),
                pool.shape[0], idx.shape[0], slab_bytes, _build.ptr(err),
                _build.stream_ptr(pool.device))
    if rc != 0:
        raise RuntimeError(f"remap_gather launch failed: cudaError {rc}")
    launches += 1
    return out


def remap_replay_op(pools, recs: torch.Tensor, err: torch.Tensor) -> None:
    """Replay recorded page copies in place, in record order, on every
    layer and on K and V alike.

    ``pools`` = (fast_k, fast_v, slow_k, slow_v), fast [L, n_fast, ...]
    and slow [L, n_slow, ...] with one page shape; ``recs`` [n_rec, 4]
    int32 rows (dir, src, dst, en): when ``en`` is set, dir
    ``ref.FAST_TO_SLOW`` copies fast page ``src`` to slow page ``dst`` and
    ``ref.SLOW_TO_FAST`` slow page ``src`` to fast page ``dst``; a disabled
    record is skipped unread.  Byte-exact, one launch on a card, no host
    wait: an enabled record outside its pools is dropped there and sets
    ``err`` (``check_flag`` reads it).  On the CPU such a record raises
    ``IndexError`` before anything is written."""
    global launches, replay_launches
    fk, fv, sk, sv = pools
    if fk.device.type == "cpu":
        remap_replay_ref(pools, recs)
        return
    if fk.device.type != "cuda":
        raise ValueError(f"remap_replay: unsupported device {fk.device}")
    for name, t in zip(("fast_k", "fast_v", "slow_k", "slow_v"), pools):
        if t.device != fk.device or t.dtype != fk.dtype \
                or not t.is_contiguous() or t.dim() < 2:
            raise ValueError(f"remap_replay: {name} must be a contiguous "
                             f"[L, n, ...] {fk.dtype} tensor on {fk.device}")
    if fv.shape != fk.shape or sv.shape != sk.shape \
            or sk.shape[0] != fk.shape[0] or sk.shape[2:] != fk.shape[2:]:
        raise ValueError("remap_replay: pools must be [L, n_fast, *page] "
                         "and [L, n_slow, *page], K and V alike")
    if recs.device != fk.device or recs.dtype != torch.int32 \
            or recs.dim() != 2 or recs.shape[1] != 4 \
            or not recs.is_contiguous() or recs.data_ptr() % 16:
        raise ValueError("remap_replay: recs must be a contiguous 16-byte "
                         "aligned [n_rec, 4] int32 tensor on the pools' "
                         "device")
    _check_flag_arg(err, fk.device)
    slab_bytes = math.prod(fk.shape[2:]) * fk.element_size()
    if recs.shape[0] == 0 or fk.shape[0] == 0 or slab_bytes == 0:
        return
    _, replay = _build.load("remap_gather", _bind)
    rc = replay(*(_build.ptr(t) for t in pools), _build.ptr(recs),
                recs.shape[0], fk.shape[0], fk.shape[1], sk.shape[1],
                slab_bytes, _build.ptr(err), _build.stream_ptr(fk.device))
    if rc != 0:
        raise RuntimeError(f"remap_replay launch failed: cudaError {rc}")
    launches += 1
    replay_launches += 1
