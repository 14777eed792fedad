"""Public wrapper for the migration gather ``out[i] = pool[idx[i]]``.

A pool on the CPU goes to the plain version (``ref.py``); a pool on a
card launches the hand-written kernel (``csrc/remap_gather.cu``) or
raises.  ``launches`` counts kernel launches (reset it by assignment).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

from .ref import remap_gather_ref

launches = 0


def _bind(lib):
    fn = lib.remap_gather
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def new_flag(device) -> torch.Tensor:
    """A cleared out-of-range flag for a batch of gathers on ``device``."""
    return torch.zeros((1,), dtype=torch.int32, device=device)


def check_flag(err: torch.Tensor):
    """Raise ``IndexError`` if a gather of the batch met an index outside
    its pool.  One host read for the whole batch."""
    if int(err.item()):
        raise IndexError("remap_gather: an index lay outside its pool")


def remap_gather_op(pool: torch.Tensor, idx: torch.Tensor,
                    err: torch.Tensor) -> torch.Tensor:
    """pool [n, rows, cols]; idx [n_out] int32 -> [n_out, rows, cols],
    byte-exact.  On a card an index outside [0, n) is never read: the
    kernel zero-fills that slab and sets ``err`` (an int32 [1] tensor from
    ``new_flag``), which the caller reads once after its batch of gathers
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
    if err.device != pool.device or err.dtype != torch.int32 \
            or err.numel() != 1:
        raise ValueError("remap_gather: err must be an int32 [1] flag on "
                         "the pool's device")
    if pool.dim() != 3 or not pool.is_contiguous():
        raise ValueError("remap_gather: pool must be a contiguous "
                         "[n, rows, cols] tensor")
    idx = idx.contiguous()
    out = torch.empty((idx.shape[0],) + tuple(pool.shape[1:]),
                      dtype=pool.dtype, device=pool.device)
    slab_bytes = pool[0].numel() * pool.element_size()
    rc = _build.load("remap_gather", _bind)(
        _build.ptr(pool), _build.ptr(idx), _build.ptr(out), pool.shape[0],
        idx.shape[0], slab_bytes, _build.ptr(err),
        _build.stream_ptr(pool.device))
    if rc != 0:
        raise RuntimeError(f"remap_gather launch failed: cudaError {rc}")
    launches += 1
    return out
