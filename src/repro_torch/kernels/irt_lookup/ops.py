"""Public wrapper for the two-level iRT walk.

Tensors on the CPU go to the plain version (``ref.py``); tensors on a
card launch the hand-written kernel (``csrc/irt_lookup.cu``) or raise on
what it does not take.  ``launches`` counts kernel launches (reset it by
assignment).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

from .ref import irt_lookup_ref

launches = 0


def _bind(lib):
    fn = lib.irt_lookup
    vp, i64 = ctypes.c_void_p, ctypes.c_longlong
    fn.argtypes = [vp, vp, vp, vp, vp, i64, i64, i64, vp]
    fn.restype = ctypes.c_int
    return fn


def irt_lookup_op(ids, home, l1_bits, leaf_table):
    """ids, home [N] int32; l1_bits [n_words] int32; leaf_table
    [n_leaf*E] int32 -> device slots [N] int32 (``home`` where the leaf is
    unallocated or the entry INVALID).  Any N: nothing is padded.  On a
    card an id outside the leaf table is never read and yields ``home``;
    on the CPU it raises ``IndexError``."""
    global launches
    if ids.device.type == "cpu":
        return irt_lookup_ref(ids, home, l1_bits, leaf_table)
    if ids.device.type != "cuda":
        raise ValueError(f"irt_lookup: unsupported device {ids.device}")
    for name, t in (("ids", ids), ("home", home), ("l1_bits", l1_bits),
                    ("leaf_table", leaf_table)):
        if t.device != ids.device or t.dtype != torch.int32:
            raise ValueError(f"irt_lookup: {name} must be int32 on "
                             f"{ids.device}, got {t.dtype} on {t.device}")
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"irt_lookup: {name} must be a contiguous "
                             f"1-D tensor")
    if home.shape != ids.shape:
        raise ValueError(f"irt_lookup: home {tuple(home.shape)} must match "
                         f"ids {tuple(ids.shape)}")
    out = torch.empty_like(ids)
    if ids.numel() == 0:
        return out
    rc = _build.load("irt_lookup", _bind)(
        _build.ptr(ids), _build.ptr(home), _build.ptr(l1_bits),
        _build.ptr(leaf_table), _build.ptr(out), ids.shape[0],
        l1_bits.shape[0], leaf_table.shape[0], _build.stream_ptr(ids.device))
    if rc != 0:
        raise RuntimeError(f"irt_lookup launch failed: cudaError {rc}")
    launches += 1
    return out
