"""Public wrappers for the two-level iRT walk: to one home per id
(``irt_lookup_op``) and to both of the tiered store's homes in one pass
(``irt_walk2_op``).

Tensors on the CPU go to the plain versions (``ref.py``); tensors on a
card launch the hand-written kernels (``csrc/irt_lookup.cu``, one walk
body for both) or raise on what they do not take.  ``launches`` counts
every launch of the walk, either entry; ``walk2_launches`` those of
``irt_walk2_op`` alone (reset both by assignment).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

from .ref import irt_lookup_ref, irt_walk2_ref

launches = 0
walk2_launches = 0


def _bind(lib):
    """(one-home entry, two-home entry) with their C signatures."""
    vp, i64 = ctypes.c_void_p, ctypes.c_longlong
    one = lib.irt_lookup
    one.argtypes = [vp, vp, vp, vp, vp, i64, i64, i64, vp]
    one.restype = ctypes.c_int
    two = lib.irt_walk2
    two.argtypes = [vp, ctypes.c_int, vp, vp, vp, vp, vp, vp, vp, i64, i64,
                    i64, vp]
    two.restype = ctypes.c_int
    return one, two


def _check_1d(what, name, t, device, dtype=torch.int32):
    if t.device != device or t.dtype != dtype:
        raise ValueError(f"{what}: {name} must be {dtype} on {device}, got "
                         f"{t.dtype} on {t.device}")
    if t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{what}: {name} must be a contiguous 1-D tensor")


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
        _check_1d("irt_lookup", name, t, ids.device)
    if home.shape != ids.shape:
        raise ValueError(f"irt_lookup: home {tuple(home.shape)} must match "
                         f"ids {tuple(ids.shape)}")
    out = torch.empty_like(ids)
    if ids.numel() == 0:
        return out
    one, _ = _build.load("irt_lookup", _bind)
    rc = one(
        _build.ptr(ids), _build.ptr(home), _build.ptr(l1_bits),
        _build.ptr(leaf_table), _build.ptr(out), ids.shape[0],
        l1_bits.shape[0], leaf_table.shape[0], _build.stream_ptr(ids.device))
    if rc != 0:
        raise RuntimeError(f"irt_lookup launch failed: cudaError {rc}")
    launches += 1
    return out


def irt_walk2_op(ids, base: int, l1_bits, leaf_table, probe=None):
    """The walk of ids [N] int32 to both homes in one pass: (walked, dev),
    each [N] int32.  ``walked`` is the entry or INVALID (what the iRC fill
    records), ``dev`` the entry or ``base + id`` (the identity home in the
    unified slot space).  ``probe`` = the iRC probe's (hit [N] bool, val
    [N] int32, id_hit [N] bool) makes ``dev`` the whole translation: a hit
    takes ``val`` (``base + id`` on an identity hit), a miss the walk.  On
    a card an id outside the leaf table is never read (walked INVALID);
    on the CPU it raises ``IndexError``.  The launch never waits for the
    card."""
    global launches, walk2_launches
    if ids.device.type == "cpu":
        return irt_walk2_ref(ids, base, l1_bits, leaf_table, probe)
    if ids.device.type != "cuda":
        raise ValueError(f"irt_walk2: unsupported device {ids.device}")
    for name, t in (("ids", ids), ("l1_bits", l1_bits),
                    ("leaf_table", leaf_table)):
        _check_1d("irt_walk2", name, t, ids.device)
    if probe is not None:
        for name, t, dt in zip(("hit", "val", "id_hit"), probe,
                               (torch.bool, torch.int32, torch.bool)):
            _check_1d("irt_walk2", name, t, ids.device, dt)
            if t.shape != ids.shape:
                raise ValueError(f"irt_walk2: {name} {tuple(t.shape)} must "
                                 f"match ids {tuple(ids.shape)}")
    base = int(base)
    if not -2**31 <= base < 2**31:
        raise ValueError(f"irt_walk2: base {base} outside int32")
    walked = torch.empty_like(ids)
    dev = torch.empty_like(ids)
    if ids.numel() == 0:
        return walked, dev
    hit, val, id_hit = ((None,) * 3 if probe is None
                        else tuple(_build.ptr(t) for t in probe))
    _, two = _build.load("irt_lookup", _bind)
    rc = two(_build.ptr(ids), base, _build.ptr(l1_bits),
             _build.ptr(leaf_table), hit, val, id_hit, _build.ptr(walked),
             _build.ptr(dev), ids.shape[0], l1_bits.shape[0],
             leaf_table.shape[0], _build.stream_ptr(ids.device))
    if rc != 0:
        raise RuntimeError(f"irt_walk2 launch failed: cudaError {rc}")
    launches += 1
    walk2_launches += 1
    return walked, dev
