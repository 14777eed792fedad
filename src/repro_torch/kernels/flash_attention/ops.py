"""Public wrapper for prefill attention in the model's layout (port of
``repro.kernels.flash_attention.ops.flash_attention_op``).

Tensors on the CPU go to the plain version (``ref.py``); tensors on a
card launch the hand-written kernel (``csrc/flash_attention.cu``) or
raise on what it does not take.  ``launches`` counts kernel launches
(reset it by assignment).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

from .ref import attention_ref

launches = 0

HEAD_DIMS = (16, 32, 64, 80, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib):
    fn = lib.flash_attention
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, vp, vp] + [i32] * 10 + [vp]
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, q_offset):
    B, S, H, hd = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} must be {q.dtype} on "
                             f"{q.device}, got {t.dtype} on {t.device}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"flash_attention: dtype {q.dtype} unsupported")
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B \
            or k.shape[3] != hd:
        raise ValueError(f"flash_attention: k and v must be [{B}, T, KV, "
                         f"{hd}]")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: hd={hd} outside {HEAD_DIMS}")
    if H % k.shape[2]:
        raise ValueError(f"flash_attention: {H} query heads do not group "
                         f"over {k.shape[2]} kv heads")
    if q_offset < 0:
        raise ValueError(f"flash_attention: q_offset {q_offset} < 0")


def flash_attention_op(q, k, v, *, causal: bool = True, window: int = 0,
                       q_offset: int = 0):
    """q [B,S,H,hd]; k,v [B,T,KV,hd] -> [B,S,H,hd] in q's dtype.  Query
    row i sits at absolute position ``q_offset + i`` (a Python int), so
    one call serves a one-shot prefill (0) and a prompt chunk against the
    full key buffer (its first position).  On a card each row's result is
    bit for bit independent of S, ``q_offset`` and masked keys past the
    row's reach (``csrc/flash_attention.cu``)."""
    global launches
    q_offset = int(q_offset)
    if q.device.type == "cpu":
        return attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), causal=causal, window=window,
                             q_offset=q_offset).transpose(1, 2)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check(q, k, v, q_offset)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if k.data_ptr() % 16 or v.data_ptr() % 16 or q.data_ptr() % 4:
        raise ValueError("flash_attention: k and v must be 16-byte aligned "
                         "and q 4-byte aligned (the kernel copies 16-byte "
                         "rows of K and V)")
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    rc = _build.load("flash_attention", _bind)(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out), B, S,
        T, H, KV, hd, q_offset, int(bool(causal)), int(window),
        _DTYPE_CODE[q.dtype], _build.stream_ptr(q.device))
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: cudaError {rc}")
    launches += 1
    return out
