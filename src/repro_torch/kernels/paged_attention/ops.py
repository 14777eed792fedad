"""Public wrapper for the fused k-token paged append+attend.

Tensors on the CPU go to the plain version (``ref.py``); tensors on a
card launch the hand-written kernel (``csrc/paged_attention_fused.cu``)
or raise on what it does not take.  ``launches`` counts the calls that
launched the kernel (its split pass and the merge that follows it);
reset it by assignment.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

from .ref import paged_attention_fused_ref

launches = 0

HEAD_DIMS = (16, 32, 64, 128)
PAGE_TOKENS = (8, 16, 32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = 227 * 1024


def _bind(lib):
    """(kernel entry, scratch-size query) with their C signatures."""
    fn = lib.paged_attention_fused
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, vp, vp, vp, vp, ctypes.c_longlong, vp, vp, vp,
                   vp, vp, i32, i32, i32, i32, i32, i32, i32, i32, i32, vp]
    fn.restype = ctypes.c_int
    size = lib.paged_attention_fused_scratch_floats
    size.argtypes = [i32] * 6
    size.restype = ctypes.c_longlong
    return fn, size


def _smem_bytes(K, G, hd, P, itemsize):
    R = K * G
    return 2 * P * hd * itemsize + 4 * (2 * R * hd + R * P + 3 * R)


def _check(q, fast_k, fast_v, slow_k, slow_v, entries, k_new, v_new, pos):
    B, K, KV, G, hd = q.shape
    dev, dt = q.device, q.dtype
    pools = (fast_k, fast_v, slow_k, slow_v)
    for name, t in (("q", q), ("fast_k", fast_k), ("fast_v", fast_v),
                    ("slow_k", slow_k), ("slow_v", slow_v),
                    ("k_new", k_new), ("v_new", v_new)):
        if t.device != dev or t.dtype != dt:
            raise ValueError(f"paged_attention_fused: {name} must be {dt} "
                             f"on {dev}, got {t.dtype} on {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"paged_attention_fused: {name} must be "
                             f"contiguous and 16-byte aligned")
    if dt not in _DTYPE_CODE:
        raise ValueError(f"paged_attention_fused: dtype {dt} unsupported")
    P = fast_k.shape[2]
    if hd not in HEAD_DIMS or P not in PAGE_TOKENS:
        raise ValueError(f"paged_attention_fused: hd={hd} page={P} outside "
                         f"{HEAD_DIMS} x {PAGE_TOKENS}")
    for t in pools:
        if t.dim() != 4 or tuple(t.shape[1:]) != (KV, P, hd):
            raise ValueError("paged_attention_fused: pools must be "
                             f"[n, {KV}, {P}, {hd}]")
    if slow_k.shape[0] % B or slow_k.shape[0] != slow_v.shape[0] \
            or fast_k.shape[0] != fast_v.shape[0]:
        raise ValueError("paged_attention_fused: slow pools must hold B*NP "
                         "homes, fast pools matching slots")
    if tuple(k_new.shape) != (B, K, KV, hd) or k_new.shape != v_new.shape:
        raise ValueError("paged_attention_fused: k_new/v_new must be "
                         f"[{B}, {K}, {KV}, {hd}]")
    for name, t in (("entries", entries), ("pos", pos)):
        if t.device != dev or t.dtype != torch.int32:
            raise ValueError(f"paged_attention_fused: {name} must be int32 "
                             f"on {dev}")
    if entries.dim() != 2 or entries.shape[0] != B or entries.stride(1) != 1:
        raise ValueError("paged_attention_fused: entries must be [B, npages] "
                         "with unit column stride")
    if tuple(pos.shape) != (B,) or not pos.is_contiguous():
        raise ValueError(f"paged_attention_fused: pos must be [{B}]")
    if _smem_bytes(K, G, hd, P, q.element_size()) > _SMEM_LIMIT:
        raise ValueError("paged_attention_fused: K*G rows need more shared "
                         "memory than one block has")


def paged_attention_fused_op(q, fast_k, fast_v, slow_k, slow_v, entries,
                             k_new, v_new, pos):
    """Fused k-token append+attend: q [B,K,KV,G,hd] -> [B,K,KV,G,hd].

    ``entries`` [B,npages] routes each page (>= 0 fast slot, < 0 slow home
    ``b*NP + j``); its second dim may be the live-page bucket.  New rows
    are cast to the pool dtype first, so the attended values are bitwise
    the values the end-of-step scatter stores."""
    global launches
    k_new = k_new.to(fast_k.dtype)
    v_new = v_new.to(fast_v.dtype)
    if q.device.type == "cpu":
        return paged_attention_fused_ref(q, fast_k, fast_v, slow_k, slow_v,
                                         entries, k_new, v_new, pos)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_fused: unsupported device "
                         f"{q.device}")
    k_new, v_new = k_new.contiguous(), v_new.contiguous()
    _check(q, fast_k, fast_v, slow_k, slow_v, entries, k_new, v_new, pos)
    B, K, KV, G, hd = q.shape
    P = fast_k.shape[2]
    NP = slow_k.shape[0] // B
    npages = min(entries.shape[1], NP)
    fn, size = _build.load("paged_attention_fused", _bind)
    out = torch.empty_like(q)
    scratch = torch.empty((size(B, K, KV, G, hd, npages),),
                          dtype=torch.float32, device=q.device)
    rc = fn(_build.ptr(q), _build.ptr(fast_k), _build.ptr(fast_v),
            _build.ptr(slow_k), _build.ptr(slow_v), _build.ptr(entries),
            entries.stride(0), _build.ptr(k_new), _build.ptr(v_new),
            _build.ptr(pos), _build.ptr(out), _build.ptr(scratch), B, K, KV,
            G, hd, P, npages, NP, _DTYPE_CODE[q.dtype],
            _build.stream_ptr(q.device))
    if rc != 0:
        raise RuntimeError(f"paged_attention_fused launch failed: "
                           f"cudaError {rc}")
    launches += 1
    return out
