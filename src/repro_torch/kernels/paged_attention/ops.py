"""Public wrappers for paged decode attention: the fused k-token
append+attend (``paged_attention_fused_op``), the one-token read over two
pools in place (``paged_attention_split_op``, the zero-copy path) and over
one unified pool (``paged_attention_op``, the legacy concat path).

Tensors on the CPU go to the plain versions (``ref.py``); tensors on a
card launch the hand-written kernels (``csrc/paged_attention_fused.cu``,
``csrc/paged_attention.cu``) or raise on what they do not take.
``launches``, ``split_launches`` and ``unified_launches`` count the calls
that launched each kernel (one launch each: the split pass with its merge
folded in); reset them by assignment.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

from .ref import (paged_attention_fused_ref, paged_attention_ref,
                  paged_attention_split_ref)

launches = 0
split_launches = 0
unified_launches = 0

HEAD_DIMS = (16, 32, 64, 128)
PAGE_TOKENS = (8, 16, 32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_counters: dict = {}


def _counters_for(device, n):
    """``n`` int32 arrival counters, one per (lane, kv head): the last
    block of each merges its splits and sets it back to zero, so one
    zeroed buffer per (card, stream) serves every later call."""
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 256), dtype=torch.int32, device=device)
        _counters[key] = buf
    return buf


def _scratch(name, floats, device):
    """The fp32 split scratch of one call (the caller holds it until the
    launch is enqueued); ``floats`` < 0: the rows do not fit one block."""
    if floats < 0:
        raise ValueError(f"{name}: K*G rows or the page tiles need more "
                         f"shared memory than one block has")
    return torch.empty((floats,), dtype=torch.float32, device=device)


def _bind(lib):
    """(kernel entry, scratch-size query) with their C signatures."""
    fn = lib.paged_attention_fused
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, vp, vp, vp, vp, ctypes.c_longlong, vp, vp, vp,
                   vp, vp, vp, i32, i32, i32, i32, i32, i32, i32, i32, i32,
                   vp]
    fn.restype = ctypes.c_int
    size = lib.paged_attention_fused_scratch_floats
    size.argtypes = [i32] * 8
    size.restype = ctypes.c_longlong
    return fn, size


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
    code = _DTYPE_CODE[q.dtype]
    scratch = _scratch("paged_attention_fused",
                       size(B, K, KV, G, hd, P, code, npages), q.device)
    counters = _counters_for(q.device, B * KV)
    out = torch.empty_like(q)
    rc = fn(_build.ptr(q), _build.ptr(fast_k), _build.ptr(fast_v),
            _build.ptr(slow_k), _build.ptr(slow_v), _build.ptr(entries),
            entries.stride(0), _build.ptr(k_new), _build.ptr(v_new),
            _build.ptr(pos), _build.ptr(out), _build.ptr(scratch),
            _build.ptr(counters), B, K, KV, G, hd, P, npages, NP, code,
            _build.stream_ptr(q.device))
    if rc != 0:
        raise RuntimeError(f"paged_attention_fused launch failed: "
                           f"cudaError {rc}")
    launches += 1
    return out


def _bind_paged(lib):
    """(split entry, unified entry, scratch-size query)."""
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    split = lib.paged_attention_split
    split.argtypes = [vp, vp, vp, vp, vp, vp, i64, vp, vp, vp, vp,
                      i32, i32, i32, i32, i32, i32, i32, i32, vp]
    split.restype = ctypes.c_int
    unified = lib.paged_attention_unified
    unified.argtypes = [vp, vp, vp, vp, i64, vp, vp, vp, vp,
                        i32, i32, i32, i32, i32, i32, i32, vp]
    unified.restype = ctypes.c_int
    size = lib.paged_attention_scratch_floats
    size.argtypes = [i32] * 7
    size.restype = ctypes.c_longlong
    return split, unified, size


def _check_read(name, q, pool_pairs, page_table, seq_lens):
    """What the one-token kernels take: q [B,KV,G,hd] and [n,KV,P,hd]
    pools of one dtype on q's card, contiguous and 16-byte aligned;
    page_table [B,npages] int32 with unit column stride; seq_lens [B]
    int32.  Returns the page size P."""
    if q.dim() != 4:
        raise ValueError(f"{name}: q must be [B, KV, G, hd]")
    B, KV, G, hd = q.shape
    dev, dt = q.device, q.dtype
    if dt not in _DTYPE_CODE:
        raise ValueError(f"{name}: dtype {dt} unsupported")
    P = pool_pairs[0][0].shape[2] if pool_pairs[0][0].dim() == 4 else -1
    for label, t in (("q", q),) + tuple(
            (f"pool {i}", t) for i, pr in enumerate(pool_pairs) for t in pr):
        if t.device != dev or t.dtype != dt:
            raise ValueError(f"{name}: {label} must be {dt} on {dev}, got "
                             f"{t.dtype} on {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {label} must be contiguous and "
                             f"16-byte aligned")
    for k, v in pool_pairs:
        if k.dim() != 4 or tuple(k.shape[1:]) != (KV, P, hd) \
                or k.shape != v.shape:
            raise ValueError(f"{name}: K/V pools must be matching "
                             f"[n, {KV}, page, {hd}] tensors")
    if hd not in HEAD_DIMS or P not in PAGE_TOKENS:
        raise ValueError(f"{name}: hd={hd} page={P} outside {HEAD_DIMS} x "
                         f"{PAGE_TOKENS}")
    for label, t in (("page_table", page_table), ("seq_lens", seq_lens)):
        if t.device != dev or t.dtype != torch.int32:
            raise ValueError(f"{name}: {label} must be int32 on {dev}, got "
                             f"{t.dtype} on {t.device}")
    if page_table.dim() != 2 or page_table.shape[0] != B \
            or page_table.stride(1) != 1:
        raise ValueError(f"{name}: page_table must be [{B}, npages] with "
                         f"unit column stride")
    if tuple(seq_lens.shape) != (B,) or not seq_lens.is_contiguous():
        raise ValueError(f"{name}: seq_lens must be [{B}]")
    return P


def _read_scratch(size, name, q, P, page_table):
    B, KV, G, hd = q.shape
    return _scratch(name, size(B, KV, G, hd, P, _DTYPE_CODE[q.dtype],
                               page_table.shape[1]), q.device)


def paged_attention_split_op(q, fast_k, fast_v, slow_k, slow_v, page_table,
                             seq_lens):
    """The zero-copy decode read: q [B,KV,G,hd] -> [B,KV,G,hd].  The fast
    [F,KV,P,hd] and slow pools stay separate; ``page_table`` [B,npages]
    speaks the unified index space (slot < F reads fast row slot, else
    slow row slot - F); row b sees columns below ``seq_lens[b]``.  Equal
    bit for bit to ``paged_attention_op`` over the concatenated pools.  A
    lane with seq_len <= 0 yields zeros on a card (the plain version's
    uniform average there is never read)."""
    global split_launches
    if q.device.type == "cpu":
        return paged_attention_split_ref(q, fast_k, fast_v, slow_k, slow_v,
                                         page_table, seq_lens)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_split: unsupported device "
                         f"{q.device}")
    P = _check_read("paged_attention_split", q,
                    ((fast_k, fast_v), (slow_k, slow_v)), page_table,
                    seq_lens)
    B, KV, G, hd = q.shape
    split, _, size = _build.load("paged_attention", _bind_paged)
    scratch = _read_scratch(size, "paged_attention_split", q, P, page_table)
    counters = _counters_for(q.device, B * KV)
    out = torch.empty_like(q)
    rc = split(_build.ptr(q), _build.ptr(fast_k), _build.ptr(fast_v),
               _build.ptr(slow_k), _build.ptr(slow_v), _build.ptr(page_table),
               page_table.stride(0), _build.ptr(seq_lens), _build.ptr(out),
               _build.ptr(scratch), _build.ptr(counters), B, KV, G, hd, P,
               page_table.shape[1], fast_k.shape[0], _DTYPE_CODE[q.dtype],
               _build.stream_ptr(q.device))
    if rc != 0:
        raise RuntimeError(f"paged_attention_split launch failed: "
                           f"cudaError {rc}")
    split_launches += 1
    return out


def paged_attention_op(q, k_pool, v_pool, page_table, seq_lens):
    """The legacy decode read over one unified pool [n_slots,KV,P,hd]:
    q [B,KV,G,hd] -> [B,KV,G,hd]; page j of lane b is pool row
    ``page_table[b, j]``; row b sees columns below ``seq_lens[b]``."""
    global unified_launches
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pool, v_pool, page_table, seq_lens)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    P = _check_read("paged_attention", q, ((k_pool, v_pool),), page_table,
                    seq_lens)
    B, KV, G, hd = q.shape
    _, unified, size = _build.load("paged_attention", _bind_paged)
    scratch = _read_scratch(size, "paged_attention", q, P, page_table)
    counters = _counters_for(q.device, B * KV)
    out = torch.empty_like(q)
    rc = unified(_build.ptr(q), _build.ptr(k_pool), _build.ptr(v_pool),
                 _build.ptr(page_table), page_table.stride(0),
                 _build.ptr(seq_lens), _build.ptr(out), _build.ptr(scratch),
                 _build.ptr(counters), B, KV, G, hd, P, page_table.shape[1],
                 _DTYPE_CODE[q.dtype],
                 _build.stream_ptr(q.device))
    if rc != 0:
        raise RuntimeError(f"paged_attention launch failed: cudaError {rc}")
    unified_launches += 1
    return out
