"""Public wrapper for prefill attention in the model's layout (port of
``repro.kernels.flash_attention.ops.flash_attention_op``), and its
gradient.

Tensors on the CPU go to the plain versions (``ref.py``); tensors on a
card launch the hand-written kernels (``csrc/flash_attention.cu``, and
``csrc/flash_attention_bwd.cu`` for the backward) or raise on what they
do not take.  When an input requires a gradient (and grad mode is on)
the call goes through ``FlashAttention``, whose forward also keeps each
row's log-sum-exp for the backward; otherwise nothing is kept.
``launches`` counts forward kernel launches and ``bwd_launches``
backward ones (reset them by assignment).

The launches are ``torch.library`` operators (``repro_torch::flash_fwd``,
``flash_fwd_lse`` and ``flash_bwd``, each with a "CUDA" and a "Meta"
kernel): a real tensor on a card runs the kernel; a fake one
(``FakeTensorMode``, as the dry run traces a step) reaches the "Meta"
kernel, which gives its outputs' shapes and never builds the library, and
``FlopCounterMode`` counts each call as the plain version computes it,
every S x T product in full (``_fwd_flops``, ``_bwd_flops``).
"""

from __future__ import annotations

import ctypes

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build

from .ref import attention_bwd_ref, attention_lse_ref, attention_ref

launches = 0
bwd_launches = 0

HEAD_DIMS = (16, 32, 64, 80, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib):
    fn = lib.flash_attention
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp] * 5 + [i32] * 10 + [vp]
    fn.restype = ctypes.c_int
    return fn


def _bind_bwd(lib):
    fn = lib.flash_attention_bwd
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp] * 10 + [i32] * 10 + [vp]
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
    row's reach (``csrc/flash_attention.cu``).  Differentiable through
    ``FlashAttention`` when an input requires a gradient."""
    q_offset = int(q_offset)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, bool(causal), int(window),
                                    q_offset)
    if q.device.type == "cpu":
        return _plain(q, k, v, causal, window, q_offset)
    return _forward(q, k, v, causal, window, q_offset, with_lse=False)[0]


def _plain(q, k, v, causal, window, q_offset):
    return attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), causal=causal, window=window,
                         q_offset=q_offset).transpose(1, 2)


def _on_card(q, k, v, q_offset):
    """Check the call, and return q, k, v contiguous: both the kernel's
    launch and a fake call see the same tensors."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check(q, k, v, q_offset)
    return q.contiguous(), k.contiguous(), v.contiguous()


def _aligned(q, k, v):
    if k.data_ptr() % 16 or v.data_ptr() % 16 or q.data_ptr() % 4:
        raise ValueError("flash_attention: k and v must be 16-byte aligned "
                         "and q 4-byte aligned (the kernel copies 16-byte "
                         "rows of K and V)")


def _launch(q, k, v, causal, window, q_offset, with_lse):
    """The forward kernel's launch on contiguous q, k, v -> (out, lse
    [B,H,S] fp32 or None)."""
    global launches
    _aligned(q, k, v)
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device) \
        if with_lse else None
    rc = _build.load("flash_attention", _bind)(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
        _build.ptr(lse) if with_lse else None, B, S, T, H, KV, hd, q_offset,
        int(bool(causal)), int(window), _DTYPE_CODE[q.dtype],
        _build.stream_ptr(q.device))
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: cudaError {rc}")
    launches += 1
    return out, lse


# the launches as operators: "CUDA" runs the kernel, "Meta" (what a fake
# tensor dispatches to) gives the outputs' shapes alone
_lib = torch.library.Library("repro_torch", "DEF")
_lib.define("flash_fwd(Tensor q, Tensor k, Tensor v, bool causal, "
            "int window, int q_offset) -> Tensor")
_lib.define("flash_fwd_lse(Tensor q, Tensor k, Tensor v, bool causal, "
            "int window, int q_offset) -> (Tensor, Tensor)")
_lib.define("flash_bwd(Tensor q, Tensor k, Tensor v, Tensor o, Tensor do, "
            "Tensor lse, bool causal, int window, int q_offset) -> "
            "(Tensor, Tensor, Tensor)")


def _fwd_meta(q, k, v, causal, window, q_offset):
    return torch.empty_like(q)


def _fwd_lse_meta(q, k, v, causal, window, q_offset):
    B, S, H, _ = q.shape
    return torch.empty_like(q), q.new_empty((B, H, S), dtype=torch.float32)


_lib.impl("flash_fwd", lambda *a: _launch(*a, False)[0], "CUDA")
_lib.impl("flash_fwd", _fwd_meta, "Meta")
_lib.impl("flash_fwd_lse", lambda *a: _launch(*a, True), "CUDA")
_lib.impl("flash_fwd_lse", _fwd_lse_meta, "Meta")


def _forward(q, k, v, causal, window, q_offset, *, with_lse: bool):
    """The kernel's launch -> (out, lse [B,H,S] fp32 or None, (q, k, v)
    as launched, contiguous)."""
    q, k, v = _on_card(q, k, v, q_offset)
    args = (q, k, v, bool(causal), int(window), int(q_offset))
    if with_lse:
        out, lse = torch.ops.repro_torch.flash_fwd_lse.default(*args)
    else:
        out, lse = torch.ops.repro_torch.flash_fwd.default(*args), None
    return out, lse, (q, k, v)


def flash_attention_bwd_op(q, k, v, o, do, lse, *, causal: bool = True,
                           window: int = 0, q_offset: int = 0):
    """The gradient of ``flash_attention_op``: from the forward's inputs,
    its output ``o``, the upstream ``do`` (all in the model's layout, one
    dtype) and the forward's row log-sum-exps ``lse`` [B,H,S] fp32 ->
    (dq, dk, dv) in the inputs' layouts and dtype.  The CPU runs
    ``attention_bwd_ref``; a card the kernel."""
    q_offset = int(q_offset)
    if q.device.type == "cpu":
        t = lambda x: x.transpose(1, 2)  # noqa: E731
        dq, dk, dv = attention_bwd_ref(t(q), t(k), t(v), t(o), t(do), lse,
                                       causal=causal, window=window,
                                       q_offset=q_offset)
        return t(dq), t(dk), t(dv)
    q, k, v = _on_card(q, k, v, q_offset)
    for name, x in (("o", o), ("do", do)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"flash_attention_bwd: {name} must be "
                             f"{tuple(q.shape)} {q.dtype} on {q.device}")
    B, S, H, hd = q.shape
    if lse.shape != (B, H, S) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd: lse must be [{B}, {H}, {S}] "
                         f"fp32")
    return torch.ops.repro_torch.flash_bwd.default(
        q, k, v, o.contiguous(), do.contiguous(), lse.contiguous(),
        bool(causal), int(window), q_offset)


def _bwd_launch(q, k, v, o, do, lse, causal, window, q_offset):
    """The backward kernel's launch on contiguous inputs."""
    global bwd_launches
    _aligned(q, k, v)
    if q.data_ptr() % 16 or do.data_ptr() % 16:
        raise ValueError("flash_attention_bwd: q and do must be 16-byte "
                         "aligned (the kernel copies 16-byte rows of them)")
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    rowdot = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    rc = _build.load("flash_attention_bwd", _bind_bwd)(
        *(_build.ptr(t) for t in (q, k, v, o, do, lse, rowdot, dq, dk, dv)),
        B, S, T, H, KV, hd, q_offset, int(bool(causal)), int(window),
        _DTYPE_CODE[q.dtype], _build.stream_ptr(q.device))
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd launch failed: cudaError "
                           f"{rc}")
    bwd_launches += 1
    return dq, dk, dv


def _bwd_meta(q, k, v, o, do, lse, causal, window, q_offset):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


_lib.impl("flash_bwd", _bwd_launch, "CUDA")
_lib.impl("flash_bwd", _bwd_meta, "Meta")


def _products(q_shape, k_shape) -> int:
    """2 B H S T hd: one S x T product over every head, as the plain
    version takes it (the masked pairs included)."""
    B, S, H, hd = q_shape
    return 2 * B * H * S * k_shape[1] * hd


@register_flop_formula([torch.ops.repro_torch.flash_fwd,
                        torch.ops.repro_torch.flash_fwd_lse])
def _fwd_flops(q_shape, k_shape, *args, **kwargs) -> int:
    """Scores and the weighted sum of V: two products."""
    return 2 * _products(q_shape, k_shape)


@register_flop_formula(torch.ops.repro_torch.flash_bwd)
def _bwd_flops(q_shape, k_shape, *args, **kwargs) -> int:
    """The scores again, dV, dP, dQ and dK: five products."""
    return 5 * _products(q_shape, k_shape)


class FlashAttention(torch.autograd.Function):
    """``flash_attention_op`` with a gradient: the forward kernel, which
    also stores each row's log-sum-exp, and the backward kernel, which
    recomputes the probabilities from it (on the CPU, ``attention_ref``
    with ``attention_lse_ref`` and ``attention_bwd_ref``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        if q.device.type == "cpu":
            o = _plain(q, k, v, causal, window, q_offset)
            lse = attention_lse_ref(q.transpose(1, 2), k.transpose(1, 2),
                                    causal=causal, window=window,
                                    q_offset=q_offset)
        else:
            o, lse, (q, k, v) = _forward(q, k, v, causal, window, q_offset,
                                         with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask = dict(causal=causal, window=window, q_offset=q_offset)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_op(q, k, v, o, do, lse, **ctx.mask)
        return dq, dk, dv, None, None, None
