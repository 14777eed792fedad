"""Shared model building blocks (port of ``repro.models.layers``) and the
seeded initialisers of the port's parameters.  Parameters are nested
dicts of tensors in the reference's layout, so the reference's
``init_params`` output converts leaf by leaf (``repro_torch.weights``)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def dense_init(g, shape, dt, device, scale):
    """Truncated normal in [-2, 2] times ``scale``, drawn in fp32 from the
    generator ``g``, stored in ``dt``.  Scaled in place, so a draw holds
    one fp32 copy of the leaf beside the stored one (qwen2-72b's
    embedding table: 4.98 GB)."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=g)
    return t.mul_(scale).to(dt)


def stacked_init(g, n_layers: int, shape, dt, device, fan_in: int = 0, *,
                 scale: float | None = None, piece=None):
    """[n_layers, *shape] of ``dense_init`` draws scaled by ``scale``,
    by default 1/sqrt(``fan_in``), one layer at a time.  ``piece`` maps
    each layer's whole draw to the part kept (a rank's piece; the result
    stacks the pieces), so no more than one layer is ever whole."""
    scale = 1.0 / np.sqrt(fan_in) if scale is None else scale
    if piece is None:
        out = torch.empty((n_layers,) + tuple(shape), dtype=dt,
                          device=device)
        for i in range(n_layers):
            out[i] = dense_init(g, shape, dt, device, scale)
        return out
    out = None
    for i in range(n_layers):
        t = piece(dense_init(g, shape, dt, device, scale))
        if out is None:
            out = torch.empty((n_layers,) + tuple(t.shape), dtype=dt,
                              device=device)
        out[i] = t
        del t
    return out


def stacked_const(n_layers: int, one: torch.Tensor, piece=None):
    """[n_layers, *one.shape]: the constant layer ``one`` on every layer,
    or its ``piece`` (``stacked_init``'s)."""
    t = one if piece is None else piece(one)
    return t.expand((n_layers,) + tuple(t.shape)).contiguous()


def rms_norm(x, weight, eps: float):
    """RMSNorm in fp32, cast back to x's dtype BEFORE the weight multiply
    (as the reference does)."""
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * weight


def swiglu(x, w_gate, w_up, w_down):
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def gelu_mlp(x, w_in, b_in, w_out, b_out=None):
    """The audio family's MLP with biases.  GELU in its tanh form, which
    ``jax.nn.gelu`` computes by default (the erf form differs by ~1e-3).
    ``b_out`` None leaves the output bias out (the split MLP adds it
    after the sum over "model")."""
    y = F.gelu(x @ w_in + b_in, approximate="tanh") @ w_out
    return y if b_out is None else y + b_out


def rope_frequencies(head_dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def rope_tables(positions, head_dim: int, theta: float):
    """(cos, sin), each [..., S, 1, hd/2] fp32, for positions [..., S].
    A decode step or a prefill computes them once and every layer's q
    and k reuse them."""
    freqs = rope_frequencies(head_dim, theta, positions.device)
    angles = positions[..., None].float() * freqs          # [..., S, hd/2]
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def apply_rope(x, positions, theta: float, tables=None):
    """x [..., S, H, hd]; positions [..., S] int.  Half-split rotation:
    the first and second halves of hd form the rotated pairs.
    ``tables`` are ``rope_tables(positions, hd, theta)`` if precomputed."""
    cos, sin = tables if tables is not None \
        else rope_tables(positions, x.shape[-1], theta)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def unembed(x, table):
    """Logits in fp32: the [vocab, d] table is cast to fp32 on every call,
    as the reference does (a known cost at full width).  With a rank's
    vocab rows of the table (tensor parallelism) they are that rank's
    vocab columns of the logits."""
    return x.float() @ table.float().T
