"""Mixture-of-Experts FFN with sort-based token dispatch (port of
``repro.models.moe``).

Token-choice top-k routing: each token's k experts come from an fp32
router, each (token, choice) takes the next free row of its expert's
fixed-capacity buffer [E, C, d] (dropped on overflow), the experts run
as batched SwiGLU matrix products over [E, C, d], and the outputs
combine weighted by the renormalised router probabilities.

The capacity ``C`` follows from the token count of the call (``capacity``),
so which tokens drop depends on everything the call routes: parked
decode lanes and prefill padding included, as in the reference.  Nothing
here waits for the card: the scatter into the buffers is an
``index_add_`` whose kept rows are unique (exact), and the dropped rows
all land in one sink row past the end.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch._scatter import top_k
from repro_torch.configs.base import ArchConfig
from repro_torch.device import torch_dtype

from .layers import stacked_init


def moe_init(g: torch.Generator, cfg: ArchConfig, device) -> dict:
    """Seeded layer-stacked experts in the reference's layout: ``router``
    [L, d, E] in fp32 (as the reference keeps it), ``w_gate``/``w_up``
    [L, E, d, ff] and ``w_down`` [L, E, ff, d] in ``cfg.dtype``, each
    scaled by 1/sqrt of its contracted input size."""
    d, ff, E, L = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.n_layers
    dt = torch_dtype(cfg.dtype)
    return {"router": stacked_init(g, L, (d, E), torch.float32, device, d),
            "w_gate": stacked_init(g, L, (E, d, ff), dt, device, d),
            "w_up": stacked_init(g, L, (E, d, ff), dt, device, d),
            "w_down": stacked_init(g, L, (E, ff, d), dt, device, ff)}


def capacity(cfg: ArchConfig, n_tokens: int) -> int:
    """Rows per expert for a call routing ``n_tokens`` tokens: the
    expected load times ``capacity_factor``, up to a multiple of 8, at
    least 8."""
    c = int(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(-(-c // 8) * 8, 8)


def route(p, xf, cfg: ArchConfig):
    """xf [T, d] -> (gate [T, K] fp32, eidx [T, K] int64, aux): the fp32
    router's softmax, its top k (ties to the lower expert, as
    ``jax.lax.top_k``) renormalised, and the Switch load-balancing loss
    E * sum_e(share of tokens whose first choice is e * mean prob of e)."""
    E, K = cfg.n_experts, cfg.top_k
    probs = torch.softmax(xf.float() @ p["router"], dim=-1)        # [T, E]
    gate, eidx = top_k(probs, K)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    experts = torch.arange(E, device=xf.device)
    frac = (eidx[:, :1] == experts).float().mean(0)
    aux = E * (frac * probs.mean(0)).sum()
    return gate, eidx, aux


def dispatch(eidx, n_experts: int, cap: int):
    """eidx [T, K] -> (slot [T*K] int64, keep [T*K] bool): each
    (token, choice), in token-major order, takes the next row of its
    expert; a choice past ``cap`` rows is dropped to the sink slot
    ``E * cap``.  The rank within an expert comes from a stable sort of
    the flat expert ids, the expert's first row from ``searchsorted``."""
    flat_e = eidx.reshape(-1)
    sorted_e, order = torch.sort(flat_e, stable=True)
    experts = torch.arange(n_experts, device=eidx.device)
    first = torch.searchsorted(sorted_e, experts, right=False)
    pos = torch.empty_like(flat_e)
    pos[order] = torch.arange(flat_e.numel(), device=eidx.device) \
        - first[sorted_e]
    keep = pos < cap
    slot = torch.where(keep, flat_e * cap + pos, n_experts * cap)
    return slot, keep


def _moe_tokens(p, xf, cfg: ArchConfig):
    """xf [T, d] -> (y [T, d], aux)."""
    T, d = xf.shape
    E, K = cfg.n_experts, cfg.top_k
    C = capacity(cfg, T)
    gate, eidx, aux = route(p, xf, cfg)
    slot, keep = dispatch(eidx, E, C)
    xs = xf[:, None].expand(T, K, d).reshape(T * K, d)   # each row K times
    buf = torch.zeros((E * C + 1, d), dtype=xf.dtype, device=xf.device)
    h = buf.index_add_(0, slot, xs)[:E * C].view(E, C, d)
    g = F.silu(torch.bmm(h, p["w_gate"].to(xf.dtype)))
    u = torch.bmm(h, p["w_up"].to(xf.dtype))
    y = torch.bmm(g * u, p["w_down"].to(xf.dtype)).view(E * C, d)
    gathered = y[slot.clamp(max=E * C - 1)] * keep[:, None].to(xf.dtype)
    out = (gathered.view(T, K, d) * gate.view(T, K, 1).to(xf.dtype)).sum(1)
    return out, aux


def moe_ffn(p, x, cfg: ArchConfig):
    """x [B, S, d] -> (y [B, S, d], aux loss, a 0-d fp32 tensor).  All
    B*S tokens route together, as the reference routes them (its
    ``REPRO_MOE_GROUPS`` split for sharded dispatch is not ported)."""
    B, S, d = x.shape
    y, aux = _moe_tokens(p, x.reshape(B * S, d), cfg)
    return y.reshape(B, S, d), aux
