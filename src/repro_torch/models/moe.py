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

import contextlib
import os
import threading
import warnings

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


def groups() -> int:
    """``REPRO_MOE_GROUPS`` (0 when unset), read at each call as the
    reference reads it at each trace."""
    return int(os.environ.get("REPRO_MOE_GROUPS", "0"))


_local = threading.local()


@contextlib.contextmanager
def shard_of(n: int):
    """Within this context ``moe_ffn`` is called on one of ``n`` equal
    data shards of the reference's batch (the sharded steps' rows), so
    ``REPRO_MOE_GROUPS`` = G groups of the whole batch are G / n groups
    here.  The caller checks that n divides G."""
    prev = getattr(_local, "shards", 1)
    _local.shards = n
    try:
        yield
    finally:
        _local.shards = prev


def data_shards(cfg: ArchConfig, n: int, rows: int) -> int:
    """How many pieces a call over ``rows`` rows, split in ``n`` equal
    data shards, computes apart while giving the reference's values:
    ``n`` when ``n`` divides ``rows`` and, for MoE, ``REPRO_MOE_GROUPS``
    = G makes the reference route in groups that the shards split evenly
    (n divides G, G divides ``rows``).  Else 1: every rank computes every
    row, n times the work and the activations, and a warning says so."""
    if n == 1:
        return 1
    if rows % n:
        why = f"{rows} rows do not split over {n} data ranks"
    elif cfg.family == "moe" and not (groups() > 1 and groups() % n == 0
                                      and rows % groups() == 0):
        why = (f"MoE routes all {rows} rows together unless "
               f"REPRO_MOE_GROUPS is a multiple of {n} dividing {rows}")
    else:
        return n
    warnings.warn(f"{cfg.name}: every one of {n} data ranks computes the "
                  f"whole batch ({why})", stacklevel=2)
    return 1


def moe_ffn(p, x, cfg: ArchConfig):
    """x [B, S, d] -> (y [B, S, d], aux loss, a 0-d fp32 tensor).  All
    B*S tokens route together, as the reference routes them; with
    ``REPRO_MOE_GROUPS`` = G > 1 dividing B, each of G groups of B / G
    rows routes on its own (its own capacity, its own ranks) and aux is
    the groups' mean, as the reference's grouped dispatch."""
    B, S, d = x.shape
    G = groups() // getattr(_local, "shards", 1)
    if G > 1 and B % G == 0:
        xg = x.reshape(G, (B // G) * S, d)
        ys, auxs = zip(*(_moe_tokens(p, xg[i], cfg) for i in range(G)))
        return torch.stack(ys).reshape(B, S, d), torch.stack(auxs).mean()
    y, aux = _moe_tokens(p, x.reshape(B * S, d), cfg)
    return y.reshape(B, S, d), aux
