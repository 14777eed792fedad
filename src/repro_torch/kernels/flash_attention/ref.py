"""Plain PyTorch version of the prefill attention kernel (port of
``repro.kernels.flash_attention.ref``): fp32 scores, a full softmax."""

from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                  q_offset: int = 0):
    """q [B,H,S,hd]; k,v [B,KV,T,hd] -> [B,H,S,hd] in q's dtype (GQA by
    repetition: q head h reads kv head h // (H/KV)).  Query row i sits at
    absolute position ``q_offset + i``; key j at j."""
    B, H, S, hd = q.shape
    KV, T = k.shape[1], k.shape[2]
    G = H // KV
    k = k.repeat_interleave(G, dim=1)
    v = v.repeat_interleave(G, dim=1)
    s = torch.einsum("bhsk,bhtk->bhst", q.float(), k.float()) / (hd ** 0.5)
    qi = torch.arange(S, device=q.device)[:, None] + q_offset
    ki = torch.arange(T, device=q.device)[None, :]
    ok = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        ok &= ki <= qi
    if window > 0:
        ok &= ki > qi - window
    s = torch.where(ok, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhst,bhtk->bhsk", w, v.float()).to(q.dtype)
