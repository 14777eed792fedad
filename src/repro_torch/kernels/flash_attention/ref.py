"""Plain PyTorch versions of the prefill attention kernel (port of
``repro.kernels.flash_attention.ref``: fp32 scores, a full softmax), of
the row log-sum-exps it stores for training, and of its backward."""

from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                  q_offset: int = 0):
    """q [B,H,S,hd]; k,v [B,KV,T,hd] -> [B,H,S,hd] in q's dtype (GQA by
    repetition: q head h reads kv head h // (H/KV)).  Query row i sits at
    absolute position ``q_offset + i``; key j at j."""
    G = q.shape[1] // k.shape[1]
    s, _ = _masked_scores(q, k, causal, window, q_offset)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhst,bhtk->bhsk", w,
                        v.float().repeat_interleave(G, dim=1)).to(q.dtype)


def attention_lse_ref(q, k, *, causal: bool = True, window: int = 0,
                      q_offset: int = 0):
    """Each row's log-sum-exp [B,H,S] fp32 of its scaled, masked scores
    (q [B,H,S,hd], k [B,KV,T,hd]): what the kernel stores for its
    backward."""
    return torch.logsumexp(_masked_scores(q, k, causal, window, q_offset)[0],
                           dim=-1)


def _masked_scores(q, k, causal, window, q_offset):
    """fp32 scores [B,H,S,T] times 1/sqrt(hd), -1e30 where masked."""
    B, H, S, hd = q.shape
    KV, T = k.shape[1], k.shape[2]
    k = k.repeat_interleave(H // KV, dim=1)
    s = torch.einsum("bhsk,bhtk->bhst", q.float(), k.float()) / (hd ** 0.5)
    qi = torch.arange(S, device=q.device)[:, None] + q_offset
    ki = torch.arange(T, device=q.device)[None, :]
    ok = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        ok &= ki <= qi
    if window > 0:
        ok &= ki > qi - window
    return torch.where(ok, s, NEG_INF), ok


def attention_bwd_ref(q, k, v, o, do, lse, *, causal: bool = True,
                      window: int = 0, q_offset: int = 0):
    """The backward of ``attention_ref`` from the forward's output ``o``
    and row log-sum-exps ``lse`` [B,H,S], as the kernel computes it, in
    fp32: P = exp(s - lse) on the pairs the mask keeps (0 elsewhere), D =
    rowsum(do * o), dV = P^T dO, dS = P (dO V^T - D), dQ = dS K / sqrt(hd),
    dK = dS^T Q / sqrt(hd), the G query heads of a kv head summed.
    q, o, do [B,H,S,hd]; k, v [B,KV,T,hd] -> (dq, dk, dv) in the inputs'
    layouts and dtype."""
    B, H, S, hd = q.shape
    KV = k.shape[1]
    G = H // KV
    s, ok = _masked_scores(q, k, causal, window, q_offset)
    p = torch.where(ok, torch.exp(s - lse.float()[..., None]), 0.0)
    dof, vf = do.float(), v.float().repeat_interleave(G, dim=1)
    dd = (dof * o.float()).sum(-1, keepdim=True)
    dv = torch.einsum("bhst,bhsk->bhtk", p, dof)
    ds = p * (torch.einsum("bhsk,bhtk->bhst", dof, vf) - dd)
    scale = 1.0 / hd ** 0.5
    dq = torch.einsum("bhst,bhtk->bhsk", ds,
                      k.float().repeat_interleave(G, dim=1)) * scale
    dk = torch.einsum("bhst,bhsk->bhtk", ds, q.float()) * scale

    def fold(t):                      # [B,H,T,hd] -> [B,KV,T,hd]
        return t.reshape(B, KV, G, *t.shape[2:]).sum(2)
    return dq.to(q.dtype), fold(dk).to(k.dtype), fold(dv).to(v.dtype)
