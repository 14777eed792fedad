"""Plain PyTorch versions of paged decode attention.

``paged_attention_ref`` (one unified pool) and ``paged_attention_split_ref``
(fast and slow pools read in place, each page routed by ``slot <
fast_slots``) are the port of ``repro.kernels.paged_attention.ref``: two
gather front ends over one ``_attend_pages`` tail, so a split read equals
a unified read of the concatenated pools bit for bit by construction.

``paged_attention_fused_ref`` computes what
``repro.kernels.paged_attention.ref.paged_attention_fused_ref`` computes,
walking the pages in order with an fp32 online softmax as the CUDA
kernel does.  Page order is what keeps the live-page bucket exact: a
page every row masks adds m unchanged, p = exp(-1e30 - m) = 0, corr = 1
and a zero product (the pools are zero-initialised, so they never hold
non-finite bytes), so attending a bucket of the first ``n`` pages equals
attending the full width bit for bit for every live lane.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _attend_pages(q, k, v, seq_lens):
    """q [B,KV,G,hd]; gathered k/v [B,KV,T,hd]; seq_lens [B]: full fp32
    softmax over the columns below ``seq_lens[b]``."""
    hd = q.shape[-1]
    s = torch.einsum("bkgh,bkth->bkgt", q.float(), k.float()) / (hd ** 0.5)
    col = torch.arange(k.shape[2], device=q.device)
    s = torch.where(col < seq_lens[:, None, None, None], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bkgt,bkth->bkgh", w, v.float()).to(q.dtype)


def _flatten_pages(x):
    """[B,npages,KV,page,hd] -> [B,KV,npages*page,hd]."""
    B, npages, KV, page, hd = x.shape
    return x.transpose(1, 2).reshape(B, KV, npages * page, hd)


def paged_attention_ref(q, k_pool, v_pool, page_table, seq_lens):
    """q [B,KV,G,hd]; pools [n_slots,KV,page,hd]; page_table [B,npages]
    int32 slots; seq_lens [B] -> [B,KV,G,hd]."""
    B, npages = page_table.shape
    flat = page_table.reshape(-1).long()

    def pick(pool):
        x = pool.index_select(0, flat)
        return _flatten_pages(x.view(B, npages, *pool.shape[1:]))

    return _attend_pages(q, pick(k_pool), pick(v_pool), seq_lens)


def paged_attention_split_ref(q, fast_k, fast_v, slow_k, slow_v,
                              page_table, seq_lens):
    """The unified read with the pools kept apart: slot < fast_slots reads
    the fast pool, else the slow pool at ``slot - fast_slots``; no
    concatenated copy is made."""
    B, npages = page_table.shape
    fast_slots = fast_k.shape[0]
    flat = page_table.reshape(-1).long()
    is_fast = flat < fast_slots
    fidx = torch.where(is_fast, flat, 0)
    sidx = torch.where(is_fast, 0, flat - fast_slots)
    sel = is_fast[:, None, None, None]

    def pick(fast, slow):
        x = torch.where(sel, fast.index_select(0, fidx),
                        slow.index_select(0, sidx))
        return _flatten_pages(x.view(B, npages, *x.shape[1:]))

    return _attend_pages(q, pick(fast_k, slow_k), pick(fast_v, slow_v),
                         seq_lens)


def paged_attention_fused_ref(q, fast_k, fast_v, slow_k, slow_v, entries,
                              k_new, v_new, pos):
    """q [B,K,KV,G,hd]; fast pools [F,KV,page,hd]; slow pools
    [B*NP,KV,page,hd] (lane b page j at row b*NP+j); entries [B,npages]
    int32 (>= 0 a fast slot, < 0 the slow home; npages may be a bucket);
    k_new/v_new [B,K,KV,hd] in the pool dtype; pos [B] (first new token's
    position, < 0 parks the lane).  Returns [B,K,KV,G,hd] in q's dtype.

    Token t of lane b sees columns below pos+1+t, overlaid with the new
    rows at positions pos..pos+K-1; a parked lane sees nothing (its
    output is a uniform average here and zeros from the CUDA kernel, and
    is never read)."""
    B, K, KV, G, hd = q.shape
    NP = slow_k.shape[0] // B
    P = slow_k.shape[2]
    R = K * G
    dev = q.device
    scale = 1.0 / math.sqrt(hd)
    npb = min(entries.shape[1], NP)
    qf = q.float().permute(0, 2, 1, 3, 4).reshape(B, KV, R, hd)
    tok = torch.arange(R, device=dev) // G
    pos = pos.long()
    live = pos >= 0
    limit = torch.where(live[:, None], pos[:, None] + 1 + tok[None, :], 0)
    homes_k = slow_k.view(B, NP, KV, P, hd)
    homes_v = slow_v.view(B, NP, KV, P, hd)
    rows = torch.arange(P, device=dev)
    m = torch.full((B, KV, R, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KV, R, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KV, R, hd), dtype=torch.float32, device=dev)
    for j in range(npb):
        e = entries[:, j].long()
        fast = (e >= 0)[:, None, None, None]
        slot = e.clamp(min=0)
        kk = torch.where(fast, fast_k[slot], homes_k[:, j]).float()
        vv = torch.where(fast, fast_v[slot], homes_v[:, j]).float()
        for t in range(K):
            pg = pos + t
            sel = live[:, None] & (pg // P == j)[:, None] \
                & (rows[None, :] == (pg % P)[:, None])          # [B, P]
            sel = sel[:, None, :, None]
            kk = torch.where(sel, k_new[:, t, :, None, :].float(), kk)
            vv = torch.where(sel, v_new[:, t, :, None, :].float(), vv)
        s = torch.einsum("bkrh,bkph->bkrp", qf, kk) * scale
        col = j * P + rows
        s = torch.where(col[None, None, None, :] < limit[:, None, :, None],
                        s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + torch.einsum("bkrp,bkph->bkrh", p, vv)
        m = m_new
    out = (acc / l.clamp_min(1e-30)).to(q.dtype)
    return out.reshape(B, KV, K, G, hd).permute(0, 2, 1, 3, 4)


def bf16_tolerance(ref: torch.Tensor) -> torch.Tensor:
    """Per-element limit for a bf16 result against the plain version
    computed in fp32 and cast to bf16: two bf16 ulps of the reference
    value (both sides round an fp32 sum of the same bf16 inputs, summed in
    another order), plus 1e-5 for values near zero, where the two fp32
    sums' own difference outweighs an ulp."""
    a = ref.float().abs().clamp_min(2.0 ** -126)
    return 2.0 * torch.exp2(torch.floor(torch.log2(a)) - 7) + 1e-5
