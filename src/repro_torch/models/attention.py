"""GQA attention for prefill and one-token decode against a KV backend
(port of ``repro.models.attention``): causal and sliding-window
self-attention, the window fixed per model or, in the hybrid family, per
layer; bidirectional self-attention without RoPE (the audio encoder);
the vlm family's gated cross-attention to image K/V.

Prefill attention (``sdpa_auto``, for the one-shot forward and each
chunk of a chunked prefill) and every cross-attention call, prefill and
decode, launch the flash kernel on a card (``kernels/flash_attention``),
whose rows are bit for bit independent of the call around them, so
chunked prefill equals one-shot prefill there too.  On the CPU they keep
the reference's plain paths: ``_sdpa`` with a mask up to
``CHUNKED_THRESHOLD``, ``chunked_sdpa`` above it, ``_sdpa`` unmasked for
cross-attention.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention.ops import flash_attention_op

from .layers import apply_rope, rms_norm

NEG_INF = -1e30
CHUNKED_THRESHOLD = 4096  # plain quadratic path at or below this length


def make_mask(seq_q: int, seq_k: int, *, causal: bool, window: int = 0,
              q_offset: int = 0, device=None):
    """[seq_q, seq_k] additive fp32 mask; window > 0 limits lookback."""
    qi = torch.arange(seq_q, device=device)[:, None] + q_offset
    ki = torch.arange(seq_k, device=device)[None, :]
    ok = torch.ones((seq_q, seq_k), dtype=torch.bool, device=device)
    if causal:
        ok &= ki <= qi
    if window > 0:
        ok &= ki > qi - window
    return torch.where(ok, 0.0, NEG_INF).float()


def _proj(x, w):
    """einsum("bsd,dhk->bshk", x, w) as one matrix product."""
    d, H, hd = w.shape
    return (x @ w.reshape(d, H * hd).to(x.dtype)).reshape(
        *x.shape[:-1], H, hd)


def _qkv(p, x, cfg, positions, rope=None):
    """q, k, v [B,S,*,hd]; RoPE at ``positions`` (``rope``: the step's
    precomputed ``layers.rope_tables``).  The head counts are the
    weights' own: under tensor parallelism (``sharding/tensor_parallel``)
    ``p`` holds this rank's H/tp query and KV/tp key/value heads, and the
    GQA group H/KV is unchanged."""
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta, rope)
        k = apply_rope(k, positions, cfg.rope_theta, rope)
    return q, k, v


def _out(o, wo):
    """einsum("bshk,hkd->bsd", o, wo); with this rank's heads of ``o`` and
    rows of ``wo`` it is this rank's term of the sum over "model"."""
    H, hd, d = wo.shape
    return o.reshape(*o.shape[:-2], H * hd) @ wo.reshape(H * hd, d) \
        .to(o.dtype)


def _scores(q, k, mask):
    """The fp32 scores [B,KV,G,S,T] of q [B,S,H,hd] against k [B,T,KV,hd],
    taken in q's and k's promoted dtype (as the reference's einsum
    promotes), scaled, plus ``mask``."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    ct = torch.promote_types(q.dtype, k.dtype)
    q, k = q.to(ct).reshape(B, S, KV, H // KV, hd), k.to(ct)
    scores = torch.einsum("bskgh,btkh->bkgst", q, k).float()
    scores = scores / math.sqrt(hd)
    if mask is not None:
        scores = scores + mask
    return scores


def _sdpa(q, k, v, mask):
    """q [B,S,H,hd]; k,v [B,T,KV,hd]; GQA by head grouping.  Scores are
    taken in q's and k's promoted dtype (as the reference's einsum
    promotes), then softmaxed in fp32; out in v's dtype."""
    return _sdpa_lse(q, k, v, mask)[0]


def _sdpa_lse(q, k, v, mask, *, lse: bool = False):
    """``_sdpa``'s output and, with ``lse``, the scores' log-sum-exp
    [B,KV,G,S] (else None): what merges attention over pieces of the key
    axis (``TensorParallel.combine``)."""
    B, S, H, hd = q.shape
    scores = _scores(q, k, mask)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", w, v).reshape(B, S, H, hd)
    return out, (torch.logsumexp(scores, dim=-1) if lse else None)


def chunked_sdpa(q, k, v, *, causal: bool, window: int = 0,
                 q_chunk: int = 1024, k_chunk: int = 1024):
    """Online-softmax attention over key blocks; never materialises more
    than a [B,KV,G,qc,kc] score block.  q [B,S,H,hd]; k,v [B,T,KV,hd]."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    qc, kc = min(q_chunk, S), min(k_chunk, T)
    if S % qc or T % kc:
        raise ValueError(f"chunked_sdpa: {S}/{qc} or {T}/{kc} not whole")
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    outs = []
    for qi in range(S // qc):
        qb = q[:, qi * qc:(qi + 1) * qc].reshape(B, qc, KV, G, hd)
        m = torch.full((B, KV, G, qc), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, KV, G, qc), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, KV, G, qc, hd), dtype=torch.float32,
                          device=dev)
        qpos = qi * qc + torch.arange(qc, device=dev)
        for ki in range(T // kc):
            kb = k[:, ki * kc:(ki + 1) * kc]
            vb = v[:, ki * kc:(ki + 1) * kc]
            s = torch.einsum("bqkgh,btkh->bkgqt", qb, kb).float() * scale
            kpos = ki * kc + torch.arange(kc, device=dev)
            ok = torch.ones((qc, kc), dtype=torch.bool, device=dev)
            if causal:
                ok &= kpos[None, :] <= qpos[:, None]
            if window > 0:
                ok &= kpos[None, :] > qpos[:, None] - window
            s = torch.where(ok, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqt,btkh->bkgqh", p.to(vb.dtype), vb).float()
            m = m_new
        out = (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)
        outs.append(out.permute(0, 3, 1, 2, 4))         # [B,qc,KV,G,hd]
    return torch.cat(outs, dim=1).reshape(B, S, H, hd)


def sdpa_auto(q, k, v, *, causal: bool, window: int = 0, q_offset: int = 0):
    """q [B,S,H,hd] at absolute positions ``q_offset``.. (a Python int);
    k,v [B,T,KV,hd] -> [B,S,H,hd].  A card runs the flash kernel at every
    length; the CPU runs the reference's paths."""
    if q.device.type == "cuda":
        return flash_attention_op(q, k, v, causal=causal, window=window,
                                  q_offset=q_offset)
    S = q.shape[1]
    if S > CHUNKED_THRESHOLD:
        if q_offset:
            raise ValueError("chunked_sdpa takes no q_offset")
        return chunked_sdpa(q, k, v, causal=causal, window=window)
    mask = make_mask(S, k.shape[1], causal=causal, window=window,
                     q_offset=q_offset, device=q.device)
    return _sdpa(q, k, v, mask)


def self_attention(p, x, cfg, *, positions, causal: bool, window: int = 0,
                   rope=None):
    q, k, v = _qkv(p, x, cfg, positions, rope)
    out = sdpa_auto(q, k, v, causal=causal, window=window)
    return _out(out, p["wo"]), (k, v)


def cross_attention(p, x, image_kv, cfg):
    """x [B,S,d] attends the image K/V ([B,T,KV,hd] each, from
    ``image_kv``) with no mask; q is RMS-normed over the head dim and
    the output scaled by tanh(gate).  On a card the core is the flash
    kernel, non-causal, which takes K/V only in q's dtype (it raises on
    fp32 image K/V under a bf16 model); the CPU follows the reference's
    dtype promotion."""
    q = _proj(x, p["wq"])
    if "bq" in p:
        q = q + p["bq"]
    q = rms_norm(q, p["q_norm"], cfg.rms_eps)
    k, v = image_kv
    if q.device.type == "cuda":
        out = flash_attention_op(q, k, v, causal=False, window=0, q_offset=0)
    else:
        out = _sdpa(q, k, v, None)
    return torch.tanh(p["gate"]).to(x.dtype) * _out(out, p["wo"])


def image_kv(p, img_embeds, cfg):
    """The cross-attention K/V [B,T,KV,hd] from projected image embeddings
    [B,T,d], in the embeddings' dtype (the weights are cast to it, as the
    reference does); k RMS-normed over the head dim."""
    k, v = _proj(img_embeds, p["wk"]), _proj(img_embeds, p["wv"])
    if "bk" in p:
        k, v = k + p["bk"], v + p["bv"]
    return rms_norm(k, p["k_norm"], cfg.rms_eps), v


def block_decode_attention(p, x, cfg, cache, pos, backend, *, window: int = 0,
                           rope=None, ring: bool = False):
    """One block's decode attention through a backend's per-layer
    ``append``/``attend`` pair (the dense path).  x [B,1,d]; pos [B]
    (negative: idle lane); ``window`` > 0 keeps only the keys inside this
    layer's sliding window (the hybrid family's global layers pass 0).
    ``ring``: the cache is a ring of the window's slots, slot ``s``
    holding position ``pos - ((pos - s) mod S)`` (the reference's
    ``REPRO_WINDOW_CACHE``); reads are masked by the true window, so the
    values are those of the full-length cache.  Returns (y [B,1,d],
    cache)."""
    q, k, v = _qkv(p, x, cfg, pos[:, None], rope)
    B, _, H, hd = q.shape
    KV = k.shape[2]
    cache = backend.append(cache, k[:, 0], v[:, 0], pos, ring=ring)
    out, cache = backend.attend(cache, q.reshape(B, KV, H // KV, hd), pos,
                                window=window, ring=ring)
    return _out(out.reshape(B, 1, H, hd), p["wo"]), cache


def block_decode_attention_fused(p, x, cfg, cache, pos, backend, *, aux,
                                 rope=None):
    """Fused-path variant for backends with a ``begin_step`` /
    ``append_attend`` / ``end_step`` protocol: the new token attends the
    store and its own K/V row in one kernel; the rows return for the
    batched end-of-step persist.  Returns (y, (k_new, v_new))."""
    q, k, v = _qkv(p, x, cfg, pos[:, None], rope)
    B, _, H, hd = q.shape
    KV = k.shape[2]
    out = backend.append_attend(cache, q.reshape(B, KV, H // KV, hd),
                                k[:, 0], v[:, 0], pos, aux)
    return _out(out.reshape(B, 1, H, hd), p["wo"]), (k[:, 0], v[:, 0])
