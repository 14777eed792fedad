"""Decoders of the dense and MoE families: parameters, full-sequence
forward, the chunked-prefill forward and the one-token decode step (port
of those families of ``repro.models.transformer``).

Parameters keep the reference's layout, a dict of layer-stacked tensors:
``{"embed" [V,d], "blocks": {"norm1" [L,d], "attn": {"wq" [L,d,H,hd],
"wk"/"wv" [L,d,KV,hd], "wo" [L,H,hd,d], with ``qkv_bias`` "bq" [L,H,hd],
"bk"/"bv" [L,KV,hd]}, "norm2" [L,d], and either "mlp": {"w_gate"/"w_up"
[L,d,ff], "w_down" [L,ff,d]} (dense) or "moe": {"router" [L,d,E] fp32,
"w_gate"/"w_up" [L,E,d,ff], "w_down" [L,E,ff,d]} (moe)}, "final_norm"
[d], "unembed" [V,d]}``.  The reference's ``lax.scan`` over layers is a
Python loop over views of the stacked tensors.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device, torch_dtype

from . import attention as attn
from . import moe as moe_mod
from .layers import (dense_init, rms_norm, rope_tables, stacked_init, swiglu,
                     unembed)

_FAMILIES = ("dense", "moe")


def check_family(cfg: ArchConfig):
    """Raise on a family the port's decoder does not run: the plain-KV
    families, whose every entry point (forward, decode, chunked prefill,
    the engine) the port serves."""
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"the port runs the decoder families {_FAMILIES}; got "
            f"{cfg.family!r}")


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def init_params(cfg: ArchConfig, device=None, seed: int = 0) -> dict:
    """Seeded random parameters in the reference's layout, made on
    ``device`` (the card unless the caller asks for the CPU).

    Every projection is scaled by 1/sqrt(fan-in) with the fan-in its
    contracted input size (d for wq/wk/wv, H*hd for wo, the rows of the
    MLP matrices).  The reference's ``dense_init`` takes ``shape[-2]``,
    which for the [d, H, hd] projections is H: its q and k come out
    sqrt(d/H) times larger and its attention nearly one-hot, so fp32
    reassociation alone moves full-width logits by ~1e-3.  Parity tests
    give both sides the same weights (``repro_torch.weights``).  The QKV
    biases start at zero, as the reference's do; the MoE family's experts
    come from ``moe.moe_init``."""
    check_family(cfg)
    device = resolve_device(device)
    dt = torch_dtype(cfg.dtype)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    L, d, ff = cfg.n_layers, cfg.d_model, cfg.d_ff
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd

    def stacked(shape, fan_in):
        return stacked_init(g, L, shape, dt, device, fan_in)

    def filled(fill, *shape):
        return torch.full(shape, fill, dtype=dt, device=device)

    attn_p = {"wq": stacked((d, H, hd), d), "wk": stacked((d, KV, hd), d),
              "wv": stacked((d, KV, hd), d), "wo": stacked((H, hd, d), H * hd)}
    if cfg.qkv_bias:
        attn_p.update(bq=filled(0, L, H, hd), bk=filled(0, L, KV, hd),
                      bv=filled(0, L, KV, hd))
    blocks = {"norm1": filled(1, L, d), "attn": attn_p,
              "norm2": filled(1, L, d)}
    if cfg.family == "moe":
        blocks["moe"] = moe_mod.moe_init(g, cfg, device)
    else:
        blocks["mlp"] = {"w_gate": stacked((d, ff), d),
                         "w_up": stacked((d, ff), d),
                         "w_down": stacked((ff, d), ff)}
    params = {"embed": dense_init(g, (cfg.vocab, d), dt, device, 0.02),
              "blocks": blocks, "final_norm": filled(1, d)}
    if not cfg.tie_embeddings:
        params["unembed"] = dense_init(g, (cfg.vocab, d), dt, device, 0.02)
    return params


def layer_params(tree, i: int):
    """Layer ``i``'s slice (views) of a layer-stacked tree of dicts and
    named tuples."""
    if isinstance(tree, dict):
        return {k: layer_params(v, i) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(layer_params(v, i) for v in tree))
    return tree[i]


def _table(cfg: ArchConfig, params):
    return params["embed"] if cfg.tie_embeddings else params["unembed"]


def _ffn(p, x, cfg: ArchConfig):
    """The block's second half: x + FFN(norm2(x)) -> (x, aux), where aux
    is the MoE load-balancing loss (a 0-d fp32 tensor) or None."""
    h2 = rms_norm(x, p["norm2"], cfg.rms_eps)
    if cfg.family == "moe":
        y, aux = moe_mod.moe_ffn(p["moe"], h2, cfg)
        return x + y, aux
    return x + swiglu(h2, p["mlp"]["w_gate"], p["mlp"]["w_up"],
                      p["mlp"]["w_down"]), None


# ---------------------------------------------------------------------------
# full-sequence forward (prefill)
# ---------------------------------------------------------------------------

def forward(cfg: ArchConfig, params, batch, *, collect_cache: bool = False):
    """batch {"tokens" [B,S]} -> (logits [B,S,V] fp32, aux, caches): aux
    the MoE load-balancing loss summed over layers (0 for dense), and
    with ``collect_cache`` caches = (k, v), each [L,B,S,KV,hd] post-RoPE."""
    check_family(cfg)
    tokens = batch["tokens"]
    x = params["embed"][tokens.long()]
    B, S = x.shape[:2]
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device).expand(B, S)
    rope = rope_tables(positions, cfg.hd, cfg.rope_theta)
    ks, vs = [], []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_layers):
        p = layer_params(params["blocks"], i)
        h = rms_norm(x, p["norm1"], cfg.rms_eps)
        a, (k, v) = attn.self_attention(p["attn"], h, cfg,
                                        positions=positions,
                                        causal=cfg.causal,
                                        window=cfg.sliding_window, rope=rope)
        x, aux_l = _ffn(p, x + a, cfg)
        if aux_l is not None:
            aux = aux + aux_l
        if collect_cache:
            ks.append(k)
            vs.append(v)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    logits = unembed(x, _table(cfg, params))
    caches = (torch.stack(ks), torch.stack(vs)) if collect_cache else ()
    return logits, aux, caches


# ---------------------------------------------------------------------------
# chunked prefill: one chunk of prompt K/V against a full-length key buffer
# ---------------------------------------------------------------------------

def forward_chunk(cfg: ArchConfig, params, tokens, buf_k, buf_v, start: int,
                  *, return_logits: bool = False):
    """One chunked-prefill step: prompt tokens [B, C] at absolute
    positions ``start..start+C-1`` (a Python int, page aligned by the
    caller) attend the previous chunks' K/V.

    ``buf_k``/``buf_v`` [L, B, P, KV, hd]: rows below ``start`` hold the
    earlier chunks' K/V, later rows are masked garbage (finite: zeros or
    earlier rows).  ``P`` must be the padded length the one-shot
    ``forward`` would run at.  Rows ``[start, start+C)`` of each layer are
    written IN PLACE before that layer's attention; the same buffers are
    returned, with the chunk's logits [B, C, vocab] fp32 when
    ``return_logits``.

    Each chunk's queries score against a key axis of the same length P as
    the one-shot forward, at the same absolute positions, so every row
    equals the matching row of ``forward(collect_cache=True)``: bit for
    bit on the CPU (``_sdpa`` with the one-shot mask's rows); on a card
    the flash kernel's rows are independent of the call around them, and
    the whole chunk equals the one-shot rows as long as cuBLAS's products
    are row-independent too (``chip_smoke.py`` phase 8 checks it).  For
    the MoE family this holds while no token is dropped: a chunk routes
    fewer tokens, so its capacity, and which tokens it drops, differ
    from the one-shot call's."""
    check_family(cfg)
    B, C = tokens.shape
    P = buf_k.shape[2]
    if P > attn.CHUNKED_THRESHOLD:
        # above the threshold the one-shot forward's CPU path switches to
        # chunked_sdpa, whose accumulation order differs; the scheduler
        # falls back to one-shot prefill there
        raise NotImplementedError(
            f"forward_chunk is bit-identical to the one-shot forward only "
            f"below sdpa_auto's CHUNKED_THRESHOLD "
            f"({attn.CHUNKED_THRESHOLD}); padded length {P} exceeds it")
    start = int(start)
    x = params["embed"][tokens.long()]
    positions = (start + torch.arange(C, dtype=torch.int32,
                                      device=x.device)).expand(B, C)
    rope = rope_tables(positions, cfg.hd, cfg.rope_theta)
    for i in range(cfg.n_layers):
        p = layer_params(params["blocks"], i)
        h = rms_norm(x, p["norm1"], cfg.rms_eps)
        q, k, v = attn._qkv(p["attn"], h, cfg, positions, rope)
        buf_k[i, :, start:start + C] = k.to(buf_k.dtype)
        buf_v[i, :, start:start + C] = v.to(buf_v.dtype)
        out = attn.sdpa_auto(q, buf_k[i], buf_v[i], causal=cfg.causal,
                             window=cfg.sliding_window, q_offset=start)
        x, _ = _ffn(p, x + attn._out(out, p["attn"]["wo"]), cfg)
    if not return_logits:
        return buf_k, buf_v
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    return buf_k, buf_v, unembed(x, _table(cfg, params))


def init_chunk_buffers(cfg: ArchConfig, P: int, batch: int = 1,
                       device=None):
    """Fresh chunked-prefill K/V buffers [L, batch, P, KV, hd], zeros, in
    the dtype ``forward`` collects its cache in, on ``device`` (the card
    unless the caller asks for the CPU)."""
    shape = (cfg.n_layers, batch, P, cfg.n_kv_heads, cfg.hd)
    dt, dev = torch_dtype(cfg.dtype), resolve_device(device)
    return (torch.zeros(shape, dtype=dt, device=dev),
            torch.zeros(shape, dtype=dt, device=dev))


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

class DecodeState(NamedTuple):
    pos: torch.Tensor         # [B] int32 per-lane length (< 0: idle lane)
    caches: Any               # backend-owned, layer-stacked


def init_decode_state(cfg: ArchConfig, batch: int, max_len: int,
                      device=None) -> DecodeState:
    """Dense caches {"k", "v"} [L, B, max_len, KV, hd], zeros."""
    check_family(cfg)
    dt = torch_dtype(cfg.dtype)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    caches = {"k": torch.zeros(shape, dtype=dt, device=device),
              "v": torch.zeros(shape, dtype=dt, device=device)}
    return DecodeState(torch.zeros((batch,), dtype=torch.int32,
                                   device=device), caches)


def decode_step(cfg: ArchConfig, params, state: DecodeState, tokens,
                backend=None, *, n_pages: int | None = None):
    """tokens [B] int -> (logits [B, vocab] fp32, new state).

    ``backend`` selects the KV storage (``models.kv_backend``): None /
    ``DenseBackend`` keeps contiguous caches; ``TieredBackend`` runs the
    fused path — ``begin_step`` once, one fused append+attend kernel per
    layer, ``end_step`` once.  ``n_pages`` (tiered only) is the live-page
    bucket; the caller guarantees it holds every live position plus this
    step's append.  Caches update in place."""
    check_family(cfg)
    if backend is None:
        from .kv_backend import DenseBackend
        backend = DenseBackend(cfg)
    x = params["embed"][tokens.long()[:, None]]
    pos = state.pos
    rope = rope_tables(pos[:, None], cfg.hd, cfg.rope_theta)
    if hasattr(backend, "begin_step"):
        caches, aux = backend.begin_step(state.caches, pos, n_pages=n_pages)
        ops = backend.scan_operands(caches)
        ks, vs = [], []
        for i in range(cfg.n_layers):
            p = layer_params(params["blocks"], i)
            h = rms_norm(x, p["norm1"], cfg.rms_eps)
            a, (k, v) = attn.block_decode_attention_fused(
                p["attn"], h, cfg, layer_params(ops, i), pos, backend,
                aux=aux, rope=rope)
            x, _ = _ffn(p, x + a, cfg)
            ks.append(k)
            vs.append(v)
        caches = backend.end_step(caches, (torch.stack(ks), torch.stack(vs)),
                                  pos, aux)
    else:
        caches = state.caches
        for i in range(cfg.n_layers):
            p = layer_params(params["blocks"], i)
            h = rms_norm(x, p["norm1"], cfg.rms_eps)
            a, _ = attn.block_decode_attention(
                p["attn"], h, cfg, layer_params(caches, i), pos, backend,
                rope=rope)
            x, _ = _ffn(p, x + a, cfg)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    logits = unembed(x, _table(cfg, params))[:, 0]
    return logits, DecodeState(pos + 1, caches)
