"""Every model family of ``repro.models.transformer``: the dense, MoE,
hybrid, ssm and vlm decoders and the audio encoder.  Parameters,
full-sequence forward, prefill, the chunked-prefill forward and the
one-token decode step.

Parameters keep the reference's layout, a dict of layer-stacked tensors:
``{"embed" [V,d], "blocks": {...}, "final_norm" [d], "unembed" [V,d]}``
(no "embed" where ``cfg.embed_inputs``: the audio encoder takes frame
embeddings).  The blocks hold "norm1" [L,d] and, by family:

  dense   "attn": {"wq" [L,d,H,hd], "wk"/"wv" [L,d,KV,hd], "wo"
          [L,H,hd,d], with ``qkv_bias`` "bq" [L,H,hd], "bk"/"bv"
          [L,KV,hd]}, "norm2" [L,d], "mlp": {"w_gate"/"w_up" [L,d,ff],
          "w_down" [L,ff,d]};
  moe     the same with "moe": {"router" [L,d,E] fp32, "w_gate"/"w_up"
          [L,E,d,ff], "w_down" [L,E,ff,d]} in place of "mlp";
  hybrid  the dense blocks plus "ssm" (``ssm.ssm_init``),
          "norm_attn_out" and "norm_ssm_out" [L,d]: attention and the
          Mamba branch run in parallel on norm1's output;
  ssm     norm1 and both xLSTM branch sets (``xlstm.xlstm_init``); no
          norm2 or FFN;
  audio   the dense blocks with "mlp": {"w_in" [L,d,ff], "b_in" [L,ff],
          "w_out" [L,ff,d], "b_out" [L,d]} (a GELU MLP with biases);
          attention is bidirectional (``cfg.causal`` False), without RoPE;
  vlm     {"self": the dense blocks stacked [ns, inner, ...], "cross":
          the dense blocks stacked [ns, ...] whose "attn" also holds
          "gate" [ns] fp32, "q_norm" and "k_norm" [ns,hd]}: ns
          super-blocks of ``inner`` = cross_attn_every - 1 self layers
          and one gated cross-attention layer to the image K/V.

The reference's ``lax.scan`` over layers is a Python loop over views of
the stacked tensors; its scanned per-layer flags (``layer_flags``) are
Python bools here.
"""

from __future__ import annotations

import functools
import os
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device, torch_dtype
from repro_torch.sharding.tensor_parallel import (_placements_without,
                                                  layer_dims)
from repro_torch.weights import abstract_params, param_axes

from . import attention as attn
from . import moe as moe_mod
from . import ssm as ssm_mod
from . import xlstm as xlstm_mod
from .layers import (dense_init, gelu_mlp, rms_norm, rope_tables,
                     stacked_const, stacked_init, swiglu, unembed)

_FAMILIES = ("dense", "moe", "hybrid", "ssm", "vlm", "audio")
_KV_FAMILIES = ("dense", "moe")
# the recurrent families, whose prefill returns a cold decode state
COLD_PREFILL = ("hybrid", "ssm")


def check_family(cfg: ArchConfig):
    """Raise on a family the port does not know: ``init_params``,
    ``forward``, ``prefill``, ``init_decode_state`` and the dense-backend
    ``decode_step`` take all six (``decode_step`` refuses the encoder).
    The chunked-prefill forward, the tiered decode branch and the engine
    take only the plain-KV families, each with its own refusal."""
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"the port runs the model families {_FAMILIES}; got "
            f"{cfg.family!r}")


def layer_flags(cfg: ArchConfig) -> np.ndarray:
    """[L] bool per-layer flags: hybrid, the global-attention layers
    (every ``global_attn_every``-th from layer 0); ssm, the sLSTM layers
    (every ``slstm_every``-th, the last of each group); else all False."""
    L = cfg.n_layers
    if cfg.family == "hybrid" and cfg.global_attn_every:
        return np.arange(L) % cfg.global_attn_every == 0
    if cfg.family == "ssm":
        every = max(cfg.slstm_every, 1)
        return np.arange(L) % every == every - 1
    return np.zeros((L,), bool)


def _window(cfg: ArchConfig, flag) -> int:
    """A hybrid layer's attention window: 0 on its global layers."""
    if cfg.family == "hybrid":
        return 0 if flag else cfg.sliding_window
    return cfg.sliding_window


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def init_params(cfg: ArchConfig, device=None, seed: int = 0, *,
                cut=None) -> dict:
    """Seeded random parameters in the reference's layout, made on
    ``device`` (the card unless the caller asks for the CPU).

    Every matrix is scaled by 1/sqrt(fan-in) with the reference's fan-in,
    ``shape[-2]`` of the unstacked leaf (``dense_init``): the rows of the
    MLP matrices, but H (KV) for the [d, H, hd] projections wq (wk, wv)
    and hd for wo [H, hd, d], so q and k come out sqrt(d/H) times their
    1/sqrt(d) size and attention at full width is nearly one-hot, as in
    the reference.  The embedding tables are scaled by 0.02.  The QKV
    biases start at zero, as the reference's do; the MoE family's experts
    come from ``moe.moe_init``, the Mamba branch from ``ssm.ssm_init``,
    the xLSTM branches from ``xlstm.xlstm_init``.  The audio MLP's biases
    start at zero and the vlm cross layers' ``gate`` at 0, so tanh(gate)
    = 0 and the cross branch adds nothing until the gate is set, as in
    the reference.

    ``cut`` (``init_sharded_params``) maps a leaf's path to a function
    from one layer's whole draw (or a top-level leaf's) to the piece
    kept: the draws are the same, in the same order (the vlm's ns x
    inner self layers one by one, then its ns cross layers), and each
    leaf is stacked from its pieces."""
    check_family(cfg)
    device = resolve_device(device)
    dt = torch_dtype(cfg.dtype)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    keep = cut or (lambda path: (lambda t: t))
    if cfg.family == "vlm":
        ns, inner = cfg.vlm_dims
        self_blocks = _blocks_init(cfg, g, ns * inner, dt, device, cut=cut,
                                   prefix="blocks/self/")
        blocks = {"self": _map(lambda t: t.reshape((ns, inner) + t.shape[1:]),
                               self_blocks),
                  "cross": _blocks_init(cfg, g, ns, dt, device, cross=True,
                                        cut=cut, prefix="blocks/cross/")}
    else:
        blocks = _blocks_init(cfg, g, cfg.n_layers, dt, device, cut=cut)
    d = cfg.d_model
    params = {} if cfg.embed_inputs else {
        "embed": keep("embed")(dense_init(g, (cfg.vocab, d), dt, device,
                                          0.02))}
    params.update(blocks=blocks, final_norm=keep("final_norm")(
        torch.ones(d, dtype=dt, device=device)))
    if not cfg.tie_embeddings:
        params["unembed"] = keep("unembed")(
            dense_init(g, (cfg.vocab, d), dt, device, 0.02))
    return params


def init_sharded_params(cfg: ArchConfig, mesh, seed: int = 0,
                        device=None) -> dict:
    """``init_params(cfg, device, seed)`` laid out on ``mesh`` by the
    reference's specs, made without the whole tree: each leaf is drawn
    one layer at a time on ``device`` (the card unless the caller asks
    for the CPU), the same draws in the same order, and this rank keeps
    only its piece of each layer.  The ranks' pieces, gathered, are
    ``init_params``'s tensors exactly; no rank holds more than one layer
    of a stacked leaf whole (a layer of qwen2-72b's ``w_gate`` is 0.97 GB
    in fp32 as drawn, of mixtral-8x22b's [8, 6144, 16384] 3.22 GB).  A
    top-level leaf is drawn whole before its piece is cut: qwen2-72b's
    embedding tables, [152064, 8192], are 4.98 GB each in fp32 as drawn,
    and that draw, not the prefill, sets the rank's peak memory.  Every
    family."""
    from repro_torch.sharding import specs

    params_abs, axes = abstract_params_and_axes(cfg)
    p_sh = specs.tree_shardings(axes, mesh, params_abs)
    flat = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}/{k}" if path else k)
        else:
            flat[path] = node
    walk(p_sh, "")

    def cut(path):
        pl = _placements_without(flat[path].placements, layer_dims(path))

        def piece(t):
            part = specs.local_chunk(t, mesh, pl)
            return part.clone() if part.numel() < t.numel() else part
        return piece
    local = init_params(cfg, device, seed, cut=cut)
    return specs.map_leaves(
        lambda t, sh, ab: specs.distribute_local(t, mesh, sh.placements,
                                                 ab.shape),
        local, p_sh, params_abs)


def init_params_and_axes(cfg: ArchConfig, device=None,
                         seed: int = 0) -> tuple[dict, dict]:
    """(``init_params(cfg, device, seed)``, the same tree of the
    reference's logical-axis tuples)."""
    return init_params(cfg, device, seed), param_axes(cfg)


def abstract_params_and_axes(cfg: ArchConfig) -> tuple[dict, dict]:
    """(the parameters as ``meta`` tensors, their logical axes): shapes
    and dtypes with nothing allocated."""
    return abstract_params(cfg), param_axes(cfg)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _blocks_init(cfg: ArchConfig, g, n: int, dt, device, *,
                 cross: bool = False, cut=None,
                 prefix: str = "blocks/") -> dict:
    """``n`` layers' blocks stacked on a leading [n] axis; ``cross`` adds
    the gated cross-attention's "gate", "q_norm" and "k_norm"; ``cut``
    as ``init_params`` takes it (each leaf named by its path, under
    ``prefix``)."""
    d, ff = cfg.d_model, cfg.d_ff
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd

    def stacked(name, shape, fan_in):
        piece = cut(prefix + name) if cut is not None else None
        return stacked_init(g, n, shape, dt, device, fan_in, piece=piece)

    def filled(name, fill, *shape):
        return stacked_const(n, torch.full(shape, fill, dtype=dt,
                                           device=device),
                             cut(prefix + name) if cut is not None else None)

    blocks = {"norm1": filled("norm1", 1, d)}
    if cfg.family == "ssm":
        blocks.update(xlstm_mod.xlstm_init(g, cfg, device, cut=cut,
                                           prefix=prefix))
        return blocks
    attn_p = {"wq": stacked("attn/wq", (d, H, hd), H),
              "wk": stacked("attn/wk", (d, KV, hd), KV),
              "wv": stacked("attn/wv", (d, KV, hd), KV),
              "wo": stacked("attn/wo", (H, hd, d), hd)}
    if cfg.qkv_bias:
        attn_p.update(bq=filled("attn/bq", 0, H, hd),
                      bk=filled("attn/bk", 0, KV, hd),
                      bv=filled("attn/bv", 0, KV, hd))
    if cross:
        attn_p.update(gate=torch.zeros(n, dtype=torch.float32, device=device),
                      q_norm=filled("attn/q_norm", 1, hd),
                      k_norm=filled("attn/k_norm", 1, hd))
    blocks.update(attn=attn_p, norm2=filled("norm2", 1, d))
    if cfg.family == "hybrid":
        blocks.update(ssm=ssm_mod.ssm_init(g, cfg, device, cut=cut,
                                           prefix=prefix + "ssm/"),
                      norm_attn_out=filled("norm_attn_out", 1, d),
                      norm_ssm_out=filled("norm_ssm_out", 1, d))
    if cfg.family == "moe":
        blocks["moe"] = moe_mod.moe_init(g, cfg, device, cut=cut)
    elif cfg.family == "audio":
        blocks["mlp"] = {"w_in": stacked("mlp/w_in", (d, ff), d),
                         "b_in": filled("mlp/b_in", 0, ff),
                         "w_out": stacked("mlp/w_out", (ff, d), ff),
                         "b_out": filled("mlp/b_out", 0, d)}
    else:
        blocks["mlp"] = {"w_gate": stacked("mlp/w_gate", (d, ff), d),
                         "w_up": stacked("mlp/w_up", (d, ff), d),
                         "w_down": stacked("mlp/w_down", (ff, d), ff)}
    return blocks


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
    m = p["mlp"]
    if cfg.family == "audio":
        return x + gelu_mlp(h2, m["w_in"], m["b_in"], m["w_out"],
                            m["b_out"]), None
    return x + swiglu(h2, m["w_gate"], m["w_up"], m["w_down"]), None


# ---------------------------------------------------------------------------
# full-sequence forward (prefill)
# ---------------------------------------------------------------------------

def _block_fwd(cfg: ArchConfig, p, x, positions, rope, flag):
    """One block over the whole sequence -> (x, aux, (k, v) or None): aux
    the MoE load-balancing loss or None, k/v the attention's post-RoPE
    keys and values (None for the ssm family).  ``positions`` None (the
    encoder) skips RoPE."""
    h = rms_norm(x, p["norm1"], cfg.rms_eps)
    if cfg.family == "ssm":
        branch = xlstm_mod.slstm_scan if flag else xlstm_mod.mlstm_parallel
        return x + branch(p, h), None, None
    if cfg.family == "hybrid":
        q, k, v = attn._qkv(p["attn"], h, cfg, positions, rope)
        out = attn.sdpa_auto(q, k, v, causal=True,
                             window=_window(cfg, flag))
        a = attn._out(out, p["attn"]["wo"])
        xz = h @ p["ssm"]["in_proj"].to(h.dtype)
        s = ssm_mod.ssm_scan(p["ssm"], xz, cfg)
        x = x + rms_norm(a, p["norm_attn_out"], cfg.rms_eps) \
            + rms_norm(s, p["norm_ssm_out"], cfg.rms_eps)
    else:
        a, (k, v) = attn.self_attention(p["attn"], h, cfg,
                                        positions=positions,
                                        causal=cfg.causal,
                                        window=cfg.sliding_window, rope=rope)
        x = x + a
    x, aux = _ffn(p, x, cfg)
    return x, aux, (k, v)


def _embed_inputs(cfg: ArchConfig, params, batch):
    """The first hidden state [B,S,d]: ``batch["embeds"]`` cast to the
    model's dtype where ``cfg.embed_inputs`` (audio), else the embedding
    rows of ``batch["tokens"]``."""
    if cfg.embed_inputs:
        return batch["embeds"].to(torch_dtype(cfg.dtype))
    # F.embedding: its backward on a card sums each row's gradients in a
    # fixed order (indexing's would use atomics)
    return F.embedding(batch["tokens"].long(), params["embed"])


def _cross_block_fwd(cfg: ArchConfig, p, x, ikv):
    """One gated cross-attention layer over the image K/V ``ikv``."""
    h = rms_norm(x, p["norm1"], cfg.rms_eps)
    x = x + attn.cross_attention(p["attn"], h, ikv, cfg)
    return _ffn(p, x, cfg)[0]


def _unstack(tree) -> list:
    """Per-layer views of a layer-stacked tree of dicts, one ``unbind``
    per leaf: its backward stacks the layers' gradients once, where
    indexing each layer would add a zero-filled full-size gradient per
    layer."""
    if isinstance(tree, dict):
        per = {k: _unstack(v) for k, v in tree.items()}
        n = len(next(iter(per.values())))
        return [{k: v[i] for k, v in per.items()} for i in range(n)]
    return tree.unbind(0)


REMAT_POLICIES = ("none", "dots", "full")


def _dots_policy(ctx, op, *args, **kwargs):
    """Selective recomputation that keeps the outputs of the projections'
    matrix products (``aten.mm``, ``addmm``) and recomputes everything
    else, attention's batched products included: the counterpart of the
    reference's ``checkpoint_dots_with_no_batch_dims``."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, remat: str):
    """``fn`` under ``torch.utils.checkpoint`` (non-reentrant): "none"
    leaves it alone, "full" saves only its inputs and recomputes the rest
    in the backward, "dots" also saves the projections' products."""
    if remat not in REMAT_POLICIES:
        raise ValueError(f"remat {remat!r} not in {REMAT_POLICIES}")
    if remat == "none":
        return fn
    kw = {} if remat == "full" else {"context_fn": functools.partial(
        create_selective_checkpoint_contexts, _dots_policy)}
    return lambda *a: checkpoint(fn, *a, use_reentrant=False, **kw)


def _check_image_dtype(image_embeds, x):
    if image_embeds.dtype != x.dtype:
        # the reference's layer scan rejects the wider residual stream
        # that image K/V in a wider dtype would promote the model to
        raise TypeError(f"image_embeds are {image_embeds.dtype}; the model "
                        f"runs in {x.dtype}")


def _vlm_forward(cfg: ArchConfig, params, x, positions, rope, image_embeds,
                 collect_cache: bool, remat: str = "none"):
    """The super-block loop -> (x, caches): with ``collect_cache`` caches
    = ((k, v) [ns,inner,B,S,KV,hd], (ik, iv) [ns,B,T,KV,hd]), else ().
    ``remat`` wraps each super-block."""
    _check_image_dtype(image_embeds, x)
    ns, inner = cfg.vlm_dims

    def super_block(p_self, p, x):
        kvs = []
        for pj in _unstack(p_self):
            x, _, kv = _block_fwd(cfg, pj, x, positions, rope, False)
            kvs.append(kv)
        ikv = attn.image_kv(p["attn"], image_embeds, cfg)
        return _cross_block_fwd(cfg, p, x, ikv), kvs, ikv

    run = _remat(super_block, remat)
    ks, vs, iks, ivs = [], [], [], []
    for p_self, p in zip(_unstack(params["blocks"]["self"]),
                         _unstack(params["blocks"]["cross"])):
        x, kvs, (ik, iv) = run(p_self, p, x)
        ks += [kv[0] for kv in kvs]
        vs += [kv[1] for kv in kvs]
        iks.append(ik)
        ivs.append(iv)
    if not collect_cache:
        return x, ()

    def stack(ts):
        t = torch.stack(ts)
        return t.reshape((ns, inner) + t.shape[1:])
    return x, ((stack(ks), stack(vs)), (torch.stack(iks), torch.stack(ivs)))


def forward(cfg: ArchConfig, params, batch, *, remat: str = "none",
            collect_cache: bool = False, return_logits: bool | str = True,
            tp=None):
    """batch {"tokens" [B,S]} ({"embeds" [B,S,d]} for audio; vlm adds
    "image_embeds" [B,T,d] in the model's dtype) -> (logits [B,S,V] fp32,
    aux, caches): aux the MoE load-balancing loss summed over layers (0
    for the others), and with ``collect_cache`` caches = (k, v), each
    [L,B,S,KV,hd] post-RoPE, for the self-attention families (() for
    ssm); vlm's are ``_vlm_forward``'s.  ``remat`` ("none", "dots",
    "full") recomputes each layer (the vlm: each super-block) in the
    backward (``_remat``), as the reference's ``REMAT_POLICIES`` do.
    ``return_logits=False`` skips the final norm and the unembedding
    (logits None): a prefill that keeps only the caches, as the
    reference's jitted prefill, whose logits XLA never computes;
    ``return_logits="last"`` unembeds the last position only (logits
    [B, 1, V]), the one a jitted prefill returns.

    ``tp`` (a ``sharding.tensor_parallel.TensorParallel``) runs the split
    step on this rank's pieces of
    the parameters and its rows (``_forward_tp``): the logits are this
    rank's vocab columns, aux the whole batch's, and ``collect_cache``
    is not taken (``prefill`` lays the cache out)."""
    check_family(cfg)
    if tp is not None:
        if collect_cache:
            raise ValueError("forward(tp=...) collects no cache; prefill "
                             "lays a split cache out")
        return _forward_tp(cfg, params, batch, tp, remat=remat,
                           logits=return_logits, aux=True) + ((),)
    x = _embed_inputs(cfg, params, batch)
    B, S = x.shape[:2]
    positions = rope = None           # the encoder: no RoPE
    if cfg.causal:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device).expand(B, S)
        rope = rope_tables(positions, cfg.hd, cfg.rope_theta)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "vlm":
        x, caches = _vlm_forward(cfg, params, x, positions, rope,
                                 batch["image_embeds"], collect_cache, remat)
        return _logits(cfg, params, x, return_logits), aux, caches
    block = _remat(functools.partial(_block_fwd, cfg), remat)
    ks, vs = [], []
    for p, flag in zip(_unstack(params["blocks"]), layer_flags(cfg)):
        x, aux_l, kv = block(p, x, positions, rope, bool(flag))
        if aux_l is not None:
            aux = aux + aux_l
        if collect_cache and kv is not None:
            ks.append(kv[0])
            vs.append(kv[1])
    caches = (torch.stack(ks), torch.stack(vs)) if ks else ()
    if not return_logits:
        return None, aux, caches
    return _logits(cfg, params, x, return_logits), aux, caches


def _logits(cfg: ArchConfig, params, x, which):
    """The final norm and the unembedding of ``x`` [B, S, d], of its last
    position only when ``which`` is "last"."""
    if which == "last":
        x = x[:, -1:]
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    return unembed(x, _table(cfg, params))


def lm_loss(cfg: ArchConfig, params, batch, *, remat: str = "none",
            tp=None):
    """Next-token cross-entropy for the decoders (the logits at position
    t against ``labels`` at t + 1, as the reference shifts them), frame
    classification for the encoder, plus 1e-2 times the MoE
    load-balancing loss and 1e-4 times the z-loss (the mean squared
    log-sum-exp of the logits).  Returns (loss, {"ce", "aux", "z"}), all
    0-d fp32 tensors.  ``REPRO_SHARDED_CE=1`` (read at each call) takes
    the reference's vocab-sharded formulation of the same quantities:
    the log-sum-exp from a detached max and a sum of exponentials, the
    label's logit picked by a mask over the vocab.  With ``tp`` (the
    split step, ``forward``) the loss always takes that form, over this
    rank's vocab columns with [B, S]-sized reductions over "model"
    (``TensorParallel.cross_entropy``)."""
    logits, aux, _ = forward(cfg, params, batch, remat=remat, tp=tp)
    labels = batch["labels"].long()
    if cfg.causal:
        logits, labels = logits[:, :-1], labels[:, 1:]
    if tp is not None:
        ce, z = tp.cross_entropy(logits, labels)
    elif os.environ.get("REPRO_SHARDED_CE", "0") == "1":
        # the reference's vocab-sharded form: max, sum-exp and the label's
        # logit as reductions over the vocab, each [B, S]
        m = logits.max(dim=-1, keepdim=True).values.detach()
        sumexp = torch.exp(logits - m).sum(dim=-1)
        vpos = torch.arange(logits.shape[-1], device=logits.device)
        lab_logit = torch.where(vpos == labels[..., None], logits,
                                0.0).sum(-1)
        lse = torch.log(sumexp) + m[..., 0]
        ce = (lse - lab_logit).mean()
        z = lse.square().mean()
    else:
        logp = torch.log_softmax(logits, dim=-1)
        ce = -logp.gather(-1, labels[..., None]).mean()
        z = torch.logsumexp(logits, dim=-1).square().mean()
    return ce + 1e-2 * aux + 1e-4 * z, {"ce": ce, "aux": aux, "z": z}


def prefill(cfg: ArchConfig, params, batch, max_len: int | None = None, *,
            last: bool = False, tp=None, seq_split: bool = False):
    """Run the prompt, return (logits [B,S,V], DecodeState) for decode,
    on the inputs' device; with ``last`` the logits are the last
    position's only, [B,1,V] (the others are never unembedded).

    dense/moe: the caches ``forward`` collects, padded to ``max_len``
    (default: the prompt length), ``pos`` = S on every lane; a ring cache
    (``_ring_cache_len``) takes the prompt at slots 0..S-1, and a prompt
    longer than the cache raises ``ValueError``, as the reference's
    write does.
    vlm: the same for the self layers' caches, and each cross layer's
    image K/V (``ik``, ``iv``), which decode reads and never writes.
    audio: as the reference does, the logits and an unused zero KV state
    with ``pos`` = S (the encoder has no decode step).
    hybrid/ssm: as the reference does, ``forward``'s logits and a COLD
    decode state (zero recurrent state, empty KV cache, ``pos`` 0): a
    decode after it does not see the prompt.  The reference documents
    this as a simplification (a warm-state prefill would be a feature it
    lacks).

    ``tp`` (this rank's parameter pieces and lanes): the split prefill
    (``_prefill_tp``): logits are this rank's vocab columns of the last
    position, [B, 1, V/tp] (``last`` taken), and with ``seq_split`` the
    caches hold this rank's positions, [L, B, W / tp, KV, hd] (W =
    max_len, or the ring's slots; the vlm's [ns, inner, B, W / tp, KV,
    hd], its image K/V whole); the recurrent families' state is cold,
    as without ``tp``."""
    check_family(cfg)
    x = batch["embeds"] if cfg.embed_inputs else batch["tokens"]
    if tp is not None:
        return _prefill_tp(cfg, params, batch, tp, max_len or x.shape[1],
                           seq_split)
    (B, S), device = x.shape[:2], x.device
    state = init_decode_state(cfg, B, max_len or S, device)
    pos = torch.full((B,), S, dtype=torch.int32, device=device)
    which = "last" if last else True
    if cfg.family in COLD_PREFILL + ("audio",):
        logits = forward(cfg, params, batch, return_logits=which)[0]
        if cfg.family == "audio":
            state = state._replace(pos=pos)
        return logits, state
    slots = state.caches["k"].shape[-3]
    if S > slots:
        # the reference's write of the prompt rows fails to broadcast
        raise ValueError(f"a {S}-token prompt does not fit the decode "
                         f"caches' {slots} positions")
    logits, _, caches = forward(cfg, params, batch, collect_cache=True,
                                return_logits=which)
    c = state.caches
    if cfg.family == "vlm":
        (k, v), (ik, iv) = caches
        c["k"][:, :, :, :S] = k
        c["v"][:, :, :, :S] = v
        c["ik"].copy_(ik)
        c["iv"].copy_(iv)
    else:
        k, v = caches
        c["k"][:, :, :S] = k.to(c["k"].dtype)
        c["v"][:, :, :S] = v.to(c["v"].dtype)
    return logits, state._replace(pos=pos)


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
    from the one-shot call's.  Only the plain-KV families qualify, as in
    the reference."""
    if cfg.family not in _KV_FAMILIES:
        raise NotImplementedError(
            f"forward_chunk supports plain-KV decoder families "
            f"{_KV_FAMILIES}; got {cfg.family!r}")
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


def _ring_cache_len(cfg: ArchConfig, max_len: int) -> int:
    """The decode caches' positions for ``max_len``: with
    ``REPRO_WINDOW_CACHE=1`` (read at each call, as the reference reads
    it at each trace) a plain-KV decoder whose every layer attends a
    sliding window keeps a ring of ``min(max_len, window)`` slots, slot
    ``pos % S`` holding position ``pos`` (``DenseBackend``'s ``ring``);
    else ``max_len``."""
    if (os.environ.get("REPRO_WINDOW_CACHE", "0") == "1"
            and cfg.sliding_window > 0 and cfg.global_attn_every == 0
            and cfg.family in _KV_FAMILIES):
        return min(max_len, cfg.sliding_window)
    return max_len


def init_decode_state(cfg: ArchConfig, batch: int, max_len: int,
                      device=None) -> DecodeState:
    """Zero decode state on ``device`` (the card unless the caller asks
    for the CPU), caches layer-stacked [L, ...]: dense/moe/audio {"k",
    "v"} [L, B, max_len, KV, hd]; hybrid the same plus "ssm" {"h"
    [L,B,di,state] fp32, "conv" [L,B,K-1,di]}; ssm {"mC" [L,B,H,hd,hd],
    "mn" [L,B,H,hd], "mm" [L,B,H], "s": {"h", "c", "n", "m"} [L,B,H,hd]},
    all fp32, ``mm`` 0 as in the reference (its parallel form starts the
    stabiliser at -1e30); vlm {"k", "v"} [ns, inner, B, max_len, KV, hd]
    and {"ik", "iv"} [ns, B, n_image_tokens, KV, hd].  The KV caches hold
    ``_ring_cache_len(cfg, max_len)`` positions."""
    check_family(cfg)
    device = resolve_device(device)
    dt, L = torch_dtype(cfg.dtype), cfg.n_layers
    pos = torch.zeros((batch,), dtype=torch.int32, device=device)
    kv = (batch, _ring_cache_len(cfg, max_len), cfg.n_kv_heads, cfg.hd)
    if cfg.family == "vlm":
        ns, inner = cfg.vlm_dims
        img = (ns, batch, cfg.n_image_tokens, cfg.n_kv_heads, cfg.hd)
        return DecodeState(pos, {
            "k": torch.zeros((ns, inner) + kv, dtype=dt, device=device),
            "v": torch.zeros((ns, inner) + kv, dtype=dt, device=device),
            "ik": torch.zeros(img, dtype=dt, device=device),
            "iv": torch.zeros(img, dtype=dt, device=device)})

    def stack(tree):
        if isinstance(tree, dict):
            return {k: stack(v) for k, v in tree.items()}
        return tree.expand((L,) + tree.shape).contiguous()

    if cfg.family == "ssm":
        caches = stack(xlstm_mod.xlstm_state_init(cfg, batch, device))
    else:
        caches = {"k": torch.zeros((L,) + kv, dtype=dt, device=device),
                  "v": torch.zeros((L,) + kv, dtype=dt, device=device)}
        if cfg.family == "hybrid":
            caches["ssm"] = stack(ssm_mod.ssm_state_init(cfg, batch, device))
    return DecodeState(pos, caches)


def _store_(dst: dict, src: dict):
    """Write a layer's new recurrent state into its slice of the stacked
    caches, in place."""
    for k, v in src.items():
        if isinstance(v, dict):
            _store_(dst[k], v)
        else:
            dst[k].copy_(v)


def _block_decode(cfg: ArchConfig, p, x, cache, pos, flag, backend, rope):
    """One block, one token per lane, over the dense path: ``cache`` is
    this layer's slice of the caches (views), updated in place.  The
    recurrent states advance on every lane, parked ones included, as in
    the reference."""
    h = rms_norm(x, p["norm1"], cfg.rms_eps)
    if cfg.family == "ssm":
        if flag:
            out, st = xlstm_mod.slstm_step(p, h, cache["s"])
            _store_(cache["s"], st)
        else:
            out, st = xlstm_mod.mlstm_step(
                p, h, {"C": cache["mC"], "n": cache["mn"], "m": cache["mm"]})
            _store_(cache, {"mC": st["C"], "mn": st["n"], "mm": st["m"]})
        return x + out
    # a ring cache (``DenseBackend.is_ring``) on the layers that all
    # attend the window; the hybrid's per-layer window never rings
    ring = cfg.family != "hybrid" and getattr(backend, "is_ring",
                                              lambda c: False)(cache)
    a, _ = attn.block_decode_attention(p["attn"], h, cfg, cache, pos,
                                       backend, window=_window(cfg, flag),
                                       rope=rope, ring=ring)
    if cfg.family == "hybrid":
        xz = h @ p["ssm"]["in_proj"].to(h.dtype)
        s_out, st = ssm_mod.ssm_step(p["ssm"], xz, cache["ssm"], cfg)
        _store_(cache["ssm"], st)
        x = x + rms_norm(a, p["norm_attn_out"], cfg.rms_eps) \
            + rms_norm(s_out, p["norm_ssm_out"], cfg.rms_eps)
    else:
        x = x + a
    return _ffn(p, x, cfg)[0]


def decode_step(cfg: ArchConfig, params, state: DecodeState, tokens,
                backend=None, *, n_pages: int | None = None, tp=None,
                seq_split: bool = False):
    """tokens [B] int -> (logits [B, vocab] fp32, new state).

    ``backend`` selects the KV storage (``models.kv_backend``): None /
    ``DenseBackend`` keeps contiguous caches (every decoder family the
    port runs; vlm's cross layers read the image K/V prefill stored);
    ``TieredBackend`` runs the fused path (dense/moe only) —
    ``begin_step`` once, one fused append+attend kernel per layer,
    ``end_step`` once.  ``n_pages`` (tiered only) is the live-page
    bucket; the caller guarantees it holds every live position plus this
    step's append.  Caches update in place.  The encoder (audio) has no
    decode step, as the reference's launcher says.

    ``tp`` (every decoder, over the dense caches): the split step
    (``_decode_step_tp``) on this rank's parameter pieces and lanes; with
    ``seq_split`` the caches hold this rank's positions and are never
    gathered.  The logits are this rank's vocab columns."""
    check_family(cfg)
    if cfg.is_encoder:
        raise NotImplementedError(
            f"{cfg.name} is encoder-only: no decode serving")
    if tp is not None:
        return _decode_step_tp(cfg, params, state, tokens, tp, seq_split)
    if backend is None:
        from .kv_backend import DenseBackend
        backend = DenseBackend(cfg, state.pos.device)
    x = params["embed"][tokens.long()[:, None]]
    pos = state.pos
    rope = rope_tables(pos[:, None], cfg.hd, cfg.rope_theta)
    if hasattr(backend, "begin_step"):
        if cfg.family not in _KV_FAMILIES:
            raise NotImplementedError(
                f"the fused tiered decode supports plain-KV decoder "
                f"families {_KV_FAMILIES}; got {cfg.family!r}")
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
    elif cfg.family == "vlm":
        caches = state.caches
        x = _vlm_decode(cfg, params, x, caches, pos, backend, rope)
    else:
        caches = state.caches
        for i, flag in enumerate(layer_flags(cfg)):
            x = _block_decode(cfg, layer_params(params["blocks"], i), x,
                              layer_params(caches, i), pos, bool(flag),
                              backend, rope)
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    logits = unembed(x, _table(cfg, params))[:, 0]
    return logits, DecodeState(pos + 1, caches)


def _vlm_decode(cfg: ArchConfig, params, x, caches, pos, backend, rope):
    """One token per lane through the super-blocks: each self layer over
    its [B, max_len, KV, hd] views of the stacked caches, each cross
    layer over its image K/V."""
    ns, inner = cfg.vlm_dims
    for s in range(ns):
        p_self = layer_params(params["blocks"]["self"], s)
        for j in range(inner):
            x = _block_decode(cfg, layer_params(p_self, j), x,
                              {"k": caches["k"][s, j],
                               "v": caches["v"][s, j]},
                              pos, False, backend, rope)
        x = _cross_block_fwd(cfg, layer_params(params["blocks"]["cross"], s),
                             x, (caches["ik"][s], caches["iv"][s]))
    return x


# ---------------------------------------------------------------------------
# tensor-parallel compute (sharding/tensor_parallel.py): every family
# ---------------------------------------------------------------------------

def _ffn_tp(cfg: ArchConfig, tp, p, x, aux: bool, sp: bool = False):
    """The block's second half on this rank's pieces -> (x, aux): the
    MLP on this rank's columns, or the MoE layer on this rank's experts
    (``moe.moe_ffn_split``; aux its load-balancing terms when ``aux``),
    summed over "model"; the audio MLP's output bias added once, after
    the sum.  With ``sp`` ``x`` is this rank's rows of the sequence: the
    norm runs on them, they are gathered before the products and the
    sum is reduce-scattered back onto them."""
    h2 = rms_norm(x, p["norm2"], cfg.rms_eps)
    if cfg.family == "moe":
        y, a = moe_mod.moe_ffn_split(p["moe"], h2, cfg, tp, aux=aux, sp=sp)
        return x + y, a
    m = p["mlp"]
    if cfg.family == "audio":
        y = gelu_mlp(tp.enter(h2, "mlp", sp), m["w_in"], m["b_in"],
                     m["w_out"])
        return x + (tp.exit(y, "mlp", sp) + m["b_out"]), None
    return x + tp.exit(swiglu(tp.enter(h2, "mlp", sp), m["w_gate"],
                              m["w_up"], m["w_down"]), "mlp", sp), None


def _ssm_branch_tp(cfg: ArchConfig, tp, p, h, state=None, sp: bool = False):
    """The hybrid's Mamba branch on this rank's channels, from ``h``
    past ``tp.enter`` (the whole sequence): x and z of them
    (``tp.ssm_in``), the scan (or, with the layer's recurrent ``state``
    whole over "model", one decode step, whose new state is gathered back
    into it), ``out_proj`` summed over "model" -> [B, S, d] (with ``sp``
    reduce-scattered: this rank's rows)."""
    xz = tp.ssm_in(h, p["ssm"]["in_proj"])
    if state is None:
        return tp.exit(ssm_mod.ssm_scan(p["ssm"], xz, cfg, tp), "ssm", sp)
    dims = ssm_mod.STATE_DIMS
    out, st = ssm_mod.ssm_step(p["ssm"], xz, tp.own_state(state, dims,
                                                          "ssm"), cfg, tp)
    _store_(state, tp.gather_state(st, dims, "ssm"))
    return tp.exit(out, "ssm")


def _xlstm_branch_tp(tp, p, h, flag, cache=None, sp: bool = False):
    """The xLSTM layer on this rank's heads: sLSTM where ``flag``, else
    mLSTM, its output summed over "model"; with the layer's state
    ``cache`` (whole over "model") one decode step, whose new state is
    gathered back into it.  With ``sp`` ``h`` is this rank's rows,
    gathered for the scan, and the sum is reduce-scattered."""
    h = tp.enter(h, "xlstm", sp)
    if cache is None:
        branch = xlstm_mod.slstm_scan if flag else xlstm_mod.mlstm_parallel
        return tp.exit(branch(p, h), "xlstm", sp)
    dims = xlstm_mod.STATE_DIMS
    if flag:
        out, st = xlstm_mod.slstm_step(p, h, tp.own_state(cache["s"], dims,
                                                          "xlstm"))
        _store_(cache["s"], tp.gather_state(st, dims, "xlstm"))
    else:
        out, st = xlstm_mod.mlstm_step(p, h, tp.own_state(
            {"C": cache["mC"], "n": cache["mn"], "m": cache["mm"]}, dims,
            "xlstm"))
        st = tp.gather_state(st, dims, "xlstm")
        _store_(cache, {"mC": st["C"], "mn": st["n"], "mm": st["m"]})
    return tp.exit(out, "xlstm")


def _block_fwd_tp(cfg: ArchConfig, tp, aux: bool, sp: bool, p_local, x,
                  positions, rope, flag: bool = False,
                  stack: str | None = None):
    """One block over the whole sequence on this rank's pieces of the
    layer (``tp.layer`` gathers them over the data axes, inside any
    remat, so a recomputing backward gathers again; ``stack`` the vlm's
    "self"): attention on this rank's heads, the MLP on its columns or
    the MoE layer on its experts, each summed over "model"; the hybrid's
    attention and Mamba branch side by side (each normed after its sum,
    ``flag`` its global layers), the xLSTM's heads (``flag`` its sLSTM
    layers).  With ``sp`` (``TensorParallel.splits_sequence``) ``x`` is
    this rank's rows [B, S/m, d]: the norms and residual adds run on
    them, one all-gather feeds each half's products (both hybrid
    branches share one) and the sums are reduce-scattered back.  Returns
    (x, aux or None, (k, v) of this rank's KV heads over the whole
    sequence, or None)."""
    p = tp.layer(p_local, stack, sp)
    h = rms_norm(x, p["norm1"], cfg.rms_eps)
    if cfg.family == "ssm":
        return x + _xlstm_branch_tp(tp, p, h, flag, sp=sp), None, None
    if cfg.family == "hybrid":
        ha = tp.enter(h, "attn", sp)
        q, k, v = attn._qkv(p["attn"], ha, cfg, positions, rope)
        out = attn.sdpa_auto(q, k, v, causal=True,
                             window=_window(cfg, flag))
        a = tp.exit(attn._out(out, p["attn"]["wo"]), "attn", sp)
        s = _ssm_branch_tp(cfg, tp, p, ha if sp else tp.enter(h, "ssm"),
                           sp=sp)
        x = x + rms_norm(a, p["norm_attn_out"], cfg.rms_eps) \
            + rms_norm(s, p["norm_ssm_out"], cfg.rms_eps)
        x, aux_l = _ffn_tp(cfg, tp, p, x, aux, sp)
        return x, aux_l, (k, v)
    a, kv = attn.self_attention(p["attn"], tp.enter(h, "attn", sp), cfg,
                                positions=positions, causal=cfg.causal,
                                window=cfg.sliding_window, rope=rope)
    x, aux_l = _ffn_tp(cfg, tp, p, x + tp.exit(a, "attn", sp), aux, sp)
    return x, aux_l, kv


def _cross_block_tp(cfg: ArchConfig, tp, p, x, ikv, sp: bool = False):
    """One gated cross-attention layer on this rank's pieces ``p``
    (gathered): q of this rank's heads against ``ikv``, the image K/V of
    its KV heads, ``wo`` summed over "model", then the MLP; with ``sp``
    on this rank's rows, as ``_block_fwd_tp``."""
    h = rms_norm(x, p["norm1"], cfg.rms_eps)
    a = attn.cross_attention(p["attn"], tp.enter(h, "attn", sp), ikv, cfg)
    return _ffn_tp(cfg, tp, p, x + tp.exit(a, "attn", sp), False, sp)[0]


def _vlm_forward_tp(cfg: ArchConfig, tp, params, x, positions, rope,
                    image_embeds, remat: str, on_layer, on_image, sp: bool):
    """The split super-block loop (``_vlm_forward`` on this rank's
    pieces): the self layers as the dense family's; each cross layer
    computes the image K/V of this rank's KV heads (``attn.image_kv``)
    and attends them with its query heads.  ``on_layer((s, j), (k, v))``
    sees each self layer's K/V and ``on_image(s, (ik, iv))`` each cross
    layer's image K/V; ``remat`` wraps each super-block; ``sp`` as
    ``_block_fwd_tp``'s (the image K/V never split by sequence)."""
    _check_image_dtype(image_embeds, x)

    def super_block(p_self, p_cross, x):
        kvs = []
        for pj in _unstack(p_self):
            x, _, kv = _block_fwd_tp(cfg, tp, False, sp, pj, x, positions,
                                     rope, stack="self")
            kvs.append(kv)
        p = tp.layer(p_cross, "cross", sp)
        ikv = attn.image_kv(p["attn"], image_embeds, cfg)
        return _cross_block_tp(cfg, tp, p, x, ikv, sp), kvs, ikv

    run = _remat(super_block, remat)
    for s, (p_self, p_cross) in enumerate(zip(
            _unstack(params["blocks"]["self"]),
            _unstack(params["blocks"]["cross"]))):
        x, kvs, ikv = run(p_self, p_cross, x)
        if on_layer is not None:
            for j, kv in enumerate(kvs):
                on_layer((s, j), kv)
        if on_image is not None:
            on_image(s, ikv)
    return x


def _table_path(cfg: ArchConfig) -> str:
    return "embed" if cfg.tie_embeddings else "unembed"


def _forward_tp(cfg: ArchConfig, params, batch, tp, *, remat: str = "none",
                logits: bool | str = True, on_layer=None, on_image=None,
                aux: bool = False):
    """The split forward on this rank's parameter pieces -> (this rank's
    vocab columns of the logits [B, S, V/tp] fp32 (of the last position
    only, [B, 1, V/tp], with ``logits="last"``; None without
    ``logits``), with ``aux`` the MoE load-balancing loss summed over
    layers (a 0-d fp32 tensor, 0 for the other families), else None);
    ``on_layer(i, (k, v))`` sees each layer's K/V (the vlm's: ``(s, j)``
    for i, and ``on_image`` its cross layers', ``_vlm_forward_tp``).
    The audio encoder takes ``batch["embeds"]``, with no RoPE and no
    mask; each layer takes its ``layer_flags``.  Where the stream splits
    by sequence (``tp.splits_sequence``) each rank embeds its own S/m
    rows and keeps them between the split products; the final norm runs
    on them and the unembedding gathers them (``tp.unembed``: with
    ``logits="last"`` only the last position, which the last "model"
    rank holds)."""
    inp = batch["embeds"] if cfg.embed_inputs else batch["tokens"]
    B, S = inp.shape[:2]
    sp = tp.splits_sequence(B, S)
    if cfg.embed_inputs:
        x = _embed_inputs(cfg, params, {
            "embeds": tp.own_rows(inp) if sp else inp})
    else:
        x = tp.embed(inp, tp.leaf("embed", params["embed"], sp), sp)
    positions = rope = None           # the encoder: no RoPE
    if cfg.causal:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device).expand(B, S)
        rope = rope_tables(positions, cfg.hd, cfg.rope_theta)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "vlm":
        x = _vlm_forward_tp(cfg, tp, params, x, positions, rope,
                            batch["image_embeds"], remat, on_layer, on_image,
                            sp)
    else:
        block = _remat(functools.partial(_block_fwd_tp, cfg, tp, aux, sp),
                       remat)
        for i, (p, flag) in enumerate(zip(_unstack(params["blocks"]),
                                          layer_flags(cfg))):
            x, aux_l, kv = block(p, x, positions, rope, bool(flag))
            if aux_l is not None:
                total = total + aux_l
            if on_layer is not None:
                on_layer(i, kv)
    total = tp.moe_aux(total, sp) if aux else None
    if not logits:
        return None, total
    if logits == "last":
        x = x[:, -1:]
    x = rms_norm(x, tp.leaf("final_norm", params["final_norm"], sp),
                 cfg.rms_eps)
    table = _table_path(cfg)
    return tp.unembed(x, tp.leaf(table, params[table], sp), sp,
                      last=logits == "last"), total


def _prefill_tp(cfg: ArchConfig, params, batch, tp, max_len: int,
                seq_split: bool):
    """The split prefill: each layer's K/V of this rank's heads laid out
    by sequence as soon as the layer has run (``tp.seq_layout``, an
    all-to-all over "model"), so ``decode_step(tp=...)`` continues from
    the state; the vlm's image K/V of this rank's KV heads gathered over
    "model" (``tp.gather_heads``: they stay whole there, as the
    reference lays them out).  Only the last position is unembedded: the
    logits are [B, 1, V/tp].  A ring cache (``_ring_cache_len``) is laid
    out at its W slots (the prompt at slots 0..S-1, which is position
    mod W), and a prompt longer than the cache raises ``ValueError`` as
    ``prefill`` does.  Under the sequence split (``_forward_tp``) each
    layer's K/V come from its gathered input, so they cover the whole
    prompt as without it.  The encoder returns the reference's unused zero
    state with ``pos`` = S; the recurrent families (``COLD_PREFILL``)
    the split forward's last logits and a cold state (``prefill``):
    caches of this rank's positions, the recurrent state whole over
    "model", ``pos`` 0."""
    x = batch["embeds"] if cfg.embed_inputs else batch["tokens"]
    (B, S), device = x.shape[:2], x.device
    if cfg.family in COLD_PREFILL:
        logits, _ = _forward_tp(cfg, params, batch, tp, logits="last")
        rows = max_len // tp.size if seq_split else max_len
        return logits, init_decode_state(cfg, B, rows, device)
    max_len = _ring_cache_len(cfg, max_len)
    if S > max_len:
        raise ValueError(f"a {S}-token prompt does not fit the decode "
                         f"caches' {max_len} positions")
    rows = max_len // tp.size if seq_split else max_len
    kv = (B, rows, cfg.n_kv_heads, cfg.hd)
    dt = torch_dtype(cfg.dtype)
    lead = cfg.vlm_dims if cfg.family == "vlm" else (cfg.n_layers,)
    caches = {"k": torch.zeros(lead + kv, dtype=dt, device=device),
              "v": torch.zeros(lead + kv, dtype=dt, device=device)}
    if cfg.family == "vlm":
        img = (lead[0], B, cfg.n_image_tokens, cfg.n_kv_heads, cfg.hd)
        caches.update(ik=torch.zeros(img, dtype=dt, device=device),
                      iv=torch.zeros(img, dtype=dt, device=device))

    def write(i, kv):
        for name, t in zip(("k", "v"), kv):
            caches[name][i] = tp.seq_layout(t, max_len, seq_split).to(dt)

    def write_image(s, ikv):
        for name, t in zip(("ik", "iv"), ikv):
            caches[name][s] = tp.gather_heads(t)
    logits, _ = _forward_tp(cfg, params, batch, tp, logits="last",
                            on_layer=None if cfg.is_encoder else write,
                            on_image=write_image)
    pos = torch.full((B,), S, dtype=torch.int32, device=device)
    return logits, DecodeState(pos, caches)


def _decode_step_tp(cfg: ArchConfig, params, state: DecodeState, tokens, tp,
                    seq_split: bool):
    """One split decode step (``decode_step(tp=...)``): per self layer, q
    and the new k/v of this rank's heads are all-gathered over "model" in
    one call ([B, H, hd], [B, KV, hd]); the rank whose positions hold a
    lane's ``pos`` (in a ring of W slots, slot ``pos % W``) writes its
    row; every rank attends its own positions for all heads
    (``DenseBackend.attend_shard``, one mask per window: the hybrid's
    global layers attend everything), the pieces merge by their lse
    (``tp.combine``), and each rank keeps its own heads for the
    row-split ``wo``; then the MLP or the MoE layer as in the forward:
    5 collectives a layer over a sequence-split cache.  A vlm cross
    layer attends with this rank's query heads the image K/V of its KV
    heads (``tp.own_heads`` of the whole ``ik``/``iv``): no gather and
    no merge, 2 collectives (``wo``'s and the MLP's sums).  The hybrid's
    Mamba branch and the xLSTM step this rank's channels or heads of the
    recurrent state and gather the new pieces back (``tp.gather_state``):
    4 more collectives a hybrid layer (``in_proj`` gathered, dt/B/C and
    the output summed, the state gathered), 2 an xLSTM layer (the
    output's sum and the state).  The recurrent states advance on every
    lane, parked ones included, as without ``tp``."""
    from .kv_backend import DenseBackend

    backend = DenseBackend(cfg, state.pos.device)
    x = tp.embed(tokens[:, None], tp.leaf("embed", params["embed"]))
    pos = state.pos
    caches = state.caches
    masks = {}
    if "k" in caches:
        rope = rope_tables(pos[:, None], cfg.hd, cfg.rope_theta)
        rows = caches["k"].shape[-3]
        start = tp.rank * rows if seq_split else 0
        slots = rows * tp.size if seq_split else rows
        # a ring (``DenseBackend.is_ring``) on the models whose every
        # layer attends the window; the hybrid's per-layer window never
        # rings
        ring = slots if cfg.family != "hybrid" \
            and 0 < slots <= cfg.sliding_window else 0
        # each lane's row in this rank's piece (outside it: no write)
        at = (torch.where(pos >= 0, pos.remainder(slots), -1) if ring
              else pos) - start

    def attention(p, h, cache, window):
        """This rank's term of the attention's sum over "model"."""
        q, k, v = tp.gather_qkv(*(t[:, 0] for t in attn._qkv(
            p["attn"], tp.enter(h, "attn"), cfg, pos[:, None], rope)))
        B, H, hd = q.shape
        KV = k.shape[1]
        backend.append(cache, k, v, at)
        if window not in masks:
            # this rank's positions against each lane's, once a step
            masks[window] = backend.shard_mask(pos, rows, start=start,
                                               window=window, ring=ring)
        out, lse = backend.attend_shard(cache, q.reshape(B, KV, H // KV, hd),
                                        pos, mask=masks[window])
        if seq_split:
            out = tp.combine(out, lse)
        out = tp.own_heads(out.reshape(B, 1, H, hd))
        return tp.exit(attn._out(out, p["attn"]["wo"]), "attn")

    def self_layer(x, p_local, cache, stack=None, flag=False):
        p = tp.layer(p_local, stack)
        h = rms_norm(x, p["norm1"], cfg.rms_eps)
        if cfg.family == "ssm":
            return x + _xlstm_branch_tp(tp, p, h, flag, cache)
        a = attention(p, h, cache, _window(cfg, flag))
        if cfg.family == "hybrid":
            s = _ssm_branch_tp(cfg, tp, p, tp.enter(h, "ssm"), cache["ssm"])
            x = x + rms_norm(a, p["norm_attn_out"], cfg.rms_eps) \
                + rms_norm(s, p["norm_ssm_out"], cfg.rms_eps)
        else:
            x = x + a
        return _ffn_tp(cfg, tp, p, x, False)[0]

    if cfg.family == "vlm":
        for s, (p_self, p_cross) in enumerate(zip(
                _unstack(params["blocks"]["self"]),
                _unstack(params["blocks"]["cross"]))):
            for j, pj in enumerate(_unstack(p_self)):
                x = self_layer(x, pj, {"k": caches["k"][s, j],
                                       "v": caches["v"][s, j]}, "self")
            ikv = tuple(tp.own_heads(caches[n][s]) for n in ("ik", "iv"))
            x = _cross_block_tp(cfg, tp, tp.layer(p_cross, "cross"), x, ikv)
    else:
        for i, (p_local, flag) in enumerate(zip(_unstack(params["blocks"]),
                                                layer_flags(cfg))):
            x = self_layer(x, p_local, layer_params(caches, i),
                           flag=bool(flag))
    x = rms_norm(x, tp.leaf("final_norm", params["final_norm"]),
                 cfg.rms_eps)
    table = _table_path(cfg)
    logits = unembed(tp.enter(x, "vocab"), tp.leaf(table, params[table]))
    return logits[:, 0], DecodeState(pos + 1, caches)
