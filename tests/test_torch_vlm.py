"""The vlm family (llama-3.2-vision-90b: super-blocks of self-attention
layers and one gated cross-attention layer to image K/V) against the JAX
reference, on its fp32 smoke config: 4 layers with ``cross_attn_every``
2, so 2 super-blocks of 1 self + 1 cross layer, 16 image tokens, d 64,
heads 4/2 of 16.

Both packages get the reference's own ``init_params`` (through numpy and
``from_jax_params``), with the cross layers' ``gate`` set non-zero in
both trees: the reference starts it at 0, and tanh(0) = 0 would hide the
whole cross branch.  Inputs come from one numpy seed.  Tolerance 1e-4
(fp32 on both sides, products and softmaxes summed in other orders).
Then the dtype case: a bf16 model with fp32 image embeddings, whose
image K/V and cross-attention output the reference promotes to fp32 and
whose forward it rejects."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduce_for_smoke as j_reduce
from repro.models import attention as j_attn
from repro.models import decode_step as j_decode_step
from repro.models import forward as j_forward
from repro.models import init_params as j_init_params
from repro.models import prefill as j_prefill
from repro.models.transformer import abstract_params_and_axes
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.models import (decode_step, forward, init_decode_state,
                                init_params, prefill)
from repro_torch.models import attention as attn
from repro_torch.weights import _expected_leaves, from_jax_params
from torch_threads import one_torch_thread  # noqa: F401

ARCH = "llama-3.2-vision-90b"
ATOL = 1e-4
B, S, MAX_LEN, STEPS = 2, 12, 20, 3
GATE = (0.7, -0.9)              # tanh 0.60 and -0.72


def _leaves(tree, path=""):
    """path -> leaf of a nested dict (NamedTuples by field)."""
    if hasattr(tree, "_fields"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{path}/{k}" if path else k))
        return out
    return {path: tree}


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    return jnp.asarray(tree)


@functools.lru_cache(maxsize=None)
def _models(dtype="float32"):
    """(reference cfg, its params, port cfg, the same params) with the
    cross gates set to ``GATE``."""
    jcfg = dataclasses.replace(j_reduce(j_get_config(ARCH)), dtype=dtype)
    cfg = dataclasses.replace(reduce_for_smoke(get_config(ARCH)), dtype=dtype)
    tree = jax.tree.map(np.asarray, j_init_params(jcfg, jax.random.key(3)))
    tree["blocks"]["cross"]["attn"]["gate"] = np.asarray(GATE, np.float32)
    return jcfg, _to_jax(tree), cfg, from_jax_params(tree, cfg, "cpu")


def _inputs(seed, cfg, n=S):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, n)).astype(np.int32)
    img = rng.normal(size=(B, cfg.n_image_tokens, cfg.d_model)).astype(
        np.float32)
    return toks, img


def _batches(toks, img):
    return ({"tokens": jnp.asarray(toks), "image_embeds": jnp.asarray(img)},
            {"tokens": torch.from_numpy(toks),
             "image_embeds": torch.from_numpy(img)})


def _close(got, want, msg=""):
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape, msg
    np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32),
                               rtol=0, atol=ATOL, err_msg=msg)


def test_smoke_config_has_two_super_blocks():
    cfg = reduce_for_smoke(get_config(ARCH))
    assert cfg.vlm_dims == (2, 1) and cfg.n_image_tokens == 16
    assert get_config(ARCH).vlm_dims == (20, 4)


def test_expected_leaves_match_reference_init_at_published_size():
    """The full config's leaves (path, shape, dtype), shapes only through
    ``abstract_params_and_axes``: the self stack [20, 4, ...], the cross
    stack [20, ...], the gate fp32 in a bf16 model."""
    want = {k: (tuple(v.shape), str(v.dtype)) for k, v in _leaves(
        abstract_params_and_axes(j_get_config(ARCH))[0]).items()}
    got = {k: (s, str(dt).removeprefix("torch.")) for k, (s, dt)
           in _expected_leaves(get_config(ARCH)).items()}
    assert got == want
    assert got["blocks/cross/attn/gate"] == ((20,), "float32")
    assert got["blocks/self/attn/wq"] == ((20, 4, 8192, 64, 128), "bfloat16")


def test_init_params_layout_and_zero_gate():
    """The port's own bf16 parameters carry the expected leaves; the gate
    starts at 0 (fp32), as the reference's does."""
    cfg = dataclasses.replace(reduce_for_smoke(get_config(ARCH)),
                              dtype="bfloat16")
    params = init_params(cfg, "cpu", seed=1)
    got = {k: (tuple(v.shape), v.dtype) for k, v in _leaves(params).items()}
    assert got == _expected_leaves(cfg)
    gate = params["blocks"]["cross"]["attn"]["gate"]
    assert gate.dtype == torch.float32 and not gate.any()


def test_forward_matches_reference():
    """Logits, and the collected caches leaf for leaf: the self layers'
    post-RoPE K/V [ns, inner, B, S, KV, hd] and each cross layer's image
    K/V [ns, B, T, KV, hd]."""
    jcfg, jparams, cfg, params = _models()
    jb, tb = _batches(*_inputs(1, cfg))
    jl, _, ((jk, jv), (jik, jiv)) = jax.jit(lambda p, b: j_forward(
        jcfg, p, b, collect_cache=True))(jparams, jb)
    tl, aux, ((k, v), (ik, iv)) = forward(cfg, params, tb,
                                          collect_cache=True)
    _close(tl, jl, "logits")
    assert float(aux) == 0.0
    for name, got, want in (("k", k, jk), ("v", v, jv), ("ik", ik, jik),
                            ("iv", iv, jiv)):
        _close(got, want, name)


def test_prefill_matches_reference():
    """Logits and the decode state: every cache leaf (shape, dtype,
    values; the self caches padded to max_len with zeros) and pos = S."""
    jcfg, jparams, cfg, params = _models()
    jb, tb = _batches(*_inputs(2, cfg))
    jl, js = j_prefill(jcfg, jparams, jb, max_len=MAX_LEN)
    tl, ts = prefill(cfg, params, tb, max_len=MAX_LEN)
    _close(tl, jl, "logits")
    np.testing.assert_array_equal(ts.pos.numpy(), np.asarray(js.pos))
    want, got = _leaves(js.caches), _leaves(ts.caches)
    assert sorted(got) == sorted(want) == ["ik", "iv", "k", "v"]
    for name, w in want.items():
        assert str(got[name].dtype).removeprefix("torch.") == str(w.dtype)
        _close(got[name], w, name)
    assert not ts.caches["k"][:, :, :, S:].any()


def test_decode_matches_reference():
    """Prefill, then 3 decode steps over the dense backend: logits within
    1e-4 at every step, and after the last every cache leaf (the image
    K/V untouched) and pos."""
    jcfg, jparams, cfg, params = _models()
    toks, img = _inputs(3, cfg)
    jb, tb = _batches(toks, img)
    _, js = j_prefill(jcfg, jparams, jb, max_len=MAX_LEN)
    _, ts = prefill(cfg, params, tb, max_len=MAX_LEN)
    ik0 = ts.caches["ik"].clone()
    jstep = jax.jit(lambda p, s, t: j_decode_step(jcfg, p, s, t))
    rng = np.random.default_rng(4)
    for i in range(STEPS):
        tok = rng.integers(0, cfg.vocab, B).astype(np.int32)
        jl, js = jstep(jparams, js, jnp.asarray(tok))
        tl, ts = decode_step(cfg, params, ts, torch.from_numpy(tok))
        _close(tl, jl, f"logits, step {i}")
    for name, w in _leaves(js.caches).items():
        _close(ts.caches[name], w, name)
    assert torch.equal(ts.caches["ik"], ik0)
    np.testing.assert_array_equal(ts.pos.numpy(), np.asarray(js.pos))
    assert ts.pos.tolist() == [S + STEPS] * B


def test_teacher_forced_decode_equals_forward():
    """The port against itself, as the card's gate holds it: the last 4
    tokens decoded one by one from a prefill of the rest give the
    forward's logits at their positions; other image embeddings move
    them (the cross branch is live)."""
    _, _, cfg, params = _models()
    toks, img = (torch.from_numpy(a) for a in _inputs(5, cfg))
    full = forward(cfg, params, {"tokens": toks, "image_embeds": img})[0]
    _, st = prefill(cfg, params, {"tokens": toks[:, :S - 4],
                                  "image_embeds": img}, max_len=S)
    for t in range(S - 4, S):
        lg, st = decode_step(cfg, params, st, toks[:, t])
        assert (lg - full[:, t]).abs().max().item() <= ATOL
    other = forward(cfg, params, {"tokens": toks,
                                  "image_embeds": img.flip(1) * 2})[0]
    assert (other - full).abs().max().item() > 1e-2


def test_zero_gate_hides_the_image():
    """With the reference's initial gate (0), the image embeddings change
    no logit, in both packages."""
    jcfg, jparams, cfg, params = _models()
    toks, img = _inputs(6, cfg)
    jp = {**jparams, "blocks": {**jparams["blocks"], "cross": {
        **jparams["blocks"]["cross"], "attn": {
            **jparams["blocks"]["cross"]["attn"],
            "gate": jnp.zeros_like(jparams["blocks"]["cross"]["attn"]
                                   ["gate"])}}}}
    p = {**params, "blocks": {**params["blocks"], "cross": {
        **params["blocks"]["cross"], "attn": {
            **params["blocks"]["cross"]["attn"],
            "gate": torch.zeros_like(params["blocks"]["cross"]["attn"]
                                     ["gate"])}}}}
    outs = []
    for im in (img, 3 * img[:, ::-1].copy()):
        jb, tb = _batches(toks, im)
        outs.append((forward(cfg, p, tb)[0], j_forward(jcfg, jp, jb)[0]))
    assert torch.equal(outs[0][0], outs[1][0])
    _close(outs[0][0], outs[0][1])


def test_fp32_image_embeds_in_a_bf16_model_promote_as_the_reference():
    """bf16 model, fp32 image embeddings: ``image_kv`` casts the weights
    to the embeddings' dtype, so the image K/V come out fp32, and the
    cross-attention output too (bf16 queries against fp32 keys promote);
    both packages agree within 1e-4 (|y| up to ~5).
    ``forward`` rejects the mix in both: the reference's layer scan
    cannot carry the fp32 residual stream it would make (TypeError).
    On a card the port's cross-attention (flash) takes K/V only in the
    queries' dtype and raises (``tests/test_torch_cuda.py``)."""
    jcfg, jparams, cfg, params = _models("bfloat16")
    toks, img = _inputs(7, cfg)
    jp = jax.tree.map(lambda t: t[0], jparams["blocks"]["cross"]["attn"])
    p = {k: v[0] for k, v in params["blocks"]["cross"]["attn"].items()}
    jik, jiv = j_attn.image_kv(jp, jnp.asarray(img), jcfg)
    ik, iv = attn.image_kv(p, torch.from_numpy(img), cfg)
    assert ik.dtype == iv.dtype == torch.float32
    assert jik.dtype == jiv.dtype == jnp.float32
    np.testing.assert_allclose(ik.numpy(), np.asarray(jik), rtol=0, atol=ATOL)
    np.testing.assert_allclose(iv.numpy(), np.asarray(jiv), rtol=0, atol=ATOL)
    x = np.random.default_rng(8).normal(size=(B, 5, cfg.d_model))
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).bfloat16()
    jy = j_attn.cross_attention(jp, jx, (jik, jiv), jcfg)
    y = attn.cross_attention(p, tx, (ik, iv), cfg)
    assert y.dtype == torch.float32 and jy.dtype == jnp.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0, atol=ATOL)
    jb, tb = _batches(toks, img)
    with pytest.raises(TypeError):
        j_forward(jcfg, jparams, jb)
    with pytest.raises(TypeError, match="image_embeds"):
        forward(cfg, params, tb)


def test_init_decode_state_layout():
    """The state the reference lays out: self caches [ns, inner, B,
    max_len, KV, hd], image K/V [ns, B, T, KV, hd], in the model's
    dtype; pos 0."""
    cfg = dataclasses.replace(reduce_for_smoke(get_config(ARCH)),
                              dtype="bfloat16")
    jcfg = dataclasses.replace(j_reduce(j_get_config(ARCH)),
                               dtype="bfloat16")
    from repro.models import init_decode_state as j_init_decode_state
    want = _leaves(j_init_decode_state(jcfg, 3, 24))
    got = _leaves(init_decode_state(cfg, 3, 24, "cpu"))
    assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in got.items()} == {
        k: (v.shape, str(v.dtype)) for k, v in want.items()}
