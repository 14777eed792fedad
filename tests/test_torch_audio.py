"""The audio family (hubert-xlarge: a bidirectional encoder over frame
embeddings, GELU MLPs with biases, no RoPE, no embedding table) against
the JAX reference, then the refusals both packages make for the encoder
and for the vlm family.

Both packages get the same weights, with random non-zero MLP biases
(the reference starts them at zero), through numpy and
``from_jax_params``.  Two configs: the fp32 smoke config (2 layers, d 64,
heads 4/2 of 16) with the reference's own ``init_params``, and a narrow
one at the card's head dim, hd 80 (d 160, 2 heads, 2 layers), with the
port's ``init_params`` except the attention projections, which the test
draws itself at 1/sqrt(d) (wq, wk, wv) and 1/sqrt(H*hd) (wo): both
packages' init scales them by 1/sqrt(H) and 1/sqrt(hd) (``dense_init``
takes ``shape[-2]`` as the fan-in), which at H = 2 makes q and k ~9x
their 1/sqrt(d) size and the attention nearly one-hot, so fp32
reassociation alone parts the two packages' logits by ~1.4e-4 there.
Tolerance 1e-4 (fp32 on both sides, products and softmaxes summed in
other orders)."""

import dataclasses
import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduce_for_smoke as j_reduce
from repro.launch import serve as j_serve
from repro.models import forward as j_forward
from repro.models import forward_chunk as j_forward_chunk
from repro.models import init_params as j_init_params
from repro.models import prefill as j_prefill
from repro.models.kv_backend import TieredBackend as JTiered
from repro.models.transformer import abstract_params_and_axes
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import EngineConfig as JEngineConfig
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.launch import serve
from repro_torch.models import (decode_step, forward, forward_chunk,
                                init_chunk_buffers, init_decode_state,
                                init_params, prefill)
from repro_torch.models.kv_backend import TieredBackend
from repro_torch.serve.engine import Engine, EngineConfig
from repro_torch.weights import _expected_leaves, from_jax_params
from torch_threads import one_torch_thread  # noqa: F401

ARCH, VLM = "hubert-xlarge", "llama-3.2-vision-90b"
ATOL = 1e-4
B, S, MAX_LEN = 2, 24, 32
# the narrow config at the card's head dim: d 160, 2 MHA heads of 80
HD80 = dict(d_model=160, n_heads=2, n_kv_heads=2, head_dim=80, d_ff=192,
            n_layers=2)


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
def _models(arch=ARCH, narrow=False):
    """(reference cfg, params, port cfg, the same params): the
    reference's ``init_params``, or for the ``narrow`` hd-80 config the
    port's with attention projections drawn at 1/sqrt(d) and
    1/sqrt(H*hd); hubert's MLP biases random."""
    jcfg, cfg = j_reduce(j_get_config(arch)), reduce_for_smoke(
        get_config(arch))
    if narrow:
        jcfg = dataclasses.replace(jcfg, **HD80)
        cfg = dataclasses.replace(cfg, **HD80)
        tree = jax.tree.map(lambda t: t.numpy(),
                            init_params(cfg, "cpu", seed=5))
        proj = np.random.default_rng(7)
        fan_in = {"wq": cfg.d_model, "wk": cfg.d_model, "wv": cfg.d_model,
                  "wo": cfg.n_heads * cfg.hd}
        attn = tree["blocks"]["attn"]
        for k, n in fan_in.items():
            attn[k] = (proj.standard_normal(attn[k].shape)
                       / np.sqrt(n)).astype(np.float32)
    else:
        tree = jax.tree.map(np.asarray,
                            j_init_params(jcfg, jax.random.key(5)))
    rng = np.random.default_rng(6)
    if cfg.family == "audio":
        mlp = tree["blocks"]["mlp"]
        for k in ("b_in", "b_out"):
            mlp[k] = rng.normal(0, 0.5, mlp[k].shape).astype(np.float32)
    return jcfg, _to_jax(tree), cfg, from_jax_params(tree, cfg, "cpu")


def _embeds(seed, cfg, n=S):
    return np.random.default_rng(seed).normal(
        size=(B, n, cfg.d_model)).astype(np.float32)


def test_expected_leaves_match_reference_init_at_published_size():
    """The full config's leaves (path, shape, dtype), shapes only through
    ``abstract_params_and_axes``: no embedding table, the GELU MLP's
    weights and biases."""
    want = {k: (tuple(v.shape), str(v.dtype)) for k, v in _leaves(
        abstract_params_and_axes(j_get_config(ARCH))[0]).items()}
    got = {k: (s, str(dt).removeprefix("torch.")) for k, (s, dt)
           in _expected_leaves(get_config(ARCH)).items()}
    assert got == want
    assert "embed" not in got
    assert got["blocks/mlp/b_in"] == ((48, 5120), "bfloat16")


def test_init_params_layout():
    """The port's own bf16 parameters carry the expected leaves, the
    biases at zero as the reference's are."""
    cfg = dataclasses.replace(reduce_for_smoke(get_config(ARCH)),
                              dtype="bfloat16")
    params = init_params(cfg, "cpu", seed=1)
    got = {k: (tuple(v.shape), v.dtype) for k, v in _leaves(params).items()}
    assert got == _expected_leaves(cfg)
    assert not params["blocks"]["mlp"]["b_in"].any()


@pytest.mark.parametrize("narrow", [False, True], ids=["smoke", "hd80"])
def test_forward_matches_reference(narrow):
    """Logits and the collected K/V [L, B, S, KV, hd] (no RoPE) within
    1e-4; the smoke config over 24 frames, the hd-80 one over 70 (two
    key blocks of the card's kernel)."""
    jcfg, jparams, cfg, params = _models(narrow=narrow)
    if narrow:
        assert cfg.hd == 80 and cfg.n_heads == cfg.n_kv_heads == 2
    emb = _embeds(1, cfg, 70 if narrow else S)
    jl, jaux, (jk, jv) = jax.jit(lambda p, e: j_forward(
        jcfg, p, {"embeds": e}, collect_cache=True))(jparams,
                                                     jnp.asarray(emb))
    tl, aux, (k, v) = forward(cfg, params, {"embeds": torch.from_numpy(emb)},
                              collect_cache=True)
    assert tl.shape == (B, emb.shape[1], cfg.vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=ATOL)
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), rtol=0, atol=ATOL)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=0, atol=ATOL)
    assert float(aux) == float(jaux) == 0.0


def test_attention_is_bidirectional():
    """A later frame moves an earlier frame's logits (no causal mask), in
    both packages alike."""
    jcfg, jparams, cfg, params = _models()
    emb = _embeds(2, cfg)
    moved = emb.copy()
    moved[:, -1] += 1.0
    got = [forward(cfg, params, {"embeds": torch.from_numpy(e)})[0][:, 0]
           for e in (emb, moved)]
    want = [j_forward(jcfg, jparams, {"embeds": jnp.asarray(e)})[0][:, 0]
            for e in (emb, moved)]
    assert (got[1] - got[0]).abs().max().item() > 1e-3
    np.testing.assert_allclose((got[1] - got[0]).numpy(),
                               np.asarray(want[1] - want[0]), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("narrow", [False, True], ids=["smoke", "hd80"])
def test_prefill_matches_reference(narrow):
    """Logits within 1e-4, and the reference's unused zero KV state
    [L, B, max_len, KV, hd] with pos = S, exactly."""
    jcfg, jparams, cfg, params = _models(narrow=narrow)
    emb = _embeds(3, cfg)
    jl, js = j_prefill(jcfg, jparams, {"embeds": jnp.asarray(emb)},
                       max_len=MAX_LEN)
    tl, ts = prefill(cfg, params, {"embeds": torch.from_numpy(emb)},
                     max_len=MAX_LEN)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(ts.pos.numpy(), np.asarray(js.pos))
    assert ts.pos.tolist() == [S] * B
    want, got = _leaves(js.caches), _leaves(ts.caches)
    assert sorted(got) == sorted(want) == ["k", "v"]
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape
        assert str(got[k].dtype).removeprefix("torch.") == str(w.dtype)
        assert not got[k].any() and not np.asarray(w).any()


def test_decode_step_refuses_the_encoder():
    """The encoder has no decode step: the port says so with the
    reference launcher's words (the reference's ``decode_step`` itself
    fails on the missing embedding table)."""
    _, _, cfg, params = _models()
    st = init_decode_state(cfg, B, MAX_LEN, "cpu")
    with pytest.raises(NotImplementedError,
                       match="encoder-only: no decode serving"):
        decode_step(cfg, params, st, torch.zeros(B, dtype=torch.int32))


def _refusal(kind, arch):
    """(port call, reference call) that must each raise for ``arch``."""
    jcfg, jparams, cfg, params = _models(arch)
    if kind == "engine":
        return (lambda: Engine(cfg, params, EngineConfig(), device="cpu"),
                lambda: JEngine(jcfg, jparams, JEngineConfig()))
    if kind == "forward_chunk":
        bk, bv = init_chunk_buffers(cfg, 16, 1, device="cpu")
        toks = np.zeros((1, 8), np.int32)
        return (lambda: forward_chunk(cfg, params, torch.from_numpy(toks),
                                      bk, bv, 0),
                lambda: j_forward_chunk(jcfg, jparams, jnp.asarray(toks),
                                        jnp.asarray(bk.numpy()),
                                        jnp.asarray(bv.numpy()), 0))
    if kind == "tiered":
        return (lambda: TieredBackend(cfg, 2, 64, device="cpu"),
                lambda: JTiered(jcfg, 2, 64))
    argv = ["--arch", arch, "--smoke"]
    return (lambda: serve.main(argv + ["--device", "cpu"]),
            lambda: j_serve.main())


@pytest.mark.parametrize("arch", [ARCH, VLM])
@pytest.mark.parametrize("kind", ["engine", "forward_chunk", "tiered",
                                  "serve"])
def test_refusals_match_reference(monkeypatch, kind, arch):
    """The engine, the chunked-prefill forward, the tiered store and the
    launcher refuse the encoder and the vlm family with the reference's
    exception and message: the launcher exits with "<name> is
    encoder-only: no decode serving" for hubert before it builds
    anything, and with the engine's refusal for the vlm."""
    port, ref = _refusal(kind, arch)
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", arch, "--smoke"])
    exc = SystemExit if kind == "serve" else NotImplementedError
    with pytest.raises(exc) as want:
        ref()
    with pytest.raises(exc) as got:
        port()
    assert str(got.value) == str(want.value)
    if kind == "serve":
        assert str(got.value) == (
            f"{arch}-smoke is encoder-only: no decode serving" if arch == ARCH
            else f"{arch}-smoke: Engine prefill supports KV-cache families "
                 f"('dense', 'moe'); got 'vlm'")


@pytest.mark.parametrize("arch", [ARCH, VLM])
def test_fused_tiered_decode_refuses(arch):
    """decode_step's fused branch (a backend with ``begin_step``) takes
    only the plain-KV families; the encoder is refused first."""
    _, _, cfg, params = _models(arch)
    llama = reduce_for_smoke(get_config("llama3-8b"))
    be = TieredBackend(llama, 2, 64, device="cpu")
    st = init_decode_state(cfg, 2, 64, "cpu")
    with pytest.raises(NotImplementedError,
                       match="encoder-only" if arch == ARCH else "plain-KV"):
        decode_step(cfg, params, st, torch.zeros(2, dtype=torch.int32),
                    backend=be)
