"""The QKV-bias dense family (qwen2-7b, qwen2-72b, codeqwen1.5-7b) and the
MoE family (granite-moe-3b, mixtral-8x22b with its sliding window)
against the JAX reference, on the fp32 smoke configs, each widened back
to its family's real GQA group size (``reduce_for_smoke`` forces 4 heads
over 2 KV heads): G = 7, 8, 1, 3 and 6.  The qwen configs get random
non-zero biases (the reference starts them at zero); mixtral keeps the
smoke window of 16, shorter than every sequence here.  This file holds
the qwen configs' cases and the checks both files run
(``check_forward``, ``check_decode``, ``check_forward_chunk``);
``test_torch_families_moe.py`` the MoE configs' and the port's own
contracts below.

Both packages get the same weights: the port's seeded ``init_params``,
in the reference's layout and dtypes, and back through
``from_jax_params``.  Tolerances: logits within 1e-4 (fp32 products and
softmaxes reduced in another order; |logits| stays below ~1), chunk
K/V and logits within 1e-5 as in ``test_torch_model.py``, the aux loss
within 1e-6.  Then the port's own contracts, torch against torch, on the
granite config: dense == tiered, bucket == full width, chunked ==
one-shot (no token dropped), and the refusals the reference makes."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduce_for_smoke as j_reduce
from repro.core.policy import get_policy as j_get_policy
from repro.models import decode_step as j_decode_step
from repro.models import forward as j_forward
from repro.models import forward_chunk as j_forward_chunk
from repro.models.kv_backend import DenseBackend as JDense
from repro.models.kv_backend import TieredBackend as JTiered
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core.policy import get_policy
from repro_torch.models import (decode_step, forward, forward_chunk,
                                init_chunk_buffers, init_params)
from repro_torch.models.kv_backend import DenseBackend, TieredBackend
from repro_torch.weights import from_jax_params, unit_fan_in
from torch_threads import one_torch_thread  # noqa: F401

GROUPS = {"qwen2-7b": 7, "qwen2-72b": 8, "codeqwen1.5-7b": 1,
          "granite-moe-3b-a800m": 3, "mixtral-8x22b": 6}
# the configs of each file
QWEN = ("codeqwen1.5-7b", "qwen2-72b", "qwen2-7b")
MOE = ("granite-moe-3b-a800m", "mixtral-8x22b")
B, MAX_LEN, PAGE, STEPS = 3, 64, 8, 24
PREFILLS = ((0, 13), (1, 21))     # (lane, prompt length); lane 2 parked
ATOL = 1e-4


def _cfgs(arch):
    """(reference, port) smoke configs with the family's group size."""
    G = GROUPS[arch]
    jcfg, cfg = j_reduce(j_get_config(arch)), reduce_for_smoke(
        get_config(arch))
    return (dataclasses.replace(jcfg, n_heads=G * jcfg.n_kv_heads),
            dataclasses.replace(cfg, n_heads=G * cfg.n_kv_heads))


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    return jnp.asarray(tree)


@functools.lru_cache(maxsize=None)
def _models(arch):
    jcfg, cfg = _cfgs(arch)
    params = init_params(cfg, "cpu", seed=3)
    tree = unit_fan_in(jax.tree.map(lambda t: t.numpy(), params), cfg)
    if cfg.qkv_bias:
        rng = np.random.default_rng(4)
        for k in ("bq", "bk", "bv"):
            leaf = tree["blocks"]["attn"][k]
            tree["blocks"]["attn"][k] = rng.normal(
                0, 0.5, leaf.shape).astype(np.float32)
    return jcfg, _to_jax(tree), cfg, from_jax_params(tree, cfg, "cpu")


def _tokens(rng, cfg, *shape):
    return rng.integers(0, cfg.vocab, shape).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _reference_prefills(arch):
    """The decode test's prompts (``PREFILLS``, drawn first from its
    seeded stream) and the reference's K/V of each, computed once for
    both backends' cases: (the generator after the prompts, [(lane,
    length, tokens, k, v)])."""
    jcfg, jparams, cfg, _ = _models(arch)
    jfwd = jax.jit(lambda p, t: j_forward(jcfg, p, {"tokens": t},
                                          collect_cache=True)[2])
    rng = np.random.default_rng(5)
    out = []
    for lane, n in PREFILLS:
        toks = _tokens(rng, cfg, 1, n)
        jk, jv = jfwd(jparams, jnp.asarray(toks))
        out.append((lane, n, toks, jk, jv))
    return rng.bit_generator.state, out


def decode_cases(archs) -> list:
    """(arch, backend) of ``check_decode``: dense and tiered, dense only
    for mixtral's window (the tiered backend refuses it)."""
    return [(a, b) for a in archs for b in ("dense", "tiered")
            if not (b == "tiered" and GROUPS[a] == 6)]


@pytest.mark.parametrize("arch", QWEN)
def test_forward_matches_reference(arch):
    check_forward(arch)


@pytest.mark.parametrize("arch,backend", decode_cases(QWEN))
def test_decode_matches_reference(arch, backend):
    """``check_decode``."""
    check_decode(arch, backend)


@pytest.mark.parametrize("arch", QWEN)
def test_forward_chunk_matches_reference(arch):
    """``check_forward_chunk``."""
    check_forward_chunk(arch)


def check_forward(arch):
    """The forward's logits and K/V within 1e-4 of the reference's, the
    aux loss within 1e-6 (positive for MoE)."""
    jcfg, jparams, cfg, params = _models(arch)
    assert cfg.n_heads // cfg.n_kv_heads == GROUPS[arch]
    toks = _tokens(np.random.default_rng(1), cfg, 2, 40)
    jl, jaux, (jk, _) = jax.jit(lambda p, t: j_forward(
        jcfg, p, {"tokens": t}, collect_cache=True))(jparams,
                                                      jnp.asarray(toks))
    tl, aux, (k, _) = forward(cfg, params, {"tokens": torch.from_numpy(toks)},
                              collect_cache=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=ATOL)
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), rtol=0, atol=ATOL)
    assert abs(float(aux) - float(jaux)) <= 1e-6
    if cfg.family == "moe":
        assert float(aux) > 0


def check_decode(arch, backend):
    """Prefill two lanes, park the third, then 24 teacher-forced decode
    steps through both packages' backends (tiered: a maintenance pass
    every 3 steps): logits within 1e-4 at every step.  MoE routes all
    three lanes' tokens, the parked one's included, as the reference
    does."""
    jcfg, jparams, cfg, params = _models(arch)
    if backend == "tiered":
        jb = JTiered(jcfg, B, MAX_LEN, page_tokens=PAGE, fast_data_slots=4,
                     policy=j_get_policy("threshold", epoch_len=2))
        tb = TieredBackend(cfg, B, MAX_LEN, page_tokens=PAGE,
                           fast_data_slots=4,
                           policy=get_policy("threshold", epoch_len=2),
                           device="cpu")
    else:
        jb, tb = JDense(jcfg), DenseBackend(cfg, "cpu")
    jstep = jax.jit(lambda p, s, t: j_decode_step(jcfg, p, s, t, backend=jb))
    jmaint = jax.jit(jb.maintain)
    js, ts = jb.init_state(B, MAX_LEN), tb.init_state(B, MAX_LEN)
    state, prefills = _reference_prefills(arch)
    rng = np.random.default_rng(5)
    rng.bit_generator.state = state
    for lane, n, toks, jk, jv in prefills:
        _, _, (k, v) = forward(cfg, params, {"tokens": torch.from_numpy(toks)},
                               collect_cache=True)
        js = jb.write_prefill(js, lane, jk[:, 0], jv[:, 0], n)
        ts = tb.write_prefill(ts, lane, k[:, 0], v[:, 0], n)
    js = js._replace(pos=js.pos.at[2].set(-1))
    ts = ts._replace(pos=torch.tensor([13, 21, -1], dtype=torch.int32))
    for i in range(STEPS):
        tok = _tokens(rng, cfg, B)
        jl, js = jstep(jparams, js, jnp.asarray(tok))
        tl, ts = decode_step(cfg, params, ts, torch.from_numpy(tok),
                             backend=tb)
        np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2],
                                   rtol=0, atol=ATOL, err_msg=f"step {i}")
        if backend == "tiered" and i % 3 == 2:
            js, ts = jmaint(js), tb.maintain(ts)
        js = js._replace(pos=js.pos.at[2].set(-1))
        ts = ts._replace(pos=torch.where(torch.arange(B) == 2, -1, ts.pos))
    np.testing.assert_array_equal(np.asarray(js.pos), ts.pos.numpy())
    if backend == "tiered":
        assert int(ts.caches.migrations) > 0


def check_forward_chunk(arch):
    """A 27-token prompt padded to 32, in back-aligned 8-token chunks,
    through both packages' chunk forwards: K/V buffers and chunk logits
    within 1e-5 after every chunk."""
    jcfg, jparams, cfg, params = _models(arch)
    P, ctx, C = 32, 27, 8
    tokens = np.zeros((1, P), np.int32)
    tokens[0, :ctx] = _tokens(np.random.default_rng(6), cfg, ctx)
    jfc = jax.jit(lambda p, t, a, b, s: j_forward_chunk(
        jcfg, p, t, a, b, s, return_logits=True))
    jbk = jnp.zeros((cfg.n_layers, 1, P, cfg.n_kv_heads, cfg.hd))
    jbv = jnp.zeros_like(jbk)
    bk, bv = init_chunk_buffers(cfg, P, device="cpu")
    for start in range(0, P, C):
        chunk = tokens[:, start:start + C]
        jbk, jbv, jl = jfc(jparams, jnp.asarray(chunk), jbk, jbv, start)
        bk, bv, tl = forward_chunk(cfg, params, torch.from_numpy(chunk), bk,
                                   bv, start, return_logits=True)
        for got, want in ((bk, jbk), (bv, jbv), (tl, jl)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=1e-5,
                                       err_msg=f"start {start}")
