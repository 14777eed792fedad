"""The QKV-bias dense family (qwen2-7b, qwen2-72b, codeqwen1.5-7b) and the
MoE family (granite-moe-3b, mixtral-8x22b with its sliding window)
against the JAX reference, on the fp32 smoke configs, each widened back
to its family's real GQA group size (``reduce_for_smoke`` forces 4 heads
over 2 KV heads): G = 7, 8, 1, 3 and 6.  The qwen configs get random
non-zero biases (the reference starts them at zero); mixtral keeps the
smoke window of 16, shorter than every sequence here.

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
                                init_chunk_buffers, init_params, moe)
from repro_torch.models.kv_backend import DenseBackend, TieredBackend
from repro_torch.serve.engine import Engine, EngineConfig
from repro_torch.weights import from_jax_params, unit_fan_in

GROUPS = {"qwen2-7b": 7, "qwen2-72b": 8, "codeqwen1.5-7b": 1,
          "granite-moe-3b-a800m": 3, "mixtral-8x22b": 6}
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


@pytest.mark.parametrize("arch", sorted(GROUPS))
def test_forward_matches_reference(arch):
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


DECODE_CASES = [(a, b) for a in sorted(GROUPS) for b in ("dense", "tiered")
                if not (b == "tiered" and GROUPS[a] == 6)]


@pytest.mark.parametrize("arch,backend", DECODE_CASES)
def test_decode_matches_reference(arch, backend):
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
    jfwd = jax.jit(lambda p, t: j_forward(jcfg, p, {"tokens": t},
                                          collect_cache=True)[2])
    js, ts = jb.init_state(B, MAX_LEN), tb.init_state(B, MAX_LEN)
    rng = np.random.default_rng(5)
    for lane, n in PREFILLS:
        toks = _tokens(rng, cfg, 1, n)
        jk, jv = jfwd(jparams, jnp.asarray(toks))
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
            js, ts = jax.jit(jb.maintain)(js), tb.maintain(ts)
        js = js._replace(pos=js.pos.at[2].set(-1))
        ts = ts._replace(pos=torch.where(torch.arange(B) == 2, -1, ts.pos))
    np.testing.assert_array_equal(np.asarray(js.pos), ts.pos.numpy())
    if backend == "tiered":
        assert int(ts.caches.migrations) > 0


@pytest.mark.parametrize("arch", sorted(GROUPS))
def test_forward_chunk_matches_reference(arch):
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


def test_windowed_forward_above_chunked_threshold_matches_reference():
    """Mixtral's one-shot forward at 5120 tokens, above
    ``CHUNKED_THRESHOLD``: both packages run their online-softmax
    ``chunked_sdpa`` under the 16-token window; logits within 1e-4, and
    the window changes them (a window-0 forward differs by more)."""
    jcfg, jparams, cfg, params = _models("mixtral-8x22b")
    toks = _tokens(np.random.default_rng(8), cfg, 1, 5120)
    jl, _, _ = jax.jit(lambda p, t: j_forward(jcfg, p, {"tokens": t}))(
        jparams, jnp.asarray(toks))
    t = torch.from_numpy(toks)
    tl, _, _ = forward(cfg, params, {"tokens": t})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=ATOL)
    full, _, _ = forward(dataclasses.replace(cfg, sliding_window=0), params,
                         {"tokens": t})
    assert (full - tl).abs().max().item() > 100 * ATOL


# ---------------------------------------------------------------------------
# the port's own contracts on the MoE config, torch against torch
# ---------------------------------------------------------------------------

def _bucket(pos, mpp):
    mx = int(np.max(pos))
    if mx < 0:
        return None
    b = 1 << (mx // PAGE).bit_length()
    return None if b >= mpp else b


def _run_port(arch, backend, n_pages_fn, steps=16, seed=3):
    _, _, cfg, params = _models(arch)
    st = backend.init_state(B, MAX_LEN)
    rng = np.random.default_rng(seed)
    for lane, n in PREFILLS:
        toks = torch.from_numpy(_tokens(rng, cfg, 1, n))
        _, _, (k, v) = forward(cfg, params, {"tokens": toks},
                               collect_cache=True)
        st = backend.write_prefill(st, lane, k[:, 0], v[:, 0], n)
    out = []
    for i in range(steps):
        tok = torch.from_numpy(_tokens(rng, cfg, B))
        lg, st = decode_step(cfg, params, st, tok, backend=backend,
                             n_pages=n_pages_fn(st))
        out.append(lg.numpy())
        if i % 3 == 2 and isinstance(backend, TieredBackend):
            st = backend.maintain(st, max_moves=3)
    return np.stack(out), st


def _granite_tiered():
    _, _, cfg, _ = _models("granite-moe-3b-a800m")
    return TieredBackend(cfg, B, MAX_LEN, page_tokens=PAGE, fast_data_slots=4,
                         policy=get_policy("mea", epoch_len=2), device="cpu")


def test_granite_bucket_equals_full_width_bitwise():
    mpp = MAX_LEN // PAGE
    full, _ = _run_port("granite-moe-3b-a800m", _granite_tiered(),
                        lambda st: None)
    bkt, st = _run_port("granite-moe-3b-a800m", _granite_tiered(),
                        lambda st: _bucket(st.pos.numpy(), mpp))
    np.testing.assert_array_equal(full, bkt)
    assert int(st.caches.migrations) > 0


def test_granite_dense_equals_tiered():
    """The same token stream through both backends on the MoE config:
    logits within 1e-5, as for llama3-8b in ``test_torch_model.py`` (the
    dense read takes one softmax over the whole row, the fused read an
    online softmax page by page)."""
    _, _, cfg, _ = _models("granite-moe-3b-a800m")
    dense, _ = _run_port("granite-moe-3b-a800m", DenseBackend(cfg, "cpu"),
                         lambda st: None)
    tiered, st = _run_port("granite-moe-3b-a800m", _granite_tiered(),
                           lambda st: None)
    np.testing.assert_allclose(dense, tiered, rtol=0, atol=1e-5)
    assert int(st.caches.migrations) > 0


def test_moe_chunked_equals_one_shot_bitwise(monkeypatch):
    """On the MoE config the chunk forward reproduces the one-shot
    ``forward(collect_cache=True)`` bit for bit while no token is
    dropped, which the test asserts by counting every dispatch's drops
    (a chunk routes fewer tokens at a smaller capacity, so a drop would
    part the two).  The seeded router sends ~2.3x the mean load to its
    favourite experts, so at the config's capacity factor of 1.25 every
    prompt of 16 tokens or more drops some; here the factor is E/K,
    where an expert's capacity is the call's token count and no token
    can drop."""
    _, _, cfg, params = _models("granite-moe-3b-a800m")
    cfg = dataclasses.replace(cfg,
                              capacity_factor=cfg.n_experts / cfg.top_k)
    drops = []
    real = moe.dispatch

    def counted(eidx, n_experts, cap):
        slot, keep = real(eidx, n_experts, cap)
        drops.append(int((~keep).sum()))
        return slot, keep

    monkeypatch.setattr(moe, "dispatch", counted)
    P, ctx, C = 32, 27, 8
    tokens = np.zeros((1, P), np.int32)
    tokens[0, :ctx] = _tokens(np.random.default_rng(9), cfg, ctx)
    t = torch.from_numpy(tokens)
    logits, _, (k_ref, v_ref) = forward(cfg, params, {"tokens": t},
                                        collect_cache=True)
    bk, bv = init_chunk_buffers(cfg, P, device="cpu")
    for start in range(0, P, C):
        bk, bv, lg = forward_chunk(cfg, params, t[:, start:start + C], bk,
                                   bv, start, return_logits=True)
    assert len(drops) == cfg.n_layers * (1 + P // C) and sum(drops) == 0
    assert torch.equal(k_ref[:, :, :ctx], bk[:, :, :ctx])
    assert torch.equal(v_ref[:, :, :ctx], bv[:, :, :ctx])
    assert torch.equal(logits[:, P - C:], lg)


def test_refusals_match_reference():
    """A sliding window on the tiered backend (and so on the tiered
    engine) raises in both packages; the tiered backend and the engine
    refuse a family outside dense/moe, ``init_params`` and ``forward`` a
    family the port does not know."""
    jcfg, _, cfg, params = _models("mixtral-8x22b")
    with pytest.raises(NotImplementedError, match="sliding-window"):
        JTiered(jcfg, B, MAX_LEN)
    with pytest.raises(NotImplementedError, match="sliding-window"):
        TieredBackend(cfg, B, MAX_LEN, device="cpu")
    with pytest.raises(NotImplementedError, match="sliding-window"):
        Engine(cfg, params, EngineConfig(batch=B, max_len=MAX_LEN,
                                         backend="tiered"), device="cpu")
    Engine(cfg, params, EngineConfig(batch=B, max_len=MAX_LEN,
                                     backend="dense"), device="cpu")
    ssm = dataclasses.replace(cfg, family="ssm")
    unknown = dataclasses.replace(cfg, family="diffusion")
    for call in (lambda: TieredBackend(ssm, B, MAX_LEN, device="cpu"),
                 lambda: Engine(ssm, params, EngineConfig(), device="cpu"),
                 lambda: init_params(unknown, "cpu"),
                 lambda: forward(unknown, params, {"tokens": torch.zeros(
                     (1, 4), dtype=torch.int32)})):
        with pytest.raises(NotImplementedError, match="famil"):
            call()
