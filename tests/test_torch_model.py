"""The whole slice at step level: the port's decoder and tiered backend
against the JAX reference on the fp32 smoke llama3-8b, teacher-forced
over 24 steps with prefill, ragged lanes, synchronous and overlapped
maintenance and a mid-stream release.  Logits agree within 1e-4 (fp32
matmuls reduce in another order); the tiered metadata is exactly equal.
The chunked-prefill forward against the reference's.  Plus the port's
own contracts, torch against torch."""

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
from repro.models import init_params as j_init_params
from repro.models.kv_backend import TieredBackend as JTiered
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core.policy import get_policy
from repro_torch.models import (decode_step, forward, forward_chunk,
                                init_chunk_buffers, init_params)
from repro_torch.models.kv_backend import DenseBackend, TieredBackend
from repro_torch.tiered import kvcache as tk
from repro_torch.weights import from_jax_params, unit_fan_in
from torch_threads import one_torch_thread  # noqa: F401

B, MAX_LEN, PAGE, STEPS = 2, 64, 8, 24
PREFILLS = ((0, 5), (1, 13), (0, 9))      # (lane, ctx len); third at step 12
ATOL = 1e-4


@functools.lru_cache(maxsize=1)
def _models():
    jcfg = j_reduce(j_get_config("llama3-8b"))
    jparams = j_init_params(jcfg, jax.random.key(0))
    cfg = reduce_for_smoke(get_config("llama3-8b"))
    params = from_jax_params(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jcfg, jparams, cfg, params


def _bucket(pos, mpp):
    mx = int(np.max(pos))
    if mx < 0:
        return None
    b = 1 << (mx // PAGE).bit_length()
    return None if b >= mpp else b


def _prompt(rng, cfg, n):
    return rng.integers(0, cfg.vocab, (1, n)).astype(np.int32)


@pytest.mark.parametrize("preset", ["threshold", "write_aware"])
def test_decode_steps_match_reference(preset):
    jcfg, jparams, cfg, params = _models()
    jb = JTiered(jcfg, B, MAX_LEN, page_tokens=PAGE, fast_data_slots=4,
                 policy=j_get_policy(preset, epoch_len=2))
    tb = TieredBackend(cfg, B, MAX_LEN, page_tokens=PAGE, fast_data_slots=4,
                       policy=get_policy(preset, epoch_len=2), device="cpu")
    jstep = jax.jit(lambda p, s, t, n: j_decode_step(jcfg, p, s, t,
                                                     backend=jb, n_pages=n),
                    static_argnums=(3,))
    jfwd = jax.jit(lambda p, t: j_forward(jcfg, p, {"tokens": t},
                                          collect_cache=True)[2])
    jplan = jax.jit(jb.plan_maintain)
    japply = jax.jit(jb.apply_maintain)
    jrelease = jax.jit(jb.release)
    js, ts = jb.init_state(B, MAX_LEN), tb.init_state(B, MAX_LEN)
    rng = np.random.default_rng(11)

    def prefill(js, ts, lane, n):
        toks = _prompt(rng, cfg, n)
        jk_, jv_ = jfwd(jparams, jnp.asarray(toks))
        _, _, (k, v) = forward(cfg, params, {"tokens": torch.from_numpy(toks)},
                               collect_cache=True)
        np.testing.assert_allclose(k.numpy(), np.asarray(jk_), atol=ATOL)
        js = jb.write_prefill(js, lane, jk_[:, 0], jv_[:, 0], n)
        ts = tb.write_prefill(ts, lane, k[:, 0], v[:, 0], n)
        return js, ts

    for lane, n in PREFILLS[:2]:
        js, ts = prefill(js, ts, lane, n)
    tokens = rng.integers(0, cfg.vocab, (STEPS, B)).astype(np.int32)
    pending = None
    for i in range(STEPS):
        if pending is not None:                    # overlapped apply
            js, ts = japply(js, pending[0]), tb.apply_maintain(ts, pending[1])
            pending = None
        n = _bucket(np.asarray(js.pos), tb.tcfg.max_pages_per_seq)
        jl, js = jstep(jparams, js, jnp.asarray(tokens[i]), n)
        tl, ts = decode_step(cfg, params, ts, torch.from_numpy(tokens[i]),
                             backend=tb, n_pages=n)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=ATOL, err_msg=f"step {i}")
        if i % 3 == 2:
            plans = (jplan(js), tb.plan_maintain(ts))
            if i % 2:
                js, ts = japply(js, plans[0]), tb.apply_maintain(ts, plans[1])
            else:
                pending = plans
        if i == 12:                                # recycle lane 0
            if pending is not None:
                js = japply(js, pending[0])
                ts = tb.apply_maintain(ts, pending[1])
                pending = None
            js, ts = jrelease(js, jnp.int32(0)), tb.release(ts, 0)
            js, ts = prefill(js, ts, *PREFILLS[2])
        for f in tk.TieredState._fields:
            if f in tk.POOL_FIELDS:
                continue
            np.testing.assert_array_equal(
                np.asarray(getattr(js.caches, f))[0].astype(np.int64),
                getattr(ts.caches, f).numpy().astype(np.int64),
                f"step {i} {f}")
        np.testing.assert_array_equal(np.asarray(js.pos), ts.pos.numpy())
    c = ts.caches
    assert int(c.migrations) > 0 and int(c.dev_hits) > 0
    for f in tk.POOL_FIELDS:
        np.testing.assert_allclose(getattr(c, f).numpy(),
                                   np.asarray(getattr(js.caches, f)),
                                   rtol=0, atol=ATOL)


def _run_port(backend, n_pages_fn, steps=16, seed=3):
    _, _, cfg, params = _models()
    st = backend.init_state(B, MAX_LEN)
    rng = np.random.default_rng(seed)
    for lane, n in PREFILLS[:2]:
        toks = torch.from_numpy(_prompt(rng, cfg, n))
        _, _, (k, v) = forward(cfg, params, {"tokens": toks},
                               collect_cache=True)
        st = backend.write_prefill(st, lane, k[:, 0], v[:, 0], n)
    out = []
    for i in range(steps):
        tok = torch.from_numpy(
            rng.integers(0, cfg.vocab, B).astype(np.int32))
        lg, st = decode_step(cfg, params, st, tok, backend=backend,
                             n_pages=n_pages_fn(st))
        out.append(lg.numpy())
        if i % 3 == 2 and isinstance(backend, TieredBackend):
            st = backend.maintain(st, max_moves=3)
    return np.stack(out), st


def _tiered():
    _, _, cfg, _ = _models()
    return TieredBackend(cfg, B, MAX_LEN, page_tokens=PAGE, fast_data_slots=4,
                         policy=get_policy("mea", epoch_len=2), device="cpu")


def test_port_bucket_equals_full_width_bitwise():
    mpp = MAX_LEN // PAGE
    full, _ = _run_port(_tiered(), lambda st: None)
    bkt, st = _run_port(_tiered(), lambda st: _bucket(st.pos.numpy(), mpp))
    np.testing.assert_array_equal(full, bkt)
    assert int(st.caches.migrations) > 0


def test_port_dense_equals_tiered():
    """Same token stream through both backends: logits within 1e-5 (the
    dense path takes one softmax over the whole row, the fused path an
    online softmax page by page)."""
    _, _, cfg, _ = _models()
    dense, _ = _run_port(DenseBackend(cfg, "cpu"), lambda st: None)
    tiered, st = _run_port(_tiered(), lambda st: None)
    np.testing.assert_allclose(dense, tiered, rtol=0, atol=1e-5)
    assert int(st.caches.migrations) > 0


# (padded length P, real prompt tokens, chunk C): C divides P, and not
CHUNK_CASES = [(32, 27, 8), (64, 50, 24)]


def _chunk_starts(P, C):
    """The scheduler's chunk starts: the last chunk back-aligned."""
    return [min(s, P - C) for s in range(0, P, C)]


@functools.lru_cache(maxsize=1)
def _port_seeded_models():
    """The port's seeded weights with the projections rescaled to their
    contracted fan-in (``unit_fan_in``) in both packages' layouts: at the
    reference's ``dense_init`` scale, sqrt(d/H) larger for q and k, K
    rows reach ~14 and one fp32 ulp there is ~1e-6."""
    jcfg = j_reduce(j_get_config("llama3-8b"))
    cfg = reduce_for_smoke(get_config("llama3-8b"))
    params = unit_fan_in(init_params(cfg, "cpu", seed=2), cfg)
    like = lambda t, x: {k: like(v, x[k]) for k, v in t.items()} \
        if isinstance(t, dict) else jnp.asarray(x.float().numpy())  # noqa
    jparams = like(j_init_params(jcfg, jax.random.key(0)), params)
    return jcfg, jparams, cfg, params


@pytest.mark.parametrize("P,ctx,C", CHUNK_CASES)
def test_forward_chunk_matches_reference(P, ctx, C):
    """``forward_chunk`` over a prompt's chunks against the reference's,
    the same seeded weights and tokens: the K/V buffers after every chunk
    and each chunk's logits within 1e-5 in fp32 (matmuls reduce in
    another order)."""
    jcfg, jparams, cfg, params = _port_seeded_models()
    rng = np.random.default_rng(P + C)
    tokens = np.zeros((1, P), np.int32)
    tokens[0, :ctx] = rng.integers(0, cfg.vocab, ctx)
    jfc = jax.jit(lambda p, t, a, b, s: j_forward_chunk(
        jcfg, p, t, a, b, s, return_logits=True))
    jbk = jnp.zeros((cfg.n_layers, 1, P, cfg.n_kv_heads, cfg.hd))
    jbv = jnp.zeros_like(jbk)
    bk, bv = init_chunk_buffers(cfg, P, device="cpu")
    for start in _chunk_starts(P, C):
        chunk = tokens[:, start:start + C]
        jbk, jbv, jl = jfc(jparams, jnp.asarray(chunk), jbk, jbv, start)
        bk, bv, tl = forward_chunk(cfg, params, torch.from_numpy(chunk), bk,
                                   bv, start, return_logits=True)
        for got, want in ((bk, jbk), (bv, jbv), (tl, jl)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=1e-5,
                                       err_msg=f"start {start}")


@pytest.mark.parametrize("P,ctx,C", CHUNK_CASES)
def test_forward_chunk_bitwise_equals_forward(P, ctx, C):
    """The port's chunk forward over all chunks reproduces its one-shot
    ``forward(collect_cache=True)`` bit for bit: every real K/V row, and
    the final chunk's logits rows (DESIGN.md §9)."""
    _, _, cfg, params = _models()
    rng = np.random.default_rng(P)
    tokens = np.zeros((1, P), np.int32)
    tokens[0, :ctx] = rng.integers(0, cfg.vocab, ctx)
    t = torch.from_numpy(tokens)
    logits, _, (k_ref, v_ref) = forward(cfg, params, {"tokens": t},
                                        collect_cache=True)
    bk, bv = init_chunk_buffers(cfg, P, device="cpu")
    for start in _chunk_starts(P, C):
        bk, bv, lg = forward_chunk(cfg, params, t[:, start:start + C], bk,
                                   bv, start, return_logits=True)
    assert torch.equal(k_ref[:, :, :ctx], bk[:, :, :ctx])
    assert torch.equal(v_ref[:, :, :ctx], bv[:, :, :ctx])
    assert torch.equal(logits[:, P - C:], lg)


def test_forward_chunk_refuses_what_the_reference_refuses():
    """A padded length above ``CHUNKED_THRESHOLD`` and a family that is not
    ported raise, as the reference's do (the scheduler then prefills in
    one shot)."""
    import dataclasses
    _, _, cfg, params = _models()
    big = torch.zeros((cfg.n_layers, 1, 4097, cfg.n_kv_heads, cfg.hd))
    with pytest.raises(NotImplementedError, match="CHUNKED_THRESHOLD"):
        forward_chunk(cfg, params, torch.zeros((1, 8), dtype=torch.int32),
                      big, big, 0)
    with pytest.raises(NotImplementedError, match="families"):
        forward_chunk(dataclasses.replace(cfg, family="ssm"), params,
                      torch.zeros((1, 8), dtype=torch.int32), big[:, :, :8],
                      big[:, :, :8], 0)
