"""The MoE family (granite-moe-3b, mixtral-8x22b with its sliding window)
against the JAX reference, on the fp32 smoke configs widened back to
their real GQA group sizes, G = 3 and 6, as ``test_torch_families.py``
holds the qwen configs (its checks, inputs and tolerances: logits within
1e-4, chunk K/V and logits within 1e-5, the aux loss within 1e-6); then
mixtral's window above ``CHUNKED_THRESHOLD``, and the port's own
contracts, torch against torch, on the granite config: dense == tiered,
bucket == full width, chunked == one-shot (no token dropped), and the
refusals the reference makes."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import forward as j_forward
from repro.models.kv_backend import TieredBackend as JTiered
from repro_torch.core.policy import get_policy
from repro_torch.models import (decode_step, forward, forward_chunk,
                                init_chunk_buffers, init_params, moe)
from repro_torch.models.kv_backend import DenseBackend, TieredBackend
from repro_torch.serve.engine import Engine, EngineConfig
from test_torch_families import (ATOL, B, MAX_LEN, MOE, PAGE, PREFILLS,
                                 _models, _tokens, check_decode,
                                 check_forward, check_forward_chunk,
                                 decode_cases)
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("arch", MOE)
def test_forward_matches_reference(arch):
    check_forward(arch)


@pytest.mark.parametrize("arch,backend", decode_cases(MOE))
def test_decode_matches_reference(arch, backend):
    """``test_torch_families.check_decode``."""
    check_decode(arch, backend)


@pytest.mark.parametrize("arch", MOE)
def test_forward_chunk_matches_reference(arch):
    """``test_torch_families.check_forward_chunk``."""
    check_forward_chunk(arch)


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
