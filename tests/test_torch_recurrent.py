"""The hybrid (hymba-1.5b) and ssm (xlstm-125m) decoder families against
the JAX reference on their fp32 smoke configs, through every model entry
point the reference gives them: ``init_params`` (leaf layout and dtypes),
``layer_flags``, ``forward``, ``prefill``, ``init_decode_state`` and
``decode_step`` over ``DenseBackend``; then the refusals the reference
makes (the engine, the chunked forward, the tiered store, the launcher)
and the device defaults of two state constructors.

Both packages get the same weights: the port's seeded ``init_params``
with the projections rescaled to their contracted fan-in
(``weights.unit_fan_in``: at the reference's scale the attention and the
mLSTM are nearly one-hot and fp32 reassociation exceeds the
tolerances), in the reference's layout and dtypes, and back through
``from_jax_params``.  hymba's smoke config has 4 layers (global on 0 and
2), a 16-token window and state 8; xlstm's 4 layers (sLSTM on 3).
Tolerances: logits within 1e-4 (fp32 reductions in another order, the
Mamba scan's products in another association; |logits| < ~1), every
decode-state leaf within 1e-5 of its scale (``test_decode_matches_
reference``), the cold prefill states exactly equal."""

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
from repro.models import decode_step as j_decode_step
from repro.models import prefill as j_prefill
from repro.models.kv_backend import DenseBackend as JDense
from repro.models.kv_backend import TieredBackend as JTiered
from repro.models.transformer import abstract_params_and_axes
from repro.models.transformer import layer_flags as j_layer_flags
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import EngineConfig as JEngineConfig
from repro_torch.configs import ALL_ARCHS, get_config, reduce_for_smoke
from repro_torch.launch import serve
from repro_torch.models import (decode_step, forward, forward_chunk,
                                init_chunk_buffers, init_decode_state,
                                init_params, layer_flags, prefill)
from repro_torch.models.kv_backend import DenseBackend, TieredBackend
from repro_torch.serve.engine import Engine, EngineConfig
from repro_torch.tiered import kvcache as tk
from repro_torch.weights import (_expected_leaves, from_jax_params,
                                 unit_fan_in)
from torch_threads import one_torch_thread  # noqa: F401

ARCHS = ("hymba-1.5b", "xlstm-125m")
ATOL, STATE_ATOL = 1e-4, 1e-5
B, MAX_LEN, STEPS = 3, 32, 8


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    return jnp.asarray(tree)


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


@functools.lru_cache(maxsize=None)
def _models(arch):
    jcfg, cfg = j_reduce(j_get_config(arch)), reduce_for_smoke(
        get_config(arch))
    tree = unit_fan_in(jax.tree.map(lambda t: t.numpy(),
                                    init_params(cfg, "cpu", seed=3)), cfg)
    return jcfg, _to_jax(tree), cfg, from_jax_params(tree, cfg, "cpu")


def _tokens(rng, cfg, *shape):
    return rng.integers(0, cfg.vocab, shape).astype(np.int32)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_layer_flags_match_reference(arch):
    np.testing.assert_array_equal(layer_flags(get_config(arch)),
                                  j_layer_flags(j_get_config(arch)))


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_expected_leaves_match_reference_init(arch):
    """Every registered config at its published size, in bf16: the leaves
    ``from_jax_params`` expects (path, shape, dtype) are those of the
    reference's ``init_params`` (shapes only, nothing materialised); the
    fp32 leaves stay fp32."""
    cfg = get_config(arch)
    want = {k: (tuple(v.shape), str(v.dtype)) for k, v in _leaves(
        abstract_params_and_axes(j_get_config(arch))[0]).items()}
    got = {k: (s, str(dt).removeprefix("torch.")) for k, (s, dt)
           in _expected_leaves(cfg).items()}
    assert got == want


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_layout_and_dtypes(arch):
    """The port's own parameters in bf16 carry exactly the expected
    leaves, fp32 where the reference keeps fp32."""
    cfg = dataclasses.replace(reduce_for_smoke(get_config(arch)),
                              dtype="bfloat16")
    got = {k: (tuple(v.shape), v.dtype)
           for k, v in _leaves(init_params(cfg, "cpu", seed=1)).items()}
    assert got == _expected_leaves(cfg)
    assert any(dt == torch.float32 for _, dt in got.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    """Two lanes of 40 tokens (past hymba's 16-token window): logits
    within 1e-4; hymba's collected K/V too, xlstm collects none."""
    jcfg, jparams, cfg, params = _models(arch)
    toks = _tokens(np.random.default_rng(1), cfg, 2, 40)
    jl, jaux, jc = jax.jit(lambda p, t: j_forward(
        jcfg, p, {"tokens": t}, collect_cache=True))(jparams,
                                                      jnp.asarray(toks))
    tl, aux, c = forward(cfg, params, {"tokens": torch.from_numpy(toks)},
                         collect_cache=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=ATOL)
    assert float(aux) == float(jaux) == 0.0
    assert len(c) == len(jc)
    for t, j in zip(c, jc):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=ATOL)


@pytest.mark.parametrize("arch", ARCHS + ("llama3-8b", "mixtral-8x22b"))
def test_prefill_matches_reference(arch):
    """Logits within 1e-4 and the decode state: for the recurrent
    families the reference's cold state (zeros, pos 0) exactly, for the
    plain-KV families the prompt's K/V padded to max_len within 1e-4 and
    pos = S."""
    jcfg, jparams, cfg, params = _models(arch)
    toks = _tokens(np.random.default_rng(2), cfg, 2, 24)
    jl, js = j_prefill(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                       max_len=MAX_LEN)
    tl, ts = prefill(cfg, params, {"tokens": torch.from_numpy(toks)},
                     max_len=MAX_LEN)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(ts.pos.numpy(), np.asarray(js.pos))
    want, got = _leaves(js.caches), _leaves(ts.caches)
    assert sorted(got) == sorted(want)
    cold = cfg.family in ("hybrid", "ssm")
    for k, w in want.items():
        w = np.asarray(w)
        assert tuple(got[k].shape) == w.shape, k
        assert str(got[k].dtype).removeprefix("torch.") == str(w.dtype), k
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                   atol=0 if cold else ATOL, err_msg=k)
    if cold:
        assert not ts.pos.any() and all(not v.any() for v in got.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference(arch):
    """8 teacher-forced decode steps over the dense backend from the cold
    state, lanes ragged (lane 0 at 0, lane 1 at 20 over random cached K/V
    rows 0-19, so hymba's window of 16 bites on its windowed layers) and
    lane 2 parked: live logits within 1e-4 at every step, every state
    leaf (recurrent states of all three lanes, KV caches) within 1e-5
    after every step, times the leaf's largest magnitude where that
    exceeds 1: the mLSTM's stabilised memory grows to ~12 in 8 steps from
    the cold state, and the two packages' fp32 products, compounded over
    the layers, part it by ~1e-6 of its size."""
    jcfg, jparams, cfg, params = _models(arch)
    js = JDense(jcfg).init_state(B, MAX_LEN)
    ts = DenseBackend(cfg, "cpu").init_state(B, MAX_LEN)
    rng = np.random.default_rng(5)
    if "k" in ts.caches:
        for name in ("k", "v"):
            rows = rng.normal(size=ts.caches[name][:, 1, :20].shape) \
                .astype(np.float32)
            ts.caches[name][:, 1, :20] = torch.from_numpy(rows)
            js = js._replace(caches={**js.caches, name: js.caches[name]
                                     .at[:, 1, :20].set(rows)})
    pos = np.array([0, 20, -1], np.int32)
    js = js._replace(pos=jnp.asarray(pos))
    ts = ts._replace(pos=torch.from_numpy(pos))
    jstep = jax.jit(lambda p, s, t: j_decode_step(jcfg, p, s, t,
                                                  backend=JDense(jcfg)))
    for i in range(STEPS):
        tok = _tokens(rng, cfg, B)
        jl, js = jstep(jparams, js, jnp.asarray(tok))
        tl, ts = decode_step(cfg, params, ts, torch.from_numpy(tok),
                             backend=DenseBackend(cfg, "cpu"))
        np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2],
                                   rtol=0, atol=ATOL, err_msg=f"step {i}")
        want = _leaves(js.caches)
        for k, t in _leaves(ts.caches).items():
            w = np.asarray(want[k])
            np.testing.assert_allclose(
                t.numpy(), w, rtol=0,
                atol=STATE_ATOL * max(1.0, float(np.abs(w).max())),
                err_msg=f"{k}, step {i}")
        js = js._replace(pos=js.pos.at[2].set(-1))
        ts = ts._replace(pos=torch.where(torch.arange(B) == 2, -1, ts.pos))
    np.testing.assert_array_equal(np.asarray(js.pos), ts.pos.numpy())


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


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind", ["engine", "forward_chunk", "tiered",
                                  "serve"])
def test_refusals_match_reference(monkeypatch, kind, arch):
    """The engine, the chunked-prefill forward, the tiered store and the
    launcher refuse the recurrent families with the reference's exception
    and message (the launcher exits with ``name: message``)."""
    port, ref = _refusal(kind, arch)
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", arch, "--smoke"])
    exc = SystemExit if kind == "serve" else NotImplementedError
    with pytest.raises(exc) as want:
        ref()
    with pytest.raises(exc) as got:
        port()
    assert str(got.value) == str(want.value)
    if kind == "serve":
        assert str(got.value).startswith(f"{arch}-smoke: Engine prefill")


@pytest.mark.parametrize("arch", ARCHS)
def test_fused_tiered_decode_refuses_recurrent_families(arch):
    """decode_step's fused branch (a backend with ``begin_step``) takes
    only the plain-KV families."""
    _, _, cfg, params = _models(arch)
    llama = reduce_for_smoke(get_config("llama3-8b"))
    be = TieredBackend(llama, 2, 64, device="cpu")
    st = init_decode_state(cfg, 2, 64, "cpu")
    with pytest.raises(NotImplementedError, match="plain-KV"):
        decode_step(cfg, params, st, torch.zeros(2, dtype=torch.int32),
                    backend=be)


@pytest.mark.parametrize("call", ["init_decode_state", "kvcache.init_state"])
def test_state_defaults_target_the_card(call):
    """With no device, both constructors ask for the card, and raise
    without one, as ``resolve_device`` does."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = reduce_for_smoke(get_config("hymba-1.5b"))
    tcfg = TieredBackend(reduce_for_smoke(get_config("llama3-8b")), 2, 64,
                         device="cpu").tcfg
    fn = {"init_decode_state": lambda: init_decode_state(cfg, 2, 16),
          "kvcache.init_state": lambda: tk.init_state(tcfg)}[call]
    with pytest.raises(RuntimeError, match="cuda"):
        fn()
