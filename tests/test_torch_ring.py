"""The ring KV cache of an all-window model (``REPRO_WINDOW_CACHE=1``)
against the JAX reference, on the fp32 smoke mixtral-8x22b (window 16).

With the variable set, ``init_decode_state`` keeps ``min(max_len,
window)`` slots; ``prefill`` writes the prompt at slots 0..S-1 and a
decode step writes position ``pos`` at slot ``pos % S``, reading each
slot at the absolute position it holds, masked by the window.  Both
packages read the variable at each call (the reference at each trace).

Tolerances: logits and cache rows within 1e-4 of the reference's (fp32
products reduced in another order, as ``test_torch_model.py``); the
positions exactly; the ring against the port's full-length cache within
1e-5, the control without the window more than 1e-3 away.  The
refusals (a prompt longer than the ring, the engine, the tiered
backend's append and read) raise what the reference raises, with its
messages."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduce_for_smoke as j_reduce
from repro.models import decode_step as j_decode_step
from repro.models import init_params as j_init_params
from repro.models import prefill as j_prefill
from repro.models.kv_backend import TieredBackend as JTiered
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import EngineConfig as JEngineConfig
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.models import decode_step, init_params, prefill
from repro_torch.models.kv_backend import TieredBackend
from repro_torch.serve.engine import Engine, EngineConfig
from repro_torch.weights import from_jax_params
from torch_threads import one_torch_thread  # noqa: F401

ARCH = "mixtral-8x22b"
MAX_LEN, STEPS = 32, 24
ATOL = 1e-4


@functools.lru_cache(maxsize=1)
def _models():
    jcfg = j_reduce(j_get_config(ARCH))
    jparams = j_init_params(jcfg, jax.random.key(0))
    cfg = reduce_for_smoke(get_config(ARCH))
    params = from_jax_params(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jcfg, jparams, cfg, params


def _ragged(S: int) -> np.ndarray:
    """Positions after an S-token prefill: lane 0 at S, lane 1 three
    back (its last prompt rows are overwritten by its decode), lane 2
    idle throughout."""
    return np.array([S, S - 3, -100], np.int32)


@pytest.mark.parametrize("prompt", [8, 16])
def test_ring_cache_matches_reference(prompt, monkeypatch):
    """Prefill of 8 and 16 tokens (a ring of 16 slots for ``max_len``
    32), then 24 teacher-forced decode steps with ragged positions and
    an idle lane, past the window and around the ring: logits within
    1e-4 at every step, positions equal, every cache slot within 1e-4."""
    monkeypatch.setenv("REPRO_WINDOW_CACHE", "1")
    jcfg, jparams, cfg, params = _models()
    rng = np.random.default_rng(prompt)
    toks = rng.integers(0, cfg.vocab, (3, prompt)).astype(np.int32)
    jl, js = j_prefill(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                       max_len=MAX_LEN)
    tl, ts = prefill(cfg, params, {"tokens": torch.from_numpy(toks)},
                     max_len=MAX_LEN)
    assert tuple(ts.caches["k"].shape) == np.asarray(js.caches["k"]).shape \
        == (cfg.n_layers, 3, cfg.sliding_window, cfg.n_kv_heads, cfg.hd)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=ATOL)
    pos = _ragged(prompt)
    js = js._replace(pos=jnp.asarray(pos))
    ts = ts._replace(pos=torch.from_numpy(pos.copy()))
    jstep = jax.jit(lambda p, s, t: j_decode_step(jcfg, p, s, t))
    feed = rng.integers(0, cfg.vocab, (STEPS, 3)).astype(np.int32)
    for i in range(STEPS):
        jl, js = jstep(jparams, js, jnp.asarray(feed[i]))
        tl, ts = decode_step(cfg, params, ts, torch.from_numpy(feed[i]))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=ATOL, err_msg=f"step {i}")
        np.testing.assert_array_equal(ts.pos.numpy(), np.asarray(js.pos))
        for k in ("k", "v"):
            np.testing.assert_allclose(ts.caches[k].numpy(),
                                       np.asarray(js.caches[k]), rtol=0,
                                       atol=ATOL, err_msg=f"step {i} {k}")
    assert int(ts.pos.max()) > cfg.sliding_window + prompt


def test_ring_prompt_longer_than_the_ring_raises(monkeypatch):
    """A 24-token prompt into a ring of 16 slots: ``ValueError`` in both
    packages."""
    monkeypatch.setenv("REPRO_WINDOW_CACHE", "1")
    jcfg, jparams, cfg, params = _models()
    toks = np.zeros((1, 24), np.int32)
    with pytest.raises(ValueError):
        j_prefill(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                  max_len=MAX_LEN)
    with pytest.raises(ValueError):
        prefill(cfg, params, {"tokens": torch.from_numpy(toks)},
                max_len=MAX_LEN)


def _refusal(fn) -> str:
    with pytest.raises(NotImplementedError) as e:
        fn()
    return str(e.value)


def test_ring_refusals_match_reference(monkeypatch):
    """The engine refuses a ring cache (its prefill writes prompt rows
    linearly) and the tiered backend's append and read refuse ``ring``,
    each with the reference's message."""
    monkeypatch.setenv("REPRO_WINDOW_CACHE", "1")
    jcfg, jparams, cfg, params = _models()
    want = _refusal(lambda: JEngine(jcfg, jparams, JEngineConfig(
        batch=2, max_len=MAX_LEN)))
    got = _refusal(lambda: Engine(cfg, params, EngineConfig(
        batch=2, max_len=MAX_LEN), device="cpu"))
    assert got == want and "REPRO_WINDOW_CACHE" in got
    plain = dataclasses.replace(cfg, sliding_window=0)
    jplain = dataclasses.replace(jcfg, sliding_window=0)
    tb = TieredBackend(plain, 2, MAX_LEN, page_tokens=8, device="cpu")
    jb = JTiered(jplain, 2, MAX_LEN, page_tokens=8)
    for name in ("append", "attend"):
        args = (None,) * (4 if name == "append" else 3)
        assert _refusal(lambda: getattr(tb, name)(*args, ring=True)) == \
            _refusal(lambda: getattr(jb, name)(*args, ring=True))


def _port_run(cfg, params, toks, feed, max_len):
    """Prefill then teacher-forced decode steps of the port: the logits
    of every step [steps, B, V] and the final positions."""
    _, st = prefill(cfg, params, {"tokens": torch.from_numpy(toks)},
                    max_len=max_len)
    st = st._replace(pos=torch.from_numpy(_ragged(toks.shape[1])))
    out = []
    for t in feed:
        lg, st = decode_step(cfg, params, st, torch.from_numpy(t))
        out.append(lg)
    return torch.stack(out), st


def test_ring_equals_full_cache(monkeypatch):
    """The port's ring (16 slots) against its full-length cache (64
    positions) over 40 decode steps from a 10-token prompt: the live
    lanes' logits within 1e-5 at every step; a control without the
    window differs by more than 1e-3, so the window took effect."""
    _, _, cfg, params = _models()
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab, (3, 10)).astype(np.int32)
    feed = rng.integers(0, cfg.vocab, (40, 3)).astype(np.int32)
    monkeypatch.setenv("REPRO_WINDOW_CACHE", "1")
    ring, st = _port_run(cfg, params, toks, feed, 64)
    assert st.caches["k"].shape[2] == cfg.sliding_window
    monkeypatch.setenv("REPRO_WINDOW_CACHE", "0")
    full, st = _port_run(cfg, params, toks, feed, 64)
    assert st.caches["k"].shape[2] == 64
    live = slice(0, 2)     # lane 2 is idle: its output averages every slot
    np.testing.assert_allclose(ring[:, live].numpy(), full[:, live].numpy(),
                               rtol=0, atol=1e-5)
    control, _ = _port_run(dataclasses.replace(cfg, sliding_window=0),
                           params, toks, feed, 64)
    assert (control[:, live] - full[:, live]).abs().max() > 1e-3
