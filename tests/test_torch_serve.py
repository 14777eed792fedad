"""PyTorch port vs the JAX reference: the single-store serving path
(``TieredServer`` over its three data paths, ``serve.tiered`` attend /
attend_concat / maintain, ``TieredBackend.append`` / ``.attend`` on one
layer).  Outputs agree within 1e-5 on live lanes (fp32; the two softmax
implementations sum in other orders), every state field and counter is
exactly equal, and the port's zero-copy read equals its concat read bit
for bit (the reference's golden equality)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduce_for_smoke as j_reduce
from repro.core.policy import get_policy as j_get_policy
from repro.models.kv_backend import TieredBackend as JTiered
from repro.serve import tiered as jsrv
from repro.serve.engine import TieredServer as JServer
from repro.tiered import kvcache as jk
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core.policy import get_policy
from repro_torch.models.kv_backend import TieredBackend
from repro_torch.serve import tiered as srv
from repro_torch.serve.decode import make_tiered_decode_step
from repro_torch.serve.engine import TieredServer
from repro_torch.tiered import kvcache as tk
from torch_threads import one_torch_thread  # noqa: F401

ATOL = 1e-5
# the reference's server geometry (tests/test_engine.py::_tiered_cfg)
GEOM = dict(n_seqs=2, max_pages_per_seq=64, page_tokens=16, n_kv_heads=2,
            head_dim=32, fast_data_slots=4, migrate_threshold=2,
            dtype="float32")


def _jit(fn, **kw):
    return jax.jit(fn, static_argnums=(0,), **kw)


J_APPEND = _jit(jk.append_token)
J_ATTEND = _jit(jsrv.attend)
J_CONCAT = _jit(jsrv.attend_concat)
J_MAINTAIN = _jit(jsrv.maintain, static_argnames=("max_moves",))


def _pools(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


def _seed_pools(js, ts, seed):
    """Both stores' slow pools from the same numpy draw."""
    sk, sv = _pools(tuple(ts.slow_k.shape), seed)
    ts.slow_k.copy_(torch.from_numpy(sk))
    ts.slow_v.copy_(torch.from_numpy(sv))
    return js._replace(slow_k=jnp.asarray(sk), slow_v=jnp.asarray(sv))


def _assert_state_equal(js, ts, where=""):
    for f in jk.TieredState._fields:
        a, b = np.asarray(getattr(js, f)), getattr(ts, f).numpy()
        if a.dtype.kind == "f":
            np.testing.assert_array_equal(a, b, f"{where} {f}")
        else:
            np.testing.assert_array_equal(a.astype(np.int64),
                                          b.astype(np.int64), f"{where} {f}")


def _close(jout, tout, live, where=""):
    np.testing.assert_allclose(tout.numpy()[live], np.asarray(jout)[live],
                               rtol=0, atol=ATOL, err_msg=where)


@pytest.mark.parametrize("path", ["zero_copy", "concat", "fused"])
def test_server_decode_loop_matches_reference(path):
    """The reference's ``test_tiered_server_decode_loop`` sequence on both
    servers: steps at a shared position, maintenance every fourth step, a
    lane release, then a step at ragged positions with the released lane
    idle.  Outputs within 1e-5 on live lanes; state and counters exact."""
    cfg_kw = dict(GEOM, cache_device_table=path != "concat")
    jcfg, tcfg = jk.TieredConfig(**cfg_kw), tk.TieredConfig(**cfg_kw)
    js, ts = JServer(jcfg, path=path), TieredServer(tcfg, path=path,
                                                     device="cpu")
    js.state = _seed_pools(js.state, ts.state, 3)
    rng = np.random.default_rng(4)
    q = rng.normal(size=(2, 2, 4, 32)).astype(np.float32)
    kv = rng.normal(size=(2, 2, 32)).astype(np.float32)
    tq, tkv = torch.from_numpy(q), torch.from_numpy(kv)
    live = np.ones(2, bool)
    for pos in range(100, 113):
        jo = js.step(jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv), pos)
        to = ts.step(tq, tkv, tkv, pos)
        _close(jo, to, live, f"pos {pos}")
        if pos % 4 == 0:
            js.maintain()
            ts.maintain()
        _assert_state_equal(js.state, ts.state, f"pos {pos}")
    assert ts.counters == js.counters
    assert ts.metrics == pytest.approx(js.metrics)
    js.release(0)
    ts.release(0)
    assert (ts.state.leaf_table[:64] == tk.INVALID).all()
    pos = np.array([-1, 113], np.int32)
    jo = js.step(jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv),
                 jnp.asarray(pos))
    to = ts.step(tq, tkv, tkv, torch.from_numpy(pos))
    _close(jo, to, pos >= 0, "after release")
    _assert_state_equal(js.state, ts.state, "after release")
    c = ts.counters
    if path == "concat":
        assert c["lookups"] == 14 * tcfg.n_logical
    else:
        assert c["dev_hits"] > 0
        assert c["lookups"] < ts.steps * tcfg.n_logical / 4


@pytest.mark.parametrize("preset", ["threshold", "recency"])
def test_attend_invariant_under_serving_matches_reference(preset):
    """The reference's ``test_tiered_attend_invariant_under_serving``
    sequence: appends crossing a page boundary, the zero-copy read on a
    cached store and the concat read on an uncached one, maintenance
    between steps.  The port's two reads are equal bit for bit, each is
    within 1e-5 of the reference's, and both stores match exactly."""
    kw = dict(GEOM, migrate_threshold=None)
    jcfg = jk.TieredConfig(policy=j_get_policy(preset, epoch_len=2), **kw)
    tcfg = tk.TieredConfig(policy=get_policy(preset, epoch_len=2), **kw)
    jcfg_l = dataclasses.replace(jcfg, cache_device_table=False)
    tcfg_l = dataclasses.replace(tcfg, cache_device_table=False)
    ts, ts_l = tk.init_state(tcfg, "cpu"), tk.init_state(tcfg_l, "cpu")
    js = _seed_pools(jk.init_state(jcfg), ts, 0)
    js_l = _seed_pools(jk.init_state(jcfg_l), ts_l, 0)
    rng = np.random.default_rng(2)
    q = rng.normal(size=(2, 2, 4, 32)).astype(np.float32)
    seqs = np.arange(2, dtype=np.int32)
    pos = 126
    for step in range(8):
        k1 = rng.normal(size=(2, 2, 32)).astype(np.float32)
        v1 = rng.normal(size=(2, 2, 32)).astype(np.float32)
        js = J_APPEND(jcfg, js, jnp.asarray(seqs), jnp.asarray(k1),
                      jnp.asarray(v1), pos)
        js_l = J_APPEND(jcfg_l, js_l, jnp.asarray(seqs), jnp.asarray(k1),
                        jnp.asarray(v1), pos)
        tkv = (torch.from_numpy(seqs), torch.from_numpy(k1),
               torch.from_numpy(v1), pos)
        ts = tk.append_token(tcfg, ts, *tkv)
        ts_l = tk.append_token(tcfg_l, ts_l, *tkv)
        pos += 1
        sl = np.full((2,), pos, np.int32)
        jo, js = J_ATTEND(jcfg, js, jnp.asarray(q), jnp.asarray(sl))
        jr, js_l = J_CONCAT(jcfg_l, js_l, jnp.asarray(q), jnp.asarray(sl))
        to, ts = srv.attend(tcfg, ts, torch.from_numpy(q),
                            torch.from_numpy(sl))
        tr, ts_l = srv.attend_concat(tcfg_l, ts_l, torch.from_numpy(q),
                                     torch.from_numpy(sl))
        assert torch.equal(to, tr), f"step {step}: zero-copy != concat"
        live = np.ones(2, bool)
        _close(jo, to, live, f"step {step} zero-copy")
        _close(jr, tr, live, f"step {step} concat")
        js = J_MAINTAIN(jcfg, js, max_moves=3)
        js_l = J_MAINTAIN(jcfg_l, js_l, max_moves=3)
        ts = srv.maintain(tcfg, ts, max_moves=3)
        ts_l = srv.maintain(tcfg_l, ts_l, max_moves=3)
        _assert_state_equal(js, ts, f"step {step}")
        _assert_state_equal(js_l, ts_l, f"step {step} legacy")
    assert int(ts.migrations) + int(ts.demotions) > 0


def test_server_paths_agree_bitwise():
    """Torch against torch: the zero-copy and concat servers give the same
    output bit for bit on live lanes, through maintenance, a release and
    ragged positions with an idle lane; the fused server agrees within
    1e-5 (on the CPU its plain version walks pages with an online softmax;
    on a card the three share one kernel body and agree bit for bit,
    ``tests/test_torch_cuda.py``)."""
    servers = {}
    for path in ("zero_copy", "concat", "fused"):
        cfg = tk.TieredConfig(**dict(GEOM,
                                     cache_device_table=path != "concat"))
        s = TieredServer(cfg, path=path, device="cpu")
        sk, sv = _pools(tuple(s.state.slow_k.shape), 7)
        s.state.slow_k.copy_(torch.from_numpy(sk))
        s.state.slow_v.copy_(torch.from_numpy(sv))
        servers[path] = s
    rng = np.random.default_rng(8)
    pos = np.array([70, -1], np.int32)
    for step in range(10):
        q = torch.from_numpy(rng.normal(size=(2, 2, 4, 32))
                             .astype(np.float32))
        kv = torch.from_numpy(rng.normal(size=(2, 2, 32)).astype(np.float32))
        outs = {k: s.step(q, kv, kv, torch.from_numpy(pos))
                for k, s in servers.items()}
        live = torch.from_numpy(pos >= 0)
        assert torch.equal(outs["zero_copy"][live], outs["concat"][live])
        torch.testing.assert_close(outs["fused"][:, 0][live],
                                   outs["zero_copy"][live], rtol=0,
                                   atol=ATOL)
        pos = np.where(pos >= 0, pos + 1, pos)
        if step == 4:
            for s in servers.values():
                s.maintain()
                s.release(0)
            pos = np.array([0, 12], np.int32)
    assert servers["zero_copy"].counters["migrations"] > 0


def _backends():
    jcfg = j_reduce(j_get_config("llama3-8b"))
    cfg = reduce_for_smoke(get_config("llama3-8b"))
    jb = JTiered(jcfg, 2, 64, page_tokens=8, fast_data_slots=4,
                 policy=j_get_policy("threshold", epoch_len=2))
    tb = TieredBackend(cfg, 2, 64, page_tokens=8, fast_data_slots=4,
                       policy=get_policy("threshold", epoch_len=2),
                       device="cpu")
    return jb, tb


def test_backend_append_attend_one_layer_matches_reference():
    """``TieredBackend.append`` / ``.attend`` on ONE layer's unstacked
    store, as the reference's layer scan slices it: outputs within 1e-5
    on live lanes, the store exact."""
    jb, tb = _backends()
    cfg = tb.tcfg
    ts = tk.init_state(cfg, "cpu")
    js = _seed_pools(jk.init_state(jb.tcfg), ts, 9)
    j_append, j_attend = jax.jit(jb.append), jax.jit(jb.attend)
    rng = np.random.default_rng(10)
    G = 4
    pos = np.array([20, -1], np.int32)
    for step in range(6):
        k = rng.normal(size=(2, cfg.n_kv_heads, cfg.head_dim)) \
            .astype(np.float32)
        q = rng.normal(size=(2, cfg.n_kv_heads, G, cfg.head_dim)) \
            .astype(np.float32)
        js = j_append(js, jnp.asarray(k), jnp.asarray(k), jnp.asarray(pos))
        ts = tb.append(ts, torch.from_numpy(k), torch.from_numpy(k),
                       torch.from_numpy(pos))
        jo, js = j_attend(js, jnp.asarray(q), jnp.asarray(pos))
        to, ts = tb.attend(ts, torch.from_numpy(q), torch.from_numpy(pos))
        _close(jo, to, pos >= 0, f"step {step}")
        _assert_state_equal(js, ts, f"step {step}")
        pos = np.where(pos >= 0, pos + 1, 3)


def test_backend_attend_raises_for_window_and_ring():
    _, tb = _backends()
    st = tk.init_state(tb.tcfg, "cpu")
    q = torch.zeros(2, tb.tcfg.n_kv_heads, 4, tb.tcfg.head_dim)
    kv = torch.zeros(2, tb.tcfg.n_kv_heads, tb.tcfg.head_dim)
    pos = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(NotImplementedError):
        tb.attend(st, q, pos, window=8)
    with pytest.raises(NotImplementedError):
        tb.attend(st, q, pos, window=torch.tensor(0))
    with pytest.raises(NotImplementedError):
        tb.attend(st, q, pos, ring=True)
    with pytest.raises(NotImplementedError):
        tb.append(st, kv, kv, pos, ring=True)


def test_decode_step_rejects_bucket_off_the_fused_path():
    cfg = tk.TieredConfig(**GEOM)
    for path in ("zero_copy", "concat"):
        with pytest.raises(ValueError):
            make_tiered_decode_step(cfg, path=path, n_pages=4)
    with pytest.raises(ValueError):
        make_tiered_decode_step(cfg, path="unified")
    make_tiered_decode_step(cfg, path="fused", n_pages=4)
