"""The compiled serving steps on the CPU: what the port captures as CUDA
graphs on a card (``serve.decode.StepGraphs``) must not read the host,
and the functions and books around the graphs.

* A guard (``NoHostReads``, a ``TorchDispatchMode``) fails on every op
  that reads a value back to the host or sizes its output by the data
  (``_local_scalar_dense``, ``item``, ``is_nonzero``, ``nonzero``,
  ``masked_select``, ``unique*``), over each function the engine and the
  server capture, exactly as they capture it: the tiered fused decode
  step, the dense one and the MoE one (each with its argmax), the
  maintenance plan, its apply and the synchronous pass with the engine's
  copy flag, the one-shot prefill (tiered and dense), the chunk forward
  and the chunk write (tiered and dense), the admission and the release,
  plain and flight-recorded, the recorded apply, the multi-tenant pass,
  and the server's three step paths, its pass and its release.  The
  lane, length, chunk start and flight step go in as the engine's 0-d
  tensors, so an ``int()`` of one shows as ``_local_scalar_dense``.
* The tiered store's and the backends' lane-lifecycle functions with
  those arguments as 0-d tensors (and the multi-tenant pass's lane map
  as a tensor) equal their Python-int calls bit for bit, at two lanes.
* ``make_decode_fn`` and ``make_prefill_fn`` against the reference's on
  the fp32 smoke configs (llama3-8b; hubert-xlarge for the encoder
  branch), logits within 1e-4 (fp32 on both sides, reduced in other
  orders).
* The copy engine's deferred flag: a captured pass does not read it, the
  engine does after the pass and raises ``IndexError``.
* ``run`` resets the engine's kept buffers in place to a fresh
  ``init_state``, bit for bit, and a second run repeats the first.
* The runner's refusals: graphs on the CPU, a pool handed back as a new
  tensor.

Captured against eager on the card: ``tests/test_torch_cuda.py`` and
``chip_smoke.py``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as j_get_config
from repro.configs import reduce_for_smoke as j_reduce
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.models import init_params as j_init_params
from repro.serve import decode as j_decode
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels.remap_gather import ops as rg_ops
from repro_torch.models import init_params
from repro_torch.serve import decode as t_decode
from repro_torch.serve.engine import (Engine, EngineConfig, Request,
                                      TieredServer)
from repro_torch.serve.sched import TenantConfig
from repro_torch.tiered import kvcache as tk
from repro_torch.weights import from_jax_params
from torch_threads import one_torch_thread  # noqa: F401

ATOL = 1e-4
EC = dict(batch=2, max_len=48, backend="tiered", page_tokens=8,
          fast_data_slots=4, maintain_every=2)
HOST_READS = ("_local_scalar_dense", "item", "is_nonzero", "nonzero",
              "masked_select")


class NoHostReads(TorchDispatchMode):
    """Records every op whose result goes to the host or whose output
    shape depends on the data; counts the ops it saw."""

    def __init__(self):
        super().__init__()
        self.ops, self.found = 0, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        name = func.overloadpacket.__name__
        if name in HOST_READS or name.lstrip("_").startswith("unique"):
            self.found.append(name)
        return func(*args, **(kwargs or {}))


def _guarded(fn, *args):
    with NoHostReads() as mode:
        out = fn(*args)
    return out, mode


@functools.lru_cache(maxsize=None)
def _params(arch):
    cfg = reduce_for_smoke(get_config(arch))
    return cfg, init_params(cfg, "cpu", seed=3)


def _served_engine(arch="llama3-8b", **over):
    """An engine mid-run: two lanes prefilled and decoded for a few steps
    with maintenance, so the plan has pages to move."""
    cfg, params = _params(arch)
    eng = Engine(cfg, params, EngineConfig(**{**EC, **over}), device="cpu")
    state, tokens = eng._reset_state()
    rng = np.random.default_rng(1)
    for lane, n in enumerate((19, 30)):
        state, tok = eng.prefill_lane(
            state, lane, Request(rid=lane, prompt=rng.integers(
                0, cfg.vocab, n), max_new=8))
        tokens[lane] = tok
    with torch.inference_mode():
        for i in range(4):
            _, tokens, state = eng._decode(state, tokens, None)
            if eng._tiered and i % 2:
                state = eng._maintain(state)
    return eng, state, tokens


def _server(path):
    tcfg = tk.TieredConfig(n_seqs=4, max_pages_per_seq=8, page_tokens=8,
                           n_kv_heads=2, head_dim=16, fast_data_slots=4,
                           dtype="float32")
    srv = TieredServer(tcfg, path=path, device="cpu")
    g = torch.Generator().manual_seed(0)
    for pool in (srv.state.slow_k, srv.state.slow_v):
        pool.copy_(torch.randn(pool.shape, generator=g))
    q = torch.randn((4, 2, 2, 16), generator=g)
    kv = torch.randn((4, 2, 16), generator=g)
    pos = torch.tensor([20, 9, 33, -1], dtype=torch.int32)
    for _ in range(3):                     # pages touched: the pass moves
        srv.step(q, kv, kv, pos)
        pos = torch.where(pos >= 0, pos + 1, pos)
    return srv, (q, kv, kv, pos)


def _engine_path(arch, backend, what):
    eng, state, tokens = _served_engine(arch, backend=backend)
    n_pages = 4 if eng._tiered else None       # a live-page bucket
    fns = {"decode": lambda: eng._decode_step(state, tokens, n_pages),
           "plan": lambda: eng._plan_fn(state),
           "apply": lambda: eng._apply_fn(state, eng._plan_fn(state)[0]),
           "pass": lambda: eng._pass_fn(state)}
    return fns[what]


def _server_path(path, what):
    srv, args = _server(path)
    if what == "maintain":
        return lambda: srv._pass(srv.state)
    if what == "release":
        return lambda: srv._release_fn(srv.state, srv._lane.fill_(1))
    pos = srv._pos.copy_(args[3])
    return lambda: srv._step(srv.state, *args[:3], pos)


def _lifecycle_path(what, backend="tiered", **over):
    """A prompt, chunk, admission or release step of an engine mid-run
    (``_served_engine``), as the engine captures it: lane 1, length 29,
    chunk start 8 and flight step 5 in the engine's own 0-d tensors, a
    32-token prompt, 8-token chunks."""
    from repro_torch.obs import FlightConfig
    if what.endswith("_rec"):
        over["flight"] = FlightConfig(capacity=64)
    if what == "tenants":
        over.update(scheduler="chunked", prefill_chunk=8, tenants=(
            TenantConfig("a", weight=2, policy="on_demand"),
            TenantConfig("b")))
    eng, state, _ = _served_engine(backend=backend, **over)
    lane, length, start, step = (
        eng._scalar(b, v) for b, v in ((eng._lane_s, 1), (eng._len_s, 29),
                                       (eng._start_s, 8), (eng._step_s, 5)))
    toks = eng._stage(np.arange(32, dtype=np.int32))
    bk, bv = eng.chunk_buffers(32)
    rk, rv = (t[:, 0, :8].clone() for t in (bk, bv))
    if what == "tenants":
        eng._pass_tenant.copy_(torch.tensor([0, 1], dtype=torch.int32))
    fns = {
        "prefill": lambda: eng._prefill_fn(state, toks, lane, length),
        "chunk": lambda: eng._chunk_fn(state, toks[:, 8:16], bk, bv, rk, rv,
                                       start=8, logits=True),
        "write_chunk": lambda: eng._write_chunk_fn(state, rk, rv, lane,
                                                   start, length),
        "admit": lambda: eng._admit_fn(state, lane, length, n_pages=2),
        "admit_rec": lambda: eng._rec_admit_fn(state, lane, length, step,
                                               n_pages=2),
        "release": lambda: eng._release_fn(state, lane),
        "release_rec": lambda: eng._rec_release_fn(state, lane, step),
        "apply_rec": lambda: eng._rec_apply_fn(
            state, eng._plan_fn(state)[0], step),
        "tenants": lambda: eng._maintain_tenants(state, eng._pass_tenant)}
    return fns[what]


GUARDED = {
    "tiered_decode": lambda: _engine_path("llama3-8b", "tiered", "decode"),
    "dense_decode": lambda: _engine_path("llama3-8b", "dense", "decode"),
    "moe_decode": lambda: _engine_path("granite-moe-3b-a800m", "tiered",
                                       "decode"),
    "plan": lambda: _engine_path("llama3-8b", "tiered", "plan"),
    "apply_with_flag": lambda: _engine_path("llama3-8b", "tiered", "apply"),
    "sync_pass_with_flag": lambda: _engine_path("llama3-8b", "tiered",
                                                "pass"),
    "server_zero_copy": lambda: _server_path("zero_copy", "step"),
    "server_fused": lambda: _server_path("fused", "step"),
    "server_concat": lambda: _server_path("concat", "step"),
    "server_maintain": lambda: _server_path("zero_copy", "maintain"),
    "server_release": lambda: _server_path("zero_copy", "release"),
    "prefill": lambda: _lifecycle_path("prefill"),
    "dense_prefill": lambda: _lifecycle_path("prefill", "dense"),
    "chunk_forward": lambda: _lifecycle_path("chunk"),
    "chunk_write": lambda: _lifecycle_path("write_chunk"),
    "dense_chunk_write": lambda: _lifecycle_path("write_chunk", "dense"),
    "admit": lambda: _lifecycle_path("admit"),
    "admit_recorded": lambda: _lifecycle_path("admit_rec"),
    "release": lambda: _lifecycle_path("release"),
    "release_recorded": lambda: _lifecycle_path("release_rec"),
    "apply_recorded": lambda: _lifecycle_path("apply_rec"),
    "tenant_pass": lambda: _lifecycle_path("tenants"),
}


# the dense chunk write is two indexed stores and their index
MIN_OPS = {"dense_chunk_write": 5}


@pytest.mark.parametrize("path", sorted(GUARDED))
def test_captured_path_reads_nothing_on_the_host(path):
    """Each captured function, as captured, runs no host read and no
    data-sized op (the plain kernel versions stand in for the card's)."""
    fn = GUARDED[path]()
    with torch.inference_mode():
        _, mode = _guarded(fn)
    assert mode.ops > MIN_OPS.get(path, 20), \
        f"{path}: only {mode.ops} ops seen"
    assert not mode.found, f"{path}: host reads {mode.found}"


def test_guard_catches_the_immediate_copy_check():
    """Control: the pass without the caller's flag reads its flag at once,
    and the guard sees it."""
    eng, state, _ = _served_engine()
    with torch.inference_mode():
        plan = eng._plan_fn(state)[0]
        _, mode = _guarded(eng.backend.apply_maintain, state, plan)
    assert mode.found and set(mode.found) <= set(HOST_READS)


@functools.lru_cache(maxsize=None)
def _ref_models(arch):
    jcfg = j_reduce(j_get_config(arch))
    cfg = reduce_for_smoke(get_config(arch))
    tree = jax.tree.map(np.asarray, j_init_params(jcfg, jax.random.key(4)))
    return (jcfg, jax.tree.map(jnp.asarray, tree), cfg,
            from_jax_params(tree, cfg, "cpu"))


@pytest.mark.parametrize("arch", ["llama3-8b", "hubert-xlarge"])
def test_make_prefill_fn_matches_reference(arch):
    """The decoder's last-position logits and its caches (llama3-8b), the
    encoder's logits over every frame (hubert-xlarge), within 1e-4."""
    jcfg, jparams, cfg, params = _ref_models(arch)
    rng = np.random.default_rng(5)
    if cfg.is_encoder:
        batch = {"embeds": rng.normal(size=(2, 20, cfg.d_model))
                 .astype(np.float32)}
    else:
        batch = {"tokens": rng.integers(0, cfg.vocab, (2, 11))
                 .astype(np.int32)}
    jout = j_decode.make_prefill_fn(jcfg, JShapeConfig("t", 32, 2,
                                                       "prefill"))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    out = t_decode.make_prefill_fn(cfg, ShapeConfig("t", 32, 2, "prefill"))(
        params, {k: torch.as_tensor(v) for k, v in batch.items()})
    if cfg.is_encoder:
        assert out.shape == (2, 20, cfg.vocab)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATOL)
        return
    (jlogits, jstate), (logits, state) = jout, out
    assert logits.shape == (2, cfg.vocab)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=ATOL)
    np.testing.assert_array_equal(state.pos.numpy(), np.asarray(jstate.pos))
    for k in ("k", "v"):
        np.testing.assert_allclose(state.caches[k].numpy(),
                                   np.asarray(jstate.caches[k]), atol=ATOL)


def test_make_decode_fn_matches_reference():
    """Four decode steps after the prefill, teacher-forced with the
    reference's greedy tokens: logits within 1e-4 at every step."""
    jcfg, jparams, cfg, params = _ref_models("llama3-8b")
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (2, 9)) \
        .astype(np.int32)
    _, jstate = j_decode.make_prefill_fn(jcfg, JShapeConfig(
        "t", 24, 2, "decode"))(jparams, {"tokens": jnp.asarray(toks)})
    _, state = t_decode.make_prefill_fn(cfg, ShapeConfig(
        "t", 24, 2, "decode"))(params, {"tokens": torch.as_tensor(toks)})
    jstep, step = j_decode.make_decode_fn(jcfg), t_decode.make_decode_fn(cfg)
    nxt = toks[:, -1]
    for _ in range(4):
        jlogits, jstate = jstep(jparams, jstate, jnp.asarray(nxt))
        logits, state = step(params, state, torch.as_tensor(nxt))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   atol=ATOL)
        nxt = np.asarray(jnp.argmax(jlogits, -1)).astype(np.int32)
    np.testing.assert_array_equal(state.pos.numpy(), np.asarray(jstate.pos))


def test_out_of_range_copy_raises_from_engine_through_deferred_flag(
        monkeypatch):
    """A captured pass only sets the caller's flag (as the card's replay
    does on an index outside its pools); the engine reads it after the
    pass and raises ``IndexError``, from ``_log_bandwidth`` and from a
    whole ``run``."""
    eng, state, _ = _served_engine()

    def card_replay(pools, recs, err):        # the kernel drops and flags
        err.fill_(1)

    monkeypatch.setattr(rg_ops, "remap_replay_op", card_replay)
    with torch.inference_mode():
        state = eng._apply(state, eng._plan(state))     # nothing raised
        assert int(eng._copy_err) == 1
        with pytest.raises(IndexError, match="outside its pool"):
            eng._log_bandwidth(state)
    cfg, _ = _params("llama3-8b")
    rng = np.random.default_rng(2)
    for r in range(3):
        eng.submit(Request(rid=r, prompt=rng.integers(0, cfg.vocab, 20),
                           max_new=6))
    with pytest.raises(IndexError, match="outside its pool"):
        eng.run()


def _leaves(state):
    return torch.utils._pytree.tree_leaves(state)


def test_run_resets_kept_state_to_a_fresh_init_state():
    """The engine's buffers outlive a run: after a run they are reset in
    place (the same tensors) to a fresh ``init_state``, bit for bit, and a
    second run decodes the first's tokens (the step count, and with it
    the maintenance cadence, runs on across runs, as the reference's
    does)."""
    cfg, params = _params("llama3-8b")
    eng = Engine(cfg, params, EngineConfig(**EC), device="cpu")
    runs = []
    for _ in range(2):
        rng = np.random.default_rng(8)
        for r in range(3):
            eng.submit(Request(rid=r, prompt=rng.integers(
                0, cfg.vocab, int(rng.integers(5, 30))), max_new=7))
        done = eng.run()
        runs.append(({r.rid: r.tokens for r in done}, eng.counters))
    assert runs[0][0] == runs[1][0]
    assert runs[0][1]["migrations"] > 0 and runs[1][1]["migrations"] > 0
    kept = _leaves(eng._kept[0])
    ptrs = [t.data_ptr() for t in kept]
    with torch.inference_mode():       # as ``run`` does
        state, tokens = eng._reset_state()
    assert [t.data_ptr() for t in _leaves(state)] == ptrs
    fresh = _leaves(eng.backend.init_state(EC["batch"], EC["max_len"]))
    assert len(fresh) == len(kept)
    for a, b in zip(_leaves(state), fresh):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert not tokens.any()


def test_graphs_need_a_card_and_pools_stay_in_place():
    """``graphs=True`` on the CPU raises; the default there runs the step
    eagerly.  The write-back refuses a pool handed back as a new tensor
    and accepts new metadata leaves, copied into the static buffers."""
    cfg, params = _params("llama3-8b")
    with pytest.raises(ValueError, match="card"):
        Engine(cfg, params, EngineConfig(**EC), device="cpu", graphs=True)
    runner = t_decode.StepGraphs("cpu")
    assert not runner.enabled
    out, _ = runner.run("k", lambda s, x: (x + 1, s), None, torch.ones(2))
    assert out.tolist() == [2.0, 2.0]
    tcfg = tk.TieredConfig(n_seqs=2, max_pages_per_seq=4, page_tokens=8,
                           n_kv_heads=1, head_dim=16, fast_data_slots=2,
                           dtype="float32")
    st = runner.bind(tk.init_state(tcfg, "cpu"))
    epoch = st.epoch
    runner._write_back(st._replace(epoch=st.epoch + 3))
    assert runner.state.epoch is epoch and int(epoch) == 3
    with pytest.raises(RuntimeError, match="pool leaf 'slow_k'"):
        runner._write_back(st._replace(slow_k=st.slow_k.clone()))
    with pytest.raises(RuntimeError, match="view of a static buffer"):
        runner._write_back(st._replace(touch=st.ema[:]))


# ---------------------------------------------------------------------------
# the lane-lifecycle functions: device-scalar arguments == Python ints
# ---------------------------------------------------------------------------

def _lifecycle_backend(kind):
    """A backend of the smoke config (4 lanes, 64 positions, 8-token pages,
    6 fast slots) whose lanes 0-2 hold seeded prompts and lane 0 two
    admitted pages, so a release, an admission and a pass have work."""
    from repro_torch.models.kv_backend import DenseBackend, TieredBackend
    cfg, _ = _params("llama3-8b")
    be = TieredBackend(cfg, 4, 64, page_tokens=8, fast_data_slots=6,
                       device="cpu") if kind == "tiered" \
        else DenseBackend(cfg, "cpu")
    st = be.init_state(4, 64)
    g = torch.Generator().manual_seed(11)
    kv = lambda n: torch.randn((cfg.n_layers, n, cfg.n_kv_heads,  # noqa
                                cfg.hd), generator=g)
    for lane, n in ((0, 30), (1, 21), (2, 40)):
        st = be.write_prefill(st, lane, kv(40), kv(40), n)
    if kind == "tiered":
        st = be.admit_prefix(st, 0, 30, 2)
    return cfg, be, st, kv(8), kv(8)


def _lifecycle_call(name, be, st, k8, v8, lane, length, start, as_tensor):
    i32 = (lambda x: torch.tensor(x, dtype=torch.int32)) if as_tensor \
        else (lambda x: x)
    args = (i32(lane), i32(length))
    if name == "release":
        return be.release(st, args[0])
    if name == "release_single":
        return tk.release_seq(be.tcfg, st.caches._replace(**{
            f: getattr(st.caches, f)[0] for f in tk.POOL_FIELDS}), args[0])
    if name == "write_prefill":
        return be.write_prefill(st, *args[:1], k8, v8, args[1])
    if name == "write_prefill_chunk":
        return be.write_prefill_chunk(st, args[0], k8, v8, i32(start),
                                      args[1])
    if name == "admit":
        return be.admit_prefix_desc(st, *args, 2)
    if name == "tenants":
        lt = np.array([0, 1, lane % 2, -1], np.int32)
        return be.maintain_tenants(
            st, torch.from_numpy(lt) if as_tensor else lt,
            (be.tcfg.pol, be.tcfg.pol), (4, 2))
    raise KeyError(name)


LIFECYCLE = [("tiered", n) for n in ("release", "release_single",
                                     "write_prefill", "write_prefill_chunk",
                                     "admit", "tenants")] \
    + [("dense", n) for n in ("write_prefill", "write_prefill_chunk")]


@pytest.mark.parametrize("lane", [1, 2])
@pytest.mark.parametrize("kind,name", LIFECYCLE)
def test_lifecycle_with_device_scalars_equals_python_ints(kind, name, lane):
    """Each function with the lane, length and chunk start as 0-d int32
    tensors (the captured steps' arguments) leaves every state leaf and
    pool, and returns every descriptor, bit for bit as its Python-int
    call does."""
    outs = []
    for as_tensor in (False, True):
        cfg, be, st, k8, v8 = _lifecycle_backend(kind)
        outs.append(_leaves(_lifecycle_call(name, be, st, k8, v8, lane,
                                            23 + lane, 8 * lane,
                                            as_tensor)))
    assert len(outs[0]) == len(outs[1]) > 1
    for a, b in zip(*outs):
        assert a.dtype == b.dtype and torch.equal(a, b)
