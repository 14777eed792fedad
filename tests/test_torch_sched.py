"""The port's request scheduling against the reference's: the tenant
partition of the move budget (``plan_tenants``), the fast-slot split and
the QoS admission book exactly; the chunked engine's token streams equal
the port's greedy engine's bit for bit (dense and tiered, under every
policy preset, a chunk that does not divide the padded length); and on
the reference's two-tenant trace the port's chunked engine gives the JAX
engine's token streams, counters and fairness books."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduce_for_smoke as j_reduce
from repro.core.policy import PRESETS
from repro.core.policy import get_policy as j_get_policy
from repro.core.policy import plan_tenants as j_plan_tenants
from repro.models import init_params as j_init_params
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import EngineConfig as JEngineConfig
from repro.serve.engine import Request as JRequest
from repro.serve.sched import TenantBook as JTenantBook
from repro.serve.sched import TenantConfig as JTenantConfig
from repro.serve.sched import split_slots as j_split_slots
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core.policy import get_policy, plan_tenants
from repro_torch.models import init_params
from repro_torch.serve import engine as t_engine
from repro_torch.serve.engine import Engine, EngineConfig, Request
from repro_torch.serve.sched import (ChunkedScheduler, GreedyScheduler,
                                     TenantBook, TenantConfig, make_scheduler,
                                     split_slots)
from repro_torch.tiered import kvcache as tk
from repro_torch.weights import from_jax_params
from torch_threads import one_torch_thread  # noqa: F401

LOGITS_ATOL = 1e-4


@functools.lru_cache(maxsize=1)
def _models():
    """One seeded model for both engines: the port's ``init_params`` in
    the reference's layout (the reference's init folds a per-process
    ``hash()`` into its keys), converted back through
    ``from_jax_params``."""
    jcfg = j_reduce(j_get_config("llama3-8b"))
    cfg = reduce_for_smoke(get_config("llama3-8b"))
    seeded = init_params(cfg, "cpu", seed=2)
    like = lambda t, x: {k: like(v, x[k]) for k, v in t.items()} \
        if isinstance(t, dict) else jnp.asarray(x.float().numpy())  # noqa
    jparams = like(j_init_params(jcfg, jax.random.key(0)), seeded)
    params = from_jax_params(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jcfg, jparams, cfg, params


# ---------------------------------------------------------------------------
# QoS books, exact against the reference
# ---------------------------------------------------------------------------

def test_plan_tenants_matches_reference():
    """Randomised scores, residency and grouping (``tests/test_sched.py``'s
    draw): both queues of the concatenated plan equal, disabled lanes
    included."""
    names = (("threshold", 3), ("write_aware", 2), ("on_demand", 4))
    jpols = tuple(j_get_policy(n, max_moves=m) for n, m in names)
    tpols = tuple(get_policy(n, max_moves=m) for n, m in names)
    quotas = (4, 3, 2)
    rng = np.random.default_rng(7)
    for _ in range(20):
        score = rng.integers(0, 8, 64).astype(np.int32)
        resident = rng.random(64) < 0.3
        group = rng.integers(-1, 3, 64).astype(np.int32)
        jp = j_plan_tenants(jpols, jnp.asarray(score), jnp.asarray(resident),
                            jnp.asarray(group), quotas)
        tp = plan_tenants(tpols, torch.from_numpy(score),
                          torch.from_numpy(resident), torch.from_numpy(group),
                          quotas)
        for f, a, b in zip(tp._fields, jp, tp):
            np.testing.assert_array_equal(np.asarray(a).astype(np.int64),
                                          b.numpy().astype(np.int64), f)


@pytest.mark.parametrize("total,weights", [
    (10, (3, 1, 1)), (2, (3, 1, 1)), (128, (2, 1)), (7, (1,)),
    (5, (1, 1, 1, 1, 1, 1)), (64, (5, 3, 2))])
def test_split_slots_matches_reference(total, weights):
    jt = tuple(JTenantConfig(f"t{i}", weight=w) for i, w in enumerate(weights))
    tt = tuple(TenantConfig(f"t{i}", weight=w) for i, w in enumerate(weights))
    q = split_slots(total, tt)
    assert q == j_split_slots(total, jt)
    assert sum(q) == total


@pytest.mark.parametrize("weights,bound", [((100, 1), 4), ((3, 1), 100),
                                           ((2, 1, 1), 2)])
def test_tenant_book_matches_reference(weights, bound):
    """The same submissions and picks (finishes in between): the same
    picked requests, credits, skip counts and fairness books."""
    names = [f"t{i}" for i in range(len(weights))]
    jb = JTenantBook(tuple(JTenantConfig(n, weight=w)
                           for n, w in zip(names, weights)), bound)
    tb = TenantBook(tuple(TenantConfig(n, weight=w)
                          for n, w in zip(names, weights)), bound)
    rng = np.random.default_rng(len(weights) + bound)
    rid = 0
    for rnd in range(12):
        for _ in range(int(rng.integers(0, 6))):
            tenant = names[int(rng.integers(0, len(names)))]
            for book, make in ((jb, JRequest), (tb, Request)):
                book.submit(make(rid=rid, prompt=np.zeros(1, np.int32),
                                 max_new=1, tenant_id=tenant,
                                 arrived=float(rid)))
            rid += 1
        for _ in range(int(rng.integers(0, 5))):
            a, b = jb.pick(), tb.pick()
            assert (a is None) == (b is None)
            if a is None:
                break
            assert (a.rid, a.tenant_id) == (b.rid, b.tenant_id)
            a.tokens, b.tokens = [1] * rnd, [1] * rnd
            jb.finish(a)
            tb.finish(b)
        assert (tb.credit, tb.skips, tb.pending) \
            == (jb.credit, jb.skips, jb.pending)
    assert tb.fairness() == jb.fairness()
    assert max(s["max_skips"] for s in tb.stats) <= bound


def test_tenant_config_checks():
    with pytest.raises(KeyError, match="unknown tenant"):
        TenantBook((TenantConfig("a"), TenantConfig("b"))).submit(
            Request(rid=0, prompt=np.zeros(1, np.int32), max_new=1,
                    tenant_id="c"))
    one = TenantBook((TenantConfig("only"),))
    one.submit(Request(rid=0, prompt=np.zeros(1, np.int32), max_new=1))
    assert one.pending == 1                       # catch-all single tenant
    for bad in ((TenantConfig("a"), TenantConfig("a")),
                (TenantConfig("a", weight=0),)):
        with pytest.raises(ValueError):
            make_scheduler(EngineConfig(scheduler="chunked", tenants=bad))
    with pytest.raises(ValueError, match="starvation_bound"):
        TenantBook((TenantConfig("a"),), starvation_bound=0)


def test_make_scheduler_kinds_and_wave_shim():
    assert isinstance(make_scheduler(EngineConfig()), GreedyScheduler)
    assert isinstance(make_scheduler(EngineConfig(scheduler="chunked")),
                      ChunkedScheduler)
    with pytest.warns(FutureWarning, match="wave-refill"):
        s = make_scheduler(EngineConfig(scheduler="wave"))
    assert isinstance(s, GreedyScheduler)
    with pytest.raises(ValueError):
        make_scheduler(EngineConfig(scheduler="nope"))


def test_admission_capped_by_remaining_quota():
    """Direct-to-fast admission cannot grow a tenant past its fast-slot
    partition across concurrent lanes (``tests/test_sched.py``'s case)."""
    _, _, cfg, params = _models()
    eng = Engine(cfg, params, EngineConfig(
        batch=2, max_len=64, backend="tiered", page_tokens=8,
        fast_data_slots=3, scheduler="chunked", prefill_chunk=8,
        tenants=(TenantConfig("only", weight=1, policy="on_demand"),),
        admit_pages=2), device="cpu")
    s = eng.scheduler
    assert s.quotas == (3,)
    assert s._admit_fast_pages(0, 0, 64) == 2
    s.lane_tenant[0] = 0
    s._note_admit(0, 0, 2)
    assert s._admit_fast_pages(1, 0, 64) == 1
    s.lane_tenant[1] = 0
    s._note_admit(1, 0, 1)
    assert s._admit_fast_pages(0, 0, 64) == 0
    s._admitted[0] = 0
    s.lane_tenant[0] = -1
    assert s._admit_fast_pages(0, 0, 64) == 2


# ---------------------------------------------------------------------------
# chunked engine == greedy engine, the port against itself, bit for bit
# ---------------------------------------------------------------------------

def _streams(ec, reqs):
    _, _, cfg, params = _models()
    eng = Engine(cfg, params, ec, device="cpu")
    for r in reqs:
        eng.submit(r)
    return {r.rid: r.tokens for r in eng.run()}, eng


def test_chunked_engine_tokens_equal_greedy_multilane():
    """A mixed request set under the chunked scheduler gives the greedy
    one-shot engine's token streams, dense and tiered (the interleaving
    changes, the math must not)."""
    _, _, cfg, _ = _models()

    def reqs():
        rng = np.random.default_rng(5)
        return [Request(rid=r, prompt=rng.integers(0, cfg.vocab, 3 + 5 * r),
                        max_new=4 + (r % 2) * 4) for r in range(4)]

    ref, _ = _streams(EngineConfig(batch=2, max_len=64), reqs())
    dense, _ = _streams(EngineConfig(batch=2, max_len=64, scheduler="chunked",
                                     prefill_chunk=4), reqs())
    tiered, eng = _streams(EngineConfig(
        batch=2, max_len=64, backend="tiered", page_tokens=8,
        fast_data_slots=8, maintain_every=3, scheduler="chunked",
        prefill_chunk=8), reqs())
    assert dense == ref
    assert tiered == ref
    assert eng.scheduler.book.stats[0]["chunks"] > 4


def test_chunked_tokens_equal_when_chunk_misaligned_to_buffer():
    """Chunk sizes that do not divide the padded length (12 and 24 of
    32): the final chunk back-aligns and re-writes the overlapped rows'
    same values, so the stream equals the one-shot engine's."""
    _, _, cfg, _ = _models()
    prompt = np.random.default_rng(23).integers(0, cfg.vocab, 30)

    def run(ec):
        return _streams(ec, [Request(rid=0, prompt=prompt.copy(),
                                     max_new=4)])[0]

    ref = run(EngineConfig(batch=1, max_len=64))
    assert run(EngineConfig(batch=1, max_len=64, scheduler="chunked",
                            prefill_chunk=12)) == ref
    assert run(EngineConfig(batch=1, max_len=64, backend="tiered",
                            page_tokens=8, fast_data_slots=4,
                            scheduler="chunked", prefill_chunk=24)) == ref


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_chunked_prefill_tokens_equal_one_shot(preset):
    """Under every policy preset the tiered engine decodes the same tokens
    after a chunked ingest (chunks of one page, maintenance every two
    steps) as after a one-shot prefill."""
    _, _, cfg, _ = _models()
    prompt = np.random.default_rng(13).integers(0, cfg.vocab, 21)
    kw = dict(batch=1, max_len=48, backend="tiered", page_tokens=8,
              fast_data_slots=4, maintain_every=2, policy=preset)
    req = lambda: [Request(rid=0, prompt=prompt.copy(), max_new=5)]  # noqa
    ref, _ = _streams(EngineConfig(**kw), req())
    got, eng = _streams(EngineConfig(**kw, scheduler="chunked",
                                     prefill_chunk=8), req())
    assert got == ref
    assert eng.scheduler.book.stats[0]["chunks"] == 3


# ---------------------------------------------------------------------------
# the reference's two-tenant trace, port engine against JAX engine
# ---------------------------------------------------------------------------

TENANTS = (("interactive", 2, "on_demand"), ("batch", 1, None))


def _two_tenant(make_engine, make_ec, make_tenant, make_req, vocab):
    tenants = tuple(make_tenant(n, weight=w, policy=p) for n, w, p in TENANTS)
    eng = make_engine(make_ec(
        batch=2, max_len=64, backend="tiered", page_tokens=8,
        fast_data_slots=8, maintain_every=2, scheduler="chunked",
        prefill_chunk=8, tenants=tenants, admit_pages=2))
    rng = np.random.default_rng(17)
    for rid in range(6):
        t = "interactive" if rid % 2 == 0 else "batch"
        eng.submit(make_req(
            rid=rid, prompt=rng.integers(0, vocab, 4 if t == "interactive"
                                         else 24),
            max_new=5, tenant_id=t))
    return eng, eng.run()


def test_two_tenant_trace_matches_reference(monkeypatch):
    """``tests/test_sched.py``'s two-tenant chunked + QoS trace on the
    tiered backend: the port's token streams, ``Engine.counters``,
    releases and fairness books equal the JAX engine's; the smallest
    top-2 logit margin of the port's decode steps is above the logits
    tolerance, so a token mismatch could only be a fault.  Then the
    reference's invariants on the port: released metadata back to
    identity, admission for the on-demand tenant, request stats
    well-formed."""
    jcfg, jparams, cfg, params = _models()
    jeng, jdone = _two_tenant(lambda ec: JEngine(jcfg, jparams, ec),
                              JEngineConfig, JTenantConfig, JRequest,
                              cfg.vocab)
    margins = []
    real = t_engine.decode_step

    def spy(cfg_, params_, state, tokens, **kw):
        live = state.pos >= 0
        logits, new = real(cfg_, params_, state, tokens, **kw)
        top2 = torch.topk(logits[live], 2, dim=-1).values
        margins.extend((top2[:, 0] - top2[:, 1]).tolist())
        return logits, new

    monkeypatch.setattr(t_engine, "decode_step", spy)
    eng, done = _two_tenant(lambda ec: Engine(cfg, params, ec, device="cpu"),
                            EngineConfig, TenantConfig, Request, cfg.vocab)
    monkeypatch.setattr(t_engine, "decode_step", real)
    assert min(margins) > LOGITS_ATOL, f"top-2 margin {min(margins)}"
    assert {r.rid: r.tokens for r in done} \
        == {r.rid: r.tokens for r in jdone}
    assert eng.counters == jeng.counters
    assert eng.releases == jeng.releases == 6
    stats, jstats = eng.request_stats(done), jeng.request_stats(jdone)
    assert stats["fairness"] == jstats["fairness"]
    st = eng.final_state.caches
    assert (st.leaf_table == tk.INVALID).all()
    assert (st.slot_owner == tk.INVALID).all()
    fair = stats["fairness"]
    assert fair["interactive"]["finished"] == fair["batch"]["finished"] == 3
    assert fair["interactive"]["admitted_fast_pages"] > 0
    assert fair["batch"]["chunks"] > fair["interactive"]["chunks"]
    agg = stats["aggregate"]
    assert agg["tokens"] == sum(len(r.tokens) for r in done)
    assert sum(agg["token_latency_hist"]["counts"]) == agg["tokens"]
    assert agg["token_latency_hist"]["edges_ms"] \
        == jstats["aggregate"]["token_latency_hist"]["edges_ms"]
    assert set(stats["tenants"]) == {"interactive", "batch"}
    c = eng.counters
    assert c["migrations"] > 0
    assert sum(c["epoch_promo_bytes"]) == c["promo_bytes"]


def test_mid_wave_latency_uses_own_enqueue(monkeypatch):
    """A request admitted mid-wave measures latency and time to first
    token from its own enqueue time (fake clock, as the reference's
    test)."""
    clock = {"t": 0.0}
    monkeypatch.setattr(t_engine.time, "time", lambda: clock["t"])
    _, _, cfg, params = _models()
    eng = Engine(cfg, params, EngineConfig(batch=1, max_len=32),
                 device="cpu")
    rng = np.random.default_rng(11)
    r0 = Request(rid=0, prompt=rng.integers(0, cfg.vocab, 2), max_new=3)
    r1 = Request(rid=1, prompt=rng.integers(0, cfg.vocab, 2), max_new=3)
    eng.submit(r0)
    clock["t"] = 10.0
    eng.submit(r1)
    now = [clock["t"]]

    def tick():
        now[0] += 0.5
        return now[0]
    monkeypatch.setattr(t_engine.time, "time", tick)
    done = {r.rid: r for r in eng.run()}
    assert done[1].arrived == 10.0
    assert done[1].latency < (done[1].done_at - done[0].arrived) - 5.0
    for r in done.values():
        assert r.first_token_at >= r.admitted_at >= r.arrived
        assert r.done_at >= r.first_token_at
        assert len(r.token_times) == len(r.tokens)


def test_serve_launcher_chunked_on_cpu(capsys):
    """The launcher's chunked + QoS flags drive the engine end to end."""
    from repro_torch.launch import serve
    serve.main(["--arch", "llama3-8b", "--smoke", "--device", "cpu",
                "--backend", "tiered", "--scheduler", "chunked",
                "--prefill-chunk", "16", "--tenants",
                "interactive:2:on_demand,batch:1", "--requests", "4",
                "--max-new", "4"])
    out = capsys.readouterr().out
    assert "served 4 requests, 16 tokens" in out
    assert "'interactive': {'weight': 2" in out
