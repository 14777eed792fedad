"""The port's page-lifecycle flight recorder against the reference's
(``repro.obs.flight``): ring ``record``/``drain`` on the same event
batches (batch order, disabled entries, wraparound, one batch larger
than the ring, several kinds in one call), ``analyze`` and ``export`` on
the same drained window, and the engine taps: on the traces of
``tests/test_flight.py`` and ``tests/test_obs.py`` under a demoting
policy and, over a two-slot fast pool, under the on-demand preset (FIFO
victims evicted), and on the two-tenant chunked trace, the port's
``Engine`` with obs, flight and SLOs on records the JAX ``Engine``'s
event stream field by field, its ``by_kind`` counts and hub counter
series; its tokens equal a telemetry-off run's; the overlapped stream
equals the synchronous one; flight off keeps no ring; the live
endpoints answer."""

import json
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.policy import get_policy as j_get_policy
from repro.models.kv_backend import TieredBackend as JTieredBackend
from repro.obs import FlightConfig as JFlightConfig
from repro.obs import MetricsHub as JMetricsHub
from repro.obs import ObsConfig as JObsConfig
from repro.obs import flight as jfl
from repro.obs import parse_slos as j_parse_slos
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import EngineConfig as JEngineConfig
from repro.serve.engine import Request as JRequest
from repro.serve.sched import TenantConfig as JTenantConfig
from repro_torch.core.policy import get_policy
from repro_torch.models.kv_backend import TieredBackend
from repro_torch.obs import FlightConfig, MetricsHub, ObsConfig, parse_slos
from repro_torch.obs import flight as fl
from repro_torch.obs import parse_prometheus
from repro_torch.serve import engine as t_engine
from repro_torch.serve.engine import Engine, EngineConfig, Request
from repro_torch.serve.sched import TenantConfig
from test_torch_engine import LOGITS_ATOL, _models
from torch_threads import one_torch_thread  # noqa: F401

# ---------------------------------------------------------------------------
# ring ops: the same batches through both rings
# ---------------------------------------------------------------------------


def _both_rings(cap, calls):
    """``calls``: (kind, pages, enable, step, lane, tenant, cause, score)
    per record call (numpy); returns the two drained windows."""
    jr, tr = jfl.init(cap), fl.init(cap)
    for kind, pages, en, step, lane, tenant, cause, score in calls:
        jr = jfl.record(jr, kind, jnp.asarray(pages), jnp.asarray(en),
                        step=jnp.int32(step), lane=jnp.asarray(lane),
                        tenant=jnp.asarray(tenant), cause=cause,
                        score=None if score is None else jnp.asarray(score))
        tr = fl.record(tr, kind, torch.from_numpy(pages),
                       torch.from_numpy(en), step=step,
                       lane=torch.from_numpy(lane),
                       tenant=torch.from_numpy(tenant), cause=cause,
                       score=None if score is None
                       else torch.from_numpy(score))
    return jfl.drain(jr), fl.drain(tr)


def _assert_drained_equal(a, b):
    for f in jfl.FIELDS:
        np.testing.assert_array_equal(np.asarray(a[f]), b[f], f)
    for k in ("n", "total_events", "dropped"):
        assert a[k] == b[k], k
    np.testing.assert_array_equal(np.asarray(a["counts"]), b["counts"])


def _random_calls(rng, n_calls, m, p_en):
    calls = []
    for c in range(n_calls):
        pages = rng.integers(0, 64, m).astype(np.int32)
        en = rng.random(m) < p_en
        calls.append((int(rng.integers(0, len(jfl.KINDS))), pages, en, c,
                      pages // 8, rng.integers(0, 3, m).astype(np.int32),
                      int(rng.integers(0, len(jfl.CAUSES))),
                      None if c % 2 else
                      rng.integers(0, 99, m).astype(np.int32)))
    return calls


@pytest.mark.parametrize("cap,n_calls,m,p_en", [
    (8, 2, 3, 0.7),        # batch order, disabled entries without a hole
    (8, 5, 3, 1.0),        # wraparound: the newest 8 survive, counts exact
    (4, 3, 4, 0.0),        # nothing enabled: head stays, nothing written
    (8, 3, 20, 0.8),       # one batch larger than the ring
    (64, 6, 16, 0.5),      # a ring that never wraps
])
def test_ring_record_and_drain_match_reference(cap, n_calls, m, p_en):
    rng = np.random.default_rng(cap * 100 + n_calls * 10 + m)
    a, b = _both_rings(cap, _random_calls(rng, n_calls, m, p_en))
    _assert_drained_equal(a, b)
    if p_en == 1.0:
        assert b["dropped"] == n_calls * m - cap


def test_one_call_of_several_kinds_equals_calls_in_order():
    """The engine records a maintenance pass as ONE call with per-entry
    kinds and causes: the same window and counts as the reference's four
    calls, also when the batch wraps the ring."""
    rng = np.random.default_rng(5)
    calls = _random_calls(rng, 4, 5, 0.6)
    for cap in (64, 7):
        ref = jfl.init(cap)
        for kind, pages, en, _, lane, tenant, cause, _s in calls:
            ref = jfl.record(ref, kind, jnp.asarray(pages), jnp.asarray(en),
                             step=jnp.int32(9), lane=jnp.asarray(lane),
                             tenant=jnp.asarray(tenant), cause=cause)
        cat = lambda i: torch.from_numpy(np.concatenate(  # noqa: E731
            [np.broadcast_to(np.int32(c[i]), c[1].shape) for c in calls]))
        port = fl.record(fl.init(cap), cat(0), cat(1),
                         torch.from_numpy(np.concatenate([c[2]
                                                          for c in calls])),
                         step=9, lane=cat(4), tenant=cat(5), cause=cat(6))
        _assert_drained_equal(jfl.drain(ref), fl.drain(port))


def _synthetic(rng, n):
    kinds = rng.integers(0, len(jfl.KINDS), n)
    counts = np.bincount(kinds, minlength=len(jfl.KINDS))
    return {"kind": kinds.astype(np.int32),
            "page": rng.integers(0, 6, n).astype(np.int32),
            "step": np.sort(rng.integers(0, 80, n)).astype(np.int32),
            "layer": np.zeros(n, np.int32), "lane": np.zeros(n, np.int32),
            "tenant": rng.integers(0, 3, n).astype(np.int32),
            "cause": np.zeros(n, np.int32), "score": np.zeros(n, np.int32),
            "n": n, "total_events": n + 3, "dropped": 3, "counts": counts}


@pytest.mark.parametrize("seed,n,window", [(0, 0, 32), (1, 40, 4),
                                           (2, 200, 16)])
def test_analyze_and_export_match_reference(seed, n, window):
    ev = _synthetic(np.random.default_rng(seed), n)
    names = ["a", "b"]     # tenant 2 falls back to its index
    a = jfl.analyze(ev, pingpong_steps=window, tenant_names=names)
    b = fl.analyze(ev, pingpong_steps=window, tenant_names=names)
    assert a == b
    ja, tb = JMetricsHub(), MetricsHub()
    jfl.export(ja, a)
    fl.export(tb, b)
    assert ja.to_prometheus() == tb.to_prometheus()


# ---------------------------------------------------------------------------
# engine taps against the JAX engine
# ---------------------------------------------------------------------------

# tests/test_flight.py's and tests/test_obs.py's trace: 4 requests of 4
# prompt tokens and 8 new tokens, 2 lanes, 4 fast data slots
TRACE = dict(batch=2, max_len=64, backend="tiered", page_tokens=8,
             fast_data_slots=4, maintain_every=2)
# every preset keeps demote_threshold 0, and a live lane touches each of
# its live pages every step, so no preset demotes in serving; this one
# demotes (and re-promotes: ping-pong) on the trace above
DEMOTING = dict(demote_threshold=16)
SLOS = "*:latency:1e9,*:ttft:1e9"
STREAM = ("kind", "page", "step", "layer", "lane", "tenant", "cause",
          "score")
# families whose values are times, not counts
TIMED = ("engine_request_latency_ms",)


def _jax_engine(over, tmp, flight=True):
    jcfg, jparams, _, _ = _models()
    ec = JEngineConfig(**TRACE, **over,
                       obs=JObsConfig(sample_every=2,
                                      prom_path=str(tmp / "jprom.txt")),
                       flight=JFlightConfig(capacity=512) if flight else None,
                       slos=j_parse_slos(SLOS))
    be = JTieredBackend(jcfg, ec.batch, ec.max_len, page_tokens=8,
                        fast_data_slots=4,
                        policy=j_get_policy("write_aware", **DEMOTING))
    eng = JEngine(jcfg, jparams, ec, backend=be)
    rng = np.random.default_rng(3)
    for rid in range(4):
        eng.submit(JRequest(rid=rid, prompt=rng.integers(0, jcfg.vocab, 4),
                            max_new=8))
    return eng, eng.run()


def _port_engine(over, tmp=None, telemetry=True, margins=None, **extra):
    _, _, cfg, params = _models()
    tel = {}
    if telemetry:
        tel = dict(obs=ObsConfig(sample_every=2,
                                 prom_path=str(tmp / "prom.txt"),
                                 jsonl_path=str(tmp / "m.jsonl"),
                                 trace_path=str(tmp / "trace.json"),
                                 **extra),
                   flight=FlightConfig(capacity=512), slos=parse_slos(SLOS))
    ec = EngineConfig(**TRACE, **over, **tel)
    be = TieredBackend(cfg, ec.batch, ec.max_len, page_tokens=8,
                       fast_data_slots=4,
                       policy=get_policy("write_aware", **DEMOTING),
                       device="cpu")
    eng = Engine(cfg, params, ec, backend=be, device="cpu")
    rng = np.random.default_rng(3)
    for rid in range(4):
        eng.submit(Request(rid=rid, prompt=rng.integers(0, cfg.vocab, 4),
                           max_new=8))
    return eng, _run_with_margins(eng, margins)


def _run_with_margins(eng, margins):
    """``eng.run()``; with ``margins`` a list, it collects each live
    lane's top-2 logit margin of every decode step."""
    if margins is None:
        return eng.run()
    real = t_engine.decode_step

    def spy(cfg_, params_, state, tokens, **kw):
        live = state.pos >= 0
        logits, new = real(cfg_, params_, state, tokens, **kw)
        top2 = torch.topk(logits[live], 2, dim=-1).values
        margins.extend((top2[:, 0] - top2[:, 1]).tolist())
        return logits, new

    t_engine.decode_step = spy
    try:
        return eng.run()
    finally:
        t_engine.decode_step = real


def _stream(eng, drained=None):
    ev = drained if drained is not None else (
        jfl.drain(eng._fl) if isinstance(eng, JEngine) else fl.drain(eng._fl))
    return {k: [int(x) for x in np.asarray(ev[k])] for k in STREAM}


def _hub_rows(eng):
    """The hub's sample series without time-valued families."""
    keep = lambda k: (k.startswith(("trimma_", "engine_"))  # noqa: E731
                      and not k.startswith(TIMED))
    return [(r["step"], {k: v for k, v in r["metrics"].items() if keep(k)})
            for r in eng.hub.series]


def _counter_identity(eng):
    """What the counters imply for the flight ring's kinds (every pass
    recorded): promotes + installs = migrations, demotes = demotions,
    evicts = copy-backs that were not demotions (FIFO victims and forced
    evictions), each per layer (the counters sum over layers)."""
    c = eng.counters
    L = eng.cfg.n_layers
    copy_backs = c["demo_bytes"] // eng.backend.tcfg.page_bytes
    return {"promote+install": c["migrations"] // L,
            "demote": c["demotions"] // L,
            "evict": (copy_backs - c["demotions"]) // L}


def _kinds(stats):
    k = stats["by_kind"]
    return {"promote+install": k["promote"] + k["install"],
            "demote": k["demote"], "evict": k["evict"]}


@pytest.fixture(scope="module")
def sync_runs(tmp_path_factory):
    """The demoting trace with synchronous maintenance: the JAX engine,
    the port with telemetry on (top-2 margins collected) and off."""
    tmp = tmp_path_factory.mktemp("flight_sync")
    over = dict(overlap_maintain=False)
    jeng, jdone = _jax_engine(over, tmp)
    margins = []
    eng, done = _port_engine(over, tmp, margins=margins)
    off, off_done = _port_engine(over, telemetry=False)
    return dict(jeng=jeng, jdone=jdone, eng=eng, done=done, off=off,
                off_done=off_done, margins=margins, tmp=tmp)


def test_engine_flight_stream_matches_reference(sync_runs):
    r = sync_runs
    assert min(r["margins"]) > LOGITS_ATOL
    jstream, stream = _stream(r["jeng"]), _stream(r["eng"])
    assert stream == jstream
    stats, jstats = r["eng"].flight_stats(), r["jeng"].flight_stats()
    assert stats["by_kind"] == jstats["by_kind"]
    assert stats == jstats
    # the trace demotes and re-promotes
    assert stats["by_kind"]["demote"] > 0
    assert stats["pingpong"]["events"] > 0
    assert r["eng"].counters == r["jeng"].counters
    # the identity between counters and the ring's kinds holds in both
    assert _kinds(jstats) == _counter_identity(r["jeng"])
    assert _kinds(stats) == _counter_identity(r["eng"])


def test_engine_hub_series_matches_reference(sync_runs):
    r = sync_runs
    rows, jrows = _hub_rows(r["eng"]), _hub_rows(r["jeng"])
    assert len(rows) == len(jrows) >= 4
    assert rows == jrows
    final = rows[-1][1]
    assert final["trimma_flight_events_total"] > 0
    assert final["engine_steps_total"] == r["eng"].steps
    assert "engine_slo_burn_rate{stat=\"latency\",tenant=\"default\"}" \
        in final
    prom = parse_prometheus((r["tmp"] / "prom.txt").read_text())
    jprom = parse_prometheus((r["tmp"] / "jprom.txt").read_text())
    assert prom["families"] == jprom["families"]


def test_engine_telemetry_leaves_tokens_and_counters(sync_runs):
    r = sync_runs
    assert [x.tokens for x in r["done"]] == [x.tokens for x in r["off_done"]]
    assert [x.tokens for x in r["done"]] == [x.tokens for x in r["jdone"]]
    assert r["off"].counters == r["eng"].counters
    assert r["off"].flight_stats() is None and r["off"]._fl is None
    assert r["off"].hub is None and r["off"].slo is None


def test_engine_trace_and_jsonl_artifacts(sync_runs):
    r = sync_runs
    doc = json.loads((r["tmp"] / "trace.json").read_text())
    phases = {e["name"] for e in doc["traceEvents"] if e["ph"] == "X"}
    assert {"decode_step", "prefill", "maintain", "release"} <= phases
    rows = [json.loads(x) for x in
            (r["tmp"] / "m.jsonl").read_text().strip().splitlines()]
    deltas = [row["deltas"].get("engine_tokens_total", 0) for row in rows]
    assert all(d >= 0 for d in deltas)
    assert sum(deltas) == sum(len(x.tokens) for x in r["done"])


def test_engine_overlapped_stream_equals_sync(sync_runs, tmp_path):
    """Double-buffered maintenance stamps the step its plan was made at:
    the same stream as the synchronous pass (``score`` aside: the
    overlapped apply reads the tracker one step later), and the same
    stream as the JAX engine's overlapped run, score included."""
    eng, done = _port_engine(dict(overlap_maintain=True), tmp_path)
    jeng, _ = _jax_engine(dict(overlap_maintain=True), tmp_path)
    stream = _stream(eng)
    assert stream == _stream(jeng)
    sync = _stream(sync_runs["eng"])
    for k in STREAM[:-1]:
        assert stream[k] == sync[k], k
    assert eng.maintain_overlaps > 0
    assert [x.tokens for x in done] \
        == [x.tokens for x in sync_runs["done"]]


def test_engine_victim_evictions_match_reference():
    """The on-demand preset over a two-slot fast pool evicts FIFO victims
    (the pass's copy-back records): the port's stream, kinds and
    counters equal the JAX engine's, and the evicts are the copy-backs
    that were not demotions."""
    jcfg, jparams, cfg, params = _models()
    over = dict(TRACE, fast_data_slots=2, policy="on_demand")
    runs = []
    for make, ec, fc, req, p in (
            (JEngine, JEngineConfig, JFlightConfig, JRequest, jparams),
            (lambda c, p_, e: Engine(c, p_, e, device="cpu"), EngineConfig,
             FlightConfig, Request, params)):
        eng = make(jcfg if make is JEngine else cfg, p,
                   ec(**over, flight=fc(capacity=512)))
        rng = np.random.default_rng(3)
        for rid in range(4):
            eng.submit(req(rid=rid, prompt=rng.integers(0, cfg.vocab, 4),
                           max_new=8))
        runs.append((eng, eng.run()))
    (jeng, jdone), (eng, done) = runs
    assert [r.tokens for r in done] == [r.tokens for r in jdone]
    assert _stream(eng) == _stream(jeng)
    assert eng.counters == jeng.counters
    stats = eng.flight_stats()
    assert stats == jeng.flight_stats()
    assert stats["by_kind"]["evict"] > 0
    assert _kinds(stats) == _counter_identity(eng)


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.read().decode()


def test_engine_live_endpoints_on_port_zero(tmp_path):
    eng, done = _port_engine(dict(overlap_maintain=True), tmp_path,
                             http_port=0)
    try:
        assert eng.obs_server is not None and eng.obs_server.port > 0
        status, body = _get(eng.obs_server.url + "/metrics")
        parsed = parse_prometheus(body)
        assert status == 200
        assert parsed["samples"]["engine_steps_total"] == eng.steps
        assert parsed["samples"]["trimma_flight_events_total"] > 0
        status, body = _get(eng.obs_server.url + "/healthz")
        assert status == 200 and json.loads(body)["steps"] == eng.steps
        status, body = _get(eng.obs_server.url + "/debug/state")
        state = json.loads(body)
        assert status == 200 and state["steps"] == eng.steps
        assert state["flight"]["n_events"] > 0
        assert state["slo"][0]["tenant"] == "default"
        assert 0 <= state["fast_pool"]["resident_pages"] \
            <= state["fast_pool"]["slots"]
        assert len(state["lanes"]) == 2
    finally:
        eng.obs_server.close()


# ---------------------------------------------------------------------------
# the two-tenant chunked trace (tests/test_torch_sched.py's)
# ---------------------------------------------------------------------------

TENANTS = (("interactive", 2, "on_demand"), ("batch", 1, None))


def _two_tenant(make_engine, make_ec, make_tenant, make_req, vocab, **tel):
    tenants = tuple(make_tenant(n, weight=w, policy=p) for n, w, p in TENANTS)
    eng = make_engine(make_ec(
        batch=2, max_len=64, backend="tiered", page_tokens=8,
        fast_data_slots=8, maintain_every=2, scheduler="chunked",
        prefill_chunk=8, tenants=tenants, admit_pages=2, **tel))
    rng = np.random.default_rng(17)
    for rid in range(6):
        t = "interactive" if rid % 2 == 0 else "batch"
        eng.submit(make_req(
            rid=rid, prompt=rng.integers(0, vocab, 4 if t == "interactive"
                                         else 24),
            max_new=5, tenant_id=t))
    return eng, eng.run()


def test_two_tenant_chunked_telemetry_matches_reference(tmp_path):
    """Admission installs are recorded (the multi-tenant maintenance pass
    is not, as in the reference), stamped with each lane's tenant; the
    stream, per-tenant analytics, tenant books and hub series equal the
    JAX engine's."""
    jcfg, jparams, cfg, params = _models()
    jeng, jdone = _two_tenant(
        lambda ec: JEngine(jcfg, jparams, ec), JEngineConfig, JTenantConfig,
        JRequest, cfg.vocab,
        obs=JObsConfig(sample_every=2), flight=JFlightConfig(capacity=512),
        slos=j_parse_slos(SLOS))
    eng, done = _two_tenant(
        lambda ec: Engine(cfg, params, ec, device="cpu"), EngineConfig,
        TenantConfig, Request, cfg.vocab, obs=ObsConfig(sample_every=2),
        flight=FlightConfig(capacity=512), slos=parse_slos(SLOS))
    assert {r.rid: r.tokens for r in done} \
        == {r.rid: r.tokens for r in jdone}
    assert _stream(eng) == _stream(jeng)
    stats = eng.flight_stats()
    assert stats == jeng.flight_stats()
    assert stats["by_kind"]["install"] > 0
    assert set(stats["per_tenant"]) == {"interactive", "batch"}
    assert _hub_rows(eng) == _hub_rows(jeng)
    final = _hub_rows(eng)[-1][1]
    assert final['engine_tenant_finished_total{tenant="batch"}'] == 3
