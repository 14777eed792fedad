"""The port's telemetry layer against the reference's (``repro.obs``):
the registry covering the port's stack with the reference's specs, the
in-graph counter and histogram ops, the tiered tap over a reference
stacked store against the port's one metadata copy with ``copies=L``,
``stashed_metrics`` against the direct tap (and its snapshot surviving
in-place updates), ``metadata_pages`` and the ``migrate_hot`` shim, the
hub's snapshot, deltas, JSONL and Prometheus text byte for byte on the
same records, label escaping, the tracer's JSON, SLO parsing and burn
rates, ``TenantBook.metrics``, the endpoint server, ``profiler_trace``
and the launcher's telemetry flags on the CPU."""

import json
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.policy.scheduler  # noqa: F401  (registers its family)
import repro.core.remap.irt  # noqa: F401
import repro.core.remap.rcache  # noqa: F401
import repro.serve.engine  # noqa: F401
import repro.serve.sched.qos  # noqa: F401
import repro.tiered.kvcache  # noqa: F401
from repro import obs as jobs
from repro.obs import metrics as jmetrics
from repro.obs import registry as jregistry
from repro.obs import trace as jtrace
from repro.serve import tiered as jsrv
from repro.serve.engine import Request as JRequest
from repro.serve.sched import TenantBook as JTenantBook
from repro.serve.sched import TenantConfig as JTenantConfig
from repro.tiered import kvcache as jk
from repro_torch import obs as tobs
from repro_torch.obs import metrics, registry, trace
from repro_torch.serve import tiered as srv
from repro_torch.serve.engine import Request
from repro_torch.serve.sched import TenantBook, TenantConfig
from repro_torch.tiered import kvcache as tk

# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

# tests/test_obs.py's required set
REQUIRED = {
    "trimma_translated_pages_total", "trimma_irc_hits_total",
    "trimma_irc_misses_total", "trimma_irt_walks_total",
    "trimma_dev_table_hits_total", "trimma_migrations_total",
    "trimma_promoted_bytes_total", "trimma_demoted_bytes_total",
    "trimma_fast_resident_pages", "trimma_metadata_pages",
    "engine_steps_total", "engine_tokens_total",
    "engine_request_latency_ms", "engine_token_latency_ms",
    "engine_tenant_admitted_total",
}


def test_registry_covers_the_ports_stack_with_reference_specs():
    import repro_torch.core.policy.scheduler  # noqa: F401
    import repro_torch.core.remap.irt  # noqa: F401
    import repro_torch.core.remap.rcache  # noqa: F401
    import repro_torch.serve.engine  # noqa: F401
    import repro_torch.serve.sched.qos  # noqa: F401
    import repro_torch.tiered.kvcache  # noqa: F401
    names = set(registry.registered())
    assert REQUIRED <= names, sorted(REQUIRED - names)
    # obs_* names are the two test files' own ad-hoc metrics
    ref = {n: s for n, s in jregistry.registered().items()
           if not n.startswith("obs_")}
    names = {n for n in names if not n.startswith("obs_")}
    assert names == set(ref)
    for n in names:
        assert vars(registry.spec(n)) == vars(ref[n]), n
    assert registry.sim_counter_keys() == jregistry.sim_counter_keys()
    c = {k: i for i, k in enumerate(registry.sim_counter_keys())}
    assert registry.sim_export(c) == jregistry.sim_export(c)


def test_register_conflict_and_inferred_specs():
    registry.register(registry.MetricSpec("obs_port_metric_x", "counter",
                                          "a test metric"))
    registry.register(registry.MetricSpec("obs_port_metric_x", "counter",
                                          "a test metric"))
    with pytest.raises(ValueError):
        registry.register(registry.MetricSpec("obs_port_metric_x", "gauge",
                                              "another"))
    for n in ("obs_never_declared_total", "obs_never_declared"):
        assert vars(registry.spec(n)) == vars(jregistry.spec(n))


# ---------------------------------------------------------------------------
# in-graph ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_hist_observe_matches_reference(seed):
    rng = np.random.default_rng(seed)
    vals = np.concatenate([rng.exponential(8.0, 40),
                           np.asarray(metrics.HIST_EDGES_MS), [0.0, 1e6]])
    vals = vals.astype(np.float32)
    en = rng.random(vals.size) < 0.7
    a = jmetrics.hist_observe(jmetrics.hist_zeros(), jnp.asarray(vals),
                              jnp.asarray(en))
    a = jmetrics.hist_observe(a, jnp.asarray(vals[:5]))
    b = metrics.hist_observe(metrics.hist_zeros(), torch.from_numpy(vals),
                             torch.from_numpy(en))
    b = metrics.hist_observe(b, torch.from_numpy(vals[:5]))
    np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert metrics.HIST_EDGES_MS == jmetrics.HIST_EDGES_MS
    for v in (0.0, 0.2499, 0.25, 511.9, 512.0, 1e9):
        assert metrics.bucket_index(v) == jmetrics.bucket_index(v)


def test_counter_ops_match_reference():
    names = ["a_total", "b_total"]
    en = np.array([True, False, True, True])
    ja, ta = jmetrics.zeros(names), metrics.zeros(names)
    ja = jmetrics.inc(jmetrics.inc(ja, "a_total"), "b_total", delta=3,
                      enable=jnp.asarray(en))
    ta = metrics.inc(metrics.inc(ta, "a_total"), "b_total", delta=3,
                     enable=torch.from_numpy(en))
    ja2 = jmetrics.inc(ja, "a_total", delta=jnp.int32(5))
    ta2 = metrics.inc(ta, "a_total", delta=torch.tensor(5))
    for got, want in ((ta, ja), (ta2, ja2),
                      (metrics.merge(ta, ta2), jmetrics.merge(ja, ja2)),
                      (metrics.delta(ta2, ta), jmetrics.delta(ja2, ja))):
        assert {k: int(v) for k, v in got.items()} \
            == {k: int(v) for k, v in want.items()}
        assert all(v.dtype == torch.int32 for v in got.values())
    assert int(metrics.bump(torch.tensor(2, dtype=torch.int32), 3)) == 5
    with pytest.raises(ValueError):
        metrics.merge(ta, {"a_total": ta["a_total"]})


# ---------------------------------------------------------------------------
# taps
# ---------------------------------------------------------------------------

GEOM = dict(n_seqs=2, max_pages_per_seq=16, page_tokens=8, n_kv_heads=2,
            head_dim=16, fast_data_slots=4, migrate_threshold=1,
            dtype="float32")


def _stores():
    """tests/test_obs.py's tiny store, built by the same ops in both
    packages: three lookups (hot), ``migrate_hot``, one more lookup (iRC
    and iRT traffic); the port's states after each op."""
    jcfg, tcfg = jk.TieredConfig(**GEOM), tk.TieredConfig(**GEOM)
    js, ts = jk.init_state(jcfg), tk.init_state(tcfg, "cpu")
    ids = np.arange(2)[:, None] * 16 + np.arange(4)[None, :]
    seen = []
    for op in ("lookup",) * 3 + ("migrate_hot", "lookup"):
        if op == "lookup":
            _, js = jk.lookup(jcfg, js, jnp.asarray(ids, jnp.int32))
            _, ts = tk.lookup(tcfg, ts, torch.from_numpy(ids).to(torch.int32))
        else:
            js = jk.migrate_hot(jcfg, js, max_moves=2)
            ts = tk.migrate_hot(tcfg, ts, max_moves=2)
        seen.append(ts)
    return jcfg, js, tcfg, ts, seen


def test_tap_metadata_pages_and_migrate_hot_match_reference():
    jcfg, js, tcfg, ts, _ = _stores()
    want = {k: float(v) for k, v in jsrv.metrics(jcfg, js).items()}
    got = srv.metrics(tcfg, ts)
    assert got == want
    assert got["trimma_migrations_total"] > 0
    assert got["trimma_metadata_pages"] > 0
    assert isinstance(got["trimma_migrations_total"], int)
    assert int(tk.metadata_pages(tcfg, ts)) \
        == int(jk.metadata_pages(jcfg, js)) == got["trimma_metadata_pages"]
    for f in ("leaf_table", "slot_owner", "leaf_cnt", "l1_bits", "touch"):
        np.testing.assert_array_equal(np.asarray(getattr(js, f)),
                                      getattr(ts, f).numpy(), f)


@pytest.mark.parametrize("L", [2, 3])
def test_tap_of_one_copy_equals_reference_stacked_sum(L):
    """The reference sums L layer copies; the port scales its one copy:
    counts and byte gauges by L, the ratio gauges unchanged."""
    jcfg, js, tcfg, ts, _ = _stores()
    stacked = jax.tree.map(lambda x: jnp.stack([x] * L), js)
    want = {k: float(v) for k, v in jsrv.metrics(jcfg, stacked).items()}
    got = srv.metrics(tcfg, ts, copies=L)
    assert got == want
    one = srv.metrics(tcfg, ts)
    for k in ("trimma_identity_entry_ratio", "trimma_irt_leaf_occupancy"):
        assert got[k] == one[k]


def test_stashed_metrics_equals_direct_tap_and_survives_updates():
    """A batch of stashes (the drain's one transfer) gives each state's
    direct tap; a stash does not move when its state is then updated in
    place."""
    _, _, tcfg, _, seen = _stores()
    geo = dict(n_logical=tcfg.n_logical, fast_slots=tcfg.fast_slots,
               leaf_entries=tk.E, copies=4)
    stashes = [metrics.tap_stash(st) for st in seen]
    want = [metrics.tiered_metrics(st, tcfg.page_bytes, **geo)
            for st in seen]
    batch = metrics.stashed_metrics(stashes, tcfg.page_bytes, **geo)
    assert [{k: v[i] for k, v in batch.items()} for i in range(len(seen))] \
        == want
    assert set(stashes[0]) == set(metrics.TAP_FIELDS) \
        == set(jmetrics.TAP_FIELDS)
    last = seen[-1]
    last.slot_owner.fill_(tk.INVALID)
    last.leaf_cnt.zero_()
    last.lookups.add_(100)
    again = metrics.stashed_metrics(stashes[-1:], tcfg.page_bytes, **geo)
    assert {k: v[0] for k, v in again.items()} == want[-1]
    assert metrics.stashed_metrics([], tcfg.page_bytes) == {}


# ---------------------------------------------------------------------------
# hub
# ---------------------------------------------------------------------------

def _drive_hub(mod, cfg_kw):
    """The same records, samples and exports through a hub of ``mod``."""
    hub = mod.MetricsHub(mod.ObsConfig(**cfg_kw))
    hub.record({"trimma_irc_hits_total": 10, "trimma_fast_resident_pages": 3})
    hub.set("engine_queue_depth", 3)
    hub.sample(step=1, ts=100.0)
    hub.record({"trimma_irc_hits_total": 25})
    hub.set("engine_tenant_tokens_total", 11, labels={"tenant": "a"})
    hub.set("engine_slo_burn_rate", 1.5,
            labels={"tenant": 'q"u\\o\nte', "stat": "latency"})
    hub.observe_hist("engine_token_latency_ms", metrics.HIST_EDGES_MS,
                     list(range(metrics.HIST_BUCKETS)), 123.5)
    hub.sample(step=2, ts=101.0)
    hub.set("trimma_identity_entry_ratio", 0.9375)
    hub.finalize(step=3)
    return hub


def test_hub_matches_reference_byte_for_byte(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1000.0)
    outs = {}
    for name, mod in (("ref", jobs), ("port", tobs)):
        kw = dict(prom_path=str(tmp_path / f"{name}.prom"),
                  jsonl_path=str(tmp_path / f"{name}.jsonl"))
        hub = _drive_hub(mod, kw)
        outs[name] = (hub.snapshot(), hub.delta(), hub.series,
                      hub.to_prometheus(),
                      (tmp_path / f"{name}.prom").read_bytes(),
                      (tmp_path / f"{name}.jsonl").read_bytes())
    assert outs["port"] == outs["ref"]
    text = outs["port"][3]
    assert tobs.parse_prometheus(text) == jobs.parse_prometheus(text)
    rows = [json.loads(x) for x in outs["port"][5].decode().splitlines()]
    assert [r["step"] for r in rows] == [1, 2, 3]
    assert rows[1]["deltas"]["trimma_irc_hits_total"] == 15


def test_label_escaping_round_trips_as_reference():
    evil = 'a"b\\c\nd'
    for mod in (jobs, tobs):
        hub = mod.MetricsHub()
        hub.set("engine_queue_depth", 1, labels={"tenant": evil})
        parsed = tobs.parse_prometheus(hub.to_prometheus())
        assert parsed["series"]["engine_queue_depth"][0]["labels"] \
            == {"tenant": evil}
    key = 'x_total{a="q\\"uote",b="back\\\\slash",c="new\\nline"}'
    assert tobs.parse_labels(key) == jobs.parse_labels(key)


# ---------------------------------------------------------------------------
# tracer
# ---------------------------------------------------------------------------

def _drive_tracer(mod, path):
    tr = mod.StepTracer(process_name="engine")
    with tr.span("decode_step", step=1):
        pass
    with tr.span("maintain", step=2, phase="plan"):
        pass
    with tr.span("custom", tid=7, lane=0):
        pass
    tr.counter("trimma_pages", {"fast_resident": 4}, ts=10.0)
    tr.instant("drain", n=3)
    tr.save(str(path))
    return path.read_bytes()


def test_tracer_json_matches_reference(tmp_path, monkeypatch):
    out = []
    for mod, name in ((jtrace, "ref"), (trace, "port")):
        clock = iter(range(1000))     # the same clock readings for each
        monkeypatch.setattr(time, "perf_counter",
                            lambda: next(clock) * 1e-3)
        out.append(_drive_tracer(mod, tmp_path / f"{name}.json"))
    ref, port = out
    assert port == ref
    evs = json.loads(port)["traceEvents"]
    assert {e["name"] for e in evs if e["ph"] == "X"} \
        == {"decode_step", "maintain", "custom"}
    nt = trace.NULL_TRACER
    with nt.span("decode_step"):
        pass
    nt.counter("x", {})
    nt.clear()
    with pytest.raises(RuntimeError):
        nt.save("unused.json")


def test_profiler_trace_writes_a_chrome_trace(tmp_path):
    with trace.profiler_trace(str(tmp_path / "prof")):
        with trace.annotate("tiny_matmul"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    doc = json.loads((tmp_path / "prof" / "trace.json").read_text())
    names = {e.get("name") for e in doc["traceEvents"]}
    assert "tiny_matmul" in names
    with trace.profiler_trace(None):
        pass


# ---------------------------------------------------------------------------
# SLOs and tenant books
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [
    "interactive:latency:250:0.95:16,*:ttft:500", "*:latency:100:0.9:10",
    "t:latency:100:0.5:4", "", None])
def test_parse_slos_and_burn_rates_match_reference(spec):
    a, b = jobs.parse_slos(spec), tobs.parse_slos(spec)
    assert [vars(x) for x in a] == [vars(x) for x in b]
    ja, tb = jobs.SLOMonitor(a), tobs.SLOMonitor(b)
    rng = np.random.default_rng(4)
    for _ in range(40):
        t = ("a", "interactive", "t")[int(rng.integers(0, 3))]
        lat, ttft = float(rng.exponential(200)), float(rng.exponential(400))
        ja.observe(t, latency_ms=lat, ttft_ms=ttft)
        tb.observe(t, latency_ms=lat, ttft_ms=ttft)
    assert tb.summary() == ja.summary()
    h1, h2 = jobs.MetricsHub(), tobs.MetricsHub()
    ja.export(h1)
    tb.export(h2)
    assert h2.to_prometheus() == h1.to_prometheus()


def test_parse_slos_rejects_as_reference():
    with pytest.raises(ValueError):
        tobs.parse_slos("tenant-only:latency")
    with pytest.raises(AssertionError):
        tobs.parse_slos("a:throughput:5")


def test_tenant_book_metrics_match_reference():
    names = ("t0", "t1", "t2")
    jb = JTenantBook(tuple(JTenantConfig(n, weight=w)
                           for n, w in zip(names, (3, 1, 2))), 4)
    tb = TenantBook(tuple(TenantConfig(n, weight=w)
                          for n, w in zip(names, (3, 1, 2))), 4)
    rng = np.random.default_rng(6)
    for rid in range(30):
        tenant = names[int(rng.integers(0, 3))]
        for book, make in ((jb, JRequest), (tb, Request)):
            book.submit(make(rid=rid, prompt=np.zeros(1, np.int32),
                             max_new=1, tenant_id=tenant, arrived=float(rid)))
        if rid % 3 == 2:
            a, b = jb.pick(), tb.pick()
            a.tokens, b.tokens = [1] * rid, [1] * rid
            jb.finish(a)
            tb.finish(b)
    assert tb.metrics() == jb.metrics()
    h1, h2 = jobs.MetricsHub(), tobs.MetricsHub()
    for hub, book in ((h1, jb), (h2, tb)):
        for name, value, labels in book.metrics():
            hub.set(name, value, labels=labels)
    assert h2.to_prometheus() == h1.to_prometheus()


# ---------------------------------------------------------------------------
# endpoints and the launcher
# ---------------------------------------------------------------------------

def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.headers.get("Content-Type"), r.read().decode()


def test_obs_server_endpoints():
    from repro_torch.obs.http import ObsServer
    hub = tobs.MetricsHub()
    hub.record({"engine_steps_total": 7})
    hub.set("engine_queue_depth", 2, labels={"tenant": 'q"uo\\te'})
    server = ObsServer(metrics_fn=hub.to_prometheus,
                       health_fn=lambda: {"steps": 7},
                       state_fn=lambda: {"lanes": [None], "steps": 7})
    try:
        status, ctype, body = _get(server.url + "/metrics")
        assert status == 200 and "text/plain" in ctype
        assert body == hub.to_prometheus()
        status, ctype, body = _get(server.url + "/healthz")
        assert json.loads(body) == {"status": "ok", "steps": 7}
        _, _, body = _get(server.url + "/debug/state")
        assert json.loads(body) == {"lanes": [None], "steps": 7}
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(server.url + "/nope")
        assert e.value.code == 404
    finally:
        server.close()


def test_serve_launcher_telemetry_on_cpu(tmp_path, capsys):
    """The launcher's telemetry flags drive the tiered engine end to end:
    the exposition parses, the trace holds the engine phases, the flight
    and SLO summaries print, and the endpoints close after the run."""
    from repro_torch.launch import serve
    prom, tr = tmp_path / "p.txt", tmp_path / "t.json"
    serve.main(["--arch", "llama3-8b", "--smoke", "--device", "cpu",
                "--backend", "tiered", "--flight", "--prom-out", str(prom),
                "--trace-out", str(tr), "--metrics-jsonl",
                str(tmp_path / "m.jsonl"), "--http-port", "0", "--slo",
                "*:latency:1e9", "--requests", "4", "--max-new", "6"])
    out = capsys.readouterr().out
    assert "served 4 requests, 24 tokens" in out
    assert "obs: live endpoints at http://127.0.0.1:" in out
    assert "flight: " in out and "by_kind=" in out
    assert "slo: default/latency" in out and "OK" in out
    parsed = tobs.parse_prometheus(prom.read_text())
    assert parsed["samples"]["engine_tokens_total"] == 24
    assert parsed["samples"]["trimma_flight_events_total"] > 0
    phases = {e["name"] for e in json.loads(tr.read_text())["traceEvents"]
              if e["ph"] == "X"}
    assert {"decode_step", "prefill", "maintain", "release"} <= phases
    with pytest.raises(SystemExit, match="tiered"):
        serve.main(["--arch", "llama3-8b", "--smoke", "--device", "cpu",
                    "--flight"])
