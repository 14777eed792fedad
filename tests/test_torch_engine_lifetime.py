"""An ``Engine`` is freed by reference counting alone.

Each case builds an engine on the CPU with Python's cyclic collector
switched off, serves a few requests, deletes the engine and checks that
a weak reference to it is dead: nothing holds the engine through a
cycle (a scheduler's back reference, a callback bound to the engine),
so on a card ``del engine`` releases its captured graphs, their memory
pool and its KV pools at once.  An engine with live endpoints takes its
HTTP server down with it: the port refuses connections and the server's
thread has ended.  The collector is switched back on in a
``finally``.  The card's side of the check is ``chip_smoke.py`` phase
15 (reserved memory falls after ``del`` with no ``gc.collect()``).
"""

import gc
import socket
import weakref

import numpy as np
import pytest

from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.models import init_params
from repro_torch.obs import ObsConfig
from repro_torch.obs.flight import FlightConfig
from repro_torch.serve.engine import Engine, EngineConfig, Request
from repro_torch.serve.sched import TenantConfig
from torch_threads import one_torch_thread  # noqa: F401

TENANTS = (TenantConfig("interactive", weight=2, policy="on_demand"),
           TenantConfig("batch", weight=1))
TIERED = dict(backend="tiered", page_tokens=8, fast_data_slots=8,
              maintain_every=2)
CASES = {
    "greedy": dict(),
    "greedy-tiered-obs": dict(**TIERED, flight=FlightConfig(capacity=64),
                              obs=ObsConfig(sample_every=2, http_port=0)),
    "chunked": dict(scheduler="chunked", prefill_chunk=8),
    "qos": dict(**TIERED, scheduler="chunked", prefill_chunk=8,
                admit_pages=2, tenants=TENANTS),
}


@pytest.fixture(scope="module")
def model():
    cfg = reduce_for_smoke(get_config("llama3-8b"))
    return cfg, init_params(cfg, "cpu", seed=0)


def _serve(cfg, params, name: str):
    """(A weak reference to an engine that served three requests, its
    obs server's port and thread or None), the engine itself gone."""
    eng = Engine(cfg, params, EngineConfig(batch=2, max_len=64,
                                           **CASES[name]), device="cpu")
    if name == "qos":
        # the QoS scheduler bound the multi-tenant pass at bind
        assert eng._tenant_parts is not None
    rng = np.random.default_rng(3)
    for rid in range(3):
        kw = {"tenant_id": TENANTS[rid % 2].name} if name == "qos" else {}
        eng.submit(Request(rid=rid, prompt=rng.integers(0, cfg.vocab, 12),
                           max_new=4, **kw))
    done = eng.run()
    assert len(done) == 3 and all(len(r.tokens) == 4 for r in done)
    srv = eng.obs_server
    server = None if srv is None else (srv.port, srv._thread)
    ref = weakref.ref(eng)
    del eng, srv
    return ref, server


@pytest.mark.parametrize("name", sorted(CASES))
def test_deleted_engine_is_freed_without_the_collector(name, model):
    cfg, params = model
    gc.collect()
    gc.disable()
    try:
        ref, server = _serve(cfg, params, name)
        assert ref() is None, [type(r).__name__
                               for r in gc.get_referrers(ref())]
        assert (server is None) == ("obs" not in name)
        if server is not None:
            port, thread = server
            assert not thread.is_alive()
            with pytest.raises(ConnectionRefusedError):
                socket.create_connection(("127.0.0.1", port), timeout=5)
    finally:
        gc.enable()
