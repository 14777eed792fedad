"""Live serving endpoints (port of ``repro.obs.http``, DESIGN.md §12): a
stdlib-threaded HTTP server that makes a RUNNING engine inspectable
without stopping it.

Routes:
  ``/metrics``      Prometheus text exposition 0.0.4, rendered from the
                    engine's ``MetricsHub`` at scrape time — the same
                    bytes ``hub.write_prometheus`` persists at drain;
  ``/healthz``      JSON liveness: ``{"status": "ok", ...}`` plus
                    whatever the health callback reports (steps,
                    active lanes);
  ``/debug/state``  JSON snapshot of the engine's live state: lanes,
                    tenant quotas, fast-pool occupancy, flight-recorder
                    analytics, SLO burn rates (``Engine.debug_state``).

The server runs daemon-threaded (``ThreadingHTTPServer``), so scrapes
never block the decode loop; callbacks execute on the request thread
and must therefore read engine state without mutating it (the engine
side guarantees this: hub renders are pure, ``debug_state`` reads host
books and the newest sample's cloned tensors, never the live state).  Sampling stays on the engine's cadence
— a scrape between samples sees the last published values, exactly
like a Prometheus scrape of any batch job.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional


class ObsServer:
    """Tiny observability endpoint server.

    ``metrics_fn`` returns the exposition text; ``health_fn`` a JSON-
    able liveness dict; ``state_fn`` the debug snapshot dict.  ``port``
    0 binds an ephemeral port (read it back from ``.port``)."""

    def __init__(self, *, metrics_fn: Callable[[], str],
                 health_fn: Optional[Callable[[], dict]] = None,
                 state_fn: Optional[Callable[[], dict]] = None,
                 host: str = "127.0.0.1", port: int = 0):
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):   # keep stdout clean
                pass

            def _send(self, code: int, body: str, ctype: str):
                data = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                try:
                    if path == "/metrics":
                        self._send(200, outer.metrics_fn(),
                                   "text/plain; version=0.0.4")
                    elif path == "/healthz":
                        body = {"status": "ok"}
                        if outer.health_fn is not None:
                            body.update(outer.health_fn())
                        self._send(200, json.dumps(body),
                                   "application/json")
                    elif path == "/debug/state":
                        body = (outer.state_fn()
                                if outer.state_fn is not None else {})
                        self._send(200,
                                   json.dumps(body, default=str),
                                   "application/json")
                    else:
                        self._send(404, json.dumps(
                            {"error": "not found", "routes": [
                                "/metrics", "/healthz", "/debug/state"]}),
                            "application/json")
                except Exception as e:          # endpoint must not crash
                    self._send(500, json.dumps({"error": repr(e)}),
                               "application/json")

        self.metrics_fn = metrics_fn
        self.health_fn = health_fn
        self.state_fn = state_fn
        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="obs-http",
            daemon=True)
        self._thread.start()

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        host = self._httpd.server_address[0]
        return f"http://{host}:{self.port}"

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)
