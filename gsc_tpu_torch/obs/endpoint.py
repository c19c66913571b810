"""Live /metrics endpoint: a standard-library HTTP server over the hub.

The port of ``gsc_tpu.obs.endpoint``.  It serves the hub snapshot in
Prometheus text exposition (the flat names are already
``gsc_<name>{tag="v",...}``) while a run executes, read-only on a daemon
thread: the handler only calls ``hub.snapshot()``, so a wedged scraper
cannot stall the training loop.  ``RunObserver(metrics_port=...)`` /
``cli train --metrics-port`` wire it.

Routes: ``/metrics`` (Prometheus text), ``/healthz`` (JSON liveness),
``/series`` (JSON query over the hub's series rings:
``/series?name=<bare metric>&since=<unix ts>``, both optional; 404 when
the hub keeps no series, 400 on a bad ``since``).
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict
from urllib.parse import parse_qs, urlparse

# the exposition version Prometheus scrapers negotiate on
PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def prometheus_text(snapshot: Dict[str, float]) -> str:
    """Hub snapshot -> Prometheus text exposition (one series per line;
    names from ``hub.flat_name`` are already ``name{label="v"}``)."""
    lines = []
    for name, value in sorted(snapshot.items()):
        try:
            lines.append(f"{name} {float(value)}")
        except (TypeError, ValueError):
            continue
    return "\n".join(lines) + "\n"


class _Handler(BaseHTTPRequestHandler):
    # one hub read per request; the server object carries the hub ref
    def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler API
        path = self.path.split("?", 1)[0].rstrip("/") or "/"
        if path in ("/metrics", "/"):
            body = prometheus_text(self.server.hub.snapshot()).encode()
            self._reply(200, PROM_CONTENT_TYPE, body)
        elif path == "/healthz":
            body = json.dumps({"status": "ok",
                               "series": len(self.server.hub.snapshot()),
                               }).encode()
            self._reply(200, "application/json", body)
        elif path == "/series":
            self._reply_series()
        else:
            self._reply(404, "text/plain",
                        b"not found (routes: /metrics, /healthz, "
                        b"/series)\n")

    def _reply_series(self):
        """Read-only JSON history query — the autoscaler-shaped consumer
        interface (same payload shape as the on-disk ``series.json``).
        One store read per request; never touches the training loop."""
        store = getattr(self.server.hub, "series_store", None)
        if store is None:
            self._reply(404, "application/json", json.dumps(
                {"error": "series history disabled "
                          "(hub has no series window)"}).encode())
            return
        query = parse_qs(urlparse(self.path).query)
        name = (query.get("name") or [None])[0] or None
        since = None
        raw = (query.get("since") or [None])[0]
        if raw:
            try:
                since = float(raw)
            except ValueError:
                self._reply(400, "application/json", json.dumps(
                    {"error": f"bad since={raw!r} (want a unix "
                              "timestamp)"}).encode())
                return
        doc = store.document(run=self.server.hub.base_tags.get("run"))
        if name is not None or since is not None:
            doc["series"] = store.query(name=name, since=since)
        self._reply(200, "application/json", json.dumps(doc).encode())

    def _reply(self, code: int, ctype: str, body: bytes):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):   # scrapes must not spam the run log
        pass


class MetricsEndpoint:
    """Background HTTP server exposing one hub.  ``port=0`` binds an
    ephemeral port (tests; the bound port is read back from ``.port``
    after :meth:`start`)."""

    def __init__(self, hub, port: int = 0, host: str = "127.0.0.1"):
        self.hub = hub
        self.host = host
        self.port = int(port)
        self._server = None
        self._thread = None

    def start(self) -> "MetricsEndpoint":
        server = ThreadingHTTPServer((self.host, self.port), _Handler)
        server.daemon_threads = True
        server.hub = self.hub
        self.port = server.server_address[1]
        self._server = server
        self._thread = threading.Thread(target=server.serve_forever,
                                        name="gsc-metrics-endpoint",
                                        daemon=True)
        self._thread.start()
        return self

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/metrics"

    def stop(self):
        server, self._server = self._server, None
        if server is not None:
            server.shutdown()
            server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
