"""Streaming ``/metrics`` endpoint: stdlib-only Prometheus exposition.
The port's copy of ``repro/obs/http.py``.

A :class:`MetricsServer` runs a daemonized ``ThreadingHTTPServer`` that
renders the process-global :class:`~repro_torch.obs.metrics.MetricsRegistry`
(or an explicitly bound one) on every ``GET /metrics``.  Scraping is
read-only and lock-free on the serving path: the registry's counters
are plain dict updates, and ``render()`` snapshots whatever values the
scrape observes -- the standard Prometheus contract (each sample is
individually consistent, the set is not atomic).

Stdlib only (``http.server``): the container bakes no web framework,
and a pull-based text endpoint needs none.

Use::

    srv = serve_metrics(port=9108)      # 0 picks an ephemeral port
    print(srv.port)
    ...
    srv.stop()

or via ``launch/serve.py --metrics-port``.
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from repro_torch.obs import metrics as obs_metrics


class MetricsServer:
    """Background HTTP listener exposing Prometheus text metrics.

    ``registry=None`` (the default) re-reads the module-global
    ``repro_torch.obs.metrics.METRICS`` on every request, so a server started
    before ``enable_metrics()`` begins serving real data the moment
    metrics are enabled (and 503s until then).
    """

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 registry=None):
        self._registry = registry
        self._thread: Optional[threading.Thread] = None

        server = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):          # noqa: N802 (http.server API)
                if self.path.split("?", 1)[0] not in ("/", "/metrics"):
                    self.send_error(404, "try /metrics")
                    return
                reg = server._registry or obs_metrics.METRICS
                if reg is None:
                    body = b"metrics disabled (call enable_metrics())\n"
                    self.send_response(503)
                else:
                    body = reg.render().encode("utf-8")
                    self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # silent: scrapes are periodic
                pass

        self._httpd = ThreadingHTTPServer((host, int(port)), Handler)
        self._httpd.daemon_threads = True

    @property
    def port(self) -> int:
        """The bound port (useful with ``port=0``)."""
        return self._httpd.server_address[1]

    def start(self) -> "MetricsServer":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._httpd.serve_forever, name="repro-metrics",
                daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        """Shut the listener down and join its thread (idempotent)."""
        if self._thread is not None:
            self._httpd.shutdown()
            self._thread.join(timeout=5.0)
            self._thread = None
        self._httpd.server_close()


def serve_metrics(port: int = 0, host: str = "127.0.0.1",
                  registry=None) -> MetricsServer:
    """Start a :class:`MetricsServer` (returns it already listening)."""
    return MetricsServer(port=port, host=host, registry=registry).start()
