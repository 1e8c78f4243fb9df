"""Scrape surface: ``/metrics`` (Prometheus text), ``/healthz``, ``/obs``,
``/slo``.

A stdlib ``ThreadingHTTPServer`` on a daemon thread — no dependency, no
event loop, good enough for a scraper hitting it once per interval. The
serving process stays the owner of all state; the handler only *reads*
(registry text dump, an optional ``extra`` callable for richer JSON like
``SpmvServer.dump_obs``, an optional ``slo`` callable for the tracker's
alert snapshot), so a slow scrape never blocks a request path. Request
logging goes through ``utils/logging.get_logger`` at debug level — the
stdlib default would spam stderr on every scrape.

``port=0`` binds an ephemeral port (tests and multi-instance fleets on one
host); the bound port is available as ``server.port`` after ``start()``.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable

from repro_torch.obs.metrics import MetricsRegistry, get_metrics
from repro_torch.utils.logging import get_logger

log = get_logger("obs.http")


class ObsHTTPServer:
    """Daemon-thread HTTP server exposing the process observability state."""

    def __init__(
        self,
        registry: MetricsRegistry | None = None,
        *,
        extra: Callable[[], dict] | None = None,
        slo: Callable[[], dict] | None = None,
        host: str = "127.0.0.1",
        port: int = 0,
    ):
        self.registry = registry if registry is not None else get_metrics()
        self.extra = extra
        self.slo = slo
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def _send(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 (http.server API)
                path = self.path.split("?", 1)[0]
                try:
                    if path == "/metrics":
                        self._send(
                            200,
                            outer.registry.to_prometheus().encode(),
                            "text/plain; version=0.0.4; charset=utf-8",
                        )
                    elif path == "/healthz":
                        self._send(
                            200, b'{"status": "ok"}\n', "application/json"
                        )
                    elif path == "/obs":
                        payload = {"metrics": outer.registry.snapshot()}
                        if outer.extra is not None:
                            payload.update(outer.extra())
                        self._send(
                            200,
                            (json.dumps(payload, default=str) + "\n").encode(),
                            "application/json",
                        )
                    elif path == "/slo":
                        if outer.slo is None:
                            self._send(
                                404, b"no slo tracker attached\n", "text/plain"
                            )
                        else:
                            self._send(
                                200,
                                (
                                    json.dumps(outer.slo(), default=str) + "\n"
                                ).encode(),
                                "application/json",
                            )
                    else:
                        self._send(404, b"not found\n", "text/plain")
                except Exception as exc:  # scrape must never kill the server
                    self._send(500, f"{exc}\n".encode(), "text/plain")

            def log_message(self, fmt, *args):  # route to our logger; the
                # stdlib default writes to stderr on every scrape. Format
                # eagerly and defensively: a %-literal in a request line must
                # not raise inside the logging machinery
                try:
                    msg = fmt % args
                except (TypeError, ValueError):
                    msg = " ".join((fmt, *map(str, args)))
                log.debug("http: %s", msg)

            log_error = log_message  # 4xx/5xx lines follow the same route

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "ObsHTTPServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="obs-http", daemon=True
        )
        self._thread.start()
        log.info(
            "observability endpoint on %s (/metrics /healthz /obs%s)",
            self.url,
            " /slo" if self.slo is not None else "",
        )
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
