"""Lightweight HTTP health/metrics endpoint for the aggregation server, a
copy of the JAX package's ``serve/health.py``: ``GET /health`` answers
liveness + round progress, ``GET /metrics`` the full metrics snapshot, both
as JSON. Stdlib-only (``http.server`` on a daemon thread), bound to
127.0.0.1; port 0 binds an ephemeral port."""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict

_HEALTH_KEYS = ("status", "round", "rounds_total", "rounds_completed",
                "updates_accepted", "updates_per_sec")


class HealthEndpoint:
    """Serve ``snapshot_fn()`` over HTTP. The callable must be cheap and
    thread-safe — it runs on request-handler threads."""

    def __init__(self, snapshot_fn: Callable[[], Dict[str, Any]],
                 host: str = "127.0.0.1", port: int = 0):
        self._snapshot_fn = snapshot_fn
        endpoint = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (http.server API)
                try:
                    snap = endpoint._snapshot_fn()
                except Exception as e:  # surface, don't kill the handler
                    self._reply(500, {"status": "error", "error": repr(e)})
                    return
                if self.path.rstrip("/") in ("", "/health"):
                    body = {k: snap[k] for k in _HEALTH_KEYS if k in snap}
                    body.setdefault("status", "live")
                    self._reply(200, body)
                elif self.path.rstrip("/") == "/metrics":
                    self._reply(200, snap)
                else:
                    self._reply(404, {"error": f"no route {self.path!r}"})

            def _reply(self, code: int, body: Dict[str, Any]):
                data = json.dumps(body).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, *a):  # keep request noise out of stderr
                pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]
        self._thread: threading.Thread | None = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="serve-health", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
