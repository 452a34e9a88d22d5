# Copied from the JAX package: paddle_tpu/observability/httpd.py
# (stdlib only). Keep it in step with that file; its one change
# rewords the comment on the deferred profiler import.
"""Live metrics endpoint: a stdlib http.server daemon thread serving the
process's observability state while it trains.

The PR 1 registry is scrapeable only via file dumps
(PADDLE_TPU_METRICS_DIR); a production deployment wants a live pull
target. Routes:

  GET /metrics      Prometheus text exposition of the default registry
  GET /healthz      JSON from health.status(); HTTP 200 while "ok",
                    503 once "degraded" (anomaly-aware, so a k8s
                    liveness/readiness probe sees divergence directly)
  GET /events?n=K[&kind=X]
                    last K events from the in-memory ring, one JSON
                    object per line (newline-delimited JSON)
  GET /v1/slo       SLO burn-rate status (PROFILE.md §Time series &
                    SLOs): per-objective state, windows and burn rates
                    from the background evaluator (or a transient
                    evaluation when only the env is configured)

Env gating: PADDLE_TPU_METRICS_PORT. Unset/empty → no server, no
socket. "0" → bind an ephemeral port (tests); any other integer → that
port. `maybe_start_http_server()` is called from the telemetry hot-path
helpers, so setting the env var before training is enough — nothing is
started at import time (guarded by tests/test_obs_import_cost.py).

Server lifecycle (locked idempotent start/stop, failed-bind caching,
atexit cleanup, 127.0.0.1 default bind overridable with
PADDLE_TPU_METRICS_HOST) lives in the shared `httpbase.HTTPServerHandle`
— the serving frontend (`paddle_tpu/serving/httpd.py`) reuses the same
base.
"""

from __future__ import annotations

import json
from typing import Optional
from urllib.parse import parse_qs, urlparse

from . import events as _events
from . import health as _health
from . import httpbase as _base
from . import metrics as _m

__all__ = ["start_http_server", "maybe_start_http_server",
           "stop_http_server", "server_port", "handle_profile_request"]

PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class _Handler(_base.QuietHandler):
    server_version = "paddle-tpu-metrics"

    def do_GET(self):  # noqa: N802 - stdlib naming
        try:
            url = urlparse(self.path)
            if url.path == "/metrics":
                self._reply(200, PROM_CONTENT_TYPE,
                            _m.render_prometheus())
            elif url.path == "/healthz":
                st = _health.status()
                code = 200 if st["status"] == "ok" else 503
                self._reply(code, "application/json",
                            json.dumps(st) + "\n")
            elif url.path == "/events":
                q = parse_qs(url.query)
                try:
                    n = int(q.get("n", ["100"])[0])
                except ValueError:
                    n = 100
                kind = q.get("kind", [None])[0]
                lines = [json.dumps(e, default=str)
                         for e in _events.recent(n=n, kind=kind)]
                self._reply(200, "application/x-ndjson",
                            "\n".join(lines) + ("\n" if lines else ""))
            elif url.path == "/v1/slo":
                from . import slo as _slo

                st = _slo.status_snapshot()
                self._reply(200 if "error" not in st else 503,
                            "application/json",
                            json.dumps(_m._json_safe(st)) + "\n")
            else:
                self._reply(404, "text/plain",
                            "not found; routes: /metrics /healthz "
                            "/events?n=K /v1/slo "
                            "POST /v1/profile\n")
        except _base.CLIENT_GONE:
            pass  # scraper hung up mid-reply

    def do_POST(self):  # noqa: N802 - stdlib naming
        try:
            if urlparse(self.path).path != "/v1/profile":
                self._reply(404, "text/plain",
                            "not found; POST routes: /v1/profile\n")
                return
            code, body = handle_profile_request(self)
            self._reply(code, "application/json", body)
        except _base.CLIENT_GONE:
            pass  # caller hung up mid-capture


def handle_profile_request(handler) -> tuple:
    """Shared POST /v1/profile implementation: parse {"seconds": N}
    from the request body, run one bounded capture, reply with the
    artifact paths. Returns (http_code, json_body). Used by this
    metrics server AND the serving frontend (serving/httpd.py), so a
    fleet router can profile a replica through the same port it routes
    inference to. The handler thread blocks for the window —
    ThreadingHTTPServer keeps every other route live meanwhile."""
    try:
        n = int(handler.headers.get("Content-Length") or 0)
        req = json.loads(handler.rfile.read(n) or b"{}") if n else {}
        if not isinstance(req, dict):
            raise ValueError("body must be a JSON object")
        seconds = float(req.get("seconds", 1.0))
    except (ValueError, TypeError) as e:
        return 400, json.dumps(
            {"error": f"bad request: {e}"}) + "\n"
    # deferred: profiler pulls in torch; this module stays import-light
    from .. import profiler as _profiler

    try:
        out = _profiler.capture_profile(seconds)
    except _profiler.ProfilerBusyError as e:
        return 409, json.dumps({"error": str(e)}) + "\n"
    except Exception as e:
        return 500, json.dumps(
            {"error": f"capture failed: {e}"}) + "\n"
    return 200, json.dumps(out, default=str) + "\n"


_handle = _base.HTTPServerHandle(
    _Handler, thread_name="paddle-tpu-metrics-http",
    port_env="PADDLE_TPU_METRICS_PORT", host_env="PADDLE_TPU_METRICS_HOST")


def server_port() -> Optional[int]:
    """Bound port of the running server, or None when no server is up."""
    return _handle.port()


def start_http_server(port: int = 0, host: Optional[str] = None) -> int:
    """Start the daemon serving thread (idempotent: a second call returns
    the already-bound port). port=0 binds an ephemeral port. Returns the
    actual bound port."""
    return _handle.start(port, host)


def maybe_start_http_server() -> bool:
    """Start the server iff PADDLE_TPU_METRICS_PORT is set and none is
    running. Called from the telemetry hot-path helpers; the unset case
    is a single env dict lookup."""
    return _handle.maybe_start()


def stop_http_server():
    _handle.stop()
