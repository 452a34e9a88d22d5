# Copied from the JAX package: paddle_tpu/observability/httpbase.py
# (stdlib only). Keep it in step with that file.
"""Shared stdlib-HTTP plumbing for in-process daemon servers.

Two servers live inside a paddle_tpu process: the observability
endpoint (`observability/httpd.py`, /metrics /healthz /events) and the
inference frontend (`serving/httpd.py`, /v1/predict /v1/status). Both
need the same lifecycle discipline — silent request logging, a locked
idempotent start that returns the bound port, failed-bind caching so an
env-gated hot path never retries the bind syscall every step, an
idempotent stop, and atexit cleanup — so that discipline lives here
once instead of being copy-drifted per server.

Stdlib-only by contract: this module is imported by the telemetry hot
path before the rest of the package finishes initializing.
"""

from __future__ import annotations

import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

__all__ = ["CLIENT_GONE", "QuietHandler", "HTTPServerHandle"]

# A scraper/client hanging up mid-reply is routine, not an error;
# handlers wrap their do_* bodies in `except CLIENT_GONE: pass`.
CLIENT_GONE = (BrokenPipeError, ConnectionResetError)


class QuietHandler(BaseHTTPRequestHandler):
    """BaseHTTPRequestHandler that never writes to stderr and replies
    with explicit Content-Length (scrapes every few seconds must not
    spam logs, and chunked replies confuse minimal clients)."""

    def log_message(self, format, *args):  # noqa: A002 - stdlib signature
        pass

    def _reply(self, code: int, content_type: str, body: str,
               extra_headers=None):
        data = body.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        for name, value in (extra_headers or {}).items():
            self.send_header(name, value)
        self.end_headers()
        self.wfile.write(data)


class _DeepBacklogServer(ThreadingHTTPServer):
    """ThreadingHTTPServer with a deep listen backlog: socketserver's
    default of 5 drops SYNs under a concurrent-connect burst, turning
    overload into ~1s TCP retransmit stalls for EVERY caller — before
    QoS admission (which can only order connections the kernel
    accepted) gets a say."""

    request_queue_size = 128


class HTTPServerHandle:
    """Lifecycle for one ThreadingHTTPServer daemon thread.

    `start()` is idempotent (a second call returns the already-bound
    port), `stop()` is idempotent and joins the serve thread, and
    `maybe_start()` implements env-gated startup with failed-bind
    caching for callers on a hot path: a port that was taken once is
    not re-bound every step until `stop()` clears the marker.

    Binds 127.0.0.1 by default (overridable via `host_env`) — exposing
    process internals on all interfaces is an operator decision, not a
    default.
    """

    def __init__(self, handler_cls, thread_name: str,
                 port_env: Optional[str] = None,
                 host_env: Optional[str] = None,
                 default_host: str = "127.0.0.1"):
        self._handler_cls = handler_cls
        self._thread_name = thread_name
        self._port_env = port_env
        self._host_env = host_env
        self._default_host = default_host
        # This module is imported (and the observability handle
        # INSTANTIATED) while the package is still bootstrapping, so the
        # sanitizer factory is best-effort AND gated on the raw env var:
        # at level 0 (the default) nothing beyond stdlib is imported,
        # and during early init a failing analysis import degrades to
        # the raw primitive (the stdlib-only contract holds either way).
        self._lock = threading.Lock()
        if os.environ.get("PADDLE_TPU_LOCKCHECK", "0") not in ("", "0"):
            try:
                from ..analysis import lockcheck as _lockcheck

                self._lock = _lockcheck.Lock(
                    "observability.httpbase.HTTPServerHandle._lock")
            except ImportError:  # mid-bootstrap: plain primitive stays
                pass  # lint-exempt:swallow: best-effort instrumentation
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._atexit_registered = False
        self._start_failed = False

    def port(self) -> Optional[int]:
        """Bound port of the running server, or None when none is up."""
        with self._lock:
            if self._server is None:
                return None
            return self._server.server_address[1]

    def start(self, port: int = 0, host: Optional[str] = None) -> int:
        """Start the daemon serving thread (idempotent: a second call
        returns the already-bound port). port=0 binds an ephemeral port.
        Returns the actual bound port."""
        with self._lock:
            if self._server is not None:
                return self._server.server_address[1]
            if host is None and self._host_env:
                host = os.environ.get(self._host_env)
            host = host or self._default_host
            srv = _DeepBacklogServer((host, int(port)),
                                     self._handler_cls)
            srv.daemon_threads = True
            t = threading.Thread(target=srv.serve_forever,
                                 name=self._thread_name, daemon=True)
            t.start()
            self._server, self._thread = srv, t
            if not self._atexit_registered:
                import atexit

                atexit.register(self.stop)
                self._atexit_registered = True
            return srv.server_address[1]

    def maybe_start(self) -> bool:
        """Start the server iff `port_env` is set in the environment and
        none is running. Safe on a hot path: the unset case is a single
        env dict lookup, and a failed bind is remembered rather than
        retried every call."""
        if not self._port_env:
            return False
        raw = os.environ.get(self._port_env)
        if not raw:
            return False
        with self._lock:
            if self._server is not None:
                return True
            if self._start_failed:
                return False  # port was taken once; don't re-bind per step
        try:
            port = int(raw)
        except ValueError:
            return False  # malformed env must not kill the hot path
        if port < 0:
            return False
        try:
            self.start(port)
        except OSError:
            self._start_failed = True  # cleared by stop()
            return False  # port taken: keep running, serving is best-effort
        return True

    def stop(self):
        """Shut the server down and join its thread; idempotent, and
        clears the failed-bind marker so a later start can retry. Also
        unregisters the atexit hook — per-instance handles (one per
        serving.Server) must not pin stopped servers in memory for the
        process lifetime."""
        with self._lock:
            srv, self._server = self._server, None
            t, self._thread = self._thread, None
            self._start_failed = False
            if self._atexit_registered:
                import atexit

                atexit.unregister(self.stop)
                self._atexit_registered = False
        if srv is not None:
            srv.shutdown()
            srv.server_close()
        if t is not None and t.is_alive():
            t.join(timeout=5)
