"""JSON-over-HTTP token-serving front end.

Counterpart of the JAX package's `serving/httpd.py` for a decode-only
server. Routes:

  POST /v1/generate  {"ids": [tok,...], "max_new_tokens": N,
                      "stream": true|false, "timeout_s": opt,
                      "model": opt}
                     With stream=true (default): a chunked
                     application/x-ndjson body, one {"token": t} line
                     per generated token as the scheduler emits it,
                     closed by {"done": true, "finish_reason": ...,
                     "tokens": n, "ttft_ms": x}. With stream=false: one
                     JSON reply carrying the full token list. 400 on a
                     malformed request, 404 for an unknown "model", 503
                     when the decode queue is full or the engine is
                     draining (with Retry-After) or stopped.
  GET  /v1/status    the server's state and load, and each decode
                     engine's queue, slot, KV block and warm view.
  GET  /v1/load      the router's cheap load probe: {"load": scalar,
                     "inflight": n, "queue_depth": q, "state": ...,
                     "models": [...]}, touching only counters.
  GET  /v1/healthz   readiness: 200 only while state == "serving"; 503
                     with {"state": "warming"} before every engine's
                     phase grid is warm, "draining" after drain() began,
                     "stopped" before start, after stop, or when an
                     engine was stopped underneath the server.
  GET  /v1/models    one row per model id: its decode engine's warm
                     state, adopted warmstart phases and model digest.

`decode=` is one engine (model id "default") or {model_id: engine};
a request's "model" picks the engine. Every /v1/* JSON reply and the
generate stream carry X-Request-Id and traceparent (a caller's
traceparent is adopted, its sampling decision with it). A client that
hangs up mid-stream cancels its generation, so its slot and KV blocks
free at once. Built on `observability.httpbase`.

Not ported yet (ROADMAP item 17): /v1/predict and its bucketed engine,
/v1/profile, QoS (tenants, typed sheds), the registry and hot swap.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Dict, Optional
from urllib.parse import urlparse

from ..observability import events as _events
from ..observability import httpbase as _base
from ..observability import tracing as _tracing
from .batcher import QueueFullError, ServerClosed
from .decode import DecodeEngine
from .engine import ServingConfig

__all__ = ["Server"]

DEFAULT_MODEL = "default"


class _ServingHandler(_base.QuietHandler):
    server_version = "paddle-tpu-torch-serving"
    # chunked transfer (the /v1/generate stream) needs HTTP/1.1; all
    # non-chunked replies send an explicit Content-Length
    protocol_version = "HTTP/1.1"
    serving: "Server" = None  # bound per-Server via a subclass

    _tctx = None  # per-request TraceContext, set at the top of do_*

    def _json_reply(self, code: int, payload: Dict, headers=None):
        hdrs = dict(headers or {})
        # every /v1/* reply carries the request id + traceparent, so a
        # caller can join its logs against the trace sink and event log
        hdrs.update(_tracing.response_headers(self._tctx))
        self._reply(code, "application/json", json.dumps(payload) + "\n",
                    extra_headers=hdrs)

    def do_GET(self):  # noqa: N802 - stdlib naming
        try:
            self._tctx = _tracing.begin_request(self.headers)
            path = urlparse(self.path).path
            if path == "/v1/status":
                self._json_reply(200, self.serving.status())
            elif path == "/v1/load":
                self._json_reply(200, self.serving.load())
            elif path == "/v1/healthz":
                state = self.serving.state()
                self._json_reply(
                    200 if state == "serving" else 503,
                    {"status": "ok" if state == "serving"
                     else "unavailable", "state": state})
            elif path == "/v1/models":
                self._json_reply(200, {"models": self.serving.models()})
            else:
                self._reply(404, "text/plain",
                            "not found; routes: POST /v1/generate, "
                            "GET /v1/status /v1/load /v1/healthz "
                            "/v1/models\n")
        except _base.CLIENT_GONE:
            pass

    def _chunk(self, line: str):
        data = line.encode("utf-8")
        self.wfile.write(f"{len(data):x}\r\n".encode())
        self.wfile.write(data)
        self.wfile.write(b"\r\n")
        self.wfile.flush()

    def _do_generate(self, payload: Dict):
        model = payload.get("model")
        decode = self.serving._decode_for(model)
        if decode is None:
            self._json_reply(404, {"error": f"unknown model {str(model)!r}"
                                   if model is not None else
                                   "no decode engine for the default "
                                   "model"})
            return
        # the request-root span: submit() captures it, so the queue-
        # wait/prefill/TTFT spans the scheduler thread records later
        # land under this request's trace
        with _tracing.trace_span("http.generate", cat="serve",
                                 ctx=self._tctx):
            self._generate_traced(payload, decode)

    def _generate_traced(self, payload: Dict, decode: DecodeEngine):
        ids = payload.get("ids")
        if not isinstance(ids, (list, tuple)) or not ids:
            self._json_reply(400, {"error": 'missing/empty "ids" list'})
            return
        max_new = payload.get("max_new_tokens", 16)
        stream = bool(payload.get("stream", True))
        timeout = payload.get("timeout_s")
        try:
            handle = decode.submit(ids, max_new_tokens=int(max_new))
        except (QueueFullError, ServerClosed) as e:
            self._json_reply(503, {"error": str(e)},
                             headers=self.serving._retry_after())
            return
        except (ValueError, TypeError) as e:
            self._json_reply(400, {"error": str(e)})
            return
        if not stream:
            try:
                toks = handle.result(timeout_s=timeout)
            except Exception as e:
                # the reply is an error, so nobody will ever read the
                # rest of this generation: free its slot/blocks now
                decode.cancel(handle)
                self._json_reply(500, {"error": f"{type(e).__name__}: "
                                                f"{e}"})
                return
            info = handle.info
            self._json_reply(200, {
                "tokens": toks, "finish_reason": info["finish_reason"],
                "ttft_ms": round(info["ttft_s"] * 1000, 3)
                if info["ttft_s"] is not None else None})
            return
        # streaming: chunked ndjson, one line per token as it lands
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.send_header("Transfer-Encoding", "chunked")
        self.send_header("Cache-Control", "no-cache")
        for name, value in _tracing.response_headers(self._tctx).items():
            self.send_header(name, value)
        self.end_headers()
        n = 0
        try:
            for tok in handle.tokens(timeout_s=timeout):
                self._chunk(json.dumps({"token": int(tok)}) + "\n")
                n += 1
            info = handle.info
            self._chunk(json.dumps({
                "done": True, "tokens": n,
                "finish_reason": info["finish_reason"],
                "ttft_ms": round(info["ttft_s"] * 1000, 3)
                if info["ttft_s"] is not None else None}) + "\n")
        except _base.CLIENT_GONE:
            # the reader hung up mid-stream: abandon the generation so
            # its decode slot and KV blocks free NOW instead of after
            # max_new_tokens of unread work
            decode.cancel(handle)
            return
        except Exception as e:
            decode.cancel(handle)
            # headers are gone; the error must travel in-band
            try:
                self._chunk(json.dumps({
                    "done": True, "error": f"{type(e).__name__}: {e}",
                    "tokens": n}) + "\n")
            except _base.CLIENT_GONE:
                return
        self.wfile.write(b"0\r\n\r\n")
        self.wfile.flush()
        # one generation per connection: a half-read stream must not
        # poison the next request on the socket
        self.close_connection = True

    def do_POST(self):  # noqa: N802 - stdlib naming
        try:
            self._tctx = _tracing.begin_request(self.headers)
            path = urlparse(self.path).path
            if path != "/v1/generate":
                self._reply(404, "text/plain",
                            "not found; POST routes: /v1/generate\n")
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                payload = json.loads(self.rfile.read(length))
            except (ValueError, TypeError):
                self._json_reply(400, {"error": "body must be JSON"})
                return
            if not isinstance(payload, dict):
                self._json_reply(400, {"error": "body must be a JSON "
                                                "object"})
                return
            self._do_generate(payload)
        except _base.CLIENT_GONE:
            pass


class Server:
    """The token-serving HTTP server around decode engines: `start()`
    warms each engine (with `config.warmup`), binds the listener and
    starts the engines' schedulers; `drain()` stops admitting while the
    listener stays up; `stop()` takes the listener down and stops the
    engines. Start and stop are idempotent; stop is also registered
    atexit so a crashing process never leaks the listener."""

    def __init__(self, config: ServingConfig, decode):
        """`decode` is a `DecodeEngine` (model id "default") or a dict
        {model_id: DecodeEngine}."""
        if decode is None or (isinstance(decode, dict) and not decode):
            raise ValueError("Server needs a DecodeEngine (decode=...)")
        self.config = config
        decodes = decode if isinstance(decode, dict) \
            else {DEFAULT_MODEL: decode}
        self._decodes: Dict[str, DecodeEngine] = \
            {str(k): v for k, v in decodes.items()}
        self.decode: Optional[DecodeEngine] = \
            self._decodes.get(DEFAULT_MODEL)
        handler = type("_BoundServingHandler", (_ServingHandler,),
                       {"serving": self})
        self._http = _base.HTTPServerHandle(
            handler, thread_name="paddle-tpu-torch-serving-http")
        self._lock = threading.Lock()
        self._started_t: Optional[float] = None
        self._draining = False

    # -- lifecycle -----------------------------------------------------

    def start(self, port: Optional[int] = None) -> int:
        """Warm every engine (when `config.warmup`; before anything
        binds or starts a thread, as the JAX Server does), bind the
        listener, then start the decode schedulers. Returns the bound
        port; a second call returns it unchanged."""
        with self._lock:
            if self._started_t is not None:
                return self._http.port()
            self._draining = False
            if self.config.warmup:
                for dec in self._decodes.values():
                    if not dec.warmed:
                        dec.warmup()
            bound = self._http.start(
                self.config.port if port is None else port,
                host=self.config.host)
            for dec in self._decodes.values():
                dec.start()
            self._started_t = time.monotonic()
            import atexit

            atexit.register(self.stop)
            _events.emit("serve_start", port=bound, decode=True,
                         models=self._model_ids())
            return bound

    def drain(self, timeout: float = 30.0):
        """Graceful drain, the fleet's scale-in half-step: the listener
        stays up (the health probe reads "draining", in-flight streams
        finish) but new generations are rejected with 503 +
        Retry-After; blocks until every engine emptied or `timeout`
        passed (one deadline across the engines). Call stop()
        afterwards. Idempotent."""
        with self._lock:
            already = self._draining or self._started_t is None
            if not already:
                self._draining = True
            decodes = list(self._decodes.values())
        if not already:
            _events.emit("serve_drain", queue_depth=sum(
                d.load()[0] for d in decodes))
        deadline = time.monotonic() + float(timeout)
        for dec in decodes:
            dec.drain(timeout_s=max(0.0, deadline - time.monotonic()))

    def draining(self) -> bool:
        with self._lock:
            return self._draining

    def _retry_after(self) -> Optional[Dict[str, str]]:
        """Retry-After for 503 replies while draining: re-send to
        another replica now, and here only after the drain."""
        return {"Retry-After": "1"} if self.draining() else None

    def state(self) -> str:
        """One-word serving state for the health probe: "warming" until
        every engine's phase grid is warm, "serving" while traffic
        flows, "draining" after drain() began, "stopped" before start,
        after stop, or when an engine was stopped underneath us."""
        with self._lock:
            if self._started_t is None:
                return "stopped"
            if self._draining:
                return "draining"
            decodes = list(self._decodes.values())
        if any(d._closed for d in decodes):
            return "stopped"
        if self.config.warmup and any(not d.warmed for d in decodes):
            return "warming"
        return "serving"

    def load(self) -> Dict:
        """The cheap load probe behind GET /v1/load: queue depth +
        in-flight generations as one scalar, touching only counters."""
        depth = inflight = 0
        for dec in self._decodes.values():
            d_wait, d_active = dec.load()
            depth += d_wait
            inflight += d_active
        return {"load": float(depth + inflight), "inflight": inflight,
                "queue_depth": depth, "state": self.state(),
                "models": self._model_ids()}

    def stop(self):
        """Listener down first, then the decode engines (their waiting
        and active generations end as cancelled). Idempotent."""
        import atexit

        with self._lock:
            started = self._started_t is not None
            self._started_t = None
            atexit.unregister(self.stop)
            self._http.stop()
            for dec in self._decodes.values():
                dec.stop()
        if started:
            requests: Dict[str, int] = {}
            for dec in self._decodes.values():
                for k, v in dec.status()["requests"].items():
                    requests[k] = requests.get(k, 0) + v
            _events.emit("serve_stop", requests=requests)

    def port(self) -> Optional[int]:
        return self._http.port()

    # -- model slots ---------------------------------------------------

    def _model_ids(self):
        return sorted(self._decodes)

    def _decode_for(self, model: Optional[str]) -> Optional[DecodeEngine]:
        if model is None:
            return self.decode
        return self._decodes.get(str(model))

    def models(self) -> list:
        """The /v1/models rows: one per model id, with its decode
        engine's warm state, adopted warmstart phases and model
        digest."""
        return [{"id": mid, "version": None,
                 "default": mid == DEFAULT_MODEL, "kind": "decode",
                 "decode": {"warmed": dec.warmed,
                            "warmstart_adopted": dec.warmstart_adopted,
                            "digest": dec._model_digest()}}
                for mid, dec in sorted(self._decodes.items())]

    def status(self) -> Dict:
        up = None if self._started_t is None \
            else round(time.monotonic() - self._started_t, 3)
        probe = self.load()
        st = {"uptime_s": up, "port": self._http.port(),
              "state": probe["state"], "load": probe["load"],
              "inflight": probe["inflight"],
              "queue_depth": probe["queue_depth"],
              "models": probe["models"]}
        if self.decode is not None:
            st["decode"] = self.decode.status()
        for mid, dec in self._decodes.items():
            if dec is not self.decode:
                st.setdefault("decodes", {})[mid] = dec.status()
        return st
