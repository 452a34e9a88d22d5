"""JSON-over-HTTP token-serving front end.

Counterpart of the JAX package's `serving/httpd.py` for a decode-only
server. Routes:

  POST /v1/generate  {"ids": [tok,...], "max_new_tokens": N,
                      "stream": true|false, "timeout_s": opt}
                     With stream=true (default): a chunked
                     application/x-ndjson body, one {"token": t} line
                     per generated token as the scheduler emits it,
                     closed by {"done": true, "finish_reason": ...,
                     "tokens": n, "ttft_ms": x}. With stream=false: one
                     JSON reply carrying the full token list. 400 on a
                     malformed request, 503 when the decode queue is
                     full or the engine is stopped.
  GET  /v1/status    the decode engine's queue, slot and KV block view.

A client that hangs up mid-stream cancels its generation, so its slot
and KV blocks free at once. Built on `observability.httpbase`.
"""

from __future__ import annotations

import json
import time
from typing import Dict, Optional
from urllib.parse import urlparse

from ..observability import httpbase as _base
from .batcher import QueueFullError, ServerClosed
from .decode import DecodeEngine
from .engine import ServingConfig

__all__ = ["Server"]


class _ServingHandler(_base.QuietHandler):
    server_version = "paddle-tpu-torch-serving"
    # chunked transfer (the /v1/generate stream) needs HTTP/1.1; all
    # non-chunked replies send an explicit Content-Length
    protocol_version = "HTTP/1.1"
    serving: "Server" = None  # bound per-Server via a subclass

    def _json_reply(self, code: int, payload: Dict):
        self._reply(code, "application/json", json.dumps(payload) + "\n")

    def do_GET(self):  # noqa: N802 - stdlib naming
        try:
            path = urlparse(self.path).path
            if path == "/v1/status":
                self._json_reply(200, self.serving.status())
            else:
                self._reply(404, "text/plain",
                            "not found; routes: POST /v1/generate, "
                            "GET /v1/status\n")
        except _base.CLIENT_GONE:
            pass

    def _chunk(self, line: str):
        data = line.encode("utf-8")
        self.wfile.write(f"{len(data):x}\r\n".encode())
        self.wfile.write(data)
        self.wfile.write(b"\r\n")
        self.wfile.flush()

    def _do_generate(self, payload: Dict):
        decode = self.serving.decode
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
            self._json_reply(503, {"error": str(e)})
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
    """The token-serving HTTP server around one `DecodeEngine`:
    `start(port)` binds the listener and starts the engine's scheduler,
    `stop()` takes the listener down and stops the engine. Both are
    idempotent; stop is also registered atexit so a crashing process
    never leaks the listener."""

    def __init__(self, config: ServingConfig, decode: DecodeEngine):
        if decode is None:
            raise ValueError("Server needs a DecodeEngine (decode=...)")
        self.config = config
        self.decode = decode
        handler = type("_BoundServingHandler", (_ServingHandler,),
                       {"serving": self})
        self._http = _base.HTTPServerHandle(
            handler, thread_name="paddle-tpu-torch-serving-http")
        self._started_t: Optional[float] = None

    def start(self, port: Optional[int] = None) -> int:
        """Bind the listener, then start the decode scheduler. Returns
        the bound port; a second call returns it unchanged."""
        if self._started_t is not None:
            return self._http.port()
        bound = self._http.start(
            self.config.port if port is None else port,
            host=self.config.host)
        self.decode.start()
        self._started_t = time.monotonic()
        import atexit

        atexit.register(self.stop)
        return bound

    def stop(self):
        """Listener down first, then the decode engine (its waiting and
        active generations end as cancelled). Idempotent."""
        import atexit

        atexit.unregister(self.stop)
        self._http.stop()
        self.decode.stop()
        self._started_t = None

    def port(self) -> Optional[int]:
        return self._http.port()

    def status(self) -> Dict:
        up = None if self._started_t is None \
            else round(time.monotonic() - self._started_t, 3)
        return {"uptime_s": up, "port": self._http.port(),
                "decode": self.decode.status()}
