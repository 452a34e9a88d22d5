"""JSON-over-HTTP serving front end: the Server that ties the predict
engine (Engine + Batcher), the decode engines and the HTTP listener
together. Counterpart of the JAX package's `serving/httpd.py`. Routes:

  POST /v1/predict   {"feeds": {name: nested-list}, "timeout_s": opt,
                      "model": opt}
                     → 200 {"outputs": {name: nested-list}, "batch": n}
                       (feeds are cast to the model's declared dtypes by
                       the Predictor; a non-finite output value goes out
                       as the string "nan", "inf" or "-inf")
                     → 400 malformed request / bad shapes
                     → 404 unknown "model"
                     → 503 queue full or draining (with Retry-After
                       while draining), or no predict engine
                     → 504 request missed its deadline
                     → 500 engine error
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
  GET  /v1/status    the server's state and load, the predict engine's
                     buckets, batches, precision and accuracy_delta, the
                     request outcome counts, and each decode engine's
                     queue, slot, KV block and warm view.
  GET  /v1/load      the router's cheap load probe: {"load": scalar,
                     "inflight": n, "queue_depth": q, "state": ...,
                     "models": [...]}, touching only counters.
  GET  /v1/healthz   readiness: 200 only while state == "serving"; 503
                     with {"state": "warming"} before every bucket and
                     phase grid is warm, "draining" after drain() began,
                     "stopped" before start, after stop, or when an
                     engine was stopped underneath the server.
  GET  /v1/models    one row per model id: kind "predict" (the predict
                     engine's program digest, warm state, buckets and
                     request counts) and/or its decode engine's warm
                     state, adopted warmstart phases and model digest.

`Server(config, predictor=None, decode=None)`: the predict engine is
built from `config.model_dir` (or wraps `predictor`) in the slot named
`config.model_id`; `decode=` is one engine (that slot) or {model_id:
engine}. A server needs one or the other. A request's "model" picks
the slot. Every /v1/* JSON reply and the generate stream carry
X-Request-Id and traceparent (a caller's traceparent is adopted, its
sampling decision with it). A client that hangs up mid-stream cancels
its generation, so its slot and KV blocks free at once. Built on
`observability.httpbase`.

Not ported (ROADMAP item 17): more predict slots (`models=`), hot swap
and the registry watcher (`registry=`), which raise, /v1/profile (404),
and QoS (tenants, typed sheds).
"""

from __future__ import annotations

import json
import threading
import time
from typing import Dict, Optional
from urllib.parse import urlparse

import numpy as np

from ..observability import events as _events
from ..observability import httpbase as _base
from ..observability import tracing as _tracing
from ..observability.metrics import _json_safe
from .batcher import (Batcher, EngineError, QueueFullError, RequestTimeout,
                      ServerClosed)
from .decode import DecodeEngine
from .engine import Engine, ServingConfig

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
        # strict JSON: a non-finite float goes out as the string "nan",
        # "inf" or "-inf", never as a bare NaN token RFC-8259 clients
        # reject
        hdrs = dict(headers or {})
        # every /v1/* reply carries the request id + traceparent, so a
        # caller can join its logs against the trace sink and event log
        hdrs.update(_tracing.response_headers(self._tctx))
        self._reply(code, "application/json",
                    json.dumps(_json_safe(payload)) + "\n",
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
                            "not found; routes: POST /v1/predict "
                            "/v1/generate, GET /v1/status /v1/load "
                            "/v1/healthz /v1/models\n")
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
            if path not in ("/v1/predict", "/v1/generate"):
                self._reply(404, "text/plain",
                            "not found; POST routes: /v1/predict, "
                            "/v1/generate (/v1/profile is not ported, "
                            "ROADMAP item 17)\n")
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                payload = json.loads(self.rfile.read(length))
            except (ValueError, TypeError):
                self._json_reply(400, {"error": "body must be JSON"})
                return
            if path == "/v1/generate":
                if not isinstance(payload, dict):
                    self._json_reply(400, {"error": "body must be a "
                                                    "JSON object"})
                    return
                self._do_generate(payload)
                return
            with _tracing.trace_span("http.predict", cat="serve",
                                     ctx=self._tctx):
                self._do_predict(payload)
        except _base.CLIENT_GONE:
            pass

    def _do_predict(self, payload):
        feeds = payload.get("feeds") if isinstance(payload, dict) else None
        if not isinstance(feeds, dict) or not feeds:
            self._json_reply(400, {"error": 'missing/empty "feeds" object'})
            return
        try:
            arrays = {str(k): np.asarray(v) for k, v in feeds.items()}
        except (ValueError, TypeError):
            self._json_reply(400, {"error": "feeds must be rectangular "
                                            "numeric arrays"})
            return
        if any(a.dtype == object or a.dtype.kind in "USV"
               for a in arrays.values()):
            self._json_reply(400, {"error": "feeds must be rectangular "
                                            "numeric arrays"})
            return
        model = payload.get("model")
        if model is not None and str(model) not in self.serving._model_ids():
            self._json_reply(404, {"error": f"unknown model {str(model)!r}"})
            return
        try:
            outs = self.serving.submit(arrays,
                                       timeout_s=payload.get("timeout_s"),
                                       model=model)
        except (QueueFullError, ServerClosed) as e:
            # draining servers add Retry-After so a router (and any
            # well-behaved client) re-sends elsewhere now and re-polls
            # this one after the drain
            self._json_reply(503, {"error": str(e)},
                             headers=self.serving._retry_after())
            return
        except RequestTimeout as e:
            self._json_reply(504, {"error": str(e)})
            return
        except EngineError as e:
            # a model failure is the server's fault: a 400 would make
            # clients retry a request that cannot succeed
            self._json_reply(500, {"error": str(e)})
            return
        except ValueError as e:
            # pre-enqueue validation (empty/ragged/oversize feeds)
            self._json_reply(400, {"error": str(e)})
            return
        except Exception as e:
            self._json_reply(500, {"error": f"{type(e).__name__}: {e}"})
            return
        first = next(iter(arrays.values()))
        self._json_reply(200, {
            "outputs": {k: np.asarray(v).tolist() for k, v in outs.items()},
            "batch": int(first.shape[0]) if first.ndim else 1})


class Server:
    """The serving HTTP server around a predict engine and decode
    engines: `start()` warms each engine (with `config.warmup`), starts
    the predict batcher, binds the listener and starts the decode
    schedulers; `drain()` stops admitting while the listener stays up;
    `stop()` takes the listener down, drains the batcher and stops the
    decode engines. Start and stop are idempotent; stop is also
    registered atexit so a crashing process never leaks the listener."""

    def __init__(self, config: ServingConfig, predictor=None, decode=None,
                 models=None, registry=None):
        """The predict engine is built from `config.model_dir` (or wraps
        `predictor`); `decode` is a `DecodeEngine` (the slot named
        `config.model_id`) or a dict {model_id: DecodeEngine}. A server
        needs a predict engine or a decode engine."""
        if models:
            raise NotImplementedError(
                "Server(models=...): more predict slots are not ported "
                "(ROADMAP item 17)")
        if registry is not None:
            raise NotImplementedError(
                "Server(registry=...): the model registry and hot swap "
                "are not ported (ROADMAP item 17)")
        if isinstance(decode, dict) and not decode:
            decode = None
        if decode is None and predictor is None and \
                getattr(config, "model_dir", None) is None:
            raise ValueError("Server needs a model_dir, a predictor or a "
                             "DecodeEngine (decode=...)")
        self.config = config
        self._default_id = getattr(config, "model_id", DEFAULT_MODEL)
        decodes = decode if isinstance(decode, dict) \
            else ({self._default_id: decode} if decode is not None else {})
        self._decodes: Dict[str, DecodeEngine] = \
            {str(k): v for k, v in decodes.items()}
        self.decode: Optional[DecodeEngine] = \
            self._decodes.get(self._default_id)
        self._engine: Optional[Engine] = None \
            if (config.model_dir is None and predictor is None) \
            else Engine(config, predictor=predictor)
        self._batcher: Optional[Batcher] = None
        handler = type("_BoundServingHandler", (_ServingHandler,),
                       {"serving": self})
        self._http = _base.HTTPServerHandle(
            handler, thread_name="paddle-tpu-torch-serving-http")
        self._lock = threading.Lock()
        self._started_t: Optional[float] = None
        self._draining = False

    @property
    def engine(self) -> Optional[Engine]:
        """The predict engine (None on a decode-only server)."""
        return self._engine

    # -- lifecycle -----------------------------------------------------

    def start(self, port: Optional[int] = None) -> int:
        """Warm every engine (when `config.warmup`; before anything
        binds or starts a thread, as the JAX Server does), start the
        predict batcher, bind the listener, then start the decode
        schedulers. Returns the bound port; a second call returns it
        unchanged."""
        with self._lock:
            if self._started_t is not None:
                return self._http.port()
            self._draining = False
            if self.config.warmup:
                for dec in self._decodes.values():
                    if not dec.warmed:
                        dec.warmup()
            batcher = None
            if self._engine is not None:
                if self.config.warmup:
                    self._engine.warmup()
                batcher = self._make_batcher(self._engine, self.config)
            try:
                bound = self._http.start(
                    self.config.port if port is None else port,
                    host=self.config.host)
            except BaseException:
                if batcher is not None:
                    batcher.stop()  # failed bind must not leak the thread
                raise
            for dec in self._decodes.values():
                dec.start()
            self._batcher = batcher
            self._started_t = time.monotonic()
            import atexit

            atexit.register(self.stop)
            _events.emit("serve_start", port=bound,
                         buckets=list(self._engine.policy.buckets)
                         if self._engine is not None else [],
                         decode=bool(self._decodes),
                         models=self._model_ids(),
                         max_queue=getattr(self.config, "max_queue", None),
                         max_wait_ms=getattr(self.config, "max_wait_ms",
                                             None))
            return bound

    def _make_batcher(self, engine: Engine, cfg: ServingConfig) -> Batcher:
        return Batcher(engine.run_batch, engine.policy,
                       max_queue=cfg.max_queue, max_wait_ms=cfg.max_wait_ms,
                       timeout_s=cfg.timeout_s,
                       output_batched=engine.output_batched)

    def drain(self, timeout: float = 30.0):
        """Graceful drain, the fleet's scale-in half-step: the listener
        stays up (the health probe reads "draining", in-flight streams
        finish) but new work is rejected with 503 + Retry-After; blocks
        until pending predict batches and decode generations completed
        or `timeout` passed (one deadline across the engines). Call
        stop() afterwards. Idempotent."""
        with self._lock:
            already = self._draining or self._started_t is None
            if not already:
                self._draining = True
            batcher = self._batcher
            decodes = list(self._decodes.values())
        if not already:
            _events.emit("serve_drain", queue_depth=(
                batcher.depth() if batcher is not None else 0) + sum(
                d.load()[0] for d in decodes))
        deadline = time.monotonic() + float(timeout)
        if batcher is not None:
            # stop() is the drain: no new admissions, pending batches
            # finish, the thread joins
            batcher.stop(timeout=max(0.0, deadline - time.monotonic()))
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
        every bucket and phase grid is warm, "serving" while traffic
        flows, "draining" after drain() began, "stopped" before start,
        after stop, or when an engine was stopped underneath us."""
        with self._lock:
            if self._started_t is None:
                return "stopped"
            if self._draining:
                return "draining"
            decodes = list(self._decodes.values())
            batcher, engine = self._batcher, self._engine
        if any(d._closed for d in decodes):
            return "stopped"
        if batcher is not None and batcher.draining():
            return "draining"
        if self.config.warmup and (
                (engine is not None and not engine.warmed)
                or any(not d.warmed for d in decodes)):
            return "warming"
        return "serving"

    def load(self) -> Dict:
        """The cheap load probe behind GET /v1/load: queue depth +
        in-flight work as one scalar, touching only counters."""
        batcher = self._batcher
        depth = batcher.depth() if batcher is not None else 0
        inflight = batcher.inflight() if batcher is not None else 0
        for dec in self._decodes.values():
            d_wait, d_active = dec.load()
            depth += d_wait
            inflight += d_active
        return {"load": float(depth + inflight), "inflight": inflight,
                "queue_depth": depth, "state": self.state(),
                "models": self._model_ids()}

    def stop(self):
        """Listener down first, then the batcher drains (its in-flight
        requests finish) and the decode engines stop (their waiting and
        active generations end as cancelled). Idempotent."""
        import atexit

        with self._lock:
            started = self._started_t is not None
            self._started_t = None
            atexit.unregister(self.stop)
            self._http.stop()
            if self._batcher is not None:
                self._batcher.stop()
            for dec in self._decodes.values():
                dec.stop()
        if started:
            requests: Dict[str, int] = self._counts()
            for dec in self._decodes.values():
                for k, v in dec.status()["requests"].items():
                    requests[k] = requests.get(k, 0) + v
            _events.emit("serve_stop", requests=requests)

    def _counts(self) -> Dict[str, int]:
        """The predict batcher's outcome counts (ok, rejected, timeout,
        error)."""
        out = {o: 0 for o in ("ok", "rejected", "timeout", "error")}
        if self._batcher is not None:
            out.update(self._batcher.outcome_counts())
        return out

    def port(self) -> Optional[int]:
        return self._http.port()

    # -- model slots ---------------------------------------------------

    def _model_ids(self):
        ids = set(self._decodes)
        if self._engine is not None:
            ids.add(self._default_id)
        return sorted(ids)

    def _decode_for(self, model: Optional[str]) -> Optional[DecodeEngine]:
        if model is None:
            return self.decode
        return self._decodes.get(str(model))

    def models(self) -> list:
        """The /v1/models rows: one per model id, with the predict
        engine's program digest, warm state and buckets and/or the
        decode engine's warm state, adopted warmstart phases and model
        digest."""
        rows = []
        for mid in self._model_ids():
            row = {"id": mid, "version": None,
                   "default": mid == self._default_id}
            if mid == self._default_id and self._engine is not None:
                eng = self._engine
                row.update(kind="predict", digest=eng._model_digest(),
                           warmed=eng.warmed,
                           warmstart_adopted=eng.warmstart_adopted,
                           buckets=[int(b) for b in eng.policy.buckets])
                if self._batcher is not None:
                    row["requests"] = self._batcher.outcome_counts()
            dec = self._decodes.get(mid)
            if dec is not None:
                row["decode"] = {"warmed": dec.warmed,
                                 "warmstart_adopted": dec.warmstart_adopted,
                                 "digest": dec._model_digest()}
                row.setdefault("kind", "decode")
            rows.append(row)
        return rows

    # -- request path --------------------------------------------------

    def submit(self, feeds: Dict[str, np.ndarray],
               timeout_s: Optional[float] = None,
               model: Optional[str] = None) -> Dict[str, np.ndarray]:
        """In-process entry to the batched predict path (the HTTP
        handler and embedded deployments share it). `model` names the
        slot (None = the default)."""
        if model is not None and str(model) != self._default_id:
            raise ValueError(f"unknown model {str(model)!r}; serving "
                             f"{self._model_ids()}")
        if self._batcher is None:
            raise ServerClosed("server not started"
                               if self._engine is not None else
                               "no predict engine on this server "
                               "(decode-only deployment)")
        return self._batcher.submit(feeds, timeout_s=timeout_s)

    def status(self) -> Dict:
        up = None if self._started_t is None \
            else round(time.monotonic() - self._started_t, 3)
        probe = self.load()
        batcher = self._batcher
        cfg = self.config
        st = {"uptime_s": up, "port": self._http.port(),
              "state": probe["state"], "load": probe["load"],
              "inflight": probe["inflight"],
              "queue_depth": probe["queue_depth"],
              "max_queue": getattr(cfg, "max_queue", None),
              "max_wait_ms": getattr(cfg, "max_wait_ms", None),
              "timeout_s": getattr(cfg, "timeout_s", None),
              "requests": self._counts(),
              "models": probe["models"]}
        if batcher is not None:
            st["queue_depth"] = batcher.depth()
        if self._engine is not None:
            st.update(self._engine.status())
        if self.decode is not None:
            st["decode"] = self.decode.status()
        for mid, dec in self._decodes.items():
            if dec is not self.decode:
                st.setdefault("decodes", {})[mid] = dec.status()
        return st
