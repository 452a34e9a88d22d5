"""JSON-over-HTTP serving front end: the Server that ties the predict
engine (Engine + Batcher), the decode engines and the HTTP listener
together. Counterpart of the JAX package's `serving/httpd.py`. Routes:

  POST /v1/predict   {"feeds": {name: nested-list}, "timeout_s": opt,
                      "model": opt, "tenant": opt}
                     → 200 {"outputs": {name: nested-list}, "batch": n}
                       (feeds are cast to the model's declared dtypes by
                       the Predictor; a non-finite output value goes out
                       as the string "nan", "inf" or "-inf")
                     → 400 malformed request / bad shapes
                     → 404 unknown "model"
                     → 503 queue full or draining (with Retry-After
                       while draining), or no predict engine; a QoS
                       shed or quota rejection is the typed 503
                       {"error", "shed": tier, "kind": "queue"|"quota",
                       "tenant", "retry_after_s"} with Retry-After
                     → 504 request missed its deadline
                     → 500 engine error
  POST /v1/generate  {"ids": [tok,...], "max_new_tokens": N,
                      "stream": true|false, "timeout_s": opt,
                      "model": opt, "tenant": opt}
                     With stream=true (default): a chunked
                     application/x-ndjson body, one {"token": t} line
                     per generated token as the scheduler emits it,
                     closed by {"done": true, "finish_reason": ...,
                     "tokens": n, "ttft_ms": x}. With stream=false: one
                     JSON reply carrying the full token list. 400 on a
                     malformed request, 404 for an unknown "model", 503
                     when the decode queue is full or the engine is
                     draining (with Retry-After) or stopped, and the
                     typed shed 503 under QoS.
  POST /v1/profile   {"seconds": N}: one bounded torch.profiler capture
                     of the live server (observability/httpd.py's
                     handler, on the profiler) → 200 {"dir", "trace",
                     "perf", "seconds"}; 409 while another capture or
                     trace runs; 400 on a malformed body
  GET  /v1/status    the server's state and load, the predict engine's
                     buckets, batches, precision and accuracy_delta, the
                     request outcome counts, the memwatch owner table
                     ("memory"), and each decode engine's queue, slot,
                     KV block and warm view.
  GET  /v1/load      the router's cheap load probe: {"load": scalar,
                     "inflight": n, "queue_depth": q, "state": ...,
                     "models": [...]}, touching only counters.
  GET  /v1/healthz   readiness: 200 only while state == "serving"; 503
                     with {"state": "warming"} before every bucket and
                     phase grid is warm, "draining" after drain() began,
                     "stopped" before start, after stop, or when an
                     engine was stopped underneath the server.
  GET  /v1/models    one row per model id: kind "predict" (the predict
                     engine's program digest, adopted registry version,
                     warm state, buckets and request counts) and/or its
                     decode engine's warm state, adopted warmstart
                     phases and model digest.

`Server(config, predictor=None, decode=None, models=None,
registry=None)`: the default predict slot is built from
`config.model_dir` (or wraps `predictor`) and named `config.model_id`;
`models=` is {model_id: ServingConfig} for more predict slots in the
same process; `decode=` is one engine (the default slot) or {model_id:
engine}. A server needs a predict or a decode engine. A request's
"model" picks the slot, its "tenant" flows to QoS admission
(`config.qos`, applied by every predict slot's Batcher; a decode
engine takes its own `DecodeConfig(qos=...)`). A typed shed answers
503 with a Retry-After header, which the fleet router passes on as an
answer rather than retrying it elsewhere. `hot_swap()` (and the
registry watcher behind `attach_registry()` or `registry=`) replaces a
predict slot's engine with one built and warmed from a new model dir or
published artifact off the serving path; the slot pointer moves under
the lock and the old batcher then drains, so no request fails. A
request that looked its slot up just before the swap and reaches the
stopped batcher is submitted once more on the slot's new one, where
the JAX package's server answers it 503 (ROADMAP F9). Every
/v1/* JSON reply and the generate stream carry X-Request-Id and
traceparent (a caller's traceparent is adopted, its sampling decision
with it). A client that hangs up mid-stream cancels its generation, so
its slot and KV blocks free at once. When PADDLE_TPU_SLOW_SHIM_FILE
names an existing file, every predict first sleeps the seconds it
holds (a slow replica injected and lifted by creating and removing the
file, which the fleet router's failover tests use). `start()` also
starts the env-gated time-series recorder (PADDLE_TPU_TS_DIR) and,
when `config.slo_spec` declares objectives, the SLO evaluator; `stop()`
stops those it started. Built on `observability.httpbase`.
"""

from __future__ import annotations

import copy
import json
import os
import threading
import time
from typing import Dict, Optional
from urllib.parse import urlparse

import numpy as np

from ..observability import events as _events
from ..observability import httpbase as _base
from ..observability import memwatch as _memwatch
from ..observability import metrics as _m
from ..observability import slo as _slo
from ..observability import timeseries as _timeseries
from ..observability import tracing as _tracing
from ..observability.metrics import _json_safe
from .batcher import (Batcher, EngineError, QueueFullError, RequestTimeout,
                      ServerClosed)
from .decode import DecodeEngine
from .engine import Engine, ServingConfig
from .qos import QoSPolicy, ShedError

__all__ = ["Server"]

DEFAULT_MODEL = "default"

MODEL_SWAPS = _m.counter(
    "paddle_tpu_model_swaps_total",
    "Completed zero-downtime model hot-swaps, by model id",
    labelnames=("model",))


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

    def _shed_reply(self, e: ShedError):
        """The typed shed/quota 503: Retry-After and a {"shed": tier}
        body that the fleet router treats as an answer (no failover
        retry): re-sending a deliberately shed request to a surviving
        replica amplifies the overload the shed relieves."""
        self._json_reply(
            503, {"error": str(e), "shed": e.tier, "kind": e.kind,
                  "tenant": e.tenant, "retry_after_s": e.retry_after_s},
            headers={"Retry-After":
                     str(max(1, int(round(e.retry_after_s))))})

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
            handle = decode.submit(ids, max_new_tokens=int(max_new),
                                   tenant=payload.get("tenant"))
        except ShedError as e:
            self._shed_reply(e)
            return
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
            if path == "/v1/profile":
                # on-demand capture on the SERVING port: this handler
                # thread blocks for the window while the threaded server
                # keeps every other route flowing
                from ..observability.httpd import handle_profile_request

                code, body = handle_profile_request(self)
                self._reply(code, "application/json", body)
                return
            if path not in ("/v1/predict", "/v1/generate"):
                self._reply(404, "text/plain",
                            "not found; POST routes: /v1/predict, "
                            "/v1/generate, /v1/profile\n")
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
        # chaos hook: when PADDLE_TPU_SLOW_SHIM_FILE names an existing
        # file, every predict sleeps the float it holds, a slow replica
        # injected and lifted mid-life without a restart
        shim = os.environ.get("PADDLE_TPU_SLOW_SHIM_FILE")
        if shim:
            try:
                with open(shim) as f:
                    delay = float(f.read().strip() or 0.0)
            except (OSError, ValueError):
                delay = 0.0
            if delay > 0:
                time.sleep(delay)
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
                                       model=model,
                                       tenant=payload.get("tenant"))
        except ShedError as e:
            self._shed_reply(e)
            return
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
    """The serving HTTP server around predict slots and decode engines:
    `start()` warms each engine (with `config.warmup`), starts the
    predict batchers, binds the listener, starts the decode schedulers
    and the registry watcher; `drain()` stops admitting while the
    listener stays up; `stop()` takes the listener down, drains the
    batchers and stops the decode engines. Start and stop are
    idempotent; stop is also registered atexit so a crashing process
    never leaks the listener."""

    def __init__(self, config: ServingConfig, predictor=None, decode=None,
                 models=None, registry=None):
        """The default predict slot is built from `config.model_dir` (or
        wraps `predictor`); `models` is {model_id: ServingConfig} for
        more predict slots beside it (each engine builds now, so a bad
        config fails here); `decode` is a `DecodeEngine` (the slot named
        `config.model_id`) or a dict {model_id: DecodeEngine};
        `registry` is a `registry.ModelRegistry` to watch for hot swaps
        (see attach_registry). A server needs a predict engine or a
        decode engine."""
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
        # more predict slots: model_id -> {config, engine, batcher};
        # engines build now, batchers at start()
        self._extra: Dict[str, Dict] = {}
        for mid, mcfg in (models or {}).items():
            mid = str(mid)
            if mid == self._default_id:
                raise ValueError(
                    f"models= duplicates the default slot {mid!r}")
            self._extra[mid] = {"config": mcfg, "engine": Engine(mcfg),
                                "batcher": None}
        self._qos = QoSPolicy.from_spec(getattr(config, "qos", None))
        handler = type("_BoundServingHandler", (_ServingHandler,),
                       {"serving": self})
        self._http = _base.HTTPServerHandle(
            handler, thread_name="paddle-tpu-torch-serving-http")
        self._lock = threading.Lock()
        self._started_t: Optional[float] = None
        # the TS recorder and SLO evaluator this server started
        self._ts_started = self._slo_started = False
        self._draining = False
        # registry hot swap: adopted version per slot, the watcher
        # thread and its stop flag
        self._versions: Dict[str, int] = {}
        self._registry = None
        self._watch_ids = None
        self._watch_poll_s = 1.0
        self._watch_stop = threading.Event()
        self._watch_thread: Optional[threading.Thread] = None
        if registry is not None:
            self.attach_registry(registry)

    @property
    def engine(self) -> Optional[Engine]:
        """The default slot's predict engine (None on a decode-only
        server)."""
        return self._engine

    # -- lifecycle -----------------------------------------------------

    def start(self, port: Optional[int] = None) -> int:
        """Warm every engine (when its config says so; before anything
        binds or starts a thread, as the JAX Server does), start the
        predict batchers, bind the listener, then start the decode
        schedulers and the registry watcher. Returns the bound port; a
        second call returns it unchanged."""
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
            extra_batchers = []
            try:
                for mid, slot in self._extra.items():
                    if slot["config"].warmup:
                        slot["engine"].warmup()
                    extra_batchers.append(
                        (mid, self._make_batcher(slot["engine"],
                                                 slot["config"])))
                bound = self._http.start(
                    self.config.port if port is None else port,
                    host=self.config.host)
            except BaseException:
                # a failed warmup or bind must not leak batcher threads
                for b in [batcher] + [b for _, b in extra_batchers]:
                    if b is not None:
                        b.stop()
                raise
            for dec in self._decodes.values():
                dec.start()
            self._batcher = batcher
            for mid, b in extra_batchers:
                self._extra[mid]["batcher"] = b
            self._started_t = time.monotonic()
            import atexit

            atexit.register(self.stop)
            # the env-gated TS recorder, and the SLO evaluator when the
            # config declares objectives (no-ops without
            # PADDLE_TPU_TS_DIR); stop() stops those started here
            recording = _timeseries.current_recorder() is not None
            evaluating = _slo.current_engine() is not None
            self._ts_started = _timeseries.maybe_start_recorder() \
                and not recording
            self._slo_started = _slo.maybe_start_evaluator(
                spec_path=getattr(self.config, "slo_spec", None)) \
                and not evaluating
            _events.emit("serve_start", port=bound,
                         buckets=list(self._engine.policy.buckets)
                         if self._engine is not None else [],
                         decode=bool(self._decodes),
                         models=self._model_ids(),
                         qos=self._qos is not None,
                         max_queue=getattr(self.config, "max_queue", None),
                         max_wait_ms=getattr(self.config, "max_wait_ms",
                                             None))
            self._maybe_start_watcher()
            return bound

    def _make_batcher(self, engine: Engine, cfg: ServingConfig) -> Batcher:
        return Batcher(engine.run_batch, engine.policy,
                       max_queue=cfg.max_queue, max_wait_ms=cfg.max_wait_ms,
                       timeout_s=cfg.timeout_s,
                       output_batched=engine.output_batched,
                       qos=self._qos)

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
            batchers = self._all_batchers()
            decodes = list(self._decodes.values())
        if not already:
            _events.emit("serve_drain", queue_depth=sum(
                b.depth() for b in batchers) + sum(
                d.load()[0] for d in decodes))
        deadline = time.monotonic() + float(timeout)
        for batcher in batchers:
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
            batchers = self._all_batchers()
            engines = self._all_engines()
        if any(d._closed for d in decodes):
            return "stopped"
        if any(b.draining() for b in batchers):
            return "draining"
        if self.config.warmup and (
                any(not e.warmed for e in engines)
                or any(not d.warmed for d in decodes)):
            return "warming"
        return "serving"

    def load(self) -> Dict:
        """The cheap load probe behind GET /v1/load: queue depth +
        in-flight work as one scalar, touching only counters."""
        batchers = self._all_batchers()
        depth = sum(b.depth() for b in batchers)
        inflight = sum(b.inflight() for b in batchers)
        for dec in self._decodes.values():
            d_wait, d_active = dec.load()
            depth += d_wait
            inflight += d_active
        return {"load": float(depth + inflight), "inflight": inflight,
                "queue_depth": depth, "state": self.state(),
                "models": self._model_ids()}

    def stop(self):
        """Listener down first, then the batchers drain (their in-flight
        requests finish) and the decode engines stop (their waiting and
        active generations end as cancelled). Idempotent."""
        import atexit

        # the registry watcher joins outside the lock: its poll loop
        # takes the lock for hot swaps
        self._watch_stop.set()
        watcher = self._watch_thread
        if watcher is not None and watcher.is_alive():
            watcher.join(timeout=10.0)
        self._watch_thread = None
        with self._lock:
            started = self._started_t is not None
            self._started_t = None
            atexit.unregister(self.stop)
            self._http.stop()
            for batcher in self._all_batchers():
                batcher.stop()
            for dec in self._decodes.values():
                dec.stop()
            stop_slo, self._slo_started = self._slo_started, False
            stop_ts, self._ts_started = self._ts_started, False
        if stop_slo:
            _slo.stop_evaluator()
        if stop_ts:
            _timeseries.stop_recorder()   # its final sample, flushed
        if started:
            requests: Dict[str, int] = self._counts()
            for dec in self._decodes.values():
                for k, v in dec.status()["requests"].items():
                    requests[k] = requests.get(k, 0) + v
            _events.emit("serve_stop", requests=requests)

    def _counts(self) -> Dict[str, int]:
        """The predict batchers' outcome counts (ok, rejected, timeout,
        error), summed over the slots."""
        out = {o: 0 for o in ("ok", "rejected", "timeout", "error")}
        for b in self._all_batchers():
            for k, v in b.outcome_counts().items():
                out[k] = out.get(k, 0) + v
        return out

    def port(self) -> Optional[int]:
        return self._http.port()

    # -- model slots ---------------------------------------------------

    def _all_batchers(self):
        out = [] if self._batcher is None else [self._batcher]
        out.extend(s["batcher"] for s in self._extra.values()
                   if s["batcher"] is not None)
        return out

    def _all_engines(self):
        out = [] if self._engine is None else [self._engine]
        out.extend(s["engine"] for s in self._extra.values())
        return out

    def _model_ids(self):
        ids = set(self._extra) | set(self._decodes)
        if self._engine is not None:
            ids.add(self._default_id)
        return sorted(ids)

    def _slot(self, model: Optional[str]):
        """(engine, batcher) of a predict slot; None = the default slot
        (empty on a decode-only server). KeyError for an unknown id."""
        mid = self._default_id if model is None else str(model)
        if mid == self._default_id and mid not in self._extra:
            return self._engine, self._batcher
        slot = self._extra[mid]
        return slot["engine"], slot["batcher"]

    def _decode_for(self, model: Optional[str]) -> Optional[DecodeEngine]:
        if model is None:
            return self.decode
        return self._decodes.get(str(model))

    def models(self) -> list:
        """The /v1/models rows: one per model id, with the predict
        engine's program digest, adopted registry version, warm state
        and buckets and/or the decode engine's warm state, adopted
        warmstart phases and model digest. The slot pointers are read
        under the server lock, the rows built after it."""
        slots = []
        with self._lock:
            for mid in self._model_ids():
                try:
                    eng, batcher = self._slot(mid)
                except KeyError:
                    eng, batcher = None, None
                slots.append((mid, self._versions.get(mid), eng, batcher,
                              self._decodes.get(mid)))
        rows = []
        for mid, version, eng, batcher, dec in slots:
            row = {"id": mid, "version": version,
                   "default": mid == self._default_id}
            if eng is not None:
                row.update(kind="predict", digest=eng._model_digest(),
                           warmed=eng.warmed,
                           warmstart_adopted=eng.warmstart_adopted,
                           buckets=[int(b) for b in eng.policy.buckets])
                if batcher is not None:
                    row["requests"] = batcher.outcome_counts()
            if dec is not None:
                row["decode"] = {"warmed": dec.warmed,
                                 "warmstart_adopted": dec.warmstart_adopted,
                                 "digest": dec._model_digest()}
                row.setdefault("kind", "decode")
            rows.append(row)
        return rows

    # -- zero-downtime hot swap ----------------------------------------

    def hot_swap(self, model_id: Optional[str] = None, *,
                 model_dir: Optional[str] = None,
                 warmstart: Optional[str] = None,
                 version: Optional[int] = None) -> Dict:
        """Replace one predict slot's engine with one built from a new
        model dir or artifact, without dropping traffic: the new engine
        builds and warms before the slot pointer moves (an adopted
        warmstart marks its buckets warm), new requests go to it from
        the swap on, and the old slot's batcher then drains, so every
        request in flight completes against the old engine. Returns the
        swap record (also the `model_swap` event)."""
        mid = self._default_id if model_id is None else str(model_id)
        if mid == self._default_id and self._engine is not None:
            old_cfg = self.config
        elif mid in self._extra:
            old_cfg = self._extra[mid]["config"]
        else:
            raise KeyError(f"unknown model slot {mid!r}; serving "
                           f"{self._model_ids()}")
        new_cfg = copy.copy(old_cfg)
        if model_dir is not None:
            new_cfg.model_dir = model_dir
        new_cfg.warmstart = warmstart
        t0 = time.monotonic()
        # the expensive part runs off the serving path: the old engine
        # keeps answering while this one builds and warms
        new_engine = Engine(new_cfg)
        if new_cfg.warmup:
            new_engine.warmup()
        new_batcher = None
        with self._lock:
            if self._started_t is not None:
                new_batcher = self._make_batcher(new_engine, new_cfg)
            if mid == self._default_id and self._engine is not None:
                old_batcher = self._batcher
                self.config = new_cfg
                self._engine = new_engine
                self._batcher = new_batcher
            else:
                old_batcher = self._extra[mid]["batcher"]
                self._extra[mid] = {"config": new_cfg,
                                    "engine": new_engine,
                                    "batcher": new_batcher}
            if version is not None:
                self._versions[mid] = int(version)
        # drain the displaced batcher after the pointer moved: its
        # queued and in-flight requests complete against the old engine
        # (their feeds were validated against its signatures) while new
        # arrivals already land on the new one
        if old_batcher is not None:
            old_batcher.stop()
        record = {"model": mid, "version": version,
                  "digest": new_engine._model_digest(),
                  "warmstart_adopted": new_engine.warmstart_adopted,
                  "swap_s": round(time.monotonic() - t0, 3)}
        MODEL_SWAPS.inc(model=mid)
        if version is not None:
            from .registry import MODEL_VERSION

            MODEL_VERSION.set(int(version), model=mid)
        _events.emit("model_swap", **record)
        return record

    def attach_registry(self, registry, model_ids=None,
                        poll_s: float = 1.0):
        """Watch a `registry.ModelRegistry` and hot-swap slots as new
        versions publish. `model_ids` bounds the watch (default: this
        server's predict slots). The watcher starts with the server (or
        at once if it is already started) and stops with it. A slot
        already serving the published program digest from an adopted
        artifact only records the version."""
        self._registry = registry
        self._watch_ids = None if model_ids is None \
            else [str(m) for m in model_ids]
        self._watch_poll_s = float(poll_s)
        self._maybe_start_watcher()

    def _maybe_start_watcher(self):
        if self._registry is None or self._watch_thread is not None \
                or self._started_t is None:
            return
        self._watch_stop.clear()
        self._watch_thread = threading.Thread(
            target=self._watch_loop,
            name="paddle-tpu-torch-registry-watch", daemon=True)
        self._watch_thread.start()

    def _watch_ids_now(self):
        if self._watch_ids is not None:
            return self._watch_ids
        ids = [] if self._engine is None else [self._default_id]
        ids.extend(self._extra)
        return ids

    def _watch_loop(self):
        while not self._watch_stop.wait(self._watch_poll_s):
            for mid in self._watch_ids_now():
                try:
                    self._adopt_if_new(mid)
                except Exception as e:
                    # a bad publish must not kill the watcher (the
                    # current engine keeps serving); surface it
                    _events.emit("model_swap_failed", model=mid,
                                 error=f"{type(e).__name__}: "
                                       f"{str(e)[:200]}")

    def _adopt_if_new(self, mid: str):
        reg = self._registry
        ver = reg.version(mid)
        if ver is None or ver <= self._versions.get(mid, 0):
            return
        entry = reg.resolve(mid)   # digest-verified blob
        try:
            eng, _ = self._slot(mid)
        except KeyError:
            eng = None
        if eng is not None and entry.get("model_digest") is not None \
                and entry["model_digest"] == eng._model_digest() \
                and eng.warmstart_adopted:
            # same program, already warm from an adopted artifact:
            # record the version, skip the rebuild
            with self._lock:
                self._versions[mid] = ver
            return
        self.hot_swap(mid, model_dir=entry.get("model_dir"),
                      warmstart=entry["path"], version=ver)

    # -- request path --------------------------------------------------

    def submit(self, feeds: Dict[str, np.ndarray],
               timeout_s: Optional[float] = None,
               model: Optional[str] = None,
               tenant: Optional[str] = None) -> Dict[str, np.ndarray]:
        """In-process entry to the batched predict path (the HTTP
        handler and embedded deployments share it). `model` names the
        slot (None = the default); `tenant` flows to QoS admission."""
        try:
            engine, batcher = self._slot(model)
        except KeyError:
            raise ValueError(f"unknown model {str(model)!r}; serving "
                             f"{self._model_ids()}")
        if batcher is None:
            raise ServerClosed("server not started"
                               if engine is not None else
                               "no predict engine on this server "
                               "(decode-only deployment)")
        try:
            return batcher.submit(feeds, timeout_s=timeout_s, tenant=tenant)
        except ServerClosed:
            # a hot swap moved the slot between the lookup and the
            # submit, and the displaced batcher is draining: the
            # request goes to the slot's new batcher (ROADMAP F9)
            _, now = self._slot(model)
            if now is None or now is batcher or self.draining():
                raise
            return now.submit(feeds, timeout_s=timeout_s, tenant=tenant)

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
              "memory": _memwatch.status_block(),
              "models": probe["models"]}
        if batcher is not None:
            st["queue_depth"] = batcher.depth()
        if self._qos is not None:
            st["qos"] = self._qos.spec_dict()
        if self._engine is not None:
            st.update(self._engine.status())
        if self.decode is not None:
            st["decode"] = self.decode.status()
        for mid, dec in self._decodes.items():
            if dec is not self.decode:
                st.setdefault("decodes", {})[mid] = dec.status()
        return st
