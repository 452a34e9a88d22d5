# Copied from the JAX package: paddle_tpu/serving/router.py (stdlib
# only). Keep it in step with that file; its declared changes give
# Router a plain lock and reword four comment lines.
"""Fleet front tier: a replica router with health ejection, breaker-
gated retry failover, and elastic rendezvous-backed membership.

One Engine on one chip is a single point of failure and a fixed
capacity ceiling; the fleet tier (SERVING.md §Fleet) puts a `Router` in
front of N replica `serving.Server` processes so a replica crash is a
retried request, not a client-visible outage, and capacity follows the
replica set:

* **balancing** — power-of-two-choices on live load: a background poll
  thread caches each replica's `/v1/load` scalar (queue depth +
  in-flight work, satellite of this PR) every `poll_interval_s`; a pick
  samples two healthy replicas and routes to the lower cached load
  plus a locally tracked in-flight delta (the cache is at most one
  interval stale, the local delta makes consecutive picks spread).
  P2C needs only the scalar — the router never parses a full status
  document on the request path (Mitzenmacher '01: two choices get
  exponentially better max-load than one; more choices add little).
* **health ejection** — the poll thread probes `/v1/healthz`;
  `eject_threshold` consecutive failures/timeouts/503s eject the
  replica from the pick set (`fleet` event + metric), a succeeding
  probe readmits it. A connect failure on the request path ejects
  immediately — waiting out the poll interval would burn retries on a
  corpse.
* **circuit breaking** — every endpoint is wrapped in a
  `resilience.retry.CircuitBreaker`; `allow()` admission happens only
  for the replica a pick actually chose (an un-picked candidate must
  not consume the half-open probe slot) and EVERY admitted call reports
  success or failure — including unexpected exceptions, so a dying
  probe thread releases the slot instead of wedging the breaker
  half-open forever (the breaker's leak-fix contract, extended here to the
  router's usage pattern and regression-tested in tests/test_fleet.py).
* **retry failover** — `/v1/predict` is idempotent (pure function of
  its feeds): a connect error, wire timeout, or replica 5xx re-sends
  the request to a different surviving replica, up to `retries` times
  (`paddle_tpu_fleet_retries_total{reason}`); a replica 503 (queue
  full / draining) is NOT a breaker failure — the replica is healthy
  and talking — but also fails over. Client errors (400) and
  request-deadline 504s never retry. Streamed `/v1/generate` is NOT
  blindly retried: a stream that dies before the first token was
  delivered is resubmitted from scratch on another replica; once
  tokens have been delivered the router surfaces a typed
  `StreamBrokenError` — silently replaying a generation after the
  client consumed half of it could emit a token sequence that
  disagrees with what was already delivered (composition-dependent
  sampling, non-greedy decode), so the CLIENT owns that retry.
* **QoS shed passthrough** — a 503 whose body carries a `"shed"` key
  is a tier shed (SERVING.md §Multi-tenancy): the replica
  deliberately rejected the request under its admission policy, so
  the router treats it as an ANSWER, not a failure — no failover
  retry (re-sending a shed request onto a surviving replica amplifies
  exactly the overload the shed is relieving), no breaker penalty,
  and the typed body + Retry-After propagate to the client unchanged
  (`paddle_tpu_fleet_sheds_total{tier}`, typed `TierShed` from the
  library API).
* **model routing** — replicas advertise the model ids they serve in
  the /v1/load body (multi-model Server, SERVING.md §Multi-tenancy);
  a request carrying `"model"` is picked only among replicas
  advertising that id (a replica advertising nothing is assumed to
  serve everything — single-model fleets predate the field), and a
  replica 404 "unknown model" fails over without a breaker penalty —
  the replica is alive, the router's model map was just stale.
  `mean_load_per_healthy(model=...)` scopes the autoscaler's
  utilization signal to one model's slice of the fleet.
* **elastic membership** — point the router at the same
  `FileRendezvous` store the replicas heartbeat into
  (`Router(rdzv_dir=...)`): member ids ARE endpoints ("host:port"),
  the poll thread folds joins/leaves into the replica set, and
  `paddle_tpu_fleet_world_size` tracks the live set. Scale-out /
  scale-in / respawn live in `distributed/launch_serve.py`
  (ReplicaSupervisor) and `serving/autoscale.py` (Autoscaler).

`RouterServer` is the HTTP face of the tier: the same /v1 surface as a
replica (predict, generate, status, healthz), so clients cannot tell a
fleet from a single server, plus the fleet view under /v1/status.
"""

from __future__ import annotations

import http.client
import json
import random
import socket
import threading
import time
import urllib.error
import urllib.request
from collections import deque
from typing import Dict, Iterator, List, Optional, Sequence, Tuple
from urllib.parse import parse_qs, urlparse

from ..observability import events as _events
from ..observability import httpbase as _base
from ..observability import metrics as _m
from ..observability import tracing as _tracing
from ..observability.metrics import _json_safe
from ..resilience.retry import CircuitBreaker

__all__ = ["Router", "RouterServer", "FleetError", "NoReplicasError",
           "StreamBrokenError", "ReplicaRejected", "FleetTimeout",
           "TierShed"]


REPLICAS = _m.gauge(
    "paddle_tpu_fleet_replicas",
    "Router replica counts by state", labelnames=("state",))
WORLD_SIZE = _m.gauge(
    "paddle_tpu_fleet_world_size",
    "Replica endpoints the router currently knows (healthy + ejected)")
REQUESTS = _m.counter(
    "paddle_tpu_fleet_requests_total",
    "Router requests by outcome (ok|error|rejected|timeout)",
    labelnames=("outcome",))
RETRIES = _m.counter(
    "paddle_tpu_fleet_retries_total",
    "Requests re-sent to another replica, by failure class "
    "(connect|server_error|busy|no_model|stream_restart)",
    labelnames=("reason",))
EJECTIONS = _m.counter(
    "paddle_tpu_fleet_ejections_total",
    "Health ejections per endpoint", labelnames=("endpoint",))
READMISSIONS = _m.counter(
    "paddle_tpu_fleet_readmissions_total",
    "Ejected endpoints readmitted after a passing health probe",
    labelnames=("endpoint",))
BREAKER_STATE = _m.gauge(
    "paddle_tpu_fleet_breaker_state",
    "Per-endpoint circuit-breaker state (0 closed, 1 half-open, 2 open)",
    labelnames=("endpoint",))
PICKS = _m.counter(
    "paddle_tpu_fleet_picks_total",
    "Power-of-two-choices routing decisions per endpoint",
    labelnames=("endpoint",))
REQUEST_SECONDS = _m.histogram(
    "paddle_tpu_fleet_request_seconds",
    "Router end-to-end request latency (successful predicts, incl. "
    "failover retries)")
FLEET_SHEDS = _m.counter(
    "paddle_tpu_fleet_sheds_total",
    "QoS tier-shed 503s the router passed through as answers (no "
    "failover), by shed tier", labelnames=("tier",))

_BREAKER_LEVEL = {CircuitBreaker.CLOSED: 0, CircuitBreaker.HALF_OPEN: 1,
                  CircuitBreaker.OPEN: 2}


class FleetError(RuntimeError):
    """Base class for router-level failures."""


class NoReplicasError(FleetError):
    """No healthy, breaker-admitted replica left to try (HTTP 503)."""


class ReplicaRejected(FleetError):
    """Every tried replica rejected the request with 503 — the fleet is
    saturated or draining; clients should back off (HTTP 503)."""


class FleetTimeout(FleetError):
    """A replica answered 504: the request's own deadline is spent, so
    re-sending it elsewhere would only double the damage (HTTP 504)."""


class TierShed(FleetError):
    """A replica answered with a QoS tier-shed 503 — a deliberate,
    policy-scoped ANSWER, not a failure: the router does not fail
    over (that would amplify the overload the shed is relieving) and
    the replica takes no breaker penalty. Carries the replica's typed
    `body` ({"shed": tier, "kind": "queue"|"quota", "tenant": ...})
    and its suggested `retry_after_s` backoff."""

    def __init__(self, msg: str, body: Optional[Dict] = None,
                 retry_after_s: float = 1.0):
        super().__init__(msg)
        self.body = dict(body or {})
        self.retry_after_s = float(retry_after_s)

    @property
    def tier(self) -> Optional[str]:
        return self.body.get("shed")


class StreamBrokenError(FleetError):
    """A streamed generation died AFTER tokens were delivered. The
    router must not silently resubmit — the replayed sequence is not
    guaranteed to extend what the client already consumed — so the
    client owns this retry. Carries `tokens_delivered`."""

    def __init__(self, msg: str, tokens_delivered: int):
        super().__init__(msg)
        self.tokens_delivered = int(tokens_delivered)


class _Replica:
    """Router-side view of one replica endpoint."""

    __slots__ = ("endpoint", "breaker", "healthy", "consec_fail",
                 "load", "inflight", "picks", "source", "last_error",
                 "last_state", "models")

    def __init__(self, endpoint: str, breaker: CircuitBreaker,
                 source: str):
        self.endpoint = endpoint
        self.breaker = breaker
        self.healthy = True      # optimistic: first probe corrects it
        self.consec_fail = 0
        self.load = 0.0          # cached /v1/load scalar
        self.inflight = 0        # router-local in-flight delta
        self.picks = 0
        self.source = source     # "static" | "rendezvous"
        self.last_error: Optional[str] = None
        self.last_state: Optional[str] = None
        # model ids the replica advertises in /v1/load; None = the
        # replica predates the field (or no poll yet) = serves anything
        self.models: Optional[frozenset] = None


class Router:
    """Load-balancing front tier over N replica endpoints — see the
    module docstring for the algorithm. Thread-safe: the HTTP frontend
    calls predict()/generate() from concurrent handler threads."""

    def __init__(self, endpoints: Sequence[str] = (), *,
                 rdzv_dir: Optional[str] = None,
                 rendezvous=None,
                 poll_interval_s: float = 0.25,
                 probe_timeout_s: float = 2.0,
                 eject_threshold: int = 2,
                 retries: int = 2,
                 request_timeout_s: float = 30.0,
                 breaker_threshold: int = 3,
                 breaker_reset_s: float = 2.0):
        if rdzv_dir is not None and rendezvous is not None:
            raise ValueError("pass rdzv_dir OR a rendezvous, not both")
        if rendezvous is None and rdzv_dir is not None:
            from ..distributed.rendezvous import FileRendezvous

            # scan-only membership view: the router never register()s,
            # so it is not a member — it just reads live heartbeats
            rendezvous = FileRendezvous(
                rdzv_dir, worker_id="fleet-router", min_workers=1)
        self._rdzv = rendezvous
        self.poll_interval_s = float(poll_interval_s)
        self.probe_timeout_s = float(probe_timeout_s)
        self.eject_threshold = int(eject_threshold)
        self.retries = int(retries)
        self.request_timeout_s = float(request_timeout_s)
        self._breaker_threshold = int(breaker_threshold)
        self._breaker_reset_s = float(breaker_reset_s)
        # a plain lock: the port has no lock-order checker (the JAX
        # package's analysis.lockcheck, ROADMAP item 21)
        self._lock = threading.Lock()
        self._replicas: Dict[str, _Replica] = {}
        self._counts = {"ok": 0, "error": 0, "rejected": 0, "timeout": 0}
        self._retry_counts: Dict[str, int] = {}
        # sliding latency window for the autoscaler's p99 gauge:
        # (monotonic ts, seconds) of recent successful predicts
        self._lat_window: "deque[Tuple[float, float]]" = deque(maxlen=1024)
        self._poll_stop = threading.Event()
        self._poll_thread: Optional[threading.Thread] = None
        self._rng = random.Random(0x5EED)
        for ep in endpoints:
            self._ensure_replica(str(ep), source="static")

    # -- membership ----------------------------------------------------

    def _make_breaker(self, endpoint: str) -> CircuitBreaker:
        def on_transition(old, new, _ep=endpoint):
            BREAKER_STATE.set(_BREAKER_LEVEL[new], endpoint=_ep)
            _events.emit("fleet", action="breaker", endpoint=_ep,
                         old=old, new=new)

        return CircuitBreaker(failure_threshold=self._breaker_threshold,
                              reset_timeout_s=self._breaker_reset_s,
                              on_transition=on_transition)

    def _ensure_replica(self, endpoint: str, source: str) -> _Replica:
        with self._lock:
            rep = self._replicas.get(endpoint)
            if rep is None:
                rep = _Replica(endpoint, self._make_breaker(endpoint),
                               source)
                self._replicas[endpoint] = rep
                joined = True
            else:
                joined = False
        if joined:
            BREAKER_STATE.set(0, endpoint=endpoint)
            _events.emit("fleet", action="member_join", endpoint=endpoint,
                         source=source)
            self._set_gauges()
        return rep

    def add_replica(self, endpoint: str):
        """Statically add one replica endpoint ("host:port")."""
        self._ensure_replica(str(endpoint), source="static")

    def remove_replica(self, endpoint: str):
        """Drop one endpoint from the pick set (scale-in bookkeeping;
        rendezvous-sourced members leave automatically)."""
        with self._lock:
            rep = self._replicas.pop(str(endpoint), None)
        if rep is not None:
            _events.emit("fleet", action="member_leave",
                         endpoint=rep.endpoint, source=rep.source)
            self._set_gauges()

    def endpoints(self) -> List[str]:
        with self._lock:
            return sorted(self._replicas)

    def healthy_endpoints(self) -> List[str]:
        with self._lock:
            return sorted(ep for ep, r in self._replicas.items()
                          if r.healthy)

    # -- background poll (membership + health + load) ------------------

    def start(self):
        """Start the poll thread (idempotent). Without it the router
        still works — ejection then happens only through request-path
        failures and membership stays static."""
        with self._lock:
            if self._poll_thread is not None \
                    and self._poll_thread.is_alive():
                return
            self._poll_stop.clear()
            self._poll_thread = threading.Thread(
                target=self._poll_loop, name="paddle-tpu-fleet-router",
                daemon=True)
            self._poll_thread.start()

    def stop(self):
        """Stop and join the poll thread. Idempotent."""
        self._poll_stop.set()
        with self._lock:
            t, self._poll_thread = self._poll_thread, None
        if t is not None:
            t.join(timeout=10.0)

    def _poll_loop(self):
        while not self._poll_stop.is_set():
            try:
                self.poll_once()
            except Exception as e:  # poll must never die; next tick retries
                _events.emit("fleet", action="poll_error",
                             error=f"{type(e).__name__}: {e}"[:200])
            self._poll_stop.wait(self.poll_interval_s)

    def poll_once(self):
        """One membership + health + load sweep (the poll thread's
        body, callable directly from tests and single-threaded
        drivers)."""
        if self._rdzv is not None:
            live = set(self._rdzv.live_members())
            for ep in live:
                self._ensure_replica(ep, source="rendezvous")
            with self._lock:
                gone = [ep for ep, r in self._replicas.items()
                        if r.source == "rendezvous" and ep not in live]
            for ep in gone:
                self.remove_replica(ep)
        with self._lock:
            targets = list(self._replicas.values())
        for rep in targets:
            self._probe(rep)
        self._set_gauges()

    def _probe(self, rep: _Replica):
        """Health + load probe of one replica (no lock held — these are
        blocking socket calls)."""
        try:
            code, body = self._get_json(rep.endpoint, "/v1/healthz",
                                        self.probe_timeout_s)
        except Exception as e:
            self._health_result(rep, ok=False,
                                error=f"{type(e).__name__}: {e}")
            return
        state = body.get("state") if isinstance(body, dict) else None
        rep.last_state = state
        if code != 200:
            self._health_result(rep, ok=False,
                                error=f"healthz {code} state={state}")
            return
        self._health_result(rep, ok=True)
        try:
            code, load = self._get_json(rep.endpoint, "/v1/load",
                                        self.probe_timeout_s)
            if code == 200 and isinstance(load, dict):
                models = load.get("models")
                with self._lock:
                    rep.load = float(load.get("load", 0.0))
                    if isinstance(models, (list, tuple)):
                        rep.models = frozenset(str(m) for m in models)
        except Exception:
            # load staleness is benign (health just passed); the next
            # poll refreshes it
            pass  # lint-exempt:swallow: stale load is self-healing

    def _health_result(self, rep: _Replica, ok: bool,
                       error: Optional[str] = None):
        with self._lock:
            if ok:
                rep.consec_fail = 0
                rep.last_error = None
                readmit = not rep.healthy
                rep.healthy = True
            else:
                readmit = False
                rep.consec_fail += 1
                rep.last_error = error
                if rep.healthy \
                        and rep.consec_fail >= self.eject_threshold:
                    rep.healthy = False
                    ejected = True
                else:
                    ejected = False
        if ok and readmit:
            READMISSIONS.inc(endpoint=rep.endpoint)
            _events.emit("fleet", action="readmit", endpoint=rep.endpoint)
            self._set_gauges()
        elif not ok and ejected:
            EJECTIONS.inc(endpoint=rep.endpoint)
            _events.emit("fleet", action="eject", endpoint=rep.endpoint,
                         reason=error, consec_fail=rep.consec_fail)
            self._set_gauges()

    def _eject_now(self, rep: _Replica, reason: str):
        """Request-path ejection: a connect failure means the replica
        is gone NOW — waiting out `eject_threshold` poll intervals
        would burn every retry on a corpse. The next passing health
        probe readmits it."""
        with self._lock:
            was = rep.healthy
            rep.healthy = False
            rep.consec_fail = max(rep.consec_fail, self.eject_threshold)
            rep.last_error = reason
        if was:
            EJECTIONS.inc(endpoint=rep.endpoint)
            _events.emit("fleet", action="eject", endpoint=rep.endpoint,
                         reason=reason, path="request")
            self._set_gauges()

    def _set_gauges(self):
        with self._lock:
            healthy = sum(1 for r in self._replicas.values() if r.healthy)
            total = len(self._replicas)
        REPLICAS.set(healthy, state="healthy")
        REPLICAS.set(total - healthy, state="ejected")
        WORLD_SIZE.set(total)

    # -- picking (power-of-two-choices) --------------------------------

    def _pick(self, exclude: frozenset,
              model: Optional[str] = None) -> Optional[_Replica]:
        """Choose a replica: sample two healthy candidates, take the
        lower (cached load + local in-flight delta), then ask its
        breaker. A breaker refusal excludes the candidate and re-picks,
        so an un-chosen candidate never consumes the half-open probe
        slot. `model` restricts candidates to replicas advertising that
        model id (None advertisement = serves anything). Returns None
        when nothing is admissible."""
        tried = set(exclude)
        while True:
            with self._lock:
                cands = [r for r in self._replicas.values()
                         if r.healthy and r.endpoint not in tried
                         and (model is None or r.models is None
                              or model in r.models)]
                if not cands:
                    return None
                if len(cands) > 2:
                    cands = self._rng.sample(cands, 2)
                rep = min(cands, key=lambda r: r.load + r.inflight)
            # allow() outside the router lock: it takes the breaker's
            # own lock and may fire transition hooks
            if rep.breaker.allow():
                with self._lock:
                    rep.picks += 1
                    rep.inflight += 1
                PICKS.inc(endpoint=rep.endpoint)
                return rep
            tried.add(rep.endpoint)

    def _release(self, rep: _Replica):
        with self._lock:
            rep.inflight = max(0, rep.inflight - 1)

    # -- HTTP plumbing -------------------------------------------------

    @staticmethod
    def _get_json(endpoint: str, path: str, timeout: float):
        # lint-exempt:traceheader: health/load probes are poll-loop work, not request-scoped
        req = urllib.request.Request(f"http://{endpoint}{path}")
        try:
            with urllib.request.urlopen(req, timeout=timeout) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            try:
                body = json.loads(e.read())
            except ValueError:
                body = {}
            return e.code, body

    @staticmethod
    def _post(endpoint: str, path: str, payload: Dict, timeout: float):
        """POST JSON; returns (code, parsed-body). Wire-level failures
        (refused/reset/timeout) raise OSError/URLError for the caller's
        retry classification. The ambient trace context (the attempt
        span _route_predict activates) is injected as `traceparent` so
        the replica's spans join this request's trace."""
        body = json.dumps(_json_safe(payload)).encode()
        req = urllib.request.Request(
            f"http://{endpoint}{path}", data=body,
            headers={"Content-Type": "application/json",
                     **_tracing.trace_headers()})
        try:
            with urllib.request.urlopen(req, timeout=timeout) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            try:
                parsed = json.loads(e.read())
            except ValueError:
                parsed = {}
            return e.code, parsed

    # -- request path --------------------------------------------------

    def _finish(self, outcome: str, t0: Optional[float] = None):
        REQUESTS.inc(outcome=outcome)
        with self._lock:
            self._counts[outcome] += 1
            if outcome == "ok" and t0 is not None:
                dt = time.monotonic() - t0
                self._lat_window.append((time.monotonic(), dt))
        if outcome == "ok" and t0 is not None:
            REQUEST_SECONDS.observe(time.monotonic() - t0)

    def _retry(self, reason: str, rep: _Replica, error: str):
        RETRIES.inc(reason=reason)
        with self._lock:
            self._retry_counts[reason] = \
                self._retry_counts.get(reason, 0) + 1
        _events.emit("fleet", action="retry", reason=reason,
                     endpoint=rep.endpoint, error=error[:200])

    def _shed_answer(self, rep: _Replica, body: Dict):
        """Classify a replica's typed shed 503 as the request's ANSWER
        (metric + event + counts), then raise TierShed — never called
        on a path that would fail over afterwards."""
        tier = str(body.get("shed"))
        FLEET_SHEDS.inc(tier=tier)
        _events.emit("fleet", action="shed", endpoint=rep.endpoint,
                     tier=tier, shed=body.get("kind"),
                     tenant=body.get("tenant"))
        self._finish("rejected")
        try:
            retry_after = float(body.get("retry_after_s", 1.0))
        except (TypeError, ValueError):
            retry_after = 1.0
        raise TierShed(str(body.get("error") or f"request shed "
                           f"(tier {tier})"),
                       body=body, retry_after_s=retry_after)

    def predict(self, feeds: Dict, timeout_s: Optional[float] = None,
                model: Optional[str] = None,
                tenant: Optional[str] = None) -> Dict:
        """Route one idempotent predict: pick → POST → on failure,
        fail over to a different surviving replica (`retries` times).
        `model` routes to replicas serving that model id; `tenant`
        rides to the replica's QoS admission. Raises NoReplicasError /
        ReplicaRejected / TierShed (QoS shed: an answer, not retried) /
        FleetTimeout / FleetError (replica 500 everywhere) / ValueError
        (the replica's 400 validation echo)."""
        payload = {"feeds": feeds}
        if timeout_s is not None:
            payload["timeout_s"] = timeout_s
        if model is not None:
            payload["model"] = str(model)
        if tenant is not None:
            payload["tenant"] = str(tenant)
        return self._route_predict(payload, timeout_s)

    def _route_predict(self, payload: Dict,
                       timeout_s: Optional[float]) -> Dict:
        with _tracing.trace_span("router.predict", cat="fleet"):
            return self._route_predict_traced(payload, timeout_s)

    def _route_predict_traced(self, payload: Dict,
                              timeout_s: Optional[float]) -> Dict:
        timeout = self.request_timeout_s if timeout_s is None \
            else float(timeout_s)
        model = payload.get("model")
        model = str(model) if model is not None else None
        t0 = time.monotonic()
        exclude: set = set()
        last: Tuple[str, str] = ("", "no replicas known")
        for _attempt in range(self.retries + 1):
            rep = self._pick(frozenset(exclude), model=model)
            if rep is None:
                break
            try:
                # wire budget slightly above the request deadline so the
                # replica's own 504 wins the race when it can; the
                # attempt span is what the replica's spans parent to —
                # each failover attempt is its own child of
                # router.predict, so retry time is attributed per try
                with _tracing.trace_span("router.attempt", cat="fleet",
                                         endpoint=rep.endpoint,
                                         attempt=_attempt):
                    code, body = self._post(rep.endpoint, "/v1/predict",
                                            payload, timeout + 5.0)
            except (OSError, urllib.error.URLError, socket.timeout) as e:
                # connect refused/reset/timeout: replica is gone or
                # wedged — breaker failure, immediate ejection, failover
                rep.breaker.record_failure()
                self._release(rep)
                self._eject_now(rep, f"{type(e).__name__}: {e}"[:200])
                self._retry("connect", rep, str(e))
                exclude.add(rep.endpoint)
                last = (rep.endpoint, f"{type(e).__name__}: {e}")
                continue
            except BaseException as e:
                # anything unexpected (MemoryError, injected faults,
                # KeyboardInterrupt in a worker thread): the admitted
                # call MUST report, or a half-open probe slot leaks and
                # the breaker wedges (the breaker's contract)
                rep.breaker.record_failure()
                self._release(rep)
                raise e
            self._release(rep)
            if code == 200:
                rep.breaker.record_success()
                self._finish("ok", t0)
                return body
            err = str(body.get("error", "")) if isinstance(body, dict) \
                else ""
            if code == 503:
                rep.breaker.record_success()
                if isinstance(body, dict) and body.get("shed"):
                    # QoS tier shed: a deliberate, policy-scoped
                    # ANSWER — failing over would amplify exactly the
                    # overload the shed is relieving
                    self._shed_answer(rep, body)
                self._retry("busy", rep, err)
                exclude.add(rep.endpoint)
                last = (rep.endpoint, f"503: {err}")
                continue
            if code == 404:
                # unknown model on this replica: it is alive — the
                # router's model map was just stale. No breaker
                # penalty; try a replica that does serve it.
                rep.breaker.record_success()
                self._retry("no_model", rep, err)
                exclude.add(rep.endpoint)
                last = (rep.endpoint, f"404: {err}")
                continue
            if code == 504:
                # the request's own deadline died inside the replica;
                # re-sending would double the latency damage
                rep.breaker.record_success()
                self._finish("timeout")
                raise FleetTimeout(
                    f"replica {rep.endpoint} timed out the request: "
                    f"{err}")
            if code == 400:
                # client error: deterministic — no replica will accept it
                rep.breaker.record_success()
                self._finish("error")
                raise ValueError(f"replica rejected request: {err}")
            # 5xx (and anything else): replica-side failure
            rep.breaker.record_failure()
            self._retry("server_error", rep, f"{code}: {err}")
            exclude.add(rep.endpoint)
            last = (rep.endpoint, f"{code}: {err}")
        # retries exhausted / nothing admissible
        ep, why = last
        if not exclude and ep == "":
            self._finish("rejected")
            raise NoReplicasError(
                "no healthy replica admitted the request "
                f"(known: {self.endpoints()})")
        if why.startswith("503"):
            self._finish("rejected")
            raise ReplicaRejected(
                f"every tried replica rejected the request; last "
                f"{ep}: {why}")
        self._finish("error")
        raise FleetError(
            f"request failed on every tried replica; last {ep}: {why}")

    # -- token generation ----------------------------------------------

    def generate(self, ids: Sequence[int], max_new_tokens: int = 16,
                 timeout_s: Optional[float] = None,
                 model: Optional[str] = None,
                 tenant: Optional[str] = None) -> Iterator[Dict]:
        """Streamed generation through the fleet: yields the replica's
        ndjson records ({"token": t}... then the {"done": ...} tail).
        Failover rule (SERVING.md §Fleet): a stream that dies with ZERO
        tokens delivered is resubmitted from scratch on another
        replica; once a token has been yielded a failure raises
        StreamBrokenError — the router will not splice two generations
        together. A QoS tier shed raises TierShed without failover;
        `model` restricts the pick to replicas serving that id."""
        timeout = self.request_timeout_s if timeout_s is None \
            else float(timeout_s)
        payload = {"ids": list(int(i) for i in ids),
                   "max_new_tokens": int(max_new_tokens),
                   "stream": True}
        if model is not None:
            payload["model"] = str(model)
        if tenant is not None:
            payload["tenant"] = str(tenant)
        # captured ONCE: the generator body runs on the consumer's
        # thread across yields, so the ambient contextvar must not be
        # mutated here — per-attempt children are minted explicitly and
        # handed to _stream_one for header injection
        tctx = _tracing.current_trace()
        exclude: set = set()
        last: Tuple[str, str] = ("", "no replicas known")
        for _attempt in range(self.retries + 1):
            rep = self._pick(frozenset(exclude),
                             model=payload.get("model"))
            if rep is None:
                break
            delivered = 0
            child = tctx.child() \
                if tctx is not None and tctx.sampled else tctx
            t0a = time.perf_counter()
            try:
                try:
                    for rec in self._stream_one(rep, payload, timeout,
                                                tctx=child):
                        if "token" in rec:
                            delivered += 1
                        yield rec
                finally:
                    _tracing.record_span_ctx(
                        child, "router.generate", time.perf_counter() -
                        t0a, cat="fleet", t0_perf=t0a,
                        endpoint=rep.endpoint, attempt=_attempt,
                        tokens=delivered)
                rep.breaker.record_success()
                self._release(rep)
                self._finish("ok")
                return
            except (OSError, urllib.error.URLError, socket.timeout,
                    http.client.HTTPException, ValueError) as e:
                # http.client.IncompleteRead is how an abruptly closed
                # chunked stream surfaces — a broken stream, same as a
                # reset socket
                rep.breaker.record_failure()
                self._release(rep)
                self._eject_now(rep, f"{type(e).__name__}: {e}"[:200])
                if delivered:
                    self._finish("error")
                    _events.emit("fleet", action="stream_broken",
                                 endpoint=rep.endpoint, tokens=delivered)
                    raise StreamBrokenError(
                        f"stream from {rep.endpoint} died after "
                        f"{delivered} token(s); resubmit is the "
                        f"client's call", tokens_delivered=delivered)
                self._retry("stream_restart", rep, str(e))
                exclude.add(rep.endpoint)
                last = (rep.endpoint, f"{type(e).__name__}: {e}")
                continue
            except _ReplicaShed as e:
                # QoS tier shed: the ANSWER — no failover, no penalty
                rep.breaker.record_success()
                self._release(rep)
                self._shed_answer(rep, e.body)
            except _ReplicaBusy as e:
                rep.breaker.record_success()
                self._release(rep)
                self._retry("busy", rep, str(e))
                exclude.add(rep.endpoint)
                last = (rep.endpoint, f"503: {e}")
                continue
            except _ReplicaHTTPError as e:
                self._release(rep)
                if e.code == 404:
                    # unknown model here: alive replica, stale model
                    # map — fail over without a breaker penalty
                    rep.breaker.record_success()
                    self._retry("no_model", rep, str(e))
                    exclude.add(rep.endpoint)
                    last = (rep.endpoint, f"404: {e}")
                    continue
                if e.code == 400:
                    # deterministic client error: every replica would
                    # reject it the same way — no retry, no breaker
                    # penalty (the replica behaved correctly)
                    rep.breaker.record_success()
                    self._finish("error")
                    raise ValueError(f"replica rejected generation: "
                                     f"{e}") from None
                # replica-side 5xx: breaker failure + failover, but NO
                # health ejection — the replica answered, it is not gone
                rep.breaker.record_failure()
                self._retry("server_error", rep, f"{e.code}: {e}")
                exclude.add(rep.endpoint)
                last = (rep.endpoint, f"{e.code}: {e}")
                continue
            except GeneratorExit:
                # the CLIENT abandoned the stream (frontend disconnect)
                # — the replica did nothing wrong, but the admitted
                # breaker call must still report to release a probe slot
                rep.breaker.record_success()
                self._release(rep)
                raise
            except BaseException:
                rep.breaker.record_failure()
                self._release(rep)
                raise
        ep, why = last
        self._finish("rejected" if why.startswith("503") else "error")
        raise NoReplicasError(
            f"no replica could serve the generation; last {ep}: {why}")

    def _stream_one(self, rep: _Replica, payload: Dict,
                    timeout: float, tctx=None) -> Iterator[Dict]:
        body = json.dumps(payload).encode()
        req = urllib.request.Request(
            f"http://{rep.endpoint}/v1/generate", data=body,
            headers={"Content-Type": "application/json",
                     **_tracing.trace_headers(tctx)})
        try:
            resp = urllib.request.urlopen(req, timeout=timeout)
        except urllib.error.HTTPError as e:
            try:
                parsed = json.loads(e.read())
            except ValueError:
                parsed = {}
            if not isinstance(parsed, dict):
                parsed = {}
            err = str(parsed.get("error", ""))
            if e.code == 503:
                if parsed.get("shed"):
                    raise _ReplicaShed(parsed)
                raise _ReplicaBusy(err or "replica busy")
            # any other HTTP status: the replica answered — this is NOT
            # a broken wire, and must not ride the URLError-subclass
            # path into record_failure + ejection
            raise _ReplicaHTTPError(e.code, err or f"HTTP {e.code}")
        done = False
        with resp:
            while True:
                line = resp.readline()
                if not line:
                    break
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)  # ValueError → broken stream
                if rec.get("done") and rec.get("error"):
                    # replica-side mid-stream failure travels in-band
                    raise ValueError(f"replica error: {rec['error']}")
                if rec.get("done"):
                    done = True
                yield rec
        if not done:
            # a complete ndjson stream ends with a {"done": ...}
            # record; EOF without one means the replica died with the
            # socket closing cleanly — that is a broken stream, not an
            # empty generation
            raise ValueError("stream ended without a done record")

    # -- status --------------------------------------------------------

    def mean_load_per_healthy(self,
                              model: Optional[str] = None
                              ) -> Optional[float]:
        """Mean (cached load + in-flight) across healthy replicas —
        the autoscaler's utilization signal. `model` scopes the mean
        to replicas advertising that model id (per-model autoscaling,
        SERVING.md §Multi-tenancy). None when no replica qualifies
        (which is its own, louder signal)."""
        with self._lock:
            loads = [r.load + r.inflight
                     for r in self._replicas.values()
                     if r.healthy and (model is None or r.models is None
                                       or model in r.models)]
        if not loads:
            return None
        return sum(loads) / len(loads)

    def recent_p99(self, window_s: float = 30.0) -> Optional[float]:
        """p99 of successful predict latencies (seconds) inside the
        trailing `window_s` — the autoscaler's latency signal."""
        cutoff = time.monotonic() - float(window_s)
        with self._lock:
            xs = sorted(dt for (ts, dt) in self._lat_window
                        if ts >= cutoff)
        if not xs:
            return None
        return xs[min(len(xs) - 1, int(round(0.99 * (len(xs) - 1))))]

    def profile(self, seconds: float = 1.0,
                replica: Optional[str] = None,
                timeout_s: Optional[float] = None) -> Dict:
        """Fan POST /v1/profile across the healthy fleet — or at ONE
        member when `replica` names an endpoint — and collect each
        capture's artifact paths. Replicas trace concurrently (one
        thread per target), so a fleet-wide capture covers the same
        wall window on every member; per-replica wire failures land in
        that replica's entry instead of failing the whole fan-out.
        Raises NoReplicasError when nothing is targetable."""
        if replica is not None:
            if replica not in self.endpoints():
                raise NoReplicasError(
                    f"unknown replica {replica!r}; members: "
                    f"{self.endpoints()}")
            targets = [replica]
        else:
            targets = self.healthy_endpoints()
            if not targets:
                raise NoReplicasError("no healthy replicas to profile")
        # the reply can only come back after the capture window closes,
        # so the per-replica HTTP timeout must cover window + export
        timeout = float(timeout_s) if timeout_s is not None \
            else float(seconds) + 30.0
        results: Dict[str, Dict] = {}

        def one(ep):
            try:
                code, body = self._post(
                    ep, "/v1/profile", {"seconds": float(seconds)},
                    timeout)
            except (OSError, urllib.error.URLError) as e:
                code, body = None, {"error": str(e)}
            if not isinstance(body, dict):
                body = {"body": body}
            results[ep] = {"code": code, **body}

        threads = [threading.Thread(target=one, args=(ep,),
                                    daemon=True) for ep in targets]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=timeout + 10.0)
        ok = sum(1 for r in results.values() if r.get("code") == 200)
        _events.emit("profile", action="fleet", seconds=float(seconds),
                     targets=len(targets), ok=ok)
        return {"seconds": float(seconds), "targets": len(targets),
                "ok": ok, "replicas": results}

    def status(self) -> Dict:
        with self._lock:
            reps = [{
                "endpoint": r.endpoint,
                "healthy": r.healthy,
                "state": r.last_state,
                "breaker": r.breaker.state,
                "load": r.load,
                "inflight": r.inflight,
                "picks": r.picks,
                "consec_fail": r.consec_fail,
                "source": r.source,
                "error": r.last_error,
                "models": sorted(r.models)
                if r.models is not None else None,
            } for r in sorted(self._replicas.values(),
                              key=lambda r: r.endpoint)]
            counts = dict(self._counts)
            retry_counts = dict(self._retry_counts)
        p99 = self.recent_p99()
        return {
            "fleet": True,
            "world_size": len(reps),
            "healthy": sum(1 for r in reps if r["healthy"]),
            "replicas": reps,
            "requests": counts,
            "retries": retry_counts,
            "recent_p99_ms": round(p99 * 1000, 3) if p99 else None,
            "elastic": self._rdzv is not None,
        }


class _ReplicaBusy(RuntimeError):
    """Internal: replica answered 503 to a generate submit."""


class _ReplicaShed(RuntimeError):
    """Internal: replica answered a generate submit with a typed QoS
    shed 503 — an answer, not saturation. Carries the parsed body."""

    def __init__(self, body: Dict):
        super().__init__(str(body.get("error", "request shed")))
        self.body = dict(body)


class _ReplicaHTTPError(RuntimeError):
    """Internal: replica answered a generate submit with a non-503
    HTTP error — the replica is alive and talking, so this must not be
    classified as a broken wire (no ejection; 400 is not even a
    breaker failure)."""

    def __init__(self, code: int, msg: str):
        super().__init__(msg)
        self.code = int(code)


# ---------------------------------------------------------------------------
# HTTP frontend
# ---------------------------------------------------------------------------


class _RouterHandler(_base.QuietHandler):
    server_version = "paddle-tpu-fleet-router"
    protocol_version = "HTTP/1.1"
    router_server: "RouterServer" = None  # bound per-server subclass
    _tctx = None  # per-request TraceContext, set at the top of do_*

    def _json_reply(self, code: int, payload: Dict, headers=None):
        hdrs = dict(headers or {})
        hdrs.update(_tracing.response_headers(self._tctx))
        self._reply(code, "application/json",
                    json.dumps(_json_safe(payload)) + "\n",
                    extra_headers=hdrs)

    def _shed_reply(self, e: TierShed):
        """Propagate a replica's typed QoS shed 503 unchanged: the
        body ({"shed": tier, ...}) and Retry-After the replica chose —
        clients of the fleet see exactly what single-replica clients
        see."""
        self._json_reply(
            503, e.body or {"error": str(e), "shed": e.tier},
            headers={"Retry-After":
                     str(max(1, int(round(e.retry_after_s))))})

    def do_GET(self):  # noqa: N802 - stdlib naming
        try:
            self._tctx = _tracing.begin_request(self.headers)
            path = urlparse(self.path).path
            router = self.router_server.router
            if path == "/v1/status":
                self._json_reply(200, router.status())
            elif path == "/v1/healthz":
                healthy = len(router.healthy_endpoints())
                self._json_reply(
                    200 if healthy else 503,
                    {"status": "ok" if healthy else "unavailable",
                     "state": "serving" if healthy else "no_replicas",
                     "healthy_replicas": healthy})
            else:
                self._reply(404, "text/plain",
                            "not found; routes: POST /v1/predict "
                            "/v1/generate, GET /v1/status /v1/healthz\n")
        except _base.CLIENT_GONE:
            pass

    def _chunk(self, line: str):
        data = line.encode("utf-8")
        self.wfile.write(f"{len(data):x}\r\n".encode())
        self.wfile.write(data)
        self.wfile.write(b"\r\n")
        self.wfile.flush()

    def _do_generate(self, payload: Dict):
        # the trace ROOT at the fleet edge (or a child of the caller's
        # context): router.generate children mint per-attempt spans and
        # inject traceparent into the upstream replica call
        with _tracing.trace_span("router.http_generate", cat="fleet",
                                 ctx=self._tctx):
            self._do_generate_traced(payload)

    def _do_generate_traced(self, payload: Dict):
        router = self.router_server.router
        ids = payload.get("ids")
        if not isinstance(ids, (list, tuple)) or not ids:
            self._json_reply(400, {"error": 'missing/empty "ids" list'})
            return
        stream = bool(payload.get("stream", True))
        try:
            # parse errors are the CLIENT's (non-numeric ids /
            # max_new_tokens / timeout_s): 400 here, never a dropped
            # connection from a dead handler thread
            ids = [int(i) for i in ids]
            timeout = payload.get("timeout_s")
            kw = dict(max_new_tokens=int(payload.get("max_new_tokens",
                                                     16)),
                      timeout_s=float(timeout)
                      if timeout is not None else None,
                      model=payload.get("model"),
                      tenant=payload.get("tenant"))
        except (ValueError, TypeError) as e:
            self._json_reply(400, {"error": f"malformed generate "
                                           f"request: {e}"})
            return
        if not stream:
            toks, tail = [], {}
            try:
                for rec in router.generate(ids, **kw):
                    if "token" in rec:
                        toks.append(int(rec["token"]))
                    elif rec.get("done"):
                        tail = rec
            except TierShed as e:
                self._shed_reply(e)
                return
            except (NoReplicasError, ReplicaRejected) as e:
                self._json_reply(503, {"error": str(e)})
                return
            except ValueError as e:
                # the replica's own 400 echoed through the fleet
                self._json_reply(400, {"error": str(e)})
                return
            except StreamBrokenError as e:
                self._json_reply(502, {
                    "error": str(e), "type": "StreamBrokenError",
                    "tokens_delivered": e.tokens_delivered})
                return
            except FleetError as e:
                self._json_reply(502, {"error": str(e)})
                return
            self._json_reply(200, {
                "tokens": toks,
                "finish_reason": tail.get("finish_reason"),
                "ttft_ms": tail.get("ttft_ms")})
            return
        # streaming proxy: the first record decides failover, so pull it
        # before committing the 200 (a pre-token failure must fail over
        # inside router.generate, not half-reply to the client)
        gen = router.generate(ids, **kw)
        try:
            first = next(gen)
        except StopIteration:
            self._json_reply(502, {"error": "empty stream from fleet"})
            return
        except TierShed as e:
            self._shed_reply(e)
            return
        except (NoReplicasError, ReplicaRejected) as e:
            self._json_reply(503, {"error": str(e)})
            return
        except ValueError as e:
            self._json_reply(400, {"error": str(e)})
            return
        except FleetError as e:
            self._json_reply(502, {"error": str(e)})
            return
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.send_header("Transfer-Encoding", "chunked")
        self.send_header("Cache-Control", "no-cache")
        for name, value in _tracing.response_headers(self._tctx).items():
            self.send_header(name, value)
        self.end_headers()
        try:
            self._chunk(json.dumps(_json_safe(first)) + "\n")
            for rec in gen:
                self._chunk(json.dumps(_json_safe(rec)) + "\n")
        except _base.CLIENT_GONE:
            gen.close()  # abandons the upstream replica stream too
            return
        except StreamBrokenError as e:
            try:
                self._chunk(json.dumps({
                    "done": True, "error": str(e),
                    "type": "StreamBrokenError",
                    "tokens_delivered": e.tokens_delivered}) + "\n")
            except _base.CLIENT_GONE:
                return
        except FleetError as e:
            try:
                self._chunk(json.dumps({"done": True,
                                        "error": str(e)}) + "\n")
            except _base.CLIENT_GONE:
                return
        self.wfile.write(b"0\r\n\r\n")
        self.wfile.flush()
        self.close_connection = True

    def _do_profile(self, query: str, payload: Dict):
        """POST /v1/profile[?replica=host:port] — proxy the capture to
        one replica or fan it across the healthy fleet. The reply
        aggregates each member's artifact paths (or its failure)."""
        try:
            seconds = float(payload.get("seconds", 1.0))
        except (TypeError, ValueError):
            self._json_reply(400, {"error": '"seconds" must be a '
                                            'number'})
            return
        replica = parse_qs(query).get("replica", [None])[0] \
            or payload.get("replica")
        router = self.router_server.router
        try:
            body = router.profile(seconds, replica=replica,
                                  timeout_s=payload.get("timeout_s"))
        except NoReplicasError as e:
            self._json_reply(503, {"error": str(e)})
            return
        except FleetError as e:
            self._json_reply(502, {"error": str(e)})
            return
        self._json_reply(200, body)

    def do_POST(self):  # noqa: N802 - stdlib naming
        try:
            # trace root at the fleet edge: extract the caller's
            # traceparent or start (head-sample) a fresh trace; every
            # reply echoes X-Request-Id + traceparent
            self._tctx = _tracing.begin_request(self.headers)
            url = urlparse(self.path)
            path = url.path
            if path not in ("/v1/predict", "/v1/generate",
                            "/v1/profile"):
                self._reply(404, "text/plain",
                            "not found; POST routes: /v1/predict, "
                            "/v1/generate, /v1/profile\n")
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                payload = json.loads(self.rfile.read(length) or b"{}") \
                    if length else {}
            except (ValueError, TypeError):
                self._json_reply(400, {"error": "body must be JSON"})
                return
            if not isinstance(payload, dict):
                self._json_reply(400, {"error": "body must be a JSON "
                                                "object"})
                return
            if path == "/v1/profile":
                self._do_profile(url.query, payload)
                return
            if path == "/v1/generate":
                self._do_generate(payload)
                return
            feeds = payload.get("feeds")
            if not isinstance(feeds, dict) or not feeds:
                self._json_reply(400, {"error":
                                       'missing/empty "feeds" object'})
                return
            router = self.router_server.router
            try:
                with _tracing.activate(self._tctx):
                    body = router._route_predict(
                        payload, payload.get("timeout_s"))
            except TierShed as e:
                self._shed_reply(e)
                return
            except (NoReplicasError, ReplicaRejected) as e:
                self._json_reply(503, {"error": str(e)},
                                 headers={"Retry-After": "1"})
                return
            except FleetTimeout as e:
                self._json_reply(504, {"error": str(e)})
                return
            except ValueError as e:
                self._json_reply(400, {"error": str(e)})
                return
            except FleetError as e:
                self._json_reply(502, {"error": str(e)})
                return
            self._json_reply(200, body)
        except _base.CLIENT_GONE:
            pass


class RouterServer:
    """HTTP face of the fleet: the same /v1 surface as a single
    replica, served by a Router. start() begins polling + listening;
    stop() is idempotent and atexit-safe."""

    def __init__(self, router: Router, host: Optional[str] = None):
        self.router = router
        handler = type("_BoundRouterHandler", (_RouterHandler,),
                       {"router_server": self})
        self._http = _base.HTTPServerHandle(
            handler, thread_name="paddle-tpu-fleet-router-http")
        self._host = host

    def start(self, port: int = 0) -> int:
        self.router.start()
        try:
            return self._http.start(port, host=self._host)
        except BaseException:
            self.router.stop()  # failed bind must not leak the poller
            raise

    def stop(self):
        self._http.stop()
        self.router.stop()

    def port(self) -> Optional[int]:
        return self._http.port()
