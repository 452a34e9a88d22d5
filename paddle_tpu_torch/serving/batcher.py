"""Bounded-queue micro-batcher: coalesce concurrent requests into
bucket-shaped batches under a latency deadline. Counterpart of the JAX
package's `serving/batcher.py`.

The core serving trade (Clipper NSDI'17, ORCA OSDI'22): a request
arriving alone pays the full host round-trip for a bs=1 dispatch, but
requests arriving together can share one bucket-shaped dispatch. The
batcher thread takes the oldest pending request, waits up to
`max_wait_ms` for companions that fit the same signature, concatenates
them up to the largest bucket, and dispatches once.

Admission control is reject-not-block: when `max_queue` requests are
already pending, `submit()` raises `QueueFullError` immediately (the
HTTP frontend maps it to 503). Each request also carries its own
deadline; expired requests are dropped at dispatch time and their
callers get `RequestTimeout` (504). `stop()` drains: no new admissions,
pending work completes, the thread exits. An exception of the engine
reaches every caller of its batch as `EngineError` (500).

With a QoS policy (`Batcher(qos=...)`, a `qos.QoSPolicy` or its
`from_spec` dict) the overload answer is tiered instead of global: a
full queue sheds the lowest-tier request, newest first within the tier
(which may be a queued victim rather than the arrival), through
`qos.ShedError`; per-tenant quotas cap one tenant's queued plus
in-flight requests; and the batch head is picked by (tier,
weighted-fair virtual time) instead of strict FIFO, so tenants within a
tier share dispatched rows in proportion to their weights. Without a
policy a full queue raises a plain `QueueFullError`.

Requests coalesce only when their non-batch signature (feed names,
trailing dims, dtypes) matches — mixed-signature traffic simply forms
separate batches. The metrics (`paddle_tpu_serving_queue_depth`,
`..._queue_wait_seconds`, `..._request_seconds`,
`..._requests_total{outcome}`, `..._batch_rows`) and the
`serve.queue_wait` and `serve.batch` trace spans are the JAX package's,
and so are the per-tenant ones of `qos.py`.
"""

from __future__ import annotations

import threading
import time
from typing import TYPE_CHECKING, Callable, Dict, List, Optional

import numpy as np

from ..observability import events as _events
from ..observability import metrics as _m
from ..observability import tracing as _tracing
from .bucketing import BucketPolicy, common_batch

if TYPE_CHECKING:  # qos.py imports batcher; runtime import is deferred
    from .qos import WeightedFairScheduler

__all__ = ["Batcher", "EngineError", "QueueFullError", "RequestTimeout",
           "ServerClosed"]

class QueueFullError(RuntimeError):
    """Admission control: max_queue requests already pending (HTTP 503)."""


class ServerClosed(RuntimeError):
    """Submitted during/after shutdown drain (HTTP 503)."""


class RequestTimeout(RuntimeError):
    """The request missed its deadline while queued or in flight (504)."""


class EngineError(RuntimeError):
    """The engine raised while executing a dispatched batch (HTTP 500).
    Distinct from pre-enqueue validation ValueErrors (HTTP 400): a model
    failure is the server's fault, not the client's — the original
    exception is chained as __cause__."""


QUEUE_DEPTH = _m.gauge(
    "paddle_tpu_serving_queue_depth",
    "Requests waiting in the batcher queue")
QUEUE_WAIT_SECONDS = _m.histogram(
    "paddle_tpu_serving_queue_wait_seconds",
    "Seconds a request waited in the queue before dispatch")
REQUEST_SECONDS = _m.histogram(
    "paddle_tpu_serving_request_seconds",
    "End-to-end request latency (submit to result, successful only)")
REQUESTS = _m.counter(
    "paddle_tpu_serving_requests_total",
    "Requests by outcome (ok|rejected|timeout|error)",
    labelnames=("outcome",))
BATCH_ROWS = _m.histogram(
    "paddle_tpu_serving_batch_rows",
    "Real (pre-padding) rows per dispatched batch",
    buckets=_m.exponential_buckets(1, 2, 12))


class _Request:
    __slots__ = ("feeds", "n", "sig", "enqueue_t", "deadline",
                 "event", "result", "error", "tctx", "tenant", "seq")

    def __init__(self, feeds, n, sig, deadline, tenant, seq):
        self.feeds = feeds
        self.n = n
        self.sig = sig
        self.enqueue_t = time.monotonic()
        self.deadline = deadline
        self.event = threading.Event()
        self.result: Optional[Dict[str, np.ndarray]] = None
        self.error: Optional[BaseException] = None
        # captured at submit() on the CALLER's thread: the batcher
        # thread records queue-wait/batch spans against it later
        self.tctx = _tracing.current_trace()
        self.tenant = tenant
        self.seq = seq          # arrival order (shed newest-first key)


def _feed_sig(feeds: Dict[str, np.ndarray]):
    return tuple(sorted((k, v.shape[1:], str(v.dtype))
                        for k, v in feeds.items()))


class Batcher:
    """One daemon thread coalescing `submit()` calls into batches for
    `run_batch` (a callable mapping a feed dict with a common leading
    dim to an output dict with the same leading dim)."""

    def __init__(self, run_batch: Callable[[Dict[str, np.ndarray]],
                                           Dict[str, np.ndarray]],
                 policy: BucketPolicy, max_queue: int = 128,
                 max_wait_ms: float = 5.0, timeout_s: float = 30.0,
                 thread_name: str = "paddle-tpu-torch-serving-batcher",
                 output_batched: Optional[Callable[[str],
                                                   Optional[bool]]] = None,
                 qos=None):
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self._run = run_batch
        self._policy = policy
        # name -> does this output carry the batch dim? (False = share
        # whole, True = split, None/unavailable = shape heuristic). The
        # Engine plumbs the Predictor's declared-shape knowledge here so
        # a fixed leading dim that merely equals the row total is not
        # mis-split across requests.
        self._output_batched = output_batched
        self._max_queue = int(max_queue)
        self._max_wait = float(max_wait_ms) / 1000.0
        self._timeout_s = float(timeout_s)
        # per-tenant QoS (None = single-tenant FIFO). Deferred import:
        # qos.py imports THIS module for the QueueFullError base class.
        from . import qos as _qos_mod

        self._qosm = _qos_mod
        self._qos = _qos_mod.QoSPolicy.from_spec(qos)
        self._wfq: Optional["WeightedFairScheduler"] = \
            _qos_mod.WeightedFairScheduler(self._qos) \
            if self._qos is not None else None
        self._seq = 0               # arrival stamp for shed ordering
        self._inflight_by: Dict[str, int] = {}  # tenant -> dispatched
        self._cv = threading.Condition()
        self._pending: List[_Request] = []
        self._inflight = 0  # requests inside a dispatched batch right now
        self._closed = False
        # per-instance outcome counts (the REQUESTS metric is process-
        # global: concurrent servers would cross-contaminate each
        # other's /v1/status and serve_stop numbers without these)
        self._counts = {"ok": 0, "rejected": 0, "timeout": 0, "error": 0}
        self._batch_seq = 0  # links every member's batch span (tracing)
        self._thread = threading.Thread(target=self._loop,
                                        name=thread_name, daemon=True)
        self._thread.start()

    # -- client side ---------------------------------------------------

    def depth(self) -> int:
        with self._cv:
            return len(self._pending)

    def inflight(self) -> int:
        """Requests currently inside a dispatched (executing) batch —
        together with depth() this is the load probe's score."""
        with self._cv:
            return self._inflight

    def draining(self) -> bool:
        with self._cv:
            return self._closed

    def outcome_counts(self) -> Dict[str, int]:
        with self._cv:
            return dict(self._counts)

    def _finish(self, outcome: str, tenant: Optional[str] = None):
        REQUESTS.inc(outcome=outcome)
        if self._qos is not None and tenant is not None:
            self._qosm.TENANT_REQUESTS.inc(
                tenant=tenant, tier=self._qos.tier_of(tenant),
                outcome=outcome)
        with self._cv:
            self._counts[outcome] += 1

    def _shed_locked(self, tenant: str, seq: int) -> None:
        """Queue-full admission under QoS (caller holds _cv): pick the
        shed victim across queued requests AND the arrival, lowest tier
        first, newest first within the tier. A queued victim's waiting
        thread is woken with ShedError (its caller gets the typed 503)
        and the arrival is admitted in its place; when the arrival IS
        the victim, ShedError raises here."""
        qos = self._qos
        entries = [(r.tenant, r.seq) for r in self._pending] \
            + [(tenant, seq)]
        vi = self._qosm.shed_victim(entries, qos)
        v_tenant = entries[vi][0]
        v_tier = qos.tier_of(v_tenant)
        self._qosm.SHEDS.inc(tier=v_tier, kind="queue")
        _events.emit("shed", where="batcher", tenant=v_tenant,
                     tier=v_tier, shed="queue")
        err = self._qosm.ShedError(
            f"queue full ({self._max_queue} pending); shed tier "
            f"{v_tier!r} (tenant {v_tenant!r})",
            tenant=v_tenant, tier=v_tier, kind="queue")
        if vi == len(entries) - 1:
            raise err                       # the arrival is the victim
        victim = self._pending.pop(vi)
        QUEUE_DEPTH.set(len(self._pending))
        victim.error = err
        victim.event.set()

    def submit(self, feeds: Dict[str, np.ndarray],
               timeout_s: Optional[float] = None,
               tenant: Optional[str] = None) -> Dict[str, np.ndarray]:
        """Block until the request's rows come back from a dispatched
        batch. Raises QueueFullError / ServerClosed (don't queue),
        RequestTimeout (queued or dispatched but missed the deadline),
        qos.ShedError (tier-shed or over-quota under a QoS policy), or
        EngineError (the engine raised on its batch)."""
        t0 = time.monotonic()
        feeds = {k: np.asarray(v) for k, v in feeds.items()}
        if not feeds:
            raise ValueError("empty feed dict")
        n = common_batch(feeds)
        if not n:
            raise ValueError("feeds must share a leading batch dim >= 1")
        if n > self._policy.max_batch:
            raise ValueError(
                f"request batch {n} exceeds the largest bucket "
                f"{self._policy.max_batch}; split it client-side")
        timeout = self._timeout_s if timeout_s is None else float(timeout_s)
        tenant = str(tenant) if tenant else self._qosm.DEFAULT_TENANT
        with self._cv:
            if self._closed:
                self._finish("rejected", tenant)
                raise ServerClosed("server is draining; request rejected")
            qos = self._qos
            if qos is not None:
                quota = qos.quota_of(tenant)
                if quota is not None:
                    have = self._inflight_by.get(tenant, 0) + sum(
                        1 for r in self._pending if r.tenant == tenant)
                    if have >= quota:
                        tier = qos.tier_of(tenant)
                        self._qosm.SHEDS.inc(tier=tier, kind="quota")
                        _events.emit("shed", where="batcher",
                                     tenant=tenant, tier=tier,
                                     shed="quota")
                        self._finish("rejected", tenant)
                        raise self._qosm.ShedError(
                            f"tenant {tenant!r} over quota ({quota} "
                            "concurrent); request rejected",
                            tenant=tenant, tier=tier, kind="quota")
            self._seq += 1
            req = _Request(feeds, n, _feed_sig(feeds), t0 + timeout,
                           tenant, self._seq)
            if len(self._pending) >= self._max_queue:
                if qos is None:
                    self._finish("rejected", tenant)
                    raise QueueFullError(
                        f"queue full ({self._max_queue} pending); "
                        "request rejected")
                try:
                    self._shed_locked(tenant, req.seq)
                except QueueFullError:
                    self._finish("rejected", tenant)
                    raise
            self._pending.append(req)
            QUEUE_DEPTH.set(len(self._pending))
            self._cv.notify_all()
        req.event.wait(max(0.0, req.deadline - time.monotonic()))
        if not req.event.is_set():
            # still queued → pull it out so the batcher never runs it;
            # already claimed for a dispatch → result is discarded
            with self._cv:
                if req in self._pending:
                    self._pending.remove(req)
                    QUEUE_DEPTH.set(len(self._pending))
            self._finish("timeout", tenant)
            raise RequestTimeout(f"request timed out after {timeout:g}s")
        if req.error is not None:
            if isinstance(req.error, RequestTimeout):
                self._finish("timeout", tenant)
            elif isinstance(req.error, QueueFullError):
                self._finish("rejected", tenant)  # shed while queued
            else:
                self._finish("error", tenant)
            raise req.error
        self._finish("ok", tenant)
        REQUEST_SECONDS.observe(time.monotonic() - t0)
        if self._qos is not None:
            self._qosm.TENANT_REQUEST_SECONDS.observe(
                time.monotonic() - t0, tenant=tenant)
        return req.result

    # -- batcher thread ------------------------------------------------

    def _collect(self) -> List[_Request]:
        """Wait for work, honor the head request's coalescing window,
        then pull out one signature-compatible batch. Returns [] when
        closed and drained."""
        with self._cv:
            while not self._pending:
                if self._closed:
                    return []
                self._cv.wait()
            if self._wfq is not None:
                # tiered weighted-fair head pick: strict tier priority,
                # minimum virtual time within the tier (FIFO tie-break)
                head = self._pending[self._wfq.pick(
                    [r.tenant for r in self._pending])]
            else:
                head = self._pending[0]
            # coalescing window: dispatch early when a full bucket of
            # compatible rows is waiting (or on drain), else wait out
            # max_wait from the head's enqueue for companions to arrive
            deadline = head.enqueue_t + self._max_wait
            while not self._closed:
                rows = sum(r.n for r in self._pending if r.sig == head.sig)
                left = deadline - time.monotonic()
                if rows >= self._policy.max_batch or left <= 0:
                    break
                self._cv.wait(timeout=left)
                if head not in self._pending:     # head gave up (timeout)
                    return []
            now = time.monotonic()
            batch, rest, total = [], [], 0
            for r in self._pending:
                if r.deadline <= now:
                    r.error = RequestTimeout("expired while queued")
                    r.event.set()
                elif r.sig == head.sig and \
                        total + r.n <= self._policy.max_batch:
                    batch.append(r)
                    total += r.n
                else:
                    rest.append(r)
            self._pending = rest
            # claimed requests count as in-flight from the moment they
            # leave the queue until their batch resolves — the load
            # probe must not report an idle server mid-dispatch
            self._inflight = len(batch)
            self._inflight_by = {}
            for r in batch:
                self._inflight_by[r.tenant] = \
                    self._inflight_by.get(r.tenant, 0) + 1
            QUEUE_DEPTH.set(len(self._pending))
        return batch

    def _dispatch(self, batch: List[_Request]):
        now = time.monotonic()
        total = sum(r.n for r in batch)
        self._batch_seq += 1
        bid = self._batch_seq
        for r in batch:
            QUEUE_WAIT_SECONDS.observe(now - r.enqueue_t)
            # per-request queue-wait span: "did the time go to
            # coalescing wait?" answered per trace
            _tracing.record_trace_span(
                "serve.queue_wait", r.tctx, now - r.enqueue_t,
                cat="serve", rows=r.n, batch=bid, tenant=r.tenant)
            if self._wfq is not None:
                # service charge: dispatched rows advance the tenant's
                # virtual time by rows/weight
                self._wfq.charge(r.tenant, r.n)
        BATCH_ROWS.observe(total)
        feeds = {k: np.concatenate([r.feeds[k] for r in batch], axis=0)
                 for k in batch[0].feeds}
        # the first sampled member's context becomes ambient for the
        # engine dispatch, so engine spans nest under ITS trace; every
        # other sampled member gets a linking span carrying the same
        # batch id (batch membership stays reconstructable)
        lead = next((r.tctx for r in batch
                     if r.tctx is not None and r.tctx.sampled), None)
        t_run = time.monotonic()
        try:
            with _tracing.trace_span("serve.batch", cat="serve",
                                     ctx=lead, batch=bid, rows=total,
                                     members=len(batch)):
                outs = self._run(feeds)
            run_dt = time.monotonic() - t_run
            seen_lead = False
            for r in batch:
                if r.tctx is None or not r.tctx.sampled:
                    continue
                if not seen_lead and r.tctx is lead:
                    seen_lead = True
                    continue
                _tracing.record_trace_span(
                    "serve.batch", r.tctx, run_dt, cat="serve",
                    batch=bid, rows=total, members=len(batch))
            # split per request; outputs that don't carry the batch dim
            # (scalars, per-class stats) are shared whole, not sliced
            def _split(v, flag, off, n):
                if flag is False or not getattr(v, "ndim", 0) \
                        or v.shape[0] != total:
                    return v
                return v[off:off + n]

            flags = {k: self._output_batched(k)
                     if self._output_batched else None for k in outs}
            split, off = [], 0
            for r in batch:
                split.append({k: _split(v, flags[k], off, r.n)
                              for k, v in outs.items()})
                off += r.n
        except BaseException as e:  # engine/split error → every caller
            err = EngineError(f"{type(e).__name__}: {e}")
            err.__cause__ = e
            for r in batch:         # sees it; the batcher thread lives on
                r.error = err
                r.event.set()
            return
        for r, res in zip(batch, split):
            r.result = res
            r.event.set()

    def _loop(self):
        while True:
            batch = self._collect()
            if batch:
                try:
                    self._dispatch(batch)
                finally:
                    with self._cv:
                        self._inflight = 0
                        self._inflight_by = {}
                continue
            with self._cv:
                self._inflight = 0
                self._inflight_by = {}
                if self._closed and not self._pending:
                    return

    # -- lifecycle -----------------------------------------------------

    def stop(self, timeout: float = 30.0):
        """Graceful drain: stop admitting, let pending batches finish,
        join the thread. Idempotent."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        if self._thread.is_alive():
            self._thread.join(timeout=timeout)
