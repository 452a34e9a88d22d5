# Copied from the JAX package: paddle_tpu/resilience/retry.py
# (stdlib only). Keep it in step with that file; its two changes
# name this package's logger and give CircuitBreaker a plain lock.
"""Capped-exponential-backoff retry for transient I/O + circuit breaker.

Checkpoint storage on TPU pods is network-attached (GCS/NFS); transient
write failures are routine and must not kill a multi-day run, while a
persistently dead disk must still surface promptly. `retry_io` is the
one policy both the CheckpointManager and any other durable writer use:
retry only the exception types the caller names (OSError by default —
a ValueError from corrupt data is NOT transient and retrying it would
mask a real bug), with exponentially growing, capped sleeps, counting
every retry in the metrics registry so a flaky disk is visible in
/metrics long before it becomes fatal.

`CircuitBreaker` is the companion for *remote peers* (the PS tier's RPC
client): retry-with-backoff alone makes every caller independently
hammer a dead server; a shared per-peer breaker converts that into one
cheap state check. Closed = calls flow; `failure_threshold` consecutive
failures open it; while open, callers fail fast (no connect attempt)
until `reset_timeout_s` passes, after which exactly one probe is
admitted (half-open) — its success closes the breaker, its failure
re-opens it for another cooldown.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional, Tuple, Type, TypeVar

from ..observability import metrics as _m

__all__ = ["retry_io", "CircuitBreaker"]

_log = logging.getLogger("paddle_tpu_torch.resilience")

RETRIES = _m.counter(
    "paddle_tpu_io_retries_total",
    "Transient I/O failures retried with backoff", labelnames=("site",))
EXHAUSTED = _m.counter(
    "paddle_tpu_io_retries_exhausted_total",
    "I/O operations that failed every retry attempt",
    labelnames=("site",))

T = TypeVar("T")


def retry_io(fn: Callable[[], T], *, attempts: int = 3,
             base_delay_s: float = 0.1, max_delay_s: float = 5.0,
             retry_on: Tuple[Type[BaseException], ...] = (OSError,),
             site: str = "io", sleep: Callable[[float], None] = time.sleep
             ) -> T:
    """Run `fn`, retrying `retry_on` failures up to `attempts` total
    tries with capped exponential backoff (base, 2*base, 4*base, ...
    capped at `max_delay_s`). The final failure propagates unchanged.
    `sleep` is injectable so tests don't wait wall-clock time."""
    if attempts < 1:
        raise ValueError("attempts must be >= 1")
    for attempt in range(attempts):
        try:
            return fn()
        except retry_on as e:
            if attempt + 1 >= attempts:
                EXHAUSTED.inc(site=site)
                raise
            RETRIES.inc(site=site)
            delay = min(max_delay_s, base_delay_s * (2 ** attempt))
            _log.warning(
                "retry_io[%s]: attempt %d/%d failed (%s); retrying in "
                "%.2fs", site, attempt + 1, attempts, e, delay)
            sleep(delay)
    raise AssertionError("unreachable")


class CircuitBreaker:
    """Thread-safe three-state (closed/open/half-open) breaker.

    Protocol: call `allow()` before attempting the guarded operation —
    False means fail fast without trying. After the attempt, report
    `record_success()` or `record_failure()`. `allow()` returning True
    in the open state *is* the half-open probe admission: exactly one
    caller per cooldown window gets True; its outcome decides whether
    the breaker closes or re-opens.

    `on_transition(old_state, new_state)` (optional) fires outside the
    lock on every state change — metrics/eventing hook; exceptions in it
    are the caller's problem (don't raise from it).
    """

    CLOSED, HALF_OPEN, OPEN = "closed", "half_open", "open"

    def __init__(self, failure_threshold: int = 3,
                 reset_timeout_s: float = 5.0,
                 clock: Callable[[], float] = time.monotonic,
                 on_transition: Optional[Callable[[str, str], None]] = None):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.failure_threshold = int(failure_threshold)
        self.reset_timeout_s = float(reset_timeout_s)
        self._clock = clock
        self._on_transition = on_transition
        # a plain lock: the port has no lock-order checker (the JAX
        # package's analysis.lockcheck, ROADMAP item 21)
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._failures = 0          # consecutive, in closed state
        self._opened_at = 0.0
        self._probe_out = False     # a half-open probe is in flight

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def _transition(self, new: str, fired: list):
        # called under self._lock; the transition is appended to the
        # CALLER'S local list and fired after the lock is released, so
        # concurrent transitions can neither drop nor double-fire hooks
        old, self._state = self._state, new
        if old != new and self._on_transition is not None:
            fired.append((old, new))

    def _fire(self, fired: list):
        for old, new in fired:
            self._on_transition(old, new)

    def allow(self) -> bool:
        """True when a call may proceed (closed, or the one half-open
        probe of this cooldown window)."""
        fired: list = []
        with self._lock:
            if self._state == self.CLOSED:
                return True
            if self._state == self.OPEN:
                if self._clock() - self._opened_at < self.reset_timeout_s:
                    return False
                self._transition(self.HALF_OPEN, fired)
                self._probe_out = True
                admitted = True
            else:  # HALF_OPEN: only the single probe holder is inside
                if self._probe_out:
                    return False
                self._probe_out = True
                admitted = True
        self._fire(fired)
        return admitted

    def record_success(self):
        fired: list = []
        with self._lock:
            self._failures = 0
            self._probe_out = False
            if self._state != self.CLOSED:
                self._transition(self.CLOSED, fired)
        self._fire(fired)

    def record_failure(self):
        fired: list = []
        with self._lock:
            self._probe_out = False
            if self._state == self.HALF_OPEN:
                # failed probe: full cooldown again
                self._opened_at = self._clock()
                self._transition(self.OPEN, fired)
            elif self._state == self.CLOSED:
                self._failures += 1
                if self._failures >= self.failure_threshold:
                    self._opened_at = self._clock()
                    self._transition(self.OPEN, fired)
            else:  # already OPEN (late failure report): refresh cooldown
                self._opened_at = self._clock()
        self._fire(fired)
