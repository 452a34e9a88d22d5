# Copied from the JAX package: paddle_tpu/observability/timeseries.py
# (stdlib only). Keep it in step with that file.
"""Metric time series: a background recorder turning the point-in-time
`MetricsRegistry` into durable, delta-encoded history on disk.

The registry (metrics.py) answers "what is the state NOW"; this module
answers "what happened over the last N seconds" — the raw material for
rates, windowed quantiles, fleet roll-ups (aggregate.py) and SLO
burn-rate alerting (slo.py). Each recording process periodically
snapshots the default registry and appends ONE JSONL record per
interval to a per-process segmented sink:

  {"ts": <wall s>, "pid": <pid>, "seq": n, "samples": [
     {"name": ..., "kind": "counter",   "labels": {...}, "delta": d},
     {"name": ..., "kind": "gauge",     "labels": {...}, "value": v},
     {"name": ..., "kind": "histogram", "labels": {...},
      "count_delta": c, "sum_delta": s, "bucket_deltas": [[le, d], ...]}
  ]}

Counters and histograms are DELTA-encoded against the previous sample
(zero-delta series and zero-delta bins are omitted), so a window sum
over records is exactly `increase()` and idle processes write near-empty
records. The first record of a recorder's life is marked
`"baseline": true` and carries gauges only: it primes the delta state
without attributing counts accrued BEFORE recording started to the
first interval. Gauges are re-emitted every record (last-wins point
reads need a value in every window). A counter/histogram that goes
backwards (process-internal reset) re-enters as `delta = current`,
Prometheus-rate style.

Sink discipline is PR 14's proven shape (tracing.py): per-process
`ts-<pid>-<rand>.jsonl` files published as atomic whole-file rewrites
via resilience/atomic.py so a concurrent reader never sees a torn line,
sealed at a fixed record count (amortized O(1) I/O per sample however
long the process lives), keep-N / total-bytes retention over THIS
process's sealed segments, and an atexit final sample + flush so a
process shorter than the interval still leaves history behind.

Env gating (default off; read by maybe_start_recorder):
  PADDLE_TPU_TS_DIR         sink directory; setting it turns recording on
  PADDLE_TPU_TS_INTERVAL_S  sample period in seconds (default 5)
  PADDLE_TPU_TS_KEEP        sealed segments to retain per process (16)
  PADDLE_TPU_TS_MAX_BYTES   total bytes across this process's segments
                            (0 = unlimited); oldest sealed deleted first
"""

from __future__ import annotations

import atexit
import json
import os
import threading
import time
from typing import Dict, Optional, Tuple

from . import metrics as _metrics

__all__ = [
    "Recorder", "maybe_start_recorder", "stop_recorder",
    "current_recorder", "TS_DIR_ENV", "TS_INTERVAL_ENV",
]

TS_DIR_ENV = "PADDLE_TPU_TS_DIR"
TS_INTERVAL_ENV = "PADDLE_TPU_TS_INTERVAL_S"
TS_KEEP_ENV = "PADDLE_TPU_TS_KEEP"
TS_MAX_BYTES_ENV = "PADDLE_TPU_TS_MAX_BYTES"

DEFAULT_INTERVAL_S = 5.0
SEGMENT_SAMPLES = 240      # ~20 min of history per segment at 5s
KEEP_SEGMENTS = 16

_SAMPLES_TOTAL = _metrics.counter(
    "paddle_tpu_ts_samples_total",
    "Time-series records written by this process's recorder",
)


def _series_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Recorder:
    """Delta-encoding metrics recorder for one process. Construct with
    a sink directory, `start()` the background thread (or drive
    `sample_once()` by hand with an injected clock in tests), `stop()`
    to take a final sample and flush. Idempotent start/stop."""

    def __init__(self, directory: str, interval_s: float = DEFAULT_INTERVAL_S,
                 registry: Optional[_metrics.MetricsRegistry] = None,
                 segment_samples: int = SEGMENT_SAMPLES,
                 keep_segments: int = KEEP_SEGMENTS,
                 max_bytes: int = 0, clock=time.time):
        self.directory = directory
        self.interval_s = max(0.05, float(interval_s))
        self.registry = registry or _metrics.default_registry()
        self.segment_samples = max(1, int(segment_samples))
        self.keep_segments = max(1, int(keep_segments))
        self.max_bytes = max(0, int(max_bytes))
        self.clock = clock
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._prev: Dict[Tuple[str, Tuple], object] = {}
        self._seq = 0
        self._baselined = False
        self._lines: list = []       # current (unsealed) segment
        self._path = self._fresh_path()
        self._sealed: list = []      # this process's sealed segments

    def _fresh_path(self) -> str:
        return os.path.join(
            self.directory,
            f"ts-{os.getpid()}-{os.urandom(4).hex()}.jsonl")

    # -- delta encoding ------------------------------------------------

    def _diff(self, snap: Dict[str, dict], baseline: bool) -> list:
        samples = []
        for name in sorted(snap):
            m = snap[name]
            kind = m.get("type")
            for s in m.get("series", ()):
                labels = s.get("labels", {})
                key = (name, _series_key(labels))
                if kind == "gauge":
                    samples.append({"name": name, "kind": "gauge",
                                    "labels": labels,
                                    "value": s.get("value", 0.0)})
                elif kind == "counter":
                    cur = float(s.get("value", 0.0))
                    prev = self._prev.get(key)
                    self._prev[key] = cur
                    if baseline:
                        continue
                    delta = cur if (prev is None or cur < prev) \
                        else cur - prev
                    if delta:
                        samples.append({"name": name, "kind": "counter",
                                        "labels": labels, "delta": delta})
                elif kind == "histogram":
                    cur_c = int(s.get("count", 0))
                    cur_s = float(s.get("sum", 0.0))
                    bins = [(float(b["le"]), int(b["count"]))
                            for b in s.get("buckets", ())]
                    prev = self._prev.get(key)
                    self._prev[key] = (cur_c, cur_s, bins)
                    if baseline:
                        continue
                    if prev is None or cur_c < prev[0] \
                            or [le for le, _ in prev[2]] \
                            != [le for le, _ in bins]:
                        # new series or in-process reset: whole table
                        dc, ds = cur_c, cur_s
                        dbins = [(le, n) for le, n in bins if n]
                    else:
                        dc = cur_c - prev[0]
                        ds = cur_s - prev[1]
                        dbins = [(le, n - pn) for (le, n), (_, pn)
                                 in zip(bins, prev[2]) if n != pn]
                    if dc or dbins:
                        samples.append({
                            "name": name, "kind": "histogram",
                            "labels": labels, "count_delta": dc,
                            "sum_delta": ds,
                            "bucket_deltas": [[le, n] for le, n in dbins]})
        return samples

    # -- sink I/O ------------------------------------------------------

    def _write_locked(self) -> bool:
        from ..resilience.atomic import write_text

        try:
            os.makedirs(self.directory, exist_ok=True)
            write_text(self._path, "".join(self._lines))
            return True
        except OSError:
            return False  # full/vanished dir: keep buffering, retry next

    def _retain_locked(self):
        """Drop oldest sealed segments beyond keep-N / total-byte caps.
        Only THIS process's files are candidates — a shared fleet dir
        holds other pids' history this recorder must not collect."""
        while len(self._sealed) > self.keep_segments:
            self._unlink(self._sealed.pop(0))
        if not self.max_bytes:
            return
        sizes = []
        for p in self._sealed + [self._path]:
            try:
                sizes.append(os.path.getsize(p))
            except OSError:
                sizes.append(0)
        total = sum(sizes)
        while total > self.max_bytes and self._sealed:
            total -= sizes.pop(0)
            self._unlink(self._sealed.pop(0))

    @staticmethod
    def _unlink(path: str):
        try:
            os.unlink(path)
        except OSError:
            pass  # lint-exempt:swallow: already-gone segment is the goal state

    def sample_once(self, now: Optional[float] = None) -> int:
        """Snapshot → delta → append one record → publish the segment.
        Returns the number of metric samples in the record (gauges +
        nonzero deltas). Safe to call concurrently with the thread."""
        with self._lock:
            baseline = not self._baselined
            snap = self.registry.snapshot()
            samples = self._diff(snap, baseline)
            self._baselined = True
            rec = {"ts": self.clock() if now is None else now,
                   "pid": os.getpid(), "seq": self._seq,
                   "samples": samples}
            if baseline:
                rec["baseline"] = True
            self._seq += 1
            self._lines.append(
                json.dumps(_metrics._json_safe(rec)) + "\n")
            if self._write_locked() \
                    and len(self._lines) >= self.segment_samples:
                # sealed: the file on disk is complete; start fresh
                self._sealed.append(self._path)
                self._lines = []
                self._path = self._fresh_path()
                self._retain_locked()
            _SAMPLES_TOTAL.inc()
            return len(samples)

    # -- lifecycle -----------------------------------------------------

    def start(self):
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return
            self._stop.clear()

            def loop():
                while not self._stop.wait(self.interval_s):
                    self.sample_once()
                # final sample so sub-interval processes still record
                self.sample_once()

            self._thread = threading.Thread(
                target=loop, name="paddle-tpu-ts-recorder", daemon=True)
            t = self._thread
        # synchronous baseline BEFORE the loop runs: delta state is
        # primed the moment start() returns, so a process shorter than
        # one interval still attributes everything after this point to
        # its final stop-time sample (instead of that sample being the
        # counter-less baseline)
        self.sample_once()
        t.start()

    def stop(self):
        with self._lock:
            t, self._thread = self._thread, None
        if t is not None and t.is_alive():
            self._stop.set()
            t.join(timeout=5)
        else:
            # never started (or already joined): still flush a final
            # record so `with recorder: ...` style use leaves history
            self.sample_once()


# ---------------------------------------------------------------------------
# Env-gated module recorder (the telemetry hot-path helpers call this)
# ---------------------------------------------------------------------------

_recorder: Optional[Recorder] = None
_recorder_lock = threading.Lock()
_atexit_registered = False


def current_recorder() -> Optional[Recorder]:
    return _recorder


def _env_float(name: str, default: float) -> float:
    try:
        v = float(os.environ.get(name, default))
    except ValueError:
        return default  # malformed env must not kill the hot path
    return v if v > 0 else default


def maybe_start_recorder() -> bool:
    """Start the background recorder iff PADDLE_TPU_TS_DIR is set and
    none is running yet — merely exporting the env var before boot is
    enough, same contract as the metrics dump thread and trace sink."""
    global _recorder, _atexit_registered
    d = os.environ.get(TS_DIR_ENV)
    if not d:
        return False
    with _recorder_lock:
        if _recorder is not None \
                and _recorder.directory == d \
                and _recorder._thread is not None \
                and _recorder._thread.is_alive():
            return True
        if _recorder is not None:
            _recorder.stop()  # env changed under us: reseat the sink
        _recorder = Recorder(
            d,
            interval_s=_env_float(TS_INTERVAL_ENV, DEFAULT_INTERVAL_S),
            keep_segments=int(_env_float(TS_KEEP_ENV, KEEP_SEGMENTS)),
            max_bytes=int(_env_float(TS_MAX_BYTES_ENV, 0)))
        _recorder.start()
        if not _atexit_registered:
            # daemon thread dies silently at interpreter exit; without
            # this a run shorter than the interval records nothing
            atexit.register(stop_recorder)
            _atexit_registered = True
        return True


def stop_recorder():
    """Final sample + flush + join. Idempotent; atexit-registered."""
    global _recorder
    with _recorder_lock:
        r, _recorder = _recorder, None
    if r is not None:
        r.stop()
