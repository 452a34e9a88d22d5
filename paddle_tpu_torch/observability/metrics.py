# Copied from the JAX package: paddle_tpu/observability/metrics.py
# (stdlib only). Keep it in step with that file.
"""Process-wide metrics registry: counters, gauges, histograms with labels.

Reference analogue: the profiler's event aggregation tables
(platform/profiler.cc DeviceTracer counters + the benchmark counters
scattered through operators/); here a single registry every subsystem
writes into, with JSON and Prometheus-text exposition so a serving
deployment can scrape the process and `tools/obsdump.py` can pretty-print
a dump offline.

Env gating (read lazily, so tests can monkeypatch):
  PADDLE_TPU_METRICS_DIR        if set, a daemon thread periodically writes
                                metrics.json + metrics.prom into this dir
  PADDLE_TPU_METRICS_INTERVAL_S dump period in seconds (default 60)
"""

from __future__ import annotations

import json
import os
import threading
from typing import Dict, Optional, Sequence, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "default_registry", "counter", "gauge", "histogram",
    "snapshot", "render_prometheus", "dump", "reset",
    "maybe_start_dump_thread", "stop_dump_thread",
    "exponential_buckets", "bucket_quantile",
]

# Seconds-scale latency buckets: 50us .. 60s covers a jit dispatch on a
# local backend through a cold compile on a tunneled one.
DEFAULT_BUCKETS = (
    50e-6, 1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2,
    5e-2, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


def exponential_buckets(start: float, factor: float, count: int):
    """Prometheus-style bucket helper: `count` upper bounds starting at
    `start`, each `factor` x the previous — e.g. (1, 2, 8) → batch-size
    buckets 1,2,4,...,128 for the serving batch histogram."""
    if start <= 0 or factor <= 1 or count < 1:
        raise ValueError("need start > 0, factor > 1, count >= 1")
    out, v = [], float(start)
    for _ in range(count):
        out.append(v)
        v *= factor
    return tuple(out)


def _label_key(labelnames: Sequence[str], labels: Dict[str, str]):
    if set(labels) != set(labelnames):
        raise ValueError(
            f"labels {sorted(labels)} do not match declared labelnames "
            f"{sorted(labelnames)}")
    return tuple(str(labels[n]) for n in labelnames)


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._values: Dict[Tuple[str, ...], object] = {}

    def _labels_dict(self, key: Tuple[str, ...]) -> Dict[str, str]:
        return dict(zip(self.labelnames, key))

    def clear(self):
        with self._lock:
            self._values.clear()


class Counter(_Metric):
    """Monotonically increasing count (steps, bytes, cache hits)."""

    kind = "counter"

    def inc(self, amount: float = 1, **labels):
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        key = _label_key(self.labelnames, labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0) + amount

    def value(self, **labels) -> float:
        key = _label_key(self.labelnames, labels)
        with self._lock:
            return self._values.get(key, 0)

    def total(self) -> float:
        """Sum across every label set — the whole-process view a bench
        wants (e.g. host-blocked seconds regardless of site)."""
        with self._lock:
            return float(sum(self._values.values()))


class Gauge(_Metric):
    """Point-in-time value (cache entries, examples/sec, bubble fraction)."""

    kind = "gauge"

    def set(self, value: float, **labels):
        key = _label_key(self.labelnames, labels)
        with self._lock:
            self._values[key] = float(value)

    def inc(self, amount: float = 1, **labels):
        key = _label_key(self.labelnames, labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def dec(self, amount: float = 1, **labels):
        self.inc(-amount, **labels)

    def set_max(self, value: float, **labels):
        """Ratchet: keep the larger of the stored and offered value —
        the high-watermark pattern (HBM peak bytes) without a
        read-modify-write race at the call sites."""
        key = _label_key(self.labelnames, labels)
        with self._lock:
            cur = self._values.get(key, float("-inf"))
            if value > cur:
                self._values[key] = float(value)

    def value(self, **labels) -> float:
        key = _label_key(self.labelnames, labels)
        with self._lock:
            return self._values.get(key, 0.0)


class Histogram(_Metric):
    """Cumulative-bucket histogram (Prometheus semantics): per label set
    keeps (count, sum, per-bucket counts); `le` buckets are cumulative at
    render time."""

    kind = "histogram"

    def __init__(self, name, help="", labelnames=(),
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames)
        self.buckets = tuple(sorted(float(b) for b in buckets))

    def observe(self, value: float, **labels):
        key = _label_key(self.labelnames, labels)
        with self._lock:
            st = self._values.get(key)
            if st is None:
                st = {"count": 0, "sum": 0.0,
                      "buckets": [0] * len(self.buckets)}
                self._values[key] = st
            st["count"] += 1
            st["sum"] += float(value)
            for i, b in enumerate(self.buckets):
                if value <= b:
                    st["buckets"][i] += 1
                    break
            # values above the top bucket land only in +Inf (count)

    def time(self, **labels):
        """Context manager observing the with-block's wall seconds —
        the duration is recorded whether the block succeeds or raises
        (a failed save's latency is still a latency)."""
        import contextlib
        import time as _time

        @contextlib.contextmanager
        def _timer():
            t0 = _time.perf_counter()
            try:
                yield self
            finally:
                self.observe(_time.perf_counter() - t0, **labels)

        return _timer()

    def stats(self, **labels) -> Dict[str, float]:
        key = _label_key(self.labelnames, labels)
        with self._lock:
            st = self._values.get(key)
            if st is None:
                return {"count": 0, "sum": 0.0, "avg": 0.0}
            return {"count": st["count"], "sum": st["sum"],
                    "avg": st["sum"] / max(1, st["count"])}


class MetricsRegistry:
    """get-or-create registry; re-registration with a different kind or
    label set is a hard error (silent divergence would corrupt dumps)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}
        # callables run before every snapshot/exposition: lazily-synced
        # sources (e.g. the span-ring drop counter, whose source module
        # is stdlib-only and cannot import this registry) publish here
        self._collect_hooks: list = []

    def add_collect_hook(self, fn):
        """Register `fn` to run at the top of every snapshot() (and so
        every /metrics render and file dump). Idempotent per callable."""
        with self._lock:
            if fn not in self._collect_hooks:
                self._collect_hooks.append(fn)

    def _get_or_create(self, cls, name, help, labelnames, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if type(m) is not cls or m.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric '{name}' already registered as "
                        f"{type(m).__name__}{m.labelnames}, requested "
                        f"{cls.__name__}{tuple(labelnames)}")
                return m
            m = cls(name, help, labelnames, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name, help="", labelnames=()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name, help="", labelnames=()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name, help="", labelnames=(),
                  buckets=DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets)

    def reset(self):
        """Zero every metric's values; registered metric OBJECTS survive
        (subsystems hold references to them)."""
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            m.clear()

    # -- exposition ----------------------------------------------------

    def snapshot(self) -> Dict[str, dict]:
        """JSON-able view of every metric (the obsdump/dump format)."""
        out = {}
        with self._lock:
            hooks = list(self._collect_hooks)
        for fn in hooks:
            try:
                fn()
            except Exception:
                pass  # lint-exempt:swallow: a broken lazy source must not poison the whole exposition
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            with m._lock:
                series = []
                for key, val in sorted(m._values.items()):
                    entry = {"labels": m._labels_dict(key)}
                    if m.kind == "histogram":
                        entry.update(
                            count=val["count"], sum=val["sum"],
                            buckets=[
                                {"le": b, "count": c} for b, c in
                                zip(m.buckets, val["buckets"])])
                    else:
                        entry["value"] = val
                    series.append(entry)
            out[m.name] = {"type": m.kind, "help": m.help,
                           "series": series}
        return out

    def render_prometheus(self) -> str:
        return render_prometheus_snapshot(self.snapshot())

    def dump(self, directory: str) -> str:
        """Write metrics.json + metrics.prom into `directory` (tmp+rename
        so a scraper never reads a torn file). Returns the json path.
        Non-finite gauge values (a NaN grad-norm is a legitimate health
        reading) become strings — json.dumps would otherwise emit a bare
        `NaN` token that strict JSON parsers reject, breaking the whole
        dump exactly when divergence is being observed."""
        os.makedirs(directory, exist_ok=True)
        snap = self.snapshot()
        jpath = os.path.join(directory, "metrics.json")
        ppath = os.path.join(directory, "metrics.prom")
        for path, text in ((jpath, json.dumps(_json_safe(snap), indent=1)),
                           (ppath, render_prometheus_snapshot(snap))):
            tmp = path + ".tmp"
            with open(tmp, "w") as f:  # atomic-exempt: tmp file, os.replace'd below
                f.write(text)
            os.replace(tmp, path)
        return jpath


def bucket_quantile(q: float, buckets, count: Optional[float] = None):
    """Histogram-bucket quantile estimate with linear interpolation
    inside the straddling bucket — THE one implementation shared by
    tools/obsdump.py, observability/aggregate.py, and the SLO engine
    (they all answer "what is p99 of this bucket table?" and must agree).

    `buckets` is a sequence of per-bin entries, each either a
    (le, count) pair or a {"le", "count"} dict (the snapshot() shape),
    with PER-BIN counts (not cumulative) and finite upper bounds in
    ascending order. `count` is the total observation count INCLUDING
    values above the top bucket (the implicit +Inf bin); when omitted it
    defaults to the sum of the given bins, i.e. no overflow.

    Returns None for an empty histogram. Quantiles that land in the
    +Inf overflow region clamp to the top finite bound — the honest
    answer "at least this much" rather than an invented extrapolation.
    """
    bins = []
    for b in buckets:
        if isinstance(b, dict):
            bins.append((float(b["le"]), float(b["count"])))
        else:
            bins.append((float(b[0]), float(b[1])))
    total = float(count) if count is not None \
        else sum(n for _, n in bins)
    if total <= 0:
        return None
    target = max(0.0, min(1.0, float(q))) * total
    prev_le, cum = 0.0, 0.0
    for le, n in bins:
        if cum + n >= target and n > 0:
            frac = (target - cum) / n
            return prev_le + frac * (le - prev_le)
        prev_le, cum = le, cum + n
    return prev_le  # target in the +Inf overflow: top finite bound


def _json_safe(obj):
    """Strict-JSON view of a snapshot: non-finite floats → strings
    ("nan"/"inf"/"-inf"), containers walked recursively."""
    if isinstance(obj, float):
        import math

        return obj if math.isfinite(obj) else repr(obj)
    if isinstance(obj, dict):
        return {k: _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_json_safe(v) for v in obj]
    return obj


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _sanitize_name(name: str) -> str:
    """Prometheus metric names are [a-zA-Z_:][a-zA-Z0-9_:]* — registry
    names that carry dots/dashes (or any other separator) are mapped to
    underscores at exposition time, so the JSON snapshot keeps the
    author's spelling while the text format stays parseable. Distinct
    raw names can collide after mapping; last-writer-wins per line is
    the accepted cost (don't name metrics `a.b` AND `a_b`)."""
    out = ["_" if not (c.isascii() and (c.isalnum() or c in "_:"))
           else c for c in name]
    if out and out[0].isdigit():
        out.insert(0, "_")
    return "".join(out)


def _fmt_labels(labels: Dict[str, str], extra: str = "") -> str:
    parts = [f'{k}="{_escape_label(str(v))}"'
             for k, v in sorted(labels.items())]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def render_prometheus_snapshot(snap: Dict[str, dict]) -> str:
    """Prometheus text exposition from a snapshot() dict. Module-level so
    tools/obsdump.py can render an offline metrics.json without importing
    the framework (and the jax stack behind it).

    Names are sanitized to the exposition charset (dots/dashes →
    underscores). Histograms render as three grouped families —
    `name_bucket` under the histogram TYPE, then `name_sum` and
    `name_count` each with their own # HELP/# TYPE (counter) block — so
    line-oriented scrapers that treat _sum/_count as standalone series
    still see typed, documented families."""
    lines = []
    for raw_name in sorted(snap):
        m = snap[raw_name]
        name = _sanitize_name(raw_name)
        if m["type"] == "histogram":
            if m.get("help"):
                lines.append(f"# HELP {name} {m['help']}")
            lines.append(f"# TYPE {name} histogram")
            for s in m["series"]:
                labels = s.get("labels", {})
                cum = 0
                for b in s["buckets"]:
                    cum += b["count"]
                    le = 'le="%g"' % b["le"]
                    lines.append(
                        f"{name}_bucket{_fmt_labels(labels, le)} {cum}")
                inf = 'le="+Inf"'
                lines.append(
                    f"{name}_bucket{_fmt_labels(labels, inf)} "
                    f"{s['count']}")
            lines.append(f"# HELP {name}_sum Sum of observations for "
                         f"{name}")
            lines.append(f"# TYPE {name}_sum counter")
            for s in m["series"]:
                lines.append(f"{name}_sum"
                             f"{_fmt_labels(s.get('labels', {}))} "
                             f"{s['sum']}")
            lines.append(f"# HELP {name}_count Count of observations "
                         f"for {name}")
            lines.append(f"# TYPE {name}_count counter")
            for s in m["series"]:
                lines.append(f"{name}_count"
                             f"{_fmt_labels(s.get('labels', {}))} "
                             f"{s['count']}")
        else:
            if m.get("help"):
                lines.append(f"# HELP {name} {m['help']}")
            lines.append(f"# TYPE {name} {m['type']}")
            for s in m["series"]:
                lines.append(f"{name}{_fmt_labels(s.get('labels', {}))} "
                             f"{s['value']}")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# Default registry + periodic env-gated dump
# ---------------------------------------------------------------------------

_default = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    return _default


def counter(name, help="", labelnames=()) -> Counter:
    return _default.counter(name, help, labelnames)


def gauge(name, help="", labelnames=()) -> Gauge:
    return _default.gauge(name, help, labelnames)


def histogram(name, help="", labelnames=(), buckets=DEFAULT_BUCKETS):
    return _default.histogram(name, help, labelnames, buckets)


def snapshot() -> Dict[str, dict]:
    return _default.snapshot()


def add_collect_hook(fn):
    _default.add_collect_hook(fn)


def render_prometheus() -> str:
    return _default.render_prometheus()


def dump(directory: Optional[str] = None) -> str:
    d = directory or os.environ.get("PADDLE_TPU_METRICS_DIR")
    if not d:
        raise ValueError("no directory given and PADDLE_TPU_METRICS_DIR "
                         "is unset")
    return _default.dump(d)


def reset():
    _default.reset()


_dump_thread: Optional[threading.Thread] = None
_dump_stop = threading.Event()
_dump_lock = threading.Lock()
_atexit_registered = False


def maybe_start_dump_thread() -> bool:
    """Start the periodic dump daemon iff PADDLE_TPU_METRICS_DIR is set
    and no dumper is running yet. Called from the telemetry hot-path
    helpers, so merely setting the env var before training is enough."""
    global _dump_thread, _atexit_registered
    d = os.environ.get("PADDLE_TPU_METRICS_DIR")
    if not d:
        return False
    with _dump_lock:
        if _dump_thread is not None and _dump_thread.is_alive():
            return True
        try:
            interval = float(os.environ.get(
                "PADDLE_TPU_METRICS_INTERVAL_S", "60"))
        except ValueError:
            interval = 60.0  # malformed env must not kill the hot path
        if interval <= 0:
            interval = 60.0  # 0/negative would busy-loop the dumper
        _dump_stop.clear()

        def loop():
            while not _dump_stop.wait(interval):
                try:
                    _default.dump(d)
                except OSError:
                    pass  # dir vanished mid-run; keep the trainer alive
            # final dump so short runs still leave a snapshot behind
            try:
                _default.dump(d)
            except OSError:
                pass

        _dump_thread = threading.Thread(
            target=loop, name="paddle-tpu-metrics-dump", daemon=True)
        _dump_thread.start()
        if not _atexit_registered:
            # daemon threads die silently at interpreter exit — without
            # this, a run shorter than the interval leaves no snapshot
            import atexit

            atexit.register(stop_dump_thread)
            _atexit_registered = True
        return True


def stop_dump_thread():
    global _dump_thread
    with _dump_lock:
        t, _dump_thread = _dump_thread, None
    if t is not None and t.is_alive():
        _dump_stop.set()
        t.join(timeout=5)
