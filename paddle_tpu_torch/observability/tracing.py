# Copied from the JAX package: paddle_tpu/observability/tracing.py
# (stdlib only). Keep it in step with that file; its one change names
# this package's logger.
"""Unified span store + chrome-trace export + distributed trace context.

One process-wide span list replaces the profiler's ad-hoc `_host_spans`:
`profiler.RecordEvent` host spans (cat="host"), executor/trainer/SPMD step
telemetry (cat="step"), and any other subsystem annotation all land here,
and `export_trace` merges them with the jax.profiler device timeline
(the `*.trace.json.gz` chrome traces jax writes under
`plugins/profile/<run>/`) into ONE chrome://tracing / perfetto-loadable
JSON file — the role of the reference's profiler.proto + tools/timeline.py
converter.

Timestamps: span ts/dur are time.perf_counter() seconds (matching what
RecordEvent always recorded); exported values are microseconds. Device
events keep their own profiler epoch — perfetto renders them as separate
tracks, which is how the reference timeline showed host vs. CUPTI streams
too.

Distributed tracing (PROFILE.md §Distributed tracing): a `TraceContext`
(trace_id, span_id, parent_span_id, sampled — the W3C `traceparent` wire
format) rides a contextvar in-process, HTTP headers across the serving
tier (`begin_request`/`trace_headers`), and the PS RPC envelope
(ps/protocol.py TRACE_FIELD) across the parameter-server tier. Sampling
is head-based: the process that STARTS a trace rolls
`PADDLE_TPU_TRACE_SAMPLE` (0.0..1.0, default 0 = off) once; every
downstream hop honors the propagated flag, so a request is either traced
end-to-end or costs nothing anywhere. Sampled spans are tagged into the
in-memory ring (args trace_id/span_id/parent_span_id) AND persisted to a
per-process JSONL sink under `PADDLE_TPU_TRACE_DIR` (atomic whole-file
rewrites via resilience/atomic.py, so a concurrent reader never sees a
torn line); `tools/obsdump.py trace DIR --trace-id ID` reassembles the
cross-process tree. This module stays stdlib-only (obsdump imports it by
file path); resilience.atomic loads lazily inside the writers.
"""

from __future__ import annotations

import atexit
import collections
import contextlib
import contextvars
import glob
import gzip
import json
import os
import random
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional, Sequence

__all__ = ["Span", "span", "record_span", "get_spans", "clear_spans",
           "dropped_spans", "save_spans", "export_trace",
           "merge_chrome_traces",
           "TraceContext", "parse_traceparent", "sample_rate",
           "start_trace", "current_trace", "current_trace_id",
           "activate", "begin_request", "trace_headers",
           "response_headers", "trace_span", "step_span",
           "record_span_ctx", "record_trace_span", "flush_trace_sink",
           "sink_path", "read_trace_dir", "build_trace_tree",
           "trace_summaries", "trace_records_to_chrome"]

# Bound host memory: a week-long trainer recording a span per step must
# not OOM the host. The store is a ring — the OLDEST spans are evicted
# (and counted in dropped_spans()), so profiling a late window of a long
# run still exports that window rather than stale day-one spans.
MAX_SPANS = 200_000


class Span(NamedTuple):
    name: str
    ts: float            # perf_counter seconds
    dur: float           # seconds
    cat: str             # "host" | "step" | subsystem-chosen
    tid: int             # recording thread ident
    args: Optional[Dict[str, Any]]


_lock = threading.Lock()
_spans: "collections.deque[Span]" = collections.deque()
_dropped = 0


def record_span(name: str, ts: float, dur: float, cat: str = "host",
                args: Optional[Dict[str, Any]] = None):
    global _dropped
    sp = Span(name, ts, dur, cat, threading.get_ident(), args)
    with _lock:
        _spans.append(sp)
        while len(_spans) > MAX_SPANS:
            _spans.popleft()
            _dropped += 1


# ---------------------------------------------------------------------------
# Distributed trace context (W3C traceparent)
# ---------------------------------------------------------------------------

TRACE_DIR_ENV = "PADDLE_TPU_TRACE_DIR"
TRACE_SAMPLE_ENV = "PADDLE_TPU_TRACE_SAMPLE"

# sampling decisions use a dedicated RNG so tests can seed it without
# perturbing anything else's randomness
_sample_rng = random.Random()


class TraceContext(NamedTuple):
    """One hop of a distributed trace: ids are lower-hex strings in the
    W3C trace-context widths (trace_id 32, span_id 16). `sampled` is the
    head-based decision made where the trace STARTED — downstream hops
    copy it from the wire instead of re-rolling, so one request is
    traced end-to-end or not at all."""

    trace_id: str
    span_id: str
    parent_span_id: Optional[str] = None
    sampled: bool = False

    def header(self) -> str:
        """W3C `traceparent`: 00-<trace_id>-<span_id>-<flags>."""
        return (f"00-{self.trace_id}-{self.span_id}-"
                f"{'01' if self.sampled else '00'}")

    def child(self) -> "TraceContext":
        """Fresh span id, this span as parent, same trace + decision."""
        return TraceContext(self.trace_id, _new_span_id(),
                            self.span_id, self.sampled)


def _new_trace_id() -> str:
    return os.urandom(16).hex()


def _new_span_id() -> str:
    return os.urandom(8).hex()


def parse_traceparent(value: Optional[str]) -> Optional[TraceContext]:
    """Parse a `traceparent` header; None on anything malformed (an
    unparseable header means "start a fresh trace", never an error)."""
    if not value or not isinstance(value, str):
        return None
    parts = value.strip().split("-")
    if len(parts) != 4:
        return None
    version, trace_id, span_id, flags = parts
    if len(version) != 2 or len(trace_id) != 32 or len(span_id) != 16 \
            or len(flags) != 2:
        return None
    try:
        int(trace_id, 16), int(span_id, 16), int(flags, 16)
    except ValueError:
        return None
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return TraceContext(trace_id.lower(), span_id.lower(), None,
                        bool(int(flags, 16) & 0x01))


def sample_rate() -> float:
    """Head-sampling probability from PADDLE_TPU_TRACE_SAMPLE (clamped
    to [0, 1]; unset/malformed = 0 = tracing off). Re-read per call so
    an operator (or the serve_bench overhead A/B) can flip it live."""
    raw = os.environ.get(TRACE_SAMPLE_ENV)
    if not raw:
        return 0.0
    try:
        return min(1.0, max(0.0, float(raw)))
    except ValueError:
        return 0.0


def start_trace(sampled: Optional[bool] = None) -> TraceContext:
    """Mint a new root context. sampled=None rolls `sample_rate()`
    once — the head-based decision every downstream hop inherits."""
    if sampled is None:
        rate = sample_rate()
        sampled = rate > 0.0 and _sample_rng.random() < rate
    return TraceContext(_new_trace_id(), _new_span_id(), None,
                        bool(sampled))


_current: "contextvars.ContextVar[Optional[TraceContext]]" = \
    contextvars.ContextVar("paddle_tpu_trace", default=None)


def current_trace() -> Optional[TraceContext]:
    return _current.get()


def current_trace_id() -> Optional[str]:
    """trace_id of the active SAMPLED context (None otherwise) — the
    event log's join key (events.py set_trace_provider)."""
    cur = _current.get()
    return cur.trace_id if cur is not None and cur.sampled else None


@contextlib.contextmanager
def activate(ctx: Optional[TraceContext]):
    """Make `ctx` the ambient context for the with-body (any thread)."""
    token = _current.set(ctx)
    try:
        yield ctx
    finally:
        _current.reset(token)


def begin_request(headers) -> TraceContext:
    """Extract-or-start at a service edge: adopt the caller's
    `traceparent` (including its sampling decision) or mint a fresh
    root sampled by PADDLE_TPU_TRACE_SAMPLE. Always returns a context —
    the trace_id doubles as the X-Request-Id response header even for
    unsampled requests. `headers` is any .get()-able mapping (the
    stdlib handler's email.message.Message included)."""
    ctx = parse_traceparent(headers.get("traceparent")
                            if headers is not None else None)
    return ctx if ctx is not None else start_trace()


def trace_headers(ctx: Optional[TraceContext] = None) -> Dict[str, str]:
    """Outbound propagation headers for a downstream HTTP call ({} when
    no context is active). Unsampled contexts propagate too — the
    sampling decision was made at the head, and a downstream hop must
    not re-roll it."""
    cur = _current.get() if ctx is None else ctx
    if cur is None:
        return {}
    return {"traceparent": cur.header()}


def response_headers(ctx: Optional[TraceContext]) -> Dict[str, str]:
    """Reply headers every /v1/* response carries (SERVING.md §HTTP
    API): the request id for log correlation plus the traceparent so
    clients can read the ids + sampling decision back."""
    if ctx is None:
        return {}
    return {"X-Request-Id": ctx.trace_id, "traceparent": ctx.header()}


# -- per-process JSONL sink -------------------------------------------------

# The sink is SEGMENTED: each segment file is published as atomic
# whole-file rewrites (readers never see a torn line) and sealed once it
# reaches _SINK_SEGMENT_SPANS, after which a fresh trace-<pid>-<rand>
# file starts — so both the in-memory buffer and the per-flush rewrite
# cost stay bounded (amortized O(1) I/O per span) no matter how long a
# sampled process lives. read_trace_dir globs every segment.
_SINK_SEGMENT_SPANS = 4096
MAX_SINK_SPANS = 100_000   # backstop drop-oldest; unreachable with
# segmenting unless rolling keeps failing (unwritable dir)
_SINK_FLUSH_EVERY_S = 0.25
_SINK_FLUSH_EVERY_N = 256

_sink_lock = threading.Lock()        # buffer/bookkeeping access
_sink_flush_lock = threading.Lock()  # serializes writers: file content
# must never go backwards (an older snapshot landing after a newer one
# would silently drop the tail spans)
_sink_state = {"dir": None, "path": None, "pid": None,
               "lines": [], "flushed": 0, "last_flush": 0.0,
               "atexit": False}


def sink_path() -> Optional[str]:
    """Resolved sink file for THIS process, or None when
    PADDLE_TPU_TRACE_DIR is unset."""
    with _sink_lock:
        if _sink_state["dir"] != os.environ.get(TRACE_DIR_ENV) \
                or _sink_state["pid"] != os.getpid():
            return _sink_reset_locked()
        return _sink_state["path"]


def _sink_reset_locked() -> Optional[str]:
    d = os.environ.get(TRACE_DIR_ENV)
    _sink_state.update(dir=d, pid=os.getpid(), lines=[], flushed=0,
                       last_flush=0.0)
    _sink_state["path"] = None if not d else os.path.join(
        d, f"trace-{os.getpid()}-{os.urandom(4).hex()}.jsonl")
    return _sink_state["path"]


def _sink_append(rec: Dict[str, Any]):
    line = json.dumps(rec, default=str) + "\n"
    flush_now = roll_now = False
    with _sink_lock:
        if _sink_state["dir"] != os.environ.get(TRACE_DIR_ENV) \
                or _sink_state["pid"] != os.getpid():
            _sink_reset_locked()
        if _sink_state["path"] is None:
            return
        lines = _sink_state["lines"]
        lines.append(line)
        if len(lines) > MAX_SINK_SPANS:
            del lines[:len(lines) - MAX_SINK_SPANS]
            _sink_state["flushed"] = 0  # prefix changed: rewrite all
        if not _sink_state["atexit"]:
            _sink_state["atexit"] = True
            atexit.register(flush_trace_sink)
        now = time.monotonic()
        pending = len(lines) - _sink_state["flushed"]
        roll_now = len(lines) >= _SINK_SEGMENT_SPANS
        flush_now = pending >= _SINK_FLUSH_EVERY_N or \
            (pending > 0 and now - _sink_state["last_flush"]
             >= _SINK_FLUSH_EVERY_S)
    if roll_now:
        _sink_roll()
    elif flush_now:
        flush_trace_sink()


def _sink_write(path: str, lines: List[str]) -> bool:
    from ..resilience.atomic import write_text

    try:
        write_text(path, "".join(lines))
        return True
    except OSError:
        return False  # full disk etc: keep buffering, retry next flush


def flush_trace_sink():
    """Publish every buffered sampled span to the per-process sink
    segment (one atomic whole-file rewrite — a concurrent obsdump
    reassembly never reads a torn line). No-op without
    PADDLE_TPU_TRACE_DIR. Writers are serialized and `flushed` only
    advances AFTER a successful write: a failed write (or a racing
    older snapshot) can never strand tail spans as flushed-but-absent,
    so the atexit flush still publishes them."""
    with _sink_flush_lock:
        with _sink_lock:
            path = _sink_state["path"]
            lines = list(_sink_state["lines"])
            if path is None or len(lines) == _sink_state["flushed"]:
                return
        if not _sink_write(path, lines):
            return
        with _sink_lock:
            if _sink_state["path"] == path \
                    and _sink_state["flushed"] < len(lines):
                _sink_state["flushed"] = len(lines)
                _sink_state["last_flush"] = time.monotonic()


def _sink_roll():
    """Seal the current segment (final full write) and start a fresh
    trace-<pid>-<rand> file — the per-flush rewrite cost and the buffer
    are both bounded by _SINK_SEGMENT_SPANS. Spans appended while the
    seal was being written stay buffered for the new segment."""
    with _sink_flush_lock:
        with _sink_lock:
            path = _sink_state["path"]
            lines = list(_sink_state["lines"])
        if path is None or not lines:
            return
        if not _sink_write(path, lines):
            return  # unwritable: keep the segment open, retry later
        with _sink_lock:
            if _sink_state["path"] != path:
                return  # env/pid reset raced us; nothing to seal
            del _sink_state["lines"][:len(lines)]
            _sink_state["flushed"] = 0
            _sink_state["last_flush"] = time.monotonic()
            _sink_state["path"] = os.path.join(
                os.path.dirname(path),
                f"trace-{os.getpid()}-{os.urandom(4).hex()}.jsonl")


def record_span_ctx(ctx: Optional[TraceContext], name: str, dur: float,
                    cat: str = "trace", t0_perf: Optional[float] = None,
                    **args):
    """Record `ctx` itself as one finished span: tagged into the ring
    AND appended to the JSONL sink. No-op unless ctx is sampled — the
    zero-overhead contract for unsampled requests."""
    if ctx is None or not ctx.sampled:
        return
    t0 = time.perf_counter() - dur if t0_perf is None else t0_perf
    tagged = dict(args)
    tagged["trace_id"] = ctx.trace_id
    tagged["span_id"] = ctx.span_id
    if ctx.parent_span_id:
        tagged["parent_span_id"] = ctx.parent_span_id
    record_span(name, t0, dur, cat, tagged)
    _sink_append({
        "trace_id": ctx.trace_id, "span_id": ctx.span_id,
        "parent_span_id": ctx.parent_span_id, "name": name, "cat": cat,
        "ts": time.time() - dur, "dur": dur, "pid": os.getpid(),
        "tid": threading.get_ident(),
        "args": args or None})


def record_trace_span(name: str, parent: Optional[TraceContext],
                      dur: float, cat: str = "trace",
                      t0_perf: Optional[float] = None, **args
                      ) -> Optional[TraceContext]:
    """Mint a child of `parent` and record it retroactively (the
    batcher/decode scheduler shape: the span's duration is only known
    after the fact). Returns the child, or None when unsampled."""
    if parent is None or not parent.sampled:
        return None
    child = parent.child()
    record_span_ctx(child, name, dur, cat=cat, t0_perf=t0_perf, **args)
    return child


@contextlib.contextmanager
def trace_span(name: str, cat: str = "trace",
               ctx: Optional[TraceContext] = None, **args):
    """Span that participates in the distributed trace: mints a child
    of the ambient (or explicit `ctx`) context, makes it ambient for
    the body — nested spans and downstream propagation see it — and
    records it on exit. When no sampled context is active this is a
    near-free no-op (one contextvar read), yielding the unchanged
    context. Pass `ctx` explicitly to adopt a context captured on
    another thread (batcher lead request, PS server envelope)."""
    cur = ctx if ctx is not None else _current.get()
    if cur is None or not cur.sampled:
        yield cur
        return
    child = cur.child()
    token = _current.set(child)
    t0 = time.perf_counter()
    try:
        yield child
    finally:
        _current.reset(token)
        record_span_ctx(child, name, time.perf_counter() - t0,
                        cat=cat, t0_perf=t0, **args)


@contextlib.contextmanager
def span(name: str, cat: str = "host", **args):
    """Context-manager span recorded into the unified store. When a
    sampled trace context is active, the span additionally joins the
    distributed trace (child ids + JSONL sink) — the executor's step
    spans gain the active trace id through exactly this path."""
    cur = _current.get()
    if cur is not None and cur.sampled:
        with trace_span(name, cat=cat, ctx=cur, **args):
            yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        record_span(name, t0, time.perf_counter() - t0, cat,
                    args or None)


@contextlib.contextmanager
def step_span(name: str, cat: str = "step", **args):
    """`span()` that also STARTS a root trace when none is active and
    PADDLE_TPU_TRACE_SAMPLE is armed — the training path's trace
    origin: Executor.run / run_chained / run_stream windows wrap their
    dispatch in this, so PS RPCs issued inside the step inherit the
    step's trace id without any trainer changes."""
    token = None
    if _current.get() is None and sample_rate() > 0.0:
        token = _current.set(start_trace())
    try:
        with span(name, cat=cat, **args):
            yield
    finally:
        if token is not None:
            _current.reset(token)


def get_spans(cat: Optional[str] = None) -> List[Span]:
    with _lock:
        out = list(_spans)
    if cat is not None:
        out = [s for s in out if s.cat == cat]
    return out


def dropped_spans() -> int:
    with _lock:
        return _dropped


def clear_spans():
    global _dropped
    with _lock:
        _spans.clear()
        _dropped = 0


# ---------------------------------------------------------------------------
# Chrome-trace export
# ---------------------------------------------------------------------------

# Host/step spans get stable synthetic pids so the tracks group cleanly in
# the viewer; device traces keep their own pids (offset on collision is
# unnecessary — jax pids are real OS pids, far from these).
_PID_BY_CAT = {"host": 1, "step": 2}


def spans_to_chrome_events(spans: Sequence[Span]) -> List[dict]:
    events = []
    tids: Dict[int, int] = {}
    for s in spans:
        tid = tids.setdefault(s.tid, len(tids))
        ev = {"name": s.name, "ph": "X",
              "pid": _PID_BY_CAT.get(s.cat, 3), "tid": tid,
              "ts": s.ts * 1e6, "dur": s.dur * 1e6, "cat": s.cat}
        if s.args:
            ev["args"] = {k: v for k, v in s.args.items()}
        events.append(ev)
    return events


def _load_chrome_trace(path: str) -> List[dict]:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    events = data.get("traceEvents", []) if isinstance(data, dict) else data
    for e in events:
        e.setdefault("cat", "device")
    return events


def find_device_traces(trace_dir: str) -> List[str]:
    """The jax profiler writes plugins/profile/<run>/<host>.trace.json.gz;
    accept plain .trace.json too."""
    hits = []
    for pat in ("**/*.trace.json.gz", "**/*.trace.json"):
        hits.extend(glob.glob(os.path.join(trace_dir, pat),
                              recursive=True))
    return sorted(set(hits))


def merge_chrome_traces(event_lists: Sequence[Sequence[dict]]) -> dict:
    merged: List[dict] = []
    for evs in event_lists:
        merged.extend(evs)
    return {"traceEvents": merged, "displayTimeUnit": "ms"}


_warned_dropped = [False]


def export_trace(path: str, trace_dir: Optional[str] = None,
                 spans: Optional[Sequence[Span]] = None) -> str:
    """Write ONE chrome trace: the unified span store (host + step +
    whatever else was recorded) plus every jax device trace found under
    `trace_dir`. Returns `path`. Warns ONCE per process when the ring
    evicted spans — the export window is then missing its oldest spans
    and the reader should know rather than trust a silently truncated
    timeline (the same drop count feeds the
    paddle_tpu_spans_dropped_total counter)."""
    if dropped_spans() and not _warned_dropped[0]:
        _warned_dropped[0] = True
        import logging

        logging.getLogger("paddle_tpu_torch.observability").warning(
            "export_trace: the span ring dropped %d span(s) (oldest "
            "evicted past MAX_SPANS=%d) — the exported window is "
            "incomplete at its start", dropped_spans(), MAX_SPANS)
    lists = [spans_to_chrome_events(
        spans if spans is not None else get_spans())]
    if trace_dir and os.path.isdir(trace_dir):
        for p in find_device_traces(trace_dir):
            try:
                lists.append(_load_chrome_trace(p))
            except (OSError, ValueError):
                continue  # truncated trace from a killed run: skip, keep ours
    trace = merge_chrome_traces(lists)
    from ..resilience.atomic import json_dump as _atomic_json_dump

    _atomic_json_dump(trace, path)
    return path


def save_spans(path: str) -> str:
    """Persist raw spans as JSON (spans.json in a run dir) so
    tools/obsdump.py can rebuild a trace offline."""
    from ..resilience.atomic import json_dump as _atomic_json_dump

    _atomic_json_dump([s._asdict() for s in get_spans()], path)
    return path


# ---------------------------------------------------------------------------
# Cross-process trace reassembly (the obsdump `trace --trace-id` backend)
# ---------------------------------------------------------------------------


def read_trace_dir(trace_dir: str) -> List[Dict[str, Any]]:
    """Every sampled-span record from every process sink under
    `trace_dir` (router + N replicas + PS servers each wrote their own
    trace-<pid>-<suffix>.jsonl). Malformed lines are skipped — a killed
    process can leave at most a torn tail, and the atomic-rewrite sink
    makes even that unlikely."""
    out: List[Dict[str, Any]] = []
    for path in sorted(glob.glob(os.path.join(trace_dir,
                                              "trace-*.jsonl"))):
        try:
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue
                    if isinstance(rec, dict) and rec.get("trace_id") \
                            and rec.get("span_id"):
                        out.append(rec)
        except OSError:
            continue
    return out


def trace_summaries(records: Sequence[Dict[str, Any]]
                    ) -> List[Dict[str, Any]]:
    """One row per trace_id (newest first): span count, distinct
    processes, the root span's name, start time, total duration."""
    by_tid: Dict[str, List[Dict[str, Any]]] = {}
    for r in records:
        by_tid.setdefault(r["trace_id"], []).append(r)
    rows = []
    for tid, recs in by_tid.items():
        ids = {r["span_id"] for r in recs}
        roots = [r for r in recs
                 if not r.get("parent_span_id")
                 or r["parent_span_id"] not in ids]
        roots.sort(key=lambda r: r.get("ts", 0.0))
        t0 = min(r.get("ts", 0.0) for r in recs)
        t1 = max(r.get("ts", 0.0) + r.get("dur", 0.0) for r in recs)
        rows.append({
            "trace_id": tid, "spans": len(recs),
            "processes": len({r.get("pid") for r in recs}),
            "root": roots[0]["name"] if roots else "?",
            "start_ts": t0, "wall_ms": round((t1 - t0) * 1000, 3)})
    rows.sort(key=lambda r: r["start_ts"], reverse=True)
    return rows


def build_trace_tree(records: Sequence[Dict[str, Any]], trace_id: str
                     ) -> List[Dict[str, Any]]:
    """Reassemble one trace's span TREE across processes: nodes are the
    sink records plus a `children` list, linked on parent_span_id and
    ordered by wall-clock start. Spans whose parent was never recorded
    (an unflushed/killed process, or the parent lives in an untraced
    tier) surface as additional roots rather than vanishing."""
    nodes = {r["span_id"]: dict(r, children=[])
             for r in records if r.get("trace_id") == trace_id}
    roots: List[Dict[str, Any]] = []
    for node in nodes.values():
        parent = node.get("parent_span_id")
        if parent and parent in nodes and parent != node["span_id"]:
            nodes[parent]["children"].append(node)
        else:
            roots.append(node)

    def _sort(children):
        children.sort(key=lambda n: n.get("ts", 0.0))
        for c in children:
            _sort(c["children"])

    _sort(roots)
    return roots


def trace_records_to_chrome(records: Sequence[Dict[str, Any]]
                            ) -> List[dict]:
    """Sink records → chrome trace events. Unlike the in-process ring
    (perf_counter epoch per process), sink records carry wall-clock
    start times, so spans from different processes line up on one
    timeline; pids are the real OS pids."""
    events = []
    tids: Dict[tuple, int] = {}
    for r in records:
        pid = int(r.get("pid", 0))
        tid = tids.setdefault((pid, r.get("tid", 0)), len(tids))
        ev = {"name": r.get("name", "?"), "ph": "X", "pid": pid,
              "tid": tid, "ts": float(r.get("ts", 0.0)) * 1e6,
              "dur": float(r.get("dur", 0.0)) * 1e6,
              "cat": r.get("cat", "trace")}
        args = dict(r.get("args") or {})
        args["trace_id"] = r.get("trace_id")
        args["span_id"] = r.get("span_id")
        if r.get("parent_span_id"):
            args["parent_span_id"] = r["parent_span_id"]
        ev["args"] = args
        events.append(ev)
    return events
