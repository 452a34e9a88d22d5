"""Profiler (reference: python/paddle/fluid/profiler.py:228 context manager
→ C++ host profiler + CUPTI DeviceTracer), on torch.profiler.

Counterpart of the JAX package's `profiler.py`, with the same API and
the same span store: `RecordEvent` annotates the timeline through
`torch.profiler.record_function` and records its host span in the
unified observability store (observability/tracing.py), so
`export_chrome_tracing` emits ONE trace holding RecordEvent host
spans, executor/decode step-telemetry spans, and the torch.profiler
timeline, which `stop_profiler` writes as `<dir>/<host>.trace.json`
(the file name `tracing.find_device_traces` merges).

The activities follow the process: the CPU always, and the CUDA
activity (kernel and memcpy records through CUPTI, from every thread
of the process) whenever `torch.cuda.is_initialized()`. A process that
uses CUDA but whose torch.profiler cannot trace it raises at start:
a profile without its device timeline is never taken quietly.

torch.profiler holds one trace per process: a second `start_profiler`
or `capture_profile` while one is active raises ProfilerBusyError.

A trace starts and stops only between device steps (`device_step`):
on the H100 a stop that overlapped a CUDA-graph replay on another
thread hung the whole process (ROADMAP F12), so the serving loops run
each step of device work inside `device_step()`.
"""

from __future__ import annotations

import contextlib
import os
import socket
import tempfile
import threading
import time
from collections import defaultdict
from typing import Dict, Optional

import torch

from .observability import tracing as _tracing

__all__ = ["profiler", "start_profiler", "stop_profiler", "reset_profiler",
           "trace_dir", "RecordEvent", "cuda_profiler", "npu_profiler",
           "export_chrome_tracing", "capture_profile", "ProfilerBusyError",
           "PROFILE_DIR_ENV", "MAX_CAPTURE_SECONDS", "device_step",
           "between_steps"]

_trace_dir: Optional[str] = None
_host_events = defaultdict(list)
_prof: Optional["torch.profiler.profile"] = None
# guards _prof: start and stop may run on different threads (an HTTP
# handler captures while the engines' threads launch)
_state_lock = threading.Lock()

# The steps of device work running now, the starts and stops waiting for
# them to end, and whether one is under way: a step waits while a start
# or stop waits or runs, and a start or stop waits for the running
# steps. Steps are short (a decode iteration, a predict batch).
_gate = threading.Condition()
_steps = 0
_waiting = 0
_switching = False
_thread_steps = threading.local()


@contextlib.contextmanager
def device_step():
    """A step of device work (a decode iteration, a predict batch) that
    no trace start or stop overlaps. Nests on one thread."""
    global _steps
    depth = getattr(_thread_steps, "depth", 0)
    if not depth:
        with _gate:
            while _waiting or _switching:
                _gate.wait()
            _steps += 1
    _thread_steps.depth = depth + 1
    try:
        yield
    finally:
        _thread_steps.depth = depth
        if not depth:
            with _gate:
                _steps -= 1
                _gate.notify_all()


@contextlib.contextmanager
def between_steps():
    """Wait for the device steps of other threads to end and hold new
    ones back while a trace starts or stops: `start_profiler` and the
    stop run inside it, and so should a caller's own torch.profiler
    start or stop in a process that serves."""
    global _waiting, _switching
    own = 1 if getattr(_thread_steps, "depth", 0) else 0
    with _gate:
        _waiting += 1
        while _switching or _steps > own:
            _gate.wait()
        _waiting -= 1
        _switching = True
    try:
        yield
    finally:
        with _gate:
            _switching = False
            _gate.notify_all()


class ProfilerBusyError(RuntimeError):
    """A capture (or a manually started trace) is already running.
    torch.profiler holds exactly one active trace per process, so
    concurrent /v1/profile requests must 409, not queue — a queued
    capture would measure a different window than the caller asked
    about."""


def _activities():
    """The CPU, plus CUDA whenever this process has initialized it;
    raises when CUDA is in use and torch.profiler cannot trace it."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_initialized():
        cuda = torch.profiler.ProfilerActivity.CUDA
        if cuda not in torch.profiler.supported_activities():
            raise RuntimeError(
                "this process uses CUDA but torch.profiler cannot trace "
                "it (no CUPTI support in this torch build); refusing a "
                "profile without its device timeline")
        acts.append(cuda)
    return acts


@contextlib.contextmanager
def profiler(state="All", sorted_key=None, profile_path="/tmp/profile",
             tracer_option="Default"):
    """reference: profiler.py:228 — `with profiler.profiler('All'):`"""
    start_profiler(state, profile_path)
    try:
        yield
    finally:
        stop_profiler(sorted_key, profile_path)


def start_profiler(state="All", profile_path="/tmp/profile",
                   tracer_option=None):
    global _trace_dir, _prof
    with _state_lock:
        if _prof is not None:
            raise ProfilerBusyError(
                "start_profiler called while a trace is already active; "
                "call stop_profiler() first (torch.profiler holds one "
                "trace per process)")
        d = profile_path if os.path.isdir(profile_path) or not \
            os.path.splitext(profile_path)[1] \
            else os.path.dirname(profile_path)
        os.makedirs(d or ".", exist_ok=True)
        prof = torch.profiler.profile(activities=_activities())
        with between_steps():
            prof.start()
            _trace_dir, _prof = d, prof


def _stop_trace() -> Optional[str]:
    """Stop the active trace and write its timeline into the trace dir;
    returns the file (None when no trace was active)."""
    global _prof
    with _state_lock:
        prof, _prof = _prof, None
        d = _trace_dir
    if prof is None:
        return None
    with between_steps():
        prof.stop()
    path = os.path.join(d or ".", f"{socket.gethostname()}.trace.json")
    prof.export_chrome_trace(path)
    return path


def stop_profiler(sorted_key=None, profile_path="/tmp/profile"):
    """Safe no-op when no trace was started — a teardown path may call it
    unconditionally."""
    _stop_trace()
    _print_host_events(sorted_key)


def reset_profiler():
    """Clear ALL host-side profiler state: the aggregate event table, the
    unified span store, and the remembered trace dir (so one test's trace
    path cannot leak into the next export)."""
    global _trace_dir
    _host_events.clear()
    _tracing.clear_spans()
    _trace_dir = None


def trace_dir() -> Optional[str]:
    """Directory the current/last trace wrote into (None after reset)."""
    return _trace_dir


def _print_host_events(sorted_key=None):
    if not _host_events:
        return
    rows = []
    for name, times in _host_events.items():
        total = sum(times)
        rows.append((name, len(times), total, total / len(times)))
    if sorted_key in (None, "total"):
        rows.sort(key=lambda r: -r[2])
    elif sorted_key == "calls":
        rows.sort(key=lambda r: -r[1])
    print(f"{'Event':40s} {'Calls':>8s} {'Total(ms)':>12s} {'Avg(ms)':>10s}")
    for name, calls, total, avg in rows:
        print(f"{name:40s} {calls:8d} {total * 1e3:12.3f} {avg * 1e3:10.3f}")


class RecordEvent:
    """reference: platform/profiler.h:81 RecordEvent RAII — host-side named
    span + a torch.profiler record_function range. The host span is
    recorded with cat="host" in the unified store."""

    def __init__(self, name: str):
        self.name = name
        self._ann = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        self._ann = torch.profiler.record_function(self.name)
        self._ann.__enter__()
        return self

    def __exit__(self, *a):
        self._ann.__exit__(*a)
        dur = time.perf_counter() - self._t0
        _host_events[self.name].append(dur)
        _tracing.record_span(self.name, self._t0, dur, cat="host")
        return False


@contextlib.contextmanager
def cuda_profiler(output_file=None, output_mode=None, config=None):
    """reference: profiler.py:39 — accelerator-profiler passthrough."""
    with profiler(profile_path=output_file or "/tmp/profile"):
        yield


npu_profiler = cuda_profiler


# ---------------------------------------------------------------------------
# On-demand bounded capture (the POST /v1/profile backend)
# ---------------------------------------------------------------------------

PROFILE_DIR_ENV = "PADDLE_TPU_PROFILE_DIR"
MAX_CAPTURE_SECONDS = 120.0
MIN_CAPTURE_SECONDS = 0.05


def capture_profile(seconds: float,
                    out_dir: Optional[str] = None) -> Dict[str, object]:
    """One bounded profiling window: a torch.profiler trace for
    `seconds`, then a merged chrome trace plus the live perf/memory
    attribution snapshot, written into a fresh artifact directory.

    Returns {"dir", "trace", "perf", "seconds"} — `trace` is the merged
    chrome://tracing JSON (unified span store + the torch.profiler
    timeline), `perf` a JSON sidecar holding the perfwatch MFU/step-time
    snapshot and the memwatch owner table taken at window close.

    Raises ProfilerBusyError when a capture or a user-started
    start_profiler() trace is active. Blocks the calling thread for the
    window — HTTP servers routing here are threaded, so the process
    keeps serving while the trace runs.
    """
    seconds = min(max(float(seconds), MIN_CAPTURE_SECONDS),
                  MAX_CAPTURE_SECONDS)
    if _prof is not None:  # start_profiler re-checks under the lock
        raise ProfilerBusyError("a profile capture is already running")
    base = os.environ.get(PROFILE_DIR_ENV)
    if out_dir is None:
        if base:
            os.makedirs(base, exist_ok=True)
        out_dir = tempfile.mkdtemp(prefix="paddle-tpu-profile-",
                                   dir=base or None)
    start_profiler(profile_path=out_dir)
    t0 = time.time()
    try:
        time.sleep(seconds)
    finally:
        # stop directly rather than via stop_profiler(): the aggregate
        # host-event table printing belongs to the interactive API, not
        # an HTTP handler's stdout
        _stop_trace()
    trace_path = _tracing.export_trace(
        os.path.join(out_dir, "trace.json"), trace_dir=out_dir)
    perf_path = os.path.join(out_dir, "perf.json")
    from .observability import events as _events
    from .observability import memwatch as _memwatch
    from .observability import perfwatch as _perfwatch
    from .observability import telemetry as _telemetry
    from .resilience.atomic import json_dump as _json_dump

    perf = {
        "window_seconds": seconds,
        "started_at": t0,
        "perfwatch": _perfwatch.snapshot(),
        "memory": _memwatch.status_block(),
        "host_blocked_seconds_total": _telemetry.host_blocked_total(),
    }
    _json_dump(perf, perf_path, indent=2, sort_keys=True, default=str)
    _events.emit("profile", dir=out_dir, seconds=seconds,
                 trace=trace_path)
    return {"dir": out_dir, "trace": trace_path, "perf": perf_path,
            "seconds": seconds}


def export_chrome_tracing(path, events=None):
    """Write ONE chrome://tracing JSON file (reference: tools/timeline.py:131
    converted profiler.proto to chrome trace): the unified span store
    (RecordEvent host spans, cat="host"; step telemetry, cat="step") plus
    the torch.profiler timeline when a trace dir is known.

    `events`, if given, is the legacy list of (name, start_s, dur_s)
    tuples and is exported verbatim instead of the span store."""
    spans = None
    if events is not None:
        spans = [_tracing.Span(name, start, dur, "host", 0, None)
                 for name, start, dur in events]
    return _tracing.export_trace(path, trace_dir=_trace_dir, spans=spans)
