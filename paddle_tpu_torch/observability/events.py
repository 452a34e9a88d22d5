# Copied from the JAX package: paddle_tpu/observability/events.py
# (stdlib only). Keep it in step with that file.
"""Append-only JSONL event log: the discrete-occurrence companion to the
metrics registry.

Metrics answer "how much/how fast"; this log answers "what happened and
when": XLA compiles (a recompile storm is a sequence of `compile` events
seconds apart), trainer run summaries, tensor-health anomalies, and
checkpoint writes. Every event carries a process-monotonic `seq` and a
wall-clock `ts`, so a tail of the file reconstructs the run's story even
after the process died — the reason long TPU jobs keep such a log on
disk rather than only in memory.

Sinks:
  - an in-process ring (`recent()`), always on and bounded — this is what
    the /events HTTP route and tests read;
  - a JSONL file, appended when `PADDLE_TPU_EVENT_LOG` names a path (or,
    if unset, `PADDLE_TPU_METRICS_DIR` is set, in which case
    `<dir>/events.jsonl` is used). One `json.dumps` line per event,
    append-only: `tools/obsdump.py events` tails and pretty-prints it.

Rotation: with `PADDLE_TPU_EVENT_LOG_MAX_BYTES` set, the file sink
rolls over before an append would push the file past the cap —
events.jsonl → events.jsonl.1 (→ .2 …), keeping
`PADDLE_TPU_EVENT_LOG_KEEP` rotated files (default 3, oldest deleted) —
so an append-only log under fleet load stays bounded instead of growing
without limit. `obsdump events --follow` detects the rename (inode
change) and reopens the fresh file without dropping lines.

Trace join key: when the distributed-tracing layer (tracing.py) has a
sampled context active at emit time, the event gains a `trace_id` field
— the JSONL event log then joins against the trace sink without every
emitter threading ids by hand. The hook is injected via
`set_trace_provider` (observability/__init__.py wires it) so this
module stays stdlib-only and file-path importable.

Schema (stable, documented in PROFILE.md §Health):
  {"seq": int, "ts": float unix seconds, "kind": str, ...kind fields}

This module is stdlib-only by contract: tools/obsdump.py imports it by
file path without pulling in the framework or jax.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Any, Dict, Iterable, List, Optional

__all__ = ["emit", "recent", "clear", "log_path", "read_jsonl",
           "set_trace_provider", "MAX_EVENTS", "KINDS"]

# Known event kinds (emitters may add more; these are the documented core).
# serve_start/serve_stop bracket a serving.Server's lifetime (SERVING.md).
# restore/preempt/fault/recovery/rank_restart are the resilience layer's
# story of a faulty run (RESILIENCE.md): checkpoint restores (incl.
# corrupt-fallback skips), graceful-stop requests, injected faults,
# recovery-policy actions, and launcher rank restarts.
# rendezvous/resize/restore_resharded are the elastic layer's story of a
# world-size change (RESILIENCE.md §Elasticity): sealed generations,
# mesh re-formations, and cross-mesh checkpoint restores.
# ps_failover is the parameter-server tier's story of an outage
# (RESILIENCE.md §Parameter-server fault tolerance): breaker
# transitions, reconnects, snapshot restores at server boot, supervisor
# respawns, and counted gradient drops.
# fleet is the serving fleet tier's story (SERVING.md §Fleet): member
# joins/leaves, health ejections/readmissions, retry failovers, breaker
# transitions, autoscale decisions, replica respawns; serve_drain marks
# a replica's graceful scale-in drain.
# slo_alert is the SLO engine's story (PROFILE.md §Time series & SLOs):
# burn-rate alert state transitions (ok ↔ fast_burn/slow_burn) with the
# firing window's burn numbers attached.
# oom is the memory tier's post-mortem (PROFILE.md §Continuous
# profiling): a RESOURCE_EXHAUSTED intercepted on a dispatch path with
# the ranked per-owner live-buffer attribution attached; hbm_budget
# marks PADDLE_TPU_HBM_BUDGET_BYTES state transitions (warn/error);
# profile marks an on-demand /v1/profile capture window with its
# artifact dir.
KINDS = ("compile", "compile_cache", "step_summary", "anomaly",
         "checkpoint", "serve_start", "serve_stop", "serve_drain",
         "restore", "preempt",
         "fault", "recovery", "rank_restart", "pipeline_stall",
         "warmstart", "amp_overflow", "quantize", "analysis",
         "rendezvous", "resize", "restore_resharded", "ps_failover",
         "decode", "fleet", "slo_alert",
         "oom", "hbm_budget", "profile")

# Ring bound: a week-long run emitting a compile+summary event per minute
# stays far under this; anomaly storms get truncated to the latest window.
MAX_EVENTS = 4096

_lock = threading.Lock()
_file_lock = threading.Lock()  # file appends serialize separately: a
# slow disk must not block ring readers (/events) or other emitters'
# seq assignment
_ring: "collections.deque[Dict[str, Any]]" = collections.deque(
    maxlen=MAX_EVENTS)
_seq = 0


_trace_provider = None


def set_trace_provider(fn):
    """Install the callable emit() asks for the active sampled trace id
    (observability/__init__.py wires tracing.current_trace_id here;
    None uninstalls). Kept as injection so this module never imports
    its sibling — tools/obsdump.py loads it standalone by file path."""
    global _trace_provider
    _trace_provider = fn


def log_path() -> Optional[str]:
    """Resolved JSONL sink path, or None when file logging is off.
    Re-read from the env on every call so tests can monkeypatch."""
    p = os.environ.get("PADDLE_TPU_EVENT_LOG")
    if p:
        return p
    d = os.environ.get("PADDLE_TPU_METRICS_DIR")
    if d:
        return os.path.join(d, "events.jsonl")
    return None


def _rotate_cap() -> int:
    """PADDLE_TPU_EVENT_LOG_MAX_BYTES as an int (0/unset/malformed =
    rotation off)."""
    raw = os.environ.get("PADDLE_TPU_EVENT_LOG_MAX_BYTES")
    if not raw:
        return 0
    try:
        return max(0, int(raw))
    except ValueError:
        return 0


def _rotate_keep() -> int:
    try:
        return max(1, int(os.environ.get("PADDLE_TPU_EVENT_LOG_KEEP",
                                         "3")))
    except ValueError:
        return 3


def _maybe_rotate_locked(path: str, incoming: int):
    """Under _file_lock: roll the sink over when appending `incoming`
    bytes would push it past the cap. os.replace renames are atomic, so
    a concurrent reader sees either the old file (under its old inode —
    how `obsdump events --follow` finishes the tail before reopening)
    or the fresh one, never a mix.

    The sink is shared ACROSS processes in a fleet (every replica
    inherits PADDLE_TPU_EVENT_LOG), so the keep-chain shift is guarded
    by an OS-level flock on a sibling lockfile — two processes racing
    the cap would otherwise both rotate, shifting a seconds-old
    generation outward and deleting the oldest retained file early. The
    size is re-checked under the flock: the loser of the race sees the
    fresh (small) file and skips."""
    cap = _rotate_cap()
    if not cap:
        return
    try:
        size = os.path.getsize(path)
    except OSError:
        return
    if size == 0 or size + incoming <= cap:
        return
    lockf = None
    try:
        import fcntl
        lockf = open(path + ".rotlock", "a")
        fcntl.flock(lockf, fcntl.LOCK_EX)
    except (ImportError, OSError):
        lockf = None  # non-POSIX / unwritable dir: best-effort rotate
    try:
        if lockf is not None:
            try:
                size = os.path.getsize(path)
            except OSError:
                return
            if size == 0 or size + incoming <= cap:
                return  # a peer process rotated while we waited
        keep = _rotate_keep()
        try:
            oldest = f"{path}.{keep}"
            if os.path.exists(oldest):
                os.remove(oldest)
            for i in range(keep - 1, 0, -1):
                src = f"{path}.{i}"
                if os.path.exists(src):
                    os.replace(src, f"{path}.{i + 1}")
            os.replace(path, f"{path}.1")
        except OSError:
            pass  # lint-exempt:swallow: rotation is best-effort; the append below still lands
    finally:
        if lockf is not None:
            try:
                lockf.close()  # releases the flock
            except OSError:
                pass  # lint-exempt:swallow: lockfile close on teardown


def emit(kind: str, **fields) -> Dict[str, Any]:
    """Record one event: ring always, file when a sink is configured.
    Returns the event dict (with seq/ts filled in)."""
    global _seq
    with _lock:
        _seq += 1
        ev: Dict[str, Any] = {"seq": _seq, "ts": time.time(), "kind": kind}
        ev.update(fields)
        if _trace_provider is not None and "trace_id" not in ev:
            try:
                tid = _trace_provider()
            except Exception:
                tid = None
            if tid:
                ev["trace_id"] = tid
        _ring.append(ev)
    path = log_path()
    if path:
        # outside the ring lock: concurrent writers may land file lines
        # out of seq order, but each line is whole and carries its seq
        try:
            line = json.dumps(ev, default=str) + "\n"
            with _file_lock:
                d = os.path.dirname(path)
                if d:
                    os.makedirs(d, exist_ok=True)
                _maybe_rotate_locked(path, len(line))
                with open(path, "a") as f:
                    f.write(line)
        except OSError:
            pass  # a full/vanished disk must not kill the trainer
    return ev


def _tail(evs: List[Dict[str, Any]], n: Optional[int]):
    if n is None:
        return evs
    n = int(n)
    return evs[-n:] if n > 0 else []  # [-0:] would mean "everything"


def recent(n: int = 100, kind: Optional[str] = None) -> List[Dict[str, Any]]:
    """Last `n` events (oldest first), optionally filtered by kind."""
    with _lock:
        evs = list(_ring)
    if kind is not None:
        evs = [e for e in evs if e.get("kind") == kind]
    return _tail(evs, n)


def clear():
    """Drop the in-memory ring (test hygiene; the file is append-only and
    never truncated here)."""
    with _lock:
        _ring.clear()


def read_jsonl(path: str, n: Optional[int] = None,
               kind: Optional[str] = None) -> List[Dict[str, Any]]:
    """Parse a JSONL event file: last `n` events, optionally filtered by
    kind. Malformed lines are skipped (a crash mid-append can truncate
    the final line). tools/obsdump.py's `events` subcommand carries its
    own single-file-handle variant of this logic so its --follow mode
    has no gap between the initial tail and the stream."""
    out: List[Dict[str, Any]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except ValueError:
                continue
            if kind is not None and ev.get("kind") != kind:
                continue
            out.append(ev)
    return _tail(out, n)
