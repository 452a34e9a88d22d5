# Copied from the JAX package: paddle_tpu/resilience/preemption.py
# (stdlib only). Keep it in step with that file.
"""Preemption handling: turn SIGTERM into a clean checkpoint-and-exit.

Preemptible TPU slices get a termination notice (SIGTERM, typically with
a ~30 s grace window) before the machine disappears. Dying mid-step
loses everything since the last checkpoint; the right response is to
finish the current step, write a final checkpoint, and exit with a code
that tells the supervisor "this was a preemption, not a bug — reschedule
me". This module is the process-wide stop flag that makes that protocol
possible:

  - `install()` registers signal handlers (env-gated via
    PADDLE_TPU_PREEMPT_SIGNALS, e.g. "TERM" or "TERM,INT") that set the
    flag — handlers do nothing else, so they are async-signal-safe.
  - the training loops (parallel.train.train_loop, trainer.py) poll
    `stop_requested()` at every step boundary — the only place a stop
    is safe (device buffers consistent, no donated-buffer step in
    flight) — checkpoint, and return stop reason "preempted".
  - the worker then exits with PREEMPT_EXIT_CODE (sysexits EX_TEMPFAIL:
    "temporary failure, retry"), which distributed/launch.py propagates
    instead of counting against the crash-restart budget.

`request_stop()` is also the programmatic entry: the fault injector's
'preempt' action and recovery policies use it to route through the same
graceful-stop machinery a real SIGTERM would.
"""

from __future__ import annotations

import os
import signal
import threading
from typing import Dict, List, Optional

from ..observability import events as _events
from ..observability import metrics as _m

__all__ = ["PREEMPT_EXIT_CODE", "SIGNALS_ENV", "install",
           "maybe_install_from_env", "uninstall", "request_stop",
           "stop_requested", "stop_reason", "reset"]

# sysexits EX_TEMPFAIL — "temporary failure; the user is invited to
# retry". Distinct from faults.CRASH_EXIT_CODE (70) and from ordinary
# nonzero crashes; launch.py keys its preemption-vs-crash logic on it.
PREEMPT_EXIT_CODE = 75

SIGNALS_ENV = "PADDLE_TPU_PREEMPT_SIGNALS"

PREEMPTIONS = _m.counter(
    "paddle_tpu_preempt_requests_total",
    "Graceful-stop requests (signal or programmatic)")

_lock = threading.Lock()
_stop = threading.Event()
_reason: Optional[str] = None
_pending_emit = False
_prev_handlers: Dict[int, object] = {}


def request_stop(reason: str = "requested") -> None:
    """Ask the training loops to stop at the next step boundary. First
    call wins (the recorded reason is the original trigger); always
    idempotent and safe from any thread."""
    global _reason, _pending_emit
    with _lock:
        if _stop.is_set():
            return
        _reason = reason
        _pending_emit = True
        _stop.set()
    _flush_pending_emit()


def _flush_pending_emit():
    """Emit the one-time preempt event/counter from ordinary (non-
    signal) context. The signal handler must not call into the event
    log or metrics registry — the interrupted main thread may be
    holding their locks mid-emit, and re-acquiring from the handler
    would deadlock — so it only flags, and the emit happens here when
    a polling site next looks at the stop state."""
    global _pending_emit
    with _lock:
        if not _pending_emit:
            return
        _pending_emit = False
        reason = _reason
    PREEMPTIONS.inc()
    _events.emit("preempt", reason=reason)


def stop_requested() -> bool:
    if _stop.is_set():
        _flush_pending_emit()
        return True
    return False


def stop_reason() -> Optional[str]:
    with _lock:
        return _reason


def _handler(signum, frame):
    # async-signal-safe-ish: no locks beyond Event.set — record the
    # trigger, flag the pending event, and return; the step-boundary
    # poll does the observable work
    global _reason, _pending_emit
    if _stop.is_set():
        return
    try:
        name = signal.Signals(signum).name
    except ValueError:
        name = str(signum)
    _reason = f"signal:{name}"
    _pending_emit = True
    _stop.set()


def _resolve(names: List[str]) -> List[int]:
    out = []
    for n in names:
        n = n.strip().upper()
        if not n:
            continue
        if not n.startswith("SIG"):
            n = "SIG" + n
        sig = getattr(signal, n, None)
        if sig is None:
            raise ValueError(f"unknown signal {n!r} in {SIGNALS_ENV}")
        out.append(int(sig))
    return out


def install(signals: Optional[List[str]] = None) -> bool:
    """Register graceful-stop handlers (default: SIGTERM). Returns False
    when handlers cannot be installed (non-main thread — jax's compile
    threads and serving workers land here); polling request_stop() still
    works, only the signal trigger is unavailable. Idempotent."""
    sigs = _resolve(signals if signals is not None else ["TERM"])
    ok = True
    for signum in sigs:
        with _lock:
            if signum in _prev_handlers:
                continue
        try:
            prev = signal.signal(signum, _handler)
        except ValueError:  # not in main thread
            ok = False
            continue
        with _lock:
            _prev_handlers[signum] = prev
    return ok


def maybe_install_from_env() -> bool:
    """Install handlers iff PADDLE_TPU_PREEMPT_SIGNALS is set — the
    training loops call this so plain `python train.py` runs keep their
    default signal semantics (Ctrl-C raises KeyboardInterrupt) unless
    the operator opts in."""
    raw = os.environ.get(SIGNALS_ENV)
    if not raw:
        return False
    return install(raw.split(","))


def uninstall():
    """Restore pre-install handlers (test hygiene)."""
    with _lock:
        items = list(_prev_handlers.items())
        _prev_handlers.clear()
    for signum, prev in items:
        try:
            signal.signal(signum, prev)
        except (ValueError, TypeError):
            pass


def reset():
    """Clear the stop flag and reason (test hygiene; installed handlers
    are left alone — use uninstall() for those)."""
    global _reason, _pending_emit
    with _lock:
        _stop.clear()
        _reason = None
        _pending_emit = False
