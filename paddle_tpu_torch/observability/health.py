# Copied from the JAX package: paddle_tpu/observability/health.py
# (stdlib and numpy). Keep it in step with that file; its one change
# names this package's logger.
"""Tensor-health layer: NaN/Inf and out-of-range detection on the values
the framework already has in hand.

Reference analogue: FLAGS_check_nan_inf (platform/flags.cc:44) +
debugger.py — the reference scans every op output when the flag is on.
Here the scan sites are the framework's natural observation points
(executor fetches and written states, trainer losses, SPMD fetches, the
optimizer's gradient global-norm), and an anomaly does three things:
increments `paddle_tpu_health_anomalies_total{kind,site}`, appends an
`anomaly` event to the JSONL event log (events.py), and — depending on
the level — warns or raises with the offending variable names.

Env gating (re-read on every call so tests can monkeypatch; the common
"unset" case is one dict lookup, so the disabled hot path stays free):

  PADDLE_TPU_CHECK_NUMERICS   0 = off (default)
                              1 = count + log + warn, training continues
                              2 = count + log + raise NumericsError
  PADDLE_TPU_HEALTH_MAX_ABS   optional float; finite values with
                              |x| > threshold count as kind="overrange"
                              (catches divergence BEFORE it hits Inf)

`status()` feeds the /healthz HTTP route: "ok" until the first anomaly
since process start (or `reset()`), then "degraded" with the last
anomaly attached.

Imports: stdlib + numpy only — no jax. Callers hand over host-readable
arrays (jax arrays cross via __array__, which blocks on the transfer;
that cost is only paid when checking is enabled).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

from . import events as _events
from . import metrics as _m

__all__ = ["NumericsError", "check_level", "max_abs", "check_numerics",
           "record_grad_global_norm", "status", "anomaly_count", "reset",
           "introspection_enabled", "add_anomaly_listener",
           "remove_anomaly_listener"]

_log = logging.getLogger("paddle_tpu_torch.health")

ANOMALIES = _m.counter(
    "paddle_tpu_health_anomalies_total",
    "Tensor-health anomalies (kind=nan|inf|overrange) by observation "
    "site (executor_fetch|executor_state|trainer_loss|spmd_fetch|"
    "optimizer_grad)", labelnames=("kind", "site"))
CHECKS = _m.counter(
    "paddle_tpu_health_checks_total",
    "check_numerics sweeps performed", labelnames=("site",))
GRAD_GLOBAL_NORM = _m.gauge(
    "paddle_tpu_health_grad_global_norm",
    "Global L2 norm of the last optimizer gradient set")
LAST_ANOMALY_TS = _m.gauge(
    "paddle_tpu_health_last_anomaly_ts",
    "Unix time of the most recent anomaly (0 = none since start)")


class NumericsError(RuntimeError):
    """Raised at PADDLE_TPU_CHECK_NUMERICS=2 (or FLAGS_check_nan_inf).
    Subclasses RuntimeError so legacy `pytest.raises(RuntimeError)`
    callers of the FLAGS path keep working."""

    def __init__(self, site: str, anomalies: List[Dict[str, Any]]):
        self.site = site
        self.anomalies = anomalies
        names = ", ".join(
            f"'{a['var']}' ({a['kind']})" for a in anomalies)
        super().__init__(
            f"check_numerics[{site}]: NaN/Inf or out-of-range values in "
            f"{names}")


def check_level() -> int:
    """0 = off, 1 = warn, 2 = raise. Malformed env reads as 0 — a typo
    in a launcher must not change training semantics."""
    raw = os.environ.get("PADDLE_TPU_CHECK_NUMERICS")
    if not raw:
        return 0
    try:
        return max(0, min(2, int(raw)))
    except ValueError:
        return 0


def max_abs() -> Optional[float]:
    raw = os.environ.get("PADDLE_TPU_HEALTH_MAX_ABS")
    if not raw:
        return None
    try:
        v = float(raw)
    except ValueError:
        return None
    return v if v > 0 else None


def introspection_enabled() -> bool:
    """Whether the optional per-step introspection extras (device-buffer
    byte gauges) should run. Any observability env opt-in counts: if the
    user wired up scraping, dumping, event logging, or checking, they
    want the gauges; with nothing set, the hot path skips the work."""
    return bool(check_level()
                or os.environ.get("PADDLE_TPU_METRICS_DIR")
                or os.environ.get("PADDLE_TPU_METRICS_PORT")
                or os.environ.get("PADDLE_TPU_EVENT_LOG"))


# -- anomaly state (feeds /healthz) -----------------------------------------

_state_lock = threading.Lock()
_anomaly_count = 0
_last_anomaly: Optional[Dict[str, Any]] = None
_listeners: List[Any] = []


def add_anomaly_listener(fn):
    """Register `fn(event_dict)` to be called for every recorded
    anomaly — the hook recovery policies (resilience/policy.py) use to
    act on warn-level (level 1) anomalies that never raise. Listener
    exceptions are swallowed with a log line: a broken policy hook must
    not turn a warning into a crash."""
    with _state_lock:
        if fn not in _listeners:
            _listeners.append(fn)


def remove_anomaly_listener(fn):
    with _state_lock:
        try:
            _listeners.remove(fn)
        except ValueError:
            pass


def _classify(arr) -> List[Tuple[str, int]]:
    """(kind, bad-element-count) pairs for one float array."""
    import numpy as np

    out = []
    n_nan = int(np.isnan(arr).sum())
    if n_nan:
        out.append(("nan", n_nan))
    n_inf = int(np.isinf(arr).sum())
    if n_inf:
        out.append(("inf", n_inf))
    thresh = max_abs()
    if thresh is not None:
        # NaN comparisons are already False, so only Inf (|inf| > thresh
        # is True) needs subtracting to isolate finite overrange elements
        with np.errstate(invalid="ignore"):
            n_over = int((np.abs(arr) > thresh).sum()) - n_inf
        if n_over > 0:
            out.append(("overrange", n_over))
    return out


def check_numerics(site: str, named_values: Iterable[Tuple[str, Any]],
                   level: Optional[int] = None,
                   step: Optional[int] = None) -> List[Dict[str, Any]]:
    """Scan (name, array) pairs for NaN/Inf/out-of-range floats.

    Non-float and None values are skipped. Each offending variable
    yields one anomaly record per kind; all are counted and logged, then
    the batch warns (level 1) or raises NumericsError (level 2). Returns
    the anomaly records (empty when clean). `level` defaults to the env
    level — callers that force a raise (FLAGS_check_nan_inf) pass 2."""
    import numpy as np

    if level is None:
        level = check_level()
    if level <= 0:
        return []
    CHECKS.inc(site=site)
    anomalies: List[Dict[str, Any]] = []
    for name, val in named_values:
        if val is None:
            continue
        try:
            arr = np.asarray(val)
        except (TypeError, ValueError):
            continue
        if not np.issubdtype(arr.dtype, np.floating):
            # ml_dtypes floats (bfloat16/float8_*, the dominant TPU
            # training dtypes) are NOT np.floating subtypes; they must
            # not slip past the scan — upcast preserves NaN/Inf
            if "float" not in arr.dtype.name:
                continue
            arr = arr.astype(np.float32)
        for kind, n_bad in _classify(arr):
            anomalies.append({"var": str(name), "kind": kind,
                              "bad": n_bad, "size": int(arr.size)})
    if anomalies:
        _record_anomalies(site, anomalies, step=step)
        if level >= 2:
            raise NumericsError(site, anomalies)
        _log.warning(
            "check_numerics[%s]: %s", site,
            "; ".join(f"{a['var']}: {a['bad']}/{a['size']} {a['kind']}"
                      for a in anomalies))
    return anomalies


def _record_anomalies(site: str, anomalies: List[Dict[str, Any]],
                      step: Optional[int] = None):
    global _anomaly_count, _last_anomaly
    now = time.time()
    for a in anomalies:
        ANOMALIES.inc(kind=a["kind"], site=site)
        # the event's "kind" slot is the event type; the numeric kind
        # (nan|inf|overrange) travels as "anomaly"
        ev_fields = dict(site=site, var=a["var"], anomaly=a["kind"],
                         bad=a["bad"], size=a["size"])
        if step is not None:
            ev_fields["step"] = int(step)
        ev = _events.emit("anomaly", **ev_fields)
        with _state_lock:
            _anomaly_count += 1
            _last_anomaly = ev
            listeners = list(_listeners)
        for fn in listeners:  # outside the lock: a listener may read
            # health state (anomaly_count) without deadlocking
            try:
                fn(ev)
            except Exception:
                _log.exception("anomaly listener %r failed", fn)
    LAST_ANOMALY_TS.set(now)


def record_grad_global_norm(norm: float, site: str = "optimizer_grad",
                            n_params: int = 0,
                            level: Optional[int] = None):
    """Gauge the optimizer's gradient global L2 norm and treat a
    non-finite norm as an anomaly at `site` (a single NaN gradient
    element poisons the whole norm, so this one scalar covers every
    parameter's gradient)."""
    import math

    GRAD_GLOBAL_NORM.set(norm)
    if level is None:
        level = check_level()
    if level <= 0 or math.isfinite(norm):
        return
    kind = "nan" if math.isnan(norm) else "inf"
    anomalies = [{"var": "grad_global_norm", "kind": kind,
                  "bad": 1, "size": max(1, int(n_params))}]
    _record_anomalies(site, anomalies)
    if level >= 2:
        raise NumericsError(site, anomalies)
    _log.warning("check_numerics[%s]: gradient global norm is %s",
                 site, norm)


def anomaly_count() -> int:
    with _state_lock:
        return _anomaly_count


def status() -> Dict[str, Any]:
    """/healthz payload: ok until the first anomaly since start/reset()."""
    with _state_lock:
        degraded = _anomaly_count > 0
        out: Dict[str, Any] = {
            "status": "degraded" if degraded else "ok",
            "anomalies": _anomaly_count,
            "check_numerics": check_level(),
        }
        if _last_anomaly is not None:
            out["last_anomaly"] = dict(_last_anomaly)
    return out


def reset():
    """Clear the degraded state (test hygiene / operator acknowledge).
    Registry counters are left alone — they are cumulative by design."""
    global _anomaly_count, _last_anomaly
    with _state_lock:
        _anomaly_count = 0
        _last_anomaly = None
    LAST_ANOMALY_TS.set(0)
