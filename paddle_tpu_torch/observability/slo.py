# Copied from the JAX package: paddle_tpu/observability/slo.py
# (stdlib only). Keep it in step with that file.
"""Declarative SLOs evaluated as multi-window multi-burn-rate alerts
over the recorded time series (timeseries.py → aggregate.py → here).

An objective is a JSON entry (spec file via PADDLE_TPU_SLO_SPEC /
`ServingConfig.slo_spec`, or a dict in tests):

  {"slos": [
    {"name": "predict-availability", "type": "availability",
     "target": 0.999,
     "errors": {"metric": "paddle_tpu_fleet_requests_total",
                "labels": {"outcome": "error"}},
     "total":  {"metric": "paddle_tpu_fleet_requests_total"}},
    {"name": "predict-latency", "type": "latency", "target": 0.95,
     "metric": "paddle_tpu_fleet_request_seconds",
     "threshold_s": 0.25}
  ]}

Both shapes reduce to one number per window: the BAD-event fraction.
Availability is errors/total over a ratio of two counter increases;
latency is re-framed the same way — the fraction of requests SLOWER
than threshold_s, with the shared bucket interpolation estimating the
split inside the straddling bucket. Burn rate = bad_fraction /
(1 - target): burn 1.0 consumes the error budget exactly at the rate
that exhausts it at the SLO period's end; burn 14.4 exhausts a 30-day
budget in ~2 days.

Alerting follows the Google-SRE multiwindow shape: a pair fires only
when BOTH its short and long windows exceed the pair's burn threshold
(the long window gives confidence, the short window makes recovery
reset fast). Defaults: fast = 5m/1h at 14.4x (page), slow = 30m/6h at
6x (ticket). `window_scale` shrinks every window uniformly so a bench
can exercise breach → fire → clear in seconds. State transitions emit
`slo_alert` events and count into `paddle_tpu_slo_alerts_total`;
the fast-window burn is exported as `paddle_tpu_slo_burn_rate`.

Stdlib-only and file-path importable (obsdump `slo` loads this without
the framework); siblings resolve through aggregate's `_sibling`.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional

__all__ = [
    "DEFAULT_WINDOWS", "load_spec", "SLOEngine",
    "maybe_start_evaluator", "stop_evaluator", "current_engine",
    "status_snapshot",
]

_HERE = os.path.dirname(os.path.abspath(__file__))

if __package__:
    from . import aggregate as _aggregate
    from . import events as _events
    from . import metrics as _metrics
else:  # file-path loaded (tools/obsdump.py): bootstrap siblings
    import importlib.util as _ilu

    def _load(name):
        spec = _ilu.spec_from_file_location(
            f"_pt_obs_{name}", os.path.join(_HERE, name + ".py"))
        mod = _ilu.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    _aggregate = _load("aggregate")
    _events = _load("events")
    _metrics = _load("metrics")

TS_DIR_ENV = "PADDLE_TPU_TS_DIR"
SLO_SPEC_ENV = "PADDLE_TPU_SLO_SPEC"
SLO_INTERVAL_ENV = "PADDLE_TPU_SLO_INTERVAL_S"
SLO_WINDOW_SCALE_ENV = "PADDLE_TPU_SLO_WINDOW_SCALE"

# Google-SRE multiwindow pairs (SLO period 30d): page on fast burn,
# ticket on slow burn. Scaled uniformly by SLOEngine(window_scale=).
DEFAULT_WINDOWS = (
    {"name": "fast", "short_s": 300.0, "long_s": 3600.0, "burn": 14.4},
    {"name": "slow", "short_s": 1800.0, "long_s": 21600.0, "burn": 6.0},
)

_BURN_GAUGE = _metrics.gauge(
    "paddle_tpu_slo_burn_rate",
    "Fast-window burn rate per SLO (1.0 = budget-neutral)",
    labelnames=("slo",))
_ALERTS_TOTAL = _metrics.counter(
    "paddle_tpu_slo_alerts_total",
    "SLO alert state transitions", labelnames=("slo", "state"))


def load_spec(spec) -> List[dict]:
    """Normalize a spec (dict, or path to a JSON file) into validated
    slo dicts. Raises ValueError on a malformed objective — a silently
    dropped SLO is an unmonitored SLO."""
    if isinstance(spec, str):
        with open(spec) as f:
            spec = json.load(f)
    if not isinstance(spec, dict) or not isinstance(spec.get("slos"), list):
        raise ValueError('SLO spec must be {"slos": [...]}')
    out = []
    for i, s in enumerate(spec["slos"]):
        if not isinstance(s, dict) or not s.get("name"):
            raise ValueError(f"slos[{i}]: missing name")
        name, typ = s["name"], s.get("type")
        target = float(s.get("target", 0))
        if not 0 < target < 1:
            raise ValueError(f"slo {name!r}: target must be in (0, 1)")
        if typ == "availability":
            for k in ("errors", "total"):
                if not isinstance(s.get(k), dict) \
                        or not s[k].get("metric"):
                    raise ValueError(
                        f"slo {name!r}: availability needs "
                        f'{k}.metric')
        elif typ == "latency":
            if not s.get("metric") or "threshold_s" not in s:
                raise ValueError(
                    f"slo {name!r}: latency needs metric + threshold_s")
        else:
            raise ValueError(
                f"slo {name!r}: type must be availability|latency")
        for w in s.get("windows", ()):
            if not all(k in w for k in ("name", "short_s", "long_s",
                                        "burn")):
                raise ValueError(
                    f"slo {name!r}: window needs name/short_s/long_s/burn")
        out.append(dict(s, target=target))
    return out


def _good_below(hist: Dict, threshold: float) -> float:
    """Observations ≤ threshold in a merged per-bin bucket table,
    linearly interpolated inside the straddling bucket (the same
    assumption bucket_quantile makes, inverted)."""
    good, prev_le = 0.0, 0.0
    for le, n in hist["buckets"]:
        if le <= threshold:
            good += n
        else:
            if threshold > prev_le:
                good += n * (threshold - prev_le) / (le - prev_le)
            break
        prev_le = le
    return good


class SLOEngine:
    """Evaluate objectives against a TS dir; keep per-SLO alert state
    across evaluations. Drive `evaluate()` from the background
    evaluator, a bench loop, or a test with an injected clock."""

    def __init__(self, slos, ts_dir: str, clock=time.time,
                 window_scale: float = 1.0):
        self.slos = load_spec({"slos": list(slos)}) \
            if not isinstance(slos, dict) else load_spec(slos)
        self.ts_dir = ts_dir
        self.clock = clock
        self.window_scale = max(1e-9, float(window_scale))
        self._state: Dict[str, str] = {
            s["name"]: "ok" for s in self.slos}
        self._last: List[dict] = []

    def _windows(self, slo: dict) -> List[dict]:
        ws = slo.get("windows") or [dict(w) for w in DEFAULT_WINDOWS]
        return [{"name": w["name"],
                 "short_s": float(w["short_s"]) * self.window_scale,
                 "long_s": float(w["long_s"]) * self.window_scale,
                 "burn": float(w["burn"])} for w in ws]

    def _bad_fraction(self, slo: dict, store, window_s: float,
                      now: float) -> Optional[float]:
        """Bad-event fraction over the window; None = no traffic (no
        data is not an outage — burn stays 0 until requests flow)."""
        if slo["type"] == "availability":
            tot = store.increase(slo["total"]["metric"], window_s, now,
                                 slo["total"].get("labels"))
            if tot <= 0:
                return None
            err = store.increase(slo["errors"]["metric"], window_s, now,
                                 slo["errors"].get("labels"))
            return min(1.0, max(0.0, err / tot))
        hist = store.hist_increase(slo["metric"], window_s, now,
                                   slo.get("labels"))
        if hist["count"] <= 0:
            return None
        good = _good_below(hist, float(slo["threshold_s"]))
        return min(1.0, max(0.0, 1.0 - good / hist["count"]))

    def evaluate(self, now: Optional[float] = None) -> List[dict]:
        """One evaluation pass: reload the TS dir, compute every
        window's burn, step each SLO's alert state machine (emitting
        `slo_alert` on transitions), return the status rows. Windows
        anchor at the NEWEST recorded sample (not wall clock), so an
        offline dir evaluates the same as it did live; burn therefore
        freezes rather than decaying if recording stops."""
        store = _aggregate.TSStore.load(self.ts_dir)
        if now is None:
            now = store.latest_ts()
            if now is None:
                now = self.clock()
        rows = []
        for slo in self.slos:
            name = slo["name"]
            budget = 1.0 - slo["target"]
            windows, firing = [], []
            current = None
            for w in self._windows(slo):
                burns = {}
                for side, wsec in (("short", w["short_s"]),
                                   ("long", w["long_s"])):
                    bad = self._bad_fraction(slo, store, wsec, now)
                    burns[side] = 0.0 if bad is None else bad / budget
                    if side == "long" and w["name"] == "fast":
                        current = None if bad is None else 1.0 - bad
                fires = burns["short"] >= w["burn"] \
                    and burns["long"] >= w["burn"]
                if fires:
                    firing.append(w["name"])
                windows.append({"window": w["name"], "burn": w["burn"],
                                "short_s": w["short_s"],
                                "long_s": w["long_s"],
                                "burn_short": burns["short"],
                                "burn_long": burns["long"],
                                "firing": fires})
                if w["name"] == "fast":
                    _BURN_GAUGE.set(burns["short"], slo=name)
            state = "fast_burn" if "fast" in firing else \
                "slow_burn" if "slow" in firing else "ok"
            prev = self._state[name]
            if state != prev:
                self._state[name] = state
                _ALERTS_TOTAL.inc(slo=name, state=state)
                _events.emit("slo_alert", slo=name, state=state,
                             prev=prev, slo_type=slo["type"],
                             target=slo["target"],
                             windows=[w for w in windows if w["firing"]]
                             or windows[:1])
            rows.append({"name": name, "type": slo["type"],
                         "target": slo["target"], "state": state,
                         "current": current, "windows": windows})
        self._last = rows
        return rows

    def last(self) -> List[dict]:
        return self._last

    def state(self, name: str) -> str:
        return self._state[name]

    def max_burn_rate(self) -> float:
        """Scalar for the autoscaler: the worst confirmed fast burn
        across objectives — min(short, long) per SLO so a single noisy
        short window can't trigger scale-out on its own."""
        worst = 0.0
        for row in self._last:
            for w in row["windows"]:
                if w["window"] == "fast":
                    worst = max(worst, min(w["burn_short"],
                                           w["burn_long"]))
        return worst


# ---------------------------------------------------------------------------
# Env-gated background evaluator (serving boots this from ServingConfig)
# ---------------------------------------------------------------------------

_engine: Optional[SLOEngine] = None
_eval_thread: Optional[threading.Thread] = None
_eval_stop = threading.Event()
_eval_lock = threading.Lock()
_atexit_registered = False


def current_engine() -> Optional[SLOEngine]:
    return _engine


def maybe_start_evaluator(spec_path: Optional[str] = None) -> bool:
    """Start the background SLO evaluator iff a spec (argument or
    PADDLE_TPU_SLO_SPEC) AND PADDLE_TPU_TS_DIR are configured. The
    period is PADDLE_TPU_SLO_INTERVAL_S (default 5s); windows shrink by
    PADDLE_TPU_SLO_WINDOW_SCALE. A malformed spec disables evaluation
    rather than killing the server boot."""
    global _engine, _eval_thread, _atexit_registered
    spec = spec_path or os.environ.get(SLO_SPEC_ENV)
    ts_dir = os.environ.get(TS_DIR_ENV)
    if not spec or not ts_dir:
        return False
    with _eval_lock:
        if _eval_thread is not None and _eval_thread.is_alive():
            return True
        try:
            engine = SLOEngine(
                load_spec(spec) if isinstance(spec, str) else spec,
                ts_dir,
                window_scale=float(os.environ.get(
                    SLO_WINDOW_SCALE_ENV, "1") or 1))
        except (OSError, ValueError):
            return False
        try:
            interval = float(os.environ.get(SLO_INTERVAL_ENV, "5"))
        except ValueError:
            interval = 5.0
        if interval <= 0:
            interval = 5.0
        _engine = engine
        _eval_stop.clear()

        def loop():
            while not _eval_stop.wait(interval):
                try:
                    engine.evaluate()
                except OSError:
                    pass  # TS dir vanished mid-run; keep serving alive

        _eval_thread = threading.Thread(
            target=loop, name="paddle-tpu-slo-eval", daemon=True)
        _eval_thread.start()
        if not _atexit_registered:
            import atexit

            atexit.register(stop_evaluator)
            _atexit_registered = True
        return True


def stop_evaluator():
    global _engine, _eval_thread
    with _eval_lock:
        t, _eval_thread = _eval_thread, None
        _engine = None
    if t is not None and t.is_alive():
        _eval_stop.set()
        t.join(timeout=5)


def status_snapshot() -> Dict:
    """The GET /v1/slo payload: live engine state when the evaluator
    runs; a transient evaluation when only env is configured; an
    explanatory error otherwise."""
    eng = _engine
    if eng is not None:
        rows = eng.last() or eng.evaluate()
        return {"slos": rows, "ts_dir": eng.ts_dir,
                "window_scale": eng.window_scale}
    spec = os.environ.get(SLO_SPEC_ENV)
    ts_dir = os.environ.get(TS_DIR_ENV)
    if spec and ts_dir:
        try:
            eng = SLOEngine(
                load_spec(spec), ts_dir,
                window_scale=float(os.environ.get(
                    SLO_WINDOW_SCALE_ENV, "1") or 1))
            return {"slos": eng.evaluate(), "ts_dir": ts_dir,
                    "window_scale": eng.window_scale,
                    "transient": True}
        except (OSError, ValueError) as e:
            return {"error": f"{type(e).__name__}: {e}"}
    return {"error": "no SLO engine: set PADDLE_TPU_SLO_SPEC (or "
                     "ServingConfig.slo_spec) and PADDLE_TPU_TS_DIR"}
