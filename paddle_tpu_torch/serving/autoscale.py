# Copied from the JAX package: paddle_tpu/serving/autoscale.py
# (stdlib only). Keep it in step with that file; its declared change
# rewords one comment line.
"""Elastic autoscaling control loop for the serving fleet.

Closes the loop between the Router's gauges and the
ReplicaSupervisor's scale_out/scale_in (SERVING.md §Fleet): every
`interval_s` it reads

  * **utilization** — `router.mean_load_per_healthy()`: mean (queue
    depth + in-flight) per healthy replica, i.e. the /v1/load scalar
    the router already polls, and
  * **latency** — `router.recent_p99(window_s)`: trailing p99 of
    successful predicts, and
  * **SLO burn** (optional) — `burn_rate_fn`, typically
    `observability.slo.SLOEngine.max_burn_rate`: the worst confirmed
    fast-window burn rate across declared objectives (PROFILE.md §Time
    series & SLOs), so the fleet grows when the error budget is being
    SPENT too fast, not only when queues are visibly deep,

and moves the replica count within `[min_replicas, max_replicas]` with
classic hysteresis so noise cannot flap the fleet:

  * scale OUT when load > `high_load` (or p99 > `p99_high_ms`, or burn
    ≥ `burn_high`) for `breach_polls` CONSECUTIVE polls AND
    `out_cooldown_s` has passed since the last scaling action;
  * scale IN when load < `low_load` AND p99 is under any configured
    bound AND burn is under `burn_high` for `clear_polls` consecutive
    polls AND `in_cooldown_s` passed — deliberately slower than
    scale-out (capacity mistakes in the down direction hurt users; in
    the up direction they only cost a replica).

The gap between `high_load` and `low_load` is the hysteresis band: a
fleet sitting anywhere inside it is left alone. Scale-out lands within
seconds because replicas boot from the warmstart artifact;
scale-in is graceful because the supervisor SIGTERMs and the replica
runs leave→drain→stop (zero dropped in-flight requests, tested by
`serve_bench --fleet`).

Multi-model fleets (SERVING.md §Multi-tenancy) allocate replica counts
per model by running one Autoscaler + ReplicaSupervisor pair per model
id against the SAME router: `Autoscaler(model="bert")` scopes the
utilization signal to `router.mean_load_per_healthy(model="bert")` —
the replicas advertising that model in /v1/load — while each model's
supervisor boots replicas serving only its model. Models then scale
independently on their own load, sharing the fleet's front door.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from ..observability import events as _events
from ..observability import metrics as _m

__all__ = ["Autoscaler"]

AUTOSCALE = _m.counter(
    "paddle_tpu_fleet_autoscale_total",
    "Autoscaler scaling actions", labelnames=("direction",))
TARGET = _m.gauge(
    "paddle_tpu_fleet_target_replicas",
    "Replica count the autoscaler currently steers toward")


class Autoscaler:
    """Queue-depth/p99 control loop over a router + supervisor — see
    the module docstring for the policy. `router` and `supervisor` are
    duck-typed (tests drive fakes): router needs
    mean_load_per_healthy() and recent_p99(); supervisor needs
    replica_count(), scale_out() and scale_in()."""

    def __init__(self, router, supervisor, *,
                 model: Optional[str] = None,
                 min_replicas: int = 1, max_replicas: int = 4,
                 high_load: float = 4.0, low_load: float = 0.5,
                 p99_high_ms: Optional[float] = None,
                 burn_rate_fn=None, burn_high: float = 14.4,
                 interval_s: float = 0.5,
                 breach_polls: int = 3, clear_polls: int = 6,
                 out_cooldown_s: float = 5.0,
                 in_cooldown_s: float = 10.0,
                 clock=time.monotonic):
        if min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if max_replicas < min_replicas:
            raise ValueError("max_replicas must be >= min_replicas")
        if low_load >= high_load:
            raise ValueError(
                "low_load must be < high_load — the gap between them "
                "is the hysteresis band; without it the fleet flaps")
        self.router = router
        self.supervisor = supervisor
        # scope the utilization signal to one model's replica slice
        # (per-model allocation: one Autoscaler+Supervisor pair per
        # model id, all sharing one Router). None = whole fleet.
        self.model = str(model) if model is not None else None
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.high_load = float(high_load)
        self.low_load = float(low_load)
        self.p99_high_ms = p99_high_ms
        # optional SLO input: a zero-arg callable returning the current
        # worst fast-window burn rate (0.0 = budget-neutral traffic)
        self.burn_rate_fn = burn_rate_fn
        self.burn_high = float(burn_high)
        self.interval_s = float(interval_s)
        self.breach_polls = int(breach_polls)
        self.clear_polls = int(clear_polls)
        self.out_cooldown_s = float(out_cooldown_s)
        self.in_cooldown_s = float(in_cooldown_s)
        self._clock = clock
        self._high_streak = 0
        self._low_streak = 0
        self._last_action_t: Optional[float] = None
        self._actions = {"out": 0, "in": 0}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------

    def start(self):
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="paddle-tpu-fleet-autoscaler",
            daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=10.0)

    def _loop(self):
        while not self._stop.is_set():
            try:
                self.tick()
            except Exception as e:  # control loop must outlive a bad tick
                _events.emit("fleet", action="autoscale_error",
                             error=f"{type(e).__name__}: {e}"[:200])
            self._stop.wait(self.interval_s)

    # -- the control law ----------------------------------------------

    def _cooldown_over(self, cooldown_s: float) -> bool:
        return self._last_action_t is None or \
            (self._clock() - self._last_action_t) >= cooldown_s

    def tick(self) -> Optional[str]:
        """One control decision; returns "out", "in", or None (also the
        unit-test entry — tests drive ticks directly with fakes and an
        injected clock). Streak counters only advance on polls with a
        real signal: an empty fleet (load None) is the supervisor's /
        router's problem, not a scale-in signal."""
        n = self.supervisor.replica_count()
        if self.model is not None:
            load = self.router.mean_load_per_healthy(model=self.model)
        else:
            # keyword-free call keeps duck-typed test fakes (zero-arg
            # mean_load_per_healthy) working unchanged
            load = self.router.mean_load_per_healthy()
        p99 = self.router.recent_p99()
        p99_ms = p99 * 1000.0 if p99 is not None else None
        TARGET.set(n)
        if load is None:
            # nothing healthy to measure: hold position (the supervisor
            # respawn/boot path is responsible for bringing one back)
            self._high_streak = self._low_streak = 0
            return None

        burn = None
        if self.burn_rate_fn is not None:
            try:
                burn = float(self.burn_rate_fn())
            except Exception:
                burn = None  # lint-exempt:swallow: a broken SLO feed must not stop load/p99 scaling

        high = load > self.high_load or (
            self.p99_high_ms is not None and p99_ms is not None
            and p99_ms > self.p99_high_ms) or (
            burn is not None and burn >= self.burn_high)
        low = load < self.low_load and (
            self.p99_high_ms is None or p99_ms is None
            or p99_ms <= self.p99_high_ms) and (
            burn is None or burn < self.burn_high)
        self._high_streak = self._high_streak + 1 if high else 0
        self._low_streak = self._low_streak + 1 if low else 0

        if high and self._high_streak >= self.breach_polls \
                and n < self.max_replicas \
                and self._cooldown_over(self.out_cooldown_s):
            endpoint = self.supervisor.scale_out()
            self._after_action("out", n, load, p99_ms,
                               endpoint=endpoint)
            return "out"
        if low and self._low_streak >= self.clear_polls \
                and n > self.min_replicas \
                and self._cooldown_over(self.in_cooldown_s):
            endpoint = self.supervisor.scale_in()
            self._after_action("in", n, load, p99_ms, endpoint=endpoint)
            return "in"
        return None

    def _after_action(self, direction: str, n_before: int,
                      load: float, p99_ms: Optional[float],
                      endpoint: Optional[str]):
        self._last_action_t = self._clock()
        self._high_streak = self._low_streak = 0
        self._actions[direction] += 1
        AUTOSCALE.inc(direction=direction)
        TARGET.set(n_before + (1 if direction == "out" else -1))
        _events.emit("fleet", action=f"scale_{direction}_decision",
                     replicas_before=n_before,
                     load=round(load, 3),
                     p99_ms=round(p99_ms, 3) if p99_ms else None,
                     endpoint=endpoint)

    def status(self) -> Dict:
        return {
            "model": self.model,
            "min": self.min_replicas, "max": self.max_replicas,
            "high_load": self.high_load, "low_load": self.low_load,
            "p99_high_ms": self.p99_high_ms,
            "burn_high": self.burn_high
            if self.burn_rate_fn is not None else None,
            "high_streak": self._high_streak,
            "low_streak": self._low_streak,
            "actions": dict(self._actions),
        }
