# Copied from the JAX package: paddle_tpu/resilience/faults.py
# (stdlib only). Keep it in step with that file.
"""Deterministic, env-gated fault injection for resilience testing.

A fault-tolerance subsystem that has never seen a fault is a liability:
the commit-marker protocol, the retry loop and the resume path all need
a way to be *provoked* on demand, in-process and in CI, without patching
framework internals. This harness is that lever: the framework calls
`faults.check(site, step=...)` at its natural failure points (step
boundaries in the training loops, checkpoint save/restore), and the
`PADDLE_TPU_FAULT_SPEC` env var decides whether anything happens. Unset
(production), a check is one dict lookup.

Spec grammar (comma-separated clauses, each colon-separated):

    PADDLE_TPU_FAULT_SPEC="step=50:crash"
    PADDLE_TPU_FAULT_SPEC="save:io_error:p=0.3:seed=7"
    PADDLE_TPU_FAULT_SPEC="step=10:preempt,restore:io_error:times=2"
    PADDLE_TPU_FAULT_SPEC="ps_rpc:io_error:p=0.2:seed=3"
    PADDLE_TPU_FAULT_SPEC="ps_server=1:crash"

    clause  := site['=' step] ':' action (':' option)*
    site    := 'step' | 'save' | 'restore' | <any site name>
               PS-tier sites (RESILIENCE.md §Parameter-server fault
               tolerance): 'ps_rpc' fires in the trainer-side client
               before each wire attempt — an io_error there rides the
               reconnect/retry/dedupe path exactly like a real broken
               socket; 'ps_server' fires in the server's request
               handler, with the clause's =N matched against the
               server's slot index (PADDLE_TPU_PS_SERVER_INDEX), so
               `ps_server=1:crash` hard-kills exactly server 1 at its
               next request.
    action  := 'crash'     — os._exit(CRASH_EXIT_CODE): simulates a
                             kill -9 / machine preemption with no
                             chance to clean up
               'io_error'  — raise InjectedIOError (an OSError): the
                             retry/backoff path's test hook
               'error'     — raise FaultInjected (a RuntimeError):
                             in-process crash stand-in for tests that
                             must survive the "crash"
               'preempt'   — request a graceful stop via
                             resilience.preemption (SIGTERM stand-in)
    option  := 'p=' float  — fire with this probability per check, drawn
                             from a clause-private random.Random
               'seed=' int — seed for that RNG (default 0) — the draw
                             sequence, hence the fault schedule, is
                             reproducible across runs
               'times=' int— stop firing after this many injections
                             (default: unlimited)

Determinism contract: a given spec + seed produces the same fault
schedule for the same sequence of `check()` calls, which is what lets
the kill-and-resume equivalence test assert exact loss trajectories.
"""

from __future__ import annotations

import os
import random
import threading
from typing import Dict, List, Optional

from ..observability import events as _events
from ..observability import metrics as _m

__all__ = ["FaultInjected", "InjectedIOError", "check", "active",
           "parse_spec", "reset", "CRASH_EXIT_CODE", "SPEC_ENV"]

SPEC_ENV = "PADDLE_TPU_FAULT_SPEC"

# sysexits EX_SOFTWARE: "internal software error" — what an injected
# hard crash exits with, distinct from preemption.PREEMPT_EXIT_CODE so
# the launcher's restart logic can tell them apart.
CRASH_EXIT_CODE = 70

INJECTED = _m.counter(
    "paddle_tpu_faults_injected_total",
    "Faults fired by the injection harness (PADDLE_TPU_FAULT_SPEC)",
    labelnames=("site", "action"))


class FaultInjected(RuntimeError):
    """An injected in-process failure (action 'error')."""


class InjectedIOError(OSError):
    """An injected transient I/O failure (action 'io_error')."""


class _Clause:
    __slots__ = ("site", "step", "action", "p", "seed", "times",
                 "fired", "_rng")

    def __init__(self, site: str, step: Optional[int], action: str,
                 p: Optional[float], seed: int, times: Optional[int]):
        self.site, self.step, self.action = site, step, action
        self.p, self.seed, self.times = p, seed, times
        self.fired = 0
        self._rng = random.Random(seed)

    def should_fire(self, step: Optional[int]) -> bool:
        if self.times is not None and self.fired >= self.times:
            return False
        if self.step is not None and step != self.step:
            return False
        if self.p is not None and self._rng.random() >= self.p:
            return False
        return True


_ACTIONS = ("crash", "io_error", "error", "preempt")


def parse_spec(raw: str) -> List[_Clause]:
    """Parse a spec string; raises ValueError with the offending clause
    so a typo in a launcher env fails loudly at the first check, not by
    silently disabling the chaos test."""
    clauses = []
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        if len(fields) < 2:
            raise ValueError(f"fault clause {part!r}: need site:action")
        site_field, action = fields[0].strip(), fields[1].strip()
        if action not in _ACTIONS:
            raise ValueError(
                f"fault clause {part!r}: unknown action {action!r} "
                f"(choose from {_ACTIONS})")
        step: Optional[int] = None
        site = site_field
        if "=" in site_field:
            site, step_s = site_field.split("=", 1)
            try:
                step = int(step_s)
            except ValueError:
                raise ValueError(
                    f"fault clause {part!r}: bad step {step_s!r}")
        p: Optional[float] = None
        seed, times = 0, None
        for opt in fields[2:]:
            opt = opt.strip()
            if "=" not in opt:
                raise ValueError(f"fault clause {part!r}: bad option "
                                 f"{opt!r} (want key=value)")
            k, v = opt.split("=", 1)
            try:
                if k == "p":
                    p = float(v)
                    if not 0.0 <= p <= 1.0:
                        raise ValueError
                elif k == "seed":
                    seed = int(v)
                elif k == "times":
                    times = int(v)
                    if times < 1:
                        raise ValueError
                else:
                    raise ValueError
            except ValueError:
                raise ValueError(
                    f"fault clause {part!r}: bad option {opt!r}")
        clauses.append(_Clause(site.strip(), step, action, p, seed, times))
    return clauses


# Parsed clauses are cached per raw spec value so clause RNG/fired state
# persists across checks; a changed env (tests monkeypatching) reparses.
_lock = threading.Lock()
_cache_raw: Optional[str] = None
_cache_clauses: List[_Clause] = []


def _clauses_for_env() -> List[_Clause]:
    global _cache_raw, _cache_clauses
    raw = os.environ.get(SPEC_ENV)
    if not raw:
        return []
    with _lock:
        if raw != _cache_raw:
            _cache_clauses = parse_spec(raw)
            _cache_raw = raw
        return _cache_clauses


def active() -> bool:
    """True when a fault spec is set (cheap enough for hot paths)."""
    return bool(os.environ.get(SPEC_ENV))


def reset():
    """Forget clause state (fired counts, RNG position) — test hygiene."""
    global _cache_raw, _cache_clauses
    with _lock:
        _cache_raw, _cache_clauses = None, []


def check(site: str, step: Optional[int] = None):
    """Evaluate the active spec at an injection point. No-op unless
    PADDLE_TPU_FAULT_SPEC names a matching clause that elects to fire."""
    if not os.environ.get(SPEC_ENV):
        return
    for c in _clauses_for_env():
        if c.site != site:
            continue
        with _lock:
            if not c.should_fire(step):
                continue
            c.fired += 1
        _fire(c, site, step)


def _fire(c: _Clause, site: str, step: Optional[int]):
    INJECTED.inc(site=site, action=c.action)
    _events.emit("fault", site=site, action=c.action,
                 **({} if step is None else {"step": int(step)}))
    if c.action == "crash":
        # no cleanup, no atexit, no flushing beyond what emit already
        # wrote — the whole point is to model a hard kill
        os._exit(CRASH_EXIT_CODE)
    if c.action == "io_error":
        raise InjectedIOError(
            f"injected I/O failure at site={site}"
            + (f" step={step}" if step is not None else ""))
    if c.action == "error":
        raise FaultInjected(
            f"injected failure at site={site}"
            + (f" step={step}" if step is not None else ""))
    if c.action == "preempt":
        from . import preemption

        preemption.request_stop(f"fault:{site}")
