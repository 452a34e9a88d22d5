"""Recovery policies: what to DO when the health monitor finds trouble.

Counterpart of the JAX package's `resilience/policy.py`, with its
semantics; what differs is the optimizer: `scale_learning_rate` scales
the `lr` of every param group of a `torch.optim.Optimizer` (the JAX
package walks optax's `inject_hyperparams` state).

The health layer (observability/health.py) detects NaN/Inf/
overrange values and either warns (level 1) or raises NumericsError
(level 2) — detection without response. This module adds the response,
configurable per run:

  skip_batch  — count it, move on to the next batch. For transient
                data-driven spikes (an overrange loss on one bad batch).
                NOTE: with level-2 checks on the *loss*, the optimizer
                update for the offending batch has already been applied
                when the anomaly is seen; skip_batch trusts that the
                damage is bounded. If params may already be NaN, use
                rollback.
  rollback    — restore the last committed checkpoint via a
                CheckpointManager and multiply the learning rate by
                `lr_backoff` (divergence is usually an LR problem;
                replaying the same steps at the same LR usually
                reproduces the same NaN). LR backoff scales every
                param group's `lr`; an optimizer without one still
                rolls back, and the skipped backoff is logged.
  abort       — re-raise: the pre-PR behavior, and the right default
                for debugging.

Budgets (`max_skips`, `max_rollbacks`) stop a policy from looping
forever on a permanently poisoned run — when exhausted, the policy
escalates to abort. A RecoveryController can also `attach()` itself as
a health-anomaly listener: repeated level-1 (warn-only) anomalies then
trip the same policy at the next step boundary, which is how a run with
PADDLE_TPU_CHECK_NUMERICS=1 gets *action* instead of a log full of
warnings.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Optional, Tuple

from ..observability import events as _events
from ..observability import health as _health
from ..observability import metrics as _m

__all__ = ["RecoveryPolicy", "RecoveryController", "RecoveryAbort",
           "scale_learning_rate"]

_log = logging.getLogger("paddle_tpu_torch.resilience")

ACTIONS = _m.counter(
    "paddle_tpu_recovery_actions_total",
    "Recovery-policy actions taken (skip_batch|rollback|abort)",
    labelnames=("action",))


class RecoveryAbort(RuntimeError):
    """A recovery policy decided (or was forced by exhausted budgets)
    to stop the run."""


@dataclasses.dataclass
class RecoveryPolicy:
    """Configuration for RecoveryController (see module docstring)."""

    on_numerics: str = "abort"          # skip_batch | rollback | abort
    max_skips: int = 3
    max_rollbacks: int = 2
    lr_backoff: float = 0.5
    # level-1 anomalies tolerated before the policy trips anyway
    # (None = never trip on warn-only anomalies)
    anomaly_budget: Optional[int] = None

    def __post_init__(self):
        if self.on_numerics not in ("skip_batch", "rollback", "abort"):
            raise ValueError(
                f"on_numerics={self.on_numerics!r}; choose "
                f"skip_batch | rollback | abort")
        if not 0.0 < self.lr_backoff <= 1.0:
            raise ValueError("lr_backoff must be in (0, 1]")


def scale_learning_rate(opt, factor: float) -> Tuple[Any, bool]:
    """Multiply the `lr` of every param group of `opt` (a
    `torch.optim.Optimizer`, or anything with `param_groups`) by
    `factor`, in place. Returns (opt, found); found is False when no
    group has an `lr`."""
    found = False
    for group in getattr(opt, "param_groups", ()):
        if "lr" in group:
            group["lr"] = group["lr"] * factor
            found = True
    return opt, found


class RecoveryController:
    """Applies a RecoveryPolicy at step boundaries. The training loop
    calls `handle()` when a NumericsError surfaces (or when
    `should_act()` reports the anomaly budget blown); `handle` returns
    ("skip_batch", state) / ("rollback", restored_state) or raises
    RecoveryAbort."""

    def __init__(self, policy: RecoveryPolicy, manager=None):
        self.policy = policy
        self.manager = manager
        self.skips = 0
        self.rollbacks = 0
        self._anomalies_seen = 0
        self._tripped = False
        self._listener = None
        if policy.on_numerics == "rollback" and manager is None:
            raise ValueError(
                "on_numerics='rollback' needs a CheckpointManager to "
                "roll back to")

    # -- health-monitor wiring ---------------------------------------------

    def attach(self):
        """Subscribe to health anomalies so warn-only (level 1)
        anomalies count against `anomaly_budget`."""
        if self._listener is None:
            self._listener = self._on_anomaly
            _health.add_anomaly_listener(self._listener)
        return self

    def detach(self):
        if self._listener is not None:
            _health.remove_anomaly_listener(self._listener)
            self._listener = None

    def _on_anomaly(self, event):
        self._anomalies_seen += 1
        budget = self.policy.anomaly_budget
        if budget is not None and self._anomalies_seen > budget:
            self._tripped = True

    def should_act(self) -> bool:
        """True when repeated warn-level anomalies blew the budget and
        the policy should run even though nothing raised."""
        return self._tripped

    # -- the decision -------------------------------------------------------

    def handle(self, exc: Optional[BaseException], state,
               step: Optional[int] = None) -> Tuple[str, Any]:
        """Decide and perform the configured action. `state` is the
        current (post-step) TrainState — on rollback it doubles as the
        restore template, carrying the structure and shardings.
        `exc=None` marks a proactive trigger (blown warn-anomaly
        budget) — there a skip_batch policy degrades to ("continue",
        state) rather than claiming to skip a batch that doesn't
        exist; rollback and abort act the same either way."""
        # acting consumes the tripped-window state: anomalies before
        # this action shouldn't also trip the next boundary
        self._tripped = False
        self._anomalies_seen = 0
        action = self.policy.on_numerics
        if action == "skip_batch":
            if exc is None:
                # proactive trigger (blown warn-anomaly budget): no
                # specific bad batch exists to skip, and pretending to
                # skip one would burn the budget on a no-op — record
                # the acknowledgment and let training proceed
                ACTIONS.inc(action="continue")
                _events.emit("recovery", action="continue",
                             reason="anomaly_budget", **_step_field(step))
                _log.warning(
                    "recovery: warn-anomaly budget exceeded; policy is "
                    "skip_batch, which only applies to a failing step — "
                    "continuing (use rollback to act on warn anomalies)")
                return "continue", state
            if self.skips >= self.policy.max_skips:
                self._abort(exc, step,
                            f"skip budget exhausted "
                            f"({self.policy.max_skips})")
            self.skips += 1
            ACTIONS.inc(action="skip_batch")
            _events.emit("recovery", action="skip_batch",
                         skips=self.skips, **_step_field(step))
            _log.warning("recovery: skipping batch after anomaly "
                         "(%d/%d skips used)", self.skips,
                         self.policy.max_skips)
            return "skip_batch", state
        if action == "rollback":
            if self.rollbacks >= self.policy.max_rollbacks:
                self._abort(exc, step,
                            f"rollback budget exhausted "
                            f"({self.policy.max_rollbacks})")
            restored = self.manager.restore_latest(state)
            if restored is None:
                self._abort(exc, step,
                            "rollback requested but no committed "
                            "checkpoint exists")
            self.rollbacks += 1
            new_opt, found = scale_learning_rate(
                restored.opt_state, self.policy.lr_backoff)
            if found:
                restored.opt_state = new_opt
            else:
                _log.warning(
                    "recovery: rollback done but the optimizer has no "
                    "param group with an lr — LR backoff skipped")
            ACTIONS.inc(action="rollback")
            _events.emit(
                "recovery", action="rollback", rollbacks=self.rollbacks,
                restored_step=int(restored.step),
                lr_backoff=self.policy.lr_backoff if found else None,
                **_step_field(step))
            _log.warning(
                "recovery: rolled back to step %d%s (%d/%d rollbacks "
                "used)", int(restored.step),
                f", lr x{self.policy.lr_backoff}" if found else "",
                self.rollbacks, self.policy.max_rollbacks)
            return "rollback", restored
        self._abort(exc, step, "policy is abort")
        raise AssertionError("unreachable")

    def _abort(self, exc, step, why: str):
        ACTIONS.inc(action="abort")
        _events.emit("recovery", action="abort", reason=why,
                     **_step_field(step))
        if exc is not None:
            raise exc
        raise RecoveryAbort(f"recovery policy aborted the run: {why}")


def _step_field(step):
    return {} if step is None else {"step": int(step)}
