# Copied from the JAX package: paddle_tpu/resilience/checkpoint_manager.py
# (stdlib only). Keep it in step with that file.
"""Checkpoint lifecycle management: commit markers, retention, fallback.

The bare orbax save/restore pair (parallel/checkpoint.py) leaves three
operational gaps this class closes, mirroring what the reference's
long-running parameter-server deployments needed from
save/load_persistables (reference io.py:320,501,769):

  1. **Atomic commit.** A process killed mid-save leaves a partial
     `step_N` directory that `latest_step_dir` would happily return.
     Here a save is only *committed* once `_COMMITTED.json` (written
     atomically, AFTER the payload write returns) exists; readers treat
     everything else as garbage.
  2. **Retention.** `keep_last_n` newest committed checkpoints plus
     every `keep_every_k_steps`-divisible step survive; pruning runs
     strictly AFTER the new checkpoint commits, so the invariant "at
     least one complete checkpoint exists" holds at every instant. The
     marker is deleted first when pruning, so a crash mid-delete
     degrades a checkpoint to uncommitted garbage, never to a committed
     lie.
  3. **Fallback restore.** `restore_latest()` walks committed steps
     newest-first, skips uncommitted directories, and on a corrupt
     checkpoint (truncated by a torn disk, bad block, ...) falls back
     to the next older committed one — emitting a `restore` event per
     skip so the operator can see how much progress was lost.

Transient I/O errors in both directions ride `retry.retry_io`'s capped
exponential backoff; the fault-injection sites `save` / `restore`
(faults.py) fire inside the retried region, which is how the tests
prove all of the above without a real flaky disk.

The payload format is pluggable (`save_fn(path, state)` /
`restore_fn(path, template)`), defaulting to the sharding-aware orbax
writers in parallel/checkpoint.py — so the manager also serves
Program-path states or plain pytrees, and unit tests can use a
numpy-dict payload without touching orbax.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any, Callable, List, Optional

from ..observability import events as _events
from ..observability import metrics as _m
from . import faults as _faults
from .atomic import json_dump as _atomic_json_dump
from .retry import retry_io

__all__ = ["CheckpointManager", "CheckpointError", "COMMIT_MARKER"]

COMMIT_MARKER = "_COMMITTED.json"

SAVES = _m.counter(
    "paddle_tpu_checkpoint_saves_total",
    "Committed checkpoint saves via CheckpointManager")
SAVE_SECONDS = _m.histogram(
    "paddle_tpu_checkpoint_save_seconds",
    "Wall seconds per committed checkpoint save (payload + marker, "
    "including retries)")
RESTORES = _m.counter(
    "paddle_tpu_checkpoint_restores_total",
    "restore_latest checkpoint-directory outcomes",
    labelnames=("outcome",))  # ok | corrupt | uncommitted
RESTORE_SECONDS = _m.histogram(
    "paddle_tpu_checkpoint_restore_seconds",
    "Wall seconds per successful checkpoint restore")
PRUNED = _m.counter(
    "paddle_tpu_checkpoint_pruned_total",
    "Checkpoint directories removed by the retention policy")
LAST_COMMITTED = _m.gauge(
    "paddle_tpu_checkpoint_last_committed_step",
    "Step number of the newest committed checkpoint (-1 = none)")


class CheckpointError(RuntimeError):
    """Every committed checkpoint failed to restore — distinct from
    'no checkpoint exists' (restore_latest returns None) because the
    right responses differ: starting fresh over a pile of unreadable
    checkpoints silently discards training progress."""


def _default_save(path: str, state) -> None:
    from ..parallel.checkpoint import save_train_state

    save_train_state(path, state)


def _default_restore(path: str, template, **kwargs):
    from ..parallel.checkpoint import restore_train_state

    return restore_train_state(path, template, **kwargs)


class CheckpointManager:
    """Step-stamped checkpoints under `root` with commit markers,
    retention and corrupt-fallback restore. See module docstring."""

    def __init__(self, root: str, *, keep_last_n: int = 3,
                 keep_every_k_steps: Optional[int] = None,
                 save_fn: Callable[[str, Any], None] = _default_save,
                 restore_fn: Callable[[str, Any], Any] = _default_restore,
                 retry_attempts: int = 3, retry_base_s: float = 0.1,
                 retry_max_s: float = 5.0):
        if keep_last_n < 1:
            raise ValueError("keep_last_n must be >= 1 — a retention "
                             "policy keeping zero checkpoints is a "
                             "deletion policy")
        if keep_every_k_steps is not None and keep_every_k_steps < 1:
            raise ValueError("keep_every_k_steps must be >= 1")
        self.root = os.path.abspath(root)
        self.keep_last_n = keep_last_n
        self.keep_every_k_steps = keep_every_k_steps
        self._save_fn = save_fn
        self._restore_fn = restore_fn
        self._retry = dict(attempts=retry_attempts,
                           base_delay_s=retry_base_s,
                           max_delay_s=retry_max_s)

    # -- layout -------------------------------------------------------------

    def step_dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{int(step)}")

    def _marker(self, d: str) -> str:
        return os.path.join(d, COMMIT_MARKER)

    def is_committed(self, d: str) -> bool:
        """A directory is committed iff its marker parses and agrees
        with the directory name — a marker atomically written but
        somehow misplaced must not bless a foreign payload."""
        try:
            with open(self._marker(d)) as f:
                meta = json.load(f)
        except (OSError, ValueError):
            return False
        return os.path.basename(d) == f"step_{meta.get('step')}"

    def _step_dirs(self) -> List[int]:
        """All step_N directory numbers present (committed or not)."""
        if not os.path.isdir(self.root):
            return []
        out = []
        for name in os.listdir(self.root):
            if not name.startswith("step_"):
                continue
            if not os.path.isdir(os.path.join(self.root, name)):
                continue
            try:
                out.append(int(name.split("_", 1)[1]))
            except ValueError:
                continue
        return sorted(out)

    def committed_steps(self) -> List[int]:
        return [s for s in self._step_dirs()
                if self.is_committed(self.step_dir(s))]

    def latest_committed_dir(self) -> Optional[str]:
        steps = self.committed_steps()
        return self.step_dir(steps[-1]) if steps else None

    # -- save ---------------------------------------------------------------

    def save(self, state, step: Optional[int] = None) -> str:
        """Write `state` as the committed checkpoint for `step` (default:
        int(state.step)), then prune. Returns the checkpoint directory.

        Failure atomicity: the commit marker is written only after
        `save_fn` returns, so any interruption leaves an uncommitted
        directory that the next save attempt clears and restore_latest
        ignores."""
        if step is None:
            step = int(state.step)
        step = int(step)
        d = self.step_dir(step)
        if self.is_committed(d):
            raise FileExistsError(
                f"checkpoint for step {step} already committed at {d} — "
                f"overwriting a committed checkpoint in place would "
                f"destroy the only good copy if this save dies midway")
        t0 = time.perf_counter()

        def attempt():
            _faults.check("save", step=step)
            if os.path.isdir(d):
                # leftover partial from a crashed/failed earlier attempt
                shutil.rmtree(d)
            self._save_fn(d, state)
            _atomic_json_dump({"step": step, "ts": time.time()},
                              self._marker(d))

        retry_io(attempt, site="checkpoint_save", **self._retry)
        seconds = time.perf_counter() - t0
        SAVES.inc()
        SAVE_SECONDS.observe(seconds)
        LAST_COMMITTED.set(step)
        _events.emit("checkpoint", site="manager_save", dir=d, step=step,
                     seconds=round(seconds, 6))
        self.prune()
        return d

    # -- retention ----------------------------------------------------------

    def retained_steps(self) -> List[int]:
        """The committed steps the retention policy keeps right now."""
        steps = self.committed_steps()
        keep = set(steps[-self.keep_last_n:])
        if self.keep_every_k_steps:
            keep.update(s for s in steps
                        if s % self.keep_every_k_steps == 0)
        return sorted(keep)

    def prune(self) -> List[int]:
        """Delete committed checkpoints outside the retention set, and
        uncommitted leftovers older than the newest committed step
        (garbage from crashed saves). Returns the pruned step numbers."""
        steps = self.committed_steps()
        keep = set(self.retained_steps())
        drop = [s for s in steps if s not in keep]
        newest = steps[-1] if steps else None
        if newest is not None:
            drop += [s for s in self._step_dirs()
                     if s < newest and s not in keep
                     and not self.is_committed(self.step_dir(s))]
        pruned = []
        for s in sorted(set(drop)):
            d = self.step_dir(s)
            try:
                # marker first: if the rmtree dies midway the remains
                # are uncommitted garbage, not a half-empty "committed"
                # checkpoint
                try:
                    os.unlink(self._marker(d))
                except FileNotFoundError:
                    pass
                shutil.rmtree(d)
            except OSError:
                continue  # undeletable now; retried at the next prune
            PRUNED.inc()
            pruned.append(s)
        if pruned:
            _events.emit("checkpoint", site="manager_prune",
                         pruned=pruned, kept=sorted(keep))
        return pruned

    # -- restore ------------------------------------------------------------

    def restore_latest(self, template, **restore_kwargs):
        """Restore the newest *complete* checkpoint into `template`'s
        structure/shardings. Extra keyword arguments are forwarded to
        the restore_fn (the orbax default accepts `cast_dtypes=True`
        for explicit cross-precision resharding); note that a template
        built on a DIFFERENT mesh than the checkpoint's is itself the
        elastic cross-world-size reshard path — the restore lands on
        the template's shardings, emits a `restore_resharded` event and
        ticks paddle_tpu_elastic_resharding_seconds, and refuses
        incompatible layouts with parallel.checkpoint.ReshardError.
        Skips uncommitted directories outright;
        a committed-but-unreadable (corrupt) checkpoint is skipped with
        a `restore` event and the next older one is tried. Returns the
        restored state, or None when no committed checkpoint exists.
        Raises CheckpointError when committed checkpoints exist but
        every one of them failed to restore.

        A committed-but-corrupt checkpoint that was skipped gets
        DEMOTED (its commit marker deleted) once an older checkpoint
        restores successfully: leaving the marker would make the
        replayed run's save() at that step collide with the corpse
        (FileExistsError), and would keep advertising the corrupt dir
        as newest-good. Demotion only happens after a successful
        fallback — when nothing restores, the markers stay put for the
        operator to inspect rather than silently degrading the root to
        "no checkpoints, start fresh"."""
        failures = []
        all_steps = self._step_dirs()
        committed = set(self.committed_steps())
        for step in sorted(all_steps, reverse=True):
            d = self.step_dir(step)
            if step not in committed:
                RESTORES.inc(outcome="uncommitted")
                _events.emit("restore", dir=d, step=step, ok=False,
                             reason="uncommitted")
                continue
            t0 = time.perf_counter()

            def attempt():
                _faults.check("restore", step=step)
                return self._restore_fn(d, template, **restore_kwargs)

            try:
                state = retry_io(attempt, site="checkpoint_restore",
                                 **self._retry)
            except Exception as e:  # noqa: BLE001 — any persistent
                # failure means "this checkpoint is unusable"; the whole
                # point of fallback is surviving unforeseen corruption
                from ..parallel.checkpoint import (PrecisionMismatchError,
                                                   ReshardError)

                if isinstance(e, (PrecisionMismatchError, ReshardError)):
                    # template-side contract errors, not data corruption:
                    # every older checkpoint would refuse identically, so
                    # falling back would burn the whole root and then
                    # mislabel the failure as corruption
                    raise
                RESTORES.inc(outcome="corrupt")
                _events.emit("restore", dir=d, step=step, ok=False,
                             reason="corrupt",
                             error=f"{type(e).__name__}: {e}")
                failures.append((d, e))
                continue
            seconds = time.perf_counter() - t0
            RESTORES.inc(outcome="ok")
            RESTORE_SECONDS.observe(seconds)
            _events.emit("restore", dir=d, step=step, ok=True,
                         seconds=round(seconds, 6))
            for bad_dir, _exc in failures:
                try:
                    os.unlink(self._marker(bad_dir))
                except OSError:
                    continue  # undeletable marker: save() will still
                    # collide there, but the restore itself succeeded
                _events.emit("checkpoint", site="manager_demote",
                             dir=bad_dir)
            LAST_COMMITTED.set(step)
            return state
        if failures:
            raise CheckpointError(
                "all committed checkpoints failed to restore: " +
                "; ".join(f"{d}: {type(e).__name__}: {e}"
                          for d, e in failures))
        return None
