# Copied from the JAX package: paddle_tpu/trainer.py, with the changes
# tests/test_torch_imports.py declares (FRONT_END_CHANGES); keep it in
# step with that file.
"""Trainer stack entry points (reference: Executor.train_from_dataset →
TrainerFactory → C++ MultiTrainer/DistMultiTrainer + DeviceWorkers,
framework/trainer.h:38, device_worker.h:103, SURVEY §3.6).

A host-side trainer loop over a dataset's batches feeding the executor's
step (HogwildWorker semantics, hogwild_worker.cc:163); any object with
`_iter_batches()`, or an iterable such as a `DataLoader`, is a source.

Since the host-overlap PR the default driver is STREAMING: batches are
micro-chained into windows of PADDLE_TPU_STREAM_WINDOW steps (default 8,
1 restores the per-step loop), dispatched as one run_chained call each
(core/executor.run_stream), with losses fetched lazily — the host only
blocks on the device when a window's values are actually needed (debug
prints, health checks) or when the bounded in-flight window applies
backpressure. Preemption is honored at window boundaries; an active
PADDLE_TPU_FAULT_SPEC drops the window to 1 so per-step fault schedules
keep their exact step semantics (see RESILIENCE.md §Streaming windows).
"""

from __future__ import annotations

import contextlib
import time
from collections import deque
from typing import Optional, Sequence

from .core import async_exec as _async
from .observability import events as _events
from .observability import health as _health
from .observability import telemetry as _telemetry
from .resilience import faults as _faults
from .resilience import preemption as _preempt


def _fetch_names(fetch_list, fetch_info=None):
    return list(fetch_info) if fetch_info else [
        getattr(f, "name", str(f)) for f in (fetch_list or [])]


def _batch_examples(feed) -> int:
    """Leading dim of the first feed tensor — the examples-per-step count
    every throughput metric is denominated in."""
    try:
        for v in feed.values():
            shape = getattr(v, "shape", None)
            if shape:
                return int(shape[0])
    except (AttributeError, TypeError):
        pass
    return 0


def _stream_window() -> int:
    """Effective streaming window: the env default, forced to 1 while a
    per-step consumer is active. A fault spec (step=N:crash) must see a
    check at every step, not every window boundary; raise-level
    numerics checking (PADDLE_TPU_CHECK_NUMERICS=2 or the legacy
    FLAGS_check_nan_inf) must stop BEFORE the next step dispatches —
    a windowed driver would let window-1 further steps mutate the
    scope on NaN state before the boundary check raised."""
    window = _async.stream_window_default()
    if window <= 1:
        return window
    if _faults.active() or _health.check_level() >= 2:
        return 1
    from .core.flags import get_flag

    if get_flag("FLAGS_check_nan_inf"):
        return 1
    return window


def _preempting_feed_src(batches, ex_pending, on_preempt=None):
    """Feed generator shared by the streaming drivers: checks for a
    graceful-stop request before each batch (so a preemption landing
    mid-window cuts the window short at a step boundary) and records
    per-batch example counts for the telemetry split."""
    for feed in batches:
        if _preempt.stop_requested():
            if on_preempt is not None:
                on_preempt()
            return
        ex_pending.append(_batch_examples(feed))
        yield feed


def _record_window_steps(n, dt, ex_pending) -> int:
    """Per-STEP telemetry for an n-step window that took dt wall
    seconds — counters stay driver-independent. Returns the window's
    example count."""
    total = 0
    for _ in range(n):
        ex = ex_pending.popleft() if ex_pending else 0
        total += ex
        _telemetry.record_trainer_step(dt / n, ex)
    return total


def _check_window_numerics(names, vals, n, step_base):
    """Per-step slices keep the anomaly's step attribution exact even
    though the window resolved as one stacked fetch."""
    for i in range(n):
        _health.check_numerics(
            "trainer_loss",
            [(nm, v[i]) for nm, v in zip(names, vals)],
            step=step_base + i)


def _make_device_current(executor):
    """A new thread's current CUDA device is card 0: make the
    executor's card current before the thread's first CUDA work."""
    device = getattr(executor, "device", None)
    if getattr(device, "type", None) == "cuda":
        import torch

        torch.cuda.set_device(device)


def train_from_dataset(executor, program=None, dataset=None, scope=None,
                       thread=0, debug=False, fetch_list=None,
                       fetch_info=None, print_period=100):
    from .core import framework

    program = program or framework.default_main_program()
    if dataset is None:
        raise ValueError("dataset is required")
    fetch_list = fetch_list or []
    names = _fetch_names(fetch_list, fetch_info)
    batches = dataset._iter_batches() if hasattr(dataset, "_iter_batches") \
        else iter(dataset)
    _preempt.maybe_install_from_env()
    window = _stream_window()
    # duck-typed executors (tests, remote stubs) without the streaming
    # surface get the classic per-step loop, as do CompiledProgram-like
    # inputs (no .desc — they carry their own sharded run path that
    # executor.run delegates to)
    if window > 1 and hasattr(executor, "run_stream") \
            and hasattr(program, "desc"):
        return _train_streaming(executor, program, batches, scope, debug,
                                fetch_list, names, print_period, window)
    step = 0
    examples = 0
    run_t0 = time.perf_counter()
    stop = "completed"
    for feed in batches:
        # step boundary: the only safe stop/injection point (see
        # parallel.train.train_loop for the full fault-tolerant driver)
        _faults.check("step", step=step)
        if _preempt.stop_requested():
            stop = "preempted"
            break
        t0 = time.perf_counter()
        vals = executor.run(program, feed=feed, fetch_list=fetch_list,
                            scope=scope)
        if fetch_list and _health.check_level():
            # the fetched losses are the trainer's divergence canary
            _health.check_numerics("trainer_loss", zip(names, vals),
                                   step=step)
        n = _batch_examples(feed)
        examples += n
        _telemetry.record_trainer_step(time.perf_counter() - t0, n)
        if debug and fetch_list and step % print_period == 0:
            print(f"step {step}: " + ", ".join(
                f"{n}={v}" for n, v in zip(names, vals)))
        step += 1
    seconds = time.perf_counter() - run_t0
    _telemetry.record_trainer_run(seconds, examples)
    _events.emit("step_summary", site="train_from_dataset", steps=step,
                 examples=examples, seconds=round(seconds, 6),
                 examples_per_sec=round(examples / seconds, 3)
                 if seconds > 0 else 0.0, stop=stop)
    return None


def _train_streaming(executor, program, batches, scope, debug, fetch_list,
                     names, print_period, window):
    """Windowed driver behind train_from_dataset: one chained dispatch
    per window, lazy fetches, preemption honored between batches (so a
    request lands at a step boundary mid-window: the current window is
    cut short and flushed). Step/example telemetry stays per-step so
    counters are driver-independent."""
    step = 0
    examples = 0
    run_t0 = time.perf_counter()
    outcome = {"stop": "completed"}
    ex_pending = deque()

    def on_preempt():
        outcome["stop"] = "preempted"

    check_lvl = _health.check_level()
    want_vals = bool(fetch_list) and bool(debug or check_lvl)
    t_last = time.perf_counter()
    for h in executor.run_stream(
            program, _preempting_feed_src(batches, ex_pending, on_preempt),
            fetch_list=fetch_list, window=window, scope=scope):
        n = h.n_steps
        now = time.perf_counter()
        dt = now - t_last
        t_last = now
        examples += _record_window_steps(n, dt, ex_pending)
        if want_vals:
            vals = h.result()  # stacked [n, ...] per fetch name
            if check_lvl:
                _check_window_numerics(names, vals, n, h.start_step)
            if debug:
                for i in range(n):
                    s = h.start_step + i
                    if s % print_period == 0:
                        print(f"step {s}: " + ", ".join(
                            f"{nm}={v[i]}"
                            for nm, v in zip(names, vals)))
        step += n
    seconds = time.perf_counter() - run_t0
    _telemetry.record_trainer_run(seconds, examples)
    _events.emit("step_summary", site="train_from_dataset", steps=step,
                 examples=examples, seconds=round(seconds, 6),
                 examples_per_sec=round(examples / seconds, 3)
                 if seconds > 0 else 0.0, stop=outcome["stop"],
                 window=window)
    return None


def infer_from_dataset(executor, program=None, dataset=None, scope=None,
                       thread=0, debug=False, fetch_list=None,
                       fetch_info=None, print_period=100):
    infer_prog = (program or __import__("paddle_tpu_torch.core.framework",
                                        fromlist=["default_main_program"]
                                        ).default_main_program()).clone(for_test=True)
    return train_from_dataset(executor, infer_prog, dataset, scope, thread,
                              debug, fetch_list, fetch_info, print_period)


class TrainerDesc:
    """Trainer configuration (reference: trainer_desc.proto:21 — class
    names MultiTrainer/DistMultiTrainer + device worker choice and
    thread_num; here the executor's step is the device worker, so the desc keeps
    the scheduling knobs only)."""

    def __init__(self, thread_num: int = 1, trainer_class: str = "MultiTrainer",
                 fetch_list=None, fetch_info=None, print_period: int = 100):
        self.thread_num = max(1, int(thread_num))
        self.trainer_class = trainer_class
        self.fetch_list = fetch_list or []
        self.fetch_info = fetch_info
        self.print_period = print_period


class HogwildWorker:
    """One training thread: pull batches from its dataset shard, run the
    executor's step against the SHARED scope (reference:
    hogwild_worker.cc:163 TrainFiles). Dispatch is serialized by a shared
    lock — a step reads the scope's params and writes their updates
    back; with the streaming driver the lock covers the window
    dispatch while execution itself overlaps via CUDA's asynchronous
    launches, and threads additionally overlap on their readers and
    host-side batch prep. Each thread makes the executor's card
    current before its first step."""

    def __init__(self, worker_id, executor, program, dataset, scope,
                 desc: TrainerDesc, step_lock=None):
        self.worker_id = worker_id
        self.executor = executor
        self.program = program
        self.dataset = dataset
        self.scope = scope
        self.desc = desc
        self.step_lock = step_lock
        self.steps = 0
        self.last_fetch = None

    def _batches(self):
        return self.dataset._iter_batches() if hasattr(
            self.dataset, "_iter_batches") else iter(self.dataset)

    def train(self):
        _make_device_current(self.executor)
        window = _stream_window()
        if window > 1 and hasattr(self.executor, "run_stream") \
                and hasattr(self.program, "desc"):
            return self._train_streaming(window)
        names = _fetch_names(self.desc.fetch_list, self.desc.fetch_info)
        run_t0 = time.perf_counter()
        examples = 0
        for feed in self._batches():
            _faults.check("step", step=self.steps)
            if _preempt.stop_requested():
                break  # graceful stop at the step boundary
            t0 = time.perf_counter()
            with self.step_lock if self.step_lock is not None else \
                    contextlib.nullcontext():
                vals = self.executor.run(self.program, feed=feed,
                                         fetch_list=self.desc.fetch_list,
                                         scope=self.scope)
            if self.desc.fetch_list and _health.check_level():
                _health.check_numerics("trainer_loss", zip(names, vals),
                                       step=self.steps)
            n = _batch_examples(feed)
            examples += n
            _telemetry.record_trainer_step(time.perf_counter() - t0, n)
            self.steps += 1
            if self.desc.fetch_list:
                self.last_fetch = vals
                if self.steps % self.desc.print_period == 0:
                    print(f"worker {self.worker_id} step {self.steps}: " +
                          ", ".join(f"{n}={v}" for n, v in
                                    zip(names, vals)))
        seconds = time.perf_counter() - run_t0
        _telemetry.record_trainer_run(seconds, examples)
        _events.emit("step_summary", site="hogwild_worker",
                     worker=self.worker_id, steps=self.steps,
                     examples=examples, seconds=round(seconds, 6))

    def _train_streaming(self, window):
        from .core.executor import (_UNROLL_WINDOW_MAX, _feed_signature,
                                    _stack_feed_window)

        names = _fetch_names(self.desc.fetch_list, self.desc.fetch_info)
        fetch_list = self.desc.fetch_list
        check_lvl = _health.check_level()
        run_t0 = time.perf_counter()
        state = {"examples": 0, "t_last": run_t0, "last": None}
        ex_pending = deque()
        lock = self.step_lock if self.step_lock is not None \
            else contextlib.nullcontext()
        win = _async.InFlightWindow(limit=_async.DEFAULT_IN_FLIGHT,
                                    site="hogwild")

        def consume(h, n):
            now = time.perf_counter()
            dt = now - state["t_last"]
            state["t_last"] = now
            state["examples"] += _record_window_steps(n, dt, ex_pending)
            want_print = fetch_list and any(
                (self.steps + i + 1) % self.desc.print_period == 0
                for i in range(n))
            if fetch_list and (check_lvl or want_print):
                vals = h.result()
                if check_lvl:
                    _check_window_numerics(names, vals, n, self.steps)
                if want_print:
                    for i in range(n):
                        s = self.steps + i + 1
                        if s % self.desc.print_period == 0:
                            print(f"worker {self.worker_id} step {s}: " +
                                  ", ".join(f"{nm}={v[i]}" for nm, v in
                                            zip(names, vals)))
            self.steps += n
            state["last"] = h

        def dispatch(feeds):
            # collate and backpressure-resolve OUTSIDE the shared lock
            # (another worker's dispatch must not wait on our input or
            # on the device draining our previous window); only the
            # dispatch itself — donated-buffer territory — serializes.
            n = len(feeds)
            stacked = _stack_feed_window(feeds)
            win.reserve()
            with lock:
                h = self.executor.run_chained(
                    self.program, feed=stacked, fetch_list=fetch_list,
                    n_steps=n, per_step_feeds=True, scope=self.scope,
                    sync=False, unroll=n <= _UNROLL_WINDOW_MAX)
            win.admit(h)
            consume(h, n)

        buf, sig = [], None
        try:
            # batch pull happens on THIS thread, outside the lock, so a
            # slow dataset shard starves only its own worker
            for feed in _preempting_feed_src(self._batches(), ex_pending):
                feed = dict(feed)
                s = _feed_signature(feed)
                if buf and s != sig:
                    dispatch(buf)
                    buf = []
                sig = s
                buf.append(feed)
                if len(buf) >= window:
                    dispatch(buf)
                    buf = []
            if buf:
                dispatch(buf)
        finally:
            win.drain()
            if fetch_list and state["last"] is not None:
                # decimated fetch: only the last COMPLETED window's
                # final step materializes for last_fetch (per-step
                # values stay lazy) — in the finally so a mid-run
                # error still leaves the last good fetch readable
                self.last_fetch = [v[-1] for v in state["last"].result()]
        seconds = time.perf_counter() - run_t0
        _telemetry.record_trainer_run(seconds, state["examples"])
        _events.emit("step_summary", site="hogwild_worker",
                     worker=self.worker_id, steps=self.steps,
                     examples=state["examples"],
                     seconds=round(seconds, 6), window=window)


class MultiTrainer:
    """Thread-pool trainer (reference: trainer.h:64 MultiTrainer — one
    DeviceWorker thread per shard, shared root scope, exceptions funneled
    like details/exception_holder.h)."""

    def __init__(self, desc: TrainerDesc):
        self.desc = desc
        self.workers = []

    def train(self, executor, program, datasets, scope=None):
        """datasets: one per thread (shard with NativeDataset
        trainer_id/num_trainers or per-thread filelists)."""
        import threading

        from .core import executor as executor_mod

        scope = scope or executor_mod.global_scope()
        if len(datasets) != self.desc.thread_num:
            raise ValueError(
                f"need {self.desc.thread_num} dataset shards, got "
                f"{len(datasets)}")
        step_lock = threading.Lock()
        self.workers = [
            HogwildWorker(i, executor, program, ds, scope, self.desc,
                          step_lock=step_lock)
            for i, ds in enumerate(datasets)]
        errors = []

        def run(w):
            try:
                w.train()
            except BaseException as e:  # exception_holder semantics
                errors.append(e)

        threads = [threading.Thread(target=run, args=(w,), daemon=True)
                   for w in self.workers]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return sum(w.steps for w in self.workers)


def train_from_dataset_multithread(executor, program, dataset_factory,
                                   thread_num: int = 2, fetch_list=None,
                                   fetch_info=None, print_period=100,
                                   scope=None):
    """Thread-pool train_from_dataset (reference: Executor.
    train_from_dataset with TrainerDesc.thread_num > 1 → MultiTrainer).

    `dataset_factory(worker_id, num_workers)` builds each thread's shard
    — give each worker its own shard of the data (the JAX package's
    NativeDataset takes trainer_id=worker_id, num_trainers=num_workers).
    """
    desc = TrainerDesc(thread_num=thread_num, fetch_list=fetch_list,
                       fetch_info=fetch_info, print_period=print_period)
    datasets = [dataset_factory(i, desc.thread_num)
                for i in range(desc.thread_num)]
    return MultiTrainer(desc).train(executor, program, datasets,
                                    scope=scope)
