"""Scope + Executor: the JAX package's `core/executor.py` on torch.

Reference: `Scope` (paddle/fluid/framework/scope.h:46) is a hierarchical
name->Variable map; `Executor::Run` (framework/executor.cc:178) runs a
block op by op against it. The JAX package compiles the whole block into
one jitted step; the port runs block 0 op by op through
`lowering.lower_block` under `torch.no_grad()`, on the place's device.
Scope reads are the step's inputs and scope writes its outputs, exactly
as there, and the prepared step (the state analysis and the policy) is
cached per (program, version, feed signature, fetches, mode, policy), as
`Executor._lookup_step` keys the JAX package's jit cache
(executor.py:1041-1071).

The scope holds tensors on the executor's device (`Scope.get` returns
numpy). The RNG state is a host int in the scope under `RNG_STATE_VAR`,
seeded from `program.random_seed` or the global seed; each step splits
it into the step's seed and the next state, and each random op seeds a
fresh generator from (step seed, its `__rng_uid__`), so a `_grad` op
replays its forward's draws.

The executor's telemetry is the JAX package's: `executor_step("run")`
and `("chained")` windows (`paddle_tpu_executor_steps_total{mode}`, step
seconds, feed bytes), program-cache hits and misses, the synchronous
fetch's host wait (`record_host_blocked("executor_sync")`), and compile
records, which here mark a prepared step's first preparation (kind
"step"). A chained run prepares nothing of its own (its steps run
eagerly), so the port records no "chained" compile and no chained
cache eviction. No live-MFU sample: an op-by-op step has no cost
analysis.

`run` hands a `CompiledProgram` to its `_run` (`core/compiler.py`, the
data-parallel step under `executor_step("sharded")`), as the JAX
package's does. A plain `run` or `run_chained` runs one rank, so under
a mesh with dp or tp larger than 1 it raises.

`run_stream` consumes an iterator of per-step feeds and runs them in
windows through `run_chained`, one lazy `FetchHandle` a window, at most
`in_flight` unresolved; feeds already on the device (a
`DevicePrefetcher` upstream) are stacked there. After the stream the
scope and the RNG state are those of per-step `run` calls.
`train_from_dataset` and `infer_from_dataset` hand over to `trainer.py`,
as there. `PADDLE_TPU_VALIDATE=1|2` runs the analysis passes
(`analysis.maybe_validate`) before a step, once a signature.

Not ported: the `listen_and_serv` branch (the parameter server, ROADMAP
item 21).
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
import weakref
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..observability import health as _health
from ..observability import memwatch as _memwatch
from ..observability import telemetry as _telemetry
from ..observability import tracing as _tracing
from . import framework, lowering
from . import precision as _precision
from . import async_exec
from .async_exec import FetchHandle, to_numpy
from .framework import Program, Variable
from .places import Place, default_place
from .registry import mix_seed, torch_dtype

RNG_STATE_VAR = "__rng_state__"

# the JAX package unrolls a chained window up to this many steps; the
# port runs every window's steps eagerly, and keeps the name for the
# streaming drivers that pass `unroll=n <= _UNROLL_WINDOW_MAX`
_UNROLL_WINDOW_MAX = 32

# every live executor, for the cache-entries gauge (the JAX package's
# count across executors)
_live_executors: "weakref.WeakSet[Executor]" = weakref.WeakSet()
_live_executors_lock = threading.Lock()

# a number for each live program, never given twice: the program cache's
# identity. An id() is not one, since a freed program's id() goes to a
# later object, which would then meet the freed one's prepared step.
_program_serials: "weakref.WeakKeyDictionary[Program, int]" = (
    weakref.WeakKeyDictionary())
_next_serial = itertools.count()


def _program_serial(program: Program) -> int:
    with _live_executors_lock:
        serial = _program_serials.get(program)
        if serial is None:
            serial = _program_serials[program] = next(_next_serial)
        return serial


def _refuse_mesh():
    """A plain Executor step runs one rank: under a mesh with dp or tp
    larger than 1 it raises rather than pass for a split run."""
    # imported here: parallel's package imports core.compiler, which
    # imports this module
    from ..parallel.mesh import refuse_dp_tp

    refuse_dp_tp("the fluid Executor (one rank; a data-parallel run is "
                 "CompiledProgram.with_data_parallel or parallel.SPMDRunner)",
                 "ROADMAP item 20c-iii")


def _health_scan(site: str, named_values, level: int):
    """Device-side prefilter in front of health.check_numerics: one
    isfinite (and the optional |x| threshold) reduction per float
    tensor; only suspect tensors are copied to the host."""
    suspects = []
    thresh = _health.max_abs()
    for n, v in named_values:
        if not isinstance(v, torch.Tensor) or not v.is_floating_point():
            continue
        bad = not bool(torch.isfinite(v).all())
        if not bad and thresh is not None and v.numel():
            bad = bool(v.abs().max() > thresh)
        if bad:
            suspects.append((n, to_numpy(v)))
    # always called (even with no suspects) so the sweep counter ticks
    _health.check_numerics(site, suspects, level=level)


def _post_step_health(writes, fetch_names, fetches, scope):
    """Post-step epilogue of Executor.run and run_chained: the legacy
    FLAGS_check_nan_inf forces raise semantics, else
    PADDLE_TPU_CHECK_NUMERICS picks the level; scans the written states
    and the fetches."""
    from .flags import get_flag

    level = 2 if get_flag("FLAGS_check_nan_inf") \
        else _health.check_level()
    if level:
        _health_scan("executor_state",
                     ((n, scope.find_var(n)) for n in writes), level)
        _health_scan("executor_fetch", zip(fetch_names, fetches), level)


class Scope:
    """Hierarchical variable store (reference: framework/scope.h:46)."""

    def __init__(self, parent: Optional["Scope"] = None):
        self._vars: Dict[str, Any] = {}
        self.parent = parent
        self.kids: List[Scope] = []

    def var(self, name: str):
        if name not in self._vars:
            self._vars[name] = None
        return self._vars[name]

    def find_var(self, name: str):
        s: Optional[Scope] = self
        while s is not None:
            if name in s._vars:
                return s._vars[name]
            s = s.parent
        return None

    def has_var(self, name: str) -> bool:
        return self.find_var(name) is not None

    def set_var(self, name: str, value):
        self._vars[name] = value

    def erase(self, names: Sequence[str]):
        for n in names:
            self._vars.pop(n, None)

    def new_scope(self) -> "Scope":
        kid = Scope(self)
        self.kids.append(kid)
        return kid

    def drop_kids(self):
        self.kids.clear()

    def local_var_names(self) -> List[str]:
        return list(self._vars)

    def get(self, name: str) -> np.ndarray:
        """The variable as a host numpy array (bfloat16 as float32)."""
        v = self.find_var(name)
        if v is None:
            raise KeyError(f"variable '{name}' not found in scope")
        return to_numpy(v)


_global_scope = Scope()
_scope_stack: List[Scope] = []


def global_scope() -> Scope:
    return _scope_stack[-1] if _scope_stack else _global_scope


@contextlib.contextmanager
def scope_guard(scope: Scope):
    _scope_stack.append(scope)
    try:
        yield
    finally:
        _scope_stack.pop()


def _as_fetch_name(f) -> str:
    if isinstance(f, Variable):
        return f.name
    return str(f)


def _on_device(v, device: torch.device) -> torch.Tensor:
    """`v` (a tensor, or anything numpy takes) as a tensor on `device`."""
    if isinstance(v, torch.Tensor):
        return v if v.device == device else v.to(device)
    return torch.as_tensor(np.asarray(v), device=device)


def _normalize_feed(program: Program, feed: Dict[str, Any],
                    policy: _precision.PrecisionPolicy,
                    device: torch.device) -> Dict[str, torch.Tensor]:
    """Each feed as a tensor on `device`, cast to its var's declared
    dtype, except that under a non-f32 policy floating feeds take the
    policy's compute dtype."""
    norm_feed = {}
    for name, val in feed.items():
        vdesc = None
        for b in program.desc.blocks:
            if name in b.vars:
                vdesc = b.vars[name]
                break
        t = _on_device(val, device)
        if vdesc is not None:
            want = policy.feed_dtype(torch_dtype(vdesc.dtype))
            if t.dtype != want:
                t = t.to(want)
        norm_feed[name] = t
    return norm_feed


def _feed_signature(feed: Dict[str, Any]) -> Tuple:
    """Shape/dtype signature of a feed dict: what decides whether two
    per-step feeds can share a stacked window."""
    return tuple(sorted(
        (k, tuple(getattr(v, "shape", ())),
         str(getattr(v, "dtype", type(v).__name__)))
        for k, v in feed.items()))


def _stack_feed_window(feeds: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Collate same-signature per-step feeds with a leading [n] axis.
    Host feeds take one memcpy (np.stack) and one transfer at dispatch;
    feeds already on the device (prefetched) are stacked there."""
    def _stack(vals):
        if all(isinstance(v, np.ndarray) for v in vals):
            return np.stack(vals)
        dev = next(v.device for v in vals if isinstance(v, torch.Tensor))
        return torch.stack([_on_device(v, dev) for v in vals])

    return {k: _stack([f[k] for f in feeds]) for k in feeds[0]}


def _pre_run_validate(program: Program, feed_names, fetch_names, policy,
                      where: str):
    """Env-gated static analysis in front of every run path
    (PADDLE_TPU_VALIDATE=0|1|2: off, warn, error; `analysis/`). The env
    probe keeps the default path at one dict lookup and the analysis
    package unimported; `maybe_validate` caches its outcome per
    (program version, run signature)."""
    if not os.environ.get("PADDLE_TPU_VALIDATE"):
        return
    from ..analysis import maybe_validate

    maybe_validate(program, feed_names=feed_names,
                   fetch_names=fetch_names, policy=policy, where=where)


def _finish_fetches(fetches, return_numpy: bool, sync: bool):
    """sync=False wraps the fetches in a lazy FetchHandle (nothing waits
    for the device until .result()); return_numpy=False returns the
    tensors untouched; else numpy copies."""
    if not sync:
        return FetchHandle(fetches, numpy=True)
    if not return_numpy:
        return list(fetches)
    t0 = time.perf_counter()
    # an asynchronous device OOM surfaces at this read
    with _memwatch.oom_guard("executor"):
        out = [to_numpy(f) for f in fetches]
    _telemetry.record_host_blocked("executor_sync",
                                   time.perf_counter() - t0, stall=False)
    return out


def _split_rng(state: int) -> Tuple[int, int]:
    """(this step's seed, the next state): the port's
    `jax.random.split` of the scope's RNG state."""
    return mix_seed(state, 0), mix_seed(state, 1)


class _Step:
    """One prepared program specialization under ONE precision policy:
    the state it reads (const or updated) and writes, and its fetches.
    A pure-bf16 policy casts floating state to the compute dtype at step
    entry; a mixed policy activates the op autocast instead and leaves
    master state f32."""

    def __init__(self, program: Program, feed_names: Tuple[str, ...],
                 fetch_names: Tuple[str, ...], is_test: bool,
                 policy: _precision.PrecisionPolicy):
        desc = program.desc
        self.policy = policy
        self.desc = desc
        self.is_test = is_test
        reads, writes = lowering.analyze_state_vars(desc, set(feed_names))
        persistable = {
            v.name
            for b in desc.blocks
            for v in b.vars.values()
            if v.persistable
        }
        for n in fetch_names:
            if n in persistable and n not in reads and n not in writes:
                reads.append(n)
        self.const_reads = tuple(n for n in reads if n not in writes)
        self.mut_reads = tuple(n for n in reads if n in writes)
        self.writes = tuple(writes)
        self.fetch_names = fetch_names
        self.feed_names = feed_names

    def _gather_states(self, scope: Scope, device: torch.device):
        states = {}
        for names, what in ((self.const_reads, "is read by the program"),
                            (self.mut_reads, "is updated in place")):
            for n in names:
                v = scope.find_var(n)
                if v is None:
                    raise RuntimeError(
                        f"variable '{n}' {what} but missing from the "
                        f"scope — run the startup program first")
                states[n] = _on_device(v, device)
        return states

    def _step(self, states, feeds, step_seed: int, device: torch.device):
        env = dict(states)
        env.update(feeds)
        policy = self.policy
        if policy.cast_state:
            env = {k: _precision.cast_floating(v, policy.compute_dtype)
                   for k, v in env.items()}
        with torch.no_grad(), _precision.autocast(policy):
            lowering.lower_block(self.desc, 0, env, rng_key=step_seed,
                                 is_test=self.is_test, device=device)
        fetches = []
        for n in self.fetch_names:
            if n not in env:
                raise lowering.LoweringError(
                    f"fetch var '{n}' was not produced by the program")
            fetches.append(env[n])
        return fetches, {n: env[n] for n in self.writes if n in env}

    def __call__(self, scope: Scope, feed: Dict[str, Any], rng: int,
                 device: torch.device):
        step_seed, new_rng = _split_rng(rng)
        fetches, new_states = self._step(self._gather_states(scope, device),
                                         feed, step_seed, device)
        for n, v in new_states.items():
            scope.set_var(n, v)
        return fetches, new_rng

    def run_chained(self, scope: Scope, feed: Dict[str, Any], rng: int,
                    n_steps: int, per_step_feeds: bool,
                    device: torch.device):
        """n_steps steps back to back with no host sync: each step's
        written state feeds the next, fetches come back stacked along a
        leading [n_steps] axis, and the scope ends as after n_steps
        sequential calls."""
        states = self._gather_states(scope, device)
        per_step: List[List[torch.Tensor]] = []
        for i in range(n_steps):
            feeds = {k: v[i] for k, v in feed.items()} if per_step_feeds \
                else feed
            step_seed, rng = _split_rng(rng)
            fetches, new_states = self._step(states, feeds, step_seed,
                                             device)
            states.update(new_states)
            per_step.append(fetches)
        for n in self.writes:
            if n in states:
                scope.set_var(n, states[n])
        stacked = [torch.stack([f[j] for f in per_step])
                   for j in range(len(self.fetch_names))]
        return stacked, rng


class Executor:
    """reference: python/paddle/fluid/executor.py:418. Runs on
    `place` (default `CUDAPlace(0)`, which raises without a GPU; pass
    `CPUPlace()` for the CPU)."""

    def __init__(self, place: Optional[Place] = None):
        self.place = place if place is not None else default_place()
        self.device = self.place.torch_device()
        self._cache: Dict[Any, _Step] = {}
        self._cache_hits = 0
        self._cache_misses = 0
        with _live_executors_lock:
            _live_executors.add(self)

    def close(self):
        self._cache.clear()

    def cache_stats(self) -> Dict[str, int]:
        """Program-cache behavior, observable for benchmarks and tests:
        after the first run of a (program, feed-signature) pair every
        later run is a hit."""
        return {"hits": self._cache_hits, "misses": self._cache_misses,
                "entries": len(self._cache)}

    def run(
        self,
        program: Optional[Program] = None,
        feed: Optional[Dict[str, Any]] = None,
        fetch_list: Optional[Sequence] = None,
        feed_var_name: str = "feed",
        fetch_var_name: str = "fetch",
        scope: Optional[Scope] = None,
        return_numpy: bool = True,
        use_program_cache: bool = True,
        sync: bool = True,
    ):
        """One program step. sync=False returns a FetchHandle: the
        tensors stay on the device and the host moves on; .result()
        resolves to numpy on demand. With sync=True, return_numpy=False
        returns the tensors untouched. A `CompiledProgram` runs its
        data-parallel step. Otherwise, under a mesh with dp or tp larger
        than 1, it raises (`_refuse_mesh`)."""
        # CompiledProgram carries its own data-parallel run (core/compiler.py)
        from .compiler import CompiledProgram

        if isinstance(program, CompiledProgram):
            return program._run(self, feed, fetch_list, scope,
                                return_numpy, sync=sync)
        _refuse_mesh()
        program = program if program is not None else framework.default_main_program()
        scope = scope if scope is not None else global_scope()
        feed = dict(feed or {})
        fetch_names = tuple(_as_fetch_name(f) for f in (fetch_list or []))
        with _telemetry.executor_step("run") as rec:
            step, norm_feed = self._lookup_step(program, feed, fetch_names,
                                                use_program_cache)
            rec.set_feed(norm_feed)
            rng = self._get_rng(scope, program)
            with _tracing.step_span("executor.run", cat="step",
                                    fetches=len(fetch_names)):
                fetches, new_rng = step(scope, norm_feed, rng, self.device)
            scope.set_var(RNG_STATE_VAR, new_rng)
            # reference: FLAGS_check_nan_inf (flags.cc:44); the legacy
            # flag forces raise-level checking of every written state
            # and fetch
            _post_step_health(step.writes, fetch_names, fetches, scope)
            return _finish_fetches(fetches, return_numpy, sync)

    def _lookup_step(self, program: Program, feed: Dict[str, Any],
                     fetch_names: Tuple[str, ...], use_program_cache: bool):
        """Normalize feeds and resolve the prepared step from the program
        cache, keyed by (program identity+version, feed shapes/dtypes,
        fetches, mode, precision policy): the JAX package's key
        (executor.py:1041-1071), with the program's serial number for
        its identity where that key takes its id()."""
        policy = _precision.resolve(program)
        norm_feed = _normalize_feed(program, feed, policy, self.device)
        _pre_run_validate(program, tuple(norm_feed), fetch_names, policy,
                          where="executor")
        feed_sig = tuple(sorted((k, tuple(v.shape), str(v.dtype))
                                for k, v in norm_feed.items()))
        key = (_program_serial(program), program._version, feed_sig,
               fetch_names, program._is_test, policy.name)
        step = self._cache.get(key) if use_program_cache else None
        hit = step is not None
        if step is None:
            self._cache_misses += 1
            t0 = time.perf_counter()
            step = _Step(program, tuple(norm_feed), fetch_names,
                         program._is_test, policy)
            # the first preparation of a signature: the port's compile
            _telemetry.record_compile(
                "step", time.perf_counter() - t0,
                meta={"fetches": len(fetch_names),
                      "writes": len(step.writes)})
            if use_program_cache:
                self._cache[key] = step
        else:
            self._cache_hits += 1
        with _live_executors_lock:
            entries = sum(len(e._cache) for e in _live_executors)
        _telemetry.record_cache_event(hit=hit, entries=entries)
        return step, norm_feed

    def run_chained(self, program=None, feed=None, fetch_list=None,
                    n_steps=1, scope=None, return_numpy=True,
                    per_step_feeds=False, sync=True, unroll="auto"):
        """Run `program` n_steps times back to back on the device, with
        no host sync between steps. With per_step_feeds, every feed value
        carries a leading [n_steps] axis and step i trains on slice i;
        otherwise the same feeds repeat. Scope state afterwards matches
        n_steps sequential `run` calls; each fetch comes back stacked
        with a leading [n_steps] axis.

        `unroll` keeps the JAX package's signature (where it unrolls the
        jitted scan) and has no effect here: the steps run eagerly."""
        del unroll
        _refuse_mesh()
        if int(n_steps) < 1:
            raise ValueError(f"run_chained needs n_steps >= 1, got "
                             f"{n_steps}")
        program = program if program is not None \
            else framework.default_main_program()
        scope = scope if scope is not None else global_scope()
        fetch_names = tuple(_as_fetch_name(f) for f in (fetch_list or []))
        feed = dict(feed or {})
        if per_step_feeds:
            for name, val in feed.items():
                shape = getattr(val, "shape", None)
                if shape is None:
                    shape = np.asarray(val).shape  # lists etc.
                if tuple(shape[:1]) != (int(n_steps),):
                    raise ValueError(
                        f"per_step_feeds: feed '{name}' needs a leading "
                        f"[{n_steps}] axis, got shape {tuple(shape)}")
        with _telemetry.executor_step("chained") as rec:
            step, norm_feed = self._lookup_step(program, feed, fetch_names,
                                                True)
            rec.set_feed(norm_feed)
            rng = self._get_rng(scope, program)
            with _tracing.step_span("executor.run_chained", cat="step",
                                    n_steps=int(n_steps)):
                fetches, new_rng = step.run_chained(
                    scope, norm_feed, rng, int(n_steps),
                    bool(per_step_feeds), self.device)
            scope.set_var(RNG_STATE_VAR, new_rng)
            _post_step_health(step.writes, fetch_names, fetches, scope)
            return _finish_fetches(fetches, return_numpy, sync)

    def run_stream(self, program=None, feed_iter: Optional[Iterable] = None,
                   fetch_list=None, window: int = 8, scope=None,
                   in_flight: int = async_exec.DEFAULT_IN_FLIGHT):
        """Streaming driver: consume an ITERATOR of per-step feed dicts
        and yield one lazy FetchHandle per window of up to `window`
        steps run back to back by `run_chained`, without stacking every
        feed up front.

        Feeds are buffered until the window fills (or the feed signature
        changes, e.g. a short final batch, or the iterator ends),
        collated with a leading [n] axis, and dispatched as ONE
        `run_chained(..., per_step_feeds=True, sync=False)`. Each
        yielded handle carries `.start_step` / `.n_steps`; its
        `.result()` is the stacked fetch list. A bounded InFlightWindow
        (`in_flight`, default 2) resolves the oldest handle before the
        next window is dispatched, so no more than `in_flight` windows
        of fetch buffers are ever on the device; the rest are drained
        when the generator closes. Feeds may already be device tensors
        (a DevicePrefetcher upstream): collation then stays on the
        device.

        Scope and RNG state after exhaustion match per-step `run`
        calls."""
        if feed_iter is None:
            raise ValueError("run_stream needs a feed iterator")
        program = program if program is not None \
            else framework.default_main_program()
        scope = scope if scope is not None else global_scope()
        window = max(1, int(window))
        win = async_exec.InFlightWindow(limit=in_flight, site="stream")

        def gen():
            buf: List[Dict[str, Any]] = []
            sig = None
            step0 = 0

            def flush():
                nonlocal buf, step0
                feeds, buf = buf, []
                n = len(feeds)
                stacked = _stack_feed_window(feeds)
                # the explicit reserve must run BEFORE run_chained makes
                # the new handle, or limit+1 windows of buffers coexist
                # for a moment (admit's own reserve would come too late)
                win.reserve()
                h = self.run_chained(program, feed=stacked,
                                     fetch_list=fetch_list, n_steps=n,
                                     per_step_feeds=True, scope=scope,
                                     sync=False,
                                     unroll=n <= _UNROLL_WINDOW_MAX)
                h.start_step, h.n_steps = step0, n
                step0 += n
                return win.admit(h)

            try:
                for feed in feed_iter:
                    feed = dict(feed)
                    s = _feed_signature(feed)
                    if buf and s != sig:
                        yield flush()
                    sig = s
                    buf.append(feed)
                    if len(buf) >= window:
                        yield flush()
                if buf:
                    yield flush()
            finally:
                # resolve the stragglers, so their device buffers free
                # even when the consumer abandons the stream midway
                win.drain()

        return gen()

    # dataset entry points (reference: executor.py train_from_dataset),
    # provided by trainer.py as in the JAX package

    def train_from_dataset(self, program=None, dataset=None, scope=None,
                           thread=0, debug=False, fetch_list=None,
                           fetch_info=None, print_period=100):
        from ..trainer import train_from_dataset

        return train_from_dataset(self, program, dataset, scope, thread,
                                  debug, fetch_list, fetch_info,
                                  print_period)

    def infer_from_dataset(self, program=None, dataset=None, scope=None,
                           thread=0, debug=False, fetch_list=None,
                           fetch_info=None, print_period=100):
        from ..trainer import infer_from_dataset

        return infer_from_dataset(self, program, dataset, scope, thread,
                                  debug, fetch_list, fetch_info,
                                  print_period)

    def _get_rng(self, scope: Scope, program: Program) -> int:
        rng = scope.find_var(RNG_STATE_VAR)
        if rng is None:
            rng = program.random_seed or framework.global_seed()
            scope.set_var(RNG_STATE_VAR, rng)
        return int(rng)
