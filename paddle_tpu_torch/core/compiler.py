"""CompiledProgram / BuildStrategy / ExecutionStrategy / ParallelExecutor:
the JAX package's `core/compiler.py` on an in-process dp ring.

Reference: python/paddle/fluid/compiler.py:65 (CompiledProgram,
`with_data_parallel` :138) backed by the C++ ParallelExecutor, which
clones the graph per GPU and inserts NCCL all-reduces.

The JAX package runs a data-parallel step as one GSPMD jit of the whole
batch sharded on dim 0 over a device mesh, so its numbers are the
one-device step's on the whole batch. The port runs one rank per place
in lockstep on an `InProcessRing` (`core/lockstep.py`, GSPMD mode):
each rank computes on its dim-0 shard of every feed, with persistable
state replicated, and the three rules there (global batch reductions,
their gradients, the all-reduce of a replicated var's partial
gradient) give the whole batch's numbers, within f32 reduce order.

Ranks: `places` is a list of ranks, and a place repeated is another
in-process rank on that device. With `places=None` they are
`cuda_places()` on a CUDA executor and `cpu_places()` (`CPU_NUM`,
default 1) on a CPU executor, as the Paddle reference takes them.
Places on another device than the executor's raise: one rank per card
is the process ring (ROADMAP item 20a).

`BuildStrategy`'s and `ExecutionStrategy`'s fields are recorded and
read by nothing, as in the JAX package (which never reads
`gradient_scale_strategy` either).
"""

from __future__ import annotations

import enum
import time
from typing import Any, Dict, List, Optional, Sequence

from ..observability import telemetry as _telemetry
from ..observability import tracing as _tracing
from . import framework, lowering
from . import precision as _precision
from .executor import (RNG_STATE_VAR, _as_fetch_name, _finish_fetches,
                       _normalize_feed, _post_step_health, _pre_run_validate,
                       _split_rng, global_scope)
from .framework import Program
from .lockstep import GSPMD, RankStep
from .ring import InProcessRing


class ReduceStrategy(enum.IntEnum):
    """reference: details/build_strategy.h:58. AllReduce replicates the
    optimizer per device; Reduce shards it (closer to ZeRO)."""

    AllReduce = 0
    Reduce = 1


class GradientScaleStrategy(enum.IntEnum):
    CoeffNumDevice = 0
    One = 1
    Customized = 2


class BuildStrategy:
    """reference: details/build_strategy.h:37."""

    ReduceStrategy = ReduceStrategy
    GradientScaleStrategy = GradientScaleStrategy

    def __init__(self):
        self.reduce_strategy = ReduceStrategy.AllReduce
        self.gradient_scale_strategy = GradientScaleStrategy.CoeffNumDevice
        # Fusion/memory knobs of the reference's pass pipeline: recorded
        # for API parity.
        self.fuse_elewise_add_act_ops = False
        self.fuse_bn_act_ops = False
        self.fuse_all_optimizer_ops = False
        self.fuse_all_reduce_ops = False
        self.fuse_broadcast_ops = False
        self.fuse_relu_depthwise_conv = False
        self.memory_optimize = None
        self.enable_inplace = None
        self.cache_runtime_context = False
        self.sync_batch_norm = False
        self.enable_sequential_execution = False
        self.remove_unnecessary_lock = True
        # Multi-host data parallel (reference: num_trainers/trainer_id
        # wired into NCCL rank math, parallel_executor.cc:469).
        self.num_trainers = 1
        self.trainer_id = 0
        self.trainers_endpoints: List[str] = []
        self.use_hierarchical_allreduce = False
        self.hierarchical_allreduce_inter_nranks = 0
        self.nccl_comm_num = 1
        self.debug_graphviz_path = ""


class ExecutorType(enum.IntEnum):
    Default = 0
    Experimental = 1


class ExecutionStrategy:
    """reference: details/execution_strategy.h; kept for API parity."""

    ExecutorType = ExecutorType

    def __init__(self):
        self.num_threads = 0
        self.num_iteration_per_drop_scope = 1
        self.num_iteration_per_run = 1
        self.use_experimental_executor = False
        self.use_thread_barrier = False


class CompiledProgram:
    """reference: compiler.py:65."""

    def __init__(self, program_or_graph,
                 build_strategy: Optional[BuildStrategy] = None):
        if not isinstance(program_or_graph, Program):
            raise TypeError("CompiledProgram expects a Program")
        self._program = program_or_graph
        self._build_strategy = build_strategy or BuildStrategy()
        self._exec_strategy = ExecutionStrategy()
        self._loss_name: Optional[str] = None
        self._places: Optional[Sequence] = None
        self._is_data_parallel = False
        self._cache: Dict[Any, Any] = {}
        self._share_vars_from = None

    # -- reference API -------------------------------------------------------

    def with_data_parallel(self, loss_name: Optional[str] = None,
                           build_strategy: Optional[BuildStrategy] = None,
                           exec_strategy: Optional[ExecutionStrategy] = None,
                           share_vars_from: Optional["CompiledProgram"] = None,
                           places: Optional[Sequence] = None) -> "CompiledProgram":
        self._is_data_parallel = True
        self._loss_name = loss_name
        if build_strategy is not None:
            self._build_strategy = build_strategy
        if exec_strategy is not None:
            self._exec_strategy = exec_strategy
        self._places = places
        self._share_vars_from = share_vars_from
        return self

    @property
    def program(self) -> Program:
        return self._program

    @property
    def build_strategy(self) -> BuildStrategy:
        return self._build_strategy

    # -- execution -----------------------------------------------------------

    def _ranks(self, executor) -> int:
        """The number of ranks, after checking that every place is on the
        executor's device."""
        from .places import cpu_places, cuda_places

        places = self._places
        if not places:
            places = cuda_places() if executor.device.type == "cuda" \
                else cpu_places()
        devices = sorted({str(p.torch_device()) for p in places})
        if devices != [str(executor.device)]:
            raise ValueError(
                f"CompiledProgram's places {list(places)} are not all on the "
                f"executor's device {executor.device}: its in-process ring "
                f"runs every rank on that device (one rank a card is the "
                f"process ring, ROADMAP item 20a)")
        return len(places)

    def _run(self, executor, feed, fetch_list, scope, return_numpy,
             sync: bool = True):
        with _telemetry.executor_step("sharded") as rec:
            program = self._program
            scope = scope if scope is not None else global_scope()
            feed = dict(feed or {})
            fetch_names = tuple(_as_fetch_name(f) for f in (fetch_list or []))
            ranks = self._ranks(executor)

            policy = _precision.resolve(program)
            norm_feed = _normalize_feed(program, feed, policy,
                                        executor.device)
            _pre_run_validate(program, tuple(norm_feed), fetch_names,
                              policy, where="sharded")
            rec.set_feed(norm_feed)

            feed_sig = tuple(sorted((k, tuple(v.shape), str(v.dtype))
                                    for k, v in norm_feed.items()))
            key = (program._version, feed_sig, fetch_names, policy.name,
                   ranks)
            step = self._cache.get(key)
            if step is None:
                t0 = time.perf_counter()
                step = _ShardedStep(program, tuple(norm_feed), fetch_names,
                                    ranks, policy)
                _telemetry.record_compile(
                    "sharded", time.perf_counter() - t0,
                    meta={"devices": ranks, "fetches": len(fetch_names)})
                self._cache[key] = step

            rng = executor._get_rng(scope, program)
            with _tracing.step_span("compiled_program.run", cat="step",
                                    fetches=len(fetch_names)):
                fetches, new_rng = step(scope, norm_feed, rng,
                                        executor.device)
            scope.set_var(RNG_STATE_VAR, new_rng)
            _post_step_health(step.writes, fetch_names, fetches, scope)
            return _finish_fetches(fetches, return_numpy, sync)


class _ShardedStep(RankStep):
    """Data-parallel step: the fed batch split on dim 0 over the ranks,
    state replicated, the whole batch's numbers (lockstep's GSPMD mode).
    A fetch or write split over the ranks comes back joined, as the JAX
    package's replicated outputs."""

    def __init__(self, program, feed_names, fetch_names, ranks, policy):
        super().__init__(program, feed_names, fetch_names, policy,
                         InProcessRing(ranks), GSPMD)

    def __call__(self, scope, feed, rng, device):
        shards = self.split_feeds(
            feed, "ranks of CompiledProgram's data-parallel ring")
        states = self._gather_states(scope, device)
        step_seed, new_rng = _split_rng(rng)
        envs, split = self.run_ranks([{**states, **f} for f in shards],
                                     [step_seed] * self.ring.size, device)

        def whole(n):
            vals = [env[n] for env in envs]
            return self.ring.join(vals, 0) if n in split else vals[0]

        fetches = []
        for n in self.fetch_names:
            if n not in envs[0]:
                raise lowering.LoweringError(
                    f"fetch var '{n}' was not produced by the program")
            fetches.append(whole(n))
        for n in self.writes:
            if n in envs[0]:
                scope.set_var(n, whole(n))
        return fetches, new_rng


class ParallelExecutor:
    """Legacy data-parallel executor facade (reference:
    parallel_executor.py:28: ``ParallelExecutor(use_cuda, loss_name,
    ...)``, predating CompiledProgram.with_data_parallel), on the same
    engine: `use_cuda` runs on `CUDAPlace(0)`, else on the CPU, with the
    ranks `CompiledProgram` takes from the executor's device. As in the
    reference, `use_cuda` is required: the facade has no default device
    and never falls back to the CPU."""

    def __init__(self, use_cuda: bool,
                 loss_name: Optional[str] = None,
                 main_program: Optional[Program] = None,
                 share_vars_from: Optional["ParallelExecutor"] = None,
                 exec_strategy: Optional[ExecutionStrategy] = None,
                 build_strategy: Optional[BuildStrategy] = None,
                 num_trainers: int = 1, trainer_id: int = 0,
                 scope=None):
        from .executor import Executor
        from .places import CPUPlace, CUDAPlace

        if num_trainers > 1:
            raise RuntimeError(
                "num_trainers > 1 runs one process per trainer over NCCL, "
                "which the port does not do yet (ROADMAP item 20a)")
        program = main_program or framework.default_main_program()
        self._scope = scope if scope is not None else global_scope()
        self._compiled = CompiledProgram(
            program, build_strategy).with_data_parallel(
            loss_name=loss_name, exec_strategy=exec_strategy,
            share_vars_from=(share_vars_from._compiled
                             if isinstance(share_vars_from,
                                           ParallelExecutor)
                             else share_vars_from))
        self._exe = Executor(CUDAPlace(0) if use_cuda else CPUPlace())

    def run(self, fetch_list=None, feed=None, feed_dict=None,
            return_numpy: bool = True):
        """Reference signature: fetch_list FIRST (parallel_executor.py
        run); feed_dict is the deprecated alias for feed."""
        return self._exe.run(self._compiled,
                             feed=feed if feed is not None else feed_dict,
                             fetch_list=fetch_list, scope=self._scope,
                             return_numpy=return_numpy)

    def drop_local_exe_scopes(self):
        """No-op: the ranks keep no scopes of their own to drop."""
