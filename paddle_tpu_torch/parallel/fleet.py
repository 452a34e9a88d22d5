"""Fleet: the unified distributed-training facade, the JAX package's
`parallel/fleet.py` on the port's in-process dp ring.

Reference: incubate/fleet/base/fleet_base.py:38 (Fleet), fleet/collective
(`CollectiveOptimizer`), used as:

    fleet.init(PaddleCloudRoleMaker())
    optimizer = fleet.distributed_optimizer(optimizer, strategy)
    optimizer.minimize(loss)
    ... exe.run(fleet.main_program)

`init()` takes one worker: several (processes over NCCL) raise, ROADMAP
item 20a. `mesh()` builds the port's `make_mesh` from the strategy's
degrees as in-process ranks on one device (dp -1 absorbs this process's
one rank), and `distributed_optimizer` returns a wrapper that, with
`use_graph_collectives`, transpiles the program with `GradAllReduce` or
`LocalSGD` after `minimize`, as there, for `SPMDRunner`. The other
rewrites raise, naming their ROADMAP items: `use_hierarchical_allreduce`
(20a), and `use_amp`, `recompute`, `gradient_merge_k > 1`, `use_dgc`
and `lamb` (the amp decorator and the other optimizers, item 16).
"""

from __future__ import annotations

import math
from typing import Optional

from ..core import framework
from .role_maker import PaddleCloudRoleMaker, RoleMakerBase
from .strategy import DistributedStrategy


def _refuse_strategy(st: DistributedStrategy) -> None:
    if st.use_hierarchical_allreduce:
        raise NotImplementedError(
            "use_hierarchical_allreduce factors the mesh over hosts, which "
            "needs the process ring over NCCL (ROADMAP item 20a)")
    unported = [k for k, on in (("use_amp", st.use_amp),
                                ("recompute", st.recompute),
                                ("gradient_merge_k > 1",
                                 st.gradient_merge_k > 1),
                                ("use_dgc", st.use_dgc), ("lamb", st.lamb))
                if on]
    if unported:
        raise NotImplementedError(
            f"DistributedStrategy {unported}: the amp decorator and the "
            f"Recompute, GradientMerge, DGC and Lamb optimizers are not "
            f"ported (ROADMAP item 16)")


class Fleet:
    def __init__(self):
        self._role_maker: Optional[RoleMakerBase] = None
        self._strategy: Optional[DistributedStrategy] = None
        self._mesh = None
        self._mesh_key = None
        self._inited = False

    # -- lifecycle (reference fleet_base.py:64 init) -----------------------

    def init(self, role_maker: Optional[RoleMakerBase] = None,
             is_collective: bool = True):
        role_maker = role_maker or PaddleCloudRoleMaker(is_collective)
        n = role_maker.worker_num()
        if n > 1:
            raise NotImplementedError(
                f"fleet.init with {n} workers runs one process a worker "
                f"over NCCL, which the port does not do yet (ROADMAP item "
                f"20a); its data parallelism is in-process ranks "
                f"(DistributedStrategy.data_parallel_degree)")
        self._role_maker = role_maker
        self._inited = True
        return self

    @property
    def inited(self) -> bool:
        return self._inited

    # -- identity ----------------------------------------------------------

    def is_first_worker(self) -> bool:
        return self._role_maker.is_first_worker()

    def worker_index(self) -> int:
        return self._role_maker.worker_index()

    def worker_num(self) -> int:
        return self._role_maker.worker_num()

    def is_worker(self) -> bool:
        return self._role_maker.is_worker()

    def is_server(self) -> bool:
        return self._role_maker.is_server()

    def worker_endpoints(self, to_string=False):
        eps = self._role_maker.get_trainer_endpoints()
        return ",".join(eps) if to_string else eps

    def server_endpoints(self, to_string=False):
        eps = self._role_maker.get_pserver_endpoints()
        return ",".join(eps) if to_string else eps

    def barrier_worker(self):
        """A barrier over the workers: with one worker there is nothing
        to wait for."""

    # -- mesh --------------------------------------------------------------

    @staticmethod
    def _ranks(strategy: DistributedStrategy) -> int:
        """The in-process ranks the strategy asks for: the product of its
        fixed degrees (an axis at -1 absorbs none)."""
        cfg = strategy.mesh_config()
        return math.prod(max(1, getattr(cfg, a))
                         for a in ("dp", "tp", "pp", "sp", "ep"))

    def mesh(self, strategy: Optional[DistributedStrategy] = None,
             device=None):
        """The strategy's mesh: its degrees as in-process rings of ranks
        on `device` (default cuda; "cpu" on the CPU)."""
        from .. import resolve_device
        from .mesh import make_mesh

        strategy = strategy or self._strategy or DistributedStrategy()
        _refuse_strategy(strategy)
        cfg = strategy.mesh_config()
        n = self._ranks(strategy)
        dev = resolve_device(device)
        key = (tuple(sorted(cfg.resolve(n).items())), str(dev))
        if self._mesh is None or self._mesh_key != key:
            self._mesh = make_mesh(cfg, devices=[dev] * n)
            self._mesh_key = key
        return self._mesh

    # -- the optimizer wrapper (reference CollectiveOptimizer) -------------

    def distributed_optimizer(self, optimizer,
                              strategy: Optional[DistributedStrategy] = None):
        self._strategy = strategy or DistributedStrategy()
        return DistributedOptimizer(self, optimizer, self._strategy)

    # -- program accessors (reference fleet_base properties) ---------------

    @property
    def main_program(self):
        return framework.default_main_program()

    @property
    def startup_program(self):
        return framework.default_startup_program()

    def save_persistables(self, executor, dirname, main_program=None):
        from .. import io

        if self.is_first_worker():
            io.save_persistables(executor, dirname, main_program)

    def save_inference_model(self, executor, dirname, feeded_var_names,
                             target_vars, main_program=None, **kw):
        from .. import io

        if self.is_first_worker():
            io.save_inference_model(dirname, feeded_var_names, target_vars,
                                    executor, main_program=main_program, **kw)


class DistributedOptimizer:
    """reference: incubate/fleet/collective/__init__.py:117
    CollectiveOptimizer: wraps a regular optimizer, applies distributed
    rewrites during minimize."""

    def __init__(self, fleet: Fleet, optimizer, strategy: DistributedStrategy):
        self._fleet = fleet
        self._inner = optimizer
        self._strategy = strategy

    def backward(self, loss, **kw):
        return self._inner.backward(loss, **kw)

    def apply_gradients(self, params_grads):
        return self._inner.apply_gradients(params_grads)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        st = self._strategy
        _refuse_strategy(st)
        ops, p2g = self._inner.minimize(loss, startup_program,
                                        parameter_list, no_grad_set)

        # Explicit in-graph collectives only for the SPMDRunner execution
        # mode (reference collective-transpiler semantics); the default
        # CompiledProgram path reduces the gradients itself.
        if st.use_graph_collectives:
            program = loss.block.program
            n = st.mesh_config().resolve(self._fleet._ranks(st))["dp"]
            if st.use_local_sgd:
                from .collective import LocalSGD

                LocalSGD(nranks=n, k_steps=st.local_sgd_steps).transpile(program)
            else:
                from .collective import GradAllReduce

                GradAllReduce(nranks=n).transpile(program)
        return ops, p2g


fleet = Fleet()
