# Copied from the JAX package's paddle_tpu/parallel/strategy.py; nothing else differs.

"""DistributedStrategy — the fleet-facing strategy object.

Reference: incubate/fleet/collective/__init__.py:94 DistributedStrategy
(extends BuildStrategy) + DistributeTranspilerConfig
(transpiler/distribute_transpiler.py:131). One object collects every
distributed-training knob; fleet.distributed_optimizer interprets it.

Mapping to TPU-native mechanisms:
  mode collective        → single pjit mesh (ICI/DCN collectives by XLA)
  use_hierarchical_allreduce → mesh factorization (mesh.py AXIS_ORDER)
  nccl_comm_num          → moot (one ICI domain); recorded
  use_local_sgd          → parallel/collective.py LocalSGD transpile
  use_dgc                → DGCMomentumOptimizer (top-k grad compression)
  gradient_merge_k       → TrainStrategy.accum_steps / GradientMergeOptimizer
  recompute              → TrainStrategy.recompute / RecomputeOptimizer
  pipeline               → parallel/pipeline.py ('pp' axis)
  sharding (ZeRO)        → TrainStrategy.shard_optimizer_states
  amp                    → amp.decorate (bf16 policy)
  tensor/sequence/expert parallel degrees → mesh axes tp/sp/ep
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from ..core.compiler import BuildStrategy, ExecutionStrategy


@dataclasses.dataclass
class DistributedStrategy:
    # parallelism degrees (mesh axes)
    data_parallel_degree: int = -1
    tensor_parallel_degree: int = 1
    pipeline_parallel_degree: int = 1
    sequence_parallel_degree: int = 1
    expert_parallel_degree: int = 1
    # optimizer-side features
    use_local_sgd: bool = False
    local_sgd_steps: int = 1
    use_dgc: bool = False
    gradient_merge_k: int = 1
    recompute: bool = False
    recompute_checkpoints: Optional[List[str]] = None
    sharding: bool = False           # ZeRO-1 optimizer-state sharding
    use_amp: bool = False
    amp_loss_scale: float = 32768.0
    lamb: bool = False
    # pipeline details
    pipeline_micro_batches: int = 1
    # parity-only knobs (reference semantics absorbed by XLA/ICI)
    use_hierarchical_allreduce: bool = False
    hierarchical_allreduce_inter_nranks: int = 0
    nccl_comm_num: int = 1
    fuse_all_reduce_ops: bool = True
    fuse_grad_size_in_MB: int = 32
    # execution mode: GSPMD CompiledProgram (default) vs per-device graph
    # with explicit c_allreduce ops run by SPMDRunner (the reference's
    # collective-transpiler semantics)
    use_graph_collectives: bool = False
    # multihost
    num_trainers: int = 1
    trainer_id: int = 0
    trainer_endpoints: Optional[List[str]] = None
    # legacy containers for API parity
    build_strategy: Optional[BuildStrategy] = None
    exec_strategy: Optional[ExecutionStrategy] = None

    def mesh_config(self):
        from .mesh import MeshConfig

        return MeshConfig(dp=self.data_parallel_degree,
                          tp=self.tensor_parallel_degree,
                          pp=self.pipeline_parallel_degree,
                          sp=self.sequence_parallel_degree,
                          ep=self.expert_parallel_degree)

    def train_strategy(self):
        from .train import TrainStrategy

        return TrainStrategy(
            shard_optimizer_states=self.sharding,
            accum_steps=max(1, self.gradient_merge_k),
            recompute=self.recompute)
