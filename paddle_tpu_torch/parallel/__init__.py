"""Training and its parallel layout: the train-step builder
(`train.py`), the device mesh (`mesh.py`, on the rings of
`core/ring.py`), logical-axis rules (`sharding.py`) and the GPipe
pipeline over `pp` (`pipeline.py`); the fluid path's data parallelism:
`SPMDRunner` (`spmd_executor.py`, on the lockstep runtime of
`core/lockstep.py`), the `GradAllReduce` and `LocalSGD` transpilers
(`collective.py`), `DistributedStrategy` (`strategy.py`), the role
makers (`role_maker.py`) and the fleet facade (`fleet.py`).

The fluid names are exported as the JAX package's `parallel/__init__`
exports them."""

from . import collective  # noqa: F401
from .strategy import DistributedStrategy  # noqa: F401
from .role_maker import (  # noqa: F401
    PaddleCloudRoleMaker, Role, RoleMakerBase, UserDefinedRoleMaker,
)
from .fleet import fleet, Fleet, DistributedOptimizer  # noqa: F401
from .spmd_executor import SPMDRunner  # noqa: F401
from .mesh import (  # noqa: F401
    MeshConfig, auto_mesh, current_mesh, get_mesh, make_hybrid_mesh,
    mesh_guard, make_mesh, resize_mesh,
)
from .sharding import (  # noqa: F401
    LogicalRules, NO_SHARD, in_manual_region, logical_to_mesh, shard,
    shard_params_spec, with_rules, current_rules,
)
from .checkpoint import (  # noqa: F401
    latest_step_dir, restore_train_state, save_train_state,
)
from .train import train_loop  # noqa: F401
