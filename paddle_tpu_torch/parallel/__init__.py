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
from .mesh import MeshConfig, make_mesh, mesh_guard  # noqa: F401
