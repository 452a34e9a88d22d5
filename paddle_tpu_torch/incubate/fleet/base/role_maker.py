# Copied from the JAX package's paddle_tpu/incubate/fleet/base/role_maker.py; nothing else differs.

"""reference: incubate/fleet/base/role_maker.py — re-exported from
paddle_tpu_torch.parallel.role_maker (same env contract: PADDLE_TRAINER_ID,
PADDLE_TRAINER_ENDPOINTS, PADDLE_PSERVERS_IP_PORT_LIST, TRAINING_ROLE)."""

from ....parallel.role_maker import (Role, RoleMakerBase,  # noqa: F401
                                     PaddleCloudRoleMaker,
                                     UserDefinedRoleMaker)

__all__ = ["Role", "RoleMakerBase", "PaddleCloudRoleMaker",
           "UserDefinedRoleMaker"]
