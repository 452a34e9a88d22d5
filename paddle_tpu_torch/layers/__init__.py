# Copied from the JAX package: paddle_tpu/layers/__init__.py
# Keep it in step with that file (tests/test_torch_imports.py).
"""Graph-building layers API (reference: python/paddle/fluid/layers/ —
~250 functions, SURVEY.md §2.4)."""

from .io import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403
from .ops import *  # noqa: F401,F403
from .nn import *  # noqa: F401,F403
from .control_flow import *  # noqa: F401,F403
from .sequence import *  # noqa: F401,F403
from .rnn import *  # noqa: F401,F403
from . import distributions  # noqa: F401
from .loss import *  # noqa: F401,F403
from .learning_rate_scheduler import *  # noqa: F401,F403
from .detection import *  # noqa: F401,F403
from .extras import *  # noqa: F401,F403
from .collective import *  # noqa: F401,F403
from .metric_op import *  # noqa: F401,F403
from . import math_op_patch

math_op_patch.monkey_patch_variable()
