"""Operators of the port: attention dispatch and beam search, the int8
product of the inference path (`int8.py`), and the fluid path's op
kernels (the int8 runtime ops among them, `quant.py`; the c_* collective
ops, `collective.py`). Importing this package registers the latter
(core/registry.py), as the JAX package's `ops/__init__.py` does."""

from . import tensor
from . import math
from . import activation
from . import reduce
from . import nn
from . import optimizer_ops
from . import metrics_ops
from . import quant
from . import compare
from . import classify
from . import control_flow
from . import collective
