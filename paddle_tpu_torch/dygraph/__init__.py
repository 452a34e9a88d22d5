"""Dygraph (eager) mode of the port: the JAX package's `dygraph/`
on torch.

Reference: paddle/fluid/imperative/ (the C++ tracer) and
python/paddle/fluid/dygraph/. Ops run at once, through the same op
registry as the static path, on torch tensors on the dygraph place
(`guard(place)`: the card unless `CPUPlace()` is given); torch autograd
records them and `backward()` is its sweep (`tracer.py`).

Layers draw their initial weights with numpy as the JAX package's do,
from a `RandomState` seeded with `hash(full_name)` (`layers.py`, a copy):
in one process both packages draw the same weights, every layer of one
class and shape starts from the same draws, and string hashing's
per-process salt changes them from run to run (ROADMAP F17). Carry
weights across with `state_dict()` / `set_dict()`.
"""

from . import base
from .base import (guard, enable_dygraph, disable_dygraph, to_variable,
                   enabled, grad, no_grad)
from .jit import TracedLayer
from .tracer import Tracer
from .varbase import VarBase
from .layers import Layer
from . import nn
from .nn import (Conv2D, Conv3D, Conv2DTranspose, Conv3DTranspose, Linear,
                 FC, BatchNorm, Embedding, LayerNorm, GRUUnit, Pool2D,
                 Dropout, NCE, PRelu, BilinearTensorProduct, SequenceConv,
                 RowConv, GroupNorm, SpectralNorm)
from .parallel import DataParallel, ParallelEnv, prepare_context
from .checkpoint import save_dygraph, load_dygraph
from .learning_rate_scheduler import (NoamDecay, PiecewiseDecay,
                                      NaturalExpDecay, ExponentialDecay,
                                      InverseTimeDecay, PolynomialDecay,
                                      CosineDecay)
