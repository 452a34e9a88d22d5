"""Operators of the port: attention dispatch and beam search, the int8
product of the inference path (`int8.py`), and the fluid path's op
kernels (the int8 runtime and fake-quant ops among them, `quant.py`;
the c_* collective ops, `collective.py`; the SelectedRows, loss, CTC and
utility ops, `misc.py`; the text-matching and CTR ops, `text_match.py`;
the detection ops, `detection.py`; the sequence models' ops,
`sequence.py`, `rnn.py`, `crf.py`, `beam.py` and `metrics_ops.py`).
Importing this package registers the latter (core/registry.py), as the
JAX package's `ops/__init__.py` does."""

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
from . import misc
from . import sequence
from . import text_match
from . import rnn
from . import crf
from . import beam
from . import detection
