"""Dygraph DataParallel: the JAX package's `dygraph/parallel.py`
(reference: python/paddle/fluid/dygraph/parallel.py — Env :30,
prepare_context :54, DataParallel :84).

`ParallelEnv` reads the reference's environment variables
(PADDLE_TRAINERS_NUM, PADDLE_TRAINER_ID, ...), one rank by default. At
one rank `scale_loss` is the identity and `apply_collective_grads` does
nothing, so a DataParallel layer trains as the bare layer does. Over
several ranks the gradient all-reduce is a process collective (the JAX
package's `process_allgather`), and the port's process ring on CUDA
tensors waits for ROADMAP item 20a: `apply_collective_grads` raises
there.
"""

from __future__ import annotations

import os

from .layers import Layer
from .varbase import VarBase


class ParallelEnv:
    """reference: dygraph/parallel.py Env, from PADDLE_TRAINER_* env
    vars."""

    def __init__(self):
        self._nranks = int(os.environ.get("PADDLE_TRAINERS_NUM", 1))
        self._local_rank = int(os.environ.get("PADDLE_TRAINER_ID", 0))

    @property
    def nranks(self):
        return self._nranks

    @property
    def local_rank(self):
        return self._local_rank

    @property
    def dev_id(self):
        return 0

    @property
    def current_endpoint(self):
        return os.environ.get("PADDLE_CURRENT_ENDPOINT", "")

    @property
    def trainer_endpoints(self):
        return os.environ.get("PADDLE_TRAINER_ENDPOINTS", "").split(",")


Env = ParallelEnv


def prepare_context(strategy=None):
    """reference: prepare_context bootstraps the ranks' collective
    context; here the environment's ranks."""
    return ParallelEnv()


class DataParallel(Layer):
    """reference: dygraph/parallel.py:84 — scale_loss + allreduce grads."""

    def __init__(self, layers: Layer, strategy=None):
        super().__init__()
        self._layers = layers
        self._strategy = strategy or ParallelEnv()

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def scale_loss(self, loss: VarBase) -> VarBase:
        n = getattr(self._strategy, "nranks", 1)
        if n <= 1:
            return loss
        return loss * (1.0 / n)

    def apply_collective_grads(self):
        """Sum every gradient over the ranks (the reference coalesces
        them into buffers and all-reduces each); nothing at one rank."""
        n = getattr(self._strategy, "nranks", 1)
        if n <= 1:
            return
        raise NotImplementedError(
            f"dygraph DataParallel over {n} ranks needs the process ring "
            "on CUDA tensors (ROADMAP item 20a); one rank trains as the "
            "bare layer")

    def parameters(self, include_sublayers=True):
        return self._layers.parameters(include_sublayers)

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_dict(self, *a, **k):
        return self._layers.set_dict(*a, **k)
