"""Precision policies: a named choice of compute width, resolved the
same way by every run path.

Counterpart of the JAX package's `core/precision.py`, with the same four
policies and fields:

  f32         leaves dtypes alone (compute_dtype None).
  bf16        params and optimizer state cast to, and computed in,
              bfloat16 (cast_state).
  mixed_bf16  bfloat16 compute against f32 master params and optimizer
              state, with dynamic loss scaling whose state lives in
              `TrainState.loss_scale`.
  mixed_f16   the same with float16 compute.

`resolve` picks the policy: explicit argument > env
`PADDLE_TPU_PRECISION` > f32 (there is no Program IR in the port yet,
so no program attribute). The lowering-time op autocast of the fluid
path waits for that IR. `compute_dtype` and `cast_floating` are what
the decode engine reads.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Union

import torch

__all__ = ["PrecisionPolicy", "POLICY_NAMES", "ENV_VAR", "get_policy",
           "resolve", "env_precision", "compute_dtype", "cast_floating",
           "cast_tree", "init_loss_scale_state", "LOSS_SCALE_COUNTER_KEYS"]

ENV_VAR = "PADDLE_TPU_PRECISION"


class PrecisionPolicy:
    """One named precision configuration; compare by name."""

    def __init__(self, name: str, *,
                 compute_dtype: Optional[torch.dtype] = None,
                 cast_state: bool = False,
                 op_autocast: bool = False,
                 dynamic_loss_scale: bool = False,
                 init_loss_scale: float = 2.0 ** 15,
                 growth_interval: int = 1000,
                 incr_ratio: float = 2.0,
                 decr_ratio: float = 0.5,
                 min_loss_scale: float = 1.0,
                 max_loss_scale: float = 2.0 ** 24):
        self.name = name
        # None = leave dtypes alone (f32 is a no-op, float64 included)
        self.compute_dtype = compute_dtype
        self.cast_state = cast_state
        self.op_autocast = op_autocast
        self.dynamic_loss_scale = dynamic_loss_scale
        self.init_loss_scale = float(init_loss_scale)
        self.growth_interval = int(growth_interval)
        self.incr_ratio = float(incr_ratio)
        self.decr_ratio = float(decr_ratio)
        self.min_loss_scale = float(min_loss_scale)
        self.max_loss_scale = float(max_loss_scale)

    def __repr__(self):
        return f"PrecisionPolicy({self.name!r})"

    def __eq__(self, other):
        return isinstance(other, PrecisionPolicy) and other.name == self.name

    def __hash__(self):
        return hash(self.name)


_POLICIES: Dict[str, PrecisionPolicy] = {
    "f32": PrecisionPolicy("f32"),
    "bf16": PrecisionPolicy("bf16", compute_dtype=torch.bfloat16,
                            cast_state=True),
    "mixed_bf16": PrecisionPolicy("mixed_bf16", compute_dtype=torch.bfloat16,
                                  op_autocast=True, dynamic_loss_scale=True),
    "mixed_f16": PrecisionPolicy("mixed_f16", compute_dtype=torch.float16,
                                 op_autocast=True, dynamic_loss_scale=True),
}

POLICY_NAMES = tuple(sorted(_POLICIES))


def get_policy(name: Union[str, PrecisionPolicy, None]) -> PrecisionPolicy:
    """Policy for `name` (a PrecisionPolicy passes through; None = f32).
    Unknown names raise."""
    if name is None:
        return _POLICIES["f32"]
    if isinstance(name, PrecisionPolicy):
        return name
    pol = _POLICIES.get(str(name))
    if pol is None:
        raise ValueError(f"unknown precision policy {name!r}; choose from "
                         f"{list(POLICY_NAMES)}")
    return pol


def env_precision() -> Optional[str]:
    return os.environ.get(ENV_VAR) or None


def resolve(explicit=None) -> PrecisionPolicy:
    """The policy in effect: explicit argument > PADDLE_TPU_PRECISION >
    f32."""
    if explicit is not None:
        return get_policy(explicit)
    return get_policy(env_precision())


def compute_dtype(name: str) -> torch.dtype:
    """The compute dtype of policy `name` (float32 for f32, which leaves
    dtypes alone); unknown names raise."""
    return get_policy(name).compute_dtype or torch.float32


def cast_floating(value, dtype: Optional[torch.dtype]):
    """`value` cast to `dtype` iff it is a floating tensor of another
    width; integer and bool tensors, non-tensors and dtype None pass
    through untouched. The cast is differentiable: the gradient of a
    cast f32 master comes back f32."""
    if dtype is None or not isinstance(value, torch.Tensor) or \
            not value.is_floating_point() or value.dtype == dtype:
        return value
    return value.to(dtype)


def cast_tree(tree, dtype: Optional[torch.dtype]):
    """cast_floating over every leaf of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_tree(v, dtype) for v in tree)
    return cast_floating(tree, dtype)


# cumulative outcome counters of the loss-scale state
LOSS_SCALE_COUNTER_KEYS = ("overflows", "growths")


def init_loss_scale_state(policy: PrecisionPolicy
                          ) -> Optional[Dict[str, Any]]:
    """Fresh loss-scale state for `policy`, or None when it has no
    dynamic loss scaling. The values are host numbers (the step reads
    `finite` on the host once a step anyway): "scale" a float held at
    f32 precision, as the JAX package's f32 scalar, the counters ints."""
    if not policy.dynamic_loss_scale:
        return None
    return {"scale": policy.init_loss_scale, "good_steps": 0,
            "overflows": 0, "growths": 0}
