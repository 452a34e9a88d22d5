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

`resolve` picks the policy: explicit argument > the program's
attribute (`set_program_precision`) > env `PADDLE_TPU_PRECISION` > f32.
Under a policy with `op_autocast`, the fluid path's lowering casts each
op's inputs (`autocast`, `autocast_op_inputs`): white-list ops take the
compute dtype, black-list ops f32, and a `_grad` op its forward op's
class. `compute_dtype` and `cast_floating` are what the decode engine
reads.
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Any, Dict, List, Optional, Union

import torch

__all__ = ["PrecisionPolicy", "POLICY_NAMES", "ENV_VAR", "get_policy",
           "resolve", "env_precision", "compute_dtype", "cast_floating",
           "cast_tree", "init_loss_scale_state", "LOSS_SCALE_COUNTER_KEYS",
           "set_program_precision", "program_precision", "autocast",
           "active_autocast", "autocast_op_inputs"]

ENV_VAR = "PADDLE_TPU_PRECISION"
PROGRAM_ATTR = "precision"


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

    def feed_dtype(self, declared: torch.dtype) -> torch.dtype:
        """Feed-normalization target for a var declared `declared`:
        floating feeds follow the policy's compute width, everything
        else keeps the declared dtype."""
        if self.compute_dtype is not None and declared.is_floating_point:
            return self.compute_dtype
        return declared

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


def set_program_precision(program, name: Optional[str]):
    """Pin `program` to a named policy (None clears it). Bumps the
    program version so every executor program-cache key re-keys: the
    old policy's prepared steps are never served for the new one."""
    if name is not None:
        get_policy(name)  # validate before mutating
    new = str(name) if name is not None else None
    if program._attrs.get(PROGRAM_ATTR) == new:
        return  # re-pinning the same policy keeps the prepared steps
    if new is None:
        program._attrs.pop(PROGRAM_ATTR, None)
    else:
        program._attrs[PROGRAM_ATTR] = new
    program._bump_version()


def program_precision(program) -> Optional[str]:
    attrs = getattr(program, "_attrs", None)
    if not attrs:
        return None
    return attrs.get(PROGRAM_ATTR)


def resolve(program=None, explicit=None) -> PrecisionPolicy:
    """The policy in effect for a run: explicit argument > program
    attribute > PADDLE_TPU_PRECISION > f32."""
    if explicit is not None:
        return get_policy(explicit)
    name = program_precision(program) if program is not None else None
    if name is None:
        name = env_precision()
    return get_policy(name)


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


# ---------------------------------------------------------------------------
# Lowering-time op autocast: core/lowering.run_op consults the active
# policy for every op it runs, casting white-list op inputs to the
# compute dtype and black-list op inputs to f32; grad ops (`foo_grad`,
# a replay of `foo`) inherit their forward op's class, so the backward
# products run at the forward's width.
# ---------------------------------------------------------------------------

_tl = threading.local()
_op_lists = None  # (white, black), loaded lazily from amp.fp16_lists


def _lists():
    global _op_lists
    if _op_lists is None:
        from ..amp import fp16_lists

        _op_lists = (frozenset(fp16_lists.white_list),
                     frozenset(fp16_lists.black_list))
    return _op_lists


@contextlib.contextmanager
def autocast(policy: Optional[PrecisionPolicy]):
    """Activate op autocast for the with-block (one step). No-op for
    policies without op_autocast. Thread-local."""
    if policy is None or not policy.op_autocast:
        yield
        return
    prev = getattr(_tl, "policy", None)
    _tl.policy = policy
    try:
        yield
    finally:
        _tl.policy = prev


def active_autocast() -> Optional[PrecisionPolicy]:
    return getattr(_tl, "policy", None)


def _base_op_type(op_type: str) -> str:
    # conv2d_grad / conv2d_grad_grad classify as conv2d
    while op_type.endswith("_grad"):
        op_type = op_type[:-len("_grad")]
    return op_type


def autocast_op_inputs(op_type: str, ins: Dict[str, List],
                       policy: PrecisionPolicy) -> Dict[str, List]:
    """Cast `ins` (slot -> value list) for `op_type` under `policy`:
    white-list ops take compute-dtype floats, black-list ops take f32
    floats, everything else passes through (dtype propagation decides).
    """
    white, black = _lists()
    base = _base_op_type(op_type)
    if base in white:
        want = policy.compute_dtype
    elif base in black:
        want = torch.float32
    else:
        return ins
    return {slot: [cast_floating(v, want) for v in vals]
            for slot, vals in ins.items()}


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
