"""Precision policies, the subset the decode engine reads.

Counterpart of the JAX package's `core/precision.py`: a policy name maps
to the compute dtype ("f32" leaves dtypes alone, i.e. float32; "bf16"
computes and stores pools in bfloat16), and `cast_floating` is the
engine's parameter cast.
"""

from __future__ import annotations

import torch

__all__ = ["POLICY_NAMES", "compute_dtype", "cast_floating"]

_COMPUTE = {"f32": torch.float32, "bf16": torch.bfloat16}
POLICY_NAMES = tuple(sorted(_COMPUTE))


def compute_dtype(name: str) -> torch.dtype:
    """The compute dtype of policy `name`; unknown names raise."""
    try:
        return _COMPUTE[str(name)]
    except KeyError:
        raise ValueError(f"unknown precision policy {name!r}; choose from "
                         f"{list(POLICY_NAMES)}") from None


def cast_floating(value: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """`value` cast to `dtype` iff it is a floating tensor of another
    width; integer and bool tensors pass through untouched."""
    if not value.is_floating_point() or value.dtype == dtype:
        return value
    return value.to(dtype)
