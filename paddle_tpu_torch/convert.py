"""Carry parameters across from the JAX package.

Both packages keep params as a flat dict with the same names and the
same layouts, so a conversion is a copy per tensor: no renames and no
transposes. Callers hand over numpy arrays (`np.asarray` of each JAX
array), which keeps this module free of any JAX import. The fluid path
carries a scope's persistables the same way (`scope_from_numpy`).

The compression passes (`slim/`) rewrite scope values on the host, as
the JAX package's do with `np.asarray` (`core.async_exec.to_numpy`
reads a value there): `like_value` writes an array back as the value it
replaces was held (a tensor on its device, or an array), and
`cast_value` changes a value's dtype where it lies.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from . import resolve_device

__all__ = ["cast_value", "like_value", "params_from_numpy",
           "scope_from_numpy"]


def params_from_numpy(params: Mapping[str, np.ndarray], device,
                      dtype: Optional[torch.dtype] = None, *,
                      expected: Optional[Mapping[str, Tuple[int, ...]]]
                      = None) -> Dict[str, torch.Tensor]:
    """{name: array} -> {name: tensor on `device`}, same names, shapes
    and values. `dtype`, when given, casts floating arrays (integer ones
    keep theirs, and so do the f32 `<k>@scale` dequantization scales of
    int8 weights, from `quantize_conv_weights_int8`). `expected` ({name: shape}, from
    a model's `param_shapes`, such as `models.resnet.param_shapes`) makes a
    missing or extra name, or another shape, an error."""
    dev = resolve_device(device)
    if expected is not None:
        missing = sorted(set(expected) - set(params))
        extra = sorted(set(params) - set(expected))
        if missing or extra:
            raise KeyError(f"param names differ: missing {missing}, "
                           f"extra {extra}")
        for name, shape in expected.items():
            if tuple(np.shape(params[name])) != tuple(shape):
                raise ValueError(f"{name}: shape {np.shape(params[name])} "
                                 f"!= expected {tuple(shape)}")
    out = {}
    for name, value in params.items():
        a = np.array(value, copy=True)
        if a.dtype.name == "bfloat16":  # ml_dtypes: no torch.from_numpy
            t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(a)
        if dtype is not None and t.is_floating_point() and \
                not name.endswith("@scale"):
            t = t.to(dtype)
        out[name] = t.to(dev)
    return out


def scope_from_numpy(scope, arrays: Mapping[str, np.ndarray], place):
    """Load {name: array} (a JAX scope's persistables, fetched as numpy
    with `Scope.get`) into the port's `scope` as tensors on `place`'s
    device, same names, dtypes and values. Returns the scope."""
    dev = place.torch_device()
    for name, t in params_from_numpy(arrays, dev).items():
        scope.set_var(name, t)
    return scope


def like_value(value, array: np.ndarray):
    """`array` held as `value` is: a tensor on `value`'s device (with
    `array`'s dtype) when `value` is a tensor, else the array."""
    if isinstance(value, torch.Tensor):
        return params_from_numpy({"v": array}, value.device)["v"]
    return array


def cast_value(value, dtype: str) -> torch.Tensor:
    """`value` (a tensor, or an array) as a tensor of the IR dtype
    `dtype`, where it lies (an array goes to a CPU tensor)."""
    from .core.registry import torch_dtype

    if not isinstance(value, torch.Tensor):
        value = params_from_numpy({"v": np.asarray(value)}, "cpu")["v"]
    return value.to(torch_dtype(dtype))
