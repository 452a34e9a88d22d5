"""VarBase, the eager tensor: the JAX package's `dygraph/varbase.py` on
a torch tensor (reference: imperative/layer.h:55, VarBase = variable +
grad var + grad op metadata).

The value is a `torch.Tensor` on an explicit device: a VarBase made from
numpy lands on the dygraph guard's place (`base.guard`), one made from a
tensor stays on that tensor's device. An op output's tensor carries its
autograd history, and its gradient is the tensor's `.grad` (the tracer
retains it on every output it records), so `gradient` and `grad` read
what `backward()` left there, summed over backward calls until
`clear_gradient()`, as the JAX package's tape does.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.ir import normalize_dtype
from ..core.registry import dtype_name


def _device():
    from .tracer import get_tracer

    return get_tracer().device


def as_tensor(value, device=None) -> torch.Tensor:
    """`value` as a tensor: a tensor keeps its device unless `device` is
    given; anything else is copied from numpy (its dtype kept) onto
    `device`, by default the dygraph place."""
    if isinstance(value, torch.Tensor):
        return value if device is None else value.to(device)
    arr = np.asarray(value)
    return torch.tensor(arr, device=_device() if device is None else device)


def host_copy(t: torch.Tensor) -> np.ndarray:
    """A numpy copy of `t` that shares no memory with it (bfloat16 read
    as float32)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    elif t.device.type == "cpu":
        t = t.clone()
    return t.cpu().numpy()


class VarBase:
    def __init__(self, value, name: Optional[str] = None, stop_gradient=False,
                 persistable=False, trainable=True):
        # value=None: a placeholder the tracer fills (static-graph layers
        # create their outputs before the op runs)
        self._value = None if value is None else as_tensor(value)
        self.name = name or f"eager_tmp_{id(self)}"
        self.stop_gradient = stop_gradient
        self.persistable = persistable
        self.trainable = trainable

    # -- data access ---------------------------------------------------------

    @property
    def value(self) -> torch.Tensor:
        return self._value

    @property
    def shape(self):
        return tuple(self._value.shape)

    @property
    def dtype(self):
        return normalize_dtype(dtype_name(self._value.dtype))

    @property
    def device(self) -> torch.device:
        return self._value.device

    def numpy(self) -> np.ndarray:
        """A host copy (waits for the device; bfloat16 read as float32)."""
        return host_copy(self._value)

    def _bind(self, tensor: torch.Tensor):
        """Take an op's output as it is, autograd history and all (the
        tracer's fill of a placeholder)."""
        self._value = tensor

    def set_value(self, v):
        """Overwrite the value with `v`, which keeps no autograd history.
        A parameter (a leaf that takes a gradient) of the same shape and
        dtype is written in place, so it keeps its gradient; anything
        else is replaced by a detached tensor on this VarBase's
        device."""
        old = self._value
        new = as_tensor(v, None if old is None else old.device).detach()
        param = old is not None and old.requires_grad and old.grad_fn is None
        if param and old.shape == new.shape and old.dtype == new.dtype:
            with torch.no_grad():
                old.copy_(new)
            return
        if param and new.is_floating_point():
            new.requires_grad_(True)
        self._value = new

    def detach(self) -> "VarBase":
        return VarBase(self._value.detach(), stop_gradient=True)

    # -- autograd ------------------------------------------------------------

    @property
    def gradient(self):
        g = self.grad
        return None if g is None else host_copy(g)

    @property
    def grad(self) -> Optional[torch.Tensor]:
        t = self._value
        if t is None or not t.requires_grad:
            return None
        return t.grad

    def clear_gradient(self):
        if self._value is not None and self._value.requires_grad:
            self._value.grad = None

    def backward(self, retain_graph=False):
        from .tracer import get_tracer

        get_tracer().run_backward(self, retain_graph=retain_graph)

    # -- operators -----------------------------------------------------------

    def _binary(self, other, op_type):
        from .tracer import get_tracer

        if not isinstance(other, VarBase):
            # a scalar in this VarBase's dtype, on its device
            other = VarBase(torch.as_tensor(other, dtype=self._value.dtype,
                                            device=self._value.device),
                            stop_gradient=True)
        out = get_tracer().trace_op(op_type, {"X": [self], "Y": [other]},
                                    {"Out": [None]}, {"axis": -1})
        return out["Out"][0]

    def __add__(self, other):
        return self._binary(other, "elementwise_add")

    __radd__ = __add__

    def __sub__(self, other):
        return self._binary(other, "elementwise_sub")

    def __mul__(self, other):
        return self._binary(other, "elementwise_mul")

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binary(other, "elementwise_div")

    def __neg__(self):
        from .tracer import get_tracer

        out = get_tracer().trace_op("scale", {"X": [self]}, {"Out": [None]},
                                    {"scale": -1.0})
        return out["Out"][0]

    def __repr__(self):
        return f"VarBase(name={self.name}, shape={self.shape}, dtype={self.dtype})\n{self.numpy()}"

    def astype(self, dtype):
        from .tracer import get_tracer

        if isinstance(dtype, torch.dtype):
            dtype = dtype_name(dtype)
        out = get_tracer().trace_op("cast", {"X": [self]}, {"Out": [None]},
                                    {"out_dtype": normalize_dtype(dtype)})
        return out["Out"][0]
