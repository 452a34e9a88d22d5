"""Device places (reference: paddle/fluid/platform/place.h:26-52): the
JAX package's `core/places.py` on torch devices.

`CUDAPlace(i)` is a real CUDA device and raises at construction on a
machine without one. `TPUPlace` and `XPUPlace` alias it, as the JAX
package aliases "the accelerator", so scripts written for either
package run unchanged. `default_place()` is `CUDAPlace(0)`: there is no
fallback to the CPU (the JAX package's falls back to `CPUPlace`); a CPU
run asks for `CPUPlace()`.
"""

from __future__ import annotations

import torch

__all__ = ["Place", "CPUPlace", "CUDAPlace", "TPUPlace", "XPUPlace",
           "is_compiled_with_cuda", "default_place"]


class Place:
    device_id: int = 0

    def __eq__(self, other):
        return type(self) is type(other) and self.device_id == getattr(other, "device_id", 0)

    def __hash__(self):
        return hash((type(self).__name__, self.device_id))

    def torch_device(self) -> torch.device:
        raise NotImplementedError


class CPUPlace(Place):
    def torch_device(self) -> torch.device:
        return torch.device("cpu")

    def __repr__(self):
        return "CPUPlace"


class CUDAPlace(Place):
    def __init__(self, device_id: int = 0):
        from .. import resolve_device

        self.device_id = int(device_id)
        self._device = resolve_device(f"cuda:{self.device_id}")

    def torch_device(self) -> torch.device:
        return self._device

    def __repr__(self):
        return f"CUDAPlace({self.device_id})"


# Scripts written against the JAX package's fluid.TPUPlace(0) (or the
# reference's XPUPlace) run on the GPU unchanged.
TPUPlace = CUDAPlace
XPUPlace = CUDAPlace


def is_compiled_with_cuda() -> bool:
    """True when this process can run on a CUDA device."""
    return torch.cuda.is_available()


def default_place() -> Place:
    """CUDAPlace(0); raises on a machine without a GPU."""
    return CUDAPlace(0)
