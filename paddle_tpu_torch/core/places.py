"""Device places (reference: paddle/fluid/platform/place.h:26-52): the
JAX package's `core/places.py` on torch devices.

`CUDAPlace(i)` is a real CUDA device and raises at construction on a
machine without one. `TPUPlace` and `XPUPlace` alias it, as the JAX
package aliases "the accelerator", so scripts written for either
package run unchanged. `default_place()` is `CUDAPlace(0)`: there is no
fallback to the CPU (the JAX package's falls back to `CPUPlace`); a CPU
run asks for `CPUPlace()`. `CUDAPinnedPlace` is host memory, as there,
and `TPUPinnedPlace` aliases it.

`cpu_places` and `cuda_places` list the ranks of a data-parallel run
(`CompiledProgram.with_data_parallel`): `CPU_NUM` CPU places (default
1), as the reference reads it, and the visible cards, which raise on a
machine without one.
"""

from __future__ import annotations

import os

import torch

__all__ = ["Place", "CPUPlace", "CUDAPlace", "TPUPlace", "XPUPlace",
           "CUDAPinnedPlace", "TPUPinnedPlace", "is_compiled_with_cuda",
           "is_compiled_with_tpu", "default_place", "cpu_places",
           "cuda_places"]


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


class CUDAPinnedPlace(Place):
    """Page-locked host memory (reference: platform/place.h
    CUDAPinnedPlace): the JAX package's `TPUPinnedPlace`, a host place."""

    def torch_device(self) -> torch.device:
        return torch.device("cpu")

    def __repr__(self):
        return "CUDAPinnedPlace"


# Scripts written against the JAX package's fluid.TPUPlace(0) (or the
# reference's XPUPlace) run on the GPU unchanged.
TPUPlace = CUDAPlace
XPUPlace = CUDAPlace
TPUPinnedPlace = CUDAPinnedPlace


def is_compiled_with_cuda() -> bool:
    """True when this process can run on a CUDA device."""
    return torch.cuda.is_available()


def is_compiled_with_tpu() -> bool:
    """Whether the accelerator place is usable: True when a CUDA device
    is, since `TPUPlace` aliases `CUDAPlace` here, so a script that picks
    `TPUPlace` by this test runs on the card."""
    return torch.cuda.is_available()


def cpu_places(device_count=None):
    """reference: framework.cpu_places: `device_count` CPU places, by
    default the `CPU_NUM` environment variable's count (1 unset)."""
    n = device_count if device_count is not None else int(
        os.environ.get("CPU_NUM", 1))
    return [CPUPlace() for _ in range(n)]


def cuda_places(device_ids=None):
    """reference: framework.cuda_places: a place for each visible card
    (`FLAGS_selected_gpus` narrows them), or for `device_ids`. Raises
    on a machine without a card; it never falls back to the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_places: no CUDA device is available; "
                           "use cpu_places() to run on the CPU")
    if device_ids is None:
        sel = os.environ.get("FLAGS_selected_gpus", "")
        device_ids = ([int(s) for s in sel.split(",") if s.strip()]
                      if sel else range(torch.cuda.device_count()))
    return [CUDAPlace(i) for i in device_ids]


def default_place() -> Place:
    """CUDAPlace(0); raises on a machine without a GPU."""
    return CUDAPlace(0)
