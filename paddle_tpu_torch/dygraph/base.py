"""Dygraph mode switches: the JAX package's `dygraph/base.py`
(reference: python/paddle/fluid/dygraph/base.py — guard :89,
to_variable :151), with a place.

`guard(place)` and `enable_dygraph(place)` take the place eager tensors
and parameters live on: `CUDAPlace(0)` when none is given, which raises
on a machine without CUDA; a CPU run passes `CPUPlace()`. There is no
fallback to the CPU.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..core import framework
from .tracer import Tracer, get_tracer
from .varbase import VarBase

_enabled = False


def enabled() -> bool:
    return _enabled


def enable_dygraph(place=None):
    """Eager mode on `place` (a Place; None is CUDAPlace(0), which raises
    without CUDA)."""
    from ..core.places import default_place

    global _enabled
    tracer = get_tracer()
    tracer.set_place(place if place is not None else default_place())
    _enabled = True
    framework._set_dygraph_tracer(tracer)


def disable_dygraph():
    global _enabled
    _enabled = False
    framework._set_dygraph_tracer(None)
    get_tracer().set_place(None)


@contextlib.contextmanager
def guard(place=None):
    enable_dygraph(place)
    try:
        yield
    finally:
        disable_dygraph()


def to_variable(value, name=None, zero_copy=None):
    """`value` (numpy, a tensor) as a VarBase on the dygraph place."""
    if isinstance(value, VarBase):
        return value
    device = get_tracer().device
    if isinstance(value, torch.Tensor):
        return VarBase(value.detach().to(device), name=name)
    return VarBase(torch.tensor(np.asarray(value), device=device), name=name)


@contextlib.contextmanager
def no_grad():
    t = get_tracer()
    old = t._no_grad
    t._no_grad = True
    try:
        yield
    finally:
        t._no_grad = old


def grad(outputs, inputs, grad_outputs=None, retain_graph=False,
         create_graph=False, only_inputs=True, allow_unused=False):
    """reference: the dygraph grad API: a backward from every output
    (each seeded with ones), then the inputs' gradients."""
    outputs = outputs if isinstance(outputs, (list, tuple)) else [outputs]
    inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    for i, o in enumerate(outputs):
        o.backward(retain_graph=retain_graph or i < len(outputs) - 1)
    return [i.grad for i in inputs]
