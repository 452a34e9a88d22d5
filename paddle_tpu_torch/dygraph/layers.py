# Copied from the JAX package: paddle_tpu/dygraph/layers.py
# Keep it in step with that file (tests/test_torch_imports.py).
"""dygraph.Layer (reference: python/paddle/fluid/dygraph/layers.py)."""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..initializer import XavierInitializer, ConstantInitializer
from ..param_attr import ParamAttr
from .varbase import VarBase



def _init_numpy(initializer, shape, dtype, rng):
    """Materialize an initializer eagerly (no startup program in dygraph)."""
    import math

    from .. import initializer as I

    if initializer is None:
        initializer = XavierInitializer()
    if isinstance(initializer, I.ConstantInitializer):
        return np.full(shape, initializer.value, dtype=dtype)
    if isinstance(initializer, I.UniformInitializer):
        return rng.uniform(initializer.low, initializer.high, shape).astype(dtype)
    if isinstance(initializer, I.NormalInitializer):
        return rng.normal(initializer.loc, initializer.scale, shape).astype(dtype)
    if isinstance(initializer, I.TruncatedNormalInitializer):
        v = rng.normal(initializer.loc, initializer.scale, shape)
        return np.clip(v, initializer.loc - 2 * initializer.scale,
                       initializer.loc + 2 * initializer.scale).astype(dtype)
    if isinstance(initializer, I.XavierInitializer):
        fan_in, fan_out = I._fans(_Shape(shape), initializer.fan_in, initializer.fan_out)
        if initializer.uniform:
            limit = math.sqrt(6.0 / (fan_in + fan_out))
            return rng.uniform(-limit, limit, shape).astype(dtype)
        return rng.normal(0, math.sqrt(2.0 / (fan_in + fan_out)), shape).astype(dtype)
    if isinstance(initializer, I.MSRAInitializer):
        fan_in, _ = I._fans(_Shape(shape), initializer.fan_in, None)
        if initializer.uniform:
            limit = math.sqrt(6.0 / fan_in)
            return rng.uniform(-limit, limit, shape).astype(dtype)
        return rng.normal(0, math.sqrt(2.0 / fan_in), shape).astype(dtype)
    if isinstance(initializer, I.NumpyArrayInitializer):
        return initializer.value.astype(dtype)
    raise TypeError(f"unsupported initializer {type(initializer)}")


class _Shape:
    def __init__(self, shape):
        self.shape = tuple(shape)


class Layer:
    """reference: dygraph/layers.py Layer."""

    def __init__(self, name_scope: Optional[str] = None, dtype="float32"):
        self._full_name = name_scope or self.__class__.__name__.lower()
        self._dtype = dtype
        self._parameters: "OrderedDict[str, VarBase]" = OrderedDict()
        self._sub_layers: "OrderedDict[str, Layer]" = OrderedDict()
        self._rng = np.random.RandomState(abs(hash(self._full_name)) % (2**31))
        self.training = True

    def full_name(self):
        return self._full_name

    def create_parameter(self, shape, attr=None, dtype=None, is_bias=False,
                         default_initializer=None) -> VarBase:
        attr = ParamAttr._to_attr(attr)
        dtype = dtype or self._dtype
        init = attr.initializer or default_initializer or (
            ConstantInitializer(0.0) if is_bias else XavierInitializer())
        value = _init_numpy(init, shape, dtype, self._rng)
        name = attr.name or f"{self._full_name}_{'b' if is_bias else 'w'}_{len(self._parameters)}"
        p = VarBase(value, name=name, persistable=True, trainable=attr.trainable)
        p.stop_gradient = not attr.trainable
        # per-parameter regularizer travels with the VarBase so the eager
        # optimizer honors it like the static path (regularizer.py)
        p.regularizer = attr.regularizer
        return p

    def parameters(self, include_sublayers=True) -> List[VarBase]:
        out = list(self._parameters.values())
        if include_sublayers:
            for l in self._sub_layers.values():
                out.extend(l.parameters())
        return out

    def named_parameters(self, prefix=""):
        for k, v in self._parameters.items():
            yield (f"{prefix}{k}", v)
        for name, l in self._sub_layers.items():
            yield from l.named_parameters(prefix=f"{prefix}{name}.")

    def sublayers(self, include_sublayers=True):
        out = list(self._sub_layers.values())
        if include_sublayers:
            for l in self._sub_layers.values():
                out.extend(l.sublayers())
        return out

    def train(self):
        self.training = True
        from .tracer import get_tracer

        get_tracer().train_mode = True
        for l in self._sub_layers.values():
            l.train()

    def eval(self):
        self.training = False
        from .tracer import get_tracer

        get_tracer().train_mode = False
        for l in self._sub_layers.values():
            l.eval()

    def clear_gradients(self):
        for p in self.parameters():
            p.clear_gradient()

    def state_dict(self, destination=None, include_sublayers=True, prefix=""):
        destination = destination if destination is not None else OrderedDict()
        for name, p in self.named_parameters(prefix):
            destination[name] = p.numpy()
        return destination

    def set_dict(self, state_dict, include_sublayers=True):
        for name, p in self.named_parameters():
            if name in state_dict:
                p.set_value(state_dict[name])

    load_dict = set_dict

    def forward(self, *inputs, **kwargs):
        raise NotImplementedError

    def __call__(self, *inputs, **kwargs):
        return self.forward(*inputs, **kwargs)

    def add_sublayer(self, name, sublayer):
        self._sub_layers[name] = sublayer
        return sublayer

    def add_parameter(self, name, parameter):
        self._parameters[name] = parameter
        return parameter

    def __setattr__(self, name, value):
        if isinstance(value, VarBase) and getattr(value, "persistable", False):
            self.__dict__.setdefault("_parameters", OrderedDict())[name] = value
        elif isinstance(value, Layer):
            self.__dict__.setdefault("_sub_layers", OrderedDict())[name] = value
        object.__setattr__(self, name, value)
