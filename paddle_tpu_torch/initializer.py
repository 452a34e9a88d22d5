# Copied from the JAX package: paddle_tpu/initializer.py
# Keep it in step with that file (tests/test_torch_imports.py).
"""Initializers — append init ops to the startup program
(reference: python/paddle/fluid/initializer.py)."""

from __future__ import annotations

import math

import numpy as np

from .core.framework import Variable


class Initializer:
    def __call__(self, var: Variable, block):
        raise NotImplementedError


class ConstantInitializer(Initializer):
    def __init__(self, value: float = 0.0):
        self.value = value

    def __call__(self, var, block):
        block.append_op(
            type="fill_constant", outputs={"Out": var},
            attrs={"shape": list(var.shape), "dtype": var.dtype, "value": self.value})


class UniformInitializer(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self.low, self.high, self.seed = low, high, seed

    def __call__(self, var, block):
        block.append_op(
            type="uniform_random", outputs={"Out": var},
            attrs={"shape": list(var.shape), "dtype": var.dtype,
                   "min": self.low, "max": self.high, "seed": self.seed})


class NormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        block.append_op(
            type="gaussian_random", outputs={"Out": var},
            attrs={"shape": list(var.shape), "dtype": var.dtype,
                   "mean": self.loc, "std": self.scale, "seed": self.seed})


class TruncatedNormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        block.append_op(
            type="truncated_gaussian_random", outputs={"Out": var},
            attrs={"shape": list(var.shape), "dtype": var.dtype,
                   "mean": self.loc, "std": self.scale, "seed": self.seed})


def _fans(var, fan_in=None, fan_out=None):
    shape = var.shape
    if len(shape) < 2:
        f_in = f_out = float(shape[0]) if shape else 1.0
    else:
        receptive = int(np.prod(shape[2:])) if len(shape) > 2 else 1
        f_in = shape[1] * receptive
        f_out = shape[0] * receptive
    return fan_in or f_in, fan_out or f_out


class XavierInitializer(Initializer):
    """reference: initializer.py XavierInitializer (Glorot)."""

    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self.uniform, self.fan_in, self.fan_out, self.seed = uniform, fan_in, fan_out, seed

    def __call__(self, var, block):
        f_in, f_out = _fans(var, self.fan_in, self.fan_out)
        if self.uniform:
            limit = math.sqrt(6.0 / (f_in + f_out))
            UniformInitializer(-limit, limit, self.seed)(var, block)
        else:
            std = math.sqrt(2.0 / (f_in + f_out))
            NormalInitializer(0.0, std, self.seed)(var, block)


class MSRAInitializer(Initializer):
    """reference: initializer.py MSRAInitializer (He)."""

    def __init__(self, uniform=True, fan_in=None, seed=0):
        self.uniform, self.fan_in, self.seed = uniform, fan_in, seed

    def __call__(self, var, block):
        f_in, _ = _fans(var, self.fan_in, None)
        if self.uniform:
            limit = math.sqrt(6.0 / f_in)
            UniformInitializer(-limit, limit, self.seed)(var, block)
        else:
            std = math.sqrt(2.0 / f_in)
            NormalInitializer(0.0, std, self.seed)(var, block)


class BilinearInitializer(Initializer):
    """reference: initializer.py BilinearInitializer (upsample deconv)."""

    def __call__(self, var, block):
        shape = var.shape
        if len(shape) != 4:
            raise ValueError("BilinearInitializer expects a 4-D filter")
        f = math.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        weight = np.zeros(shape, dtype="float32")
        for i in range(np.prod(shape)):
            x = i % shape[3]
            y = (i // shape[3]) % shape[2]
            idx = np.unravel_index(i, shape)
            weight[idx] = (1 - abs(x / f - c)) * (1 - abs(y / f - c))
        NumpyArrayInitializer(weight)(var, block)


class NumpyArrayInitializer(Initializer):
    def __init__(self, value: np.ndarray):
        self.value = np.asarray(value)

    def __call__(self, var, block):
        vals = self.value.astype(np.float32 if "float" in var.dtype else np.int32)
        block.append_op(
            type="assign_value", outputs={"Out": var},
            attrs={"shape": list(self.value.shape), "dtype": var.dtype,
                   "fp32_values": vals.reshape(-1).tolist()})


# reference-compat aliases (initializer.py bottom)
Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
TruncatedNormal = TruncatedNormalInitializer
Xavier = XavierInitializer
MSRA = MSRAInitializer
Bilinear = BilinearInitializer


def force_init_on_cpu():
    return False
