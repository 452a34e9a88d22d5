# Copied from the JAX package: paddle_tpu/layers/distributions.py
# Keep it in step with that file (tests/test_torch_imports.py).
"""Probability distributions (reference:
python/paddle/fluid/layers/distributions.py — Uniform, Normal,
Categorical, MultivariateNormalDiag built over graph ops; same API
here: sample/entropy/log_prob/kl_divergence where the reference defines
them)."""

from __future__ import annotations

import math

from ..layer_helper import LayerHelper
from . import nn as _nn
from . import tensor as _tensor

__all__ = ["Uniform", "Normal", "Categorical", "MultivariateNormalDiag"]


def _as_var(v, like=None, dtype="float32"):
    if hasattr(v, "name"):
        return v
    import numpy as np

    arr = np.asarray(v, np.float32)
    helper = LayerHelper("dist_const")
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="assign_value", inputs={}, outputs={"Out": out},
                     attrs={"shape": list(arr.shape) or [1],
                            "values": arr.reshape(-1).tolist(),
                            "dtype": dtype})
    return out


class Uniform:
    """reference: distributions.py `Uniform(low, high)`."""

    def __init__(self, low, high):
        self.low = _as_var(low)
        self.high = _as_var(high)

    def sample(self, shape, seed=0):
        u = _tensor.uniform_random(list(shape), min=0.0, max=1.0,
                                   seed=seed)
        return self.low + (self.high - self.low) * u

    def entropy(self):
        return _log(self.high - self.low)

    def log_prob(self, value):
        lb = _tensor.cast(_greater(value, self.low), value.dtype)
        ub = _tensor.cast(_less(value, self.high), value.dtype)
        return _log(lb * ub) - _log(self.high - self.low)


class Normal:
    """reference: distributions.py `Normal(loc, scale)`."""

    def __init__(self, loc, scale):
        self.loc = _as_var(loc)
        self.scale = _as_var(scale)

    def sample(self, shape, seed=0):
        z = _tensor.gaussian_random(list(shape), mean=0.0, std=1.0,
                                    seed=seed)
        return self.loc + self.scale * z

    def entropy(self):
        c = 0.5 + 0.5 * math.log(2.0 * math.pi)
        return c + _log(self.scale)

    def log_prob(self, value):
        var = self.scale * self.scale
        log_scale = _log(self.scale)
        return (-1.0 * ((value - self.loc) * (value - self.loc))
                / (2.0 * var) - log_scale
                - math.log(math.sqrt(2.0 * math.pi)))

    def kl_divergence(self, other):
        var_ratio = self.scale / other.scale
        var_ratio = var_ratio * var_ratio
        t1 = (self.loc - other.loc) / other.scale
        t1 = t1 * t1
        return 0.5 * (var_ratio + t1 - 1.0 - _log(var_ratio))


class Categorical:
    """reference: distributions.py `Categorical(logits)`."""

    def __init__(self, logits):
        self.logits = logits

    def _probs(self):
        return _nn.softmax(self.logits)

    def entropy(self):
        p = self._probs()
        lp = _nn.log_softmax(self.logits)
        return 0.0 - _nn.reduce_sum(p * lp, dim=[-1])

    def kl_divergence(self, other):
        p = self._probs()
        lp = _nn.log_softmax(self.logits)
        lq = _nn.log_softmax(other.logits)
        return _nn.reduce_sum(p * (lp - lq), dim=[-1])


class MultivariateNormalDiag:
    """reference: distributions.py `MultivariateNormalDiag(loc, scale)` —
    scale is the DIAGONAL covariance-... scale matrix; only entropy and
    kl_divergence, like the reference."""

    def __init__(self, loc, scale):
        self.loc = loc
        self.scale = scale          # [D, D] diagonal matrix var

    def _det(self):
        # product of the diagonal (the reference uses reduce_prod of
        # the diag); here: sum of logs is numerically safer but match
        # the reference's determinant contract
        d = _diag_part(self.scale)
        return _reduce_prod(d)

    def entropy(self):
        k = float(self.loc.shape[-1])
        return 0.5 * (k * (math.log(2.0 * math.pi) + 1.0)
                      + _log(self._det()))

    def kl_divergence(self, other):
        k = float(self.loc.shape[-1])
        d_self = _diag_part(self.scale)
        d_other = _diag_part(other.scale)
        tr = _nn.reduce_sum(d_self / d_other, dim=[0])
        diff = other.loc - self.loc
        md = _nn.reduce_sum(diff * diff / d_other, dim=[-1])
        return 0.5 * (tr + md - k + _log(_reduce_prod(d_other))
                      - _log(_reduce_prod(d_self)))


def _log(v):
    helper = LayerHelper("dist_log")
    out = helper.create_variable_for_type_inference(v.dtype)
    helper.append_op(type="log", inputs={"X": v}, outputs={"Out": out})
    return out


def _greater(a, b):
    helper = LayerHelper("dist_gt")
    out = helper.create_variable_for_type_inference("bool")
    helper.append_op(type="greater_than", inputs={"X": a, "Y": b},
                     outputs={"Out": out})
    return out


def _less(a, b):
    helper = LayerHelper("dist_lt")
    out = helper.create_variable_for_type_inference("bool")
    helper.append_op(type="less_than", inputs={"X": a, "Y": b},
                     outputs={"Out": out})
    return out


def _diag_part(m):
    helper = LayerHelper("dist_diagpart")
    out = helper.create_variable_for_type_inference(m.dtype)
    helper.append_op(type="diag_part", inputs={"X": m},
                     outputs={"Out": out})
    return out


def _reduce_prod(v):
    helper = LayerHelper("dist_prod")
    out = helper.create_variable_for_type_inference(v.dtype)
    helper.append_op(type="reduce_prod", inputs={"X": v},
                     outputs={"Out": out}, attrs={"reduce_all": True})
    return out
