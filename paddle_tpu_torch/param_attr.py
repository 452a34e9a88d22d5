# Copied from the JAX package: paddle_tpu/param_attr.py
# Keep it in step with that file (tests/test_torch_imports.py).
"""ParamAttr (reference: python/paddle/fluid/param_attr.py)."""

from __future__ import annotations

from typing import Optional


class ParamAttr:
    def __init__(self, name: Optional[str] = None, initializer=None,
                 learning_rate: float = 1.0, regularizer=None,
                 trainable: bool = True, do_model_average: bool = False,
                 need_clip: bool = True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(arg) -> "ParamAttr":
        if arg is None:
            return ParamAttr()
        if isinstance(arg, (list, tuple)):
            return [ParamAttr._to_attr(a) for a in arg]
        if isinstance(arg, ParamAttr):
            return arg
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        if isinstance(arg, bool):
            return ParamAttr() if arg else ParamAttr(trainable=False)
        from .initializer import Initializer

        if isinstance(arg, Initializer):
            return ParamAttr(initializer=arg)
        raise TypeError(f"cannot make ParamAttr from {type(arg)}")


class WeightNormParamAttr(ParamAttr):
    """reference: param_attr.py WeightNormParamAttr — weight normalization
    reparameterization w = g * v / ||v||."""

    def __init__(self, dim=None, **kwargs):
        super().__init__(**kwargs)
        self.dim = dim
