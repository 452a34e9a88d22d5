# Copied from the JAX package: paddle_tpu/layer_helper.py
# Keep it in step with that file (tests/test_torch_imports.py).
"""LayerHelper (reference: python/paddle/fluid/layer_helper.py:42) — shared
machinery for layers: parameter creation (init ops go to the startup
program), bias/activation appending, dtype plumbing."""

from __future__ import annotations

from typing import Optional

from .core import framework
from .core.framework import Variable, unique_name
from .initializer import ConstantInitializer, XavierInitializer
from .param_attr import ParamAttr


class LayerHelper:
    def __init__(self, layer_type: str, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        name = kwargs.get("name")
        self.name = name if name is not None else unique_name.generate(layer_type)

    @property
    def main_program(self):
        return framework.default_main_program()

    @property
    def startup_program(self):
        return framework.default_startup_program()

    def append_op(self, *args, **kwargs):
        return self.main_program.current_block().append_op(*args, **kwargs)

    def create_variable_for_type_inference(self, dtype, stop_gradient=False) -> Variable:
        return self.main_program.current_block().create_var(
            name=unique_name.generate(".".join([self.name, "tmp"])),
            dtype=dtype, stop_gradient=stop_gradient)

    def create_variable(self, *args, **kwargs):
        return self.main_program.current_block().create_var(*args, **kwargs)

    def create_parameter(self, attr, shape, dtype="float32", is_bias=False,
                         default_initializer=None, stop_gradient=False):
        attr = ParamAttr._to_attr(attr)
        if attr is False or (isinstance(attr, ParamAttr) and not attr.trainable and attr.name is None
                             and attr.initializer is None and is_bias and self.kwargs.get("bias_attr") is False):
            return None
        suffix = "b" if is_bias else "w"
        name = attr.name or unique_name.generate(".".join([self.name, suffix]))
        if default_initializer is None:
            default_initializer = (ConstantInitializer(0.0) if is_bias
                                   else XavierInitializer())
        init = attr.initializer or default_initializer

        # main-program parameter (the var the ops read)
        param = self.main_program.global_block().create_parameter(
            name=name, shape=shape, dtype=dtype, trainable=attr.trainable,
            optimize_attr={"learning_rate": attr.learning_rate},
            regularizer=attr.regularizer, do_model_average=attr.do_model_average,
            need_clip=attr.need_clip)
        # startup-program twin + its init op (reference: LayerHelper
        # startup_program parameter creation)
        sb = self.startup_program.global_block()
        if not sb.has_var(name):
            svar = sb.create_parameter(
                name=name, shape=shape, dtype=dtype, trainable=attr.trainable)
            init(svar, sb)
        return param

    def get_parameter(self, name):
        return self.main_program.global_block().var(name)

    # -- common layer tails --------------------------------------------------

    def append_bias_op(self, input_var: Variable, dim_start=1, bias_attr=None,
                       num_flatten_dims=None) -> Variable:
        bias_attr = bias_attr if bias_attr is not None else self.kwargs.get("bias_attr")
        if bias_attr is False:
            return input_var
        size = list(input_var.shape[dim_start:])
        b = self.create_parameter(bias_attr, shape=size, dtype=input_var.dtype, is_bias=True)
        if b is None:
            return input_var
        out = self.create_variable_for_type_inference(input_var.dtype)
        self.append_op(
            type="elementwise_add", inputs={"X": input_var, "Y": b},
            outputs={"Out": out}, attrs={"axis": dim_start})
        return out

    def append_activation(self, input_var: Variable, act: Optional[str] = None) -> Variable:
        act = act if act is not None else self.kwargs.get("act")
        if act is None:
            return input_var
        out = self.create_variable_for_type_inference(input_var.dtype)
        self.append_op(type=act, inputs={"X": input_var}, outputs={"Out": out})
        return out

    def input_dtype(self, input_param_name="input"):
        val = self.kwargs.get(input_param_name)
        if isinstance(val, (list, tuple)):
            val = val[0]
        return val.dtype
