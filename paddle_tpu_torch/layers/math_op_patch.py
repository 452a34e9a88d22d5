# Copied from the JAX package: paddle_tpu/layers/math_op_patch.py
# Keep it in step with that file (tests/test_torch_imports.py).
"""Operator-overload sugar on Variable (reference:
python/paddle/fluid/layers/math_op_patch.py monkey_patch_variable)."""

from __future__ import annotations

from ..core.framework import Variable
from ..layer_helper import LayerHelper


def _binary(op_type, reverse=False):
    def impl(self, other):
        from . import tensor as _tensor

        if not isinstance(other, Variable):
            other = _tensor.fill_constant([1], self.dtype, float(other))
        x, y = (other, self) if reverse else (self, other)
        helper = LayerHelper(op_type)
        out = helper.create_variable_for_type_inference(x.dtype)
        helper.append_op(type=op_type, inputs={"X": x, "Y": y},
                         outputs={"Out": out}, attrs={"axis": -1})
        return out

    return impl


def _neg(self):
    helper = LayerHelper("scale")
    out = helper.create_variable_for_type_inference(self.dtype)
    helper.append_op(type="scale", inputs={"X": self}, outputs={"Out": out},
                     attrs={"scale": -1.0, "bias": 0.0, "bias_after_scale": True})
    return out


def monkey_patch_variable():
    Variable.__add__ = _binary("elementwise_add")
    Variable.__radd__ = _binary("elementwise_add", reverse=True)
    Variable.__sub__ = _binary("elementwise_sub")
    Variable.__rsub__ = _binary("elementwise_sub", reverse=True)
    Variable.__mul__ = _binary("elementwise_mul")
    Variable.__rmul__ = _binary("elementwise_mul", reverse=True)
    Variable.__truediv__ = _binary("elementwise_div")
    Variable.__rtruediv__ = _binary("elementwise_div", reverse=True)
    Variable.__pow__ = _binary("elementwise_pow")
    Variable.__mod__ = _binary("elementwise_mod")
    Variable.__floordiv__ = _binary("elementwise_floordiv")
    Variable.__lt__ = _binary("less_than")
    Variable.__le__ = _binary("less_equal")
    Variable.__gt__ = _binary("greater_than")
    Variable.__ge__ = _binary("greater_equal")
    Variable.__neg__ = _neg
