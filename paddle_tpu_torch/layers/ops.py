# Copied from the JAX package: paddle_tpu/layers/ops.py
# Keep it in step with that file (tests/test_torch_imports.py).
"""Auto-generated thin layers over registered ops (reference:
python/paddle/fluid/layers/ops.py via layer_function_generator.py — layers
generated from OpProtos; here generated from the op registry)."""

from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = []

_UNARY_OPS = [
    "sigmoid", "logsigmoid", "exp", "tanh", "tanh_shrink", "softplus",
    "softsign", "sqrt", "rsqrt", "abs", "ceil", "floor", "cos", "sin",
    "tan", "acos", "asin", "atan", "sinh", "cosh", "round", "reciprocal",
    "square", "log", "relu", "selu", "erf", "silu", "mish", "sign",
]


def _make_unary(op_type):
    def layer(x, name=None):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(x.dtype)
        helper.append_op(type=op_type, inputs={"X": x}, outputs={"Out": out})
        return out

    layer.__name__ = op_type
    layer.__doc__ = f"Elementwise {op_type} (reference: operators/activation_op.cc)."
    return layer


for _op in _UNARY_OPS:
    globals()[_op] = _make_unary(_op)
    __all__.append(_op)


def _make_unary_attr(op_type, attr_names):
    def layer(x, *args, name=None, **kwargs):
        attrs = dict(zip(attr_names, args))
        for k, v in kwargs.items():
            if k in attr_names:
                attrs[k] = v
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(x.dtype)
        helper.append_op(type=op_type, inputs={"X": x}, outputs={"Out": out}, attrs=attrs)
        return out

    layer.__name__ = op_type
    return layer


leaky_relu = _make_unary_attr("leaky_relu", ["alpha"])
elu = _make_unary_attr("elu", ["alpha"])
relu6 = _make_unary_attr("relu6", ["threshold"])
brelu = _make_unary_attr("brelu", ["t_min", "t_max"])
pow = _make_unary_attr("pow", ["factor"])
stanh = _make_unary_attr("stanh", ["scale_a", "scale_b"])
hard_sigmoid = _make_unary_attr("hard_sigmoid", ["slope", "offset"])
hard_swish = _make_unary_attr("hard_swish", ["threshold", "scale", "offset"])
swish = _make_unary_attr("swish", ["beta"])
softshrink = _make_unary_attr("softshrink", ["lambda"])
hard_shrink = _make_unary_attr("hard_shrink", ["threshold"])
thresholded_relu = _make_unary_attr("thresholded_relu", ["threshold"])
gelu = _make_unary_attr("gelu", ["approximate"])
cumsum = _make_unary_attr("cumsum", ["axis", "exclusive", "reverse"])

__all__ += ["leaky_relu", "elu", "relu6", "brelu", "pow", "stanh",
            "hard_sigmoid", "hard_swish", "swish", "softshrink", "hard_shrink",
            "thresholded_relu", "gelu", "cumsum"]


def _make_binary(op_type, out_slot="Out"):
    def layer(x, y, axis=-1, act=None, name=None):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(x.dtype)
        helper.append_op(type=op_type, inputs={"X": x, "Y": y},
                         outputs={out_slot: out}, attrs={"axis": axis})
        return helper.append_activation(out, act)

    layer.__name__ = op_type
    return layer


for _op in ["elementwise_add", "elementwise_sub", "elementwise_mul",
            "elementwise_div", "elementwise_max", "elementwise_min",
            "elementwise_pow", "elementwise_mod", "elementwise_floordiv"]:
    globals()[_op] = _make_binary(_op)
    __all__.append(_op)


def _make_compare(op_type):
    def layer(x, y, cond=None):
        helper = LayerHelper(op_type)
        out = cond or helper.create_variable_for_type_inference("bool")
        helper.append_op(type=op_type, inputs={"X": x, "Y": y}, outputs={"Out": out})
        return out

    layer.__name__ = op_type
    return layer


for _op in ["equal", "not_equal", "less_than", "less_equal", "greater_than",
            "greater_equal", "logical_and", "logical_or", "logical_xor"]:
    globals()[_op] = _make_compare(_op)
    __all__.append(_op)


def logical_not(x, out=None, name=None):
    helper = LayerHelper("logical_not", name=name)
    out = out or helper.create_variable_for_type_inference("bool")
    helper.append_op(type="logical_not", inputs={"X": x}, outputs={"Out": out})
    return out


__all__.append("logical_not")
