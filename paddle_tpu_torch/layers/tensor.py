# Copied from the JAX package: paddle_tpu/layers/tensor.py
# Keep it in step with that file (tests/test_torch_imports.py).
"""Tensor layers (reference: python/paddle/fluid/layers/tensor.py)."""

from __future__ import annotations

import numpy as np

from ..core.framework import Variable
from ..layer_helper import LayerHelper

__all__ = [
    "create_tensor", "create_parameter", "create_global_var", "cast",
    "concat", "sums", "assign", "fill_constant",
    "fill_constant_batch_size_like", "ones", "zeros", "ones_like",
    "zeros_like", "reverse", "range", "linspace", "argmax", "argmin",
    "argsort", "has_inf", "has_nan", "isfinite", "diag", "eye",
    "sum", "rank", "size", "is_empty", "scatter_nd", "uniform_random",
    "gaussian_random", "load", "get_tensor_from_selected_rows",
    "merge_selected_rows",
]


def create_tensor(dtype, name=None, persistable=False):
    helper = LayerHelper("create_tensor", name=name)
    return helper.create_variable(name=helper.name, dtype=dtype, persistable=persistable)


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    helper = LayerHelper("create_parameter", name=name)
    from ..param_attr import ParamAttr

    attr = ParamAttr._to_attr(attr)
    if name is not None and attr.name is None:
        attr.name = name
    return helper.create_parameter(attr, shape, dtype, is_bias, default_initializer)


def create_global_var(shape, value, dtype, persistable=False, force_cpu=False, name=None):
    helper = LayerHelper("global_var", name=name)
    var = helper.main_program.global_block().create_var(
        name=helper.name, shape=shape, dtype=dtype, persistable=persistable)
    sb = helper.startup_program.global_block()
    svar = sb.create_var(name=var.name, shape=shape, dtype=dtype, persistable=persistable)
    sb.append_op(type="fill_constant", outputs={"Out": svar},
                 attrs={"shape": list(shape), "dtype": dtype, "value": float(value)})
    return var


def cast(x, dtype):
    helper = LayerHelper("cast")
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="cast", inputs={"X": x}, outputs={"Out": out},
                     attrs={"in_dtype": x.dtype, "out_dtype": dtype})
    return out


def concat(input, axis=0, name=None):
    helper = LayerHelper("concat", name=name)
    first = input[0] if isinstance(input, (list, tuple)) else input
    out = helper.create_variable_for_type_inference(first.dtype)
    helper.append_op(type="concat", inputs={"X": input}, outputs={"Out": out},
                     attrs={"axis": axis})
    return out


def sums(input, out=None):
    helper = LayerHelper("sum")
    if out is None:
        out = helper.create_variable_for_type_inference(helper.input_dtype("input"))
    helper.kwargs["input"] = input
    helper.append_op(type="sum", inputs={"X": input}, outputs={"Out": out})
    return out


def assign(input, output=None):
    helper = LayerHelper("assign")
    if isinstance(input, np.ndarray):
        if output is None:
            output = helper.create_variable_for_type_inference(str(input.dtype))
        helper.append_op(type="assign_value", outputs={"Out": output},
                         attrs={"shape": list(input.shape), "dtype": str(input.dtype),
                                "fp32_values": input.astype(np.float32).reshape(-1).tolist()})
        return output
    if output is None:
        output = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="assign", inputs={"X": input}, outputs={"Out": output})
    return output


def fill_constant(shape, dtype, value, force_cpu=False, out=None):
    helper = LayerHelper("fill_constant")
    if out is None:
        out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="fill_constant", outputs={"Out": out},
                     attrs={"shape": list(shape), "dtype": dtype, "value": float(value)})
    out.stop_gradient = True
    return out


def fill_constant_batch_size_like(input, shape, dtype, value,
                                  input_dim_idx=0, output_dim_idx=0):
    helper = LayerHelper("fill_constant_batch_size_like")
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="fill_constant_batch_size_like",
                     inputs={"Input": input}, outputs={"Out": out},
                     attrs={"shape": list(shape), "dtype": dtype, "value": float(value),
                            "input_dim_idx": input_dim_idx, "output_dim_idx": output_dim_idx})
    out.stop_gradient = True
    return out


def ones(shape, dtype="float32", force_cpu=False):
    return fill_constant(shape, dtype, 1.0)


def zeros(shape, dtype="float32", force_cpu=False):
    return fill_constant(shape, dtype, 0.0)


def ones_like(x, out=None):
    helper = LayerHelper("ones_like")
    if out is None:
        out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="fill_constant_batch_size_like", inputs={"Input": x},
                     outputs={"Out": out},
                     attrs={"shape": list(x.shape), "dtype": x.dtype, "value": 1.0})
    return out


def zeros_like(x, out=None):
    helper = LayerHelper("zeros_like")
    if out is None:
        out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="fill_zeros_like", inputs={"X": x}, outputs={"Out": out})
    return out


def reverse(x, axis):
    helper = LayerHelper("reverse")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="reverse", inputs={"X": x}, outputs={"Out": out},
                     attrs={"axis": [axis] if isinstance(axis, int) else list(axis)})
    return out


def range(start, end, step, dtype="int64"):
    helper = LayerHelper("range")
    s = fill_constant([1], dtype, start) if not isinstance(start, Variable) else start
    e = fill_constant([1], dtype, end) if not isinstance(end, Variable) else end
    st = fill_constant([1], dtype, step) if not isinstance(step, Variable) else step
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="range", inputs={"Start": s, "End": e, "Step": st},
                     outputs={"Out": out})
    return out


def linspace(start, stop, num, dtype="float32"):
    helper = LayerHelper("linspace")
    s = fill_constant([1], dtype, start) if not isinstance(start, Variable) else start
    e = fill_constant([1], dtype, stop) if not isinstance(stop, Variable) else stop
    n = fill_constant([1], "int32", num) if not isinstance(num, Variable) else num
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="linspace", inputs={"Start": s, "Stop": e, "Num": n},
                     outputs={"Out": out}, attrs={"dtype": dtype})
    return out


def argmax(x, axis=0):
    helper = LayerHelper("arg_max")
    out = helper.create_variable_for_type_inference("int64")
    helper.append_op(type="arg_max", inputs={"X": x}, outputs={"Out": out},
                     attrs={"axis": axis})
    return out


def argmin(x, axis=0):
    helper = LayerHelper("arg_min")
    out = helper.create_variable_for_type_inference("int64")
    helper.append_op(type="arg_min", inputs={"X": x}, outputs={"Out": out},
                     attrs={"axis": axis})
    return out


def argsort(input, axis=-1, descending=False, name=None):
    helper = LayerHelper("argsort", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    ids = helper.create_variable_for_type_inference("int64")
    helper.append_op(type="argsort", inputs={"X": input},
                     outputs={"Out": out, "Indices": ids},
                     attrs={"axis": axis, "descending": descending})
    return out, ids


def has_inf(x):
    helper = LayerHelper("isinf")
    out = helper.create_variable_for_type_inference("bool")
    helper.append_op(type="isinf", inputs={"X": x}, outputs={"Out": out})
    return out


def has_nan(x):
    helper = LayerHelper("isnan")
    out = helper.create_variable_for_type_inference("bool")
    helper.append_op(type="isnan", inputs={"X": x}, outputs={"Out": out})
    return out


def isfinite(x):
    helper = LayerHelper("isfinite")
    out = helper.create_variable_for_type_inference("bool")
    helper.append_op(type="isfinite", inputs={"X": x}, outputs={"Out": out})
    return out


def diag(diagonal):
    helper = LayerHelper("diag")
    out = helper.create_variable_for_type_inference(diagonal.dtype)
    helper.append_op(type="diag", inputs={"Diagonal": diagonal}, outputs={"Out": out})
    return out


def eye(num_rows, num_columns=None, batch_shape=None, dtype="float32"):
    helper = LayerHelper("eye")
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="eye", outputs={"Out": out},
                     attrs={"num_rows": num_rows,
                            "num_columns": num_columns or num_rows, "dtype": dtype})
    return out


def sum(x):
    """reference: layers/tensor.py `sum` → sum op (elementwise sum of a
    var list)."""
    helper = LayerHelper("sum")
    xs = list(x) if isinstance(x, (list, tuple)) else [x]
    out = helper.create_variable_for_type_inference(xs[0].dtype)
    helper.append_op(type="sum", inputs={"X": xs}, outputs={"Out": out})
    return out


def rank(input):
    """reference: layers/nn.py `rank` — the (static) dimensionality as a
    0-d... shape-[1] int32 constant."""
    return fill_constant(shape=[1], dtype="int32", value=len(input.shape))


def size(input):
    """reference: layers/nn.py `size` → size op (runtime element count —
    the static shape may carry a -1 batch dim)."""
    helper = LayerHelper("size")
    out = helper.create_variable_for_type_inference("int64")
    helper.append_op(type="size", inputs={"Input": input},
                     outputs={"Out": out})
    return out


def is_empty(x, cond=None):
    """reference: layers/control_flow.py `is_empty` → is_empty op."""
    helper = LayerHelper("is_empty")
    out = cond or helper.create_variable_for_type_inference("bool")
    helper.append_op(type="is_empty", inputs={"X": x},
                     outputs={"Out": out})
    return out


def scatter_nd(index, updates, shape, name=None):
    """reference: layers/nn.py `scatter_nd` — scatter_nd_add into a zero
    tensor of `shape`."""
    zero = zeros(list(shape), dtype=updates.dtype)
    helper = LayerHelper("scatter_nd", name=name)
    out = helper.create_variable_for_type_inference(updates.dtype)
    helper.append_op(type="scatter_nd_add",
                     inputs={"X": zero, "Index": index,
                             "Updates": updates},
                     outputs={"Out": out})
    return out


def uniform_random(shape, dtype="float32", min=-1.0, max=1.0, seed=0):
    """reference: layers/ops.py `uniform_random` op."""
    helper = LayerHelper("uniform_random")
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="uniform_random", inputs={},
                     outputs={"Out": out},
                     attrs={"shape": list(shape), "min": float(min),
                            "max": float(max), "seed": int(seed),
                            "dtype": dtype})
    return out


def gaussian_random(shape, mean=0.0, std=1.0, seed=0, dtype="float32"):
    """reference: layers/ops.py `gaussian_random` op."""
    helper = LayerHelper("gaussian_random")
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="gaussian_random", inputs={},
                     outputs={"Out": out},
                     attrs={"shape": list(shape), "mean": float(mean),
                            "std": float(std), "seed": int(seed),
                            "dtype": dtype})
    return out


def load(out, file_path, load_as_fp16=None):
    """reference: layers/io `load` → load op: fill `out` from a
    save_vars-format .npy file at run time."""
    helper = LayerHelper("load")
    helper.append_op(type="load", inputs={}, outputs={"Out": out},
                     attrs={"file_path": file_path})
    return out


def get_tensor_from_selected_rows(x, name=None):
    """reference: get_tensor_from_selected_rows_op.cc. SelectedRows are
    DENSE in this framework (PARITY.md §2.1: gradients are dense on TPU;
    only the PS sparse table is truly sparse), so this is the identity."""
    return x


def merge_selected_rows(x, name=None):
    """reference: merge_selected_rows_op.cc — merges duplicate rows of a
    SelectedRows. Dense tensors have no duplicate-row encoding, so this
    is the identity (the scatter-add that produced the dense grad already
    merged)."""
    return x
