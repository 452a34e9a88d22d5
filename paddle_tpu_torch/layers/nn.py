# Copied from the JAX package: paddle_tpu/layers/nn.py
# Keep it in step with that file (tests/test_torch_imports.py).
"""Core NN layers (reference: python/paddle/fluid/layers/nn.py:39-300 lists
~250 functions; this module provides the model-zoo-covering subset and grows
with the zoo)."""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np

from ..core.framework import Variable
from ..layer_helper import LayerHelper
from ..initializer import ConstantInitializer, NormalInitializer, XavierInitializer

__all__ = [
    "fc", "embedding", "distributed_embedding", "box_embedding",
    "conv2d", "conv3d",
    "conv2d_transpose",
    "depthwise_conv2d", "deformable_conv", "pool2d", "pool3d", "adaptive_pool2d", "adaptive_pool3d", "batch_norm",
    "layer_norm", "group_norm", "instance_norm", "l2_normalize", "dropout",
    "softmax", "log_softmax", "matmul", "mul", "topk", "one_hot", "reshape",
    "transpose", "squeeze", "unsqueeze", "flatten", "split", "stack",
    "unstack", "expand", "expand_as", "slice", "strided_slice", "gather",
    "gather_nd", "scatter", "scatter_nd_add", "pad", "pad2d", "reduce_sum",
    "reduce_mean", "reduce_max", "reduce_min", "reduce_prod", "reduce_all",
    "reduce_any", "mean", "scale", "clip", "clip_by_norm", "maxout", "prelu",
    "relu", "image_resize", "resize_bilinear", "resize_nearest",
    "resize_trilinear",
    "label_smooth", "pixel_shuffle", "grid_sampler", "shape", "where",
    "unique", "shard_index", "temporal_shift",
    "squared_l2_norm", "linear_chain_crf", "crf_decoding", "chunk_eval",
    "mean_iou",
]


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, name=None):
    """Fully connected (reference: layers/nn.py `fc`) — lowers to `mul`
    (flatten+GEMM, operators/mul_op.cc) + bias + act; one MXU matmul."""
    helper = LayerHelper("fc", input=input, param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    inputs = input if isinstance(input, (list, tuple)) else [input]
    mul_results = []
    for inp in inputs:
        in_shape = inp.shape
        in_features = int(np.prod(in_shape[num_flatten_dims:]))
        w = helper.create_parameter(param_attr, shape=[in_features, size],
                                    dtype=inp.dtype)
        out = helper.create_variable_for_type_inference(inp.dtype)
        helper.append_op(type="mul", inputs={"X": inp, "Y": w},
                         outputs={"Out": out},
                         attrs={"x_num_col_dims": num_flatten_dims,
                                "y_num_col_dims": 1})
        mul_results.append(out)
    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:
        pre_bias = helper.create_variable_for_type_inference(inputs[0].dtype)
        helper.append_op(type="sum", inputs={"X": mul_results},
                         outputs={"Out": pre_bias})
    pre_act = helper.append_bias_op(pre_bias, dim_start=num_flatten_dims,
                                    bias_attr=bias_attr)
    return helper.append_activation(pre_act, act)


def distributed_embedding(input, size, table_name, sparse_lr=0.01,
                          dtype="float32", name=None):
    """Embedding whose table lives row-sharded on pservers (reference:
    distributed_lookup_table_op + parameter_prefetch). Rows prefetch in the
    forward; sparse SGD gradients push server-side in the backward. The
    table is created with ps.sparse_table.init_sparse_table; `size` is
    (vocab, dim). A trainable scalar shadow ties the remote table into the
    autodiff graph."""
    helper = LayerHelper("distributed_embedding", name=name)
    shadow = helper.create_parameter(
        None, shape=[1], dtype=dtype, is_bias=False,
        default_initializer=ConstantInitializer(0.0))
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="distributed_lookup_table",
        inputs={"Ids": input, "Shadow": shadow},
        outputs={"Out": out},
        attrs={"table_name": table_name, "emb_dim": int(size[1]),
               "sparse_lr": float(sparse_lr), "dtype": str(dtype)})
    return out


def box_embedding(input, size, table_name, sparse_lr=0.01,
                  dtype="float32", name=None):
    """Embedding served through the BoxPS-analogue hot-row cache
    (reference: pull_box_sparse_op.cc + fleet/box_wrapper.h): lookups hit
    the trainer-resident LRU (ps/box_cache.py) and only cache misses
    reach the pservers; gradients apply locally and flush to the PS
    asynchronously. Initialize with ps.sparse_table.init_sparse_table +
    ps.box_cache.init_box_cache; `size` is (vocab, dim)."""
    helper = LayerHelper("box_embedding", name=name)
    shadow = helper.create_parameter(
        None, shape=[1], dtype=dtype, is_bias=False,
        default_initializer=ConstantInitializer(0.0))
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="pull_box_sparse",
        inputs={"Ids": input, "Shadow": shadow},
        outputs={"Out": out},
        attrs={"table_name": table_name, "emb_dim": int(size[1]),
               "sparse_lr": float(sparse_lr), "dtype": str(dtype)})
    return out


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32"):
    """reference: layers/nn.py `embedding` → lookup_table_op. is_sparse
    selects SelectedRows gradients, exactly as in the reference: the W
    grad flows through the program as a (rows, ids) row-slice value
    (core/selected_rows.py) and the sgd/momentum/adam/adagrad kernels
    apply true row-sparse updates — no dense [V, D] grad is ever
    materialized. The PS path handles truly huge tables
    (distributed_embedding); box_embedding adds the hot-row cache."""
    helper = LayerHelper("embedding", param_attr=param_attr)
    w = helper.create_parameter(param_attr, shape=list(size), dtype=dtype)
    out = helper.create_variable_for_type_inference(dtype)
    pidx = -1 if padding_idx is None else (
        padding_idx if padding_idx >= 0 else size[0] + padding_idx)
    helper.append_op(type="lookup_table", inputs={"W": w, "Ids": input},
                     outputs={"Out": out},
                     attrs={"padding_idx": pidx, "is_sparse": is_sparse,
                            "is_distributed": is_distributed})
    return out


def _pair(v, n=2):
    if isinstance(v, (list, tuple)):
        return [int(x) for x in v]
    return [int(v)] * n


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, use_cudnn=True,
           act=None, name=None, data_format="NCHW"):
    """reference: layers/nn.py `conv2d` → conv2d op (+cudnn). use_cudnn is
    accepted and ignored (XLA owns the conv algorithm on TPU)."""
    helper = LayerHelper("conv2d", param_attr=param_attr, bias_attr=bias_attr,
                         act=act, name=name)
    num_channels = input.shape[1]
    fsize = _pair(filter_size)
    filter_shape = [num_filters, num_channels // groups] + fsize
    fan_in = (num_channels // groups) * fsize[0] * fsize[1]
    std = (2.0 / fan_in) ** 0.5
    w = helper.create_parameter(param_attr, shape=filter_shape, dtype=input.dtype,
                                default_initializer=NormalInitializer(0.0, std))
    out = helper.create_variable_for_type_inference(input.dtype)
    op_type = ("depthwise_conv2d"
               if groups == num_channels and num_filters % num_channels == 0 and groups > 1
               else "conv2d")
    helper.append_op(type=op_type, inputs={"Input": input, "Filter": w},
                     outputs={"Output": out},
                     attrs={"strides": _pair(stride), "paddings": _pair(padding),
                            "dilations": _pair(dilation), "groups": groups})
    pre_act = helper.append_bias_op(out, dim_start=1, bias_attr=bias_attr)
    return helper.append_activation(pre_act, act)


def depthwise_conv2d(input, num_filters, filter_size, **kw):
    return conv2d(input, num_filters, filter_size, groups=input.shape[1], **kw)


def deformable_conv(input, offset, mask, num_filters, filter_size, stride=1,
                    padding=0, dilation=1, groups=None,
                    deformable_groups=None, im2col_step=None,
                    param_attr=None, bias_attr=None, modulated=True,
                    name=None):
    """reference: layers/nn.py:15763 `deformable_conv` → deformable_conv
    (v2, modulated) or deformable_conv_v1 op. im2col_step is accepted and
    ignored (the XLA lowering gathers all taps in one fused computation)."""
    helper = LayerHelper("deformable_conv", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    groups = groups or 1
    deformable_groups = deformable_groups or 1
    num_channels = input.shape[1]
    fsize = _pair(filter_size)
    filter_shape = [num_filters, num_channels // groups] + fsize
    fan_in = (num_channels // groups) * fsize[0] * fsize[1]
    std = (2.0 / fan_in) ** 0.5
    w = helper.create_parameter(param_attr, shape=filter_shape,
                                dtype=input.dtype,
                                default_initializer=NormalInitializer(0.0, std))
    out = helper.create_variable_for_type_inference(input.dtype)
    inputs = {"Input": input, "Offset": offset, "Filter": w}
    op_type = "deformable_conv" if modulated else "deformable_conv_v1"
    if modulated:
        inputs["Mask"] = mask
    helper.append_op(type=op_type, inputs=inputs,
                     outputs={"Output": out},
                     attrs={"strides": _pair(stride),
                            "paddings": _pair(padding),
                            "dilations": _pair(dilation), "groups": groups,
                            "deformable_groups": deformable_groups,
                            "im2col_step": im2col_step or 64})
    return helper.append_bias_op(out, dim_start=1, bias_attr=bias_attr)


def conv3d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, use_cudnn=True,
           act=None, name=None):
    helper = LayerHelper("conv3d", param_attr=param_attr, bias_attr=bias_attr,
                         act=act, name=name)
    num_channels = input.shape[1]
    fsize = _pair(filter_size, 3)
    filter_shape = [num_filters, num_channels // groups] + fsize
    w = helper.create_parameter(param_attr, shape=filter_shape, dtype=input.dtype)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="conv3d", inputs={"Input": input, "Filter": w},
                     outputs={"Output": out},
                     attrs={"strides": _pair(stride, 3), "paddings": _pair(padding, 3),
                            "dilations": _pair(dilation, 3), "groups": groups})
    pre_act = helper.append_bias_op(out, dim_start=1, bias_attr=bias_attr)
    return helper.append_activation(pre_act, act)


def conv2d_transpose(input, num_filters, output_size=None, filter_size=None,
                     padding=0, stride=1, dilation=1, groups=1,
                     param_attr=None, bias_attr=None, use_cudnn=True,
                     act=None, name=None):
    helper = LayerHelper("conv2d_transpose", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    num_channels = input.shape[1]
    if filter_size is None:
        raise ValueError("filter_size required (output_size-only not yet supported)")
    fsize = _pair(filter_size)
    filter_shape = [num_channels, num_filters // groups] + fsize
    w = helper.create_parameter(param_attr, shape=filter_shape, dtype=input.dtype)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="conv2d_transpose", inputs={"Input": input, "Filter": w},
                     outputs={"Output": out},
                     attrs={"strides": _pair(stride), "paddings": _pair(padding),
                            "dilations": _pair(dilation), "groups": groups})
    pre_act = helper.append_bias_op(out, dim_start=1, bias_attr=bias_attr)
    return helper.append_activation(pre_act, act)


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1, pool_padding=0,
           global_pooling=False, use_cudnn=True, ceil_mode=False, name=None,
           exclusive=True, adaptive=False):
    helper = LayerHelper("pool2d", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="pool2d", inputs={"X": input}, outputs={"Out": out},
                     attrs={"pooling_type": pool_type, "ksize": _pair(pool_size),
                            "strides": _pair(pool_stride),
                            "paddings": _pair(pool_padding),
                            "global_pooling": global_pooling,
                            "ceil_mode": ceil_mode, "exclusive": exclusive,
                            "adaptive": adaptive})
    return out


def pool3d(input, pool_size=-1, pool_type="max", pool_stride=1, pool_padding=0,
           global_pooling=False, use_cudnn=True, ceil_mode=False, name=None,
           exclusive=True):
    helper = LayerHelper("pool3d", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="pool3d", inputs={"X": input}, outputs={"Out": out},
                     attrs={"pooling_type": pool_type, "ksize": _pair(pool_size, 3),
                            "strides": _pair(pool_stride, 3),
                            "paddings": _pair(pool_padding, 3),
                            "global_pooling": global_pooling})
    return out


def adaptive_pool2d(input, pool_size, pool_type="max", name=None):
    return pool2d(input, pool_size=pool_size, pool_type=pool_type,
                  adaptive=True, name=name)


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               in_place=False, name=None, moving_mean_name=None,
               moving_variance_name=None, do_model_average_for_mean_and_var=False,
               use_global_stats=False):
    """reference: layers/nn.py `batch_norm`. Under mesh data parallelism the
    batch stats are global (sync-BN) — see ops/nn.py batch_norm note."""
    helper = LayerHelper("batch_norm", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    c = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    dtype = input.dtype if input.dtype != "float16" else "float32"
    scale = helper.create_parameter(param_attr, shape=[c], dtype=dtype,
                                    default_initializer=ConstantInitializer(1.0))
    bias = helper.create_parameter(bias_attr, shape=[c], dtype=dtype, is_bias=True)

    from ..param_attr import ParamAttr
    from ..core.framework import unique_name

    mean_name = moving_mean_name or unique_name.generate(helper.name + ".mean")
    var_name = moving_variance_name or unique_name.generate(helper.name + ".var")
    mean = helper.create_parameter(ParamAttr(name=mean_name, trainable=False),
                                   shape=[c], dtype=dtype,
                                   default_initializer=ConstantInitializer(0.0))
    variance = helper.create_parameter(ParamAttr(name=var_name, trainable=False),
                                       shape=[c], dtype=dtype,
                                       default_initializer=ConstantInitializer(1.0))
    mean.stop_gradient = True
    variance.stop_gradient = True

    saved_mean = helper.create_variable_for_type_inference(dtype, stop_gradient=True)
    saved_var = helper.create_variable_for_type_inference(dtype, stop_gradient=True)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="batch_norm",
        inputs={"X": input, "Scale": scale, "Bias": bias,
                "Mean": mean, "Variance": variance},
        outputs={"Y": out, "MeanOut": mean, "VarianceOut": variance,
                 "SavedMean": saved_mean, "SavedVariance": saved_var},
        attrs={"momentum": momentum, "epsilon": epsilon, "is_test": is_test,
               "data_layout": data_layout, "use_global_stats": use_global_stats})
    return helper.append_activation(out, act)


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1, epsilon=1e-5,
               param_attr=None, bias_attr=None, act=None, name=None):
    helper = LayerHelper("layer_norm", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    norm_size = int(np.prod(input.shape[begin_norm_axis:]))
    inputs = {"X": input}
    if scale:
        s = helper.create_parameter(param_attr, shape=[norm_size], dtype=input.dtype,
                                    default_initializer=ConstantInitializer(1.0))
        inputs["Scale"] = s
    if shift:
        b = helper.create_parameter(bias_attr, shape=[norm_size], dtype=input.dtype,
                                    is_bias=True)
        inputs["Bias"] = b
    out = helper.create_variable_for_type_inference(input.dtype)
    mean = helper.create_variable_for_type_inference(input.dtype, stop_gradient=True)
    var = helper.create_variable_for_type_inference(input.dtype, stop_gradient=True)
    helper.append_op(type="layer_norm", inputs=inputs,
                     outputs={"Y": out, "Mean": mean, "Variance": var},
                     attrs={"begin_norm_axis": begin_norm_axis, "epsilon": epsilon})
    return helper.append_activation(out, act)


def group_norm(input, groups, epsilon=1e-5, param_attr=None, bias_attr=None,
               act=None, data_layout="NCHW", name=None):
    helper = LayerHelper("group_norm", param_attr=param_attr,
                         bias_attr=bias_attr, act=act, name=name)
    c = input.shape[1]
    inputs = {"X": input}
    if param_attr is not False:
        inputs["Scale"] = helper.create_parameter(
            param_attr, shape=[c], dtype=input.dtype,
            default_initializer=ConstantInitializer(1.0))
    if bias_attr is not False:
        inputs["Bias"] = helper.create_parameter(bias_attr, shape=[c],
                                                 dtype=input.dtype, is_bias=True)
    out = helper.create_variable_for_type_inference(input.dtype)
    mean = helper.create_variable_for_type_inference(input.dtype, stop_gradient=True)
    var = helper.create_variable_for_type_inference(input.dtype, stop_gradient=True)
    helper.append_op(type="group_norm", inputs=inputs,
                     outputs={"Y": out, "Mean": mean, "Variance": var},
                     attrs={"groups": groups, "epsilon": epsilon})
    return helper.append_activation(out, act)


def instance_norm(input, epsilon=1e-5, param_attr=None, bias_attr=None, name=None):
    helper = LayerHelper("instance_norm", name=name)
    c = input.shape[1]
    inputs = {"X": input}
    if param_attr is not False:
        inputs["Scale"] = helper.create_parameter(
            param_attr, shape=[c], dtype=input.dtype,
            default_initializer=ConstantInitializer(1.0))
    if bias_attr is not False:
        inputs["Bias"] = helper.create_parameter(bias_attr, shape=[c],
                                                 dtype=input.dtype, is_bias=True)
    out = helper.create_variable_for_type_inference(input.dtype)
    sm = helper.create_variable_for_type_inference(input.dtype, stop_gradient=True)
    sv = helper.create_variable_for_type_inference(input.dtype, stop_gradient=True)
    helper.append_op(type="instance_norm", inputs=inputs,
                     outputs={"Y": out, "SavedMean": sm, "SavedVariance": sv},
                     attrs={"epsilon": epsilon})
    return out


def l2_normalize(x, axis, epsilon=1e-12, name=None):
    helper = LayerHelper("l2_normalize", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="l2_normalize", inputs={"X": x}, outputs={"Out": out},
                     attrs={"axis": axis, "epsilon": epsilon})
    return out


def dropout(x, dropout_prob, is_test=False, seed=None, name=None,
            dropout_implementation="downgrade_in_infer"):
    helper = LayerHelper("dropout", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    mask = helper.create_variable_for_type_inference("uint8", stop_gradient=True)
    helper.append_op(type="dropout", inputs={"X": x},
                     outputs={"Out": out, "Mask": mask},
                     attrs={"dropout_prob": dropout_prob, "is_test": is_test,
                            "dropout_implementation": dropout_implementation,
                            "seed": seed or 0})
    return out


def softmax(input, use_cudnn=False, name=None, axis=-1):
    helper = LayerHelper("softmax", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="softmax", inputs={"X": input}, outputs={"Out": out},
                     attrs={"axis": axis})
    return out


def log_softmax(input, axis=-1, name=None):
    helper = LayerHelper("log_softmax", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="log_softmax", inputs={"X": input}, outputs={"Out": out},
                     attrs={"axis": axis})
    return out


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    helper = LayerHelper("matmul", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="matmul", inputs={"X": x, "Y": y}, outputs={"Out": out},
                     attrs={"transpose_X": transpose_x, "transpose_Y": transpose_y,
                            "alpha": float(alpha)})
    return out


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None):
    helper = LayerHelper("mul", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="mul", inputs={"X": x, "Y": y}, outputs={"Out": out},
                     attrs={"x_num_col_dims": x_num_col_dims,
                            "y_num_col_dims": y_num_col_dims})
    return out


def topk(input, k, name=None):
    helper = LayerHelper("top_k", name=name)
    values = helper.create_variable_for_type_inference(input.dtype)
    indices = helper.create_variable_for_type_inference("int64")
    helper.append_op(type="top_k", inputs={"X": input},
                     outputs={"Out": values, "Indices": indices}, attrs={"k": k})
    return values, indices


def one_hot(input, depth, allow_out_of_range=False):
    helper = LayerHelper("one_hot")
    out = helper.create_variable_for_type_inference("float32")
    helper.append_op(type="one_hot", inputs={"X": input}, outputs={"Out": out},
                     attrs={"depth": depth})
    return out


def reshape(x, shape, actual_shape=None, act=None, inplace=False, name=None):
    helper = LayerHelper("reshape2", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="reshape2", inputs={"X": x}, outputs={"Out": out},
                     attrs={"shape": list(shape)})
    return helper.append_activation(out, act)


def transpose(x, perm, name=None):
    helper = LayerHelper("transpose2", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="transpose2", inputs={"X": x}, outputs={"Out": out},
                     attrs={"axis": list(perm)})
    return out


def squeeze(input, axes, name=None):
    helper = LayerHelper("squeeze2", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="squeeze2", inputs={"X": input}, outputs={"Out": out},
                     attrs={"axes": list(axes)})
    return out


def unsqueeze(input, axes, name=None):
    helper = LayerHelper("unsqueeze2", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="unsqueeze2", inputs={"X": input}, outputs={"Out": out},
                     attrs={"axes": list(axes)})
    return out


def flatten(x, axis=1, name=None):
    helper = LayerHelper("flatten2", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="flatten2", inputs={"X": x}, outputs={"Out": out},
                     attrs={"axis": axis})
    return out


def split(input, num_or_sections, dim=-1, name=None):
    helper = LayerHelper("split", name=name)
    dim = dim if dim >= 0 else dim + len(input.shape)
    if isinstance(num_or_sections, int):
        n = num_or_sections
        attrs = {"num": n, "axis": dim}
    else:
        n = len(num_or_sections)
        attrs = {"sections": list(num_or_sections), "axis": dim}
    outs = [helper.create_variable_for_type_inference(input.dtype) for _ in range(n)]
    helper.append_op(type="split", inputs={"X": input}, outputs={"Out": outs},
                     attrs=attrs)
    return outs


def stack(x, axis=0):
    helper = LayerHelper("stack")
    x = x if isinstance(x, (list, tuple)) else [x]
    out = helper.create_variable_for_type_inference(x[0].dtype)
    helper.append_op(type="stack", inputs={"X": x}, outputs={"Y": out},
                     attrs={"axis": axis})
    return out


def unstack(x, axis=0, num=None):
    helper = LayerHelper("unstack")
    num = num if num is not None else x.shape[axis]
    outs = [helper.create_variable_for_type_inference(x.dtype) for _ in range(num)]
    helper.append_op(type="unstack", inputs={"X": x}, outputs={"Y": outs},
                     attrs={"axis": axis, "num": num})
    return outs


def expand(x, expand_times, name=None):
    helper = LayerHelper("expand", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="expand", inputs={"X": x}, outputs={"Out": out},
                     attrs={"expand_times": list(expand_times)})
    return out


def expand_as(x, target_tensor, name=None):
    helper = LayerHelper("expand_as", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="expand_as",
                     inputs={"X": x, "target_tensor": target_tensor},
                     outputs={"Out": out})
    return out


def slice(input, axes, starts, ends):
    helper = LayerHelper("slice")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="slice", inputs={"Input": input}, outputs={"Out": out},
                     attrs={"axes": list(axes), "starts": list(starts),
                            "ends": list(ends)})
    return out


def strided_slice(input, axes, starts, ends, strides):
    helper = LayerHelper("strided_slice")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="strided_slice", inputs={"Input": input},
                     outputs={"Out": out},
                     attrs={"axes": list(axes), "starts": list(starts),
                            "ends": list(ends), "strides": list(strides)})
    return out


def gather(input, index, overwrite=True):
    helper = LayerHelper("gather")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="gather", inputs={"X": input, "Index": index},
                     outputs={"Out": out})
    return out


def gather_nd(input, index, name=None):
    helper = LayerHelper("gather_nd", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="gather_nd", inputs={"X": input, "Index": index},
                     outputs={"Out": out})
    return out


def scatter(input, index, updates, name=None, overwrite=True):
    helper = LayerHelper("scatter", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="scatter",
                     inputs={"X": input, "Ids": index, "Updates": updates},
                     outputs={"Out": out}, attrs={"overwrite": overwrite})
    return out


def scatter_nd_add(ref, index, updates, name=None):
    helper = LayerHelper("scatter_nd_add", name=name)
    out = helper.create_variable_for_type_inference(ref.dtype)
    helper.append_op(type="scatter_nd_add",
                     inputs={"X": ref, "Index": index, "Updates": updates},
                     outputs={"Out": out})
    return out


def pad(x, paddings, pad_value=0.0, name=None):
    helper = LayerHelper("pad", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="pad", inputs={"X": x}, outputs={"Out": out},
                     attrs={"paddings": list(paddings), "pad_value": float(pad_value)})
    return out


def pad2d(input, paddings=(0, 0, 0, 0), mode="constant", pad_value=0.0,
          data_format="NCHW", name=None):
    helper = LayerHelper("pad2d", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="pad2d", inputs={"X": input}, outputs={"Out": out},
                     attrs={"paddings": list(paddings), "mode": mode,
                            "pad_value": float(pad_value)})
    return out


def _reduce(op_type):
    def layer(input, dim=None, keep_dim=False, name=None):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(input.dtype)
        if dim is None:
            attrs = {"reduce_all": True, "keep_dim": keep_dim}
        else:
            attrs = {"dim": [dim] if isinstance(dim, int) else list(dim),
                     "keep_dim": keep_dim}
        helper.append_op(type=op_type, inputs={"X": input}, outputs={"Out": out},
                         attrs=attrs)
        return out

    layer.__name__ = op_type
    return layer


reduce_sum = _reduce("reduce_sum")
reduce_mean = _reduce("reduce_mean")
reduce_max = _reduce("reduce_max")
reduce_min = _reduce("reduce_min")
reduce_prod = _reduce("reduce_prod")
reduce_all = _reduce("reduce_all")
reduce_any = _reduce("reduce_any")


def mean(x, name=None):
    helper = LayerHelper("mean", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="mean", inputs={"X": x}, outputs={"Out": out})
    return out


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    helper = LayerHelper("scale", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="scale", inputs={"X": x}, outputs={"Out": out},
                     attrs={"scale": float(scale), "bias": float(bias),
                            "bias_after_scale": bias_after_scale})
    return helper.append_activation(out, act)


def clip(x, min, max, name=None):
    helper = LayerHelper("clip", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="clip", inputs={"X": x}, outputs={"Out": out},
                     attrs={"min": float(min), "max": float(max)})
    return out


def clip_by_norm(x, max_norm, name=None):
    helper = LayerHelper("clip_by_norm", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="clip_by_norm", inputs={"X": x}, outputs={"Out": out},
                     attrs={"max_norm": float(max_norm)})
    return out


def squared_l2_norm(x, name=None):
    helper = LayerHelper("squared_l2_norm", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="squared_l2_norm", inputs={"X": x}, outputs={"Out": out})
    return out


def maxout(x, groups, name=None):
    helper = LayerHelper("maxout", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="maxout", inputs={"X": x}, outputs={"Out": out},
                     attrs={"groups": groups})
    return out


def prelu(x, mode, param_attr=None, name=None):
    helper = LayerHelper("prelu", param_attr=param_attr, name=name)
    if mode == "all":
        alpha_shape = [1]
    elif mode == "channel":
        alpha_shape = [x.shape[1]]
    else:
        alpha_shape = list(x.shape[1:])
    alpha = helper.create_parameter(param_attr, shape=alpha_shape, dtype=x.dtype,
                                    default_initializer=ConstantInitializer(0.25))
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="prelu", inputs={"X": x, "Alpha": alpha},
                     outputs={"Out": out}, attrs={"mode": mode})
    return out


def relu(x, name=None):
    helper = LayerHelper("relu", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="relu", inputs={"X": x}, outputs={"Out": out})
    return out


def image_resize(input, out_shape=None, scale=None, name=None,
                 resample="BILINEAR", align_corners=True, align_mode=1):
    helper = LayerHelper("interp", name=name)
    op_type = {"BILINEAR": "bilinear_interp", "NEAREST": "nearest_interp",
               "TRILINEAR": "trilinear_interp"}[resample.upper()]
    out = helper.create_variable_for_type_inference(input.dtype)
    attrs = {"align_corners": align_corners, "align_mode": align_mode}
    if out_shape is not None:
        keys = ("out_d", "out_h", "out_w")[-len(out_shape):]
        for k, v in zip(keys, out_shape):
            attrs[k] = int(v)
    else:
        attrs["scale"] = float(scale)
    helper.append_op(type=op_type, inputs={"X": input}, outputs={"Out": out},
                     attrs=attrs)
    return out


def resize_bilinear(input, out_shape=None, scale=None, name=None, **kw):
    return image_resize(input, out_shape, scale, name, "BILINEAR", **kw)


def resize_nearest(input, out_shape=None, scale=None, name=None, **kw):
    return image_resize(input, out_shape, scale, name, "NEAREST", **kw)


def resize_trilinear(input, out_shape=None, scale=None, name=None, **kw):
    """reference: layers/nn.py:9716 `resize_trilinear` → trilinear_interp
    op on NCDHW input."""
    return image_resize(input, out_shape, scale, name, "TRILINEAR", **kw)


def label_smooth(label, prior_dist=None, epsilon=0.1, dtype="float32", name=None):
    helper = LayerHelper("label_smooth", name=name)
    out = helper.create_variable_for_type_inference(dtype)
    inputs = {"X": label}
    if prior_dist is not None:
        inputs["PriorDist"] = prior_dist
    helper.append_op(type="label_smooth", inputs=inputs, outputs={"Out": out},
                     attrs={"epsilon": float(epsilon)})
    return out


def pixel_shuffle(x, upscale_factor):
    helper = LayerHelper("pixel_shuffle")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="pixel_shuffle", inputs={"X": x}, outputs={"Out": out},
                     attrs={"upscale_factor": upscale_factor})
    return out


def grid_sampler(x, grid, name=None):
    helper = LayerHelper("grid_sampler", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="grid_sampler", inputs={"X": x, "Grid": grid},
                     outputs={"Output": out})
    return out


def shape(input):
    helper = LayerHelper("shape")
    out = helper.create_variable_for_type_inference("int32", stop_gradient=True)
    helper.append_op(type="shape", inputs={"Input": input}, outputs={"Out": out})
    return out


def where(condition, x=None, y=None):
    helper = LayerHelper("where")
    if x is None:
        out = helper.create_variable_for_type_inference("int64")
        helper.append_op(type="where_index", inputs={"Condition": condition},
                         outputs={"Out": out})
        return out
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="where", inputs={"Condition": condition, "X": x, "Y": y},
                     outputs={"Out": out})
    return out


def unique(x, dtype="int64"):
    helper = LayerHelper("unique")
    out = helper.create_variable_for_type_inference(x.dtype)
    index = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="unique", inputs={"X": x},
                     outputs={"Out": out, "Index": index})
    return out, index


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    """reference: operators/shard_index_op.cc (sharded classification)."""
    helper = LayerHelper("shard_index")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="shard_index", inputs={"X": input},
                     outputs={"Out": out},
                     attrs={"index_num": int(index_num),
                            "nshards": int(nshards),
                            "shard_id": int(shard_id),
                            "ignore_value": int(ignore_value)})
    return out


def temporal_shift(x, seg_num, shift_ratio=0.25, name=None):
    helper = LayerHelper("temporal_shift", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="temporal_shift", inputs={"X": x}, outputs={"Out": out},
                     attrs={"seg_num": seg_num, "shift_ratio": shift_ratio})
    return out


def linear_chain_crf(input, label, param_attr=None, length=None):
    """CRF negative log-likelihood (reference: layers/nn.py:1500 →
    linear_chain_crf_op). input [N,T,D] emissions, label [N,T]; returns the
    per-sequence cost [N,1]. The [D+2,D] transition parameter is created
    here; name it via param_attr to share with crf_decoding."""
    helper = LayerHelper("linear_chain_crf", param_attr=param_attr)
    d = int(input.shape[-1])
    transition = helper.create_parameter(param_attr, shape=[d + 2, d],
                                         dtype=input.dtype)
    ll = helper.create_variable_for_type_inference(input.dtype)
    alpha = helper.create_variable_for_type_inference(input.dtype)
    eexp = helper.create_variable_for_type_inference(input.dtype)
    texp = helper.create_variable_for_type_inference(input.dtype)
    inputs = {"Emission": input, "Transition": transition, "Label": label}
    if length is not None:
        inputs["Length"] = length
    helper.append_op(type="linear_chain_crf", inputs=inputs,
                     outputs={"LogLikelihood": ll, "Alpha": alpha,
                              "EmissionExps": eexp, "TransitionExps": texp})
    return ll


def crf_decoding(input, param_attr, label=None, length=None):
    """Viterbi decode with the transition parameter trained by
    linear_chain_crf (reference: layers/nn.py:1620). With label, returns a
    0/1 correctness mask instead of the path."""
    helper = LayerHelper("crf_decoding", param_attr=param_attr)
    d = int(input.shape[-1])
    transition = helper.create_parameter(param_attr, shape=[d + 2, d],
                                         dtype=input.dtype)
    path = helper.create_variable_for_type_inference("int64")
    inputs = {"Emission": input, "Transition": transition}
    if label is not None:
        inputs["Label"] = label
    if length is not None:
        inputs["Length"] = length
    helper.append_op(type="crf_decoding", inputs=inputs,
                     outputs={"ViterbiPath": path})
    return path


def chunk_eval(input, label, chunk_scheme, num_chunk_types,
               excluded_chunk_types=None, seq_length=None):
    """Chunk precision/recall/F1 (reference: layers/nn.py:1999 →
    chunk_eval_op). Returns (precision, recall, f1, num_infer, num_label,
    num_correct) for the batch."""
    helper = LayerHelper("chunk_eval")
    outs = {k: helper.create_variable_for_type_inference(dt)
            for k, dt in [("Precision", "float32"), ("Recall", "float32"),
                          ("F1-Score", "float32"),
                          ("NumInferChunks", "int64"),
                          ("NumLabelChunks", "int64"),
                          ("NumCorrectChunks", "int64")]}
    inputs = {"Inference": input, "Label": label}
    if seq_length is not None:
        inputs["SeqLength"] = seq_length
    helper.append_op(type="chunk_eval", inputs=inputs, outputs=outs,
                     attrs={"num_chunk_types": num_chunk_types,
                            "chunk_scheme": chunk_scheme,
                            "excluded_chunk_types":
                                list(excluded_chunk_types or [])})
    return (outs["Precision"], outs["Recall"], outs["F1-Score"],
            outs["NumInferChunks"], outs["NumLabelChunks"],
            outs["NumCorrectChunks"])


def mean_iou(input, label, num_classes):
    """Mean IoU over classes (reference: layers/nn.py `mean_iou` →
    mean_iou_op.cc). Returns (mean_iou, out_wrong, out_correct); the
    counter outputs can be fed back via InWrongs/InCorrects for
    streaming accumulation."""
    helper = LayerHelper("mean_iou")
    iou = helper.create_variable_for_type_inference("float32")
    wrong = helper.create_variable_for_type_inference("int32")
    correct = helper.create_variable_for_type_inference("int32")
    helper.append_op(type="mean_iou",
                     inputs={"Predictions": input, "Labels": label},
                     outputs={"OutMeanIou": iou, "OutWrong": wrong,
                              "OutCorrect": correct},
                     attrs={"num_classes": num_classes})
    return iou, wrong, correct


def adaptive_pool3d(input, pool_size, pool_type="max", require_index=False,
                    name=None):
    """reference: layers/nn.py `adaptive_pool3d` → pool3d with adaptive
    bins (divisible-bin convention; max_pool3d_with_index when
    require_index)."""
    helper = LayerHelper("adaptive_pool3d", name=name)
    ksize = pool_size if isinstance(pool_size, (list, tuple)) \
        else [pool_size] * 3
    ksize = [int(k) for k in ksize]
    out = helper.create_variable_for_type_inference(input.dtype)
    if require_index:
        mask = helper.create_variable_for_type_inference("int32")
        helper.append_op(type="max_pool3d_with_index",
                         inputs={"X": input},
                         outputs={"Out": out, "Mask": mask},
                         attrs={"ksize": ksize, "adaptive": True})
        return out, mask
    helper.append_op(type="pool3d", inputs={"X": input},
                     outputs={"Out": out},
                     attrs={"pooling_type": pool_type, "ksize": ksize,
                            "adaptive": True})
    return out
