"""Dygraph NN modules: the JAX package's `dygraph/nn.py` (reference:
python/paddle/fluid/dygraph/nn.py — Conv2D, Pool2D, FC/Linear,
BatchNorm, Embedding, LayerNorm, GRUUnit, ...), each forward a few
registry ops through the tracer.

Two behaviours of the JAX package are kept as they are: BatchNorm
writes its running mean and variance with no autograd history
(`set_value`), and GRUUnit returns tanh of the candidate gate's
pre-activation twice, with no update or reset gate and off the tape, so
its weight and bias take no gradient (ROADMAP F19).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..initializer import ConstantInitializer, NormalInitializer
from .layers import Layer
from .tracer import get_tracer
from .varbase import VarBase


def _op(op_type, ins, outs, attrs=None):
    return get_tracer().trace_op(op_type, ins, outs, attrs or {})


class Conv2D(Layer):
    def __init__(self, num_channels, num_filters, filter_size, stride=1,
                 padding=0, dilation=1, groups=1, param_attr=None,
                 bias_attr=None, use_cudnn=True, act=None, dtype="float32"):
        super().__init__(dtype=dtype)
        fs = filter_size if isinstance(filter_size, (list, tuple)) else [filter_size] * 2
        self._attrs = {"strides": [stride] * 2 if isinstance(stride, int) else list(stride),
                       "paddings": [padding] * 2 if isinstance(padding, int) else list(padding),
                       "dilations": [dilation] * 2 if isinstance(dilation, int) else list(dilation),
                       "groups": groups}
        fan_in = (num_channels // groups) * fs[0] * fs[1]
        std = (2.0 / fan_in) ** 0.5
        self.weight = self.create_parameter(
            [num_filters, num_channels // groups] + list(fs), attr=param_attr,
            default_initializer=NormalInitializer(0.0, std))
        self.bias = None if bias_attr is False else self.create_parameter(
            [num_filters], attr=bias_attr, is_bias=True)
        self._act = act

    def forward(self, x):
        out = _op("conv2d", {"Input": [x], "Filter": [self.weight]},
                  {"Output": [None]}, self._attrs)["Output"][0]
        if self.bias is not None:
            out = _op("elementwise_add", {"X": [out], "Y": [self.bias]},
                      {"Out": [None]}, {"axis": 1})["Out"][0]
        if self._act:
            out = _op(self._act, {"X": [out]}, {"Out": [None]})["Out"][0]
        return out


class Linear(Layer):
    def __init__(self, input_dim, output_dim, param_attr=None, bias_attr=None,
                 act=None, dtype="float32"):
        super().__init__(dtype=dtype)
        self.weight = self.create_parameter([input_dim, output_dim], attr=param_attr)
        self.bias = None if bias_attr is False else self.create_parameter(
            [output_dim], attr=bias_attr, is_bias=True)
        self._act = act

    def forward(self, x):
        out = _op("mul", {"X": [x], "Y": [self.weight]}, {"Out": [None]},
                  {"x_num_col_dims": len(x.shape) - 1})["Out"][0]
        if self.bias is not None:
            out = _op("elementwise_add", {"X": [out], "Y": [self.bias]},
                      {"Out": [None]}, {"axis": len(out.shape) - 1})["Out"][0]
        if self._act:
            out = _op(self._act, {"X": [out]}, {"Out": [None]})["Out"][0]
        return out


class FC(Linear):
    """reference: dygraph/nn.py FC (pre-Linear API)."""

    def __init__(self, name_scope, size, num_flatten_dims=1, param_attr=None,
                 bias_attr=None, act=None, dtype="float32", input_dim=None):
        if input_dim is None:
            raise ValueError("FC requires input_dim on TPU (static shapes)")
        super().__init__(input_dim, size, param_attr, bias_attr, act, dtype)


class BatchNorm(Layer):
    def __init__(self, num_channels, act=None, is_test=False, momentum=0.9,
                 epsilon=1e-5, param_attr=None, bias_attr=None,
                 data_layout="NCHW", dtype="float32", use_global_stats=False):
        super().__init__(dtype=dtype)
        self.weight = self.create_parameter(
            [num_channels], attr=param_attr,
            default_initializer=ConstantInitializer(1.0))
        self.bias = self.create_parameter([num_channels], attr=bias_attr, is_bias=True)
        self._mean = VarBase(np.zeros(num_channels, dtype), persistable=True,
                             stop_gradient=True)
        self._variance = VarBase(np.ones(num_channels, dtype), persistable=True,
                                 stop_gradient=True)
        self._attrs = {"momentum": momentum, "epsilon": epsilon,
                       "data_layout": data_layout,
                       "use_global_stats": use_global_stats, "is_test": is_test}
        self._act = act

    def forward(self, x):
        attrs = dict(self._attrs)
        attrs["is_test"] = attrs["is_test"] or not self.training
        outs = _op("batch_norm",
                   {"X": [x], "Scale": [self.weight], "Bias": [self.bias],
                    "Mean": [self._mean], "Variance": [self._variance]},
                   {"Y": [None], "MeanOut": [None], "VarianceOut": [None],
                    "SavedMean": [None], "SavedVariance": [None]}, attrs)
        if not attrs["is_test"]:
            self._mean.set_value(outs["MeanOut"][0].value)
            self._variance.set_value(outs["VarianceOut"][0].value)
        y = outs["Y"][0]
        if self._act:
            y = _op(self._act, {"X": [y]}, {"Out": [None]})["Out"][0]
        return y


class Embedding(Layer):
    def __init__(self, size, is_sparse=False, is_distributed=False,
                 padding_idx=None, param_attr=None, dtype="float32",
                 name_scope=None):
        super().__init__(name_scope, dtype=dtype)
        self.weight = self.create_parameter(list(size), attr=param_attr)
        self._padding_idx = -1 if padding_idx is None else padding_idx

    def forward(self, ids):
        return _op("lookup_table_v2", {"W": [self.weight], "Ids": [ids]},
                   {"Out": [None]}, {"padding_idx": self._padding_idx})["Out"][0]


class LayerNorm(Layer):
    def __init__(self, normalized_shape, scale=True, shift=True, epsilon=1e-5,
                 param_attr=None, bias_attr=None, act=None, dtype="float32"):
        super().__init__(dtype=dtype)
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        n = int(np.prod(normalized_shape))
        self.weight = self.create_parameter(
            [n], attr=param_attr, default_initializer=ConstantInitializer(1.0)) if scale else None
        self.bias = self.create_parameter([n], attr=bias_attr, is_bias=True) if shift else None
        self._epsilon = epsilon
        self._act = act

    def forward(self, x):
        ins = {"X": [x]}
        if self.weight is not None:
            ins["Scale"] = [self.weight]
        if self.bias is not None:
            ins["Bias"] = [self.bias]
        out = _op("layer_norm", ins,
                  {"Y": [None], "Mean": [None], "Variance": [None]},
                  {"begin_norm_axis": len(x.shape) - 1,
                   "epsilon": self._epsilon})["Y"][0]
        if self._act:
            out = _op(self._act, {"X": [out]}, {"Out": [None]})["Out"][0]
        return out


class Pool2D(Layer):
    def __init__(self, pool_size=-1, pool_type="max", pool_stride=1,
                 pool_padding=0, global_pooling=False, use_cudnn=True,
                 ceil_mode=False, exclusive=True, dtype="float32"):
        super().__init__(dtype=dtype)
        p = lambda v: [v] * 2 if isinstance(v, int) else list(v)
        self._attrs = {"pooling_type": pool_type, "ksize": p(pool_size),
                       "strides": p(pool_stride), "paddings": p(pool_padding),
                       "global_pooling": global_pooling, "ceil_mode": ceil_mode,
                       "exclusive": exclusive}

    def forward(self, x):
        return _op("pool2d", {"X": [x]}, {"Out": [None]}, self._attrs)["Out"][0]


class Dropout(Layer):
    def __init__(self, p=0.5, dropout_implementation="downgrade_in_infer"):
        super().__init__()
        self._attrs = {"dropout_prob": p,
                       "dropout_implementation": dropout_implementation}

    def forward(self, x):
        attrs = dict(self._attrs, is_test=not self.training)
        return _op("dropout", {"X": [x]}, {"Out": [None], "Mask": [None]},
                   attrs)["Out"][0]


class GRUUnit(Layer):
    def __init__(self, size, param_attr=None, bias_attr=None,
                 activation="tanh", gate_activation="sigmoid", dtype="float32"):
        super().__init__(dtype=dtype)
        d = size // 3
        self._d = d
        self.weight = self.create_parameter([d, d * 3], attr=param_attr)
        self.bias = self.create_parameter([1, d * 3], attr=bias_attr, is_bias=True)

    def forward(self, input, hidden):
        # input: [N, 3D] projected x; hidden: [N, D]
        d = self._d
        gates = _op("mul", {"X": [hidden], "Y": [self.weight]}, {"Out": [None]},
                    {})["Out"][0]
        gates = _op("elementwise_add", {"X": [gates], "Y": [input]},
                    {"Out": [None]}, {"axis": -1})["Out"][0]
        gates = _op("elementwise_add", {"X": [gates], "Y": [self.bias]},
                    {"Out": [None]}, {"axis": -1})["Out"][0]
        # split u, r, c
        value = gates.value.detach()
        u = VarBase(torch.tanh(value[:, 2 * d:]))
        return u, u


class Conv3D(Layer):
    def __init__(self, num_channels, num_filters, filter_size, stride=1,
                 padding=0, dilation=1, groups=1, param_attr=None,
                 bias_attr=None, act=None, dtype="float32"):
        super().__init__(dtype=dtype)
        fs = filter_size if isinstance(filter_size, (list, tuple)) else \
            [filter_size] * 3
        self._attrs = {
            "strides": [stride] * 3 if isinstance(stride, int)
            else list(stride),
            "paddings": [padding] * 3 if isinstance(padding, int)
            else list(padding),
            "dilations": [dilation] * 3 if isinstance(dilation, int)
            else list(dilation), "groups": groups}
        self.weight = self.create_parameter(
            [num_filters, num_channels // groups] + list(fs),
            attr=param_attr)
        self.bias = None if bias_attr is False else self.create_parameter(
            [num_filters], attr=bias_attr, is_bias=True)
        self._act = act

    def forward(self, x):
        out = _op("conv3d", {"Input": [x], "Filter": [self.weight]},
                  {"Output": [None]}, self._attrs)["Output"][0]
        if self.bias is not None:
            out = _op("elementwise_add", {"X": [out], "Y": [self.bias]},
                      {"Out": [None]}, {"axis": 1})["Out"][0]
        if self._act:
            out = _op(self._act, {"X": [out]}, {"Out": [None]})["Out"][0]
        return out


class Conv2DTranspose(Layer):
    def __init__(self, num_channels, num_filters, filter_size, stride=1,
                 padding=0, dilation=1, param_attr=None, bias_attr=None,
                 act=None, dtype="float32"):
        super().__init__(dtype=dtype)
        fs = filter_size if isinstance(filter_size, (list, tuple)) else \
            [filter_size] * 2
        self._attrs = {
            "strides": [stride] * 2 if isinstance(stride, int)
            else list(stride),
            "paddings": [padding] * 2 if isinstance(padding, int)
            else list(padding),
            "dilations": [dilation] * 2 if isinstance(dilation, int)
            else list(dilation)}
        self.weight = self.create_parameter(
            [num_channels, num_filters] + list(fs), attr=param_attr)
        self.bias = None if bias_attr is False else self.create_parameter(
            [num_filters], attr=bias_attr, is_bias=True)
        self._act = act

    def forward(self, x):
        out = _op("conv2d_transpose",
                  {"Input": [x], "Filter": [self.weight]},
                  {"Output": [None]}, self._attrs)["Output"][0]
        if self.bias is not None:
            out = _op("elementwise_add", {"X": [out], "Y": [self.bias]},
                      {"Out": [None]}, {"axis": 1})["Out"][0]
        if self._act:
            out = _op(self._act, {"X": [out]}, {"Out": [None]})["Out"][0]
        return out


class Conv3DTranspose(Layer):
    def __init__(self, num_channels, num_filters, filter_size, stride=1,
                 padding=0, param_attr=None, bias_attr=None, act=None,
                 dtype="float32"):
        super().__init__(dtype=dtype)
        fs = filter_size if isinstance(filter_size, (list, tuple)) else \
            [filter_size] * 3
        self._attrs = {
            "strides": [stride] * 3 if isinstance(stride, int)
            else list(stride),
            "paddings": [padding] * 3 if isinstance(padding, int)
            else list(padding)}
        self.weight = self.create_parameter(
            [num_channels, num_filters] + list(fs), attr=param_attr)
        self.bias = None if bias_attr is False else self.create_parameter(
            [num_filters], attr=bias_attr, is_bias=True)
        self._act = act

    def forward(self, x):
        out = _op("conv3d_transpose",
                  {"Input": [x], "Filter": [self.weight]},
                  {"Output": [None]}, self._attrs)["Output"][0]
        if self.bias is not None:
            out = _op("elementwise_add", {"X": [out], "Y": [self.bias]},
                      {"Out": [None]}, {"axis": 1})["Out"][0]
        if self._act:
            out = _op(self._act, {"X": [out]}, {"Out": [None]})["Out"][0]
        return out


class NCE(Layer):
    """reference: dygraph/nn.py:1780 — NCE loss module holding the
    [num_total_classes, dim] weight/bias tables."""

    def __init__(self, num_total_classes, dim, param_attr=None,
                 bias_attr=None, num_neg_samples=10,
                 sampler="uniform", dtype="float32"):
        super().__init__(dtype=dtype)
        self.weight = self.create_parameter([num_total_classes, dim],
                                            attr=param_attr)
        self.bias = self.create_parameter([num_total_classes],
                                          attr=bias_attr, is_bias=True)
        self._attrs = {"num_total_classes": num_total_classes,
                       "num_neg_samples": num_neg_samples,
                       "sampler": sampler}

    def forward(self, input, label, sample_weight=None):
        ins = {"Input": [input], "Label": [label],
               "Weight": [self.weight], "Bias": [self.bias]}
        if sample_weight is not None:
            ins["SampleWeight"] = [sample_weight]
        return _op("nce", ins,
                   {"Cost": [None], "SampleLogits": [None],
                    "SampleLabels": [None]}, self._attrs)["Cost"][0]


class PRelu(Layer):
    def __init__(self, mode="all", channel=None, input_shape=None,
                 param_attr=None, dtype="float32"):
        super().__init__(dtype=dtype)
        self._mode = mode
        if mode == "all":
            shape = [1]
        elif mode == "channel":
            shape = [channel]
        else:
            shape = list(input_shape)
        self.weight = self.create_parameter(
            shape, attr=param_attr,
            default_initializer=ConstantInitializer(0.25))

    def forward(self, x):
        return _op("prelu", {"X": [x], "Alpha": [self.weight]},
                   {"Out": [None]}, {"mode": self._mode})["Out"][0]


class BilinearTensorProduct(Layer):
    """out_i = x W_i y^T + b_i (reference: dygraph/nn.py:2111)."""

    def __init__(self, input1_dim, input2_dim, output_dim, param_attr=None,
                 bias_attr=None, act=None, dtype="float32"):
        super().__init__(dtype=dtype)
        self.weight = self.create_parameter(
            [output_dim, input1_dim, input2_dim], attr=param_attr)
        self.bias = None if bias_attr is False else self.create_parameter(
            [output_dim], attr=bias_attr, is_bias=True)
        self._act = act

    def forward(self, x, y):
        # x W_o y^T via traced ops so the tape sees every step:
        # W [O,D1,D2] -> [D1, O*D2]; t = x @ W' -> [N,O,D2]; sum(t*y)
        o, d1, d2 = [int(v) for v in self.weight.shape]
        wt = _op("transpose2", {"X": [self.weight]},
                 {"Out": [None], "XShape": [None]},
                 {"axis": [1, 0, 2]})["Out"][0]
        wt = _op("reshape2", {"X": [wt]}, {"Out": [None], "XShape": [None]},
                 {"shape": [d1, o * d2]})["Out"][0]
        t = _op("mul", {"X": [x], "Y": [wt]}, {"Out": [None]},
                {"x_num_col_dims": 1, "y_num_col_dims": 1})["Out"][0]
        t = _op("reshape2", {"X": [t]}, {"Out": [None], "XShape": [None]},
                {"shape": [-1, o, d2]})["Out"][0]
        yu = _op("unsqueeze2", {"X": [y]},
                 {"Out": [None], "XShape": [None]}, {"axes": [1]})["Out"][0]
        prod = _op("elementwise_mul", {"X": [t], "Y": [yu]},
                   {"Out": [None]}, {"axis": -1})["Out"][0]
        out = _op("reduce_sum", {"X": [prod]}, {"Out": [None]},
                  {"dim": [-1], "keep_dim": False})["Out"][0]
        if self.bias is not None:
            out = _op("elementwise_add", {"X": [out], "Y": [self.bias]},
                      {"Out": [None]}, {"axis": 1})["Out"][0]
        if self._act:
            out = _op(self._act, {"X": [out]}, {"Out": [None]})["Out"][0]
        return out


class SequenceConv(Layer):
    def __init__(self, input_dim, num_filters, filter_size=3,
                 padding_start=None, param_attr=None, bias_attr=None,
                 act=None, dtype="float32"):
        super().__init__(dtype=dtype)
        self.weight = self.create_parameter(
            [filter_size * input_dim, num_filters], attr=param_attr)
        self.bias = None if bias_attr is False else self.create_parameter(
            [num_filters], attr=bias_attr, is_bias=True)
        self._attrs = {"contextLength": filter_size,
                       "contextStart": padding_start
                       if padding_start is not None
                       else -(filter_size - 1) // 2}
        self._act = act

    def forward(self, x, length=None):
        ins = {"X": [x], "Filter": [self.weight]}
        if length is not None:
            ins["Length"] = [length]
        out = _op("sequence_conv", ins, {"Out": [None]},
                  self._attrs)["Out"][0]
        if self.bias is not None:
            out = _op("elementwise_add", {"X": [out], "Y": [self.bias]},
                      {"Out": [None]}, {"axis": 2})["Out"][0]
        if self._act:
            out = _op(self._act, {"X": [out]}, {"Out": [None]})["Out"][0]
        return out


class RowConv(Layer):
    def __init__(self, input_dim, future_context_size, param_attr=None,
                 act=None, dtype="float32"):
        super().__init__(dtype=dtype)
        self.weight = self.create_parameter(
            [future_context_size + 1, input_dim], attr=param_attr)
        self._act = act

    def forward(self, x):
        out = _op("row_conv", {"X": [x], "Filter": [self.weight]},
                  {"Out": [None]})["Out"][0]
        if self._act:
            out = _op(self._act, {"X": [out]}, {"Out": [None]})["Out"][0]
        return out


class GroupNorm(Layer):
    def __init__(self, channels, groups, epsilon=1e-5, param_attr=None,
                 bias_attr=None, act=None, dtype="float32"):
        super().__init__(dtype=dtype)
        self.weight = self.create_parameter(
            [channels], attr=param_attr,
            default_initializer=ConstantInitializer(1.0))
        self.bias = None if bias_attr is False else self.create_parameter(
            [channels], attr=bias_attr, is_bias=True)
        self._attrs = {"groups": groups, "epsilon": epsilon}
        self._act = act

    def forward(self, x):
        ins = {"X": [x], "Scale": [self.weight]}
        if self.bias is not None:
            ins["Bias"] = [self.bias]
        out = _op("group_norm", ins,
                  {"Y": [None], "Mean": [None], "Variance": [None]},
                  self._attrs)["Y"][0]
        if self._act:
            out = _op(self._act, {"X": [out]}, {"Out": [None]})["Out"][0]
        return out


class SpectralNorm(Layer):
    def __init__(self, weight_shape, dim=0, power_iters=1, eps=1e-12,
                 dtype="float32"):
        super().__init__(dtype=dtype)
        h = int(weight_shape[dim])
        total = 1
        for s in weight_shape:
            total *= int(s)
        self.weight_u = self.create_parameter(
            [h], attr=None, default_initializer=NormalInitializer(0.0, 1.0))
        self.weight_v = self.create_parameter(
            [total // h], attr=None,
            default_initializer=NormalInitializer(0.0, 1.0))
        self._attrs = {"dim": dim, "power_iters": power_iters, "eps": eps}

    def forward(self, weight):
        return _op("spectral_norm",
                   {"Weight": [weight], "U": [self.weight_u],
                    "V": [self.weight_v]}, {"Out": [None]},
                   self._attrs)["Out"][0]


class TreeConv(Layer):
    """reference: dygraph/nn.py `TreeConv` → tree_conv op (TBCNN over
    NodesVector/EdgeSet). The op's filter is [feature_size, 3,
    out_channels]; the reference's extra num_filters dim folds into the
    channel dim (out = output_size * num_filters), matching the op's
    [N, M, C] output."""

    def __init__(self, feature_size, output_size, num_filters=1,
                 max_depth=2, act="tanh", param_attr=None, bias_attr=None,
                 name=None, dtype="float32"):
        super().__init__(dtype=dtype)
        self._max_depth = max_depth
        self._act = act
        self._num_filters = int(num_filters)
        self._output_size = int(output_size)
        c = self._output_size * self._num_filters
        self.weight = self.create_parameter(
            [feature_size, 3, c], attr=param_attr)
        # bias stays [num_filters] like the reference (shared across
        # output_size) so checkpoints transfer; tiled at forward time
        self.bias = (self.create_parameter(
            [self._num_filters], attr=bias_attr, is_bias=True)
            if bias_attr is not False else None)

    def forward(self, nodes_vector, edge_set):
        out = _op("tree_conv",
                  {"NodesVector": [nodes_vector], "EdgeSet": [edge_set],
                   "Filter": [self.weight]}, {"Out": [None]},
                  {"max_depth": self._max_depth})["Out"][0]
        if self.bias is not None:
            tiled = _op("tile", {"X": [self.bias]}, {"Out": [None]},
                        {"repeat_times": [self._output_size]})["Out"][0]
            out = _op("elementwise_add", {"X": [out], "Y": [tiled]},
                      {"Out": [None]}, {"axis": -1})["Out"][0]
        if self._act:
            out = _op(self._act, {"X": [out]}, {"Out": [None]})["Out"][0]
        return out
