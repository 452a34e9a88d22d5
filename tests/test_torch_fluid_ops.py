"""Every op kernel the port registers for the fluid path, forward and
generic gradient, against the JAX package's kernel of the same name on
the same numpy inputs (float32, from a seed).

The gradient is each package's `<op>_grad`, synthesized by its registry
(`jax.vjp` there, a replay under autograd here), given the same random
cotangent for every floating output; every floating input's gradient is
requested. Tolerances, by op class, on float32 (`TOL`): elementwise ops
and activations rtol 1e-5; reductions and losses 1e-5; products
(mul, matmul, conv2d) and the linear-algebra ops 1e-4, with an atol of
the same size relative to the reference's largest value, since XLA and
torch sum products in other orders. Random ops are held to their
distribution instead (mean, spread, bounds), since torch and jax draw
different numbers.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.core import registry as jreg
from paddle_tpu.core.ir import OpDesc as JOpDesc

from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core.ir import OpDesc as TOpDesc

TOL = {"ew": (1e-5, 1e-6), "reduce": (1e-5, 1e-6), "mm": (1e-4, 1e-4)}


def _spec(shape, kind="normal", dtype="float32"):
    return (tuple(shape), kind, dtype)


N = _spec((3, 4, 5))
P = _spec((3, 4, 5), "pos")


def _make(rng, spec):
    if isinstance(spec, np.ndarray):
        return spec
    shape, kind, dtype = spec
    if kind == "normal":
        a = rng.standard_normal(shape)
    elif kind == "pos":
        a = rng.uniform(0.5, 2.0, shape)
    elif kind == "unit":
        a = rng.uniform(-0.9, 0.9, shape)
    elif kind == "wide":
        a = rng.standard_normal(shape) * 4.0
    elif kind == "pd":
        m = rng.standard_normal(shape)
        a = m @ np.swapaxes(m, -1, -2) + shape[-1] * np.eye(shape[-1])
    elif kind == "bool":
        a = rng.uniform(size=shape) > 0.5
    elif kind == "prob":       # rows of a distribution over the last dim
        e = np.exp(rng.standard_normal(shape))
        a = e / e.sum(-1, keepdims=True)
    elif kind == "prob01":
        a = rng.uniform(0.05, 0.95, shape)
    elif kind == "sign":
        a = rng.choice([-1.0, 1.0], shape)
    elif kind == "bin":
        a = rng.randint(0, 2, shape)
    elif kind == "special":    # normal with an inf and a nan
        a = rng.standard_normal(shape)
        a.flat[1], a.flat[-2] = np.inf, np.nan
    elif kind.startswith("int"):
        a = rng.randint(0, int(kind[3:]), shape)
    else:
        raise ValueError(kind)
    return np.asarray(a).astype(dtype)


def _c(op, ins, attrs=None, cls="ew", name=None):
    return pytest.param(op, ins, attrs or {}, cls, id=name or op)


_UNARY_POS = ("log", "log1p", "log2", "log10", "sqrt", "rsqrt",
              "reciprocal")
_UNARY = ("relu", "sigmoid", "logsigmoid", "tanh", "tanh_shrink", "exp",
          "abs", "square", "softsign", "sin", "cos", "tan", "atan", "sinh",
          "cosh", "erf", "floor", "ceil", "round", "sign", "silu", "mish")

CASES = (
    [_c(f"elementwise_{k}", {"X": [N], "Y": [_spec((4, 5))]})
     for k in ("add", "sub", "mul", "max", "min")]
    + [_c("elementwise_add", {"X": [N], "Y": [_spec((4,))]}, {"axis": 1},
          name="elementwise_add_axis1"),
       _c("elementwise_div", {"X": [N], "Y": [P]}),
       _c("elementwise_pow", {"X": [P], "Y": [_spec((3, 4, 5), "unit")]}),
       _c("elementwise_mod", {"X": [P], "Y": [_spec((4, 5), "pos")]}),
       _c("elementwise_floordiv", {"X": [_spec((3, 4), "wide")],
                                   "Y": [_spec((3, 4), "pos")]}),
       _c("sum", {"X": [N, N, N]}),
       _c("scale", {"X": [N]}, {"scale": 2.5, "bias": 0.5}),
       _c("scale", {"X": [N]}, {"scale": 2.5, "bias": 0.5,
                                "bias_after_scale": False},
          name="scale_bias_first"),
       _c("mul", {"X": [_spec((2, 3, 4))], "Y": [_spec((12, 5))]},
          {"x_num_col_dims": 1}, "mm"),
       _c("mul", {"X": [_spec((2, 3, 4))], "Y": [_spec((4, 5))]},
          {"x_num_col_dims": 2}, "mm", name="mul_xnc2"),
       _c("matmul", {"X": [_spec((2, 3, 4))], "Y": [_spec((2, 5, 4))]},
          {"transpose_Y": True, "alpha": 0.5}, "mm"),
       _c("matmul_v2", {"X": [_spec((2, 4, 3))], "Y": [_spec((2, 4, 5))]},
          {"trans_x": True}, "mm"),
       _c("bmm", {"X": [_spec((2, 3, 4))], "Y": [_spec((2, 4, 5))]},
          cls="mm"),
       _c("dot", {"X": [_spec((3, 4))], "Y": [_spec((3, 4))]}, cls="reduce"),
       _c("addmm", {"Input": [_spec((3, 5))], "X": [_spec((3, 4))],
                    "Y": [_spec((4, 5))]}, {"Alpha": 2.0, "Beta": 0.5}, "mm"),
       _c("kron", {"X": [_spec((2, 3))], "Y": [_spec((3, 2))]}),
       _c("trace", {"Input": [_spec((4, 4, 3))]}, {"offset": 1}, "reduce"),
       _c("cholesky", {"X": [_spec((4, 4), "pd")]}, {}, "mm"),
       _c("inverse", {"Input": [_spec((4, 4), "pd")]}, {}, "mm"),
       _c("max", {"X": [N], "Y": [N]}),
       _c("maximum", {"X": [N], "Y": [N]}),
       _c("minimum", {"X": [N], "Y": [N]}),
       _c("l1_norm", {"X": [N]}, cls="reduce")]
    + [_c(op, {"X": [P]}) for op in _UNARY_POS]
    + [_c(op, {"X": [N]}) for op in _UNARY]
    + [_c(op, {"X": [_spec((3, 4, 5), "unit")]}) for op in ("asin", "acos")]
    + [_c("gelu", {"X": [N]}),
       _c("gelu", {"X": [N]}, {"approximate": True}, name="gelu_tanh"),
       _c("leaky_relu", {"X": [N]}, {"alpha": 0.1}),
       _c("elu", {"X": [N]}, {"alpha": 0.7}),
       _c("selu", {"X": [N]}),
       _c("relu6", {"X": [_spec((3, 4, 5), "wide")]}, {"threshold": 6.0}),
       _c("brelu", {"X": [_spec((3, 4, 5), "wide")]},
          {"t_min": -1.0, "t_max": 2.0}),
       _c("softplus", {"X": [_spec((3, 4, 5), "wide")]}),
       _c("softshrink", {"X": [N]}, {"lambda": 0.3}),
       _c("hard_shrink", {"X": [N]}, {"threshold": 0.3}),
       _c("thresholded_relu", {"X": [N]}, {"threshold": 0.2}),
       _c("hard_sigmoid", {"X": [_spec((3, 4, 5), "wide")]}),
       _c("hard_swish", {"X": [_spec((3, 4, 5), "wide")]}),
       _c("swish", {"X": [N]}, {"beta": 1.5}),
       _c("stanh", {"X": [N]}),
       _c("prelu", {"X": [_spec((2, 3, 4, 4))], "Alpha": [_spec((3,))]},
          {"mode": "channel"}),
       _c("pow", {"X": [P]}, {"factor": 2.5}),
       _c("maxout", {"X": [_spec((2, 6, 3, 3))]}, {"groups": 2}),
       _c("soft_relu", {"X": [_spec((3, 4, 5), "wide")]}, {"threshold": 3.0})]
    + [_c(op, {"X": [N]}, {"dim": [1, 2], "keep_dim": keep}, "reduce",
          name=f"{op}_keep{int(keep)}")
       for op in ("reduce_sum", "reduce_mean", "reduce_max", "reduce_min",
                  "reduce_prod", "logsumexp", "frobenius_norm")
       for keep in (False, True)]
    + [_c("reduce_sum", {"X": [N]}, {"reduce_all": True}, "reduce",
          name="reduce_sum_all"),
       _c("reduce_all", {"X": [_spec((3, 4), "bool", "bool")]},
          {"dim": [1]}, "reduce"),
       _c("reduce_any", {"X": [_spec((3, 4), "bool", "bool")]},
          {"dim": [0]}, "reduce"),
       _c("mean", {"X": [N]}, cls="reduce"),
       _c("fill_constant", {}, {"shape": [2, 3], "value": 1.5,
                                "dtype": "float32"}),
       _c("fill_constant", {}, {"shape": [4], "value": 7, "dtype": "int64"},
          name="fill_constant_int64"),
       _c("cast", {"X": [N]}, {"out_dtype": "float64"}),
       _c("cast", {"X": [_spec((3, 4), "wide")]}, {"out_dtype": "int32"},
          name="cast_int32"),
       _c("reshape2", {"X": [N]}, {"shape": [0, -1]}),
       _c("top_k", {"X": [_spec((4, 10))]}, {"k": 3}),
       _c("conv2d", {"Input": [_spec((2, 3, 8, 8))],
                     "Filter": [_spec((4, 3, 3, 3))]},
          {"strides": [1, 1], "paddings": [1, 1], "dilations": [1, 1],
           "groups": 1}, "mm"),
       _c("conv2d", {"Input": [_spec((2, 4, 9, 9))],
                     "Filter": [_spec((6, 2, 3, 3))]},
          {"strides": [2, 2], "paddings": [0, 1, 1, 0], "dilations": [1, 1],
           "groups": 2}, "mm", name="conv2d_asym_groups"),
       _c("conv2d", {"Input": [_spec((2, 3, 9, 9))],
                     "Filter": [_spec((4, 3, 3, 3))]},
          {"strides": [2, 2], "padding_algorithm": "SAME",
           "dilations": [2, 2]}, "mm", name="conv2d_same_dilated"),
       _c("pool2d", {"X": [_spec((2, 3, 8, 8))]},
          {"pooling_type": "max", "ksize": [2, 2], "strides": [2, 2]}),
       _c("pool2d", {"X": [_spec((2, 3, 8, 8))]},
          {"pooling_type": "max", "ksize": [3, 3], "strides": [2, 2],
           "paddings": [1, 1]}, name="pool2d_max_padded"),
       _c("pool2d", {"X": [_spec((2, 3, 8, 8))]},
          {"pooling_type": "avg", "ksize": [3, 3], "strides": [2, 2],
           "paddings": [1, 1], "exclusive": True}, name="pool2d_avg_exclusive"),
       _c("pool2d", {"X": [_spec((2, 3, 8, 8))]},
          {"pooling_type": "avg", "ksize": [3, 3], "strides": [2, 2],
           "paddings": [1, 1], "exclusive": False}, name="pool2d_avg_inclusive"),
       _c("pool2d", {"X": [_spec((2, 3, 8, 8))]},
          {"pooling_type": "avg", "ksize": [2, 2], "global_pooling": True},
          name="pool2d_global_avg"),
       _c("pool2d", {"X": [_spec((2, 3, 8, 8))]},
          {"pooling_type": "max", "ksize": [2, 4], "adaptive": True},
          name="pool2d_adaptive_max"),
       _c("dropout", {"X": [N]}, {"dropout_prob": 0.3, "is_test": True},
          name="dropout_test"),
       _c("dropout", {"X": [N]}, {"dropout_prob": 0.0,
                                  "dropout_implementation": "upscale_in_train"},
          name="dropout_p0"),
       _c("softmax", {"X": [N]}),
       _c("softmax_with_cross_entropy",
          {"Logits": [_spec((6, 10))], "Label": [_spec((6, 1), "int10",
                                                       "int64")]},
          {}, "reduce"),
       _c("softmax_with_cross_entropy",
          {"Logits": [_spec((6, 10))], "Label": [_spec((6, 1), "int10",
                                                       "int64")]},
          {"ignore_index": 3}, "reduce", name="softmax_xent_ignore"),
       _c("square_error_cost", {"X": [_spec((6, 1))], "Y": [_spec((6, 1))]}),
       _c("accuracy", {"Indices": [_spec((6, 3), "int10", "int64")],
                       "Label": [_spec((6, 1), "int10", "int64")]}),
       _c("sgd", {"Param": [N], "Grad": [N], "LearningRate": [_spec((1,), "pos")]}),
       _c("momentum", {"Param": [N], "Grad": [N], "Velocity": [N],
                       "LearningRate": [_spec((1,), "pos")]}, {"mu": 0.9}),
       _c("momentum", {"Param": [N], "Grad": [N], "Velocity": [N],
                       "LearningRate": [_spec((1,), "pos")]},
          {"mu": 0.9, "use_nesterov": True}, name="momentum_nesterov"),
       _c("adam", {"Param": [N], "Grad": [N], "Moment1": [N], "Moment2": [P],
                   "Beta1Pow": [_spec((1,), "unit")],
                   "Beta2Pow": [_spec((1,), "unit")],
                   "LearningRate": [_spec((1,), "pos")]},
          {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8})]
)


# -- the op modules ported with the fluid op library's core: compare,
# tensor, nn, classify and control_flow (the JAX package's
# ops/{compare,tensor,nn,classify,control_flow}.py). Literal arrays
# stand in for specs where the values matter (bounds, unique ids).

def _lit(a, dtype):
    return np.asarray(a, dtype)


def _unpool_indices():
    """max_pool2d_with_index's Mask of a 6 x 6 map under 2 x 2 windows:
    one row-major position inside each window."""
    rng = np.random.RandomState(3)
    a, b = rng.randint(0, 2, (2, 2, 3, 3)), rng.randint(0, 2, (2, 2, 3, 3))
    i, j = np.meshgrid(np.arange(3), np.arange(3), indexing="ij")
    return ((2 * i + a) * 6 + 2 * j + b).astype("int32")


B = _spec((3, 4, 5), "bool", "bool")
PROB = _spec((6, 10), "prob")
LAB = _spec((6, 1), "int10", "int64")
BN_IN = {"X": [_spec((4, 3, 5, 5))], "Scale": [_spec((3,), "pos")],
         "Bias": [_spec((3,))], "Mean": [_spec((3,))],
         "Variance": [_spec((3,), "pos")]}

COMPARE_CASES = (
    [_c(op, {"X": [N], "Y": [_spec((4, 5))]})
     for op in ("not_equal", "less_than", "less_equal", "greater_than",
                "greater_equal")]
    + [_c("not_equal", {"X": [_spec((3, 4), "int3", "int64")],
                        "Y": [_spec((3, 4), "int3", "int64")]},
          name="not_equal_int")]
    + [_c(op, {"X": [B], "Y": [B]})
       for op in ("logical_and", "logical_or", "logical_xor")]
    + [_c("logical_not", {"X": [B]})]
    + [_c(op, {"X": [_spec((3, 4), "special")]})
       for op in ("isinf", "isnan", "isfinite", "isinf_v2", "isnan_v2")]
    + [_c("isfinite", {"X": [N]}, name="isfinite_all_finite"),
       _c("allclose", {"Input": [N], "Other": [N]}, {"rtol": 1e-5,
                                                     "atol": 1e-8}),
       _c("allclose", {"Input": [_lit([1.0, 2.0], "float32")],
                       "Other": [_lit([1.0, 2.0 + 1e-6], "float32")]},
          {"rtol": 1e-5, "atol": 1e-8}, name="allclose_within")]
)

TENSOR_CASES = [
    _c("fill_constant_batch_size_like", {"Input": [N]},
       {"shape": [7, -1], "value": 2.0, "dtype": "float32",
        "input_dim_idx": 0, "output_dim_idx": 1}),
    _c("fill_zeros_like", {"X": [N]}),
    _c("range", {"Start": [_lit(0.5, "float32")],
                 "End": [_lit(5.0, "float32")],
                 "Step": [_lit(0.75, "float32")]}),
    _c("range", {"Start": [_lit(2, "int64")], "End": [_lit(11, "int64")],
                 "Step": [_lit(3, "int64")]}, name="range_int64"),
    _c("assign_value", {}, {"shape": [2, 3], "dtype": "float32",
                            "fp32_values": [1.0, 2.5, -3.0, 4.0, 0.5, 6.0]}),
    _c("assign_value", {}, {"shape": [3], "dtype": "int32",
                            "int32_values": [4, -1, 7]},
       name="assign_value_int32"),
    _c("shape", {"Input": [N]}),
    _c("fill", {}, {"shape": [2, 2], "value": [1.0, 2.0, 3.0, 4.0],
                    "dtype": "float32"}),
    _c("fill_any_like", {"X": [N]}, {"value": 3.0}),
    _c("fill_any_like", {"X": [N]}, {"value": 3.0, "dtype": "int64"},
       name="fill_any_like_int64"),
    _c("fill_zeros_like2", {"X": [N]}),
    _c("linspace", {"Start": [_lit(-1.0, "float32")],
                    "Stop": [_lit(2.0, "float32")],
                    "Num": [_lit(7, "int32")]}, {"dtype": "float32"}),
    _c("eye", {}, {"num_rows": 3, "num_columns": 4, "dtype": "float32"}),
    _c("reshape", {"X": [N]}, {"shape": [0, -1]}),
    _c("transpose2", {"X": [N]}, {"axis": [2, 0, 1]}),
    _c("transpose", {"X": [N]}, {"axis": [1, 0, 2]}),
    _c("squeeze2", {"X": [_spec((3, 1, 5))]}, {"axes": [1]}),
    _c("squeeze2", {"X": [_spec((3, 1, 5, 1))]}, {}, name="squeeze2_all"),
    _c("squeeze", {"X": [_spec((1, 4, 1))]}, {"axes": [0]}),
    _c("unsqueeze2", {"X": [N]}, {"axes": [0, 2]}),
    _c("unsqueeze", {"X": [N]}, {"axes": [3]}),
    _c("flatten2", {"X": [_spec((2, 3, 4, 5))]}, {"axis": 2}),
    _c("flatten2", {"X": [N]}, {"axis": 0}, name="flatten2_axis0"),
    _c("flatten", {"X": [_spec((2, 3, 4, 5))]}, {"axis": 1}),
    _c("concat", {"X": [N, _spec((3, 2, 5)), N]}, {"axis": 1}),
    _c("split", {"X": [_spec((4, 6))]}, {"axis": 1, "sections": [2, 4]}),
    _c("split", {"X": [_spec((4, 6))]}, {"axis": 1, "num": 3},
       name="split_num"),
    _c("stack", {"X": [N, N]}, {"axis": 1}),
    _c("unstack", {"X": [N]}, {"axis": 1}),
    _c("expand", {"X": [_spec((3, 1, 5))]}, {"expand_times": [1, 4, 2]}),
    _c("expand_as", {"X": [_spec((3, 1, 5))],
                     "target_tensor": [_spec((3, 4, 5))]}),
    _c("tile", {"X": [_spec((2, 3))]}, {"repeat_times": [2, 1, 3]}),
    _c("slice", {"Input": [N]}, {"axes": [1, 2], "starts": [1, -3],
                                 "ends": [3, 100]}),
    _c("slice", {"Input": [N]}, {"axes": [0], "starts": [1], "ends": [2],
                                 "decrease_axis": [0]},
       name="slice_decrease"),
    _c("strided_slice", {"Input": [N]}, {"axes": [1, 2], "starts": [0, 4],
                                         "ends": [4, 0],
                                         "strides": [2, -2]}),
    _c("reverse", {"X": [N]}, {"axis": [0, 2]}),
    _c("pad", {"X": [_spec((3, 4))]}, {"paddings": [1, 0, 2, 1],
                                       "pad_value": 0.5}),
    _c("pad2d", {"X": [_spec((2, 3, 4, 5))]}, {"paddings": [1, 2, 0, 1]}),
    _c("pad2d", {"X": [_spec((2, 3, 4, 5))]},
       {"paddings": [1, 2, 0, 1], "mode": "reflect"}, name="pad2d_reflect"),
    _c("pad2d", {"X": [_spec((2, 3, 4, 5))]},
       {"paddings": [1, 2, 0, 1], "mode": "edge"}, name="pad2d_edge"),
    _c("gather", {"X": [N], "Index": [_spec((4,), "int3", "int64")]}),
    _c("gather_nd", {"X": [N], "Index": [_spec((2, 2), "int3", "int64")]}),
    _c("scatter", {"X": [_spec((5, 4))], "Ids": [_lit([1, 3], "int64")],
                   "Updates": [_spec((2, 4))]}),
    _c("scatter", {"X": [_spec((5, 4))], "Ids": [_lit([1, 3, 1], "int64")],
                   "Updates": [_spec((3, 4))]}, {"overwrite": False},
       name="scatter_add"),
    _c("scatter_nd_add", {"X": [_spec((3, 4))],
                          "Index": [_spec((5, 2), "int3", "int64")],
                          "Updates": [_spec((5,))]}),
    _c("index_select", {"X": [N], "Index": [_spec((3,), "int4", "int64")]},
       {"dim": 1}),
    _c("one_hot", {"X": [_spec((6, 1), "int12", "int64")]}, {"depth": 10}),
    _c("lookup_table", {"W": [_spec((10, 4))], "Ids": [LAB]}),
    _c("lookup_table", {"W": [_spec((10, 4))],
                        "Ids": [_spec((2, 3, 1), "int10", "int64")]},
       {"padding_idx": 3}, name="lookup_table_padding"),
    _c("where", {"Condition": [B], "X": [N], "Y": [N]}),
    _c("where_index", {"Condition": [B]}),
    _c("top_k_v2", {"X": [_spec((4, 10))]}, {"k": 3}),
    _c("top_k_v2", {"X": [_spec((10, 4))]}, {"k": 2, "axis": 0},
       name="top_k_v2_axis0"),
    _c("arg_max", {"X": [N]}, {"axis": 1}),
    _c("arg_min", {"X": [N]}, {"axis": 2}),
    _c("argsort", {"X": [N]}, {"axis": 1}),
    _c("argsort", {"X": [_spec((3, 8), "int4", "float32")]},
       {"axis": -1, "descending": True}, name="argsort_descending_ties"),
    _c("unique", {"X": [_spec((12,), "int5", "int64")]}),
    _c("unique_with_counts", {"X": [_spec((3, 4), "int6", "int64")]}),
    _c("clip", {"X": [N]}, {"min": -0.5, "max": 0.7}),
    _c("clip_by_norm", {"X": [N]}, {"max_norm": 1.0}),
    _c("clip_by_norm", {"X": [N]}, {"max_norm": 100.0},
       name="clip_by_norm_under"),
    _c("squared_l2_norm", {"X": [N]}, cls="reduce"),
    _c("norm", {"X": [N]}, {"axis": 1}, "reduce"),
    _c("p_norm", {"X": [N]}, {"porder": 3.0, "axis": 1, "keepdim": True},
       "reduce"),
    _c("dlpack/identity", {"X": [N]}, name="dlpack_identity"),
    _c("print", {"X": [_spec((2, 2))]}, {"message": "x"}),
    _c("is_empty", {"X": [N]}),
    _c("cumsum", {"X": [N]}, {"axis": 1}, "reduce"),
    _c("cumsum", {"X": [N]}, {"axis": 1, "exclusive": True}, "reduce",
       name="cumsum_exclusive"),
    _c("cumsum", {"X": [N]}, {"axis": 2, "reverse": True}, "reduce",
       name="cumsum_reverse"),
    _c("diag", {"Diagonal": [_spec((4,))]}),
    _c("size", {"Input": [N]}),
    _c("diag_part", {"X": [_spec((4, 4))]}),
    _c("shard_index", {"X": [_spec((6, 1), "int20", "int64")]},
       {"index_num": 20, "nshards": 3, "shard_id": 1, "ignore_value": -1}),
]

NN_CASES = [
    _c("conv3d", {"Input": [_spec((2, 3, 5, 5, 5))],
                  "Filter": [_spec((4, 3, 3, 3, 3))]},
       {"strides": [1, 2, 1], "paddings": [1, 1, 0]}, "mm"),
    _c("depthwise_conv2d", {"Input": [_spec((2, 3, 8, 8))],
                            "Filter": [_spec((3, 1, 3, 3))]},
       {"strides": [2, 2], "paddings": [1, 1], "groups": 3}, "mm"),
    _c("conv2d_transpose", {"Input": [_spec((2, 3, 5, 5))],
                            "Filter": [_spec((3, 4, 3, 3))]},
       {"strides": [2, 2], "paddings": [1, 1]}, "mm"),
    _c("conv2d_transpose", {"Input": [_spec((2, 3, 5, 4))],
                            "Filter": [_spec((3, 2, 3, 2))]},
       {"strides": [1, 2], "paddings": [1, 0, 0, 1], "dilations": [2, 1]},
       "mm", name="conv2d_transpose_asym_dilated"),
    _c("depthwise_conv2d_transpose", {"Input": [_spec((2, 3, 5, 5))],
                                      "Filter": [_spec((3, 1, 3, 3))]},
       {"strides": [2, 2], "paddings": [1, 1]}, "mm"),
    _c("deformable_conv", {"Input": [_spec((1, 4, 6, 6))],
                           "Offset": [_spec((1, 36, 6, 6))],
                           "Mask": [_spec((1, 18, 6, 6), "prob01")],
                           "Filter": [_spec((4, 2, 3, 3))]},
       {"strides": [1, 1], "paddings": [1, 1], "groups": 2,
        "deformable_groups": 2}, "mm"),
    _c("deformable_conv_v1", {"Input": [_spec((1, 2, 7, 7))],
                              "Offset": [_spec((1, 18, 3, 3))],
                              "Filter": [_spec((3, 2, 3, 3))]},
       {"strides": [2, 2], "paddings": [0, 0], "dilations": [1, 1]}, "mm"),
    _c("pool3d", {"X": [_spec((2, 3, 6, 6, 6))]},
       {"pooling_type": "max", "ksize": [2, 2, 2], "strides": [2, 2, 2]}),
    _c("pool3d", {"X": [_spec((2, 3, 6, 6, 6))]},
       {"pooling_type": "avg", "ksize": [3, 3, 3], "strides": [2, 2, 2],
        "paddings": [1, 1, 1]}, name="pool3d_avg_padded"),
    _c("pool3d", {"X": [_spec((2, 3, 4, 4, 4))]},
       {"pooling_type": "max", "global_pooling": True},
       name="pool3d_global"),
    _c("max_pool2d_with_index", {"X": [_spec((2, 3, 6, 6))]},
       {"ksize": [3, 3], "strides": [2, 2], "paddings": [1, 1]}),
    _c("max_pool2d_with_index", {"X": [_spec((2, 3, 6, 4))]},
       {"ksize": [3, 2], "adaptive": True}, name="max_pool2d_adaptive"),
    _c("max_pool3d_with_index", {"X": [_spec((1, 2, 4, 4, 4))]},
       {"ksize": [2, 2, 2], "strides": [2, 2, 2]}),
    _c("unpool", {"X": [_spec((2, 2, 3, 3))],
                  "Indices": [_unpool_indices()]},
       {"ksize": [2, 2], "strides": [2, 2]}),
    _c("spp", {"X": [_spec((2, 3, 7, 7))]}, {"pyramid_height": 3}),
    _c("spp", {"X": [_spec((2, 3, 7, 7))]},
       {"pyramid_height": 2, "pooling_type": "avg"}, name="spp_avg"),
    _c("batch_norm", BN_IN, {"momentum": 0.9, "epsilon": 1e-5}, "reduce"),
    _c("batch_norm", BN_IN, {"is_test": True}, "reduce",
       name="batch_norm_is_test"),
    _c("batch_norm", BN_IN, {"use_global_stats": True}, "reduce",
       name="batch_norm_global_stats"),
    _c("batch_norm", dict(BN_IN, X=[_spec((2, 4, 4, 3))]),
       {"data_layout": "NHWC"}, "reduce", name="batch_norm_nhwc"),
    _c("batch_norm", dict(BN_IN, X=[_spec((8, 3))]), {}, "reduce",
       name="batch_norm_2d"),
    _c("sync_batch_norm", BN_IN, {}, "reduce"),
    _c("layer_norm", {"X": [N], "Scale": [_spec((20,))],
                      "Bias": [_spec((20,))]}, {"begin_norm_axis": 1},
       "reduce"),
    _c("layer_norm", {"X": [N]}, {"begin_norm_axis": 2}, "reduce",
       name="layer_norm_no_affine"),
    _c("group_norm", {"X": [_spec((2, 6, 3, 3))], "Scale": [_spec((6,))],
                      "Bias": [_spec((6,))]}, {"groups": 3}, "reduce"),
    _c("instance_norm", {"X": [_spec((2, 3, 4, 4))], "Scale": [_spec((3,))],
                         "Bias": [_spec((3,))]}, {}, "reduce"),
    _c("l2_normalize", {"X": [N]}, {"axis": 1}, "reduce"),
    _c("log_softmax", {"X": [N]}, {"axis": 1}, "reduce"),
    _c("cross_entropy", {"X": [PROB], "Label": [LAB]}, {}, "reduce"),
    _c("cross_entropy", {"X": [PROB], "Label": [LAB]}, {"ignore_index": 3},
       "reduce", name="cross_entropy_ignore"),
    _c("cross_entropy", {"X": [PROB], "Label": [PROB]}, {"soft_label": True},
       "reduce", name="cross_entropy_soft"),
    _c("sigmoid_cross_entropy_with_logits",
       {"X": [_spec((6, 5))], "Label": [_spec((6, 5), "prob01")]}, {},
       "reduce"),
    _c("sigmoid_cross_entropy_with_logits",
       {"X": [_spec((6, 5))], "Label": [_spec((6, 5), "bin")]},
       {"ignore_index": 1, "normalize": True}, "reduce",
       name="sigmoid_xent_ignore_normalize"),
    _c("smooth_l1_loss", {"X": [_spec((6, 4))], "Y": [_spec((6, 4))]},
       {"sigma": 1.5}, "reduce"),
    _c("smooth_l1_loss", {"X": [_spec((6, 4))], "Y": [_spec((6, 4))],
                          "InsideWeight": [_spec((6, 4), "pos")],
                          "OutsideWeight": [_spec((6, 4), "pos")]},
       {}, "reduce", name="smooth_l1_weighted"),
    _c("huber_loss", {"X": [_spec((6, 1))], "Y": [_spec((6, 1))]},
       {"delta": 0.8}),
    _c("bce_loss", {"X": [_spec((6, 3), "prob01")],
                    "Label": [_spec((6, 3), "bin")]}),
    _c("margin_rank_loss", {"X1": [_spec((6, 1))], "X2": [_spec((6, 1))],
                            "Label": [_spec((6, 1), "sign")]},
       {"margin": 0.1}),
    _c("hinge_loss", {"Logits": [_spec((6, 1))],
                      "Labels": [_spec((6, 1), "bin")]}),
    _c("bilinear_interp", {"X": [_spec((2, 3, 4, 5))]},
       {"out_h": 7, "out_w": 9}, "mm"),
    _c("bilinear_interp", {"X": [_spec((2, 3, 4, 5))]},
       {"out_h": 7, "out_w": 3, "align_corners": False, "align_mode": 0},
       "mm", name="bilinear_interp_half_pixel"),
    _c("bilinear_interp", {"X": [_spec((2, 3, 4, 5))]},
       {"scale": 2.0, "align_corners": False, "align_mode": 1}, "mm",
       name="bilinear_interp_scale"),
    _c("nearest_interp", {"X": [_spec((2, 3, 4, 5))]},
       {"out_h": 7, "out_w": 3}),
    _c("trilinear_interp", {"X": [_spec((1, 2, 3, 4, 5))]},
       {"out_d": 5, "out_h": 6, "out_w": 4}, "mm"),
    _c("grid_sampler", {"X": [_spec((2, 3, 5, 6))],
                        "Grid": [_spec((2, 4, 4, 2), "unit")]}, {}, "mm"),
    _c("pixel_shuffle", {"X": [_spec((2, 8, 3, 3))]}, {"upscale_factor": 2}),
    _c("temporal_shift", {"X": [_spec((4, 8, 3, 3))]},
       {"seg_num": 2, "shift_ratio": 0.25}),
    _c("label_smooth", {"X": [PROB]}, {"epsilon": 0.1}),
    _c("label_smooth", {"X": [PROB], "PriorDist": [_spec((1, 10), "prob")]},
       {"epsilon": 0.1}, name="label_smooth_prior"),
    _c("embedding_with_scaled_gradient",
       {"W": [_spec((10, 4))], "Ids": [_spec((6,), "int10", "int64")]}),
    _c("fc", {"Input": [_spec((2, 3, 4))], "W": [_spec((12, 5))],
              "Bias": [_spec((5,))]},
       {"in_num_col_dims": 1, "activation_type": "relu"}, "mm"),
    _c("fc", {"Input": [_spec((2, 3, 4))], "W": [_spec((4, 5))]},
       {"in_num_col_dims": 2}, "mm", name="fc_ncol2"),
] + [_c("kldiv_loss", {"X": [_spec((4, 5))], "Target": [_spec((4, 5), "pos")]},
        {"reduction": red}, "reduce", name=f"kldiv_loss_{red}")
     for red in ("mean", "sum", "batchmean", "none")]

CLASSIFY_CASES = [
    _c("hierarchical_sigmoid", {"X": [_spec((6, 5))], "W": [_spec((9, 5))],
                                "Label": [LAB], "Bias": [_spec((9, 1))]},
       {"num_classes": 10}, "mm"),
    _c("hierarchical_sigmoid",
       {"X": [_spec((3, 5))], "W": [_spec((6, 5))],
        "Label": [_spec((3, 1), "int4", "int64")],
        "PathTable": [_lit([[0, 2, -1], [1, 3, 5], [0, -1, -1]], "int64")],
        "PathCode": [_lit([[1, 0, 0], [0, 1, 1], [1, 0, 0]], "int64")]},
       {"num_classes": 4}, "mm", name="hierarchical_sigmoid_custom_tree"),
    _c("sampled_softmax_with_cross_entropy",
       {"Logits": [_spec((4, 12))], "Label": [_spec((4, 1), "int12",
                                                    "int64")],
        "CustomizedSamples": [_lit([[3, 1, 5, 3], [0, 7, 0, 2],
                                    [11, 4, 9, 1], [6, 6, 2, 8]], "int64")],
        "CustomizedProbabilities": [_spec((4, 4), "prob01")]},
       {"num_samples": 3, "use_customized_samples": True}, "reduce",
       name="sampled_softmax_customized"),
    _c("sample_logits",
       {"Logits": [_spec((4, 12))], "Labels": [_spec((4, 1), "int12",
                                                     "int64")],
        "CustomizedSamples": [_lit([[3, 1, 5, 3], [0, 7, 0, 2],
                                    [11, 4, 9, 1], [6, 6, 2, 8]], "int64")],
        "CustomizedProbabilities": [_spec((4, 4), "prob01")]},
       {"num_samples": 3, "use_customized_samples": True}, "reduce",
       name="sample_logits_customized"),
    _c("cos_sim", {"X": [_spec((4, 5))], "Y": [_spec((4, 5))]}, {}, "reduce"),
    _c("cos_sim", {"X": [_spec((4, 5))], "Y": [_spec((1, 5))]}, {}, "reduce",
       name="cos_sim_broadcast"),
    _c("cross_entropy2", {"X": [PROB], "Label": [LAB]}, {}, "reduce"),
    _c("cross_entropy2", {"X": [PROB], "Label": [LAB]}, {"ignore_index": 4},
       "reduce", name="cross_entropy2_ignore"),
]

CONTROL_CASES = [
    _c("select_input", {"X": [N, N, N], "Mask": [_lit([1], "int32")]}),
    _c("select_input", {"X": [N, N], "Mask": [_lit([5], "int64")]},
       name="select_input_clamped"),
    _c("assign_skip", {"X": [N]}),
]

# the ops of misc.py beside its SelectedRows ops that the port has: the
# CTR program's loss and the three the dygraph layers reach; with them
# sequence_conv (sequence.py) and tree_conv (text_match.py)
_TREE_EDGES = np.array([[[1, 2], [1, 3], [2, 4], [2, 5], [0, 0]],
                        [[1, 2], [2, 3], [2, 4], [0, 0], [0, 0]]], "int64")
MISC_CASES = [
    _c("log_loss", {"Predicted": [_spec((6, 1), "prob01")],
                    "Labels": [_spec((6, 1), "prob01")]}, {}),
    _c("spectral_norm", {"Weight": [_spec((6, 4, 2))], "U": [_spec((4,))],
                         "V": [_spec((12,))]},
       {"dim": 1, "power_iters": 3}, "mm"),
    _c("row_conv", {"X": [_spec((2, 6, 4))], "Filter": [_spec((3, 4))]}),
    _c("conv3d_transpose", {"Input": [_spec((2, 3, 4, 5, 4))],
                            "Filter": [_spec((3, 2, 3, 2, 3))]},
       {"strides": [2, 1, 2], "paddings": [1, 0, 1],
        "dilations": [1, 2, 1]}, "mm"),
    _c("sequence_conv", {"X": [_spec((2, 7, 3))], "Filter": [_spec((9, 4))],
                         "Length": [_lit([7, 4], "int64")]},
       {"contextLength": 3, "contextStart": -1}, "mm"),
    _c("sequence_conv", {"X": [_spec((2, 7, 3))],
                         "Filter": [_spec((12, 4))]},
       {"contextLength": 4, "contextStart": -2}, "mm",
       name="sequence_conv_full"),
    _c("tree_conv", {"NodesVector": [_spec((2, 5, 3))],
                     "EdgeSet": [_TREE_EDGES],
                     "Filter": [_spec((3, 3, 4))]}, {"max_depth": 2}, "mm"),
]

CASES = (CASES + COMPARE_CASES + TENSOR_CASES + NN_CASES + CLASSIFY_CASES
         + CONTROL_CASES + MISC_CASES)


def _names(ins):
    return {slot: [f"{slot}{i}" for i in range(len(v))]
            for slot, v in ins.items()}


def _run(pkg, op_type, ins, attrs, outputs):
    """One kernel call through `pkg`'s registry, in its own tensors."""
    if pkg == "jax":
        desc = JOpDesc(type=op_type, inputs=_names(ins), outputs=outputs,
                       attrs=attrs)
        ctx = jreg.KernelCtx(desc)
        vals = {k: [None if x is None else jnp.asarray(x) for x in v]
                for k, v in ins.items()}
        outs = jreg.get_op_def(op_type).call(vals, attrs, ctx)
    else:
        desc = TOpDesc(type=op_type, inputs=_names(ins), outputs=outputs,
                       attrs=attrs)
        ctx = treg.KernelCtx(desc, device="cpu")
        vals = {k: [None if x is None else torch.from_numpy(np.array(x))
                    for x in v] for k, v in ins.items()}
        with torch.no_grad():  # as the executor runs every op
            outs = treg.get_op_def(op_type).call(vals, attrs, ctx)
    return {k: [None if o is None else np.asarray(o) for o in v]
            for k, v in outs.items()}


def _held(got, want, cls, what):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    if want.dtype == np.bool_ or np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    rtol, atol = TOL[cls]
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * scale,
                               err_msg=what)


@pytest.mark.parametrize("op_type, spec, attrs, cls", CASES)
def test_op_forward_and_generic_gradient(op_type, spec, attrs, cls):
    rng = np.random.RandomState(sum(map(ord, op_type)))
    ins = {slot: [_make(rng, s) for s in specs]
           for slot, specs in spec.items()}
    fj = _run("jax", op_type, ins, attrs, {})
    ft = _run("torch", op_type, ins, attrs, {})
    for slot, vals in fj.items():
        for i, v in enumerate(vals):
            if v is None:
                assert i >= len(ft.get(slot, [])) or ft[slot][i] is None
                continue
            _held(ft[slot][i], v, cls, f"{op_type} {slot}[{i}]")

    if not jreg.get_op_def(op_type).has_grad():
        assert not treg.get_op_def(op_type).has_grad()
        return
    # the grad op: fwd_in::, fwd_out:: and out_grad:: inputs, a random
    # cotangent for every floating output; in_grad:: for every floating
    # input slot
    gins, gouts = {}, {}
    for slot, vals in ins.items():
        gins["fwd_in::" + slot] = vals
        if all(np.issubdtype(x.dtype, np.floating) for x in vals):
            gouts["in_grad::" + slot] = [f"g{slot}{i}" for i in range(len(vals))]
    for slot, vals in fj.items():
        gins["fwd_out::" + slot] = vals
        gins["out_grad::" + slot] = [
            None if v is None or not np.issubdtype(v.dtype, np.floating)
            else rng.standard_normal(v.shape).astype(v.dtype) for v in vals]
    gj = _run("jax", op_type + "_grad", gins, attrs, gouts)
    gt = _run("torch", op_type + "_grad", gins, attrs, gouts)
    assert sorted(gj) == sorted(gt), (sorted(gj), sorted(gt))
    for slot, vals in gj.items():
        for i, v in enumerate(vals):
            _held(gt[slot][i], v, cls, f"{op_type}_grad {slot}[{i}]")


@pytest.mark.parametrize("op_type, attrs", [
    ("uniform_random", {"min": -0.5, "max": 1.5}),
    ("gaussian_random", {"mean": 0.5, "std": 2.0}),
    ("truncated_gaussian_random", {"mean": 0.5, "std": 2.0}),
])
def test_random_op_distribution(op_type, attrs):
    """Shape, dtype and the law (mean, spread, bounds) of the random
    initializers, against the JAX kernel's at 256 x 256 draws, and the
    draw replays from (step seed, uid)."""
    attrs = dict(attrs, shape=[256, 256], dtype="float32", __rng_uid__=3)
    (j,) = _run("jax", op_type, {}, attrs, {})["Out"]
    desc = TOpDesc(type=op_type, attrs=attrs)
    draws = [treg.get_op_def(op_type).call(
        {}, attrs, treg.KernelCtx(desc, rng_key=seed, device="cpu"))["Out"][0]
        for seed in (11, 11, 12)]
    t = draws[0].numpy()
    assert t.shape == j.shape and t.dtype == j.dtype
    assert torch.equal(draws[0], draws[1])
    assert not torch.equal(draws[0], draws[2])
    assert abs(t.mean() - j.mean()) < 0.03 * max(1.0, j.std())
    assert abs(t.std() - j.std()) < 0.03 * j.std()
    assert t.min() >= j.min() - 0.05 * j.std()
    assert t.max() <= j.max() + 0.05 * j.std()


def test_dropout_grad_replays_the_forward_mask():
    """`dropout_grad` replays `dropout` with the same (step seed, uid):
    its gradient is the cotangent through the forward's own mask."""
    attrs = {"dropout_prob": 0.4, "dropout_implementation": "upscale_in_train",
             "__rng_uid__": 5}
    x = torch.randn(64, 64, dtype=torch.float32)
    ctx = treg.KernelCtx(TOpDesc(type="dropout", attrs=attrs), rng_key=7,
                         device="cpu")
    fwd = treg.get_op_def("dropout").call({"X": [x]}, attrs, ctx)
    mask = fwd["Mask"][0].bool()
    assert 0.5 < mask.float().mean() < 0.7
    torch.testing.assert_close(fwd["Out"][0], torch.where(mask, x / 0.6, 0.0))
    cot = torch.randn(64, 64)
    gdesc = TOpDesc(type="dropout_grad", outputs={"in_grad::X": ["gx"]},
                    attrs=attrs)
    g = treg.get_op_def("dropout_grad").call(
        {"fwd_in::X": [x], "fwd_out::Out": fwd["Out"],
         "fwd_out::Mask": fwd["Mask"], "out_grad::Out": [cot],
         "out_grad::Mask": [None]},
        attrs, treg.KernelCtx(gdesc, rng_key=7, device="cpu"))
    torch.testing.assert_close(g["in_grad::X"][0],
                               torch.where(mask, cot / 0.6, 0.0))


def test_shape_inference_on_meta_tensors():
    """`infer_op_outputs` runs a kernel on meta tensors: -1 dims come
    back -1 and the dtype as the IR's name, equal to the JAX package's
    inference; a random op draws nothing on the card there."""
    from paddle_tpu.core.ir import VarDesc as JVarDesc

    from paddle_tpu_torch.core.ir import VarDesc as TVarDesc

    cases = [
        ("conv2d", {"Input": ("x", (-1, 3, 28, 28), "float32"),
                    "Filter": ("w", (6, 3, 5, 5), "float32")},
         {"Output": ["y"]}, {"strides": [1, 1], "paddings": [0, 0]}),
        ("top_k", {"X": ("x", (-1, 10), "float32")},
         {"Out": ["v"], "Indices": ["i"]}, {"k": 1}),
        ("accuracy", {"Indices": ("i", (-1, 1), "int64"),
                      "Label": ("l", (-1, 1), "int64")},
         {"Accuracy": ["a"], "Correct": ["c"], "Total": ["t"]}, {}),
        ("dropout", {"X": ("x", (-1, 8), "float32")},
         {"Out": ["o"], "Mask": ["m"]}, {"dropout_prob": 0.5}),
        ("uniform_random", {}, {"Out": ["u"]},
         {"shape": [4, 5], "dtype": "float64"}),
    ]
    for op_type, ins, outs, attrs in cases:
        inputs = {slot: [n] for slot, (n, _, _) in ins.items()}
        got = treg.infer_op_outputs(
            TOpDesc(type=op_type, inputs=inputs, outputs=outs, attrs=attrs),
            {n: TVarDesc(n, shape=s, dtype=d) for n, s, d in ins.values()})
        want = jreg.infer_op_outputs(
            JOpDesc(type=op_type, inputs=inputs, outputs=outs, attrs=attrs),
            {n: JVarDesc(n, shape=s, dtype=d) for n, s, d in ins.values()})
        assert {k: (tuple(v.shape), v.dtype) for k, v in got.items()} == {
            k: (tuple(v.shape), str(np.dtype(v.dtype))) for k, v in want.items()}


# -- random ops of the library's core: each drawn by both packages, the
# law held (the numbers are each package's own) and every deterministic
# part recomputed from the port's own draw


def test_randint_distribution():
    attrs = {"shape": [256, 256], "low": 2, "high": 9, "dtype": "int64",
             "__rng_uid__": 4}
    (j,) = _run("jax", "randint", {}, attrs, {})["Out"]
    desc = TOpDesc(type="randint", attrs=attrs)
    draws = [treg.get_op_def("randint").call(
        {}, attrs, treg.KernelCtx(desc, rng_key=seed, device="cpu"))["Out"][0]
        for seed in (11, 11, 12)]
    t = draws[0].numpy()
    assert t.shape == j.shape and t.dtype == j.dtype
    assert torch.equal(draws[0], draws[1])
    assert not torch.equal(draws[0], draws[2])
    assert (t.min(), t.max()) == (j.min(), j.max()) == (2, 8)
    np.testing.assert_allclose(np.bincount(t.ravel(), minlength=9) / t.size,
                               np.bincount(j.ravel(), minlength=9) / j.size,
                               atol=0.01)


def _law_held(samples, law, what):
    """Each class's share of `samples` within 5 standard errors of its
    probability under `law`."""
    freq = np.bincount(samples.ravel(), minlength=law.size) / samples.size
    se = np.sqrt(law * (1 - law) / samples.size)
    assert np.all(np.abs(freq - law) <= 5 * se + 1e-3), (what, freq, law)


def _log_uniform_law(c):
    k = np.arange(c)
    return np.log((k + 2.0) / (k + 1.0)) / np.log(c + 1.0)


def _nce_inputs(rng, sampler):
    n, d, c = 512, 8, 20
    ins = {"Input": [rng.standard_normal((n, d)).astype("float32")],
           "Label": [rng.randint(0, c, (n, 1)).astype("int64")],
           "Weight": [rng.standard_normal((c, d)).astype("float32")],
           "Bias": [rng.standard_normal((c,)).astype("float32")]}
    if sampler == 2:
        p = rng.uniform(0.2, 1.0, c)
        ins["CustomDistProbs"] = [(p / p.sum()).astype("float32")]
    attrs = {"num_total_classes": c, "num_neg_samples": 6,
             "sampler": sampler, "__rng_uid__": 9}
    return ins, attrs


@pytest.mark.parametrize("sampler", [0, 1, 2])
def test_nce_distribution_and_cost(sampler):
    """nce under each sampler: the true classes lead SampleLabels, the
    negatives follow the JAX op's law, SampleLogits is W[s] . x + b[s]
    and Cost the reference formula on the port's own samples; the
    gradient op replays the same draw."""
    rng = np.random.RandomState(sampler)
    ins, attrs = _nce_inputs(rng, sampler)
    c, k = attrs["num_total_classes"], attrs["num_neg_samples"]
    j = _run("jax", "nce", ins, attrs, {})
    desc = TOpDesc(type="nce", attrs=attrs)
    ctx = treg.KernelCtx(desc, rng_key=5, device="cpu")
    vals = {s: [torch.from_numpy(a) for a in v] for s, v in ins.items()}
    t = {s: [v.numpy() for v in vs] for s, vs in treg.get_op_def("nce").call(
        vals, attrs, ctx).items()}
    samples, logits = t["SampleLabels"][0], t["SampleLogits"][0]
    assert samples.shape == j["SampleLabels"][0].shape
    np.testing.assert_array_equal(samples[:, :1], ins["Label"][0])
    law = {0: np.full(c, 1.0 / c), 1: _log_uniform_law(c),
           2: ins.get("CustomDistProbs", [None])[0]}[sampler]
    for what, drawn in (("port", samples), ("jax", j["SampleLabels"][0])):
        _law_held(drawn[:, 1:], np.asarray(law, np.float64), what)
    x, w, b = ins["Input"][0], ins["Weight"][0], ins["Bias"][0]
    want = np.einsum("nsd,nd->ns", w[samples], x) + b[samples]
    np.testing.assert_allclose(logits, want, rtol=1e-5, atol=1e-5)
    if sampler == 2:
        p = ins["CustomDistProbs"][0][samples]
    elif sampler == 1:
        p = np.log((samples + 2.0) / (samples + 1.0)) / np.log(c + 1.0)
    else:
        p = np.full(samples.shape, 1.0 / c)
    o, q = 1 / (1 + np.exp(-want)), p * k
    cost = (-np.log(o[:, :1] / (o[:, :1] + q[:, :1] + 1e-12) + 1e-12)).sum(1)
    cost += (-np.log(q[:, 1:] / (o[:, 1:] + q[:, 1:] + 1e-12) + 1e-12)).sum(1)
    np.testing.assert_allclose(t["Cost"][0][:, 0], cost, rtol=1e-4)
    again = treg.get_op_def("nce").call(vals, attrs, treg.KernelCtx(
        desc, rng_key=5, device="cpu"))["SampleLabels"][0].numpy()
    np.testing.assert_array_equal(again, samples)


@pytest.mark.parametrize("op_type", ["sampled_softmax_with_cross_entropy",
                                     "sample_logits"])
def test_sampled_softmax_distribution_and_logits(op_type):
    """The log-uniform negatives follow the JAX op's law; the sampled
    logits (expected-count correction, accidental hits at -1e20) and
    the loss are the reference's on the port's own samples."""
    rng = np.random.RandomState(2)
    n, c, s = 512, 30, 8
    logits = rng.standard_normal((n, c)).astype("float32")
    label = rng.randint(0, c, (n, 1)).astype("int64")
    lslot = "Label" if op_type != "sample_logits" else "Labels"
    ins = {"Logits": [logits], lslot: [label]}
    attrs = {"num_samples": s, "__rng_uid__": 2}
    j = _run("jax", op_type, ins, attrs, {})
    desc = TOpDesc(type=op_type, attrs=attrs)
    out = treg.get_op_def(op_type).call(
        {k: [torch.from_numpy(v[0])] for k, v in ins.items()}, attrs,
        treg.KernelCtx(desc, rng_key=3, device="cpu"))
    t = {k: [v.numpy() for v in vs] for k, vs in out.items()}
    samples = t["Samples"][0]
    np.testing.assert_array_equal(samples[:, :1], label)
    for what, drawn in (("port", samples), ("jax", j["Samples"][0])):
        _law_held(drawn[:, 1:], _log_uniform_law(c), what)
    q = np.log((samples + 2.0) / (samples + 1.0)) / np.log(c + 1.0) * s
    sub = np.take_along_axis(logits, samples, 1).astype(np.float64)
    sub[:, 1:] += np.where(samples[:, 1:] == label, -1e20, 0.0)
    sub -= np.log(q + 1e-12)
    np.testing.assert_allclose(t["SampledLogits"][0], sub, rtol=1e-5,
                               atol=1e-5)
    if op_type == "sample_logits":
        np.testing.assert_allclose(t["Probabilities"][0], q, rtol=1e-5)
        np.testing.assert_array_equal(t["SampledLabels"][0],
                                      np.zeros((n, 1), "int64"))
        np.testing.assert_array_equal(t["LogitsDim"][0], [n, c])
        return
    sub -= sub.max(1, keepdims=True)
    logp = sub - np.log(np.exp(sub).sum(1, keepdims=True))
    np.testing.assert_allclose(t["Loss"][0], -logp[:, :1], rtol=1e-5)


# -- the registry, persistence and control flow


_PORTED_MODULES = ("compare", "tensor", "nn", "classify", "control_flow",
                   "optimizer_ops", "sequence", "rnn", "crf", "beam",
                   "metrics_ops", "quant", "misc", "text_match", "detection")


def _unported_by_module():
    """{JAX ops module: the op types registered there that the port does
    not register}, from both live registries."""
    import inspect

    have = set(treg.registered_ops(made_at_lookup=False))
    out = {}
    for t, d in jreg._REGISTRY.items():
        if t.endswith("_grad") or t in have:
            continue
        mod = inspect.getmodule(d.kernel).__name__.rsplit(".", 1)[-1]
        out.setdefault(mod, []).append(t)
    return {m: sorted(v) for m, v in sorted(out.items())}


def test_registry_diff_names_every_unported_op():
    """The op types still to port, by the JAX module that registers them:
    none from the five modules the library's core ports, from
    optimizer_ops.py, from the sequence models' five (sequence, rnn,
    crf, beam, metrics_ops), from quant.py, misc.py, text_match.py or
    detection.py; the 11 parameter-server ops of distributed.py, each of
    which raises naming itself and ROADMAP item 21, the item that ports
    them (`registry.UNPORTED`)."""
    missing = _unported_by_module()
    print("still unported:", {m: len(v) for m, v in missing.items()})
    assert not set(missing) & set(_PORTED_MODULES), missing
    assert {m: len(v) for m, v in missing.items()} == {"distributed": 11}
    assert sorted(treg.UNPORTED) == missing["distributed"]
    for t in missing["distributed"]:
        with pytest.raises(KeyError, match=f"'{t}'.*ROADMAP item 21"):
            treg.get_op_def(t)
    with pytest.raises(KeyError, match="'no_such_op' is not registered"):
        treg.get_op_def("no_such_op")


def _tied(shape, seed, levels=4):
    """Values on a few levels: most entries tie with another."""
    rng = np.random.RandomState(seed)
    return np.round(rng.uniform(0, 1, shape) * levels).astype("float32")


@pytest.mark.parametrize("op_type, shape, attrs", [
    ("top_k", (4, 64), {"k": 12}),
    ("top_k", (3, 5, 20), {"k": 7}),
    ("top_k_v2", (6, 40), {"k": 9}),
    ("top_k_v2", (30, 5), {"k": 6, "axis": 0}),
    ("top_k_v2", (2, 25, 3), {"k": 4, "axis": 1}),
])
def test_top_k_breaks_ties_as_lax_top_k(op_type, shape, attrs):
    """ROADMAP F26: top_k and top_k_v2 on tied inputs equal the JAX
    ops, indices and values, through both registries (the port's
    `stable_top_k`: a stable descending sort, ties to the lower
    index)."""
    ins = {"X": [_tied(shape, len(shape) + attrs["k"])]}
    j = _run("jax", op_type, ins, attrs, {})
    t = _run("torch", op_type, ins, attrs, {})
    for k in ("Out", "Indices"):
        np.testing.assert_array_equal(t[k][0], j[k][0], err_msg=k)
    axis = attrs.get("axis", -1)
    order = np.argsort(-ins["X"][0], axis=axis, kind="stable")
    np.testing.assert_array_equal(
        t["Indices"][0], np.take(order, np.arange(attrs["k"]), axis=axis))


@pytest.mark.parametrize("k", [5, 40])
def test_sparse_allreduce_breaks_ties_as_lax_top_k(k):
    """F26: `sparse_allreduce` over four ranks of tied magnitudes picks
    the JAX package's entries (its `lax.top_k`, under a vmapped
    all_gather) where the ties straddle the k-th place."""
    import jax

    from paddle_tpu.ops.collective import sparse_allreduce as jsparse

    from paddle_tpu_torch.ops.collective import sparse_allreduce

    rng = np.random.RandomState(k)
    flats = np.round(rng.standard_normal((4, 96)) * 2).astype("float32")
    want = jax.vmap(lambda f: jsparse(f, k, "r"), axis_name="r")(
        jnp.asarray(flats))
    got = sparse_allreduce([torch.from_numpy(f) for f in flats], k)
    for r in range(4):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want[r]))


def test_beam_search_op_with_ties_matches_jax():
    """F26's helper in the beam_search op (k > 1) and its argmax path (k
    = 1) on a step whose candidates mostly tie: the JAX op's picks."""
    pre_ids = np.array([[4, 5, 6, 7], [3, 2, 9, 1]], "int64")
    pre_scores = np.array([[-1.0, -1.0, -2.0, -1.0],
                           [-0.5, -0.5, -0.5, -0.5]], "float32")
    scores = np.round(_tied((2, 4, 6), 3) * -1.0).astype("float32")
    outs = {"selected_ids": ["i"], "selected_scores": ["s"],
            "parent_idx": ["p"]}
    for beam in (1, 3, 4):
        attrs = {"beam_size": beam, "end_id": 0}
        ins = {"pre_ids": [pre_ids[:, :beam]],
               "pre_scores": [pre_scores[:, :beam]],
               "scores": [scores[:, :beam]]}
        j = _run("jax", "beam_search", ins, attrs, outs)
        t = _run("torch", "beam_search", ins, attrs, outs)
        for k in outs:
            np.testing.assert_array_equal(t[k][0], j[k][0], err_msg=k)


def _var_program(pkg, shapes):
    """A program declaring vars {name: (shape, dtype)}: the `load` ops'
    out vars."""
    main = pkg.Program()
    for n, (shape, dtype) in shapes.items():
        main.global_block().create_var(name=n, shape=shape, dtype=dtype)
    return main.desc


def _persist(pkg, op_type, names, xs, attrs, program=None):
    """One save/load kernel call through `pkg`'s registry."""
    if pkg == "jax":
        desc = JOpDesc(type=op_type, inputs={"X": names} if xs else {},
                       outputs={} if xs else {"Out": names}, attrs=attrs)
        ctx = jreg.KernelCtx(desc, program=program)
        vals = {"X": [jnp.asarray(x) for x in xs]} if xs else {}
        outs = jreg.get_op_def(op_type).call(vals, attrs, ctx)
    else:
        desc = TOpDesc(type=op_type, inputs={"X": names} if xs else {},
                       outputs={} if xs else {"Out": names}, attrs=attrs)
        ctx = treg.KernelCtx(desc, program=program, device="cpu")
        vals = {"X": [torch.from_numpy(x) for x in xs]} if xs else {}
        outs = treg.get_op_def(op_type).call(vals, attrs, ctx)
    return [np.asarray(o) for o in outs.get("Out", [])]


@pytest.mark.parametrize("writer, reader", [("torch", "jax"),
                                            ("jax", "torch")])
@pytest.mark.parametrize("combined", [False, True])
def test_save_load_files_cross_packages(tmp_path, writer, reader, combined):
    """`save` (`.npy`, resilience/atomic.np_save) and `save_combine`
    (`.npz`) files of one package are read back by the other's `load`
    and `load_combine`, with the declared shapes and dtypes."""
    import paddle_tpu as pt
    import paddle_tpu_torch as ptt

    rng = np.random.RandomState(0)
    xs = {"w": rng.standard_normal((3, 4)).astype("float32"),
          "ids": rng.randint(0, 9, (5,)).astype("int64")}
    shapes = {n: (list(x.shape), str(x.dtype)) for n, x in xs.items()}
    prog = _var_program(pt if reader == "jax" else ptt, shapes)
    if combined:
        path = str(tmp_path / "sub" / "all")
        _persist(writer, "save_combine", list(xs), list(xs.values()),
                 {"file_path": path})
        got = _persist(reader, "load_combine", list(xs), [],
                       {"file_path": path}, prog)
    else:
        got = []
        for n, x in xs.items():
            path = str(tmp_path / "sub" / n)
            _persist(writer, "save", [n], [x], {"file_path": path})
            got += _persist(reader, "load", [n], [], {"file_path": path},
                            prog)
    for g, x in zip(got, xs.values()):
        assert g.dtype == x.dtype
        np.testing.assert_array_equal(g, x)


def _loops(pkg):
    """A `While` (the op `while`) doubling an accumulator 5 times and a
    `while_loop` (`while_v2`) counting to 10 while it sums x."""
    main, startup = pkg.Program(), pkg.Program()
    L = pkg.layers
    with pkg.framework.unique_name.guard(), pkg.program_guard(main, startup):
        x = L.data(name="x", shape=[3], dtype="float32",
                   append_batch_size=False)
        i = L.fill_constant([1], "int64", 0)
        n = L.fill_constant([1], "int64", 5)
        acc = L.assign(x)
        cond = L.less_than(i, n)
        w = L.While(cond)
        with w.block():
            L.assign(L.scale(acc, scale=2.0), acc)
            L.increment(i, in_place=True)
            L.less_than(i, n, cond=cond)
        ten = L.fill_constant([1], "float32", 10.0)
        k0 = L.fill_constant([1], "float32", 0.0)
        k, total = L.while_loop(
            lambda k, s: L.less_than(k, ten),
            lambda k, s: [L.elementwise_add(k, L.fill_constant(
                [1], "float32", 1.0)), L.elementwise_add(s, x)],
            [k0, L.assign(x)])
    return main, [acc, i, k, total]


def _static_rnn(pkg, T=5, H=4):
    """A StaticRNN (the op `scan`) h_t = tanh(fc(x_t) + h_{t-1} W),
    its mean as the loss, and the gradients of both weights and x."""
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 3
    L = pkg.layers
    with pkg.framework.unique_name.guard(), pkg.program_guard(main, startup):
        x = L.data(name="x", shape=[T, 2, 3], dtype="float32",
                   append_batch_size=False)
        x.stop_gradient = False
        w = L.create_parameter([H, H], "float32", name="rnn_w")
        rnn = L.StaticRNN()
        with rnn.step():
            xt = rnn.step_input(x)
            h = rnn.memory(shape=[2, H], init_value=0.0)
            h2 = L.tanh(L.elementwise_add(L.fc(xt, size=H), L.matmul(h, w)))
            rnn.update_memory(h, h2)
            rnn.step_output(h2)
        loss = L.mean(rnn())
        params = [p.name for p in main.all_parameters()]
        grads = pkg.backward.gradients(
            loss, [x] + [main.global_block().var(p) for p in params])
    return main, startup, [loss] + grads


def test_while_ops_match_jax():
    import paddle_tpu as pt
    import paddle_tpu_torch as ptt

    (mj, fj), (mt, ft) = _loops(pt), _loops(ptt)
    assert mt.desc.to_dict() == mj.desc.to_dict()
    assert {"while", "while_v2"} <= {op.type for op in mt.desc.block(0).ops}
    feed = {"x": np.array([1.0, -2.0, 0.5], "float32")}
    want = pt.Executor(pt.CPUPlace()).run(mj, feed=feed, fetch_list=fj,
                                          scope=pt.Scope())
    got = ptt.Executor(ptt.CPUPlace()).run(mt, feed=feed, fetch_list=ft,
                                           scope=ptt.Scope())
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_array_equal(got[0], feed["x"] * 32)


def test_scan_and_its_gradient_match_jax():
    """StaticRNN's `scan` forward and its generic gradient (the steps
    replayed under autograd) against the JAX package's from the same
    params."""
    import paddle_tpu as pt
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.convert import scope_from_numpy

    mj, sj, fj = _static_rnn(pt)
    mt, st, ft = _static_rnn(ptt)
    assert mt.desc.to_dict() == mj.desc.to_dict()
    scj = pt.Scope()
    pt.Executor(pt.CPUPlace()).run(sj, scope=scj)
    sct = scope_from_numpy(ptt.Scope(), {
        v.name: scj.get(v.name) for v in sj.list_vars() if v.persistable},
        ptt.CPUPlace())
    feed = {"x": np.random.RandomState(0).standard_normal(
        (5, 2, 3)).astype("float32")}
    want = pt.Executor(pt.CPUPlace()).run(
        mj, feed=feed, fetch_list=[v.name for v in fj], scope=scj)
    got = ptt.Executor(ptt.CPUPlace()).run(
        mt, feed=feed, fetch_list=[v.name for v in ft], scope=sct)
    for a, b in zip(got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=1e-5,
                                   atol=1e-6 * np.abs(b).max())
