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
