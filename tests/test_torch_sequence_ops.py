"""The sequence ops of the fluid path (`paddle_tpu_torch/ops/sequence.py`,
the JAX package's `ops/sequence.py`, all seventeen) against the JAX
kernels on the same numpy inputs from a seed: forward, and the generic
`<op>_grad` where the op is differentiable (every floating input's
gradient, a random cotangent on every floating output).

Ragged lengths with a length-0 row throughout, and each place where the
JAX primitive does what torch would refuse: a runtime slice offset out
of range is clamped, a scatter id out of range is dropped and a negative
one wraps, im2sequence's features come in (C, kh, kw) order at kh != kw
and strides != 1, and sequence_erase compacts stably.

Tolerances (`test_torch_fluid_ops.TOL`, on float32): masks, gathers,
pads and pools rtol 1e-5 ("ew", "reduce"); im2sequence's patches are
exact copies, held at the same; integer and boolean outputs exactly.
The JAX side runs under the suite's x64, where every op here keeps the
dtype its code declares.
"""

import numpy as np
import pytest
import torch

from paddle_tpu.core import registry as jreg
from paddle_tpu.core.ir import OpDesc as JOpDesc, VarDesc as JVarDesc

from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core.ir import OpDesc as TOpDesc, VarDesc as TVarDesc
from test_torch_fluid_ops import _c, _held, _lit, _make, _run, _spec


def check_op(op_type, spec, attrs, cls, seed=None):
    """Forward through both registries, then `<op>_grad` where the JAX
    op has one; every output held by `_held` under `cls`. Returns the
    port's forward outputs."""
    rng = np.random.RandomState(sum(map(ord, op_type)) if seed is None
                                else seed)
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
        return ft
    gins, gouts = {}, {}
    for slot, vals in ins.items():
        gins["fwd_in::" + slot] = vals
        if all(np.issubdtype(x.dtype, np.floating) for x in vals):
            gouts["in_grad::" + slot] = [f"g{slot}{i}"
                                        for i in range(len(vals))]
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
    return ft


LEN4 = _lit([6, 0, 3, 1], "int64")          # ragged, with a length-0 row
X463 = _spec((4, 6, 3))

SEQUENCE_CASES = (
    [_c("sequence_mask", {"X": [LEN4]}, {"maxlen": 7}),
     _c("sequence_mask", {"X": [LEN4]}, {"maxlen": -1,
                                          "out_dtype": "float32"},
        name="sequence_mask_maxlen_from_x")]
    + [_c("sequence_pool", {"X": [X463], "Length": [LEN4]},
          {"pooltype": p}, "reduce", name=f"sequence_pool_{p.lower()}")
       for p in ("SUM", "AVERAGE", "SQRT", "MAX", "LAST", "FIRST")]
    + [_c("sequence_pool", {"X": [X463]}, {"pooltype": "MAX"}, "reduce",
          name="sequence_pool_max_no_length"),
       _c("sequence_softmax", {"X": [_spec((4, 6))], "Length": [LEN4]}),
       _c("sequence_softmax", {"X": [_spec((4, 6))]},
          name="sequence_softmax_no_length"),
       _c("sequence_reverse", {"X": [X463], "Length": [LEN4]}),
       _c("sequence_reverse", {"X": [X463]},
          name="sequence_reverse_no_length"),
       _c("sequence_expand", {"X": [_spec((2, 2, 3))],
                              "Y": [_spec((2, 6, 1))]}),
       _c("sequence_concat", {"X": [_spec((2, 3, 4)), _spec((2, 2, 4))]}),
       _c("sequence_slice", {"X": [X463]}, {"offset": 2, "length": 3},
          name="sequence_slice_attr"),
       _c("sequence_slice", {"X": [X463], "Offset": [_lit([1], "int64")]},
          {"length": 3}),
       # a runtime offset past T - length clamps to it; a negative one
       # counts from the end first (-2 is 4 here, clamped to 2)
       _c("sequence_slice", {"X": [X463], "Offset": [_lit([7], "int64")]},
          {"length": 4}, name="sequence_slice_offset_clamped_high"),
       _c("sequence_slice", {"X": [X463], "Offset": [_lit([-2], "int64")]},
          {"length": 4}, name="sequence_slice_offset_clamped_low"),
       # kh != kw, strides != 1, asymmetric paddings [top, left, bottom,
       # right]
       _c("im2sequence", {"X": [_spec((2, 3, 7, 8))]},
          {"kernels": [2, 3], "strides": [2, 1],
           "paddings": [1, 0, 0, 2]}),
       _c("im2sequence", {"X": [_spec((2, 2, 6, 9))]},
          {"kernels": [3, 2], "strides": [1, 3]},
          name="im2sequence_wide_stride"),
       _c("sequence_pad", {"X": [X463], "PadValue": [_lit([2.5], "float32")],
                           "Length": [LEN4]}, {"padded_length": 8}),
       _c("sequence_pad", {"X": [X463],
                           "PadValue": [_lit([1.0, -1.0, 3.0], "float32")],
                           "Length": [LEN4]}, {"padded_length": 4},
          name="sequence_pad_truncate_step_value"),
       _c("sequence_pad", {"X": [X463]}, {}, name="sequence_pad_defaults"),
       _c("sequence_unpad", {"X": [X463], "Length": [LEN4]}),
       _c("sequence_enumerate", {"X": [_spec((4, 6), "int9", "int64")],
                                 "Length": [LEN4]},
          {"win_size": 3, "pad_value": 9}),
       _c("sequence_enumerate", {"X": [_spec((2, 5), "int9", "int32")]},
          {"win_size": 2}, name="sequence_enumerate_no_length"),
       _c("sequence_erase", {"X": [_lit([[2, 1, 5, 3, 2, 4],
                                         [5, 5, 1, 2, 0, 1],
                                         [3, 2, 1, 0, 2, 2],
                                         [4, 2, 0, 0, 0, 0]], "int64")],
                             "Length": [LEN4]}, {"tokens": [2, 5]}),
       _c("sequence_erase", {"X": [_spec((3, 7), "int6", "int32")]},
          {"tokens": [0, 3]}, name="sequence_erase_no_length"),
       _c("sequence_expand_as", {"X": [_spec((3, 4))],
                                 "Y": [_spec((3, 5, 1))]}),
       _c("sequence_expand_as", {"X": [_spec((3, 1, 4))],
                                 "Y": [_spec((3, 5, 1))]},
          name="sequence_expand_as_rank3"),
       _c("sequence_reshape", {"X": [_spec((2, 4, 6))]}, {"new_dim": 8}),
       # ids past D are dropped; -1 wraps to D - 1, -8 (< -D) is dropped
       _c("sequence_scatter", {"X": [_spec((4, 6))],
                               "Ids": [_lit([[0, 5, -1, 9, 2, 2],
                                             [1, 6, 3, 3, -8, 0],
                                             [2, 2, 2, 2, 2, 2],
                                             [-6, 4, 7, 0, 1, 1]], "int64")],
                               "Updates": [_spec((4, 6))],
                               "Length": [LEN4]}),
       _c("sequence_scatter", {"X": [_spec((2, 5))],
                               "Ids": [_spec((2, 3), "int5", "int32")],
                               "Updates": [_spec((2, 3))]},
          name="sequence_scatter_no_length"),
       _c("sequence_topk_avg_pooling",
          {"X": [_spec((2, 3, 4, 5))], "ROW": [_lit([4, 2], "int64")],
           "COLUMN": [_lit([5, 2], "int64")]}, {"topks": [1, 3, 7]},
          "reduce"),
       _c("sequence_topk_avg_pooling", {"X": [_spec((2, 2, 3, 4))]},
          {"topks": [2]}, "reduce", name="sequence_topk_avg_pooling_plain"),
       ])


@pytest.mark.parametrize("op_type, spec, attrs, cls", SEQUENCE_CASES)
def test_sequence_op_matches_jax(op_type, spec, attrs, cls):
    check_op(op_type, spec, attrs, cls)


def test_every_sequence_op_has_a_case():
    """The seventeen op types the JAX module registers, each a case here
    or (sequence_conv) in test_torch_fluid_ops.py."""
    import inspect

    jax_ops = {t for t, d in jreg._REGISTRY.items()
               if not t.endswith("_grad") and
               inspect.getmodule(d.kernel).__name__ == "paddle_tpu.ops.sequence"}
    assert len(jax_ops) == 17
    covered = {p.values[0] for p in SEQUENCE_CASES} | {"sequence_conv"}
    assert covered == jax_ops, jax_ops ^ covered


def _out(op_type, ins, attrs):
    return _run("torch", op_type, ins, attrs, {})


def test_sequence_slice_offset_wraps_and_clamps():
    """A runtime offset reads as lax.dynamic_slice reads it: a negative
    one counts from the end, then the start is clamped into
    [0, T - length]."""
    x = np.arange(2 * 6 * 1, dtype="float32").reshape(2, 6, 1)
    hi = _out("sequence_slice", {"X": [x], "Offset": [_lit([9], "int64")]},
              {"length": 4})["Out"][0]
    np.testing.assert_array_equal(hi, x[:, 2:6])
    wrapped = _out("sequence_slice",
                   {"X": [x], "Offset": [_lit([-3], "int64")]},
                   {"length": 2})["Out"][0]
    np.testing.assert_array_equal(wrapped, x[:, 3:5])
    lo = _out("sequence_slice", {"X": [x], "Offset": [_lit([-9], "int64")]},
              {"length": 2})["Out"][0]
    np.testing.assert_array_equal(lo, x[:, 0:2])


def test_sequence_scatter_drops_and_wraps_like_jax_at_add():
    x = np.zeros((1, 4), "float32")
    got = _out("sequence_scatter",
               {"X": [x], "Ids": [_lit([[-1, 4, -5, 1, 1]], "int64")],
                "Updates": [_lit([[1, 2, 4, 8, 16]], "float32")]},
               {})["Out"][0]
    np.testing.assert_array_equal(got, [[0, 24, 0, 1]])


def test_im2sequence_feature_order_is_channel_kh_kw():
    """One patch read by hand: the feature index is c * kh * kw +
    i * kw + j."""
    rng = np.random.RandomState(0)
    x = rng.standard_normal((1, 2, 5, 7)).astype("float32")
    got = _out("im2sequence", {"X": [x]},
               {"kernels": [2, 3], "strides": [2, 2]})["Out"][0]
    oh, ow = (5 - 2) // 2 + 1, (7 - 3) // 2 + 1
    assert got.shape == (1, oh * ow, 2 * 2 * 3)
    r, s = 1, 2                                   # output position (1, 2)
    want = x[0, :, 2 * r:2 * r + 2, 2 * s:2 * s + 3].reshape(-1)
    np.testing.assert_array_equal(got[0, r * ow + s], want)


def test_sequence_erase_compacts_stably():
    x = _lit([[7, 2, 8, 2, 9, 2, 6]], "int64")
    out = _out("sequence_erase", {"X": [x], "Length": [_lit([6], "int64")]},
               {"tokens": [2]})
    np.testing.assert_array_equal(out["Out"][0], [[7, 8, 9, 0, 0, 0, 0]])
    np.testing.assert_array_equal(out["Length"][0], [3])


@pytest.mark.parametrize("op_type, ins, outs, attrs", [
    ("sequence_pool", {"X": ("x", (-1, 6, 3), "float32"),
                       "Length": ("l", (-1,), "int64")},
     {"Out": ["o"]}, {"pooltype": "MAX"}),
    ("sequence_pad", {"X": ("x", (-1, 6, 3), "float32"),
                      "Length": ("l", (-1,), "int64")},
     {"Out": ["o"], "Length": ["ol"]}, {"padded_length": 9}),
    ("sequence_slice", {"X": ("x", (-1, 6, 3), "float32"),
                        "Offset": ("f", (1,), "int64")},
     {"Out": ["o"]}, {"length": 2}),
    ("im2sequence", {"X": ("x", (-1, 3, 7, 8), "float32")},
     {"Out": ["o"]}, {"kernels": [2, 3], "strides": [2, 1]}),
    ("sequence_erase", {"X": ("x", (-1, 7), "int64")},
     {"Out": ["o"], "Length": ["ol"]}, {"tokens": [1]}),
])
def test_sequence_shape_inference_matches_jax(op_type, ins, outs, attrs):
    """`infer_op_outputs` on meta tensors, against the JAX package's
    `jax.eval_shape`: -1 dims stay -1, dtypes by name."""
    inputs = {slot: [n] for slot, (n, _, _) in ins.items()}
    got = treg.infer_op_outputs(
        TOpDesc(type=op_type, inputs=inputs, outputs=outs, attrs=attrs),
        {n: TVarDesc(n, shape=s, dtype=d) for n, s, d in ins.values()})
    want = jreg.infer_op_outputs(
        JOpDesc(type=op_type, inputs=inputs, outputs=outs, attrs=attrs),
        {n: JVarDesc(n, shape=s, dtype=d) for n, s, d in ins.values()})
    assert {k: (tuple(v.shape), v.dtype) for k, v in got.items()} == {
        k: (tuple(v.shape), str(np.dtype(v.dtype))) for k, v in want.items()}


def outputs_stay_on_meta(op_type, ins, attrs):
    """Run the port's kernel on meta copies of `ins` (numpy arrays) and
    assert that every output is on meta: an op that made a tensor on
    another device than its inputs' would fail or come back there. Meta
    stands in for the card here."""
    vals = {slot: [None if x is None else torch.from_numpy(np.array(x))
                   .to("meta") for x in xs] for slot, xs in ins.items()}
    desc = TOpDesc(type=op_type, attrs=attrs)
    outs = treg.get_op_def(op_type).call(vals, attrs,
                                         treg.KernelCtx(desc, device="meta"))
    for slot, vs in outs.items():
        for v in vs:
            assert v is None or v.device.type == "meta", (op_type, slot)


def cases_stay_on_meta(cases, seed=0):
    rng = np.random.RandomState(seed)
    for p in cases:
        op_type, spec, attrs, _ = p.values
        outputs_stay_on_meta(op_type, {slot: [_make(rng, s) for s in specs]
                                       for slot, specs in spec.items()},
                             attrs)


def test_no_op_leaves_the_device_it_was_given():
    """Every case's forward on meta inputs comes back on meta, but
    sequence_mask reading its maxlen from X (a host read by
    definition)."""
    cases_stay_on_meta([p for p in SEQUENCE_CASES
                        if p.id != "sequence_mask_maxlen_from_x"])
