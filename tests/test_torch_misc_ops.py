"""The JAX package's `ops/misc.py` op types the port adds
(`paddle_tpu_torch/ops/misc.py`: 33 of them) against the JAX kernels on
the same numpy inputs from a seed, at the shapes of
`tests/test_misc_ops.py`: forward, and the generic `<op>_grad` where the
op is differentiable (every floating input's gradient under a random
cotangent on every floating output, `check_op`).

Tolerances, on float32 (`test_torch_fluid_ops.TOL`): elementwise ops and
losses rtol 1e-5 with an atol of 1e-6 of the largest reference value
("ew", "reduce"); products (fsp, npair_loss, affine_grid's einsum)
1e-4 ("mm"); integer outputs (edit distances, alignments, IoU counts)
exactly. Under the suite's x64 three JAX ops compute in float64 where
their code declares no dtype (affine_grid's linspace, the position
encoding's numpy constant, optax's CTC alphas); the port computes in
the input's float32, as the JAX package does without x64, and the test
compares its float32 with the float64 reference at the same limits.

`warpctc` is held on a batch with a row whose label cannot fit its
frames: its loss is large and finite (optax's log(0) stand-in, -1e5)
and held at rtol 1e-5; its `WarpCTCGrad` there is held at 5e-3 of the
largest gradient, since log-alphas near -1e5 carry f32's ulp there,
0.0078, into every logaddexp (JAX at float32 differs from float64 by
2e-3 on that row too); the feasible rows at 1e-5. Random ops are held
to their law (shape, dtype, range, moments) against the JAX op's.
"""

import numpy as np
import pytest
import torch

from paddle_tpu.core import registry as jreg

from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core.ir import OpDesc as TOpDesc
from test_torch_fluid_ops import TOL, _c, _lit, _make, _names, _run, _spec

# ops whose JAX kernel computes in float64 under x64 (see above)
_F64_UNDER_X64 = {"affine_grid", "add_position_encoding", "warpctc"}


def _held(got, want, cls, what, op_type):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if op_type in _F64_UNDER_X64 and want.dtype == np.float64:
        assert got.dtype == np.float32, (what, got.dtype)
        want = want.astype(np.float32)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    if want.dtype == np.bool_ or np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    rtol, atol = TOL[cls]
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * scale,
                               err_msg=what)


def check_op(op_type, spec, attrs, cls, seed=None):
    """Forward through both registries, then `<op>_grad` where the JAX
    op has one. Returns the port's forward outputs."""
    rng = np.random.RandomState(sum(map(ord, op_type)) if seed is None
                                else seed)
    ins = {slot: [_make(rng, s) for s in specs]
           for slot, specs in spec.items()}
    fj = _run("jax", op_type, ins, attrs, {})
    ft = _run("torch", op_type, ins, attrs, {})
    assert sorted(fj) == sorted(ft), (sorted(fj), sorted(ft))
    for slot, vals in fj.items():
        assert len(vals) == len(ft[slot]), slot
        for i, v in enumerate(vals):
            _held(ft[slot][i], v, cls, f"{op_type} {slot}[{i}]", op_type)
    if not jreg.get_op_def(op_type).has_grad():
        assert not treg.get_op_def(op_type).has_grad()
        return ft
    assert treg.get_op_def(op_type).has_grad()
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
            _held(gt[slot][i], v, cls, f"{op_type}_grad {slot}[{i}]",
                  op_type)
    return ft


X2344 = _spec((2, 3, 4, 4))
LAB_TS = _lit([[-2.0], [-1.0], [-0.5], [0.3], [0.7], [1.4]], "float32")
HYPS = _lit([[1, 2, 3, 0, 5], [1, 1, 1, 1, 1], [4, 0, 2, 0, 2],
             [3, 3, 1, 2, 4]], "int64")
REFS = _lit([[1, 3, 3, 0, 0, 2], [2, 2, 2, 2, 0, 0], [4, 2, 0, 2, 1, 1],
             [0, 0, 0, 0, 0, 0]], "int64")
HLEN = _lit([3, 5, 5, 0], "int64")
RLEN = _lit([3, 4, 6, 2], "int64")

MISC_CASES = [
    _c("affine_channel", {"X": [X2344], "Scale": [_spec((3,))],
                          "Bias": [_spec((3,))]}),
    _c("affine_channel", {"X": [_spec((2, 4, 4, 3))], "Scale": [_spec((3,))],
                          "Bias": [_spec((3,))]}, {"data_layout": "NHWC"},
       name="affine_channel_nhwc"),
    _c("affine_grid", {"Theta": [_spec((2, 2, 3))]},
       {"output_shape": [2, 1, 3, 4]}, "mm"),
    _c("lrn", {"X": [_spec((1, 6, 3, 3), "pos")]},
       {"n": 5, "k": 2.0, "alpha": 1e-4, "beta": 0.75}),
    _c("data_norm", {"X": [_spec((4, 3))], "BatchSize": [_spec((3,), "pos")],
                     "BatchSum": [_spec((3,))],
                     "BatchSquareSum": [_spec((3,), "pos")]}),
    _c("shuffle_channel", {"X": [_spec((2, 6, 2, 2))]}, {"group": 3}),
    _c("space_to_depth", {"X": [_spec((1, 2, 4, 4))]}, {"blocksize": 2}),
    _c("unfold", {"X": [_spec((1, 2, 5, 5))]},
       {"kernel_sizes": [2, 3], "strides": [2, 1],
        "paddings": [1, 0, 0, 1], "dilations": [1, 2]}),
    _c("crop", {"X": [_spec((2, 3, 4))]},
       {"shape": [1, 2, 2], "offsets": [1, 1, 2]}),
    _c("crop", {"X": [_spec((2, 3, 4))], "Y": [_spec((1, 2, 2))],
                "Offsets": [_lit([1, 0, 1], "int64")]}, name="crop_by_y"),
    _c("crop_tensor", {"X": [_spec((2, 3, 4))],
                       "Offsets": [_lit([0, 0, 1], "int64")]},
       {"shape": [2, 2, 2]}),
    # a runtime offset past the end is clamped, as dynamic_slice does
    _c("crop_tensor", {"X": [_spec((2, 3, 4))],
                       "Offsets": [_lit([1, 5, -3], "int64")]},
       {"shape": [-1, 2, 2]}, name="crop_tensor_clamped"),
    _c("add_position_encoding", {"X": [_spec((2, 5, 8))]},
       {"alpha": 0.5, "beta": 2.0}),
    _c("add_position_encoding", {"X": [_spec((2, 4, 7))]}, {},
       name="add_position_encoding_odd"),
    _c("rank_loss", {"Label": [_spec((5, 1), "bin", "float32")],
                     "Left": [_spec((5, 1))], "Right": [_spec((5, 1))]}),
    _c("bpr_loss", {"X": [_spec((4, 5))], "Label": [_spec((4, 1), "int5",
                                                          "int64")]},
       cls="reduce"),
    _c("npair_loss", {"Anchor": [_spec((4, 6))], "Positive": [_spec((4, 6))],
                      "Labels": [_lit([0, 1, 0, 2], "int64")]},
       {"l2_reg": 0.002}, "mm"),
    _c("center_loss", {"X": [_spec((4, 3))],
                       "Label": [_lit([[0], [2], [0], [1]], "int64")],
                       "Centers": [_spec((3, 3))],
                       "CenterUpdateRate": [_lit([0.5], "float32")]},
       {"update_center": True}, "reduce"),
    _c("teacher_student_sigmoid_loss", {"X": [_spec((6, 1), "wide")],
                                        "Label": [LAB_TS]}),
    _c("modified_huber_loss", {"X": [_spec((6, 1), "wide")],
                               "Y": [_spec((6, 1), "bin", "float32")]}),
    _c("edit_distance", {"Hyps": [HYPS], "Refs": [REFS],
                         "HypsLength": [HLEN], "RefsLength": [RLEN]},
       {"normalized": False}),
    _c("edit_distance", {"Hyps": [HYPS], "Refs": [REFS],
                         "HypsLength": [HLEN], "RefsLength": [RLEN]},
       {"normalized": True, "ignored_tokens": [0, 2]},
       name="edit_distance_ignored_normalized"),
    _c("edit_distance", {"Hyps": [_spec((6, 9), "int4", "int64")],
                         "Refs": [_spec((6, 7), "int4", "int64")]},
       {"normalized": True}, name="edit_distance_full_rows"),
    _c("ctc_align", {"Input": [_lit([[0, 1, 1, 0, 2, 2, 3, 0],
                                     [3, 3, 0, 3, 1, 0, 0, 2]], "int64")],
                     "InputLength": [_lit([8, 6], "int64")]},
       {"blank": 0, "merge_repeated": True}),
    _c("ctc_align", {"Input": [_lit([[0, 1, 1, 0, 2, 2, 3, 0]], "int64")]},
       {"blank": 2, "merge_repeated": False}, name="ctc_align_no_merge"),
    _c("multiplex", {"X": [_spec((4, 5))] * 3,
                     "Ids": [_lit([[2], [0], [1], [2]], "int32")]}),
    _c("minus", {"X": [_spec((3, 4))], "Y": [_spec((3, 4))]}),
    _c("fsp", {"X": [_spec((2, 3, 4, 5))], "Y": [_spec((2, 6, 4, 5))]},
       cls="mm"),
    _c("mean_iou", {"Predictions": [_lit([0, 0, 1, 1, 2], "int64")],
                    "Labels": [_lit([0, 1, 1, 1, 2], "int64")]},
       {"num_classes": 4}),
    _c("mean_iou", {"Predictions": [_spec((4, 6), "int5", "int64")],
                    "Labels": [_spec((4, 6), "int5", "int64")],
                    "InWrongs": [_lit([1, 0, 2, 0, 1], "int32")],
                    "InCorrects": [_lit([0, 3, 1, 1, 0], "int32")],
                    "InMeanIou": [_lit([0.25], "float32")]},
       {"num_classes": 5}, name="mean_iou_streaming"),
    _c("similarity_focus", {"X": [_spec((2, 3, 4, 5))]},
       {"axis": 1, "indexes": [0, 2]}),
    _c("similarity_focus", {"X": [_spec((2, 4, 3, 5))]},
       {"axis": 2, "indexes": [1]}, name="similarity_focus_axis2"),
    _c("coalesce_tensor", {"Input": [_spec((2, 3)), _spec((4,)),
                                     _spec((1, 2, 2))]}),
    _c("coalesce_tensor", {"Input": [_spec((2, 3)), _spec((4,))]},
       {"set_constant": True, "constant": 0.5},
       name="coalesce_tensor_constant"),
    _c("fake_init", {}, {"shape": [3, 4], "dtype": "float32"}),
    _c("delete_var", {"X": [_spec((2, 2))]}),
    _c("ref_by_trainer_id", {"X": [_spec((2, 3))] * 3,
                             "TrainerId": [_lit([1], "int64")]}),
]


@pytest.mark.parametrize("op_type, spec, attrs, cls", MISC_CASES)
def test_misc_op_forward_and_generic_gradient(op_type, spec, attrs, cls):
    check_op(op_type, spec, attrs, cls)


_CTC_INS = {"Logits": [_spec((3, 6, 5))],
            "Label": [_lit([[2, 4, 1, 3], [3, 3, 1, 1], [1, 1, 1, 1]],
                           "int64")],
            "LogitsLength": [_lit([6, 5, 3], "int64")],
            "LabelLength": [_lit([3, 2, 4], "int64")]}


@pytest.mark.parametrize("norm_by_times", [False, True])
def test_warpctc_loss_and_grad_with_an_infeasible_row(norm_by_times):
    """Row 2's four repeated labels need 7 frames and have 3: a large
    finite loss in both packages. Loss, WarpCTCGrad and the generic
    gradient of the loss."""
    rng = np.random.RandomState(5)
    ins = {k: [_make(rng, s) for s in v] for k, v in _CTC_INS.items()}
    attrs = {"blank": 0, "norm_by_times": norm_by_times}
    outs = {"Loss": ["l"], "WarpCTCGrad": ["g"]}
    fj = _run("jax", "warpctc", ins, attrs, outs)
    ft = _run("torch", "warpctc", ins, attrs, outs)
    lj, lt = fj["Loss"][0], ft["Loss"][0]
    assert lt.shape == (3, 1) and lt.dtype == np.float32
    assert np.isfinite(lt).all() and lt[2, 0] > 1e4 / (3 if norm_by_times
                                                       else 1)
    np.testing.assert_allclose(lt, lj, rtol=1e-5)
    gj, gt = fj["WarpCTCGrad"][0], ft["WarpCTCGrad"][0]
    assert gt.dtype == np.float32 and gj.dtype == np.float32
    top = float(np.abs(gj).max())
    np.testing.assert_allclose(gt[:2], gj[:2], rtol=0, atol=1e-5 * top)
    np.testing.assert_allclose(gt[2], gj[2], rtol=0, atol=5e-3 * top)
    # the generic gradient of Loss under a random cotangent
    cot = rng.standard_normal((3, 1))
    gins = {"fwd_in::" + k: v for k, v in ins.items()}
    gins.update({"fwd_out::Loss": [lj], "fwd_out::WarpCTCGrad": [gj],
                 "out_grad::Loss": [cot], "out_grad::WarpCTCGrad": [None]})
    gouts = {"in_grad::Logits": ["gl"]}
    dj = _run("jax", "warpctc_grad", gins, attrs, gouts)["in_grad::Logits"][0]
    dt = _run("torch", "warpctc_grad", gins, attrs,
              gouts)["in_grad::Logits"][0]
    top = float(np.abs(dj).max())
    np.testing.assert_allclose(dt[:2], dj[:2], rtol=0, atol=1e-5 * top)
    np.testing.assert_allclose(dt[2], dj[2], rtol=0, atol=5e-3 * top)


def _law(op_type, attrs, ins, seeds=(11, 11, 12)):
    desc = TOpDesc(type=op_type, inputs=_names(ins), attrs=attrs)
    vals = {k: [torch.from_numpy(np.array(x)) for x in v]
            for k, v in ins.items()}
    return [treg.get_op_def(op_type).call(
        vals, attrs, treg.KernelCtx(desc, rng_key=s, device="cpu"))["Out"][0]
        for s in seeds]


@pytest.mark.parametrize("op_type, attrs", [
    ("uniform_random_batch_size_like", {"shape": [-1, 500], "min": -0.5,
                                        "max": 1.5}),
    ("gaussian_random_batch_size_like", {"shape": [-1, 500], "mean": 2.0,
                                         "std": 0.5}),
    ("uniform_random_batch_size_like", {"shape": [40, -1],
                                        "input_dim_idx": 0,
                                        "output_dim_idx": 1, "min": 0.0,
                                        "max": 1.0}),
])
def test_batch_size_like_random_laws(op_type, attrs):
    """Shape, dtype and law against the JAX op's draw (the uniform's
    range, the normal's share beyond 3 std); the draw replays from
    (step seed, uid)."""
    attrs = dict(attrs, __rng_uid__=4)
    ins = {"Input": [np.zeros((70, 3), "float32")]}
    (j,) = _run("jax", op_type, ins, attrs, {})["Out"]
    a, b, c = _law(op_type, attrs, ins)
    t = a.numpy()
    assert t.shape == j.shape and t.dtype == j.dtype
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert abs(t.mean() - j.mean()) < 0.03 * max(1.0, j.std())
    assert abs(t.std() - j.std()) < 0.03 * j.std()
    if op_type.startswith("uniform"):
        assert attrs["min"] <= t.min() and t.max() <= attrs["max"]
    else:
        tails = [float((np.abs(v - attrs["mean"]) > 3 * attrs["std"]).mean())
                 for v in (t, j)]
        assert abs(tails[0] - tails[1]) < 2e-3, tails


def test_random_crop_windows_are_uniform_and_contiguous():
    """Every crop is a contiguous window of X at an offset in range, the
    offsets of 400 draws cover every start about equally, as the JAX
    op's uniform randint does, and one seed replays."""
    x = np.arange(100, dtype="float32").reshape(10, 10)
    attrs = {"shape": [4, 4], "__rng_uid__": 2}
    (j,) = _run("jax", "random_crop", {"X": [x]}, attrs, {})["Out"]
    assert j.shape == (4, 4)
    starts = []
    for s in range(400):
        (out,) = _law("random_crop", attrs, {"X": [x]}, seeds=(s,))
        out = out.numpy()
        r0, c0 = divmod(int(out[0, 0]), 10)
        np.testing.assert_array_equal(out, x[r0:r0 + 4, c0:c0 + 4])
        starts.append((r0, c0))
    rows, cols = np.bincount([r for r, _ in starts], minlength=7), \
        np.bincount([c for _, c in starts], minlength=7)
    assert len(rows) == len(cols) == 7
    assert rows.min() > 30 and cols.min() > 30     # 400 / 7 = 57 each
    a, b = _law("random_crop", attrs, {"X": [x]}, seeds=(3, 3))
    assert torch.equal(a, b)


def test_sampling_id_follows_the_row_probabilities():
    """One-hot rows always give their class, as the JAX op does; a
    spread row's draws follow its probabilities."""
    probs = np.array([[0.0, 1.0, 0.0], [1.0, 0.0, 0.0]], "float32")
    attrs = {"__rng_uid__": 1}
    (j,) = _run("jax", "sampling_id", {"X": [probs]}, attrs, {})["Out"]
    (t,) = _law("sampling_id", attrs, {"X": [probs]}, seeds=(1,))
    assert t.dtype == torch.int64 and t.numpy().dtype == j.dtype
    np.testing.assert_array_equal(t.numpy(), j)
    p = np.tile(np.array([[0.1, 0.6, 0.3]], "float32"), (4000, 1))
    (t,) = _law("sampling_id", attrs, {"X": [p]}, seeds=(7,))
    freq = np.bincount(t.numpy(), minlength=3) / 4000
    np.testing.assert_allclose(freq, p[0], atol=0.03)


def test_py_func_forward_and_backward_callables():
    """One forward and one backward callable, registered in both
    packages, on host arrays: tanh and its gradient, a -1 batch dim, a
    None gradient padded with zeros; the outputs come back as tensors
    of the declared dtype."""
    import paddle_tpu.ops.misc as jmisc
    import paddle_tpu_torch.ops.misc as tmisc

    def fwd(x, y):
        return np.tanh(x) * 2.0, (x.sum(1) + y.sum(1)).astype("float64")

    def bwd(x, y, out0, out1, g0, g1):
        return g0 * 2.0 * (1.0 - np.tanh(x) ** 2) + g1[:, None], None

    rng = np.random.RandomState(0)
    x = rng.standard_normal((4, 3)).astype("float32")
    y = rng.standard_normal((4, 2)).astype("float32")
    got = {}
    for pkg, mod in (("jax", jmisc), ("torch", tmisc)):
        attrs = {"forward_callable_id": mod.register_py_func(fwd),
                 "backward_callable_id": mod.register_py_func(bwd),
                 "out_shapes": [[-1, 3], [-1]],
                 "out_dtypes": ["float32", "float64"]}
        f = _run(pkg, "py_func", {"X": [x, y]}, attrs, {})["Out"]
        gins = {"fwd_in::X": [x, y], "fwd_out::Out": f,
                "out_grad::Out": [np.ones((4, 3), "float32"),
                                  np.full((4,), 0.5)]}
        g = _run(pkg, "py_func_grad", gins, attrs,
                 {"in_grad::X": ["gx", "gy"]})["in_grad::X"]
        got[pkg] = f + g
    for a, b in zip(got["torch"], got["jax"]):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=1e-6)
    np.testing.assert_array_equal(got["torch"][3], np.zeros((4, 2)))


def test_coalesce_tensor_refuses_mixed_dtypes():
    ins = {"Input": [np.zeros((2,), "float32"), np.zeros((2,), "float64")]}
    for pkg in ("jax", "torch"):
        with pytest.raises(TypeError, match="mixed input dtypes"):
            _run(pkg, "coalesce_tensor", ins, {}, {})


def test_ref_by_trainer_id_refuses_an_id_out_of_range():
    ins = {"X": [np.zeros((2,), "float32")] * 3,
           "TrainerId": [np.array([3], "int64")]}
    for pkg in ("jax", "torch"):
        with pytest.raises(ValueError, match="out of range"):
            _run(pkg, "ref_by_trainer_id", ins, {}, {})


def test_edit_distance_anti_diagonals_match_a_levenshtein_table():
    """The port's anti-diagonal sweep against a plain Python DP on 40
    random pairs of lengths 0-12, and against the JAX op."""
    rng = np.random.RandomState(3)
    n, t1, t2 = 40, 12, 10
    h = rng.randint(0, 4, (n, t1)).astype("int64")
    r = rng.randint(0, 4, (n, t2)).astype("int64")
    hl = rng.randint(0, t1 + 1, n).astype("int64")
    rl = rng.randint(0, t2 + 1, n).astype("int64")
    ins = {"Hyps": [h], "Refs": [r], "HypsLength": [hl], "RefsLength": [rl]}
    attrs = {"normalized": False}
    got = _run("torch", "edit_distance", ins, attrs, {})["Out"][0][:, 0]
    want = _run("jax", "edit_distance", ins, attrs, {})["Out"][0][:, 0]
    for i in range(n):
        d = np.arange(rl[i] + 1, dtype=float)
        for a in range(1, hl[i] + 1):
            prev, d = d, np.zeros_like(d)
            d[0] = a
            for b in range(1, rl[i] + 1):
                d[b] = min(prev[b] + 1, d[b - 1] + 1,
                           prev[b - 1] + (h[i, a - 1] != r[i, b - 1]))
        assert got[i] == d[rl[i]] == want[i], i


def _ctc_programs(pkg, N, T, C, L, lr):
    with pkg.framework.unique_name.guard():
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            x = pkg.layers.data(name="x", shape=[T, C], dtype="float32")
            y = pkg.layers.data(name="y", shape=[L], dtype="int64")
            logits = pkg.layers.fc(x, size=C, num_flatten_dims=2)
            loss = pkg.layers.mean(pkg.layers.warpctc(logits, y, blank=0))
            pkg.optimizer.Adam(learning_rate=lr).minimize(loss)
    with pkg.framework.unique_name.guard():
        infer = pkg.Program()
        with pkg.program_guard(infer, pkg.Program()):
            x2 = pkg.layers.data(name="x", shape=[T, C], dtype="float32")
            y2 = pkg.layers.data(name="y", shape=[L], dtype="int64")
            logits2 = pkg.layers.fc(x2, size=C, num_flatten_dims=2)
            dec, dec_len = pkg.layers.ctc_greedy_decoder(
                pkg.layers.softmax(logits2), blank=0)
            dist, _ = pkg.layers.edit_distance(dec, y2, normalized=False,
                                               input_length=dec_len)
    return main, startup, infer, loss, dist


def ctc_ladder_data(N, T, C, L, seed=0):
    """tests/test_misc_ops.py's OCR-style ladder: frames one-hot on the
    label each stretches, plus noise."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(1, C, (N, L)).astype("int64")
    feats = np.zeros((N, T, C), "float32")
    for i in range(N):
        for t in range(T):
            feats[i, t, labels[i, min(t * L // T, L - 1)]] = 1.0
    feats += rng.randn(N, T, C).astype("float32") * 0.1
    return feats, labels


def test_ctc_ladder_trains_and_decodes_as_the_jax_package():
    """The ladder of tests/test_misc_ops.py (N 16, T 8, C 5, L 3; Adam
    0.05, 100 steps) through both packages from the JAX startup's
    weights: every step's loss within 1e-4 (relative) of the JAX one,
    the loss halved, and equal edit distances after training."""
    import paddle_tpu as jpt
    import paddle_tpu_torch as tpt
    from paddle_tpu_torch.convert import scope_from_numpy

    feats, labels = ctc_ladder_data(16, 8, 5, 3)
    feed = {"x": feats, "y": labels}
    progs = {p: _ctc_programs(p, 16, 8, 5, 3, 0.05) for p in (jpt, tpt)}
    jmain, jstart, jinfer, jloss, jdist = progs[jpt]
    tmain, tstart, tinfer, tloss, tdist = progs[tpt]
    jscope = jpt.Scope()
    jexe = jpt.Executor(jpt.CPUPlace())
    jexe.run(jstart, scope=jscope)
    init = {v.name: np.asarray(jscope.find_var(v.name))
            for v in jstart.list_vars() if v.persistable}
    tscope = scope_from_numpy(tpt.Scope(), init, tpt.CPUPlace())
    texe = tpt.Executor(tpt.CPUPlace())
    lj, lt = [], []
    for _ in range(100):
        lj.append(float(np.asarray(jexe.run(jmain, feed=feed,
                                            fetch_list=[jloss],
                                            scope=jscope)[0]).reshape(())))
        lt.append(float(np.asarray(texe.run(tmain, feed=feed,
                                            fetch_list=[tloss],
                                            scope=tscope)[0]).reshape(())))
    np.testing.assert_allclose(lt, lj, rtol=1e-4)
    assert lt[-1] < lt[0] * 0.5, (lt[0], lt[-1])
    dj = np.asarray(jexe.run(jinfer, feed=feed, fetch_list=[jdist],
                             scope=jscope)[0])
    dt = texe.run(tinfer, feed=feed, fetch_list=[tdist], scope=tscope)[0]
    np.testing.assert_array_equal(dt, dj)
    assert float(dt.mean()) < 1.0


def test_center_loss_centers_persist_across_steps():
    """CentersOut writes back into the centers parameter: with no
    optimizer the loss shrinks as the JAX package's does."""
    import paddle_tpu_torch as pt

    x_np = np.array([[2.0, 2.0]], "float32")
    y_np = np.array([[0]], "int64")
    main, startup = pt.Program(), pt.Program()
    with pt.framework.unique_name.guard(), pt.program_guard(main, startup):
        x = pt.layers.data(name="x", shape=[2], dtype="float32")
        y = pt.layers.data(name="y", shape=[1], dtype="int64")
        loss = pt.layers.mean(pt.layers.center_loss(
            x, y, num_classes=3, alpha=0.5, update_center=True))
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    exe.run(startup, scope=scope)
    ls = [float(exe.run(main, feed={"x": x_np, "y": y_np},
                        fetch_list=[loss], scope=scope)[0].reshape(()))
          for _ in range(21)]
    assert ls[-1] < ls[0] * 0.2, ls


def test_no_misc_op_leaves_the_device_it_was_given():
    """Every case's forward on meta inputs comes back on meta (meta
    stands in for the card: an op that made a tensor on another device
    than its inputs' would fail or come back there), but
    ref_by_trainer_id, which reads its id on the host by definition."""
    from test_torch_sequence_ops import cases_stay_on_meta

    cases_stay_on_meta([p for p in MISC_CASES
                        if p.values[0] != "ref_by_trainer_id"])


@pytest.mark.parametrize("op_type, spec, attrs", [
    ("edit_distance", {"Hyps": [HYPS], "Refs": [REFS]}, {}),
    ("warpctc", _CTC_INS, {"blank": 0}),
    ("ctc_align", {"Input": [_lit([[0, 1, 1, 0]], "int64")]}, {}),
    ("sampling_id", {"X": [_spec((4, 3), "prob")]}, {}),
])
def test_data_dependent_ops_infer_shapes_without_running(op_type, spec,
                                                         attrs):
    """Under shape inference (meta tensors, a -1 batch dim stood in by a
    sentinel) the ops whose work depends on their data give their
    outputs' shapes and dtypes as the JAX package's `eval_shape` does."""
    from paddle_tpu.core.ir import OpDesc as JOpDesc, VarDesc as JVarDesc
    from paddle_tpu_torch.core.ir import VarDesc as TVarDesc

    rng = np.random.RandomState(0)
    ins, descs = {}, {}
    for slot, specs in spec.items():
        ins[slot] = []
        for i, s in enumerate(specs):
            a = _make(rng, s)
            name = f"{slot}{i}"
            ins[slot].append(name)
            descs[name] = ((-1,) + a.shape[1:], str(a.dtype))
    outs = {"edit_distance": ["Out", "SequenceNum"],
            "warpctc": ["Loss", "WarpCTCGrad"],
            "ctc_align": ["Output", "OutputLength"],
            "sampling_id": ["Out"]}[op_type]
    outs = {o: [o.lower()] for o in outs}
    got = treg.infer_op_outputs(
        TOpDesc(type=op_type, inputs=ins, outputs=outs, attrs=attrs),
        {n: TVarDesc(n, shape=s, dtype=d) for n, (s, d) in descs.items()})
    want = jreg.infer_op_outputs(
        JOpDesc(type=op_type, inputs=ins, outputs=outs, attrs=attrs),
        {n: JVarDesc(n, shape=s, dtype=d) for n, (s, d) in descs.items()})
    want = {k: (tuple(v.shape), str(np.dtype(v.dtype)))
            for k, v in want.items()}
    if op_type == "warpctc":       # float64 under x64 (module docstring)
        want["loss"] = (want["loss"][0], "float32")
    assert {k: (tuple(v.shape), v.dtype) for k, v in got.items()} == want
