"""Quantization-aware training in the port against the JAX package: the
ten fake-quant op types (`paddle_tpu_torch/ops/quant.py`) and
`slim/qat.py`'s transform and freeze passes, on the same numpy inputs
from a seed.

- Each op, forward and (for the quantize-dequantize ones) the generic
  gradient through the straight-through estimator: bit for bit. The
  arithmetic is the JAX op's term for term in f32 (the grid bound and
  the scale floor are f32 tensors, so every division is a true f32
  division; the STE is `x + (q - x).detach()`), and XLA's f32 rounding
  on the CPU is torch's.
- The moving-average state advances exactly once a step, although the
  generic gradient replays the forward: after n steps the state is
  sum(rate**k, k < n) + rate**n (from 1), in both packages.
- The windowed range scale shrinks once the old maximum slides out
  (after tests/test_round2b_ops.py:62).
- The transform gives the JAX pass's ProgramDesc (`to_dict()` equal,
  main and startup).
- A 10-step QAT MLP trajectory from the JAX startup's weights: every
  loss within 1e-5 (relative) of the JAX one, and every state var.
- The freeze pass from one trained scope: equal frozen weights (bit for
  bit), every frozen weight on its channel's int8 grid, no fake op left,
  and equal frozen logits (1e-5 relative); the frozen logits within
  the JAX test's rtol = atol = 0.1 of the QAT test program's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu_torch.convert import scope_from_numpy
from test_torch_fluid_ops import _lit, _make, _run, _spec

RATE = 0.9


def _exact(got, want, what):
    assert got.shape == want.shape and got.dtype == want.dtype, \
        (what, got.shape, want.shape, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=what)


def _both(op_type, ins, attrs, outs=None):
    outs = outs or {}
    fj = _run("jax", op_type, ins, attrs, outs)
    ft = _run("torch", op_type, ins, attrs, outs)
    assert sorted(fj) == sorted(ft)
    for slot in fj:
        for i, v in enumerate(fj[slot]):
            _exact(ft[slot][i], v, f"{op_type} {slot}[{i}]")
    return ft


W = _spec((4, 3, 2, 2), "wide")
STATE = {"InScale": [_lit([0.7], "float32")],
         "InState": [_lit([1.3], "float32")],
         "InAccum": [_lit([0.9], "float32")]}

QUANT_CASES = [
    ("fake_quantize_dequantize_abs_max", {"X": [W]}, {"bit_length": 8}),
    ("fake_quantize_dequantize_abs_max", {"X": [W]}, {"bit_length": 4}),
    ("fake_channel_wise_quantize_dequantize_abs_max", {"X": [W]},
     {"bit_length": 8, "quant_axis": 0}),
    ("fake_channel_wise_quantize_dequantize_abs_max",
     {"X": [_spec((6, 5), "wide")]}, {"bit_length": 8, "quant_axis": 1}),
    ("fake_quantize_dequantize_moving_average_abs_max",
     dict(STATE, X=[W]), {"bit_length": 8, "moving_rate": RATE}),
    ("fake_quantize_dequantize_moving_average_abs_max",
     dict(STATE, X=[W]), {"bit_length": 8, "is_test": True}),
    ("fake_quantize_dequantize_moving_average_abs_max",
     {"X": [W], "InScale": STATE["InScale"]}, {"bit_length": 8}),
    ("fake_quantize_abs_max", {"X": [W]}, {"bit_length": 8}),
    ("fake_channel_wise_quantize_abs_max", {"X": [W]},
     {"bit_length": 8, "quant_axis": 0}),
    ("fake_quantize_range_abs_max",
     {"X": [W], "InScale": [_lit([30.0], "float32")],
      "Iter": [_lit([1], "int64")]}, {"bit_length": 8}),
    ("fake_quantize_range_abs_max",
     {"X": [W], "InScale": [_lit([3.0], "float32")],
      "Iter": [_lit([5], "int64")],
      "InScales": [_lit([9.0, 1.0, 2.0], "float32")]},
     {"bit_length": 8, "window_size": 3}),
    ("fake_quantize_range_abs_max",
     {"X": [W], "InScale": [_lit([3.0], "float32")],
      "Iter": [_lit([5], "int64")]}, {"bit_length": 8, "is_test": True}),
    ("fake_quantize_moving_average_abs_max", dict(STATE, X=[W]),
     {"bit_length": 8, "moving_rate": 0.8}),
    ("fake_dequantize_max_abs", {"X": [_spec((3, 4), "int9", "float32")],
                                 "Scale": [_lit([2.5], "float32")]},
     {"max_range": 127.0}),
    ("fake_channel_wise_dequantize_max_abs",
     {"X": [_spec((4, 3, 2, 2), "int9", "float32")],
      "Scales": [_lit([1.5, 0.5, 2.0, 3.0], "float32")]},
     {"quant_bits": [8], "quant_axis": 0}),
    ("fake_channel_wise_dequantize_max_abs",
     {"X": [_spec((3, 4), "int9", "float32")],
      "Scales": [_lit([1.5, 0.5, 2.0, 3.0], "float32"),
                 _lit([0.25], "float32")]},
     {"quant_bits": [8, 8], "quant_axis": 1}),
    ("moving_average_abs_max_scale",
     {"X": [W], "InState": STATE["InState"], "InAccum": STATE["InAccum"]},
     {"moving_rate": RATE}),
    ("moving_average_abs_max_scale",
     {"X": [W], "InState": STATE["InState"], "InAccum": STATE["InAccum"]},
     {"is_test": True}),
]


@pytest.mark.parametrize("op_type, spec, attrs", QUANT_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in
                              enumerate(QUANT_CASES)])
def test_fake_quant_op_bit_for_bit(op_type, spec, attrs):
    rng = np.random.RandomState(sum(map(ord, op_type)))
    ins = {k: [_make(rng, s) for s in v] for k, v in spec.items()}
    fwd = _both(op_type, ins, attrs)
    from paddle_tpu.core import registry as jreg
    from paddle_tpu_torch.core import registry as treg

    jdef, tdef = jreg.get_op_def(op_type), treg.get_op_def(op_type)
    assert jdef.has_grad() == tdef.has_grad()
    assert jdef.intermediate_outputs == tdef.intermediate_outputs
    assert jdef.nondiff_inputs == tdef.nondiff_inputs
    if not jdef.has_grad():
        return
    # the STE gradient: the cotangent of Out, through unchanged
    cot = rng.standard_normal(ins["X"][0].shape).astype("float32")
    gins = {"fwd_in::" + k: v for k, v in ins.items()}
    gins.update({"fwd_out::" + k: v for k, v in fwd.items()})
    gins["out_grad::Out"] = [cot]
    g = _both(op_type + "_grad", gins, attrs, {"in_grad::X": ["gx"]})
    np.testing.assert_array_equal(g["in_grad::X"][0], cot)


def test_round_half_to_even_on_the_grid():
    """Activations exactly on a half step round to even, as jnp.round
    does: 0.5, 1.5, 2.5 quanta give 0, 2, 2."""
    x = np.array([[0.5, 1.5, 2.5, -0.5, -2.5, 127.0]], "float32")
    out = _both("fake_quantize_abs_max", {"X": [x]}, {"bit_length": 8})
    np.testing.assert_array_equal(out["Out"][0], [[0, 2, 2, 0, -2, 127]])


def test_range_window_scale_shrinks():
    """With the InScales window threaded through, the scale drops once
    the old maximum slides out, in both packages."""
    wsize = 3
    state = {"jax": (np.zeros(1, "float32"), np.zeros(wsize, "float32")),
             "torch": (np.zeros(1, "float32"), np.zeros(wsize, "float32"))}
    scales = {"jax": [], "torch": []}
    for it, m in enumerate([5.0, 1.0, 1.0, 1.0]):
        x = np.array([[m, -m / 2]], "float32")
        for pkg in ("jax", "torch"):
            in_scale, window = state[pkg]
            out = _run(pkg, "fake_quantize_range_abs_max",
                       {"X": [x], "InScale": [in_scale],
                        "Iter": [np.array([it], "int64")],
                        "InScales": [window]},
                       {"bit_length": 8, "window_size": wsize}, {})
            state[pkg] = (out["OutScale"][0], out["OutScales"][0])
            scales[pkg].append(float(out["OutScale"][0][0]))
    assert scales["torch"] == scales["jax"] == [5.0, 5.0, 5.0, 1.0]


def _build_mlp(pkg, seed=3):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    with pkg.framework.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data(name="x", shape=[8], dtype="float32")
        y = pkg.layers.data(name="y", shape=[1], dtype="int64")
        h = pkg.layers.fc(x, size=16, act="relu")
        logits = pkg.layers.fc(h, size=4)
        loss = pkg.layers.mean(
            pkg.layers.softmax_with_cross_entropy(logits, y))
        pkg.optimizer.Adam(learning_rate=0.02).minimize(loss)
    return main, startup, loss, logits


def _infer_mlp(pkg):
    infer = pkg.Program()
    with pkg.framework.unique_name.guard(), \
            pkg.program_guard(infer, pkg.Program()):
        xv = pkg.layers.data(name="x", shape=[8], dtype="float32")
        hv = pkg.layers.fc(xv, size=16, act="relu")
        logits = pkg.layers.fc(hv, size=4)
    return infer, logits


def _mlp_data():
    rng = np.random.RandomState(0)
    X = rng.randn(64, 8).astype("float32")
    Y = (np.abs(X[:, :4]).argmax(1) % 4).astype("int64")[:, None]
    return X, Y


def _qat(pkg):
    from importlib import import_module

    slim = import_module(pkg.__name__ + ".slim")
    main, startup, loss, logits = _build_mlp(pkg)
    slim.QuantizationTransformPass().apply(main, startup)
    return main, startup, loss, logits


def test_transform_gives_the_jax_pass_program():
    mj, sj, _, _ = _qat(pt)
    mt, st, _, _ = _qat(ptt)
    assert mt.desc.to_dict() == mj.desc.to_dict()
    assert st.desc.to_dict() == sj.desc.to_dict()
    types = [op.type for op in mt.global_block().ops]
    assert types.count("fake_channel_wise_quantize_dequantize_abs_max") == 2
    assert types.count(
        "fake_quantize_dequantize_moving_average_abs_max") == 2
    ij, _ = _infer_mlp(pt)
    it, _ = _infer_mlp(ptt)
    assert ptt.slim.QuantizationTransformPass(
        weight_quantize_type="abs_max",
        activation_quantize_type="abs_max").apply(it).desc.to_dict() == \
        pt.slim.QuantizationTransformPass(
            weight_quantize_type="abs_max",
            activation_quantize_type="abs_max").apply(ij).desc.to_dict()


def _state_vars(main):
    return sorted(n for n in main.global_block().desc.vars
                  if n.endswith((".quant_in_scale", ".quant_state",
                                 ".quant_accum")))


def test_qat_trajectory_and_state_advance_once_a_step():
    """10 Adam steps of the QAT MLP in both packages from the JAX
    startup's state: losses within 1e-5, every quant state var within
    1e-6 (relative) of the JAX one, and each quant_state at
    sum(rate**k, k < n) + rate**n after n steps."""
    mj, sj, lj, _ = _qat(pt)
    mt, _, lt, _ = _qat(ptt)
    X, Y = _mlp_data()
    feed = {"x": X, "y": Y}
    scj = pt.Scope()
    exej, exet = pt.Executor(pt.CPUPlace()), ptt.Executor(ptt.CPUPlace())
    exej.run(sj, scope=scj)
    pers = [v.name for v in sj.list_vars() if v.persistable]
    sct = scope_from_numpy(ptt.Scope(), {n: scj.get(n) for n in pers},
                           ptt.CPUPlace())
    states = _state_vars(mt)
    assert len(states) == 6
    for n in range(1, 11):
        a = float(np.asarray(exej.run(mj, feed=feed, fetch_list=[lj],
                                      scope=scj)[0]).reshape(()))
        b = float(exet.run(mt, feed=feed, fetch_list=[lt],
                           scope=sct)[0].reshape(()))
        assert abs(b - a) <= 1e-5 * abs(a), (n, a, b)
        for s in states:
            np.testing.assert_allclose(sct.get(s), scj.get(s), rtol=1e-6,
                                       err_msg=f"{s} after step {n}")
            if s.endswith(".quant_state"):
                want = sum(RATE ** k for k in range(n)) + RATE ** n
                np.testing.assert_allclose(sct.get(s), [want], rtol=1e-6)


def test_freeze_from_one_trained_scope():
    """The JAX package trains the QAT MLP 40 steps (tests/test_slim.py's
    freeze test); both packages freeze the QAT inference program from
    copies of that scope."""
    mj, sj, lj, _ = _qat(pt)
    X, Y = _mlp_data()
    scj = pt.Scope()
    exej = pt.Executor(pt.CPUPlace())
    exej.run(sj, scope=scj)
    for _ in range(40):
        exej.run(mj, feed={"x": X, "y": Y}, fetch_list=[lj], scope=scj)
    names = [v.name for v in mj.list_vars() if v.persistable]
    trained = {n: scj.get(n) for n in names}
    frozen, outs = {}, {}
    for pkg in (pt, ptt):
        infer, logits = _infer_mlp(pkg)
        qat_infer = pkg.slim.QuantizationTransformPass().apply(infer)
        scope = pkg.Scope()
        if pkg is pt:
            for n, v in trained.items():
                scope.set_var(n, jnp.asarray(v))
        else:
            scope_from_numpy(scope, trained, ptt.CPUPlace())
        exe = pkg.Executor(pkg.CPUPlace())
        qat_out = np.asarray(exe.run(qat_infer.clone(for_test=True),
                                     feed={"x": X}, fetch_list=[logits.name],
                                     scope=scope)[0])
        prog = pkg.slim.QuantizationFreezePass().apply(qat_infer, scope)
        assert not any(op.type.startswith("fake_")
                       for op in prog.global_block().ops)
        out = np.asarray(exe.run(prog, feed={"x": X},
                                 fetch_list=[logits.name], scope=scope)[0])
        np.testing.assert_allclose(out, qat_out, rtol=0.1, atol=0.1)
        params = [p.name for p in prog.all_parameters()
                  if p.name.endswith(".w_0")]
        frozen[pkg.__name__] = {p: np.asarray(scope.get(p) if pkg is ptt
                                              else scope.find_var(p))
                                for p in params}
        outs[pkg.__name__] = out
    for p, w in frozen["paddle_tpu_torch"].items():
        _exact(w, frozen["paddle_tpu"][p], p)
        # fc weights [In, Out]: one scale per output column
        q = w * 127.0 / np.abs(trained[p]).max(axis=0, keepdims=True)
        np.testing.assert_allclose(q, np.round(q), rtol=0, atol=1e-4)
    np.testing.assert_allclose(outs["paddle_tpu_torch"], outs["paddle_tpu"],
                               rtol=1e-5, atol=1e-6)


def test_freeze_writes_back_on_the_var_device_as_a_tensor():
    """A frozen weight stays a tensor on its device (here the CPU): the
    freeze pass reads it to the host and writes the grid values back
    where it was."""
    infer, _ = _infer_mlp(ptt)
    qat = ptt.slim.QuantizationTransformPass().apply(infer)
    scope = ptt.Scope()
    ptt.Executor(ptt.CPUPlace()).run(
        _infer_startup(), scope=scope)
    before = {n: scope.find_var(n) for n in scope.local_var_names()
              if isinstance(scope.find_var(n), torch.Tensor)}
    assert len(before) == 4
    ptt.slim.QuantizationFreezePass().apply(qat, scope)
    for n, v in before.items():
        got = scope.find_var(n)
        assert isinstance(got, torch.Tensor) and got.device == v.device
        assert got.dtype == v.dtype and got.shape == v.shape


def _infer_startup():
    startup = ptt.Program()
    with ptt.framework.unique_name.guard(), \
            ptt.program_guard(ptt.Program(), startup):
        xv = ptt.layers.data(name="x", shape=[8], dtype="float32")
        hv = ptt.layers.fc(xv, size=16, act="relu")
        ptt.layers.fc(hv, size=4)
    return startup


def test_no_fake_quant_op_leaves_the_device_it_was_given():
    """Every case's forward on meta inputs comes back on meta (the grid
    constants are made on the activation's device)."""
    from test_torch_sequence_ops import outputs_stay_on_meta

    rng = np.random.RandomState(0)
    for op_type, spec, attrs in QUANT_CASES:
        outputs_stay_on_meta(op_type, {k: [_make(rng, s) for s in v]
                                       for k, v in spec.items()}, attrs)


@pytest.mark.parametrize("pkg", [pt, ptt], ids=["jax", "torch"])
def test_f24_freeze_rounds_a_boundary_weight_off_the_fake_ops_grid(pkg):
    """ROADMAP F24 (the JAX package's behaviour, copied): the fake-quant
    op rounds w / amax * 127, the freeze pass (the PTQ quantizer) rounds
    w / (amax / 127); for w = 0.0433070846 in a column of abs-max 1 the
    first gives 5 quanta and the second 6, in both packages."""
    main = pkg.Program()
    with pkg.framework.unique_name.guard(), \
            pkg.program_guard(main, pkg.Program()):
        x = pkg.layers.data(name="x", shape=[2], dtype="float32")
        pkg.layers.fc(x, size=1, bias_attr=False)
    qat = pkg.slim.QuantizationTransformPass().apply(main)
    w = np.array([[1.0], [0.04330708459019661]], "float32")
    scope = pkg.Scope()
    scope.set_var("fc_0.w_0", w if pkg is pt else torch.from_numpy(w))
    for n, v in (("x.quant_in_scale", 1.0), ("x.quant_state", 1.0),
                 ("x.quant_accum", 1.0)):
        scope.set_var(n, np.full((1,), v, "float32"))
    fake = np.asarray(pkg.Executor(pkg.CPUPlace()).run(
        qat.clone(for_test=True), feed={"x": np.ones((1, 2), "float32")},
        fetch_list=["fc_0.w_0.quantized"], scope=scope)[0])
    pkg.slim.QuantizationFreezePass().apply(qat, scope)
    frozen = np.asarray(scope.get("fc_0.w_0"))
    np.testing.assert_array_equal(np.rint(fake * 127), [[127], [5]])
    np.testing.assert_array_equal(np.rint(frozen * 127), [[127], [6]])
