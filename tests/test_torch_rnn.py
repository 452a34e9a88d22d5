"""The LSTM and GRU ops of the fluid path (`paddle_tpu_torch/ops/rnn.py`,
the JAX package's `ops/rnn.py`, all eight) against the JAX kernels on
the same numpy inputs from a seed: forward, and the generic `<op>_grad`
for every weight and input (a random cotangent on every floating
output), at T <= 12 and widths <= 16.

`is_reverse` both ways and with and without H0 / C0; `lstmp_v2`'s H0
contract (the initial projection, [N, P]) and its refusal of peepholes;
`attention_lstm` with a length-0 row (it attends uniformly there).

Tolerance: the products' class, `TOL["mm"]` of test_torch_fluid_ops.py
(rtol 1e-4, atol 1e-4 of the reference's largest value), on float32:
XLA's dot and torch's matmul sum in other orders, and a recurrence
carries that difference through T steps.
"""

import numpy as np
import pytest

from test_torch_fluid_ops import _c, _lit, _run, _spec
from test_torch_sequence_ops import cases_stay_on_meta, check_op

N, T, D, H = 3, 7, 5, 4


def _lstm_ins(h0=False, c0=False, pre=False):
    ins = {"Input": [_spec((N, T, 4 * H) if pre else (N, T, D))],
           "Weight": [_spec((H, 4 * H) if pre else (D + H, 4 * H),
                            "unit")],
           "Bias": [_spec((4 * H,))]}
    if h0:
        ins["H0"] = [_spec((N, H))]
    if c0:
        ins["C0"] = [_spec((N, H))]
    return ins


def _gru_ins(h0=False, pre=False):
    ins = {"Input": [_spec((N, T, 3 * H) if pre else (N, T, D))],
           "Weight": [_spec((H, 3 * H) if pre else (D + H, 3 * H), "unit")],
           "Bias": [_spec((3 * H,))]}
    if h0:
        ins["H0"] = [_spec((N, H))]
    return ins


def _variants(op, build, states):
    out = []
    for rev in (False, True):
        for st in states:
            name = f"{op}_{'rev' if rev else 'fwd'}" + \
                "".join(f"_{k}" for k, v in st.items() if v)
            out.append(_c(op, build(**st), {"hidden_size": H,
                                            "is_reverse": rev}, "mm",
                          name=name))
    return out


P, DP = 3, 4        # lstmp's projection and cell widths

RNN_CASES = (
    _variants("lstm_v2", _lstm_ins, [{}, {"h0": True, "c0": True}])
    + _variants("dynamic_lstm_v2", lambda **k: _lstm_ins(pre=True, **k),
                [{}, {"h0": True, "c0": True}])
    + _variants("gru_v2", _gru_ins, [{}, {"h0": True}])
    + _variants("dynamic_gru_v2", lambda **k: _gru_ins(pre=True, **k),
                [{}, {"h0": True}])
    + [_c("lstm_v2", {"Input": [_spec((N, T, D))],
                      "Weight": [_spec((D + H, 4 * H), "unit")]},
          {"hidden_size": H}, "mm", name="lstm_v2_no_bias"),
       _c("lstm_unit", {"X": [_spec((N, 4 * H))], "C_prev": [_spec((N, H))]},
          {"forget_bias": 0.5}, "mm"),
       _c("gru_unit", {"Input": [_spec((N, 3 * H))],
                       "HiddenPrev": [_spec((N, H))],
                       "Weight": [_spec((H, 3 * H), "unit")],
                       "Bias": [_spec((1, 3 * H))]}, {}, "mm"),
       _c("gru_unit", {"Input": [_spec((N, 3 * H))],
                       "HiddenPrev": [_spec((N, H))],
                       "Weight": [_spec((H, 3 * H), "unit")]},
          {"origin_mode": True, "activation": 3, "gate_activation": 1},
          "mm", name="gru_unit_origin_mode_relu"),
       _c("gru_unit", {"Input": [_spec((N, 3 * H))],
                       "HiddenPrev": [_spec((N, H))],
                       "Weight": [_spec((H, 3 * H), "unit")]},
          {"activation": 0, "gate_activation": 2}, "mm",
          name="gru_unit_identity_tanh_codes"),
       _c("lstmp_v2", {"Input": [_spec((N, T, 4 * DP))],
                       "Weight": [_spec((P, 4 * DP), "unit")],
                       "ProjWeight": [_spec((DP, P), "unit")],
                       "Bias": [_spec((4 * DP,))]}, {}, "mm"),
       # H0 is the initial projection [N, P]; clips and a reverse pass
       _c("lstmp_v2", {"Input": [_spec((N, T, 4 * DP))],
                       "Weight": [_spec((P, 4 * DP), "unit")],
                       "ProjWeight": [_spec((DP, P), "unit")],
                       "H0": [_spec((N, P))], "C0": [_spec((N, DP))]},
          {"is_reverse": True, "cell_clip": 0.8, "proj_clip": 0.5,
           "proj_activation": "identity"}, "mm",
          name="lstmp_v2_rev_h0_c0_clipped"),
       ])

M, DA, TA = 4, 3, 6   # attention_lstm: x width, cell width, T


def _attention_ins(seq_len=True, h0=True, scalar=True):
    ins = {"X": [_spec((N, TA, M))], "C0": [_spec((N, DA))],
           "AttentionWeight": [_spec((M + DA, 1), "unit")],
           "AttentionBias": [_spec((1, 1))],
           "LSTMWeight": [_spec((DA + M, 4 * DA), "unit")],
           "LSTMBias": [_spec((1, 4 * DA))]}
    if h0:
        ins["H0"] = [_spec((N, DA))]
    if scalar:
        ins["AttentionScalar"] = [_lit([[0.7]], "float32")]
        ins["AttentionScalarBias"] = [_lit([[0.1]], "float32")]
    if seq_len:
        ins["SeqLen"] = [_lit([6, 0, 2], "int64")]   # a length-0 row
    return ins


ATTENTION_CASES = [
    _c("attention_lstm", _attention_ins(), {}, "mm"),
    _c("attention_lstm", _attention_ins(seq_len=False, h0=False,
                                        scalar=False),
       {"gate_activation": "sigmoid", "cell_activation": "relu",
        "candidate_activation": "tanh"}, "mm", name="attention_lstm_plain"),
]


@pytest.mark.parametrize("op_type, spec, attrs, cls",
                         RNN_CASES + ATTENTION_CASES)
def test_rnn_op_matches_jax(op_type, spec, attrs, cls):
    check_op(op_type, spec, attrs, cls)


def test_no_rnn_op_leaves_the_device_it_was_given():
    """Every case's forward on meta inputs comes back on meta
    (`cases_stay_on_meta`)."""
    cases_stay_on_meta(RNN_CASES + ATTENTION_CASES)


def test_every_rnn_op_has_a_case():
    import inspect

    from paddle_tpu.core import registry as jreg

    jax_ops = {t for t, d in jreg._REGISTRY.items()
               if not t.endswith("_grad") and
               inspect.getmodule(d.kernel).__name__ == "paddle_tpu.ops.rnn"}
    covered = {p.values[0] for p in RNN_CASES + ATTENTION_CASES}
    assert len(jax_ops) == 8 and covered == jax_ops, jax_ops ^ covered


def test_attention_lstm_length_zero_row_attends_uniformly():
    """The -1e30 mask keeps a SeqLen-0 row finite: its attention is
    uniform over T in both packages."""
    rng = np.random.RandomState(3)
    from test_torch_fluid_ops import _make

    ins = {k: [_make(rng, s) for s in v] for k, v in _attention_ins().items()}
    t = _run("torch", "attention_lstm", ins, {}, {})
    j = _run("jax", "attention_lstm", ins, {}, {})
    att = t["AttentionFCOut"][0][1, :, :, 0]             # row 1: SeqLen 0
    np.testing.assert_allclose(att, np.full((TA, TA), 1.0 / TA), rtol=1e-6)
    assert np.isfinite(t["Hidden"][0]).all()
    np.testing.assert_allclose(t["Hidden"][0], j["Hidden"][0], rtol=1e-4,
                               atol=1e-5)


def _lstmp(pkg, h0_width=None, peepholes=False):
    rng = np.random.RandomState(0)
    ins = {"Input": [rng.standard_normal((N, T, 4 * DP)).astype("float32")],
           "Weight": [rng.uniform(-.9, .9, (P, 4 * DP)).astype("float32")],
           "ProjWeight": [rng.uniform(-.9, .9, (DP, P)).astype("float32")]}
    if h0_width is not None:
        ins["H0"] = [rng.standard_normal((N, h0_width)).astype("float32")]
    return _run(pkg, "lstmp_v2", ins, {"use_peepholes": peepholes}, {})


def test_lstmp_h0_is_the_initial_projection_in_both_packages():
    """H0 of width P runs; H0 of the cell's width D (the op doc's shape)
    is refused by both, naming the projection contract."""
    for pkg in ("jax", "torch"):
        assert _lstmp(pkg, h0_width=P)["Projection"][0].shape == (N, T, P)
    with pytest.raises(AssertionError, match="initial projection"):
        _lstmp("jax", h0_width=DP)
    with pytest.raises(ValueError, match="initial projection"):
        _lstmp("torch", h0_width=DP)


def test_lstmp_refuses_peepholes_in_both_packages():
    with pytest.raises(AssertionError, match="use_peepholes"):
        _lstmp("jax", peepholes=True)
    with pytest.raises(ValueError, match="use_peepholes"):
        _lstmp("torch", peepholes=True)


# -- faults copied from the JAX package (ROADMAP F20, F21): each shown
# in both packages, which agree


def _reverse_lstm(pkg, x, lengths_pad):
    """dynamic_lstm_v2 reversed on x [2, 6, 4H] whose row 1 is 3 long,
    its padding filled with `lengths_pad`."""
    x = x.copy()
    x[1, 3:] = lengths_pad
    rng = np.random.RandomState(4)
    ins = {"Input": [x],
           "Weight": [rng.uniform(-.9, .9, (H, 4 * H)).astype("float32")]}
    return _run(pkg, "dynamic_lstm_v2", ins,
                {"hidden_size": H, "is_reverse": True}, {})["Hidden"][0]


def test_f20_reversed_lstm_reads_a_short_rows_padding_first():
    """The LSTM ops take no lengths and is_reverse flips the whole
    padded T: a 3-long row's reversed outputs at its valid positions
    change with what its padding holds, in both packages (Paddle
    reverses each sequence within its length, so they would not)."""
    x = np.random.RandomState(0).standard_normal((2, 6, 4 * H)).astype(
        "float32")
    outs = {}
    for pkg in ("jax", "torch"):
        zero, ones = _reverse_lstm(pkg, x, 0.0), _reverse_lstm(pkg, x, 1.0)
        assert np.abs(zero[1, :3] - ones[1, :3]).max() > 1e-3, pkg
        np.testing.assert_array_equal(zero[0], ones[0])
        outs[pkg] = ones
    np.testing.assert_allclose(outs["torch"], outs["jax"], rtol=1e-4,
                               atol=1e-5)


def _book_lstm_program(pkg, **acts):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.framework.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data(name="x", shape=[5, 4 * H], dtype="float32")
        hidden, _ = pkg.layers.dynamic_lstm(x, size=4 * H, **acts)
    return main, startup, hidden


def test_f21_dynamic_lstm_drops_its_activations_and_peepholes():
    """`layers.dynamic_lstm` passes only hidden_size and is_reverse to
    the op: db_lstm's relu candidate and sigmoid gate and cell, and
    use_peepholes, leave the program and its output as the defaults'
    (tanh, tanh, no peepholes), in both packages."""
    import paddle_tpu as pt

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.convert import scope_from_numpy

    book = dict(candidate_activation="relu", gate_activation="sigmoid",
                cell_activation="sigmoid", use_peepholes=True)
    x = np.random.RandomState(1).standard_normal((3, 5, 4 * H)).astype(
        "float32")
    for pkg in (pt, ptt):
        asked = _book_lstm_program(pkg, **book)
        plain = _book_lstm_program(pkg)
        assert asked[0].desc.to_dict() == plain[0].desc.to_dict()
        op = next(o for o in asked[0].desc.block(0).ops
                  if o.type == "dynamic_lstm_v2")
        assert not {"candidate_activation", "gate_activation",
                    "cell_activation", "use_peepholes"} & set(op.attrs)
    main_j, start_j, out_j = _book_lstm_program(pt, **book)
    main_t, _, out_t = _book_lstm_program(ptt, **book)
    scj = pt.Scope()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(start_j, scope=scj)
    want = np.asarray(exe.run(main_j, feed={"x": x}, fetch_list=[out_j],
                              scope=scj)[0])
    pers = [v.name for v in start_j.list_vars() if v.persistable]
    sct = scope_from_numpy(ptt.Scope(), {n: scj.get(n) for n in pers},
                           ptt.CPUPlace())
    got = ptt.Executor(ptt.CPUPlace()).run(main_t, feed={"x": x},
                                           fetch_list=[out_t], scope=sct)[0]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    # what tanh and tanh give: the op at its only activations
    state = {tuple(scj.get(n).shape): scj.get(n) for n in pers}
    w, b = state[(H, 4 * H)], state[(4 * H,)]
    ref = _run("torch", "dynamic_lstm_v2",
               {"Input": [x], "Weight": [w], "Bias": [b.reshape(-1)]},
               {"hidden_size": H}, {})["Hidden"][0]
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
