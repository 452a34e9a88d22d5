"""The fluid path's optimizers on the port against the JAX package's, on
the CPU (`tests/test_optimizers.py` and `test_optimizer_extras.py`
mirrored, but for the two tests that need `io_native` and `dataset/`,
ROADMAP item 21).

- Each of the 17 optimizer op types (`ops/optimizer_ops.py`), dense and
  with a SelectedRows gradient (repeated ids), against the JAX op on the
  same float32 inputs from a seed: rtol 1e-5, atol 1e-6 (sqrt, pow and
  division round alike in both; the reductions of `lars_momentum`,
  `lamb` and `dpsgd` sum in another order). `average_accumulates`'
  int32 counters exactly. `dpsgd` at sigma 0 exactly, and its noise by
  its mean and standard deviation.
- Each of the JAX package's optimizer names (the 26 this slice adds and
  the 7 before it) builds the same main and startup ProgramDesc in both
  packages, and 3 steps of a small MLP under it, each step from the JAX
  scope (resynced), leave every persistable within 1e-5 of the JAX
  package's, relative to the tensor's largest value (the gradients
  agree to f32 noise; adaptive steps divide by it).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as pt
from paddle_tpu.core import registry as jreg
from paddle_tpu.core.ir import OpDesc as JOpDesc
from paddle_tpu.core.selected_rows import SelectedRows as JSR

import paddle_tpu_torch as ptt
from paddle_tpu_torch.convert import scope_from_numpy
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core.ir import OpDesc as TOpDesc
from paddle_tpu_torch.core.selected_rows import SelectedRows as TSR

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6


# -- op level ---------------------------------------------------------------


def _pos(rng, shape):
    return rng.uniform(0.1, 1.0, shape).astype("float32")


def _nrm(rng, shape):
    return rng.standard_normal(shape).astype("float32")


def _lr(v=0.1):
    return np.array([v], "float32")


V, D = 7, 3


def _op_inputs(op, rng):
    """(inputs, attrs, output slots) of one call of `op`."""
    p, g = _nrm(rng, (V, D)), _nrm(rng, (V, D))
    base = {"Param": p, "Grad": g, "LearningRate": _lr()}
    if op == "sgd":
        return base, {}, ["ParamOut"]
    if op in ("momentum", "lars_momentum"):
        attrs = {"mu": 0.9}
        if op == "lars_momentum":
            attrs.update(lars_coeff=0.01, lars_weight_decay=0.0005)
        return ({**base, "Velocity": _nrm(rng, (V, D))}, attrs,
                ["ParamOut", "VelocityOut"])
    if op in ("adam", "adamw", "lamb"):
        ins = {**base, "Moment1": _nrm(rng, (V, D)) * 0.1,
               "Moment2": _pos(rng, (V, D)) * 0.1,
               "Beta1Pow": np.array([0.81], "float32"),
               "Beta2Pow": np.array([0.998], "float32")}
        attrs = {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}
        if op == "adamw":
            attrs["coeff"] = 0.01
        if op == "lamb":
            attrs.update(epsilon=1e-6, weight_decay=0.01)
        return ins, attrs, ["ParamOut", "Moment1Out", "Moment2Out",
                            "Beta1PowOut", "Beta2PowOut"]
    if op == "adamax":
        return ({**base, "Moment": _nrm(rng, (V, D)) * 0.1,
                 "InfNorm": _pos(rng, (V, D)),
                 "Beta1Pow": np.array([0.81], "float32")},
                {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8},
                ["ParamOut", "MomentOut", "InfNormOut"])
    if op in ("adagrad", "decayed_adagrad"):
        attrs = {"epsilon": 1e-6}
        if op == "decayed_adagrad":
            attrs["decay"] = 0.95
        return ({**base, "Moment": _pos(rng, (V, D))}, attrs,
                ["ParamOut", "MomentOut"])
    if op == "adadelta":
        return ({"Param": p, "Grad": g,
                 "AvgSquaredGrad": _pos(rng, (V, D)),
                 "AvgSquaredUpdate": _pos(rng, (V, D))},
                {"rho": 0.95, "epsilon": 1e-6},
                ["ParamOut", "AvgSquaredGradOut", "AvgSquaredUpdateOut"])
    if op in ("rmsprop", "rmsprop_centered"):
        ins = {**base, "MeanSquare": _pos(rng, (V, D)) + 1.0,
               "Moment": _nrm(rng, (V, D)) * 0.1}
        outs = ["ParamOut", "MeanSquareOut", "MomentOut"]
        attrs = {"decay": 0.9, "epsilon": 1e-6, "momentum": 0.5}
        if op == "rmsprop_centered":
            ins["MeanGrad"] = _nrm(rng, (V, D)) * 0.1
            outs.append("MeanGradOut")
            attrs["centered"] = True
        return ins, attrs, outs
    if op == "ftrl":
        return ({**base, "SquaredAccumulator": _pos(rng, (V, D)),
                 "LinearAccumulator": _nrm(rng, (V, D))},
                {"l1": 0.01, "l2": 0.02, "lr_power": -0.5},
                ["ParamOut", "SquaredAccumOut", "LinearAccumOut"])
    if op == "dpsgd":
        return base, {"clip": 1.0, "batch_size": 4.0, "sigma": 0.0}, \
            ["ParamOut"]
    if op == "dgc_momentum":
        return ({**base, "U": _nrm(rng, (V, D)), "V": _nrm(rng, (V, D))},
                {"mu": 0.9, "sparsity_ratio": 0.25},
                ["ParamOut", "UOut", "VOut", "GradOut"])
    if op in ("proximal_gd", "proximal_gd_l1"):
        return base, {"l1": 0.05 if op.endswith("l1") else 0.0, "l2": 0.1}, \
            ["ParamOut"]
    if op in ("proximal_adagrad", "proximal_adagrad_l1"):
        return ({**base, "Moment": _pos(rng, (V, D))},
                {"l1": 0.05 if op.endswith("l1") else 0.0, "l2": 0.1},
                ["ParamOut", "MomentOut"])
    raise KeyError(op)


OP_CASES = ["sgd", "momentum", "lars_momentum", "adam", "adamw", "adamax",
            "adagrad", "decayed_adagrad", "adadelta", "rmsprop",
            "rmsprop_centered", "ftrl", "lamb", "dpsgd", "dgc_momentum",
            "proximal_gd", "proximal_gd_l1", "proximal_adagrad",
            "proximal_adagrad_l1"]
SPARSE_IDS = np.array([1, 4, 1, 6], "int64")   # id 1 repeated


def _op_type(case):
    return {"rmsprop_centered": "rmsprop", "proximal_gd_l1": "proximal_gd",
            "proximal_adagrad_l1": "proximal_adagrad"}.get(case, case)


def call_jax(op, ins, attrs, outs):
    desc = JOpDesc(type=op, inputs={k: [k] for k in ins},
                   outputs={k: [k] for k in outs}, attrs=dict(attrs))
    vals = {}
    for k, v in ins.items():
        if isinstance(v, tuple):     # (rows, ids): a SelectedRows
            vals[k] = [JSR(jnp.asarray(v[0]), jnp.asarray(v[1], jnp.int32),
                           V)]
        else:
            vals[k] = [jnp.asarray(v)]
    got = jreg.get_op_def(op).call(vals, dict(attrs), jreg.KernelCtx(desc))
    return {k: np.asarray(got[k][0]) for k in outs}


def call_port(op, ins, attrs, outs, rng_key=None):
    desc = TOpDesc(type=op, inputs={k: [k] for k in ins},
                   outputs={k: [k] for k in outs}, attrs=dict(attrs))
    vals = {}
    for k, v in ins.items():
        if isinstance(v, tuple):
            vals[k] = [TSR(torch.from_numpy(v[0]), torch.from_numpy(v[1]),
                           V)]
        else:
            vals[k] = [torch.from_numpy(v)]
    ctx = treg.KernelCtx(desc, device="cpu", rng_key=rng_key)
    got = treg.get_op_def(op).call(vals, dict(attrs), ctx)
    return {k: got[k][0].numpy() for k in outs}


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("case", OP_CASES)
def test_optimizer_op_matches_jax(case, sparse):
    """Each op against the JAX op, dense and with a SelectedRows grad
    (the sparse branches of sgd, adam, adagrad; every other op
    densifies it, as the JAX package's `_dense_grad`)."""
    rng = np.random.RandomState(OP_CASES.index(case))
    op = _op_type(case)
    ins, attrs, outs = _op_inputs(case, rng)
    if sparse:
        ins["Grad"] = (_nrm(rng, (len(SPARSE_IDS), D)), SPARSE_IDS)
    want = call_jax(op, ins, attrs, outs)
    got = call_port(op, ins, attrs, outs)
    for k in outs:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=f"{case} {k}")


def test_adam_lazy_mode_sparse_matches_jax_and_freezes_untouched_rows():
    """lazy_mode=True with a SelectedRows grad: the touched rows against
    the JAX op, the untouched rows' params and moments unchanged; with
    lazy_mode=False the sparse update equals the dense one bit for bit
    (test_selected_rows.py's semantics test)."""
    rng = np.random.RandomState(3)
    ins, attrs, outs = _op_inputs("adam", rng)
    rows = _nrm(rng, (len(SPARSE_IDS), D))
    ins["Grad"] = (rows, SPARSE_IDS)
    lazy = dict(attrs, lazy_mode=True)
    want = call_jax("adam", ins, lazy, outs)
    got = call_port("adam", ins, lazy, outs)
    for k in outs:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL)
    untouched = [i for i in range(V) if i not in SPARSE_IDS]
    np.testing.assert_array_equal(got["ParamOut"][untouched],
                                  ins["Param"][untouched])
    np.testing.assert_array_equal(got["Moment1Out"][untouched],
                                  ins["Moment1"][untouched])
    dense = np.zeros((V, D), "float32")
    np.add.at(dense, SPARSE_IDS, rows)
    sparse_out = call_port("adam", ins, attrs, outs)
    dense_out = call_port("adam", dict(ins, Grad=dense), attrs, outs)
    for k in outs:
        np.testing.assert_array_equal(sparse_out[k], dense_out[k])


@pytest.mark.parametrize("op", ["sgd", "momentum", "adagrad"])
def test_sparse_update_equals_dense_bit_for_bit(op):
    """sgd, momentum and adagrad: the SelectedRows update equals the
    dense update of the scattered gradient, bit for bit (repeated ids
    are summed in arrival order, as the dense scatter-add sums them)."""
    rng = np.random.RandomState(4)
    ins, attrs, outs = _op_inputs(op, rng)
    rows = _nrm(rng, (len(SPARSE_IDS), D))
    dense = torch.zeros(V, D).index_add_(
        0, torch.from_numpy(SPARSE_IDS), torch.from_numpy(rows)).numpy()
    a = call_port(op, dict(ins, Grad=(rows, SPARSE_IDS)), attrs, outs)
    b = call_port(op, dict(ins, Grad=dense), attrs, outs)
    for k in outs:
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("state", [
    # (num_accumulates, old_num_accumulates, num_updates)
    (0, 0, 0), (3, 1, 5), (9, 2, 9), (4, 0, 16383), (20, 5, 40)])
def test_average_accumulates_matches_jax(state):
    """ModelAverage's accumulator op, int32 counters exactly: a plain
    step, a window restart (num_accumulates reaching min_window) and
    the 16384-update roll of sum_1 into sum_2."""
    rng = np.random.RandomState(sum(state))
    na, ona, nu = state
    ins = {"param": _nrm(rng, (4, 3)), "in_sum_1": _nrm(rng, (4, 3)),
           "in_sum_2": _nrm(rng, (4, 3)), "in_sum_3": _nrm(rng, (4, 3)),
           "in_num_accumulates": np.array([na], "int64"),
           "in_old_num_accumulates": np.array([ona], "int64"),
           "in_num_updates": np.array([nu], "int64")}
    attrs = {"average_window": 0.15, "min_average_window": 10,
             "max_average_window": 30}
    outs = ["out_sum_1", "out_sum_2", "out_sum_3", "out_num_accumulates",
            "out_old_num_accumulates", "out_num_updates"]
    want = call_jax("average_accumulates", ins, attrs, outs)
    got = call_port("average_accumulates", ins, attrs, outs)
    for k in outs:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)


def test_dpsgd_noise_law_and_replay():
    """dpsgd's noise: mean 0 and standard deviation sigma * clip (the
    JAX op's law, held on both), the same bits from the same (step seed,
    __rng_uid__), other bits from another step seed."""
    n = 40000
    ins = {"Param": np.zeros((n,), "float32"),
           "Grad": np.zeros((n,), "float32"), "LearningRate": _lr(1.0)}
    attrs = {"clip": 0.5, "batch_size": 1.0, "sigma": 2.0,
             "__rng_uid__": 7}
    for noise in (-call_port("dpsgd", ins, attrs, ["ParamOut"],
                             rng_key=11)["ParamOut"],
                  -call_jax("dpsgd", ins, attrs, ["ParamOut"])["ParamOut"]):
        assert abs(noise.mean()) < 4 * 1.0 / np.sqrt(n)
        assert abs(noise.std() - 1.0) < 0.02
    a = call_port("dpsgd", ins, attrs, ["ParamOut"], rng_key=11)
    b = call_port("dpsgd", ins, attrs, ["ParamOut"], rng_key=11)
    c = call_port("dpsgd", ins, attrs, ["ParamOut"], rng_key=12)
    np.testing.assert_array_equal(a["ParamOut"], b["ParamOut"])
    assert not np.array_equal(a["ParamOut"], c["ParamOut"])


def test_dpsgd_at_sigma_zero_is_clipped_sgd():
    rng = np.random.RandomState(5)
    ins, attrs, _ = _op_inputs("dpsgd", rng)
    got = call_port("dpsgd", ins, attrs, ["ParamOut"])["ParamOut"]
    g = ins["Grad"]
    g = g / max(1.0, np.sqrt((g.astype("float64") ** 2).sum()) / 1.0)
    np.testing.assert_allclose(got, ins["Param"] - 0.1 * g / 4.0,
                               rtol=RTOL, atol=ATOL)


def test_dgc_momentum_ranks_sum_each_ranks_top_k():
    """dgc_momentum with an axis, over two ranks (what SPMDRunner's
    lockstep calls): each rank keeps its top k of |V| locally zeroed,
    and both apply the sum of the ranks' compressed gradients."""
    from paddle_tpu_torch.ops.optimizer_ops import dgc_momentum_ranks

    rng = np.random.RandomState(6)
    attrs = {"mu": 0.9, "sparsity_ratio": 0.25, "axis_name": "dp"}
    rank_ins, singles = [], []
    for _ in range(2):
        ins, _, outs = _op_inputs("dgc_momentum", rng)
        rank_ins.append({k: [torch.from_numpy(v)] for k, v in ins.items()})
        singles.append(call_port("dgc_momentum", ins,
                                 {"mu": 0.9, "sparsity_ratio": 0.25},
                                 outs))
    got = dgc_momentum_ranks(rank_ins, attrs)
    total = singles[0]["GradOut"] + singles[1]["GradOut"]
    for r in range(2):
        np.testing.assert_allclose(got[r]["GradOut"].numpy(), total,
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(got[r]["UOut"].numpy(),
                                      singles[r]["UOut"])
        p = rank_ins[r]["Param"][0].numpy()
        np.testing.assert_allclose(got[r]["ParamOut"].numpy(),
                                   p - 0.1 * total, rtol=1e-6, atol=1e-6)
    with pytest.raises(RuntimeError, match="SPMDRunner"):
        call_port("dgc_momentum", {k: v[0].numpy()
                                   for k, v in rank_ins[0].items()},
                  attrs, ["ParamOut"])


# test_optimizers.py's op-math tests, on the port


def test_sgd_momentum_adam_op_math():
    rng = np.random.RandomState(0)
    p, g = rng.rand(4, 3).astype("float32"), rng.rand(4, 3).astype("float32")
    got = call_port("sgd", {"Param": p, "Grad": g, "LearningRate": _lr()},
                    {}, ["ParamOut"])["ParamOut"]
    np.testing.assert_allclose(got, p - 0.1 * g, rtol=1e-5)
    v = rng.rand(4, 3).astype("float32")
    for nesterov in (False, True):
        got = call_port("momentum", {"Param": p, "Grad": g, "Velocity": v,
                                     "LearningRate": _lr()},
                        {"mu": 0.9, "use_nesterov": nesterov},
                        ["ParamOut", "VelocityOut"])
        v_new = 0.9 * v + g
        np.testing.assert_allclose(got["VelocityOut"], v_new, rtol=1e-5)
        want = p - 0.1 * (g + 0.9 * v_new) if nesterov else p - 0.1 * v_new
        np.testing.assert_allclose(got["ParamOut"], want, rtol=1e-5)
    m1, m2 = rng.rand(4, 3).astype("float32"), rng.rand(4, 3).astype("float32")
    b1p, b2p = np.array([0.9], "float32"), np.array([0.999], "float32")
    got = call_port("adam", {"Param": p, "Grad": g, "Moment1": m1,
                             "Moment2": m2, "Beta1Pow": b1p,
                             "Beta2Pow": b2p, "LearningRate": _lr(0.01)},
                    {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8},
                    ["ParamOut", "Beta1PowOut"])
    m1n, m2n = 0.9 * m1 + 0.1 * g, 0.999 * m2 + 0.001 * g * g
    lr_t = 0.01 * np.sqrt(1 - b2p) / (1 - b1p)
    np.testing.assert_allclose(got["ParamOut"],
                               p - lr_t * m1n / (np.sqrt(m2n) + 1e-8),
                               rtol=1e-5)
    np.testing.assert_allclose(got["Beta1PowOut"], b1p * 0.9, rtol=1e-6)


# -- program level ------------------------------------------------------------


def _opt(name, pkg):
    """The optimizer `name` of `pkg`, as a callable that minimizes a
    loss and returns the helper objects a test needs."""
    o = pkg.optimizer

    def plain(make):
        def f(loss):
            make().minimize(loss)
            return None
        return f

    table = {
        "SGD": lambda: o.SGD(0.05),
        "Momentum": lambda: o.Momentum(0.05, momentum=0.9),
        "Momentum_nesterov": lambda: o.MomentumOptimizer(
            0.05, momentum=0.9, use_nesterov=True),
        "Adam": lambda: o.Adam(0.01),
        "Adagrad": lambda: o.Adagrad(0.05, initial_accumulator_value=0.1),
        "Adamax": lambda: o.Adamax(0.01),
        "Dpsgd": lambda: o.Dpsgd(0.05, clip=1.0, batch_size=16.0, sigma=0.0),
        "DecayedAdagrad": lambda: o.DecayedAdagrad(0.05),
        "Adadelta": lambda: o.Adadelta(1.0),
        "RMSProp": lambda: o.RMSProp(0.01, momentum=0.5),
        "RMSProp_centered": lambda: o.RMSPropOptimizer(
            0.01, centered=True),
        "Ftrl": lambda: o.Ftrl(0.05, l1=0.001, l2=0.001),
        "Lamb": lambda: o.Lamb(0.01),
        "Lamb_exclude": lambda: o.LambOptimizer(
            0.01, exclude_from_weight_decay_fn=lambda p: ".b_" in p.name),
        "LarsMomentum": lambda: o.LarsMomentum(0.05, momentum=0.9),
        "DGCMomentum": lambda: o.DGCMomentumOptimizer(
            0.05, momentum=0.9, sparsity=[0.5]),
    }
    if name in table:
        return plain(table[name])
    if name == "ModelAverage":
        def f(loss):
            o.SGD(0.05).minimize(loss)
            return o.ModelAverage(0.15, min_average_window=2,
                                  max_average_window=6)
        return f
    if name == "ExponentialMovingAverage":
        def f(loss):
            o.SGD(0.05).minimize(loss)
            ema = o.ExponentialMovingAverage(decay=0.5)
            ema.update()
            return ema
        return f
    if name == "Lookahead":
        return plain(lambda: o.LookaheadOptimizer(o.SGD(0.1), alpha=0.5,
                                                  k=2))
    if name == "Recompute":
        def f(loss):
            rc = o.RecomputeOptimizer(o.Adam(0.01))
            rc._set_checkpoints([])
            rc.minimize(loss)
        return f
    if name == "GradientMerge":
        return plain(lambda: o.GradientMerge(o.Momentum(0.05, 0.9),
                                             k_steps=2))
    if name == "Pipeline":
        return plain(lambda: o.PipelineOptimizer(o.SGD(0.05),
                                                 num_microbatches=2))
    raise KeyError(name)


OPTIMIZERS = ["SGD", "Momentum", "Momentum_nesterov", "Adam", "Adagrad",
              "Adamax", "Dpsgd", "DecayedAdagrad", "Adadelta", "RMSProp",
              "RMSProp_centered", "Ftrl", "Lamb", "Lamb_exclude",
              "LarsMomentum", "DGCMomentum", "ModelAverage",
              "ExponentialMovingAverage", "Lookahead", "Recompute",
              "GradientMerge", "Pipeline"]


def _mlp(pkg, name):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.framework.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data(name="x", shape=[8], dtype="float32")
        y = pkg.layers.data(name="y", shape=[1], dtype="float32")
        h = pkg.layers.fc(input=x, size=16, act="tanh")
        pred = pkg.layers.fc(input=h, size=1)
        loss = pkg.layers.mean(pkg.layers.square_error_cost(input=pred,
                                                            label=y))
        extra = _opt(name, pkg)(loss)
    return main, startup, loss, extra


def test_every_public_name_of_the_jax_optimizer_module():
    """An AST-free name diff: every name of the JAX package's
    `optimizer.__all__` is in the port's, and the aliases are the
    classes."""
    assert set(pt.optimizer.__all__) <= set(ptt.optimizer.__all__)
    for n in pt.optimizer.__all__:
        assert hasattr(ptt.optimizer, n), n
    assert ptt.optimizer.Lamb is ptt.optimizer.LambOptimizer
    assert ptt.optimizer.GradientMerge is ptt.optimizer.GradientMergeOptimizer


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_program_desc_matches_jax(name):
    mj, sj, _, _ = _mlp(pt, name)
    mt, st, _, _ = _mlp(ptt, name)
    assert mt.desc.to_dict() == mj.desc.to_dict()
    assert st.desc.to_dict() == sj.desc.to_dict()


def _persistables(prog):
    return sorted({v.name for v in prog.list_vars() if v.persistable})


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_three_steps_match_jax(name):
    """3 steps from the JAX scope, resynced before each: every
    persistable (params, accumulators, counters) within 1e-5 of the JAX
    package's, relative to the tensor's largest value."""
    mj, sj, lj, _ = _mlp(pt, name)
    mt, st, lt, _ = _mlp(ptt, name)
    rng = np.random.RandomState(1)
    exej, exet = pt.Executor(pt.CPUPlace()), ptt.Executor(ptt.CPUPlace())
    scj, sct = pt.Scope(), ptt.Scope()
    exej.run(sj, scope=scj)
    pers = [n for n in _persistables(mj) if scj.find_var(n) is not None]
    for step in range(3):
        x = rng.rand(16, 8).astype("float32")
        feed = {"x": x, "y": (x.sum(1, keepdims=True) * 0.3).astype(
            "float32")}
        scope_from_numpy(sct, {n: scj.get(n) for n in pers}, ptt.CPUPlace())
        a = exet.run(mt, feed=feed, fetch_list=[lt], scope=sct)[0]
        b = exej.run(mj, feed=feed, fetch_list=[lj], scope=scj)[0]
        np.testing.assert_allclose(a, b, rtol=1e-5)
        for n in pers:
            want, got = scj.get(n), sct.get(n)
            assert got.dtype == want.dtype, n
            np.testing.assert_allclose(
                got, want, rtol=0,
                atol=1e-5 * max(1.0, float(np.abs(want).max())),
                err_msg=f"{name}: {n} after step {step + 1}")


def _train(pkg, name, steps, rng):
    main, startup, loss, extra = _mlp(pkg, name)
    exe = pkg.Executor(pkg.CPUPlace())
    scope = pkg.Scope()
    exe.run(startup, scope=scope)
    X = rng.rand(32, 8).astype("float32")
    Y = (X @ rng.rand(8, 1) * 0.5).astype("float32")
    losses = [float(np.asarray(exe.run(main, feed={"x": X, "y": Y},
                                       fetch_list=[loss],
                                       scope=scope)[0]).reshape(()))
              for _ in range(steps)]
    return main, exe, scope, losses, extra, (X, Y, loss)


@pytest.mark.parametrize("name", ["SGD", "Momentum", "Adam", "Adagrad",
                                  "RMSProp", "Lamb", "DGCMomentum",
                                  "Lookahead"])
def test_optimizer_converges(name):
    """test_optimizers.py's convergence test (and the DGC and Lookahead
    ones of test_optimizer_extras.py) on the port."""
    _, _, _, losses, _, _ = _train(ptt, name, 60, np.random.RandomState(0))
    assert losses[-1] < losses[0] * 0.5, losses[::15]


def test_gradient_merge_applies_every_k():
    main, startup, loss, _ = _mlp(ptt, "GradientMerge")
    exe = ptt.Executor(ptt.CPUPlace())
    scope = ptt.Scope()
    exe.run(startup, scope=scope)
    pname = main.all_parameters()[0].name
    rng = np.random.RandomState(2)
    X, Y = rng.rand(8, 8).astype("float32"), rng.rand(8, 1).astype("float32")
    prev, changed = scope.get(pname), []
    for _ in range(6):
        exe.run(main, feed={"x": X, "y": Y}, fetch_list=[loss], scope=scope)
        cur = scope.get(pname)
        changed.append(not np.array_equal(cur, prev))
        prev = cur
    assert changed == [False, True] * 3


def test_ema_apply_and_restore_match_jax():
    """EMA's shadow, bias-corrected, against the JAX package's after 5
    steps from the same start; `apply` swaps it in and restores the
    params exactly."""
    rng = np.random.RandomState(7)
    X = rng.rand(8, 8).astype("float32")
    Y = rng.rand(8, 1).astype("float32")
    got = {}
    for pkg in (pt, ptt):
        main, startup, loss, ema = _mlp(pkg, "ExponentialMovingAverage")
        exe = pkg.Executor(pkg.CPUPlace())
        scope = pkg.Scope()
        exe.run(startup, scope=scope)
        if pkg is pt:
            start = {n: scope.get(n) for n in _persistables(main)
                     if scope.find_var(n) is not None}
        else:
            scope_from_numpy(scope, start, ptt.CPUPlace())
        with pkg.scope_guard(scope):
            for _ in range(5):
                exe.run(main, feed={"x": X, "y": Y}, fetch_list=[loss])
            pname = main.all_parameters()[0].name
            w = scope.get(pname)
            with ema.apply():
                got[pkg.__name__] = scope.get(pname)
                assert not np.allclose(w, got[pkg.__name__])
            np.testing.assert_array_equal(scope.get(pname), w)
    np.testing.assert_allclose(got["paddle_tpu_torch"], got["paddle_tpu"],
                               rtol=1e-5, atol=1e-6)


def test_model_average_apply_and_restore():
    """test_optimizer_extras.py's ModelAverage test, plus: inside
    `apply` the params are the accumulated sums over the count, and
    `restore` brings back the exact params."""
    rng = np.random.RandomState(8)
    main, exe, scope, _, ma, (X, Y, loss) = _train(ptt, "ModelAverage", 8,
                                                   rng)
    pname = main.all_parameters()[0].name
    # apply reads the default main program's parameters, as there
    with ptt.scope_guard(scope), ptt.program_guard(main):
        w = scope.get(pname)
        with ma.apply(exe):
            s = scope.get(ma._sum_vars[pname].name)
            cnt = scope.get(ma._cnt_var.name).reshape(())
            np.testing.assert_allclose(scope.get(pname), s / max(cnt, 1.0),
                                       rtol=1e-6)
            l_avg = exe.run(main, feed={"x": X, "y": Y}, fetch_list=[loss])
        assert np.isfinite(l_avg[0]).all()
        np.testing.assert_array_equal(scope.get(pname), w)


def _amp_program(pkg, mode, scale=128.0):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.framework.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data(name="x", shape=[8], dtype="float32")
        y = pkg.layers.data(name="y", shape=[1], dtype="float32")
        h = pkg.layers.fc(input=x, size=16, act="relu")
        pred = pkg.layers.fc(input=h, size=1)
        loss = pkg.layers.mean(pkg.layers.square_error_cost(
            input=pred, label=y))
        opt = pkg.amp.decorate(pkg.optimizer.SGD(0.05),
                               init_loss_scaling=scale,
                               use_bf16=mode != "f16",
                               rewrite=mode == "rewrite")
        opt.minimize(loss)
    return main, startup, loss, opt


def _amp_feed(rng):
    x = rng.rand(16, 8).astype("float32")
    return {"x": x, "y": x.sum(1, keepdims=True).astype("float32")}


@pytest.mark.parametrize("mode", ["bf16", "f16", "rewrite"])
def test_amp_decorate_matches_jax(mode):
    """`amp.decorate` (copied): the same main and startup ProgramDesc as
    the JAX package's (mixed_bf16 pinned; f16 with the static loss
    scale, its unscale and zeroing of non-finite gradients; the cast
    rewrite), and 3 steps from the JAX scope, resynced, within 2**-7 of
    each tensor's largest value (two bf16 ulps: both packages round the
    white-list products to 16 bits, in their own orders), the loss at
    2**-5 (the squared error of a 16-bit prediction whose residual
    nearly cancels). The f16 case scales the loss by 128: at the default
    2**15 this MLP's f16 gradients overflow (ROADMAP F15)."""
    mj, sj, lj, oj = _amp_program(pt, mode)
    mt, st, lt, ot = _amp_program(ptt, mode)
    assert mt.desc.to_dict() == mj.desc.to_dict()
    assert st.desc.to_dict() == sj.desc.to_dict()
    assert (ot.get_loss_scaling() is None) == (mode != "f16")
    exej, exet = pt.Executor(pt.CPUPlace()), ptt.Executor(ptt.CPUPlace())
    scj, sct = pt.Scope(), ptt.Scope()
    exej.run(sj, scope=scj)
    pers = [n for n in _persistables(mj) if scj.find_var(n) is not None]
    rng = np.random.RandomState(9)
    for _ in range(3):
        feed = _amp_feed(rng)
        scope_from_numpy(sct, {n: scj.get(n) for n in pers}, ptt.CPUPlace())
        a = exet.run(mt, feed=feed, fetch_list=[lt], scope=sct)[0]
        b = exej.run(mj, feed=feed, fetch_list=[lj], scope=scj)[0]
        np.testing.assert_allclose(a, b, rtol=2.0 ** -5)
        for n in pers:
            want = scj.get(n)
            assert np.abs(sct.get(n) - want).max() <= \
                2.0 ** -7 * max(1.0, float(np.abs(want).max())), n


def test_amp_f16_overflow_turns_params_nan_in_both_packages():
    """ROADMAP F15, shown: `decorate(use_bf16=False)` zeroes a
    non-finite gradient by multiplying it by its finite mask, and
    inf * 0 is NaN, so at the default loss scale (2**15) an f16
    gradient that overflows makes its param NaN, in the JAX package and
    in the port's copy alike."""
    nan = {}
    for pkg in (pt, ptt):
        main, startup, loss, _ = _amp_program(pkg, "f16", scale=2.0 ** 15)
        exe = pkg.Executor(pkg.CPUPlace())
        scope = pkg.Scope()
        exe.run(startup, scope=scope)
        exe.run(main, feed=_amp_feed(np.random.RandomState(9)),
                fetch_list=[loss], scope=scope)
        nan[pkg.__name__] = sorted(
            p.name for p in main.all_parameters()
            if np.isnan(scope.get(p.name)).any())
    # which weights overflow depends on each package's f16 products
    assert nan["paddle_tpu"] and nan["paddle_tpu_torch"], nan


def test_dgc_with_an_axis_runs_under_spmd_runner():
    """DGCMomentum(axis_name="dp") under SPMDRunner on 2 CPU ranks: one
    step equals each rank's gradient (its half of the batch) compressed
    to its top k and summed by the ring's `sparse_allreduce`, applied on
    both ranks; a plain Executor raises, naming SPMDRunner."""
    from paddle_tpu_torch import parallel as par
    from paddle_tpu_torch.ops.collective import sparse_allreduce

    def build(axis):
        main, startup = ptt.Program(), ptt.Program()
        main.random_seed = startup.random_seed = 3
        with ptt.framework.unique_name.guard(), \
                ptt.program_guard(main, startup):
            x = ptt.layers.data(name="x", shape=[8], dtype="float32")
            y = ptt.layers.data(name="y", shape=[1], dtype="float32")
            pred = ptt.layers.fc(input=ptt.layers.fc(input=x, size=16,
                                                     act="tanh"), size=1)
            loss = ptt.layers.mean(ptt.layers.square_error_cost(
                input=pred, label=y))
            ptt.optimizer.DGCMomentumOptimizer(
                0.1, momentum=0.9, sparsity=[0.75],
                axis_name=axis).minimize(loss)
        return main, startup, loss

    rng = np.random.RandomState(2)
    x = rng.rand(16, 8).astype("float32")
    feed = {"x": x, "y": x.sum(1, keepdims=True).astype("float32")}
    main, startup, loss = build("dp")
    exe = ptt.Executor(ptt.CPUPlace())
    scope = ptt.Scope()
    exe.run(startup, scope=scope)
    params = [p.name for p in main.all_parameters()]
    init = {n: scope.get(n) for n in params}
    with pytest.raises(RuntimeError, match="SPMDRunner"):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    mesh = par.make_mesh(par.MeshConfig(dp=2), devices=["cpu"] * 2)
    par.SPMDRunner(main, mesh).run(exe, feed=feed, fetch_list=[loss],
                                   scope=scope)
    plain, pstart, _ = build(None)
    grads = []
    for r in range(2):
        s = ptt.Scope()
        exe.run(pstart, scope=s)
        grads.append(exe.run(plain, feed={k: v[r * 8:(r + 1) * 8]
                                          for k, v in feed.items()},
                             fetch_list=[n + "@GRAD" for n in params],
                             scope=s))
    for i, n in enumerate(params):
        flats, k = [], None
        for r in range(2):
            v = torch.from_numpy(grads[r][i]).reshape(-1)
            k = max(1, int(v.numel() * (1.0 - 0.75)))
            t = torch.topk(v.abs(), k).values[-1]
            flats.append(torch.where(v.abs() >= t, v, torch.zeros_like(v)))
        want = init[n] - 0.1 * sparse_allreduce(flats, k).reshape(
            init[n].shape).numpy()
        np.testing.assert_allclose(scope.get(n), want, rtol=1e-6,
                                   atol=1e-7, err_msg=n)
