"""The JAX package's `ops/text_match.py` op types in the port
(`paddle_tpu_torch/ops/text_match.py`: the nine beside `tree_conv`)
against the JAX kernels on the same numpy inputs from a seed: forward,
and the `<op>_grad` where the op is differentiable (every floating
input's gradient under a random cotangent on every floating output), at
the shapes of tests/test_text_match_ops.py.

Tolerances, on float32 (`test_torch_fluid_ops.TOL`): elementwise ops
rtol 1e-5 with an atol of 1e-6 of the largest reference value ("ew");
products (bilinear_tensor_product, match_matrix_tensor, var_conv_2d's
conv) 1e-4 ("mm"); integer outputs exactly. `hash` is held bit for bit
on ids up to 2^31 - 1, for several seeds, num_hash 1 and 3, and
mod_by below and above 2^31. `cvm`'s gradient is its own kernel (the
counters' slots of dX are the CVM input). One step of a small
text-matching program (`chip_smoke.text_match_program`) is held to the
JAX package's from the same state.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from paddle_tpu.core import registry as jreg

from paddle_tpu_torch.core import registry as treg
from test_torch_fluid_ops import TOL, _make, _run, _spec

torch.set_num_threads(2)


def held(got, want, cls, what, f64=False):
    """`got` against `want` by class: integers and booleans exactly,
    floats at TOL[cls] scaled by the reference's largest value. With
    `f64`, a float64 reference (the JAX op under the suite's x64, where
    its constants are float64) is held against the port's float32."""
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if f64 and want.dtype == np.float64:
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


def _jax_call(op_type, attrs, outputs):
    """A function of the inputs (jnp, by slot) running the JAX kernel."""
    from paddle_tpu.core.ir import OpDesc as JOpDesc

    opdef = jreg.get_op_def(op_type)

    def call(vals):
        names = {k: [f"{k}{i}" for i in range(len(v))]
                 for k, v in vals.items()}
        desc = JOpDesc(type=op_type, inputs=names, outputs=outputs,
                       attrs=attrs)
        return opdef.call(vals, attrs, jreg.KernelCtx(desc))
    return call


def _jnp(ins):
    import jax.numpy as jnp

    return {k: [None if x is None else jnp.asarray(x) for x in v]
            for k, v in ins.items()}


def _np(outs):
    return {k: [None if o is None else np.asarray(o) for o in v]
            for k, v in outs.items()}


def run_jax(op_type, ins, attrs, outputs):
    """`_run("jax", ...)` with the kernel under `jax.jit`: one compile
    of the whole kernel instead of an eager dispatch of each of its
    primitives (the same numbers; it keeps these files quick)."""
    import jax

    return _np(jax.jit(_jax_call(op_type, attrs, outputs))(_jnp(ins)))


def _grad_ins(ins, fwd, cots):
    """The `<op>_grad` op's inputs and requested outputs: the forward's
    inputs and outputs, a cotangent for every floating output, a
    gradient for every floating input slot."""
    gins, gouts = {}, {}
    for slot, vals in ins.items():
        gins["fwd_in::" + slot] = vals
        if all(np.issubdtype(np.asarray(x).dtype, np.floating)
               for x in vals):
            gouts["in_grad::" + slot] = [f"g{slot}{i}"
                                        for i in range(len(vals))]
    for slot, vals in fwd.items():
        gins["fwd_out::" + slot] = vals
        gins["out_grad::" + slot] = cots[slot]
    return gins, gouts


def _cotangents(rng, shapes):
    return {slot: [None if v is None or not np.issubdtype(
        np.dtype(v.dtype), np.floating) else rng.standard_normal(
            v.shape).astype(np.float32) for v in vals]
        for slot, vals in shapes.items()}


def _run_jax_with_grad(op_type, ins, attrs, rng):
    """The JAX kernel's forward and its `<op>_grad` in one `jax.jit`
    (one compile; the forward's outputs feed the grad op's fwd_out::
    slots): (forward, grad outputs, the grad op's inputs and outputs
    as numpy)."""
    import jax

    fwd = _jax_call(op_type, attrs, {})
    shapes = jax.eval_shape(fwd, _jnp(ins))
    cots = _cotangents(rng, shapes)
    _, gouts = _grad_ins(ins, shapes, cots)
    grad = _jax_call(op_type + "_grad", attrs, gouts)

    def both(vals, cot):
        out = fwd(vals)
        return out, grad({**{"fwd_in::" + k: v for k, v in vals.items()},
                          **{"fwd_out::" + k: v for k, v in out.items()},
                          **{"out_grad::" + k: v for k, v in cot.items()}})

    out, g = jax.jit(both)(_jnp(ins), _jnp(cots))
    fj = _np(out)
    gins, _ = _grad_ins(ins, fj, cots)
    return fj, _np(g), gins, gouts


def check_op(op_type, ins, attrs, cls="ew", seed=0, f64=False,
             grad=True, jit=True):
    """Forward through both registries, then `<op>_grad` where the JAX
    op has one (and `grad`); the JAX kernel under `jax.jit` (forward
    and gradient in one compile), or eager (quicker for a few small
    primitives, whose compiles jax caches across calls). Returns (the
    port's, the JAX op's) forward outputs."""
    rng = np.random.RandomState(seed)
    has = jreg.get_op_def(op_type).has_grad()
    assert treg.get_op_def(op_type).has_grad() == has
    grad = grad and has
    if jit and grad:
        fj, gj, gins, gouts = _run_jax_with_grad(op_type, ins, attrs, rng)
    else:
        fj = (run_jax if jit else lambda *a: _run("jax", *a))(
            op_type, ins, attrs, {})
    ft = _run("torch", op_type, ins, attrs, {})
    assert sorted(k for k, v in fj.items() if v) == \
        sorted(k for k, v in ft.items() if v), (sorted(fj), sorted(ft))
    for slot, vals in fj.items():
        for i, v in enumerate(vals):
            if v is None:
                assert i >= len(ft.get(slot, [])) or ft[slot][i] is None
                continue
            held(ft[slot][i], v, cls, f"{op_type} {slot}[{i}]", f64)
    if not grad:
        return ft, fj
    if not jit:
        gins, gouts = _grad_ins(ins, fj, _cotangents(rng, fj))
        gj = _run("jax", op_type + "_grad", gins, attrs, gouts)
    gt = _run("torch", op_type + "_grad", gins, attrs, gouts)
    assert sorted(gj) == sorted(gt), (sorted(gj), sorted(gt))
    for slot, vals in gj.items():
        for i, v in enumerate(vals):
            held(gt[slot][i], v, cls, f"{op_type}_grad {slot}[{i}]", f64)
    return ft, fj


def _ins(spec, seed):
    rng = np.random.RandomState(seed)
    return {slot: [_make(rng, s) for s in specs]
            for slot, specs in spec.items()}


LEN3 = np.array([5, 2, 0], "int64")

CASES = [
    ("pad_constant_like", {"X": [_spec((4, 5))], "Y": [_spec((2, 3))]},
     {"pad_value": 7.0}, "ew"),
    ("pad_constant_like", {"X": [_spec((3, 4, 5))],
                           "Y": [_spec((3, 2, 5))]}, {}, "ew"),
    ("squared_l2_distance", {"X": [_spec((5, 4))], "Y": [_spec((5, 4))]},
     {}, "ew"),
    ("squared_l2_distance", {"X": [_spec((5, 2, 3))],
                             "Y": [_spec((1, 2, 3))]}, {}, "ew"),
    ("bilinear_tensor_product", {"X": [_spec((3, 4))], "Y": [_spec((3, 5))],
                                 "Weight": [_spec((2, 4, 5))],
                                 "Bias": [_spec((1, 2))]}, {}, "mm"),
    ("bilinear_tensor_product", {"X": [_spec((3, 4))], "Y": [_spec((3, 5))],
                                 "Weight": [_spec((2, 4, 5))]}, {}, "mm"),
    ("conv_shift", {"X": [_spec((2, 7))], "Y": [_spec((2, 3))]}, {}, "ew"),
    ("match_matrix_tensor", {"X": [_spec((2, 4, 6))],
                             "Y": [_spec((2, 5, 6))],
                             "W": [_spec((6, 3, 6))]}, {}, "mm"),
    ("var_conv_2d", {"X": [_spec((3, 2, 6, 5))], "W": [_spec((4, 18))],
                     "ROW": [LEN3], "COLUMN": [np.array([4, 5, 1],
                                                        "int64")]},
     {"kernel_h": 3, "kernel_w": 3}, "mm"),
    ("var_conv_2d", {"X": [_spec((3, 2, 7, 6))], "W": [_spec((4, 2, 3, 3))],
                     "ROW": [np.array([7, 3, 1], "int64")],
                     "COLUMN": [np.array([2, 6, 5], "int64")]},
     {"kernel_h": 3, "kernel_w": 3, "stride_h": 2, "stride_w": 2}, "mm"),
    ("var_conv_2d", {"X": [_spec((2, 2, 5, 5))], "W": [_spec((3, 18))]},
     {}, "mm"),
    ("filter_by_instag", {"Ins": [_spec((6, 3))],
                          "Ins_tag": [np.array([[1, -1], [4, 2], [3, -1],
                                                [2, 2], [5, 6], [9, 1]],
                                               "int64")],
                          "Filter_tag": [np.array([1, 2], "int64")]},
     {"is_lod": True}, "ew"),
    ("filter_by_instag", {"Ins": [_spec((4, 2))],
                          "Ins_tag": [np.array([3, 7, 3, 1], "int64")],
                          "Filter_tag": [np.array([3], "int64")]},
     {}, "ew"),
]


@pytest.mark.parametrize(
    "op_type, spec, attrs, cls", CASES,
    ids=[f"{c[0]}_{i}" for i, c in enumerate(CASES)])
def test_op_forward_and_gradient(op_type, spec, attrs, cls):
    check_op(op_type, _ins(spec, sum(map(ord, op_type))), attrs, cls)


@pytest.mark.parametrize("use_cvm", [True, False])
def test_cvm_forward_and_own_gradient(use_cvm):
    """cvm's forward and its own gradient kernel: dX's counters' slots
    are the CVM input, the tail the output gradient, as the JAX op's."""
    rng = np.random.RandomState(3)
    x = rng.uniform(0.0, 9.0, (5, 6)).astype("float32")
    ins = {"X": [x], "CVM": [rng.uniform(0.0, 1.0, (5, 2)).astype(
        "float32")]}
    ft, _ = check_op("cvm", ins, {"use_cvm": use_cvm}, jit=False)
    g = _run("torch", "cvm_grad",
             {"fwd_in::X": ins["X"], "fwd_in::CVM": ins["CVM"],
              "fwd_out::Y": ft["Y"],
              "out_grad::Y": [np.ones_like(ft["Y"][0])]},
             {"use_cvm": use_cvm}, {"in_grad::X": ["gx"]})
    np.testing.assert_array_equal(g["in_grad::X"][0][:, :2], ins["CVM"][0])


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("num_hash, mod_by", [(1, 100000), (3, 1000003),
                                              (2, 2 ** 31 + 11),
                                              (3, 2 ** 33)])
def test_hash_bit_for_bit(seed, num_hash, mod_by):
    """hash's Out equals the JAX op's exactly: ids drawn up to 2^31 - 1
    (with 0 and the largest), windows of 1 and 4, int64 and int32 ids."""
    rng = np.random.RandomState(seed)
    for w, dt in ((4, "int64"), (1, "int32"), (4, "int32")):
        ids = rng.randint(0, 2 ** 31 - 1, (64, w)).astype(dt)
        ids[0, 0], ids[1, -1] = 0, 2 ** 31 - 1
        ft, fj = check_op("hash", {"X": [ids]},
                          {"num_hash": num_hash, "mod_by": mod_by},
                          jit=False)
        assert ft["Out"][0].dtype == np.int64
        assert ft["Out"][0].min() >= 0 and ft["Out"][0].max() < min(
            mod_by, 2 ** 31)


def test_hash_spreads_ids():
    """Distinct windows hash to distinct buckets almost always (a
    mixing check of the port's own, beside the equality above)."""
    ids = np.arange(4096, dtype="int64")[:, None]
    ft, _ = check_op("hash", {"X": [ids]}, {"num_hash": 2, "mod_by": 1 << 30},
                     jit=False)
    out = ft["Out"][0]
    assert len(np.unique(out[:, 0])) > 4090
    assert (out[:, 0] != out[:, 1]).mean() > 0.99


def test_text_match_program_step_matches_jax():
    """One Adam step of `chip_smoke.text_match_program` at a small size
    (the hash, embedding, match_matrix_tensor, var_conv_2d,
    sequence_topk_avg_pooling, fc and CTR cvm + filter_by_instag
    branches) from the JAX package's state: the loss at rtol 1e-5 and
    every trainable parameter's gradient within 1e-4 of the step's
    largest."""
    import paddle_tpu as pt

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.convert import scope_from_numpy

    size = dict(B=4, Tq=5, Tt=7, vocab=50, emb=8, dim_t=2, ch=3, hid=8,
                ctr_dim=6)
    j = chip_smoke.text_match_program(pt, **size)
    t = chip_smoke.text_match_program(ptt, **size)
    assert t["main"].desc.to_dict() == j["main"].desc.to_dict()
    scj = pt.Scope()
    pt.Executor(pt.CPUPlace()).run(j["startup"], scope=scj)
    pers = [v.name for v in j["startup"].list_vars() if v.persistable]
    sct = scope_from_numpy(ptt.Scope(), {n: scj.get(n) for n in pers},
                           ptt.CPUPlace())
    params = [p.name for p in j["main"].all_parameters() if p.trainable]
    fetch = [j["loss"].name] + [p + "@GRAD" for p in params]
    feed = chip_smoke.text_match_feed(np.random.RandomState(0), **size)
    want = pt.Executor(pt.CPUPlace()).run(j["main"], feed=feed,
                                          fetch_list=fetch, scope=scj)
    got = ptt.Executor(ptt.CPUPlace()).run(t["main"], feed=feed,
                                           fetch_list=fetch, scope=sct)
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(want[0]),
                               rtol=1e-5)
    scale = max(float(np.abs(np.asarray(w)).max()) for w in want[1:])
    for p, g, w in zip(params, got[1:], want[1:]):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=0,
                                   atol=1e-4 * scale, err_msg=p)
