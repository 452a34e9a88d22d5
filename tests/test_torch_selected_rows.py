"""SelectedRows sparse gradients through the port's Program path, on the
CPU: the JAX package's `tests/test_selected_rows.py` mirrored, held
against that package on the same numpy inputs.

- The kernels with a SelectedRows branch (`sum`, `clip`, `clip_by_norm`,
  `squared_l2_norm`, `elementwise_mul` by a scalar, the three ops of
  `ops/misc.py`) densify to the JAX kernels' results (rtol 1e-6: the
  merges sum in one order, the norms reduce in another).
- `lookup_table` / `lookup_table_v2` with `is_sparse=True` give a
  SelectedRows whose dense form is the JAX package's.
- An `is_sparse` embedding trained by SGD, Momentum, Adagrad and Adam
  (lazy_mode off) leaves the same table as the dense program, bit for
  bit (the JAX package's own test holds it at rtol 1e-6); the sparse
  programs, lazy Adam too, against the JAX package's sparse programs
  over 3 steps at 1e-5 of each tensor's largest value.
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
from paddle_tpu_torch.core.selected_rows import (SelectedRows, merge_rows,
                                                 to_dense)

torch.set_num_threads(2)


def _jsr(rows, ids, h):
    return JSR(jnp.asarray(np.asarray(rows, "float32")),
               jnp.asarray(np.asarray(ids), jnp.int32), h)


def _tsr(rows, ids, h):
    return SelectedRows(torch.tensor(np.asarray(rows, "float32")),
                        torch.tensor(np.asarray(ids), dtype=torch.int64), h)


def _dense(v):
    if isinstance(v, JSR):
        return np.asarray(v.to_dense())
    if isinstance(v, SelectedRows):
        return v.to_dense().numpy()
    return np.asarray(v)


def _both(op, ins_np, attrs, outs=("Out",)):
    """(port, jax) outputs of `op`; ins_np values are numpy arrays or
    (rows, ids, height) triples for a SelectedRows."""
    res = []
    for pkg in ("torch", "jax"):
        vals = {}
        for k, vs in ins_np.items():
            vals[k] = [
                (_tsr if pkg == "torch" else _jsr)(*v) if isinstance(v, tuple)
                else (torch.from_numpy(v) if pkg == "torch"
                      else jnp.asarray(v)) for v in vs]
        names = {k: [f"{k}{i}" for i in range(len(v))]
                 for k, v in ins_np.items()}
        if pkg == "torch":
            desc = TOpDesc(type=op, inputs=names,
                           outputs={o: [o] for o in outs}, attrs=attrs)
            got = treg.get_op_def(op).call(
                vals, dict(attrs), treg.KernelCtx(desc, device="cpu"))
        else:
            desc = JOpDesc(type=op, inputs=names,
                           outputs={o: [o] for o in outs}, attrs=attrs)
            got = jreg.get_op_def(op).call(vals, dict(attrs),
                                           jreg.KernelCtx(desc))
        res.append(got)
    return res


SR = ([[3.0, -4.0], [1.0, 1.0], [3.0, 0.0]], [2, 0, 2], 6)


def test_merge_rows_sums_in_arrival_order_like_a_scatter_add():
    rng = np.random.RandomState(0)
    ids = torch.from_numpy(rng.randint(0, 20, 300))
    rows = torch.from_numpy(rng.standard_normal((300, 5)).astype("float32"))
    uids, summed = merge_rows(ids, rows)
    assert torch.equal(uids, torch.unique(ids))
    dense = torch.zeros(20, 5).index_add_(0, ids, rows)
    assert torch.equal(dense[uids], summed)
    assert torch.equal(SelectedRows(rows, ids, 20).to_dense(), dense)


@pytest.mark.parametrize("op, attrs", [
    ("clip", {"min": -1.0, "max": 1.0}),
    ("clip", {"min": 0.5, "max": 10.0}),
    ("clip_by_norm", {"max_norm": 1.0}),
    ("squared_l2_norm", {}),
    ("merge_selected_rows", {}),
    ("get_tensor_from_selected_rows", {}),
])
def test_selected_rows_kernels_match_jax(op, attrs):
    """test_clip_kernels_on_selected_rows and the misc ops: each output
    (densified) against the JAX kernel's. get_tensor_from_selected_rows
    gives the value tensor, which for an unmerged input is the rows as
    they came in both packages."""
    got, want = _both(op, {"X": [SR]}, attrs)
    g, w = got["Out"][0], want["Out"][0]
    assert isinstance(g, SelectedRows) == isinstance(w, JSR)
    np.testing.assert_allclose(_dense(g), _dense(w), rtol=1e-6)


def test_clip_does_not_lift_repeated_slots_to_min():
    """The JAX test's duplicate-id case: clip([6, -4]) once, untouched
    rows stay zero."""
    got, _ = _both("clip", {"X": [SR]}, {"min": 0.5, "max": 10.0})
    dense = _dense(got["Out"][0])
    np.testing.assert_allclose(dense[2], [6.0, 0.5])
    assert np.all(dense[[1, 3, 4, 5]] == 0)


def test_sum_concatenates_and_mixed_densifies():
    a = ([[1.0, 2.0]], [3], 5)
    b = ([[10.0, 20.0], [30.0, 40.0]], [1, 3], 5)
    got, want = _both("sum", {"X": [a, b]}, {})
    assert isinstance(got["Out"][0], SelectedRows)
    np.testing.assert_array_equal(_dense(got["Out"][0]),
                                  _dense(want["Out"][0]))
    d = np.ones((5, 2), "float32")
    got, want = _both("sum", {"X": [a, d]}, {})
    assert isinstance(got["Out"][0], torch.Tensor)
    np.testing.assert_array_equal(_dense(got["Out"][0]),
                                  _dense(want["Out"][0]))


def test_scalar_multiply_stays_sparse():
    got, want = _both("elementwise_mul",
                      {"X": [SR], "Y": [np.array([0.5], "float32")]}, {})
    assert isinstance(got["Out"][0], SelectedRows)
    np.testing.assert_allclose(_dense(got["Out"][0]),
                               _dense(want["Out"][0]), rtol=1e-6)
    got, want = _both("elementwise_add",
                      {"X": [SR], "Y": [np.ones((6, 2), "float32")]}, {})
    np.testing.assert_allclose(_dense(got["Out"][0]),
                               _dense(want["Out"][0]), rtol=1e-6)


def test_split_selected_rows_matches_jax():
    rows = np.arange(8, dtype="float32").reshape(4, 2)
    x = (rows, [0, 3, 5, 6], 8)
    got, want = _both("split_selected_rows", {"X": [x]},
                      {"height_sections": [4, 4]}, outs=("Out",))
    assert len(got["Out"]) == 2
    for g, w in zip(got["Out"], want["Out"]):
        assert g.height == w.height == 4
        np.testing.assert_array_equal(_dense(g), _dense(w))
    assert got["Out"][0].rows.shape[0] == 2   # only its own rows


@pytest.mark.parametrize("op", ["lookup_table", "lookup_table_v2"])
@pytest.mark.parametrize("padding_idx", [-1, 2])
def test_sparse_lookup_table_grad_matches_jax(op, padding_idx):
    rng = np.random.RandomState(1)
    W = rng.standard_normal((9, 4)).astype("float32")
    ids = rng.randint(0, 9, (6, 1)).astype("int64")
    shape = (6, 4) if op == "lookup_table" else (6, 1, 4)
    og = rng.standard_normal(shape).astype("float32")
    attrs = {"is_sparse": True, "padding_idx": padding_idx}
    ins = {"fwd_in::W": [W], "fwd_in::Ids": [ids], "out_grad::Out": [og],
           "fwd_out::Out": [og]}
    got, want = _both(op + "_grad", ins, attrs, outs=("in_grad::W",))
    g, w = got["in_grad::W"][0], want["in_grad::W"][0]
    assert isinstance(g, SelectedRows) and isinstance(w, JSR)
    np.testing.assert_allclose(_dense(g), _dense(w), rtol=1e-6, atol=1e-7)
    attrs["is_sparse"] = False
    got, _ = _both(op + "_grad", ins, attrs, outs=("in_grad::W",))
    np.testing.assert_array_equal(_dense(got["in_grad::W"][0]), _dense(g))


V, D = 12, 4


def _emb_program(pkg, is_sparse, opt, regularize=False, clip=None):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 11
    with pkg.framework.unique_name.guard(), pkg.program_guard(main, startup):
        w = pkg.layers.data(name="w", shape=[1], dtype="int64")
        y = pkg.layers.data(name="y", shape=[1], dtype="float32")
        emb = pkg.layers.embedding(w, (V, D), is_sparse=is_sparse)
        emb = pkg.layers.reshape(emb, shape=[-1, D])
        pred = pkg.layers.fc(input=emb, size=1)
        loss = pkg.layers.mean(pkg.layers.square_error_cost(input=pred,
                                                            label=y))
        o = pkg.optimizer
        kw = {}
        if regularize:
            kw["regularization"] = pkg.regularizer.L2Decay(1e-4)
        if clip is not None:
            kw["grad_clip"] = {
                "value": lambda: pkg.clip.GradientClipByValue(max=0.1),
                "norm": lambda: pkg.clip.GradientClipByNorm(clip_norm=0.5),
                "global_norm": lambda: pkg.clip.GradientClipByGlobalNorm(
                    clip_norm=0.5)}[clip]()
        {"sgd": lambda: o.SGD(0.2, **kw),
         "momentum": lambda: o.Momentum(0.2, momentum=0.9, **kw),
         "adagrad": lambda: o.Adagrad(0.2, **kw),
         "adam": lambda: o.Adam(0.05, **kw),
         "adam_lazy": lambda: o.Adam(0.05, lazy_mode=True, **kw),
         }[opt]().minimize(loss)
    table = [p.name for p in main.all_parameters()
             if tuple(p.shape) == (V, D)][0]
    return main, startup, loss, table


def _feeds(steps, seed=0):
    rng = np.random.RandomState(seed)
    return [{"w": rng.randint(0, V, (6, 1)).astype("int64"),
             "y": rng.rand(6, 1).astype("float32")} for _ in range(steps)]


def _train_port(is_sparse, opt, steps=3, same_feed=False, **kw):
    main, startup, loss, table = _emb_program(ptt, is_sparse, opt, **kw)
    exe = ptt.Executor(ptt.CPUPlace())
    scope = ptt.Scope()
    exe.run(startup, scope=scope)
    losses = [float(exe.run(main, feed=f, fetch_list=[loss],
                            scope=scope)[0].reshape(()))
              for f in (_feeds(1) * steps if same_feed else _feeds(steps))]
    return scope.get(table), losses


@pytest.mark.parametrize("opt", ["sgd", "momentum", "adagrad", "adam"])
def test_embedding_is_sparse_program_equals_dense(opt):
    """test_embedding_is_sparse_program_matches_dense, held bit for bit:
    sgd, momentum, adagrad and adam (lazy_mode off) give the dense
    program's table exactly."""
    w_sparse, _ = _train_port(True, opt)
    w_dense, _ = _train_port(False, opt)
    np.testing.assert_array_equal(w_sparse, w_dense)
    assert np.abs(w_sparse).sum() > 0


@pytest.mark.parametrize("opt", ["sgd", "momentum", "adagrad", "adam",
                                 "adam_lazy"])
def test_sparse_program_matches_jax(opt):
    """The sparse program against the JAX package's, 3 steps from its
    scope, resynced each step: desc equal, the table and every other
    persistable within 1e-5 of the tensor's largest value."""
    mj, sj, lj, table = _emb_program(pt, True, opt)
    mt, st, lt, _ = _emb_program(ptt, True, opt)
    assert mt.desc.to_dict() == mj.desc.to_dict()
    exej, exet = pt.Executor(pt.CPUPlace()), ptt.Executor(ptt.CPUPlace())
    scj, sct = pt.Scope(), ptt.Scope()
    exej.run(sj, scope=scj)
    pers = sorted({v.name for v in mj.list_vars() if v.persistable
                   and scj.find_var(v.name) is not None})
    for f in _feeds(3):
        scope_from_numpy(sct, {n: scj.get(n) for n in pers}, ptt.CPUPlace())
        a = exet.run(mt, feed=f, fetch_list=[lt], scope=sct)[0]
        b = exej.run(mj, feed=f, fetch_list=[lj], scope=scj)[0]
        np.testing.assert_allclose(a, b, rtol=1e-5)
        for n in pers:
            want = scj.get(n)
            np.testing.assert_allclose(
                sct.get(n), want, rtol=0,
                atol=1e-5 * max(1.0, float(np.abs(want).max())), err_msg=n)
    assert table in pers


@pytest.mark.parametrize("clip_kind", ["value", "norm", "global_norm"])
def test_sparse_embedding_with_regularizer_and_clip(clip_kind):
    """is_sparse embedding + L2 decay + every gradient-clip type trains
    through the port's Program path."""
    _, losses = _train_port(True, "sgd", steps=5, same_feed=True,
                            regularize=True, clip=clip_kind)
    assert np.isfinite(losses).all() and losses[-1] <= losses[0], losses


def test_to_dense_of_a_dense_value_is_itself():
    t = torch.ones(2, 2)
    assert to_dense(t) is t
