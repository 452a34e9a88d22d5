"""The port's fluid Program path against the JAX package's, on three
programs: bench.py's LeNet rung (`_build_lenet_program`), the book
LeNet (`models/lenet.py::build_program`, with its accuracy head) and
fit_a_line (`fc` 13 -> 1, `square_error_cost`, SGD).

- Program identity: each built under `unique_name.guard()` in both
  packages gives equal `desc.to_dict()` for main and startup: ops,
  attrs, the grad and optimizer ops, every inferred shape and dtype.
  The LeNet rung is built by `chip_smoke.lenet_rung_program`, held to
  bench.py's builder statement for statement.
- Three steps from the same initial scope (the JAX scope's persistables
  carried in with `convert.scope_from_numpy`), batch 16: the losses
  (and the book LeNet's accuracy) at rtol 1e-5, every parameter
  gradient of each step within 1e-5 of its tensor's largest value, and
  every parameter after each step within 1e-5 (measured: 8e-7 and 3e-7
  on bench LeNet), plus, under Adam, what the step's gradient
  difference can move its update (`_adam_slack`). Each step starts from
  the JAX package's state (resynced, as `tests/test_torch_resnet.py`
  does). Adam divides by sqrt(v) + eps, so where a gradient nearly
  cancels (a bias summed over the batch) its f32 rounding moves the
  update by a share of the learning rate: unsynced, the book LeNet's
  conv2 weights differ by 1.8e-5 in one element of 25,000 after three
  steps at lr 0.01, and even resynced its conv2 bias by 1.4e-5 in one
  element of 3,200 after the first step.
- The book programs train on the port (the JAX package's synthetic
  mnist and uci_housing readers, as `tests/test_book.py`).
- `models/lenet.py`'s native loss against the JAX package's.
- Refusals: an unported op raises at `Executor.run`, naming itself;
  `Executor()`, `default_place()` and `CUDAPlace(0)` raise on a machine
  without a GPU.
"""

import ast
import os

import numpy as np
import pytest
import torch

import jax

import chip_smoke
import paddle_tpu as pt
from paddle_tpu.dataset import mnist, uci_housing
from paddle_tpu.models import lenet as jlenet

import paddle_tpu_torch as ptt
from paddle_tpu_torch.convert import params_from_numpy, scope_from_numpy
from paddle_tpu_torch.models import lenet as tlenet

torch.set_num_threads(2)


def _fit_a_line(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = pkg.layers.data(name="x", shape=[13], dtype="float32")
        y = pkg.layers.data(name="y", shape=[1], dtype="float32")
        pred = pkg.layers.fc(input=x, size=1)
        loss = pkg.layers.mean(pkg.layers.square_error_cost(input=pred, label=y))
        pkg.optimizer.SGD(learning_rate=0.01).minimize(loss)
    return main, startup, [loss]


def _bench_lenet(pkg):
    # chip_smoke.py's copy of bench.py's `_build_lenet_program`: bench.py
    # is not imported here, as importing it switches jax's default PRNG
    # for the whole process (test_bench_lenet_builder_is_benchs holds
    # the copy to its source)
    main, startup, loss = chip_smoke.lenet_rung_program(pkg)
    return main, startup, [loss]


def _book_lenet(pkg):
    models = jlenet if pkg is pt else tlenet
    main, startup, _, loss, acc = models.build_program(pkg, lr=0.01)
    return main, startup, [loss, acc]


def _feeds(name, rng, bs=16):
    if name == "fit_a_line":
        return {"x": rng.rand(bs, 13).astype("float32"),
                "y": rng.rand(bs, 1).astype("float32")}
    img = "img" if name == "book_lenet" else "x"
    lab = "label" if name == "book_lenet" else "y"
    return {img: rng.rand(bs, 1, 28, 28).astype("float32"),
            lab: rng.randint(0, 10, (bs, 1)).astype("int64")}


PROGRAMS = {"bench_lenet": _bench_lenet, "book_lenet": _book_lenet,
            "fit_a_line": _fit_a_line}
ADAM_LR = {"bench_lenet": 2e-3, "book_lenet": 0.01}


def _adam_slack(lr, g_port, g_jax):
    """How far a gradient difference can move one Adam step (beta1 0.9,
    beta2 0.999, eps 1e-8, steps 1-3): the update is lr_t m / (sqrt(v) +
    eps) with lr_t <= 0.32 lr and sqrt(v) >= sqrt(1 - beta2) |g|, so
    |d update / d g| <= 2 lr / (|g| + eps / sqrt(1 - beta2))."""
    return 2 * lr * np.abs(g_port - g_jax) / (
        np.abs(g_jax) + 1e-8 / np.sqrt(1e-3))


def _build(name, pkg):
    with pkg.framework.unique_name.guard():
        return PROGRAMS[name](pkg)


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_program_identity(name):
    mj, sj, _ = _build(name, pt)
    mt, st, _ = _build(name, ptt)
    assert mt.desc.to_dict() == mj.desc.to_dict()
    assert st.desc.to_dict() == sj.desc.to_dict()
    types = {op.type for op in mt.desc.block(0).ops}
    assert any(t.endswith("_grad") for t in types)
    assert types & {"adam", "sgd"}



def _function_body(path, name):
    """The statements of function `name` in `path`, docstring dropped,
    as an AST dump."""
    with open(path) as f:
        tree = ast.parse(f.read())
    (fn,) = [n for n in tree.body
             if isinstance(n, ast.FunctionDef) and n.name == name]
    return [ast.dump(stmt) for stmt in fn.body[1:]]


def test_bench_lenet_builder_is_benchs():
    """chip_smoke.py's `lenet_rung_program` is bench.py's
    `_build_lenet_program` statement for statement."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert _function_body(os.path.join(repo, "chip_smoke.py"),
                          "lenet_rung_program") == _function_body(
        os.path.join(repo, "bench.py"), "_build_lenet_program")


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_three_steps_match_jax(name):
    mj, sj, fj = _build(name, pt)
    mt, st, ft = _build(name, ptt)
    feed = _feeds(name, np.random.RandomState(0))
    exej, exet = pt.Executor(pt.CPUPlace()), ptt.Executor(ptt.CPUPlace())
    scj, sct = pt.Scope(), ptt.Scope()
    exej.run(sj, scope=scj)
    pers = [v.name for v in sj.list_vars() if v.persistable]
    params = [p.name for p in mj.all_parameters()]
    grads = [p + "@GRAD" for p in params]
    for step in range(3):
        scope_from_numpy(sct, {n: scj.get(n) for n in pers}, ptt.CPUPlace())
        gj = exej.run(mj, feed=feed, fetch_list=[v.name for v in fj] + grads,
                      scope=scj)
        gt = exet.run(mt, feed=feed, fetch_list=[v.name for v in ft] + grads,
                      scope=sct)
        for a, b in zip(gt[:len(fj)], gj[:len(fj)]):
            np.testing.assert_allclose(a, b, rtol=1e-5)
        for n, a, b in zip(params, gt[len(fj):], gj[len(fj):]):
            np.testing.assert_allclose(
                a, b, rtol=0, atol=1e-5 * np.abs(b).max(),
                err_msg=f"{n}@GRAD at step {step + 1}")
            want = scj.get(n)
            slack = _adam_slack(ADAM_LR[name], a, b) if name in ADAM_LR \
                else 0.0
            err = np.abs(sct.get(n) - want) - slack
            assert err.max() <= 1e-5 * max(1.0, np.abs(want).max()), \
                (n, step + 1, float(err.max()))


def _batches(reader, bs, n):
    batch = []
    for sample in reader():
        batch.append(sample)
        if len(batch) == bs:
            yield batch
            batch = []
            n -= 1
            if n == 0:
                return


def test_book_lenet_trains():
    """book/test_recognize_digits.py on the port: 30 steps of 64, the
    loss falls and the accuracy rises."""
    with ptt.framework.unique_name.guard():
        main, startup, feeds, loss, acc = tlenet.build_program(ptt, lr=0.01)
    exe = ptt.Executor(ptt.CPUPlace())
    losses, accs = [], []
    with ptt.scope_guard(ptt.Scope()):
        exe.run(startup)
        for batch in _batches(mnist.train(), 64, 30):
            img = np.stack([b[0] for b in batch]).reshape(-1, 1, 28, 28)
            lab = np.array([b[1] for b in batch], "int64").reshape(-1, 1)
            l, a = exe.run(main, feed={"img": img.astype("float32"),
                                       "label": lab},
                           fetch_list=[loss, acc])
            losses.append(float(l.reshape(())))
            accs.append(float(a.reshape(())))
    assert losses[-1] < losses[0]
    assert np.mean(accs[-5:]) > np.mean(accs[:5])


def test_fit_a_line_converges():
    """book/test_fit_a_line.py on the port: 4 epochs of 32."""
    main, startup, (loss,) = _build("fit_a_line", ptt)
    exe = ptt.Executor(ptt.CPUPlace())
    losses = []
    with ptt.scope_guard(ptt.Scope()):
        exe.run(startup)
        for _ in range(4):
            for batch in _batches(uci_housing.train(), 32, -1):
                X = np.stack([b[0] for b in batch]).astype("float32")
                Y = np.stack([b[1] for b in batch]).reshape(-1, 1).astype(
                    "float32")
                losses.append(float(exe.run(main, feed={"x": X, "y": Y},
                                            fetch_list=[loss])[0][0]))
    assert losses[-1] < losses[0]


def test_native_lenet_loss_matches_jax():
    """`models/lenet.py`'s init/apply/loss_fn: the JAX package's params
    carried across give the same loss and logits."""
    jparams, _ = jlenet.init(jax.random.key(0))
    rng = np.random.RandomState(1)
    img = rng.rand(4, 1, 28, 28).astype("float32")
    label = rng.randint(0, 10, (4, 1)).astype("int64")
    want = float(jlenet.loss_fn(jparams, {"img": img, "label": label}))
    tparams = params_from_numpy({k: np.asarray(v) for k, v in jparams.items()},
                                "cpu")
    got = tlenet.loss_fn(tparams, {"img": torch.from_numpy(img),
                                   "label": torch.from_numpy(label)})
    np.testing.assert_allclose(float(got), want, rtol=1e-5)
    logits = tlenet.apply(tparams, torch.from_numpy(img))
    np.testing.assert_allclose(logits.numpy(),
                               np.asarray(jlenet.apply(jparams, img)),
                               rtol=1e-4, atol=1e-4)
    shapes = {k: tuple(v.shape) for k, v in tlenet.init(
        torch.Generator().manual_seed(0), device="cpu")[0].items()}
    assert shapes == {k: tuple(v.shape) for k, v in jparams.items()}


def test_unported_op_raises_naming_itself():
    """A program with an op the port lacks (a parameter-server op, which
    no layer of the port builds) builds, as a structural op would, and
    `Executor.run` raises naming the op and the ROADMAP item that ports
    it."""
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        x = ptt.layers.data(name="x", shape=[4], dtype="float32")
        main.global_block().append_op(type="ps_send", inputs={"X": [x]},
                                      outputs={}, attrs={})
        out = ptt.layers.scale(x, scale=2.0)
    exe = ptt.Executor(ptt.CPUPlace())
    with pytest.raises(KeyError, match="ps_send.*ROADMAP item 21"):
        exe.run(main, feed={"x": np.zeros((2, 4), "float32")},
                fetch_list=[out])


def test_no_gpu_refusals():
    """No fallback to the CPU: the default place, `CUDAPlace(0)` and an
    `Executor()` with no place raise on a machine without CUDA."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    for make in (ptt.Executor, lambda: ptt.CUDAPlace(0),
                 lambda: ptt.TPUPlace(0), ptt.places.default_place):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert not ptt.is_compiled_with_cuda()
