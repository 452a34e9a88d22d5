"""The port's Executor, Scope and backward, mirroring the JAX package's
`tests/test_executor.py`, `tests/test_backward.py` and
`tests/test_double_backward.py` on the CPU: linreg converges, the program
cache hits after the first run, scopes are isolated, a missing feed and
an unknown fetch raise, the RNG replays (through `dropout_grad` too),
`run_chained` equals sequential runs (also with per-step feeds),
`append_backward` creates the param grads, `gradients` agrees with
finite differences and stops at `stop_gradient`, and
`gradients(gradients(...))` equals the JAX package's."""

import numpy as np
import pytest
import torch

import paddle_tpu as pt

import paddle_tpu_torch as ptt
from paddle_tpu_torch.core import async_exec
from paddle_tpu_torch.observability import health

torch.set_num_threads(2)

CPU = ptt.CPUPlace()


@pytest.fixture
def rng():
    return np.random.RandomState(0)


def _linreg_program(pkg=ptt):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = pkg.layers.data(name="x", shape=[13], dtype="float32")
        y = pkg.layers.data(name="y", shape=[1], dtype="float32")
        pred = pkg.layers.fc(input=x, size=1)
        loss = pkg.layers.mean(pkg.layers.square_error_cost(input=pred, label=y))
        pkg.optimizer.SGD(learning_rate=0.05).minimize(loss)
    return main, startup, loss


def _params(main, scope):
    return {v.name: scope.get(v.name) for v in main.list_vars()
            if isinstance(v, ptt.Parameter)}


def test_linreg_converges(rng):
    main, startup, loss = _linreg_program()
    exe = ptt.Executor(CPU)
    with ptt.scope_guard(ptt.Scope()):
        exe.run(startup)
        X = rng.rand(64, 13).astype("float32")
        Y = (X @ rng.rand(13, 1)).astype("float32")
        losses = [float(exe.run(main, feed={"x": X, "y": Y},
                                fetch_list=[loss])[0][0]) for _ in range(60)]
    assert losses[-1] < losses[0] * 0.05


def test_cache_hits_after_first_run(rng):
    """After the first run of a (program, feed signature), every run is a
    hit; another batch size is a new entry; a program edit re-keys."""
    main, startup, loss = _linreg_program()
    exe = ptt.Executor(CPU)
    X = rng.rand(16, 13).astype("float32")
    Y = rng.rand(16, 1).astype("float32")
    with ptt.scope_guard(ptt.Scope()):
        exe.run(startup)
        for _ in range(4):
            exe.run(main, feed={"x": X, "y": Y}, fetch_list=[loss])
        assert exe.cache_stats() == {"hits": 3, "misses": 2, "entries": 2}
        exe.run(main, feed={"x": X[:8], "y": Y[:8]}, fetch_list=[loss])
        assert exe.cache_stats()["entries"] == 3
        main._bump_version()
        exe.run(main, feed={"x": X, "y": Y}, fetch_list=[loss])
        assert exe.cache_stats()["misses"] == 4


def test_scope_isolation(rng):
    main, startup, loss = _linreg_program()
    exe = ptt.Executor(CPU)
    s1, s2 = ptt.Scope(), ptt.Scope()
    X = rng.rand(8, 13).astype("float32")
    Y = rng.rand(8, 1).astype("float32")
    with ptt.scope_guard(s1):
        exe.run(startup)
        exe.run(main, feed={"x": X, "y": Y}, fetch_list=[loss])
        w1 = _params(main, s1)
    with ptt.scope_guard(s2):
        exe.run(startup)
        for _ in range(10):
            exe.run(main, feed={"x": X, "y": Y}, fetch_list=[loss])
        w2 = _params(main, s2)
    for n in w1:
        np.testing.assert_array_equal(s1.get(n), w1[n])
        assert not np.array_equal(w1[n], w2[n])


def test_missing_feed_and_unknown_fetch_raise(rng):
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        x = ptt.layers.data(name="x", shape=[3], dtype="float32")
        out = ptt.layers.scale(x, scale=2.0)
    exe = ptt.Executor(CPU)
    exe.run(startup)
    X = rng.rand(4, 3).astype("float32")
    res = exe.run(main, feed={"x": X}, fetch_list=[out])[0]
    np.testing.assert_allclose(res, X * 2.0, rtol=1e-6)
    from paddle_tpu_torch.core.lowering import LoweringError

    with pytest.raises(LoweringError, match="input var 'x' has no value"):
        exe.run(main, feed={}, fetch_list=[out])
    with pytest.raises(LoweringError, match="fetch var 'nope'"):
        exe.run(main, feed={"x": X}, fetch_list=["nope"])


def test_fetch_async_and_tensors(rng):
    """sync=False returns a FetchHandle resolving to numpy;
    return_numpy=False returns the tensors."""
    main, startup, loss = _linreg_program()
    exe = ptt.Executor(CPU)
    X = rng.rand(8, 13).astype("float32")
    Y = rng.rand(8, 1).astype("float32")
    with ptt.scope_guard(ptt.Scope()):
        exe.run(startup)
        h = exe.run(main, feed={"x": X, "y": Y}, fetch_list=[loss],
                    sync=False)
        assert isinstance(h, async_exec.FetchHandle)
        (v,) = h.result()
        assert isinstance(v, np.ndarray) and v.shape == (1,)
        (t,) = exe.run(main, feed={"x": X, "y": Y}, fetch_list=[loss],
                       return_numpy=False)
        assert isinstance(t, torch.Tensor)


def test_check_nan_inf_raises():
    """FLAGS_check_nan_inf keeps its raise: a NaN fetch raises."""
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        x = ptt.layers.data(name="x", shape=[3], dtype="float32")
        out = ptt.layers.log(x)
    exe = ptt.Executor(CPU)
    ptt.set_flags({"FLAGS_check_nan_inf": True})
    try:
        with pytest.raises(health.NumericsError):
            exe.run(main, feed={"x": -np.ones((2, 3), "float32")},
                    fetch_list=[out])
    finally:
        ptt.set_flags({"FLAGS_check_nan_inf": False})


def _dropout_program():
    main, startup = ptt.Program(), ptt.Program()
    main.random_seed = 42
    with ptt.program_guard(main, startup):
        x = ptt.layers.data(name="x", shape=[100], dtype="float32")
        x.stop_gradient = False
        out = ptt.layers.dropout(x, dropout_prob=0.5)
        loss = ptt.layers.mean(out)
        (gx,) = ptt.gradients(loss, x)
    return main, startup, out, gx


def test_rng_determinism_and_dropout_grad_replay():
    """The RNG state advances between steps; a fresh scope with the same
    seed replays the stream; `dropout_grad` replays the forward's mask,
    so the gradient is zero exactly where the output was dropped."""
    main, startup, out, gx = _dropout_program()
    exe = ptt.Executor(CPU)
    X = np.ones((4, 100), "float32")
    with ptt.scope_guard(ptt.Scope()):
        exe.run(startup)
        a, ga = exe.run(main, feed={"x": X}, fetch_list=[out, gx])
        b = exe.run(main, feed={"x": X}, fetch_list=[out])[0]
    assert not np.array_equal(a, b)
    with ptt.scope_guard(ptt.Scope()):
        exe.run(startup)
        a2 = exe.run(main, feed={"x": X}, fetch_list=[out])[0]
    np.testing.assert_array_equal(a, a2)
    kept = a != 0
    assert 0.3 < kept.mean() < 0.7
    np.testing.assert_array_equal(ga != 0, kept)
    np.testing.assert_allclose(ga[kept], 1.0 / X.size, rtol=1e-6)


def _train(n_steps, chained, X, Y, per_step=False):
    ptt.framework.unique_name.generator = ptt.framework.UniqueNameGenerator()
    main, startup, loss = _linreg_program()
    exe = ptt.Executor(CPU)
    scope = ptt.Scope()
    with ptt.scope_guard(scope):
        exe.run(startup)
        if chained:
            losses = exe.run_chained(main, feed={"x": X, "y": Y},
                                     fetch_list=[loss], n_steps=n_steps,
                                     per_step_feeds=per_step)[0]
            assert losses.shape == (n_steps, 1)
            losses = [float(v) for v in losses.ravel()]
        else:
            losses = [float(exe.run(
                main, feed={"x": X[i], "y": Y[i]} if per_step
                else {"x": X, "y": Y}, fetch_list=[loss])[0][0])
                for i in range(n_steps)]
        return losses, _params(main, scope)


@pytest.mark.parametrize("per_step", [False, True],
                         ids=["same_feed", "per_step_feeds"])
def test_run_chained_matches_sequential(rng, per_step):
    """n chained steps leave the scope as n sequential runs and return
    the same per-step losses (bit for bit: the same ops in the same
    order)."""
    n = 5
    if per_step:
        X = rng.rand(n, 16, 13).astype("float32")
        Y = np.einsum("nbi,io->nbo", X, rng.rand(13, 1)).astype("float32")
    else:
        X = rng.rand(32, 13).astype("float32")
        Y = (X @ rng.rand(13, 1)).astype("float32")
    seq_losses, seq_params = _train(n, False, X, Y, per_step)
    ch_losses, ch_params = _train(n, True, X, Y, per_step)
    assert ch_losses == seq_losses
    assert seq_params.keys() == ch_params.keys()
    for name in seq_params:
        np.testing.assert_array_equal(ch_params[name], seq_params[name])


def test_run_chained_per_step_feeds_needs_leading_axis(rng):
    main, startup, loss = _linreg_program()
    exe = ptt.Executor(CPU)
    with ptt.scope_guard(ptt.Scope()):
        exe.run(startup)
        with pytest.raises(ValueError, match="leading"):
            exe.run_chained(main, feed={"x": rng.rand(8, 13),
                                        "y": rng.rand(8, 1)},
                            fetch_list=[loss], n_steps=4,
                            per_step_feeds=True)


def _mlp(pkg, main, startup):
    with pkg.program_guard(main, startup):
        x = pkg.layers.data(name="x", shape=[6], dtype="float32")
        y = pkg.layers.data(name="y", shape=[1], dtype="float32")
        h = pkg.layers.fc(input=x, size=5, act="tanh")
        pred = pkg.layers.fc(input=h, size=1)
        loss = pkg.layers.mean(pkg.layers.square_error_cost(input=pred, label=y))
    return x, y, loss


def test_append_backward_creates_param_grads():
    main, startup = ptt.Program(), ptt.Program()
    x, y, loss = _mlp(ptt, main, startup)
    with ptt.program_guard(main, startup):
        p2g = ptt.backward.append_backward(loss)
    assert len(p2g) == 4  # 2 fc layers x (w, b)
    for p, g in p2g:
        assert g.name.endswith("@GRAD")
        assert tuple(p.shape) == tuple(g.shape)


def test_gradients_match_finite_differences(rng):
    main, startup = ptt.Program(), ptt.Program()
    x, y, loss = _mlp(ptt, main, startup)
    with ptt.program_guard(main, startup):
        p2g = ptt.backward.append_backward(loss)
    exe = ptt.Executor(CPU)
    scope = ptt.Scope()
    exe.run(startup, scope=scope)
    feed = {"x": rng.rand(8, 6).astype("float32"),
            "y": rng.rand(8, 1).astype("float32")}
    grads = exe.run(main, feed=feed, fetch_list=[g for _, g in p2g],
                    scope=scope)
    delta = 1e-3
    for (param, _), g in zip(p2g, grads):
        w0 = scope.get(param.name).astype(np.float64)
        flat_w = w0.reshape(-1)
        for j in rng.choice(flat_w.size, size=min(6, flat_w.size),
                            replace=False):
            num = 0.0
            for sign in (+1, -1):
                w = flat_w.copy()
                w[j] += sign * delta
                scope.set_var(param.name, w.reshape(w0.shape).astype("float32"))
                num += sign * float(exe.run(main, feed=feed, fetch_list=[loss],
                                            scope=scope)[0][0]) / (2 * delta)
            scope.set_var(param.name, w0.astype("float32"))
            ana = float(g.reshape(-1)[j])
            assert abs(ana - num) <= 2e-2 * max(1.0, abs(num)), \
                (param.name, j, ana, num)


def test_gradients_api_intermediate_var(rng):
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        x = ptt.layers.data(name="x", shape=[4], dtype="float32")
        x.stop_gradient = False
        h = ptt.layers.scale(x, scale=3.0)
        loss = ptt.layers.mean(h)
        (gx,) = ptt.gradients(loss, x)
    exe = ptt.Executor(CPU)
    X = rng.rand(2, 4).astype("float32")
    g = exe.run(main, feed={"x": X}, fetch_list=[gx], scope=ptt.Scope())[0]
    np.testing.assert_allclose(g, np.full_like(X, 3.0 / X.size), rtol=1e-5)


def test_stop_gradient_blocks_path():
    main, startup = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, startup):
        x = ptt.layers.data(name="x", shape=[4], dtype="float32")
        h1 = ptt.layers.fc(input=x, size=4)
        h1.stop_gradient = True
        h2 = ptt.layers.fc(input=h1, size=1)
        loss = ptt.layers.mean(h2)
        p2g = ptt.append_backward(loss)
    grad_params = {p.name for p, _ in p2g}
    all_params = {v.name for v in main.list_vars()
                  if isinstance(v, ptt.Parameter)}
    assert len(grad_params) == 2
    assert grad_params < all_params


def _square(pkg, x, w):
    return pkg.layers.square(x)


def _tanh_mul_add(pkg, x, w):
    h = pkg.layers.elementwise_mul(pkg.layers.tanh(x), w)
    return pkg.layers.elementwise_add(h, pkg.layers.square(x))


@pytest.mark.parametrize("build_y", [_square, _tanh_mul_add],
                         ids=["square", "tanh_mul_add"])
def test_double_backward_matches_jax(build_y):
    """y = build_y(x); g = d sum(y)/dx; gg = d sum(g^2)/dx, built with
    `gradients(gradients(...))` in both packages (float64): the port's
    `_grad_grad` ops (a replay of the generic grad under autograd, with
    create_graph) against the JAX package's (jax.vjp of jax.vjp)."""
    rng = np.random.RandomState(1)
    feed = {"x": rng.randn(3, 4), "w": rng.randn(3, 4)}
    got = {}
    for pkg in (pt, ptt):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.framework.unique_name.guard(), \
                pkg.program_guard(main, startup):
            x = pkg.layers.data(name="x", shape=[4], dtype="float64")
            w = pkg.layers.data(name="w", shape=[4], dtype="float64")
            (g,) = pkg.backward.gradients(
                pkg.layers.reduce_sum(build_y(pkg, x, w)), x)
            p = pkg.layers.reduce_sum(pkg.layers.square(g))
            (gg,) = pkg.backward.gradients(p, x)
        assert any(op.type.endswith("_grad_grad")
                   for op in main.desc.block(0).ops)
        exe = pkg.Executor(pkg.CPUPlace())
        got[pkg] = exe.run(main, feed=feed, fetch_list=[g.name, gg.name],
                           scope=pkg.Scope())
    for a, b in zip(got[ptt], got[pt]):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-10, atol=1e-12)
    if build_y is _square:
        np.testing.assert_allclose(got[ptt][1], 8 * feed["x"], rtol=1e-12)


def test_program_precision_rekeys_and_autocasts(rng):
    """`set_program_precision` re-keys the prepared-step cache; under
    mixed_bf16 the white-list `mul` runs in bfloat16 (its grad op too)
    and the black-list `mean` in f32, as the JAX package's lowering
    casts them: the loss agrees with the JAX package's under the same
    policy to bf16's rounding."""
    from paddle_tpu.core import precision as jprec

    from paddle_tpu_torch.convert import scope_from_numpy
    from paddle_tpu_torch.core import precision as tprec

    X = rng.rand(16, 13).astype("float32")
    Y = rng.rand(16, 1).astype("float32")
    feed = {"x": X, "y": Y}
    with pt.framework.unique_name.guard():
        jmain, jstartup, jloss = _linreg_program(pt)
    with ptt.framework.unique_name.guard():
        tmain, _, tloss = _linreg_program(ptt)
    jexe, texe = pt.Executor(pt.CPUPlace()), ptt.Executor(CPU)
    jscope = pt.Scope()
    jexe.run(jstartup, scope=jscope)
    init = {v.name: jscope.get(v.name) for v in jstartup.list_vars()
            if v.persistable}
    losses = []
    for policy in (None, "mixed_bf16"):
        jprec.set_program_precision(jmain, policy)
        tprec.set_program_precision(tmain, policy)
        assert tprec.resolve(tmain).name == (policy or "f32")
        for n, v in init.items():
            jscope.set_var(n, v)
        tscope = scope_from_numpy(ptt.Scope(), init, CPU)
        losses.append((
            texe.run(tmain, feed=feed, fetch_list=[tloss], scope=tscope)[0],
            jexe.run(jmain, feed=feed, fetch_list=[jloss], scope=jscope)[0]))
    assert texe.cache_stats()["misses"] == 2  # one step per policy
    (tf, jf), (tm, jm) = losses
    np.testing.assert_allclose(tf, jf, rtol=1e-5)
    np.testing.assert_allclose(tm, jm, rtol=2 ** -7)
    assert not np.array_equal(tm, tf)  # the bf16 product shows
