"""The compression toolkit of the port (`paddle_tpu_torch/slim/`: prune,
distillation, float16, nas, core) against the JAX package's, on the
MLP and data of `tests/test_slim.py`.

- Pruning from one trained scope (the JAX package trains it): the masks
  and the pruned weights equal bit for bit, the masks pinned through 10
  more SGD steps, and the sensitivity curves within 1e-5 (relative to
  the base metric) of the JAX ones, with the same picked ratios.
  Structured (filter-L1) pruning on the output axis, as there.
- Distillation: `merge` gives the JAX program (`to_dict()` equal), the
  soft-label, L2 and FSP losses of one scope within 1e-5 of the JAX
  values, and the merged student trains with its teacher fixed.
- `float16_transpile` (bf16 and f16): the JAX desc, the scope cast to
  the half dtype on its device, and the transpiled logits within 2 bf16
  steps (2**-7) of the largest logit of the f32 ones.
- The Compressor: tests/test_slim.py's prune-then-QAT schedule from its
  YAML and from the equal dict give the same strategies; a run fires
  both (fake-quant ops present, more than 20% of the pruned weights
  zero, the last eval within 0.15 of the best); an unknown strategy is
  refused; the distillation schedule swaps programs for its epochs.
- NAS: the controller server tests, mirrored on the port's copy.
"""

import socket as _socket

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu_torch.convert import scope_from_numpy


def _build_mlp(pkg, seed=3, opt=None):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    with pkg.framework.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data(name="x", shape=[8], dtype="float32")
        y = pkg.layers.data(name="y", shape=[1], dtype="int64")
        h = pkg.layers.fc(x, size=16, act="relu")
        logits = pkg.layers.fc(h, size=4)
        loss = pkg.layers.mean(
            pkg.layers.softmax_with_cross_entropy(logits, y))
        if opt is not None:
            opt(pkg).minimize(loss)
    return main, startup, loss, logits


def _mlp_data():
    rng = np.random.RandomState(0)
    X = rng.randn(64, 8).astype("float32")
    Y = (np.abs(X[:, :4]).argmax(1) % 4).astype("int64")[:, None]
    return X, Y


def _sgd(pkg):
    return pkg.optimizer.SGD(learning_rate=0.05)


def _adam(lr):
    return lambda pkg: pkg.optimizer.Adam(learning_rate=lr)


def _jax_trained(steps, opt, seed=3):
    """The JAX package's MLP trained `steps` steps: (program pieces, its
    scope, its persistables as numpy)."""
    main, startup, loss, logits = _build_mlp(pt, seed, opt)
    X, Y = _mlp_data()
    scope = pt.Scope()
    exe = pt.Executor(pt.CPUPlace())
    exe.run(startup, scope=scope)
    for _ in range(steps):
        exe.run(main, feed={"x": X, "y": Y}, fetch_list=[loss], scope=scope)
    pers = {v.name: scope.get(v.name) for v in startup.list_vars()
            if v.persistable}
    return scope, pers


def _w_names(main):
    return [p.name for p in main.global_block().all_parameters()
            if p.name.endswith(".w_0")]


def _jax_scope(arrays):
    scope = pt.Scope()
    for n, v in arrays.items():
        scope.set_var(n, jnp.asarray(v))
    return scope


def test_pruner_masks_equal_and_persist():
    _, trained = _jax_trained(20, _sgd)
    X, Y = _mlp_data()
    got = {}
    for pkg in (pt, ptt):
        main, _, loss, _ = _build_mlp(pkg, opt=_sgd)
        scope = _jax_scope(trained) if pkg is pt else \
            scope_from_numpy(ptt.Scope(), trained, ptt.CPUPlace())
        params = _w_names(main)
        pruner = pkg.slim.Pruner()
        masks = pruner.prune(scope, params, {"*": 0.5})
        pruned = {n: scope.get(n) for n in params}
        for w in pruned.values():
            assert 0.45 <= (w == 0).mean() <= 0.55
        pruner.apply_masks(main, scope, masks)
        exe = pkg.Executor(pkg.CPUPlace())
        for _ in range(10):
            exe.run(main, feed={"x": X, "y": Y}, fetch_list=[loss],
                    scope=scope)
        after = {n: scope.get(n) for n in params}
        for n in params:
            assert ((after[n] == 0) >= (masks[n] == 0)).all(), n
        got[pkg.__name__] = (masks, pruned, after, scope)
    (mj, pj, aj, _), (mt, ptd, at, st) = got["paddle_tpu"], \
        got["paddle_tpu_torch"]
    for n in mj:
        np.testing.assert_array_equal(mt[n], mj[n])
        np.testing.assert_array_equal(ptd[n], pj[n])
        np.testing.assert_allclose(at[n], aj[n], rtol=0,
                                   atol=1e-5 * np.abs(aj[n]).max())
        mask = st.find_var(n + ".prune_mask")
        assert isinstance(mask, torch.Tensor) and mask.dtype == torch.float32


def test_sensitivity_equal_to_the_jax_curves():
    _, trained = _jax_trained(80, _adam(0.02))
    X, Y = _mlp_data()
    sens, picks = {}, {}
    for pkg in (pt, ptt):
        main, _, loss, _ = _build_mlp(pkg)
        scope = _jax_scope(trained) if pkg is pt else \
            scope_from_numpy(ptt.Scope(), trained, ptt.CPUPlace())
        exe = pkg.Executor(pkg.CPUPlace())

        def eval_fn():
            out = exe.run(main, feed={"x": X, "y": Y},
                          fetch_list=[loss.name], scope=scope)[0]
            return -float(np.asarray(out).reshape(()))

        base = eval_fn()
        strat = pkg.slim.SensitivePruneStrategy(ratios=(0.3, 0.5, 0.9))
        params = _w_names(main)
        sens[pkg.__name__] = strat.sensitivity(scope, params, eval_fn)
        for n in params:       # each probe restores the weight
            np.testing.assert_array_equal(scope.get(n), trained[n])
        for curve in sens[pkg.__name__].values():
            assert curve[0.9] > 0, curve
        picks[pkg.__name__] = strat.pick_ratios(sens[pkg.__name__],
                                                max_drop=0.05)
    sj, st = sens["paddle_tpu"], sens["paddle_tpu_torch"]
    assert sorted(sj) == sorted(st)
    for n in sj:
        for r in sj[n]:
            assert abs(st[n][r] - sj[n][r]) <= 1e-5 * abs(base), (n, r)
    assert picks["paddle_tpu_torch"] == picks["paddle_tpu"]


@pytest.mark.parametrize("pkg", [pt, ptt], ids=["jax", "torch"])
def test_filter_l1_prunes_output_axis(pkg):
    scope = pkg.Scope()
    w = np.ones((6, 4), "float32")
    w[:, 0] = 0.01
    w[:, 2] = 0.02
    scope.set_var("fcw", w if pkg is pt else torch.from_numpy(w))
    pkg.slim.Pruner(mode="filter_l1").prune(scope, ["fcw"], {"*": 0.5})
    out = scope.get("fcw")
    assert (out[:, 0] == 0).all() and (out[:, 2] == 0).all()
    assert (out[:, 1] != 0).all() and (out[:, 3] != 0).all()
    conv = np.ones((4, 2, 3, 3), "float32")
    conv[1] = 0.01
    scope.set_var("convw", conv)
    pkg.slim.Pruner(mode="filter_l1").prune(scope, ["convw"], {"*": 0.25})
    out = scope.get("convw")
    assert (out[1] == 0).all() and (out[0] != 0).all()


def _distill_programs(pkg):
    teacher, t_start = pkg.Program(), pkg.Program()
    with pkg.framework.unique_name.guard(), \
            pkg.program_guard(teacher, t_start):
        x = pkg.layers.data(name="x", shape=[8], dtype="float32")
        th = pkg.layers.fc(x, size=32, act="relu",
                           param_attr=pkg.ParamAttr(name="tw1"),
                           bias_attr=pkg.ParamAttr(name="tb1"))
        t_logits = pkg.layers.fc(th, size=4,
                                 param_attr=pkg.ParamAttr(name="tw2"),
                                 bias_attr=pkg.ParamAttr(name="tb2"))
    student, s_start = pkg.Program(), pkg.Program()
    with pkg.framework.unique_name.guard(), \
            pkg.program_guard(student, s_start):
        x = pkg.layers.data(name="x", shape=[8], dtype="float32")
        y = pkg.layers.data(name="y", shape=[1], dtype="int64")
        sh = pkg.layers.fc(x, size=8, act="relu",
                           param_attr=pkg.ParamAttr(name="sw1"),
                           bias_attr=pkg.ParamAttr(name="sb1"))
        s_logits = pkg.layers.fc(sh, size=4,
                                 param_attr=pkg.ParamAttr(name="sw2"),
                                 bias_attr=pkg.ParamAttr(name="sb2"))
    rename = pkg.slim.distillation.merge(teacher, student, data_names=["x"])
    with pkg.framework.unique_name.guard("distill"), \
            pkg.program_guard(student, s_start):
        block = student.global_block()
        t_var = block.var(rename[t_logits.name])
        dist = pkg.slim.distillation
        kd = dist.soft_label_loss(t_var, s_logits, teacher_temperature=2.0,
                                  student_temperature=2.0)
        l2 = dist.l2_loss(t_var, s_logits)
        ce = pkg.layers.mean(pkg.layers.softmax_with_cross_entropy(
            s_logits, y))
        total = pkg.layers.elementwise_add(kd, ce)
        img = pkg.layers.reshape(x, [-1, 2, 2, 2])
        fsp = dist.fsp_loss(img, img, img, pkg.layers.scale(img, scale=0.5))
        pkg.optimizer.Adam(learning_rate=0.02).minimize(total)
    return student, s_start, t_start, rename, (kd, l2, fsp, total)


def test_distillation_merge_losses_and_training():
    X, Y = _mlp_data()
    built = {p.__name__: _distill_programs(p) for p in (pt, ptt)}
    sj, ssj, tsj, rj, lj = built["paddle_tpu"]
    stt, sst, tst, rt, lt = built["paddle_tpu_torch"]
    assert rt == rj
    assert stt.desc.to_dict() == sj.desc.to_dict()
    scj = pt.Scope()
    exej = pt.Executor(pt.CPUPlace())
    exej.run(ssj, scope=scj)
    exej.run(tsj, scope=scj)
    pers = {v.name: scj.get(v.name)
            for v in list(ssj.list_vars()) + list(tsj.list_vars())
            if v.persistable}
    sct = scope_from_numpy(ptt.Scope(), pers, ptt.CPUPlace())
    pt.slim.distillation.init_teacher_scope(scj, rj)
    ptt.slim.distillation.init_teacher_scope(sct, rt)
    exet = ptt.Executor(ptt.CPUPlace())
    feed = {"x": X, "y": Y}
    vj = exej.run(sj, feed=feed, fetch_list=[v.name for v in lj], scope=scj)
    vt = exet.run(stt, feed=feed, fetch_list=[v.name for v in lt], scope=sct)
    for a, b in zip(vt, vj):
        np.testing.assert_allclose(a, b, rtol=1e-5)
    tw = sct.get("teacher_tw1")
    ls = [float(exet.run(stt, feed=feed, fetch_list=[lt[3].name],
                         scope=sct)[0].reshape(())) for _ in range(60)]
    assert ls[-1] < ls[0], (ls[0], ls[-1])
    np.testing.assert_array_equal(sct.get("teacher_tw1"), tw)


def _lenet_infer(pkg):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.framework.unique_name.guard(), pkg.program_guard(main, startup):
        img = pkg.layers.data(name="img", shape=[1, 12, 12],
                              dtype="float32")
        c = pkg.layers.conv2d(img, num_filters=4, filter_size=3, act="relu")
        p = pkg.layers.pool2d(c, pool_size=2, pool_stride=2)
        logits = pkg.layers.fc(p, size=5)
    main._attrs["feed_names"] = ["img"]
    main._attrs["fetch_names"] = [logits.name]
    return main, startup, logits


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_float16_transpile(dtype):
    rng = np.random.RandomState(1)
    img = rng.standard_normal((6, 1, 12, 12)).astype("float32")
    mj, sj, lj = _lenet_infer(pt)
    mt, st, lt = _lenet_infer(ptt)
    scj = pt.Scope()
    exej = pt.Executor(pt.CPUPlace())
    exej.run(sj, scope=scj)
    pers = {v.name: scj.get(v.name) for v in sj.list_vars() if v.persistable}
    sct = scope_from_numpy(ptt.Scope(), pers, ptt.CPUPlace())
    exet = ptt.Executor(ptt.CPUPlace())
    f32 = exet.run(mt, feed={"img": img}, fetch_list=[lt.name], scope=sct)[0]
    pt.slim.float16_transpile(mj, scj, dtype=dtype)
    ptt.slim.float16_transpile(mt, sct, dtype=dtype)
    assert mt.desc.to_dict() == mj.desc.to_dict()
    for n in pers:
        v = sct.find_var(n)
        assert isinstance(v, torch.Tensor) and str(v.dtype) == "torch." + dtype
    got = exet.run(mt, feed={"img": img}, fetch_list=[lt.name], scope=sct)[0]
    want = np.asarray(exej.run(mj, feed={"img": img}, fetch_list=[lj.name],
                               scope=scj)[0])
    assert got.dtype == np.float32 and got.shape == f32.shape
    top = float(np.abs(f32).max())
    assert np.abs(got - f32).max() <= 2 * 2.0 ** -7 * top
    assert np.abs(got - want).max() <= 2 * 2.0 ** -7 * top


_YAML = """
strategies:
  prune:
    class: SensitivePruneStrategy
    start_epoch: 1
    max_metric_drop: 0.1
    sensitivity_ratios: [0.3, 0.5, 0.7]
    pruned_params: [%s]
  quant:
    class: QuantizationStrategy
    start_epoch: 2
compressor:
  epoch: 4
"""


def _compressor_dict(params):
    return {"strategies": {
        "prune": {"class": "SensitivePruneStrategy", "start_epoch": 1,
                  "max_metric_drop": 0.1,
                  "sensitivity_ratios": [0.3, 0.5, 0.7],
                  "pruned_params": list(params)},
        "quant": {"class": "QuantizationStrategy", "start_epoch": 2}},
        "compressor": {"epoch": 4}}


def _strategy_key(s):
    return type(s).__name__, sorted(
        (k, v) for k, v in vars(s).items() if not isinstance(v, dict))


def test_compressor_yaml_and_dict_give_the_same_schedule():
    from paddle_tpu_torch.slim.core import Compressor

    main, startup, loss, _ = _build_mlp(ptt, seed=5, opt=_adam(0.03))
    params = _w_names(main)
    yaml_cfg = _YAML % ", ".join(f'"{p}"' for p in params)
    a = Compressor(ptt.CPUPlace(), ptt.Scope(), main, startup).config(
        yaml_cfg)
    b = Compressor(ptt.CPUPlace(), ptt.Scope(), main, startup).config(
        _compressor_dict(params))
    assert a.epoch == b.epoch == 4
    assert [_strategy_key(s) for s in a.strategies] == \
        [_strategy_key(s) for s in b.strategies]
    assert [type(s).__name__ for s in a.strategies] == \
        ["SensitivePruneStrategyScheduled", "QuantizationStrategy"]


def test_compressor_schedules_prune_then_qat():
    """tests/test_slim.py's run on the port, config as a dict."""
    from paddle_tpu_torch.slim.core import Compressor

    main, startup, loss, logits = _build_mlp(ptt, seed=5, opt=_adam(0.03))
    X, Y = _mlp_data()

    def train_reader():
        for _ in range(30):
            yield {"x": X, "y": Y}

    def eval_func(program, executor, scope):
        out = executor.run(program, feed={"x": X, "y": Y},
                           fetch_list=[logits], scope=scope)[0]
        return float((np.asarray(out).argmax(1) == Y[:, 0]).mean())

    scope = ptt.Scope()
    comp = Compressor(ptt.CPUPlace(), scope, main, startup,
                      train_reader=train_reader, train_fetch_list=[loss],
                      eval_func=eval_func).config(
        _compressor_dict(_w_names(main)))
    ctx = comp.run()
    assert any(op.type.startswith("fake_") for op in main.global_block().ops)
    w_names = _w_names(main)
    zeros = sum(int((scope.get(n) == 0).sum()) for n in w_names)
    total = sum(scope.get(n).size for n in w_names)
    assert zeros > 0.2 * total, (zeros, total)
    assert ctx.eval_history[-1] >= max(ctx.eval_history) - 0.15, \
        ctx.eval_history
    assert ctx.eval_history[-1] > 0.4, ctx.eval_history


@pytest.mark.parametrize("pkg", [pt, ptt], ids=["jax", "torch"])
def test_compressor_rejects_unknown_strategy(pkg):
    from importlib import import_module

    Compressor = import_module(pkg.__name__ + ".slim.core").Compressor
    main, startup, loss, _ = _build_mlp(pkg, seed=6)
    with pytest.raises(ValueError, match="unknown compression strategy"):
        Compressor(pkg.CPUPlace(), pkg.Scope(), main, startup).config(
            {"strategies": {"bogus": {"class": "NoSuchStrategy"}}})


def test_compressor_distillation_schedule():
    """tests/test_slim.py's distillation schedule on the port: a trained
    teacher spliced into the student's distill program, which is active
    for epochs 1 and 2 only."""
    from paddle_tpu_torch.slim import distillation
    from paddle_tpu_torch.slim.core import Compressor

    X, Y = _mlp_data()
    t_main, t_start, t_loss, _ = _build_mlp(ptt, seed=21, opt=_adam(0.05))
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(t_start, scope=scope)
    for _ in range(40):
        exe.run(t_main, feed={"x": X, "y": Y}, fetch_list=[t_loss],
                scope=scope)
    t_infer = ptt.Program()
    with ptt.framework.unique_name.guard("teacher_build"), \
            ptt.program_guard(t_infer, ptt.Program()):
        xv = ptt.layers.data(name="x", shape=[8], dtype="float32")
        hv = ptt.layers.fc(xv, size=16, act="relu",
                           param_attr=ptt.ParamAttr(name="tw1"),
                           bias_attr=ptt.ParamAttr(name="tb1"))
        t_out = ptt.layers.fc(hv, size=4,
                              param_attr=ptt.ParamAttr(name="tw2"),
                              bias_attr=ptt.ParamAttr(name="tb2"))
    for src, dst in zip(sorted(p.name for p in t_main.all_parameters()),
                        ["tb1", "tw1", "tb2", "tw2"]):
        scope.set_var(dst, scope.find_var(src))
    s_main, s_start, s_loss, s_logits = _build_mlp(ptt, seed=22,
                                                   opt=_adam(0.03))
    distill = s_main.clone()
    rename = distillation.merge(t_infer, distill, data_names=["x"])
    distillation.init_teacher_scope(scope, rename)
    with ptt.program_guard(distill, s_start):
        soft = distillation.soft_label_loss(
            distill.current_block().var(rename[t_out.name]),
            distill.current_block().var(s_logits.name))
        ptt.optimizer.Adam(learning_rate=0.03).minimize(
            soft, parameter_list=[p for p in distill.all_parameters()
                                  if not p.name.startswith("t")])

    def train_reader():
        for _ in range(10):
            yield {"x": X, "y": Y}

    def eval_func(program, executor, scope_):
        out = executor.run(program, feed={"x": X, "y": Y},
                           fetch_list=[s_logits], scope=scope_)[0]
        return float((np.asarray(out).argmax(1) == Y[:, 0]).mean())

    comp = Compressor(ptt.CPUPlace(), scope, s_main, s_start,
                      train_reader=train_reader, train_fetch_list=[s_loss],
                      eval_func=eval_func, distill_program=distill).config({
                          "strategies": {
                              "distill": {"class": "DistillationStrategy",
                                          "start_epoch": 1,
                                          "end_epoch": 2}},
                          "compressor": {"epoch": 4}})
    ctx = comp.run()
    assert ctx.train_program is s_main and ctx.active_program is s_main
    assert comp.strategies[0].distilled_epochs == [1, 2]
    assert len(ctx.eval_history) == 4
    assert ctx.eval_history[-1] > 0.4, ctx.eval_history


def test_nas_controller_server_finds_good_tokens():
    from paddle_tpu_torch.slim import (ControllerServer, SAController,
                                       SearchAgent)

    ctrl = SAController(range_table=[8] * 5, init_temperature=100.0,
                        reduce_rate=0.7, seed=0)
    server = ControllerServer(ctrl)
    server.start()
    agent = SearchAgent("127.0.0.1", server.port)
    for _ in range(60):
        toks = agent.next_tokens()
        agent.update(toks, float(sum(toks)))
    best_toks, best_reward = agent.best()
    agent.close_server()
    assert best_reward >= 25, (best_toks, best_reward)


@pytest.mark.parametrize("payload", [b"update\tnot,numbers",
                                     b"\xff\xfe garbage"])
def test_nas_server_survives_a_malformed_request(payload):
    from paddle_tpu_torch.slim import (ControllerServer, SAController,
                                       SearchAgent)

    ctrl = SAController(range_table=[4, 4], seed=3, max_iter_number=3)
    srv = ControllerServer(ctrl)
    srv.start()
    with _socket.create_connection(("127.0.0.1", srv.port)) as s:
        s.sendall(payload)
        s.shutdown(_socket.SHUT_WR)
        resp = s.recv(65536).decode()
    assert resp.startswith("error")
    agent = SearchAgent("127.0.0.1", srv.port)
    for _ in range(5):
        toks = agent.next_tokens()
        assert len(toks) == 2
        agent.update(toks, float(sum(toks)))
    assert ctrl.is_finished
    assert agent.update([3, 3], 100.0) is False
    assert agent.best()[1] == 100.0
    agent.close_server()


# chip_smoke.py's phase 33 parts, run here with the CPU on both sides at
# a small size (VGG-16-BN at widths / 8, batch 8; LeNet at batch 32; the
# CTC ladder at 8 x 16 frames x 10 classes), so their code and gates run
# before a card does


def test_phase33_qat_vgg_parity_steps_and_freeze(tmp_path):
    import chip_smoke as c

    cpu = ptt.CPUPlace()
    prog, scope, row = c.qat_vgg_parity(ptt, cpu, cpu, width=8, batch=8)
    assert row["quant_ops"] == 32 and row["state_vars"] == 48
    assert row["flips"] == 0 and row["card_vs_cpu_worst"]["loss"] == 0
    exe = ptt.Executor(cpu)
    img, label = c.synthetic_cifar(8 * c.SLIM_QAT_STEPS, seed=35)
    losses = [float(exe.run(prog["main"],
                            feed={"img": img[i * 8:(i + 1) * 8],
                                  "label": label[i * 8:(i + 1) * 8]},
                            fetch_list=[prog["loss"]], scope=scope)[0][0])
              for i in range(c.SLIM_QAT_STEPS)]
    assert np.isfinite(losses).all()
    out = c.qat_vgg_freeze(ptt, prog, scope, cpu, cpu, str(tmp_path),
                           batch=8)
    assert out["frozen_weights"] == 16 and out["frozen_card_vs_cpu"] == 0


def test_phase33_compressor_distillation_and_bf16(tmp_path):
    import chip_smoke as c

    cpu = ptt.CPUPlace()
    main, scope, row = c.lenet_compress(ptt, cpu, steps=10, batch=32,
                                        eval_b=128)
    assert row["fake_ops"] == 8 and row["zero_share"] > 0.2
    dist = c.lenet_distill(ptt, cpu, steps=5, teacher_steps=10, batch=32,
                           eval_b=128)
    assert dist["distilled_epochs"] == [1, 2]
    bf16 = c.lenet_bf16(ptt, main, scope, cpu, cpu, str(tmp_path), batch=16)
    assert bf16["bf16_card_vs_cpu_max_abs"] == 0


def test_phase33_ctc_ladder():
    import chip_smoke as c

    cpu = ptt.CPUPlace()
    row = c.slim_ctc(ptt, cpu, cpu, steps=30, B=8, T=16, C=10,
                     labels=(2, 5), frames=(12, 16))
    assert row["op_card_vs_cpu"]["infeasible_loss"] > 1e4
    assert row["losses_first_last"][1] < 0.5 * row["losses_first_last"][0]


def test_phase33_sweep_covers_the_43_op_types():
    import chip_smoke as c

    row = c.slim_sweep("cpu")
    assert row["op_types"] == 43
    assert not any(row["worst_abs"].values())


@pytest.mark.parametrize("pkg", [pt, ptt], ids=["jax", "torch"])
def test_f23_a_rebuilt_program_marks_every_parameter_trainable(pkg):
    """ROADMAP F23 (the JAX package's behaviour, copied): a program
    rebuilt from its desc (here by the QAT transform's
    `_rebuild_from_desc`) makes every parameter a `Parameter` with the
    default trainable=True, a batch norm's running mean and variance
    too, in both packages."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.framework.unique_name.guard(), pkg.program_guard(main, startup):
        x = pkg.layers.data(name="x", shape=[3, 4, 4], dtype="float32")
        y = pkg.layers.batch_norm(pkg.layers.conv2d(x, num_filters=2,
                                                    filter_size=3))
        pkg.layers.fc(y, size=2)

    def frozen():
        return sorted(p.name for p in main.all_parameters()
                      if not p.trainable)

    assert frozen() == ["batch_norm_0.mean_0", "batch_norm_0.var_0"]
    pkg.slim.QuantizationTransformPass().apply(main, startup)
    assert frozen() == []
